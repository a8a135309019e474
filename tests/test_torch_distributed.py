"""The port's training over several ranks on the CPU: 2 or 4 gloo
processes (tests/_torch_dist_worker.py) with a FileStore in tmp_path, no
TCP port, each world joined within a timeout.

* ``quantized_psum`` over 2 ranks equals, bit for bit, the numpy sum of
  the JAX package's ``quantize_int8`` of each rank's partial;
* the reference _POD_SCRIPT (a linear least-squares loss, the batch split
  over a "pod" axis of 2) through ``make_compressed_value_and_grad``
  against JAX's exact ``jax.value_and_grad``: loss within 1e-4, grads
  within the reference's bound 4 (2 max|g| / 254 + 1e-5);
* ``make_train_step`` on a (data=2, model=1) mesh with the ZeRO-2 grad
  specs against the port's one-rank step: three AdamW steps of TINY,
  losses within rtol 1e-5, params under ``chip_smoke.train_param_diff``'s
  rule;
* the reference _RESHARD_SCRIPT on a (2, 2) plan (4 ranks) and a (2, 1)
  plan (2 ranks): host leaves bit-equal to the host params, TINY's too
  under the "tp" profile's specs (its leaves really shard), and a
  checkpoint restored with ``shardings`` placed the same way, bit-equal;
* the "tp" profile's model paths (sharded attention, vocab-sharded
  embedding and cross entropy, sequence parallelism, expert parallelism)
  on a (data=1, model=2) mesh, and the data-parallel SSM and hybrid
  blocks (row by row) on a (data=2, model=1) mesh, against one rank:
  loss within rtol 1e-5, grads within 1e-4 max|g| + 1e-6.
"""
import multiprocessing as mp

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.parallel.compression import quantize_int8 as jax_quantize  # noqa: E402
from repro_torch.launch.train import TINY  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_loss_fn, make_opt_init, make_train_step, value_and_grad)
from tests import _torch_dist_worker as W  # noqa: E402

JOIN_TIMEOUT_S = 90


# ranks fork from one server process that has imported torch and the
# port once (a spawned rank would import them anew)
_CTX = mp.get_context("forkserver")
_CTX.set_forkserver_preload(["tests._torch_dist_worker",
                             "repro_torch.train.train_step",
                             "repro_torch.parallel.sharding",
                             "repro_torch.parallel.compression",
                             "torch.distributed.tensor"])


def _spawn(case, world, out):
    """Run ``case`` on ``world`` ranks; its rank 0's results."""
    ctx = _CTX
    procs = [ctx.Process(target=W.run, args=(r, case, world, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{case}: {len(alive)} ranks did not finish"
    assert [p.exitcode for p in procs] == [0] * world, case
    with np.load(out / f"{case}.npz") as z:
        return {k: z[k] for k in z.files}


def test_quantized_psum_equals_the_jax_quantized_sum(tmp_path):
    got = _spawn("psum", 2, tmp_path)["sum"]
    want = np.zeros((5, 7), np.float32)
    for rank in range(2):
        q, s = jax_quantize(jnp.asarray(W.psum_partial(rank)))
        want = want + np.asarray(q).astype(np.float32) * np.float32(s)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_compressed_value_and_grad_against_jax(tmp_path):
    got = _spawn("pod", 2, tmp_path)
    w, x, y = W.pod_data()

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2)

    loss_e, grads_e = jax.value_and_grad(loss_fn)(
        {"w": jnp.asarray(w)}, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    assert abs(float(got["loss"]) - float(loss_e)) < 1e-4
    ge = np.asarray(grads_e["w"])
    bound = 2 * np.abs(ge).max() / 254 + 1e-5
    assert np.abs(got["g"] - ge).max() < bound * 4, (
        np.abs(got["g"] - ge).max(), bound)


def test_data_parallel_train_step_matches_one_rank(tmp_path):
    got = _spawn("train", 2, tmp_path)
    params = registry.init_params(TINY, torch.Generator().manual_seed(W.SEED))
    opt = make_opt_init(TINY, W.train_opt())(params)
    step_fn = make_train_step(TINY, W.train_opt())
    losses = []
    for batch in W.batches():
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want = {k: v.numpy() for k, v in T.items(params)}
    diff = chip_smoke.train_param_diff(
        np, {k: got[f"p/{k}"] for k in want}, want, W.train_opt().lr,
        W.train_opt().weight_decay)
    assert diff["ok"], diff


@pytest.mark.parametrize("world", [4, 2], ids=["plan_2x2", "plan_2x1"])
def test_reshard_across_plans_is_bit_equal(tmp_path, world):
    from repro_torch.configs import smoke_config

    got = _spawn(f"reshard-{world}", world, tmp_path)
    gemma = registry.init_params(smoke_config("gemma-7b"),
                                 torch.Generator().manual_seed(W.SEED))
    tiny = registry.init_params(TINY, torch.Generator().manual_seed(W.SEED))
    for prefix, tree in (("gemma", gemma), ("tiny", tiny),
                         ("restored", tiny)):
        for k, v in T.items(tree):
            np.testing.assert_array_equal(got[f"{prefix}/{k}"], v.numpy())
    assert int(got["n_sharded"]) == 9 and bool(got["same_placements"])


@pytest.mark.parametrize("kind,arch", [("tp", a) for a in W.TP_ARCHS]
                         + [("dp", a) for a in W.DP_ARCHS])
def test_sharded_loss_and_grads_match_one_rank(tmp_path, kind, arch):
    got = _spawn(f"{kind}-{arch}", 2, tmp_path)
    cfg = W.tp_cfg(arch) if kind == "tp" else W.dp_cfg(arch)
    params = registry.init_params(cfg, torch.Generator().manual_seed(W.SEED))
    loss, grads = value_and_grad(make_loss_fn(cfg))(params,
                                                    W.tp_batch(cfg))
    np.testing.assert_allclose(got["loss"], loss.numpy(), rtol=1e-5)
    for k, g in T.items(grads):
        g = g.numpy()
        tol = 1e-4 * np.abs(g).max() + 1e-6
        assert np.abs(got[f"g/{k}"] - g).max() <= tol, k
