"""The port's train step and training driver against the JAX package's, on
the CPU (card against CPU: tests/test_torch_train_cuda.py).

``make_train_step`` against the reference's (jitted) on JAX-initialised
weights and a JAX-initialised optimizer state carried across by
``convert``, on ``TokenPipeline`` batches (batch 8, seq 32): TINY with
AdamW in one and two microbatches and with Adafactor, mamba2-130m's smoke
config in two microbatches and deepseek-moe-16b's (the aux loss):

* ``one_step``: the first step;
* ``teacher_forced``: steps 1-3, each port step taken from JAX's params
  and state before it;
* ``free``: three port steps in a row against three JAX steps.

Loss, ``grad_norm`` and ``lr`` within rtol 1e-5. Params: every entry
within 1e-6 + 1e-4 * |p|, except where AdamW's g / (|g| + eps) amplifies
the float32 rounding of a small grad. In the one-step and teacher-forced
modes those are the entries whose JAX grad this step is below 1e-4 *
max|g_leaf|, the grads' own tolerance (tests/test_torch_loss.py): an
entry whose grad is within a few hundred eps of zero moves by a share of
lr that its grad's last bits decide (measured: |g| = 1.5e-7 against
1.8e-7 moves an entry by 0.03 lr). In three free steps those entries
then feed every later grad, so the exception is a count instead. Either
way the entries outside 1e-6 + 1e-4 * |p| must be under 0.1% of all and
each within 2 * lr * (1 + wd). Measured worst case (TINY, AdamW, one
microbatch): 232 entries of 4,196,608 at the first step, at most 0.26
lr; 406 after three free steps, at most 1.19 lr, the largest of the
others 4.8 times its tolerance. Adafactor's update has no such division:
0 entries over.

``launch.train.main`` in-process on the CPU (TINY, seq 32, batch 4): a
run and its log, resume from its own checkpoint (the reference's
``[resume] restored step 6``), the watchdog's exit code 75 and a resumed
run bit-equal to an uninterrupted one, the refused families and a mesh
over more than one device; ``examples/torch_train_lm.py`` is in
tests/test_torch_examples.py.
"""
import dataclasses
import functools
import os

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro.launch.train import TINY as JAX_TINY  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.device import NotPortedError  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import TINY  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    _split_microbatches, make_opt_init, make_prefill_step, make_train_step)

LR, WD, STEPS = chip_smoke.TRAIN_LR, chip_smoke.TRAIN_WD, 3
G_SMALL = 1e-4          # a grad below this share of its leaf's largest
CASES = {"tiny_adamw": ("tiny", "adamw", 1),
         "tiny_adamw_mb2": ("tiny", "adamw", 2),
         "tiny_adafactor": ("tiny", "adafactor", 1),
         "mamba2_mb2": ("mamba2-130m", "adamw", 2),
         "moe": ("deepseek-moe-16b", "adamw", 1)}


def _cfgs(name, **kw):
    j, p = (JAX_TINY, TINY) if name == "tiny" else (jax_smoke(name),
                                                    smoke_config(name))
    return dataclasses.replace(j, **kw), dataclasses.replace(p, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """{case: JAX's three steps}: params and state before every step and
    after the last, the batches, the metrics and the JAX grads at each
    step's params (full batch), all as numpy."""
    out = {}
    for case, (name, opt, n_mb) in CASES.items():
        jcfg, _ = _cfgs(name, num_microbatches=n_mb)
        opt_cfg = jopt.OptimizerConfig(name=opt, lr=LR, warmup_steps=0,
                                       total_steps=100, weight_decay=WD)
        params = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
        state = jts.make_opt_init(jcfg, opt_cfg)(params)
        step = jax.jit(jts.make_train_step(jcfg, opt_cfg))
        vag = jax.jit(jax.value_and_grad(
            functools.partial(jax_registry.loss_fn, jcfg)))
        pipe = TokenPipeline(DataConfig(vocab=jcfg.vocab, seq_len=32,
                                        global_batch=8, seed=0))
        run = {"params": [_np(params)], "state": [_np(state)],
               "batches": [], "metrics": [], "grads": [],
               "opt_cfg": opt_cfg}
        for i in range(STEPS):
            batch = pipe.batch_at(i)
            run["grads"].append(_np(vag(params, batch)[1]))
            params, state, metrics = step(params, state, batch)
            run["batches"].append(batch)
            run["metrics"].append({k: float(v) for k, v in metrics.items()})
            run["params"].append(_np(params))
            run["state"].append(_np(state))
        out[case] = run
    return out


def _port_state(pcfg, run, i):
    """The port's params and optimizer state carried from JAX's before
    step ``i``."""
    opt_cfg = OptimizerConfig(**dataclasses.asdict(run["opt_cfg"]))
    return (convert.lm_params_from_numpy(pcfg, run["params"][i],
                                         device="cpu"),
            convert.opt_state_from_numpy(pcfg, opt_cfg, run["state"][i],
                                         device="cpu"),
            opt_cfg)


def _hold_params(got, want, small=None):
    """chip_smoke.train_param_diff's rule: entries outside 1e-6 + 1e-4 *
    |want| under 0.1% of all, each within 2 * lr * (1 + wd), and none
    outside ``small`` (the masks of small grads) when it is given."""
    want = dict(T.items(want))
    diff = chip_smoke.train_param_diff(
        np, {k: v.numpy() for k, v in T.items(got)}, want, LR, WD, small)
    assert diff["ok"], diff


def _small_grads(grads):
    return {k: np.abs(v) < G_SMALL * np.abs(v).max()
            for k, v in T.items(grads)}


def _hold_metrics(got, want):
    for k in ("loss", "grad_norm", "lr"):
        assert float(got[k]) == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.parametrize("mode", ["one_step", "teacher_forced", "free"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(jax_runs, case, mode):
    name, _, n_mb = CASES[case]
    run = jax_runs[case]
    _, pcfg = _cfgs(name, num_microbatches=n_mb)
    steps = 1 if mode == "one_step" else STEPS
    params, state, opt_cfg = _port_state(pcfg, run, 0)
    step_fn = make_train_step(pcfg, opt_cfg)
    for i in range(steps):
        if mode == "teacher_forced":
            params, state, _ = _port_state(pcfg, run, i)
        params, state, metrics = step_fn(params, state,
                                         _torch(run["batches"][i]))
        _hold_metrics(metrics, run["metrics"][i])
        assert int(state["step"]) == int(run["state"][i + 1]["step"])
        _hold_params(params, run["params"][i + 1],
                     None if mode == "free" else _small_grads(
                         run["grads"][i]))


def test_microbatches_split_the_batch_in_order():
    batch = {"tokens": torch.arange(24).reshape(6, 4)}
    mbs = _split_microbatches(batch, 3)
    assert mbs["tokens"].shape == (3, 2, 4)
    torch.testing.assert_close(mbs["tokens"][1], batch["tokens"][2:4])
    with pytest.raises(ValueError, match="microbatches"):
        _split_microbatches(batch, 4)


def test_train_step_ignores_the_callers_no_grad_and_donates():
    """Under a serving path's torch.no_grad the step still trains; with
    donate=True it writes into the inputs and returns them."""
    cfg = smoke_config("gemma-7b")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=0)
    state = make_opt_init(cfg, opt_cfg)(params)
    batch = _torch(TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                            global_batch=2)).batch_at(0))
    ref_p, _, ref_m = make_train_step(cfg, opt_cfg)(params, state, batch)
    with torch.no_grad():
        got_p, got_s, m = make_train_step(cfg, opt_cfg, donate=True)(
            params, state, batch)
    assert float(m["grad_norm"]) > 0 and torch.equal(m["loss"], ref_m["loss"])
    assert got_p["embed"]["tok"] is params["embed"]["tok"]
    assert got_s["step"] is state["step"] and int(state["step"]) == 1
    for a, b in zip(T.leaves(ref_p), T.leaves(got_p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefill_step_is_the_mean_of_its_waves():
    cfg = dataclasses.replace(smoke_config("mamba2-130m"),
                              prefill_microbatches=2)
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _torch(TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                            global_batch=4)).batch_at(0))
    two = make_prefill_step(cfg)(params, batch)
    halves = [registry.loss_fn(cfg, params, {k: v[i:i + 2]
                                             for k, v in batch.items()})
              for i in (0, 2)]
    assert not two.requires_grad
    assert float(two) == pytest.approx(float(sum(halves).detach()) / 2,
                                       rel=1e-6)


def test_grad_specs_and_compress_pod_name_a18():
    opt_cfg = OptimizerConfig()
    for kw in ({"grad_specs": {}}, {"compress_pod": ("mesh", {})}):
        with pytest.raises(NotPortedError, match="A.18"):
            make_train_step(TINY, opt_cfg, **kw)


# --------------------------------------------------------------- driver
BASE = ["--preset", "tiny", "--device", "cpu", "--seq", "32", "--batch",
        "4", "--log-every", "1"]


def _ckpt(tmp_path, name):
    return ["--ckpt-dir", str(tmp_path / name)]


def test_driver_trains_and_logs(tmp_path, capsys):
    assert train.main(BASE + _ckpt(tmp_path, "a") + ["--steps", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 4 and "tok/s" in steps[0]
    losses = [float(ln.split()[3]) for ln in steps]
    assert all(np.isfinite(losses))
    assert lines[-1].startswith("done in") and \
        "(entropy bound 1.3863)" in lines[-1]
    assert CheckpointManager(str(tmp_path / "a")).latest_step() == 4


def test_driver_resumes_from_its_checkpoint(tmp_path, capsys):
    """The reference test's run: 6 steps with a checkpoint every 5, then
    --steps 8 --resume restores step 6 and trains steps 6-7."""
    ck = _ckpt(tmp_path, "run") + ["--ckpt-every", "5"]
    assert train.main(BASE + ck + ["--steps", "6"]) == 0
    capsys.readouterr()
    assert train.main(BASE + ck + ["--steps", "8", "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"[resume] restored step 6 from {tmp_path / 'run'}" in out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == ["6", "7"]
    assert CheckpointManager(str(tmp_path / "run")).all_steps() == [5, 6, 8]


def test_watchdog_exits_75_and_a_resumed_run_equals_an_uninterrupted_one(
        tmp_path, capsys):
    straight = _ckpt(tmp_path, "straight") + ["--steps", "5"]
    assert train.main(BASE + straight) == 0
    cut = _ckpt(tmp_path, "cut") + ["--steps", "5"]
    assert train.main(BASE + cut + ["--step-timeout", "1e-9"]) == 75
    out = capsys.readouterr().out
    assert "[watchdog] step 1 took" in out
    mgr = CheckpointManager(str(tmp_path / "cut"))
    assert mgr.latest_step() == 2
    assert train.main(BASE + cut + ["--resume"]) == 0
    assert "[resume] restored step 2" in capsys.readouterr().out
    template = {"params": registry.init_params(
        TINY, torch.Generator().manual_seed(0))}
    template["opt"] = make_opt_init(TINY, OptimizerConfig())(
        template["params"])
    _, a = CheckpointManager(str(tmp_path / "straight")).restore(template)
    _, b = mgr.restore(template)
    for x, y in zip(T.leaves(a), T.leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_driver_refuses_encdec_and_the_vlm(tmp_path, arch):
    with pytest.raises(SystemExit, match="token-LM"):
        train.main(["--preset", "smoke", "--arch", arch, "--device", "cpu",
                    "--steps", "1"] + _ckpt(tmp_path, "x"))
    assert not os.path.exists(tmp_path / "x")


def test_driver_trains_a_smoke_family(tmp_path, capsys):
    assert train.main(["--preset", "smoke", "--arch", "deepseek-moe-16b",
                       "--device", "cpu", "--steps", "2", "--seq", "32",
                       "--batch", "2"] + _ckpt(tmp_path, "moe")) == 0
    assert "done in" in capsys.readouterr().out


def test_driver_mesh_over_several_devices_names_a18(tmp_path):
    with pytest.raises(NotPortedError, match="A.18"):
        train.main(BASE + _ckpt(tmp_path, "m") + ["--mesh-data", "2"])
