"""The port's dense LM serving path against the JAX package's on the CPU.

Weights are made by the JAX package (its own init, seed 0) and carried
across through ``convert.lm_params_from_numpy``, so both sides compute on
identical parameters:

* ``init_cache`` shapes and dtypes (f32, bf16 and int8 caches);
* ``decode_step`` logits over 8 teacher-forced steps (the JAX tokens, or
  embeddings for the VLM backbone, fed to both, so one argmax flip cannot
  cascade), for ``TINY`` and the smoke config of every dense arch and
  internvl2, in f32: within 1e-4 (relative and absolute; float32 sums in
  another order);
* the same with ``kv_cache_dtype="int8"``: logits within 1e-4, and the
  int8 cache entries (and bf16 scales) that differ from JAX's are
  counted: the count must be 0. A float32 K that rounds to another int8
  step at a .5 boundary would show here as a count of 1;
* ``forward`` against JAX ``forward`` (1e-4), including the query-chunked
  path (S > attn_chunk);
* the int8 quantizers of ``parallel/compression.py`` bit-exact;
* the registry raises ``NotPortedError`` for the other families;
* ``python -m repro_torch.launch.serve --preset tiny --device cpu`` runs.
"""
import dataclasses
import functools
import subprocess
import sys
import pathlib

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.launch.train import TINY as JAX_TINY  # noqa: E402
from repro.models import dense as jax_dense  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.parallel import compression as jax_cp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.device import NotPortedError  # noqa: E402
from repro_torch.launch.train import TINY  # noqa: E402
from repro_torch.models import dense, registry  # noqa: E402
from repro_torch.parallel import compression as port_cp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DENSE = sorted(n for n, c in ARCHS.items() if c.family in ("dense", "vlm"))
CASES = ["tiny"] + DENSE
STEPS = 8
B = 2
TOL = 1e-4


def _cfgs(name, **kw):
    """(JAX config, port config) of ``name`` ("tiny" or a smoke arch)."""
    if name == "tiny":
        j, p = JAX_TINY, TINY
    else:
        j, p = jax_smoke(name), smoke_config(name)
    return dataclasses.replace(j, **kw), dataclasses.replace(p, **kw)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _params(name):
    jcfg, pcfg = _cfgs(name)
    jp = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, convert.lm_params_from_numpy(pcfg, _tree_np(jp), device="cpu")


def _inputs(jcfg, n):
    """(B, n) tokens, or (B, n, D) embeddings for the VLM, from JAX."""
    key = jax.random.PRNGKey(7)
    if jcfg.embeds_in:
        return np.asarray(jax.random.normal(key, (B, n, jcfg.d_model),
                                            jnp.float32) * 0.02)
    return np.asarray(jax.random.randint(key, (B, n), 0, jcfg.vocab,
                                         jnp.int32))


def _decode_both(name, **kw):
    jcfg, pcfg = _cfgs(name, **kw)
    jp, pp = _params(name)
    x = _inputs(jcfg, STEPS)
    step = jax.jit(functools.partial(jax_registry.decode_step, jcfg))
    jc = jax_registry.init_cache(jcfg, B, STEPS)
    pc = registry.init_cache(pcfg, B, STEPS, device="cpu")
    got, want = [], []
    for t in range(STEPS):
        jl, jc = step(jp, jc, x[:, t:t + 1])
        with torch.no_grad():
            pl, pc = registry.decode_step(pcfg, pp, pc,
                                          torch.tensor(x[:, t:t + 1]))
        want.append(np.asarray(jl, np.float32))
        got.append(pl.float().numpy())
    return np.stack(got), np.stack(want), pc, _tree_np(jc)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", ["tiny", "gemma-7b", "starcoder2-7b"])
def test_init_cache_shapes_and_dtypes(name, kv):
    jcfg, pcfg = _cfgs(name, kv_cache_dtype=kv)
    if kv == "bfloat16":
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
        pcfg = dataclasses.replace(pcfg, param_dtype="bfloat16")
    jc = jax_registry.init_cache(jcfg, 3, 11)
    pc = registry.init_cache(pcfg, 3, 11, device="cpu")
    assert set(jc) == set(pc) and pc["pos"] == int(jc["pos"]) == 0
    for k in jc:
        if k == "pos":
            continue
        assert tuple(pc[k].shape) == jc[k].shape
        assert str(pc[k].dtype).replace("torch.", "") == str(jc[k].dtype)
        assert not bool(pc[k].any())


@pytest.mark.parametrize("name", CASES)
def test_decode_step_logits_match_jax(name):
    got, want, pc, jc = _decode_both(name)
    assert got.shape == want.shape == (STEPS, B, 1, _cfgs(name)[1].vocab)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert pc["pos"] == int(jc["pos"]) == STEPS
    for k in ("k", "v"):
        np.testing.assert_allclose(pc[k].numpy(), jc[k], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", CASES)
def test_int8_kv_decode_matches_jax(name):
    got, want, pc, jc = _decode_both(name, kv_cache_dtype="int8")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert pc["k"].dtype == torch.int8 and pc["k_scale"].dtype == \
        torch.bfloat16
    n_diff = sum(int((pc[k].float().numpy()
                      != np.asarray(jc[k], np.float32)).sum())
                 for k in ("k", "v", "k_scale", "v_scale"))
    assert n_diff == 0
    assert int((pc["k"] != 0).sum()) > 0        # entries were written


@pytest.mark.parametrize("S,chunk", [(12, 0), (32, 8)],
                         ids=["full", "chunked"])
@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax(name, S, chunk):
    jcfg, pcfg = _cfgs(name, attn_chunk=chunk)
    jp, pp = _params(name)
    x = _inputs(jcfg, S)
    want = np.asarray(jax_dense.forward(jcfg, jp, x), np.float32)
    with torch.no_grad():
        got = dense.forward(pcfg, pp, torch.tensor(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_matches_forward_in_the_port():
    """Token-by-token decode reproduces the teacher-forced forward
    (tests/test_models.py's check, at its tolerance, on the port alone)."""
    cfg = smoke_config("gemma-7b")
    _, pp = _params("gemma-7b")
    toks = torch.tensor(_inputs(_cfgs("gemma-7b")[0], 12))
    with torch.no_grad():
        full = dense.forward(cfg, pp, toks)
        cache = dense.init_cache(cfg, B, 12, device="cpu")
        got = []
        for t in range(12):
            logits, cache = dense.decode_step(cfg, pp, cache, toks[:, t:t + 1])
            got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_dense_lm_module_holds_the_pytree():
    cfg = smoke_config("starcoder2-7b")
    _, pp = _params("starcoder2-7b")
    m = dense.DenseLM(cfg, pp)
    names = dict(m.tree.named_parameters())
    assert names["blocks.attn.wq"] is not None
    assert names["blocks.attn.wq"].data_ptr() == pp["blocks"]["attn"][
        "wq"].data_ptr()
    assert tuple(names["blocks.ln1.bias"].shape) == (cfg.n_layers,
                                                     cfg.d_model)
    toks = torch.tensor(_inputs(_cfgs("starcoder2-7b")[0], 4))
    with torch.no_grad():
        np.testing.assert_array_equal(
            m(toks).numpy(), dense.forward(cfg, pp, toks).numpy())


def test_int8_quantizers_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 4, 16)) * rng.uniform(0.1, 9, (3, 5, 1, 1))
         ).astype(np.float32)
    jq, js = jax_cp.quantize_int8(x)
    pq, ps = port_cp.quantize_int8(torch.as_tensor(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert float(ps) == float(js)
    np.testing.assert_array_equal(
        port_cp.dequantize_int8(pq, ps).numpy(),
        np.asarray(jax_cp.dequantize_int8(jq, js)))
    for axis in (-1, 2):
        jq, js = jax_cp.quantize_kv(x, axis)
        pq, ps = port_cp.quantize_kv(torch.as_tensor(x), axis)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            port_cp.dequantize_kv(pq, ps, torch.float32).numpy(),
            np.asarray(jax_cp.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("name", sorted(
    n for n, c in ARCHS.items() if c.family not in ("dense", "vlm")))
def test_registry_refuses_unported_families(name):
    cfg = smoke_config(name)
    with pytest.raises(NotPortedError, match="ROADMAP A.16"):
        registry.init_params(cfg, torch.Generator())
    with pytest.raises(NotPortedError):
        registry.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(NotPortedError, match="A.17"):
        registry.loss_fn(smoke_config("gemma-7b"), {}, {})


def test_configs_are_the_reference_configs():
    assert set(ARCHS) == set(JAX_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(
            JAX_ARCHS[name])
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(
            jax_smoke(name))
        assert ARCHS[name].param_count() == JAX_ARCHS[name].param_count()
    assert dataclasses.asdict(TINY) == dataclasses.asdict(JAX_TINY)


def test_make_batch_shapes():
    from repro_torch.configs import SMOKE_SHAPE

    g = torch.Generator().manual_seed(0)
    b = registry.make_batch(smoke_config("internvl2-76b"), SMOKE_SHAPE, g)
    assert tuple(b["embeds"].shape) == (2, 64, 64)
    b = registry.make_batch(smoke_config("gemma-7b"), SMOKE_SHAPE, g)
    assert b["tokens"].dtype == torch.int32 and int(b["tokens"].max()) < 512


def test_serve_driver_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--preset", "tiny",
         "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen",
         "6"], capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill 4 tokens x 2 reqs")
    assert lines[1].startswith("generated 6 tokens x 2 reqs")
    assert lines[2].startswith("first request tokens: [")
