"""The port's MoE, SSM, hybrid and encoder-decoder LM families against the
JAX package's on the CPU.

Weights are made by the JAX package (its own init, seed 0) and carried
across through ``convert.lm_params_from_numpy``, so both sides compute on
identical parameters, for the smoke configs of deepseek-moe-16b,
grok-1-314b (expert slices), mamba2-130m, zamba2-1.2b and whisper-tiny:

* ``init`` trees and ``init_cache`` shapes and dtypes equal JAX's;
* ``decode_step`` logits over 8 teacher-forced steps (the JAX tokens fed
  to both) and the final cache within 1e-4 in f32 (float32 sums in
  another order); MoE with int8 caches: the int8 entries and bf16 scales
  equal JAX's (0 differ);
* ``forward`` within 1e-4, with and without the family's query or SSD
  chunks; encdec's ``encode`` and its cached cross K/V within 1e-4;
* the MoE router and dispatch (``_route``, ``_dispatch_tensors``,
  ``moe_capacity``) equal to JAX's, with the capacity invariants, and
  ties broken toward the lower expert as ``lax.top_k`` does;
* ``_ssd_scan`` against the naive recurrence at chunks 8, 16 and 64 (as
  tests/test_models.py does), and against JAX's with an initial state;
* decode against forward in the port, at the reference tests' settings
  (MoE with capacity_factor 16, 2e-2; SSM 3e-2; hybrid and encdec 2e-2);
* ``convert`` keeps the f32 leaves of bf16 trees (router, A_log, D_skip,
  dt_bias) and refuses a leaf in another dtype;
* the serving driver generates for every token-LM family at smoke width
  and refuses encdec.
"""
import copy
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec, hybrid, moe, registry, ssm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

FAMILY_ARCHS = sorted(n for n, c in ARCHS.items()
                      if c.family in ("moe", "ssm", "hybrid", "encdec"))
MOE_ARCHS = sorted(n for n in FAMILY_ARCHS if ARCHS[n].family == "moe")
STEPS = 8
B = 2
TOL = 1e-4


def _cfgs(name, **kw):
    """(JAX config, port config): ``name``'s smoke config, with ``kw``."""
    return (dataclasses.replace(jax_smoke(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def carried():
    """(name, param_dtype) -> (JAX params as numpy, the port's params
    carried across), JAX init with seed 0, made once a module."""
    made = {}

    def get(name, dtype="float32"):
        if (name, dtype) not in made:
            jcfg, pcfg = _cfgs(name, param_dtype=dtype)
            jp = _tree_np(jax_registry.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
            made[name, dtype] = jp, convert.lm_params_from_numpy(
                pcfg, jp, device="cpu")
        return made[name, dtype]
    return get


def _tokens(jcfg, n, seed=7):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, n), 0,
                                         jcfg.vocab, jnp.int32))


def _enc_embeds(jcfg, seed=11):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (B, jcfg.enc_len, jcfg.d_model),
                                        jnp.float32))


def _jax_cache(jcfg, jp, T):
    if jcfg.family == "encdec":
        return jax_registry.init_cache(jcfg, B, T, params=jp,
                                       enc_embeds=_enc_embeds(jcfg))
    return jax_registry.init_cache(jcfg, B, T)


def _port_cache(jcfg, pcfg, pp, T):
    if pcfg.family == "encdec":
        return registry.init_cache(pcfg, B, T, device="cpu", params=pp,
                                   enc_embeds=torch.tensor(_enc_embeds(jcfg)))
    return registry.init_cache(pcfg, B, T, device="cpu")


@pytest.fixture
def jax_decode(request, carried):
    """The JAX side of a decode comparison, made in setup (its compiles
    are outside the test's time budget): (name, kv cache dtype) ->
    (name, logits (STEPS, B, 1, V), final cache as numpy, the tokens)."""
    name, kv = request.param
    jcfg, _ = _cfgs(name, kv_cache_dtype=kv)
    jp, _ = carried(name)
    x = _tokens(jcfg, STEPS)
    step = jax.jit(functools.partial(jax_registry.decode_step, jcfg))
    jc = _jax_cache(jcfg, jp, STEPS)
    want = []
    for t in range(STEPS):
        jl, jc = step(jp, jc, x[:, t:t + 1])
        want.append(np.asarray(jl, np.float32))
    return name, np.stack(want), _tree_np(jc), x


def _decode_port(carried, name, x, **kw):
    jcfg, pcfg = _cfgs(name, **kw)
    _, pp = carried(name)
    pc = _port_cache(jcfg, pcfg, pp, STEPS)
    got = []
    with torch.no_grad():
        for t in range(STEPS):
            pl, pc = registry.decode_step(pcfg, pp, pc,
                                          torch.tensor(x[:, t:t + 1]))
            got.append(pl.float().numpy())
    return np.stack(got), pc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_init_tree_matches_jax(name, dtype):
    """The port's own init makes the reference's tree: the same leaves,
    shapes and dtypes (f32 router / A_log / D_skip / dt_bias in bf16)."""
    jcfg, pcfg = _cfgs(name, param_dtype=dtype)
    want = _flat(jax.eval_shape(
        lambda: jax_registry.init_params(jcfg, jax.random.PRNGKey(0))))
    got = _flat(registry.init_params(pcfg, torch.Generator().manual_seed(0)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        assert bool(torch.isfinite(got[k].float()).all()), k


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_init_cache_shapes_and_dtypes(name, kv):
    jcfg, pcfg = _cfgs(name, kv_cache_dtype=kv)
    jc = jax_registry.init_cache(jcfg, 3, 11)
    pc = registry.init_cache(pcfg, 3, 11, device="cpu")
    assert set(jc) == set(pc) and pc["pos"] == int(jc["pos"]) == 0
    for k in jc:
        if k == "pos":
            continue
        assert tuple(pc[k].shape) == jc[k].shape, k
        assert str(pc[k].dtype).replace("torch.", "") == str(jc[k].dtype), k
        assert not bool(pc[k].any())


@pytest.mark.parametrize("jax_decode", [(n, "float32") for n in FAMILY_ARCHS],
                         indirect=True, ids=FAMILY_ARCHS)
def test_decode_step_logits_match_jax(carried, jax_decode):
    name, want, jc, x = jax_decode
    got, pc = _decode_port(carried, name, x)
    assert got.shape == want.shape == (STEPS, B, 1, smoke_config(name).vocab)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert pc["pos"] == int(jc["pos"]) == STEPS
    assert set(pc) == set(jc)
    for k in jc:
        if k != "pos":
            np.testing.assert_allclose(pc[k].float().numpy(), jc[k],
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("jax_decode", [(n, "int8") for n in MOE_ARCHS],
                         indirect=True, ids=MOE_ARCHS)
def test_moe_int8_kv_decode_matches_jax(carried, jax_decode):
    name, want, jc, x = jax_decode
    got, pc = _decode_port(carried, name, x, kv_cache_dtype="int8")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert pc["k"].dtype == torch.int8 and pc["k_scale"].dtype == \
        torch.bfloat16
    n_diff = sum(int((pc[k].float().numpy()
                      != np.asarray(jc[k], np.float32)).sum())
                 for k in ("k", "v", "k_scale", "v_scale"))
    assert n_diff == 0
    assert int((pc["k"] != 0).sum()) > 0


# (name, S, config overrides): each family without and with its chunks
# (MoE: query chunks and two token groups; SSM: SSD chunks; hybrid: both;
# encdec: the decoder's query chunks, while the bidirectional encoder over
# enc_len 16 > 8 must stay unchunked)
FORWARD_CASES = [
    ("deepseek-moe-16b", 12, dict(attn_chunk=0)),
    ("deepseek-moe-16b", 32, dict(attn_chunk=8)),
    ("grok-1-314b", 12, dict(attn_chunk=0)),
    ("grok-1-314b", 32, dict(attn_chunk=8)),
    ("mamba2-130m", 16, dict()),
    ("mamba2-130m", 32, dict(ssm_chunk=8)),
    ("zamba2-1.2b", 16, dict(attn_chunk=0)),
    ("zamba2-1.2b", 32, dict(attn_chunk=8, ssm_chunk=8)),
    ("whisper-tiny", 12, dict(attn_chunk=0)),
    ("whisper-tiny", 32, dict(attn_chunk=8)),
]


def _forward_inputs(jcfg, S):
    x = _tokens(jcfg, S)
    return ((_enc_embeds(jcfg), x) if jcfg.family == "encdec" else (x,))


@pytest.fixture
def jax_forward(request, carried):
    """The JAX side of a forward comparison, made in setup: (the case,
    logits as numpy, aux loss or None)."""
    name, S, kw = request.param
    jcfg, _ = _cfgs(name, **kw)
    jp, _ = carried(name)
    out = jax_registry.model_for(jcfg).forward(jcfg, jp,
                                               *_forward_inputs(jcfg, S))
    if isinstance(out, tuple):          # MoE: (logits, aux loss)
        return request.param, np.asarray(out[0], np.float32), float(out[1])
    return request.param, np.asarray(out, np.float32), None


@pytest.mark.parametrize(
    "jax_forward", FORWARD_CASES, indirect=True,
    ids=[f"{n}-S{s}-{'chunked' if any(k.values()) else 'full'}"
         for n, s, k in FORWARD_CASES])
def test_forward_matches_jax(carried, jax_forward):
    (name, S, kw), want, want_aux = jax_forward
    jcfg, pcfg = _cfgs(name, **kw)
    _, pp = carried(name)
    with torch.no_grad():
        got = registry.model_for(pcfg).forward(
            pcfg, pp, *map(torch.tensor, _forward_inputs(jcfg, S)))
    if want_aux is not None:
        np.testing.assert_allclose(float(got[1]), want_aux, rtol=TOL,
                                   atol=TOL)
        got = got[0]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)


@pytest.fixture
def jax_encode(carried):
    """JAX's encoder output and cached cross K/V of whisper-tiny's smoke
    config, made in setup."""
    jcfg, _ = _cfgs("whisper-tiny")
    jp, _ = carried("whisper-tiny")
    e = _enc_embeds(jcfg)
    jc = jax_encdec.init_cache(jcfg, B, 4, params=jp, enc_embeds=e)
    return (np.asarray(jax_encdec.encode(jcfg, jp, e)),
            np.asarray(jc["cross_k"]), np.asarray(jc["cross_v"]))


def test_encode_and_cross_kv_match_jax(carried, jax_encode):
    jcfg, pcfg = _cfgs("whisper-tiny")
    _, pp = carried("whisper-tiny")
    e = torch.tensor(_enc_embeds(jcfg))
    with torch.no_grad():
        got = encdec.encode(pcfg, pp, e).numpy()
        pc = encdec.init_cache(pcfg, B, 4, params=pp, enc_embeds=e,
                               device="cpu")
    want_enc, want_k, want_v = jax_encode
    np.testing.assert_allclose(got, want_enc, rtol=TOL, atol=TOL)
    for k, want in (("cross_k", want_k), ("cross_v", want_v)):
        assert tuple(pc[k].shape) == want.shape == (
            jcfg.n_layers, B, jcfg.enc_len, jcfg.n_kv_heads,
            jcfg.resolved_head_dim())
        np.testing.assert_allclose(pc[k].numpy(), want, rtol=TOL, atol=TOL)


# the reference attention's arguments beyond causal self-attention:
# cross-attention (kv=), bidirectional, RoPE off, and the hybrid's cache
# step; and the stacked-cache decode with RoPE off
ATTENTION_MODES = ["cross", "bidirectional", "no_rope", "cache_step",
                   "decode_inplace_no_rope"]


@pytest.mark.parametrize("mode", ATTENTION_MODES)
def test_attention_modes_match_jax(mode):
    from repro.models import layers as jax_L

    jcfg, pcfg = _cfgs("zamba2-1.2b")
    rng = np.random.default_rng(8)
    hd, KV = jcfg.resolved_head_dim(), jcfg.n_kv_heads
    p = {k: (rng.normal(size=s) * 0.2).astype(np.float32) for k, s in (
        ("wq", (64, 64)), ("wk", (64, KV * hd)), ("wv", (64, KV * hd)),
        ("wo", (64, 64)))}
    pt = {k: torch.tensor(v) for k, v in p.items()}
    S = 1 if mode in ("cache_step", "decode_inplace_no_rope") else 6
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    pos = np.full((B, S), 3, np.int32) if S == 1 else \
        np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    T = 7
    ck = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    cv = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    src = rng.normal(size=(B, 9, 64)).astype(np.float32)
    with torch.no_grad():
        if mode == "decode_inplace_no_rope":
            kall, vall = ck[None].copy(), cv[None].copy()
            want = jax_L.attention_decode_inplace(
                jcfg, p, x, jnp.int32(3), kall, vall, jnp.int32(0),
                use_rope=False)
            got = L.attention_decode_inplace(
                pcfg, pt, torch.tensor(x), 3, torch.tensor(kall),
                torch.tensor(vall), 0, use_rope=False)
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=TOL, atol=TOL)
            got, want = got[0], want[0]
        else:
            kw = {"cross": dict(kv=(src, src), causal=False, use_rope=False),
                  "bidirectional": dict(causal=False),
                  "no_rope": dict(use_rope=False),
                  "cache_step": dict(cache={"k": ck, "v": cv, "pos": 3})}[
                      mode]
            want, want_cache = jax_L.attention(jcfg, p, x, pos, **kw)
            pkw = dict(kw)
            if mode == "cross":
                pkw["kv"] = (torch.tensor(src), torch.tensor(src))
            if mode == "cache_step":
                pkw["cache"] = {"k": torch.tensor(ck), "v": torch.tensor(cv),
                                "pos": 3}
            got, got_cache = L.attention(pcfg, pt, torch.tensor(x),
                                         torch.tensor(pos), **pkw)
            if mode == "cache_step":
                assert got_cache["pos"] == int(want_cache["pos"]) == 4
                assert got_cache["k"] is pkw["cache"]["k"]     # in place
                for k in ("k", "v"):
                    np.testing.assert_allclose(
                        got_cache[k].numpy(), np.asarray(want_cache[k]),
                        rtol=TOL, atol=TOL)
            else:
                assert got_cache is None and want_cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _router_inputs(cfg, T=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    router = (rng.normal(size=(cfg.d_model, cfg.n_experts)) * 0.1).astype(
        np.float32)
    return x, router


def _sliced(cfg, gates, idx, xp):
    """The expert-slice expansion of moe_mlp (a token visits every slice of
    its expert with the same gate)."""
    s = max(cfg.expert_slices, 1)
    if s == 1:
        return gates, idx
    if xp is np:
        idx = (idx[..., None] * s + np.arange(s)).reshape(*idx.shape[:2], -1)
        return np.repeat(gates, s, axis=-1), idx.astype(np.int32)
    idx = (idx[..., None] * s + torch.arange(s, dtype=idx.dtype)).reshape(
        *idx.shape[:2], -1)
    return torch.repeat_interleave(gates, s, dim=-1), idx


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 16.0])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_route_and_dispatch_match_jax(name, capacity_factor):
    jcfg, pcfg = _cfgs(name, capacity_factor=capacity_factor)
    x, router = _router_inputs(jcfg)
    jg, ji, jpr = jax_moe._route(jcfg, router, x)
    pg, pi, ppr = moe._route(pcfg, torch.tensor(router), torch.tensor(x))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ppr.numpy(), np.asarray(jpr), rtol=1e-6,
                               atol=1e-7)

    C = moe.moe_capacity(pcfg, x.shape[1])
    assert C == jax_moe.moe_capacity(jcfg, x.shape[1])
    jg2, ji2 = _sliced(jcfg, np.asarray(jg), np.asarray(ji), np)
    pg2, pi2 = _sliced(pcfg, pg, pi, torch)
    jd, jcomb, jkept = jax_moe._dispatch_tensors(jcfg, jg2, ji2, C)
    pd, pcomb, pkept = moe._dispatch_tensors(pcfg, pg2, pi2, C)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pkept.numpy(), np.asarray(jkept))
    np.testing.assert_allclose(pcomb.numpy(), np.asarray(jcomb), rtol=1e-6,
                               atol=1e-7)
    # every capacity slot holds at most one token; an expert keeps at
    # most C; combine weights are the kept gates and zero where dropped
    assert float(pd.sum(dim=1).max()) <= 1.0
    assert float(pd.sum(dim=(1, 3)).max()) <= C
    kept_gates = (pg2 * pkept).sum(-1)
    np.testing.assert_allclose(pcomb.sum(dim=(2, 3)).numpy(),
                               kept_gates.numpy(), rtol=1e-6, atol=1e-6)
    if capacity_factor == 0.5:
        assert float(pkept.sum()) < pkept.numel()       # some slots dropped
    if capacity_factor == 16.0:
        assert float(pkept.sum()) == pkept.numel()      # nothing dropped


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: lax.top_k picks the lower indices
    first, and so does the port."""
    jcfg, pcfg = _cfgs("deepseek-moe-16b")
    x = np.ones((1, 4, jcfg.d_model), np.float32)
    router = np.zeros((jcfg.d_model, jcfg.n_experts), np.float32)
    router[:, 5] = router[:, 2] = 0.25     # a tie at the top, then the rest
    _, ji, _ = jax_moe._route(jcfg, router, x)
    _, pi, _ = moe._route(pcfg, torch.tensor(router), torch.tensor(x))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert pi[0, 0].tolist() == [2, 5]
    _, ji, _ = jax_moe._route(jcfg, router * 0, x)
    _, pi, _ = moe._route(pcfg, torch.zeros_like(torch.tensor(router)),
                          torch.tensor(x))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert pi[0, 0].tolist() == [0, 1]


@pytest.mark.parametrize("group", [1, 8, 24, 512, 1024])
@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_capacity_matches_jax(name, width, group):
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import get_arch

    jcfg, pcfg = (_cfgs(name) if width == "smoke"
                  else (jax_arch(name), get_arch(name)))
    c = moe.moe_capacity(pcfg, group)
    assert c == jax_moe.moe_capacity(jcfg, group)
    assert c >= 4 and c % 4 == 0


def _naive_ssd(x, a, Bv, Cv):
    B_, S, H, P = x.shape
    st = np.zeros((B_, H, P, Bv.shape[-1]))
    ys = []
    for t in range(S):
        st = st * np.exp(a[:, t])[:, :, None, None] + np.einsum(
            "bn,bhp->bhpn", Bv[:, t], x[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", Cv[:, t], st))
    return np.stack(ys, 1), st


def _ssd_inputs(seed=2, B_=2, S=64, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B_, S, H, P)).astype(np.float32)
    a = -np.log1p(np.exp(rng.normal(size=(B_, S, H)))).astype(np.float32)
    Bv = rng.normal(size=(B_, S, N)).astype(np.float32)
    Cv = rng.normal(size=(B_, S, N)).astype(np.float32)
    return x, a, Bv, Cv


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_scan_matches_naive_recurrence(chunk):
    x, a, Bv, Cv = _ssd_inputs()
    y, st = ssm._ssd_scan(*map(torch.tensor, (x, a, Bv, Cv)), chunk=chunk)
    want_y, want_st = _naive_ssd(x, a, Bv, Cv)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), want_st, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_scan_with_initial_state_matches_jax(chunk):
    x, a, Bv, Cv = _ssd_inputs(seed=3)
    s0 = np.random.default_rng(4).normal(size=(2, 3, 4, 5)).astype(
        np.float32)
    jy, jst = jax_ssm._ssd_scan(x, a, Bv, Cv, chunk, init_state=s0)
    py, pst = ssm._ssd_scan(*map(torch.tensor, (x, a, Bv, Cv)), chunk,
                            init_state=torch.tensor(s0))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pst.numpy(), np.asarray(jst), rtol=TOL,
                               atol=TOL)


def test_ssd_scan_masks_before_exp():
    """Steep decays: exp of the unmasked upper triangle would overflow to
    inf (and inf * 0 = nan); the port masks first, as the reference."""
    x, a, Bv, Cv = _ssd_inputs(seed=5, S=16)
    a = a * 200.0
    y, st = ssm._ssd_scan(*map(torch.tensor, (x, a, Bv, Cv)), chunk=16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    want_y, _ = _naive_ssd(x, a, Bv, Cv)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(6)
    u = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    np.testing.assert_allclose(
        ssm._causal_conv(*map(torch.tensor, (u, w, b))).numpy(),
        np.asarray(jax_ssm._causal_conv(u, w, b)), rtol=1e-6, atol=1e-6)


# (name, T, tolerance, config overrides): tests/test_models.py's settings
DECODE_VS_FORWARD = [
    ("deepseek-moe-16b", 12, 2e-2, dict(capacity_factor=16.0)),
    ("grok-1-314b", 12, 2e-2, dict(capacity_factor=16.0)),
    ("mamba2-130m", 16, 3e-2, dict()),
    ("zamba2-1.2b", 16, 2e-2, dict()),
    ("whisper-tiny", 12, 2e-2, dict()),
]


@pytest.mark.parametrize("name,T,tol,kw", DECODE_VS_FORWARD,
                         ids=[c[0] for c in DECODE_VS_FORWARD])
def test_decode_matches_forward_in_the_port(name, T, tol, kw):
    cfg = dataclasses.replace(smoke_config(name), **kw)
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (B, T),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    mod = registry.model_for(cfg)
    with torch.no_grad():
        if cfg.family == "encdec":
            e = torch.randn((B, cfg.enc_len, cfg.d_model),
                            generator=torch.Generator().manual_seed(3))
            full = mod.forward(cfg, params, e, toks)
            cache = registry.init_cache(cfg, B, T, device="cpu",
                                        params=params, enc_embeds=e)
        else:
            full = mod.forward(cfg, params, toks)
            cache = registry.init_cache(cfg, B, T, device="cpu")
        if isinstance(full, tuple):
            full = full[0]
        got = []
        for t in range(T):
            logits, cache = registry.decode_step(cfg, params, cache,
                                                 toks[:, t:t + 1])
            got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=tol, atol=tol)


def test_hybrid_decode_reads_its_own_cache_per_application():
    """zamba2's shared block keeps one KV cache an application: after a
    step, every application's slot at pos 0 is written, and they differ."""
    cfg = smoke_config("zamba2-1.2b")
    n_app = hybrid.n_shared_applications(cfg)
    assert n_app == len(hybrid._segment_sizes(cfg)) == 1
    full = ARCHS["zamba2-1.2b"]
    assert hybrid.n_shared_applications(full) == 7
    assert hybrid._segment_sizes(full) == [6] * 6 + [2]
    cfg3 = dataclasses.replace(cfg, n_layers=5)       # segments 2, 2, 1
    params = registry.init_params(cfg3, torch.Generator().manual_seed(1))
    cache = registry.init_cache(cfg3, B, 4, device="cpu")
    assert cache["k"].shape[0] == 3
    with torch.no_grad():
        registry.decode_step(cfg3, params, cache,
                             torch.zeros((B, 1), dtype=torch.int32))
    k0 = cache["k"][:, :, 0]
    assert bool((k0 != 0).any(dim=(1, 2, 3)).all())
    assert not torch.equal(k0[0], k0[1]) and not torch.equal(k0[1], k0[2])
    assert not bool(cache["k"][:, :, 1:].any())


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_convert_keeps_the_f32_leaves(carried, name):
    _, pcfg = _cfgs(name, param_dtype="bfloat16")
    jp, pp = carried(name, "bfloat16")
    flat = _flat(pp)
    own = _flat(registry.init_params(pcfg, torch.Generator().manual_seed(0)))
    for k, t in flat.items():
        want = (torch.float32 if k.rsplit("/", 1)[1] in L.F32_LEAVES
                else torch.bfloat16)
        assert t.dtype == want == own[k].dtype, k
    f32 = [k for k in flat if k.rsplit("/", 1)[1] in L.F32_LEAVES]
    assert bool(f32) == (ARCHS[name].family in ("moe", "ssm", "hybrid"))
    # a leaf in another dtype than the models give it is refused: an f32
    # leaf cast to bf16, or a bf16 leaf cast to f32
    path = (f32[0] if f32 else next(iter(flat))).strip("/").split("/")
    bad = copy.deepcopy(jp)
    node = bad
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]].astype(
        jnp.bfloat16 if f32 else np.float32)
    with pytest.raises(ValueError, match=path[-1]):
        convert.lm_params_from_numpy(pcfg, bad, device="cpu")


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_registry_serves_the_family(name):
    cfg = smoke_config(name)
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    kw = {}
    if cfg.family == "encdec":
        kw = dict(params=params, enc_embeds=torch.zeros(
            (B, cfg.enc_len, cfg.d_model)))
    cache = registry.init_cache(cfg, B, 4, device="cpu", **kw)
    with torch.no_grad():
        logits, cache = registry.decode_step(
            cfg, params, cache, torch.ones((B, 1), dtype=torch.int32))
    assert tuple(logits.shape) == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all()) and cache["pos"] == 1


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_serve_driver_on_the_family(name, capsys):
    argv = ["--preset", "smoke", "--arch", name, "--device", "cpu",
            "--batch", "2", "--prompt-len", "3", "--gen", "4"]
    if ARCHS[name].family == "encdec":
        with pytest.raises(SystemExit, match="token-LM families only"):
            serve.main(argv)
        return
    assert serve.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 3 tokens x 2 reqs")
    assert lines[1].startswith("generated 4 tokens x 2 reqs")


def test_generate_serves_encdec_with_its_encoder_input():
    cfg = smoke_config("whisper-tiny")
    params = serve.build(cfg, 0, "cpu")
    e = torch.randn((B, cfg.enc_len, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    r = serve.generate(cfg, params, batch=B, prompt_len=3, gen=4,
                       temperature=0.0, device="cpu", enc_embeds=e)
    assert tuple(r["tokens"].shape) == (B, 4)
    assert int(r["tokens"].max()) < cfg.vocab
    with pytest.raises(ValueError, match="enc_embeds"):
        serve.generate(cfg, params, batch=B, prompt_len=3, gen=4,
                       device="cpu")
