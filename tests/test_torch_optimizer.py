"""The port's optimizers (src/repro_torch/train/optimizer.py) against the
JAX package's on the same params and grads, on the CPU.

* AdamW and Adafactor, three updates each from the same state, with new
  grads every step: params and every state leaf within RTOL = 1e-6 of
  JAX's (relative to the leaf's largest entry, as the float32 sums of
  the two packages differ in the last bits). The trees hold a stacked
  3-D factored leaf (Adafactor's per-layer RMS clip and row factor), a
  4-D stacked expert leaf, a (n_layers, D) stacked norm leaf (weight
  decay on every leaf with ndim >= 2), a matrix, a vector and a one-layer
  stack (updated whole);
* with clipping engaged and not, bf16 AdamW moments, warmup;
* ``schedule`` at every step of a warmup + cosine run, the pre-clip
  ``grad_norm`` metric and ``clip_by_global_norm``'s tree, Adafactor's
  state shapes and ``make_optimizer``;
* the port's own contracts: a stacked leaf's Adafactor update equals
  updating each layer as a leaf of its own; AdamW in slices equals AdamW
  whole; ``donate=True`` writes into the inputs and equals the
  functional update; the reference test's numpy AdamW and Adafactor's
  descent on a quadratic.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

RTOL = 1e-6
SHAPES = {
    "blocks": {"w_up": (3, 8, 6), "experts": (2, 3, 5, 4),
               "ln": {"scale": (3, 8)}},
    "embed": {"tok": (10, 8)},
    "final_norm": {"scale": (8,)},
    "one_layer": (1, 8, 6),
}


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return T.map_leaves(
        lambda s: (rng.normal(0, scale, s)).astype(np.float32), shapes)


def _port(tree):
    return T.map_leaves(torch.tensor, tree)


def _jax(tree):
    return T.map_leaves(jnp.asarray, tree)


def _np(tree):
    return T.map_leaves(lambda x: np.asarray(x, np.float32)
                        if not torch.is_tensor(x)
                        else x.float().numpy(), tree)


def _close(got, want, what):
    """Every leaf within RTOL of the leaf's largest |entry|."""
    g, w = dict(T.items(_np(got))), dict(T.items(_np(want)))
    assert g.keys() == w.keys(), what
    for k in w:
        tol = RTOL * max(float(np.abs(w[k]).max()), 1e-30)
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                   err_msg=f"{what} {k}")


def _run_both(cfg, steps=3, grad_scale=1.0):
    """Three updates of both packages from the same params and state, new
    grads each step: (port params, state, metrics), (JAX ...)."""
    jinit, jupd = jopt.make_optimizer(cfg)
    pinit, pupd = popt.make_optimizer(
        popt.OptimizerConfig(**dataclasses.asdict(cfg)))
    p0 = _tree(0)
    jp, pp = _jax(p0), _port(p0)
    js, ps = jinit(jp), pinit(pp)
    for step in range(steps):
        g = _tree(100 + step, grad_scale)
        jp, js, jm = jupd(_jax(g), js, jp)
        pp, ps, pm = pupd(_port(g), ps, pp)
    return (pp, ps, pm), (jp, js, jm)


CASES = {
    "plain": {},
    "clipped": {"clip_norm": 0.5},
    "warmup": {"warmup_steps": 4, "total_steps": 10},
    "bf16_moments": {"moment_dtype": "bfloat16"},
    "no_decay": {"weight_decay": 0.0},
}


# Adafactor keeps float32 state whatever moment_dtype: no bf16 case
@pytest.mark.parametrize("name,case", [
    (n, c) for n in ("adamw", "adafactor") for c in sorted(CASES)
    if not (n == "adafactor" and c == "bf16_moments")])
def test_update_matches_jax(name, case):
    cfg = jopt.OptimizerConfig(**{"name": name, "lr": 1e-2,
                                  "warmup_steps": 0, "total_steps": 100,
                                  **CASES[case]})
    (pp, ps, pm), (jp, js, jm) = _run_both(cfg)
    _close(pp, jp, "params")
    for key in js:
        if key == "step":
            assert int(ps["step"]) == int(js["step"]) == 3
            assert ps["step"].dtype == torch.int32
        else:
            _close(ps[key], js[key], key)
    for k in ("grad_norm", "lr"):
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=RTOL)
    if case == "bf16_moments":
        assert all(x.dtype == torch.bfloat16 for x in T.leaves(ps["m"]))


def test_adamw_converted_state_continues_like_jax():
    """A JAX state after two steps, carried by convert.opt_state_from_numpy,
    takes a third step in the port as it does in JAX."""
    cfg = jopt.OptimizerConfig(name="adamw", lr=1e-2, warmup_steps=0)
    jinit, jupd = jopt.make_optimizer(cfg)
    jp = _jax(_tree(0))
    js = jinit(jp)
    for step in range(2):
        jp, js, _ = jupd(_jax(_tree(100 + step)), js, jp)
    ps = convert.opt_state_from_numpy(None, cfg, jax.tree.map(np.asarray, js),
                                      device="cpu")
    pp = _port(jax.tree.map(np.asarray, jp))
    g = _tree(7)
    jp, js, _ = jupd(_jax(g), js, jp)
    pp, ps, _ = popt.make_optimizer(popt.OptimizerConfig(
        **dataclasses.asdict(cfg)))[1](_port(g), ps, pp)
    _close(pp, jp, "params")
    _close(ps["m"], js["m"], "m")


def test_opt_state_from_numpy_checks_keys_and_dtypes():
    cfg = jopt.OptimizerConfig(name="adafactor")
    js = jax.tree.map(np.asarray, jopt.adafactor_init(cfg, _jax(_tree(0))))
    ps = convert.opt_state_from_numpy(None, cfg, js, device="cpu")
    assert T.map_leaves(lambda x: (tuple(x.shape), x.dtype), ps) == \
        T.map_leaves(lambda x: (tuple(x.shape), torch.float32 if x.ndim
                                else torch.int32), js)
    with pytest.raises(ValueError, match="keys"):
        convert.opt_state_from_numpy(None, dataclasses.replace(
            cfg, name="adamw"), js, device="cpu")
    bad = dict(js, step=np.asarray(3, np.int64))
    with pytest.raises(ValueError, match="step"):
        convert.opt_state_from_numpy(None, cfg, bad, device="cpu")


def test_schedule_matches_jax():
    for kw in ({"lr": 1.0, "warmup_steps": 10, "total_steps": 110,
                "min_lr_frac": 0.1},
               {"lr": 3e-4, "warmup_steps": 0, "total_steps": 7},
               {"lr": 2e-3, "warmup_steps": 50, "total_steps": 60}):
        j = jopt.OptimizerConfig(**kw)
        p = popt.OptimizerConfig(**kw)
        for step in range(0, 130):
            want = float(jopt.schedule(j, jnp.asarray(step)))
            got = popt.schedule(p, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12), \
                (kw, step)
    p = popt.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110,
                             min_lr_frac=0.1)
    assert float(popt.schedule(p, 0)) == 0.0
    assert float(popt.schedule(p, 10)) == pytest.approx(1.0)
    assert float(popt.schedule(p, 110)) == pytest.approx(0.1, abs=1e-6)


def test_clipping_metric_and_tree_match_jax():
    g = _tree(3, scale=1e3)
    jt, jn = jopt.clip_by_global_norm(_jax(g), 1.0)
    pt, pn = popt.clip_by_global_norm(_port(g), 1.0)
    assert float(pn) == pytest.approx(float(jn), rel=RTOL)
    assert float(pn) > 1e3        # the norm before clipping
    _close(pt, jt, "clipped")
    assert float(popt.global_norm(pt)) == pytest.approx(1.0, rel=1e-5)
    cfg = popt.OptimizerConfig(lr=1.0, warmup_steps=0, min_lr_frac=1.0,
                               clip_norm=1.0, weight_decay=0.0)
    p = {"w": torch.zeros((8, 8))}
    _, _, m = popt.adamw_update(cfg, {"w": torch.full((8, 8), 1e6)},
                                popt.adamw_init(cfg, p), p)
    assert float(m["grad_norm"]) > 1e6


def test_adafactor_state_shapes_match_jax():
    cfg = jopt.OptimizerConfig(name="adafactor")
    want = jopt.adafactor_init(cfg, _jax(_tree(0)))
    got = popt.adafactor_init(popt.OptimizerConfig(name="adafactor"),
                              _port(_tree(0)))
    assert T.map_leaves(lambda x: tuple(x.shape), got) == \
        T.map_leaves(lambda x: tuple(x.shape), want)
    st = popt.adafactor_init(cfg, {"w": torch.zeros((64, 32)),
                                   "b": torch.zeros((32,))})
    assert st["v"]["w"]["vr"].shape == (64,)
    assert st["v"]["w"]["vc"].shape == (32,)
    assert st["v"]["b"]["v"].shape == (32,)
    assert all(x.dtype == torch.float32 for x in T.leaves(st["v"]))


def test_adafactor_updates_a_stacked_leaf_layer_by_layer():
    """Each layer of a stacked factored leaf moves as that layer would as a
    leaf of its own (its own RMS clip and row factor); updating the stack
    as one matrix would not."""
    cfg = popt.OptimizerConfig(name="adafactor", lr=0.1, warmup_steps=0,
                               clip_norm=1e9)
    rng = np.random.default_rng(4)
    # layers with grads of very different sizes: the per-leaf RMS would
    # clip them all alike
    p = torch.tensor(rng.normal(0, 1, (3, 8, 6)), dtype=torch.float32)
    g = torch.tensor(rng.normal(0, 1, (3, 8, 6)) * np.array(
        [1e-3, 1.0, 1e3])[:, None, None], dtype=torch.float32)
    init, upd = popt.make_optimizer(cfg)
    got, _, _ = upd({"w": g}, init({"w": p}), {"w": p})
    for i in range(3):
        one, _, _ = upd({"w": g[i]}, init({"w": p[i]}), {"w": p[i]})
        torch.testing.assert_close(got["w"][i], one["w"], rtol=0, atol=0)
    whole, _, _ = upd({"w": g.reshape(24, 6)},
                      init({"w": p.reshape(24, 6)}), {"w": p.reshape(24, 6)})
    assert not torch.allclose(got["w"], whole["w"].reshape(3, 8, 6))


def test_adamw_in_slices_equals_adamw_whole(monkeypatch):
    cfg = popt.OptimizerConfig(lr=1e-2, warmup_steps=0, clip_norm=0.5)
    p, g = _port(_tree(0)), _port(_tree(1))
    whole = popt.adamw_update(cfg, g, popt.adamw_init(cfg, p), p)
    monkeypatch.setattr(popt, "_SLICE", 7)
    sliced = popt.adamw_update(cfg, g, popt.adamw_init(cfg, p), p)
    for a, b in zip(T.leaves(whole[:2]), T.leaves(sliced[:2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_donate_updates_in_place_and_equals_functional(name):
    cfg = popt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=0)
    init, upd = popt.make_optimizer(cfg)
    p, g = _port(_tree(0)), _port(_tree(1))
    s = init(p)
    want_p, want_s, _ = upd(g, s, p)
    assert int(s["step"]) == 0 and not torch.equal(
        want_p["embed"]["tok"], p["embed"]["tok"])
    got_p, got_s, _ = upd(g, s, p, donate=True)
    assert got_p["embed"]["tok"] is p["embed"]["tok"]
    assert got_s["step"] is s["step"] and int(s["step"]) == 1
    for a, b in zip(T.leaves((want_p, want_s)), T.leaves((got_p, got_s))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        popt.make_optimizer(popt.OptimizerConfig(name="sgd"))


def _numpy_adamw_step(p, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8,
                      wd=0.01):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1**t)
    vh = v / (1 - b2**t)
    upd = mh / (np.sqrt(vh) + eps) + (wd * p if p.ndim >= 2 else 0)
    return p - lr * upd, m, v


def test_adamw_matches_numpy_reference():
    cfg = popt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10**9,
                               min_lr_frac=1.0, clip_norm=1e9)
    rng = np.random.default_rng(0)
    p = rng.normal(0, 1, (4, 3)).astype(np.float32)
    g = rng.normal(0, 1, (4, 3)).astype(np.float32)
    pt = {"w": torch.tensor(p)}
    newp, _, _ = popt.adamw_update(cfg, {"w": torch.tensor(g)},
                                   popt.adamw_init(cfg, pt), pt)
    ref, _, _ = _numpy_adamw_step(p, g, np.zeros((4, 3)), np.zeros((4, 3)),
                                  1, 1e-2)
    np.testing.assert_allclose(newp["w"].numpy(), ref, rtol=1e-5)


def test_adafactor_shrinks_loss_quadratic():
    cfg = popt.OptimizerConfig(name="adafactor", lr=0.1, warmup_steps=0,
                               total_steps=10**9, min_lr_frac=1.0,
                               weight_decay=0.0)
    init, update = popt.make_optimizer(cfg)
    target = torch.tensor(np.random.default_rng(1).normal(0, 1, (16, 8)),
                          dtype=torch.float32)
    p = {"w": torch.zeros((16, 8))}
    state = init(p)
    for _ in range(60):
        p, state, _ = update({"w": p["w"] - target}, state, p)
    assert float(torch.mean(torch.square(p["w"] - target))) < 0.05
