"""Bit-sliced packing, hot-swap, decode and weight conversion vs JAX.

* ``pack_fabrics(layout="bitsliced")`` arrays equal JAX's element for
  element, TMR on and off, banded and dense;
* ``swap_chip`` rewrites exactly its chip's rows (all replicas under
  TMR) and agrees with JAX's swap;
* ``decode_scores_device`` / ``decode_plan`` are exact;
* ``convert`` carries a JAX stack and encode plan across: the result
  equals the port's own pack and scores identically, for the matmul
  layout's bf16 ``sel`` too (tests/test_torch_lut_eval.py holds the
  matmul packing and kernels against JAX in full).
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import frontend as jax_fe  # noqa: E402
from repro.kernels.lut_eval import ops as jax_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import frontend as port_fe  # noqa: E402
from repro_torch.kernels.lut_eval import ops as port_ops  # noqa: E402
from tests._torch_helpers import chip_pair, frames  # noqa: E402

FABRICS = ("efpga_130nm", "efpga_28nm")
_ARRAYS = ("src", "tables", "output_nets", "level_base", "win_base")
_STATICS = ("n_inputs", "n_outputs", "n_inputs_each", "n_outputs_each",
            "n_nets_pad", "m_pad", "n_levels", "in_seg", "band_k",
            "n_replicas")


@pytest.fixture(scope="module")
def pairs():
    return [chip_pair(f) for f in FABRICS]


def _pack_both(pairs, **kw):
    j = jax_ops.pack_fabrics([p[0].config for p in pairs],
                             layout="bitsliced", **kw)
    p = port_ops.pack_fabrics([p[1].config for p in pairs], device="cpu",
                              layout="bitsliced", **kw)
    return j, p


def _assert_stack_equal(j, p):
    for k in _ARRAYS:
        want = np.asarray(getattr(j, k))
        got = getattr(p, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in _STATICS:
        assert getattr(p, k) == getattr(j, k), k


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
@pytest.mark.parametrize("band", [None, False])
def test_pack_fabrics_equals_jax(pairs, redundancy, band):
    j, p = _pack_both(pairs, redundancy=redundancy, band=band)
    _assert_stack_equal(j, p)
    assert p.n_replicas == (3 if redundancy == "tmr" else 1)


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_swap_chip_updates_only_its_rows(pairs, redundancy):
    j, p = _pack_both(pairs, redundancy=redundancy)
    new_j, new_p = chip_pair("efpga_130nm", seed=6)
    js = j.swap_chip(1, new_j.config)
    ps = p.swap_chip(1, new_p.config)
    _assert_stack_equal(js, ps)
    R = p.n_replicas
    for k in ("src", "tables", "output_nets"):
        old, new = getattr(p, k), getattr(ps, k)
        assert torch.equal(old[:R], new[:R]), k       # chip 0 untouched
        assert not torch.equal(old[R:], new[R:]), k   # chip 1 rewritten
    assert ps.n_inputs_each[1] == new_p.config.n_inputs


def test_decode_scores_and_plan_exact(pairs):
    configs_j = [p[0].config for p in pairs]
    configs_p = [p[1].config for p in pairs]
    w = port_ops.decode_plan(configs_p, 28)
    np.testing.assert_array_equal(w, jax_ops.decode_plan(configs_j, 28))
    rng = np.random.default_rng(4)
    C, R, B, O = 2, 3, 70, 28
    outs = rng.integers(0, 2, (C, B, O)).astype(np.uint8)
    dis = rng.random((C, R, B)) < 0.2
    thr = np.array([-5, 1 << 20], np.int32)
    valid = rng.random((C, B)) < 0.9
    want = jax_ops.decode_scores_device(
        jnp.asarray(outs), jnp.asarray(dis), jnp.asarray(w),
        jnp.asarray(thr), jnp.asarray(valid))
    got = port_ops.decode_scores_device(
        torch.as_tensor(outs), torch.as_tensor(dis), torch.as_tensor(w),
        torch.as_tensor(thr), torch.as_tensor(valid))
    for g, e in zip(got, want):
        assert g.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    # and against the host decoder of each chip
    for c, (_, chip) in enumerate(pairs):
        n_out = len(chip.config.output_nets)
        np.testing.assert_array_equal(
            got[0][c].numpy(), chip.synth.decode_outputs(outs[c, :, :n_out]))


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_convert_round_trips_jax_stack_and_plan(pairs, redundancy):
    jf = jax_fe.pack_frontend([p[0].config for p in pairs],
                              [p[0].frontend_spec() for p in pairs],
                              layout="bitsliced", redundancy=redundancy)
    fields = {k: np.asarray(getattr(jf.stack, k)) for k in _ARRAYS}
    fields.update({k: getattr(jf.stack, k) for k in _STATICS})
    fields["sel"] = None
    stack = convert.stack_from_numpy(fields, device="cpu")
    plan = convert.plan_from_numpy(
        {k: np.asarray(v) for k, v in jf.plan.items()}, device="cpu")
    own = port_fe.pack_frontend([p[1].config for p in pairs],
                                [p[1].frontend_spec() for p in pairs],
                                redundancy=redundancy, layout="bitsliced",
                                device="cpu")
    _assert_stack_equal(jf.stack, stack)
    _assert_stack_equal(jf.stack, own.stack)
    for k, v in own.plan.items():
        assert plan[k].dtype == v.dtype, k
        assert torch.equal(plan[k], v), k
    converted = dataclasses.replace(own, stack=stack, plan=plan, staging={})
    fr, y0 = frames(128)
    f2, z2 = np.stack([fr[:64], fr[64:]]), np.stack([y0[:64], y0[64:]])
    for a, b in zip(own.score_frames_voted(f2, z2),
                    converted.score_frames_voted(f2, z2)):
        assert torch.equal(a, b)


def test_matmul_pack_and_convert_equal_jax(pairs):
    """The default (matmul) pack and its conversion from a JAX stack (bf16
    ``sel`` through float32) equal JAX's arrays."""
    jax_stack = jax_ops.pack_fabrics([p[0].config for p in pairs])
    own = port_ops.pack_fabrics([p[1].config for p in pairs], device="cpu")
    fields = {k: np.asarray(getattr(jax_stack, k))
              for k in _ARRAYS if k != "src"}
    fields.update({k: getattr(jax_stack, k) for k in _STATICS})
    fields.update(sel=np.asarray(jax_stack.sel), src=None)
    converted = convert.stack_from_numpy(fields, device="cpu")
    for stack in (own, converted):
        assert stack.layout == jax_stack.layout and stack.src is None
        assert stack.sel.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            stack.sel.float().numpy(), np.asarray(jax_stack.sel, np.float32))
        for k in ("tables", "output_nets", "level_base", "win_base"):
            np.testing.assert_array_equal(getattr(stack, k).numpy(),
                                          np.asarray(getattr(jax_stack, k)))


def test_matmul_layout_not_ported(pairs):
    """The name is kept from when layout="matmul" was refused; both layouts
    are ported now, and what is still refused is a layout that neither
    package has, and a converted stack with neither routing array."""
    for layout in ("matmul", "bitsliced"):
        stack = port_ops.pack_fabrics([pairs[0][1].config], layout=layout,
                                      device="cpu")
        assert (stack.sel is None) == (layout == "bitsliced")
    with pytest.raises(ValueError, match="layout"):
        port_ops.pack_fabrics([pairs[0][1].config], layout="gather",
                              device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        convert.stack_from_numpy({"sel": None, "src": None}, device="cpu")
