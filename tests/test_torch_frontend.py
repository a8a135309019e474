"""Fused frontend: frames -> (score, keep, disagree), port vs JAX.

One stack holds a chip of every registered fabric (heterogeneous specs,
used features and widths), TMR off and on, in the bit-sliced layout and
(for (a)) in the default selection-matmul layout:

(a) given IDENTICAL features (the JAX featurizer's), the port's
    post-featurize tail (quantize, bit gather, word walk + vote, decode,
    cut) gives (score, keep, disagree) bit-identical to JAX's fused pass;
(b) end to end from frames, every event matches except those whose
    quantized used-feature pattern differs between the two featurizers
    (summation-order flips, see test_torch_yprofile.py); those are at
    most 1% of events, and even there the port's result equals the numpy
    oracle fed with the port's own features.
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import frontend as jax_fe  # noqa: E402
from repro.kernels.yprofile import ops as jax_yp  # noqa: E402
from repro_torch.core.fabric import FabricSim  # noqa: E402
from repro_torch.core.quantize import quantize_raw  # noqa: E402
from repro_torch.kernels import frontend as port_fe  # noqa: E402
from repro_torch.kernels.yprofile import ops as port_yp  # noqa: E402
from repro_torch.parallel.compression import sparse_trigger_pack  # noqa: E402
from tests._torch_helpers import FABRIC_RECIPES, chip_pair, frames  # noqa: E402

B = 256
REDUNDANCIES = ("none", "tmr")


@pytest.fixture(scope="module")
def farm():
    """Chips, frames and the JAX side's features and fused results, built
    once in setup."""
    pairs = [chip_pair(f) for f in sorted(FABRIC_RECIPES)]
    C = len(pairs)
    fr, y0 = frames(C * B)
    fr, y0 = fr.reshape(C, B, 8, 13, 21), y0.reshape(C, B)
    jax_feats = np.array(jax_yp.yprofile_traced(
        jnp.asarray(fr), jnp.asarray(y0), threshold=800.0, batch_tile=128,
        interpret=True))
    jax_out = {}
    for red in REDUNDANCIES:
        jf = jax_fe.pack_frontend([p[0].config for p in pairs],
                                  [p[0].frontend_spec() for p in pairs],
                                  layout="bitsliced", redundancy=red)
        jax_out[red] = [np.asarray(x) for x in jf.score_frames_voted(fr, y0)]
    return pairs, fr, y0, jax_feats, jax_out


@pytest.fixture(scope="module")
def matmul_out(farm):
    """JAX's fused pass with layout="matmul" (its default), in setup."""
    pairs, fr, y0, _, _ = farm
    out = {}
    for red in REDUNDANCIES:
        jf = jax_fe.pack_frontend([p[0].config for p in pairs],
                                  [p[0].frontend_spec() for p in pairs],
                                  redundancy=red)
        assert jf.stack.sel is not None
        out[red] = [np.asarray(x) for x in jf.score_frames_voted(fr, y0)]
    return out


def _port_frontend(pairs, red, layout="bitsliced"):
    return port_fe.pack_frontend([p[1].config for p in pairs],
                                 [p[1].frontend_spec() for p in pairs],
                                 redundancy=red, layout=layout, device="cpu")


@pytest.mark.parametrize("red", REDUNDANCIES)
def test_tail_from_identical_features_is_bit_identical(farm, red):
    pairs, fr, y0, jax_feats, jax_out = farm
    pf = _port_frontend(pairs, red)
    valid = torch.ones((len(pairs), B), dtype=torch.bool)
    got = port_fe.score_features(torch.as_tensor(jax_feats), pf.stack,
                                 pf.plan, valid)
    for g, want, what in zip(got, jax_out[red], ("score", "keep", "dis")):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=what)
    assert got[2].shape == (len(pairs), pf.n_replicas)


@pytest.mark.parametrize("red", REDUNDANCIES)
def test_matmul_tail_from_identical_features_is_bit_identical(
        farm, matmul_out, red):
    """(a) for the matmul layout: pack_frontend's default, as in JAX."""
    pairs, _, _, jax_feats, _ = farm
    pf = port_fe.pack_frontend([p[1].config for p in pairs],
                               [p[1].frontend_spec() for p in pairs],
                               redundancy=red, device="cpu")
    assert pf.stack.layout == "banded" and pf.stack.src is None
    valid = torch.ones((len(pairs), B), dtype=torch.bool)
    got = port_fe.score_features(torch.as_tensor(jax_feats), pf.stack,
                                 pf.plan, valid)
    for g, want, what in zip(got, matmul_out[red], ("score", "keep", "dis")):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=what)


def test_matmul_and_bitsliced_frontends_agree_on_frames(farm):
    pairs, fr, y0, _, _ = farm
    a = _port_frontend(pairs, "tmr", layout="matmul")
    b = _port_frontend(pairs, "tmr")
    for x, y in zip(a.score_frames_voted(fr[:, :100], y0[:, :100]),
                    b.score_frames_voted(fr[:, :100], y0[:, :100])):
        assert torch.equal(x, y)


def _oracle(chip, feats):
    outs, _ = FabricSim(chip.config).run(chip.encode_features(feats))
    return chip.synth.decode_outputs(np.asarray(outs))


@pytest.mark.parametrize("red", REDUNDANCIES)
def test_frames_end_to_end_matches_up_to_featurizer_flips(farm, red):
    pairs, fr, y0, jax_feats, jax_out = farm
    pf = _port_frontend(pairs, red)
    score, keep, dis = (x.numpy() for x in pf.score_frames_voted(fr, y0))
    port_feats = port_yp.yprofile_traced(
        torch.as_tensor(fr), torch.as_tensor(y0), threshold=800.0).numpy()
    n_flip = n_mismatch = 0
    for c, (_, chip) in enumerate(pairs):
        used = list(chip.synth.used_features)
        spec = chip.golden.spec
        flip = (quantize_raw(port_feats[c][:, used], spec)
                != quantize_raw(jax_feats[c][:, used], spec)).any(-1)
        mism = (score[c] != jax_out[red][0][c]) | (keep[c] != jax_out[red][1][c])
        assert not (mism & ~flip).any(), f"chip {c}: non-flip mismatch"
        want = _oracle(chip, port_feats[c, :, :14])
        np.testing.assert_array_equal(score[c], want)
        np.testing.assert_array_equal(keep[c],
                                      want <= chip.score_threshold_raw)
        n_flip += int(flip.sum())
        n_mismatch += int(mism.sum())
    print(f"{red}: {n_flip} events with a quantization flip, "
          f"{n_mismatch} score/keep mismatches of {score.size}")
    assert n_flip <= 0.01 * score.size
    assert not dis.any()


def test_padding_rows_are_invalid_and_sliced(farm):
    pairs, fr, y0, _, _ = farm
    pf = _port_frontend(pairs, "none")
    score, keep, _ = pf.score_frames_voted(fr[:, :70], y0[:, :70])
    full, fkeep, _ = pf.score_frames_voted(fr, y0)
    assert score.shape == (len(pairs), 70)
    assert torch.equal(score, full[:, :70]) and torch.equal(keep,
                                                           fkeep[:, :70])
    assert (70, 128) == (score.shape[1], pf.staging[(3, 128)][0].shape[1])


# two dispatches of real rows, one after the other: (first frame, count)
# a chip; the second's counts leave rows of the first to be zeroed again
STAGED_DISPATCHES = (((0, 70), (0, 0), (0, 128)),
                     ((100, 5), (0, 128), (0, 0)))


@pytest.mark.parametrize("egress", ["voted", "sparse"])
def test_staged_rows_equal_the_padded_path(farm, egress):
    """One frontend stages two dispatches of real rows from a staging
    ring, chip-major with no padding: after each, its staging buffers
    (frames, y0, valid) hold what a padded (C, 128) dispatch of the same
    rows stages, and the results equal the padded call's."""
    pairs, fr, y0, _, _ = farm
    C, W = len(pairs), 128
    pf, ref = _port_frontend(pairs, "tmr"), _port_frontend(pairs, "tmr")
    ring = port_fe.StagingRing(2, pinned=False)
    for picks in STAGED_DISPATCHES:
        counts = [n for _, n in picks]
        rows = ring.take(counts, W)
        assert rows.offsets == tuple(np.cumsum([0] + counts[:-1]))
        fp = np.zeros((C, W, 8, 13, 21), np.float32)
        zp = np.zeros((C, W), np.float32)
        for c, ((lo, n), o) in enumerate(zip(picks, rows.offsets)):
            rows.frames.numpy()[o : o + n] = fr[c, lo : lo + n]
            rows.y0.numpy()[o : o + n] = y0[c, lo : lo + n]
            fp[c, :n], zp[c, :n] = fr[c, lo : lo + n], y0[c, lo : lo + n]
        valid = np.arange(W)[None, :] < np.asarray(counts)[:, None]
        got = getattr(pf, f"score_frames_{egress}")(rows)
        want = getattr(ref, f"score_frames_{egress}")(fp, zp, valid=valid)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        f, z, v = pf.staging[(C, W)]
        assert torch.equal(f, torch.as_tensor(fp))
        assert torch.equal(z, torch.as_tensor(zp))
        assert torch.equal(v, torch.as_tensor(valid))


def test_swap_chip_and_threshold_update_plan_rows(farm):
    pairs, fr, y0, _, _ = farm
    pf = _port_frontend(pairs, "tmr")
    new = chip_pair("efpga_130nm", seed=6)[1]
    before = {k: v.clone() for k, v in pf.plan.items()}
    sw = pf.swap_chip(0, new.config, new.frontend_spec())
    score, _, _ = sw.score_frames_voted(fr[:, :64], y0[:, :64])
    feats = port_yp.yprofile(fr[0, :64], y0[0, :64], device="cpu").numpy()
    np.testing.assert_array_equal(score[0].numpy(), _oracle(new, feats))
    row = port_fe._plan_row(new.config, new.frontend_spec(),
                            sw.stack.n_inputs, sw.stack.n_outputs)
    for k, v in before.items():
        assert torch.equal(v[1:], sw.plan[k][1:]), k
        assert sw.plan[k] is pf.plan[k], k      # written in place
        assert torch.equal(sw.plan[k][0],
                           torch.as_tensor(row[k], dtype=v.dtype)), k
    st = sw.set_threshold(2, -7)
    assert int(st.plan["threshold_raw"][2]) == -7
    assert st.chip_specs[2].threshold_raw == -7
    # the sparse pass of the swapped, retargeted stack is its dense pass,
    # packed (kernel B6's twin here)
    count, idx, vals, dis = st.score_frames_sparse(fr[:, :64], y0[:, :64])
    score, keep, dense_dis = st.score_frames_voted(fr[:, :64], y0[:, :64])
    want = sparse_trigger_pack(score, keep)
    for g, w in zip((count, idx, vals, dis), (*want, dense_dis)):
        assert torch.equal(g, w)
    assert 0 < int(count) < keep.numel()


def test_scoring_backends_agree(farm):
    """KernelBackend == HostBackend (staged oracle) on bits and on frames,
    in the default matmul layout and in the bit-sliced one; an unknown
    layout is refused by name."""
    from repro_torch.core.readout import HostBackend, KernelBackend

    pairs, fr, y0, _, _ = farm
    hb = HostBackend(device="cpu")
    for kb in (KernelBackend(device="cpu"),
               KernelBackend(layout="bitsliced", device="cpu")):
        for c, (_, chip) in enumerate(pairs):
            bits = np.random.default_rng(c).integers(
                0, 2, (45, chip.config.n_inputs)).astype(np.uint8)
            np.testing.assert_array_equal(kb.score_bits(chip.config, bits),
                                          hb.score_bits(chip.config, bits))
            np.testing.assert_array_equal(
                chip.infer_from_frames(fr[c, :50], y0[c, :50], backend=kb),
                chip.infer_from_frames(fr[c, :50], y0[c, :50], backend=hb))
    assert KernelBackend(device="cpu").layout == "matmul"
    with pytest.raises(ValueError, match="layout"):
        KernelBackend(layout="gather")
