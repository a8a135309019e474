"""Bit-sliced word evaluation: the port equals the JAX package EXACTLY.

On the same packed arrays, the port's word functions (int32 bit patterns)
equal JAX's (uint32) bit for bit, and both equal the numpy host oracles
(``pack_event_words``, ``BitslicedSim``). Covered: R=1 and R=3 (with an
upset replica, so the disagreement words are not trivially zero), batch
sizes off the 32-event word boundary, banded and dense envelopes.
"""
import pytest

pytest.importorskip("jax")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels.lut_eval import bitsliced as jax_bs  # noqa: E402
from repro.kernels.lut_eval import ops as jax_ops  # noqa: E402
from repro_torch.core.fabric import (  # noqa: E402
    BitslicedSim,
    pack_event_words,
    unpack_event_words,
)
from repro_torch.kernels.lut_eval import bitsliced as port_bs  # noqa: E402
from repro_torch.kernels.lut_eval import ops as port_ops  # noqa: E402
from tests._torch_helpers import as_int32, chip_pair  # noqa: E402

FABRICS = ("efpga_130nm", "efpga_28nm")


@pytest.fixture(scope="module", autouse=True)
def _trained():
    """Train the chips once, in setup (outside the per-test budget)."""
    for f in FABRICS:
        chip_pair(f)


def _stacks(redundancy, band):
    pairs = [chip_pair(f) for f in FABRICS]
    j = jax_ops.pack_fabrics([p[0].config for p in pairs], band=band,
                             redundancy=redundancy, layout="bitsliced")
    p = port_ops.pack_fabrics([p[1].config for p in pairs], band=band,
                              redundancy=redundancy, layout="bitsliced",
                              device="cpu")
    return pairs, j, p


def _jit(fn, **static):
    """The JAX reference, compiled once per call site (its eager form
    re-dispatches every per-level op)."""
    return jax.jit(functools.partial(fn, **static))


def _bits(stack, B, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (stack.n_chips, B, stack.n_inputs),
                        dtype=np.int32)


@pytest.mark.parametrize("B", [1, 31, 77, 256])
def test_pack_unpack_words_match_jax_and_numpy(B):
    rng = np.random.default_rng(B)
    bits = rng.integers(0, 2, (3, B, 5)).astype(np.uint8)
    bits[:, -1] = 1                              # lane 31 set: sign bit
    got = port_bs.pack_words(torch.as_tensor(bits)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, as_int32(jax_bs.pack_words(bits)))
    np.testing.assert_array_equal(got, pack_event_words(bits).view(np.int32))
    back = port_bs.unpack_words(torch.as_tensor(got), B).numpy()
    np.testing.assert_array_equal(back, bits)
    np.testing.assert_array_equal(
        back, unpack_event_words(got.view(np.uint32), B))


@pytest.mark.parametrize("band", [None, False])
def test_eval_words_matches_jax_and_bitsliced_sim(band):
    pairs, j, p = _stacks("none", band)
    assert p.banded == (band is None) and p.band_k == j.band_k
    bits = _bits(p, 77, 0)
    seg = port_bs.input_words(torch.as_tensor(bits), p.n_inputs, p.in_seg)
    np.testing.assert_array_equal(
        seg.numpy(), as_int32(jax_bs.input_words(bits, j.n_inputs,
                                                 j.in_seg)))
    got = port_bs.eval_words(p.src, p.tables, p.output_nets, seg).numpy()
    want = _jit(jax_bs.eval_words)(j.src, j.tables, j.output_nets,
                                   jnp.asarray(seg.numpy().view(np.uint32)))
    np.testing.assert_array_equal(got, as_int32(want))
    for c, (_, chip) in enumerate(pairs):
        cfg = chip.config
        words = pack_event_words(bits[c, :, : cfg.n_inputs].astype(np.uint8))
        np.testing.assert_array_equal(
            got[c, :, : len(cfg.output_nets)],
            BitslicedSim(cfg).run_words(words).view(np.int32))


@pytest.mark.parametrize("upset", [False, True])
def test_eval_words_voted_tmr_matches_jax(upset):
    _, j, p = _stacks("tmr", None)
    bits = _bits(p, 200, 1)
    tables = p.tables.clone()
    if upset:                    # replica 1 of chip 0 flips table entries
        tables[1, :, :8, ::3] = 1.0 - tables[1, :, :8, ::3]
    kw = dict(n_replicas=3, n_inputs=p.n_inputs, in_seg=p.in_seg)
    voted, dis = port_bs.eval_words_voted(
        p.src, tables, p.output_nets, torch.as_tensor(bits), **kw)
    jv, jd = _jit(jax_bs.eval_words_voted, **kw)(
        j.src, jnp.asarray(tables.numpy()), j.output_nets, bits)
    np.testing.assert_array_equal(voted.numpy(), as_int32(jv))
    np.testing.assert_array_equal(dis.numpy(), as_int32(jd))
    assert bool((dis != 0).any()) == upset
    # the event-domain form too (tail lanes dropped)
    pv, pdis = port_bs.eval_bits_voted(
        p.src, tables, p.output_nets, torch.as_tensor(bits), **kw)
    jv, jdis = _jit(jax_bs.eval_bits_voted, **kw)(
        j.src, jnp.asarray(tables.numpy()), j.output_nets, bits)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pdis.numpy(), np.asarray(jdis))


def test_eval_bits_no_vote_matches_jax():
    _, j, p = _stacks("none", None)
    bits = _bits(p, 45, 2)
    got = port_bs.eval_bits(p.src, p.tables, p.output_nets,
                            torch.as_tensor(bits), n_inputs=p.n_inputs,
                            in_seg=p.in_seg).numpy()
    want = _jit(jax_bs.eval_bits, n_inputs=j.n_inputs, in_seg=j.in_seg)(
        j.src, j.tables, j.output_nets, bits)
    np.testing.assert_array_equal(got, np.asarray(want))
    voted, dis = port_bs.eval_seg_voted(
        p.src, p.tables, p.output_nets,
        port_bs.input_words(torch.as_tensor(bits), p.n_inputs, p.in_seg), 1)
    assert dis.shape == (2, 1, 2) and not bool(dis.any())


def test_word_tile_fits_shared_memory():
    # every level's descriptors of the chip (8 + 2 B a LUT), the net
    # buffer (the input segment once, then each replica's level slots)
    # and the disagreement words
    n = 3 * 13 * 128
    assert port_bs.smem_bytes(3, 256, 13, 128, 8) == (
        n * 10 + 8 * (256 + n) * 4 + 3 * 8 * 4)
    assert port_bs.scratch_bytes(4, 3, 13, 128) == 4 * n * 10
    assert port_bs.word_tile(3, 256, 13, 128, 256) == 8
    assert port_bs.word_tile(1, 256, 13, 128, 256) == 28
    assert port_bs.word_tile(1, 256, 13, 128, 8) == 8
    assert port_bs.word_tile(3, 256, 13, 128, 256, n_chips=4, n_sms=132) == 8
    assert port_bs.word_tile(1, 256, 13, 128, 256, n_chips=4, n_sms=132) == 8
    assert port_bs.word_tile(1, 256, 13, 128, 8, n_chips=4, n_sms=132) == 1
    assert port_bs.word_tile(3, 256, 13, 128, 16, n_chips=4, n_sms=132) == 1
    # 50 levels under TMR take the split walk (one replica a block); the
    # refusal stays for an envelope whose one word's net buffer does not
    # fit (past the streamed walk)
    assert port_bs.walk_path(3, 256, 50, 128) == "split"
    with pytest.raises(ValueError, match="shared"):
        port_bs.word_tile(3, 256, 460, 128, 4)

