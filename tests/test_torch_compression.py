"""The port's sparse trigger wire format against the JAX package's.

``repro_torch.parallel.compression`` (the trigger half) is held to
``repro.parallel.compression`` on fixed seeded inputs, exactly: the wire
constants, the event-domain pack (any shape, tails that end mid-word,
all-keep and all-drop), the word-domain pack and the host unpack with its
three named validation errors. On the CPU both packs run the plain twin
of kernel B6 (tests/test_torch_kernels_cuda.py holds the kernel to it on
the card).
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.parallel import compression as jax_cp  # noqa: E402
from repro_torch.launch import readout_server as port_server  # noqa: E402
from repro_torch.parallel import compression as port_cp  # noqa: E402
from tests._torch_helpers import as_int32  # noqa: E402

# (shape, keep fraction): mid-word tails, a single event, all-drop and
# all-keep, a server-like (chips, pow2 B < 32) and a multi-word grid
EVENT_CASES = [((4, 5), 0.4), ((3, 37), 0.5), ((1,), 1.0), ((2, 64), 0.0),
               ((2, 64), 1.0), ((4, 8), 0.3), ((5, 7, 3), 0.6),
               ((4, 512), 0.01)]
WORD_CASES = [((3, 4), 0.5), ((1, 1), 0.0), ((2, 3), 1.0), ((4, 16), 0.02)]


def _as_numpy(packed):
    return [np.asarray(x) for x in packed]


def test_wire_constants_equal_jax():
    for name in ("SPARSE_BYTES_PER_EVENT", "DENSE_BYTES_PER_EVENT",
                 "SPARSE_HEADER_BYTES", "SPARSE_RECORD_STRUCT",
                 "SPARSE_COUNT_STRUCT"):
        assert getattr(port_cp, name) == getattr(jax_cp, name), name
    assert port_server.DENSE_BYTES_PER_EVENT == jax_cp.DENSE_BYTES_PER_EVENT
    assert issubclass(port_cp.WireFormatError, ValueError)


@pytest.mark.parametrize("shape,frac", EVENT_CASES)
def test_event_pack_equals_jax(shape, frac):
    rng = np.random.default_rng(sum(shape) + int(frac * 100))
    score = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    keep = rng.random(shape) < frac
    want = _as_numpy(jax_cp.sparse_trigger_pack(jnp.asarray(score),
                                                jnp.asarray(keep)))
    got = port_cp.sparse_trigger_pack(torch.as_tensor(score),
                                      torch.as_tensor(keep))
    assert [g.dtype for g in got] == [torch.int32] * 3
    for g, w, what in zip(got, want, ("count", "idx", "vals")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    assert int(got[0]) == int(keep.sum())


@pytest.mark.parametrize("shape,frac", WORD_CASES)
def test_word_pack_equals_jax(shape, frac):
    C, W = shape
    rng = np.random.default_rng(C * 100 + W)
    bits = rng.random((C, W, 32)) < frac
    keep_w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)
    scores = rng.integers(-2**31, 2**31, (C, W, 32)).astype(np.int32)
    want = _as_numpy(jax_cp.sparse_trigger_pack_words(jnp.asarray(keep_w),
                                                      jnp.asarray(scores)))
    got = port_cp.sparse_trigger_pack_words(torch.as_tensor(as_int32(keep_w)),
                                            torch.as_tensor(scores))
    for g, w, what in zip(got, want, ("count", "idx", "vals")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)


@pytest.mark.parametrize("shape,frac", EVENT_CASES[:5])
@pytest.mark.parametrize("sliced", [False, True])
def test_unpack_equals_jax_and_inverts_pack(shape, frac, sliced):
    rng = np.random.default_rng(7 + len(shape))
    score = rng.integers(-1000, 1000, shape).astype(np.int32)
    keep = rng.random(shape) < frac
    count, idx, vals = port_cp.sparse_trigger_pack(torch.as_tensor(score),
                                                   torch.as_tensor(keep))
    n = int(count)
    args = ((idx[:n].numpy(), vals[:n].numpy(), shape) if sliced
            else (idx.numpy(), vals.numpy(), shape, n))
    got = port_cp.sparse_trigger_unpack(*args)
    want = jax_cp.sparse_trigger_unpack(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(got[0], score * keep)
    np.testing.assert_array_equal(got[1], keep)


@pytest.mark.parametrize("args,match", [
    ((np.zeros(3, np.int32), np.zeros(2, np.int32), (4,)), "disagree"),
    ((np.zeros(3, np.int32), np.zeros(3, np.int32), (4,), 5), "count prefix"),
    ((np.array([0, 9]), np.array([1, 2]), (2, 3)), "outside dense shape"),
    ((np.array([0, -2]), np.array([1, 2]), (2, 3)), "outside dense shape"),
])
def test_unpack_raises_wire_format_errors_as_jax(args, match):
    with pytest.raises(port_cp.WireFormatError, match=match):
        port_cp.sparse_trigger_unpack(*args)
    with pytest.raises(jax_cp.WireFormatError, match=match):
        jax_cp.sparse_trigger_unpack(*args)
