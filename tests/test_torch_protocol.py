"""The port's wire protocol (repro_torch/net/protocol.py) against the JAX
package's (repro/net/protocol.py), on the CPU.

Stated tolerance: exact. For the same numpy inputs every encoder writes
the same bytes; each package decodes the other's bytes to the same
fields; the fuzz cases of tests/test_protocol.py (truncation, bit flips,
duplicated and reordered frames, version skew, garbage) raise the same
named errors and resync to the same messages with the same counts.

Fault C.1 of the reference (ROADMAP C): when a resync finds no magic,
its StreamDecoder drops the whole buffer, with it the first bytes of a
magic that ends the chunk, and so the next frame. The port keeps that
tail: a multi-frame stream with garbage between the frames, split into
two chunks at every byte offset, decodes every frame.
"""
import struct
import zlib

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the seeded sweep shim (tests/_propshim.py)
    from tests._propshim import given, settings, strategies as st

from repro.net import protocol as JP  # noqa: E402
from repro_torch.net import protocol as PP  # noqa: E402
from repro_torch.parallel.compression import WireFormatError  # noqa: E402

PKGS = {"jax": JP, "port": PP}


def _frames(rng, n):
    return (rng.normal(size=(n, 8, 13, 21)).astype(np.float32) * 1e3,
            rng.normal(size=n).astype(np.float32) * 100)


def _corpus(P, seed):
    """One of each message type from seeded field values, encoded by the
    package ``P`` (the same values whichever package encodes)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    fr, y0 = _frames(rng, n)
    kept = np.sort(rng.choice(n, size=int(rng.integers(0, n + 1)),
                              replace=False)).astype(np.int32)
    scores = rng.integers(-2**20, 2**20, size=len(kept)).astype(np.int32)
    sensor = int(rng.integers(0, 2**16))
    seq = int(rng.integers(0, 2**32))
    counters = {k: int(rng.integers(0, 2**40)) for k in P.ACK_COUNTERS}
    return [
        P.encode_frame_batch(sensor, seq, fr, y0),
        P.encode_trigger_batch(sensor, seq, orig_seq=seq ^ 5, n_events=n,
                               n_admitted=n, idx=kept, scores=scores),
        P.encode_flush(sensor, seq),
        P.encode_flush_ack(sensor, seq, counters),
    ]


def _fields(m):
    """Every field of a decoded Message, arrays as (dtype, shape, bytes)."""
    out = {}
    for k in ("msg_type", "sensor_id", "seq", "orig_seq", "n_events",
              "n_admitted", "counters"):
        out[k] = getattr(m, k)
    for k in ("frames", "y0", "idx", "scores"):
        a = getattr(m, k)
        out[k] = None if a is None else (a.dtype.str, a.shape, a.tobytes())
    return out


def _outcome(P, wire):
    """decode_message's result: ("ok", fields, consumed) or ("err", the
    error's class name, TruncatedError's .needed)."""
    try:
        msg, consumed = P.decode_message(wire)
    except P.ProtocolError as e:
        return ("err", type(e).__name__, getattr(e, "needed", None))
    return ("ok", _fields(msg), consumed)


def _stream(P, chunks):
    dec = P.StreamDecoder()
    msgs = [_fields(m) for c in chunks for m in dec.feed(c)]
    return msgs, dict(dec.errors), dec.resyncs, dec.buffered


# ------------------------------------------------------------- encoders
def test_constants_and_error_family_match_the_jax_package():
    for name in ("MAGIC", "PROTOCOL_VERSION", "MSG_FRAME_BATCH",
                 "MSG_TRIGGER_BATCH", "MSG_FLUSH", "MSG_FLUSH_ACK",
                 "MSG_NAMES", "HEADER_BYTES", "FRAME_EVENT_BYTES",
                 "MAX_EVENTS_PER_BATCH", "MAX_PAYLOAD_BYTES",
                 "UDP_MAX_EVENTS", "ACK_COUNTERS"):
        assert getattr(PP, name) == getattr(JP, name), name
    assert PP._HEADER.format == JP._HEADER.format == "<4sBBHII"
    assert PP.UDP_MAX_EVENTS == 7
    assert issubclass(PP.ProtocolError, WireFormatError)
    for name in ("TruncatedError", "BadMagicError", "BadCrcError",
                 "VersionSkewError", "FieldBoundsError"):
        assert issubclass(getattr(PP, name), PP.ProtocolError), name


@given(seed=st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_every_encoder_writes_the_jax_packages_bytes(seed):
    assert _corpus(PP, seed) == _corpus(JP, seed)


def test_version_skewed_frames_are_byte_identical():
    fr, y0 = _frames(np.random.default_rng(1), 2)
    for version in (0, 2, 255):
        assert (PP.encode_frame_batch(3, 9, fr, y0, version=version)
                == JP.encode_frame_batch(3, 9, fr, y0, version=version))
        assert (PP.encode_flush(3, 9, version=version)
                == JP.encode_flush(3, 9, version=version))


@pytest.mark.parametrize("kwargs", [
    dict(sensor_id=1 << 16), dict(sensor_id=-1), dict(seq=1 << 32),
    dict(seq=-1), dict(n=0), dict(shape=(8, 13, 20))])
def test_frame_batch_encoder_refuses_what_the_jax_one_refuses(kwargs):
    rng = np.random.default_rng(0)
    fr, y0 = _frames(rng, 2 if kwargs.get("n", 2) else 1)
    if kwargs.get("n") == 0:
        fr, y0 = fr[:0], y0[:0]
    if "shape" in kwargs:
        fr = np.zeros((2,) + kwargs["shape"], np.float32)
    sensor, seq = kwargs.get("sensor_id", 0), kwargs.get("seq", 0)
    for P in PKGS.values():
        with pytest.raises(P.FieldBoundsError):
            P.encode_frame_batch(sensor, seq, fr, y0)


@pytest.mark.parametrize("kwargs", [
    dict(n_events=4, n_admitted=5, idx=[], scores=[]),
    dict(n_events=4, n_admitted=4, idx=[4], scores=[1]),
    dict(n_events=4, n_admitted=1, idx=[0, 1], scores=[1, 2]),
    dict(n_events=4, n_admitted=4, idx=[0], scores=[1, 2]),
    dict(n_events=1 << 16, n_admitted=0, idx=[], scores=[])])
def test_trigger_encoder_refuses_what_the_jax_one_refuses(kwargs):
    for P in PKGS.values():
        with pytest.raises(P.FieldBoundsError):
            P.encode_trigger_batch(0, 0, orig_seq=0, **kwargs)


# ------------------------------------------------------------- decoders
@given(seed=st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_each_package_decodes_the_others_bytes_to_equal_fields(seed):
    for wj, wp in zip(_corpus(JP, seed), _corpus(PP, seed)):
        want = _fields(JP.decode_datagram(wj))
        assert _fields(PP.decode_datagram(wj)) == want
        assert _fields(JP.decode_datagram(wp)) == want
        assert _fields(PP.decode_datagram(wp)) == want


@given(seed=st.integers(0, 2_000))
@settings(max_examples=25, deadline=None)
def test_truncations_raise_the_same_named_error(seed):
    rng = np.random.default_rng(seed)
    for wire in _corpus(JP, seed):
        cuts = set(rng.integers(0, len(wire), 8).tolist()) | {
            0, 3, 4, JP.HEADER_BYTES - 1, len(wire) - 1}
        for cut in cuts:
            got = _outcome(PP, wire[:cut])
            assert got == _outcome(JP, wire[:cut])
            assert got[:2] == ("err", "TruncatedError") and got[2] > 0


@given(seed=st.integers(0, 2_000))
@settings(max_examples=25, deadline=None)
def test_bit_flips_raise_the_same_named_error(seed):
    rng = np.random.default_rng(seed)
    for wire in _corpus(JP, seed):
        for bitpos in rng.integers(0, len(wire) * 8, size=24):
            bad = bytearray(wire)
            bad[bitpos // 8] ^= 1 << (bitpos % 8)
            got = _outcome(PP, bytes(bad))
            assert got == _outcome(JP, bytes(bad))
            assert got[0] == "err", int(bitpos)


def _reseal(wire: bytearray) -> bytes:
    wire[16:20] = struct.pack(
        "<I", zlib.crc32(bytes(wire[20:]), zlib.crc32(bytes(wire[:16]))))
    return bytes(wire)


def _malformed():
    """Named malformations of tests/test_protocol.py: version skew (with
    a fresh CRC, and a flipped version byte under a stale one), unknown
    msg_type, oversized payload_len, a trigger count past its records,
    a datagram with trailing bytes."""
    fr, y0 = _frames(np.random.default_rng(2), 2)
    ok = JP.encode_frame_batch(0, 0, fr, y0)
    stale = bytearray(ok)
    stale[4] = 2
    unknown = bytearray(ok)
    unknown[5] = 99
    big = bytearray(ok)
    big[12:16] = struct.pack("<I", JP.MAX_PAYLOAD_BYTES + 1)
    trig = bytearray(JP.encode_trigger_batch(
        0, 0, orig_seq=0, n_events=8, n_admitted=8, idx=[1, 2],
        scores=[10, 20]))
    off = JP.HEADER_BYTES + 8
    trig[off:off + 4] = struct.pack("<I", 1000)
    return {
        "version_skew": JP.encode_frame_batch(0, 0, fr, y0, version=2),
        "stale_crc_version": bytes(stale),
        "unknown_msg_type": _reseal(unknown),
        "oversized_length": bytes(big),
        "count_past_records": _reseal(trig),
        "bad_magic": b"XXXX" + ok[4:],
        "empty_flush_payload": _reseal(bytearray(
            JP.encode_flush(0, 0)[:12] + struct.pack("<I", 1)
            + b"\0" * 4 + b"x")),
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_frames_raise_the_same_named_error(case):
    wire = _malformed()[case]
    got = _outcome(PP, wire)
    assert got == _outcome(JP, wire) and got[0] == "err"
    with pytest.raises(PP.ProtocolError) as pe:
        PP.decode_datagram(wire)
    with pytest.raises(JP.ProtocolError) as je:
        JP.decode_datagram(wire)
    assert type(pe.value).__name__ == type(je.value).__name__


def test_trailing_bytes_in_a_datagram_are_refused_by_both():
    wire = JP.encode_flush(0, 0) + b"x"
    for P in PKGS.values():
        with pytest.raises(P.FieldBoundsError):
            P.decode_datagram(wire)


@given(seed=st.integers(0, 2_000))
@settings(max_examples=20, deadline=None)
def test_stream_resync_matches_the_jax_decoder(seed):
    """[A][garbage][B][corrupt C][D], one feed (no chunk boundary, so
    fault C.1 cannot arise): the same messages, errors and resyncs."""
    rng = np.random.default_rng(seed)
    a, b, c, dd = _corpus(JP, seed)
    corrupt = bytearray(c)
    corrupt[8 + int(rng.integers(0, 4))] ^= 0xFF
    stream = (a + rng.bytes(int(rng.integers(1, 64))) + b + bytes(corrupt)
              + dd)
    got = _stream(PP, [stream])
    assert got == _stream(JP, [stream])
    assert len(got[0]) == 3 and got[2] >= 2 and got[3] == 0


def test_duplicated_and_reordered_frames_match_the_jax_decoder():
    msgs = _corpus(JP, 3)
    stream = b"".join(msgs[i] for i in [0, 2, 1, 1, 3, 0])
    got = _stream(PP, [stream])
    assert got == _stream(JP, [stream])
    assert len(got[0]) == 6 and got[1] == {}


def test_garbage_around_a_frame_matches_the_jax_decoder():
    rng = np.random.default_rng(6)
    fr, y0 = _frames(rng, 3)
    wire = JP.encode_frame_batch(7, 42, fr, y0)
    # the noise ends on a byte that cannot begin the magic, so the two
    # decoders keep the same (empty) tail
    stream = rng.bytes(997) + wire + rng.bytes(1012) + b"\0"
    got = _stream(PP, [stream])
    assert got == _stream(JP, [stream])
    assert [m["seq"] for m in got[0]] == [42]


# ------------------------------------------------------ fault C.1 absent
def _c1_stream():
    """Four frames (one of each type), each behind garbage that holds no
    magic byte, so every split offset ends a chunk after an error."""
    rng = np.random.default_rng(18)
    frames = _corpus(PP, 18)
    frames[0] = PP.encode_frame_batch(
        1, 7, *_frames(rng, 1))              # the smallest frame batch
    parts, starts = [], []
    for i, wire in enumerate(frames):
        parts.append(bytes(rng.integers(0x80, 0x100, 5 + i, np.uint8)))
        starts.append(sum(map(len, parts)))
        parts.append(wire)
    return b"".join(parts), frames, starts


def test_every_split_offset_decodes_every_frame():
    stream, frames, starts = _c1_stream()
    want = [_fields(PP.decode_datagram(w)) for w in frames]
    for cut in range(len(stream) + 1):
        msgs, errors, _, buffered = _stream(
            PP, [stream[:cut], stream[cut:]])
        assert msgs == want, cut
        assert buffered == 0, cut


def test_the_jax_decoder_loses_a_frame_at_a_split_inside_its_magic():
    """The reference's fault, pinned so the test above is known to reach
    it: a chunk that ends 1-3 bytes into a magic after garbage loses that
    frame in the JAX package's decoder, and in no other split."""
    stream, frames, starts = _c1_stream()
    inside = {s + k for s in starts for k in (1, 2, 3)}
    for cut in range(len(stream) + 1):
        msgs = _stream(JP, [stream[:cut], stream[cut:]])[0]
        assert len(msgs) == (len(frames) - 1 if cut in inside
                             else len(frames)), cut
