"""Versioned little-endian binary wire protocol for the readout link
(the port's copy of the JAX package's net/protocol.py: the same bytes in
both directions, the same named errors).

The paper's eFPGA sits in a front-end readout chip: sensors stream framed
pixel data in over a serial link and sparse trigger decisions stream back
out. This module is that link's software twin — a packed binary framing
(versioned structs à la lob_v1) shared by the TCP and UDP transports of
the asyncio front door (net/ingress.py) and the replay client
(net/replay.py).

Frame layout (all little-endian)::

    offset  size  field
    0       4     magic        b"eFPG" (resync anchor)
    4       1     version      PROTOCOL_VERSION (= 1)
    5       1     msg_type     MSG_* discriminant
    6       2     sensor_id    u16 producer id -> server chip slot
    8       4     seq          u32 per-client message sequence number
    12      4     payload_len  u32 payload bytes after the header
    16      4     crc32        zlib.crc32 over header[0:16] + payload
    20      ...   payload

The CRC covers the header fields as well as the payload — a bit flip in
``seq`` or ``sensor_id`` is as fatal to trigger accounting as one in the
pixel data, so it must be equally detectable.

Message payloads::

    FRAME_BATCH   u16 n_events + u16 reserved(0), then y0 f32[n], then
                  frames f32[n * N_T * N_Y * N_X] (C order) — the exact
                  arrays ``ReadoutServer.submit_frames`` ingests.
    TRIGGER_BATCH u32 orig_seq (the FRAME_BATCH answered), u16 n_events,
                  u16 n_admitted, u32 count, then count x (i32 flat
                  index, i32 score) — byte-identical to
                  ``parallel/compression.py``'s sparse trigger format
                  (SPARSE_HEADER_BYTES count word + SPARSE_BYTES_PER_EVENT
                  records), indices relative to the original batch.
    FLUSH         empty payload; asks the front door to force pending
                  batches through and answer with FLUSH_ACK. FLUSH takes
                  a seq like any message, so a tail drop in the data
                  stream is visible as a gap when the flush arrives.
    FLUSH_ACK     ACK_COUNTERS u64 each, in order — the per-client
                  accounting snapshot.

Decoder contract (the fuzz suite's property): every malformed input
raises a named :class:`ProtocolError` subclass — never a raw struct or
numpy error, never a silent partial decode — and :class:`StreamDecoder`
resyncs on the next magic so one corrupted frame costs one frame, not
the stream, wherever the transport splits its chunks: a resync that
finds no magic keeps the buffer's tail that may begin one.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.smartpixel import N_T, N_X, N_Y
from repro_torch.parallel.compression import (
    SPARSE_BYTES_PER_EVENT,
    SPARSE_COUNT_STRUCT,
    SPARSE_HEADER_BYTES,
    SPARSE_RECORD_STRUCT,
    WireFormatError,
)

MAGIC = b"eFPG"
PROTOCOL_VERSION = 1

MSG_FRAME_BATCH = 1
MSG_TRIGGER_BATCH = 2
MSG_FLUSH = 3
MSG_FLUSH_ACK = 4
MSG_NAMES = {
    MSG_FRAME_BATCH: "frame_batch",
    MSG_TRIGGER_BATCH: "trigger_batch",
    MSG_FLUSH: "flush",
    MSG_FLUSH_ACK: "flush_ack",
}

# magic[4s] version[B] msg_type[B] sensor_id[H] seq[I] payload_len[I] crc[I]
_HEADER = struct.Struct("<4sBBHII")      # the CRC-covered prefix (16 B)
_CRC = struct.Struct("<I")
HEADER_BYTES = _HEADER.size + _CRC.size  # 20
_CRC_OFFSET = _HEADER.size

_FRAME_VALUES = N_T * N_Y * N_X
FRAME_EVENT_BYTES = 4 + 4 * _FRAME_VALUES     # y0 + one charge frame
_FRAME_PREFIX = struct.Struct("<HH")          # n_events, reserved
_TRIG_PREFIX = struct.Struct("<IHH")          # orig_seq, n_events, n_admitted
assert struct.calcsize(SPARSE_COUNT_STRUCT) == SPARSE_HEADER_BYTES
assert struct.calcsize(SPARSE_RECORD_STRUCT) == SPARSE_BYTES_PER_EVENT
_SPARSE_REC_DT = np.dtype([("idx", "<i4"), ("score", "<i4")])

MAX_EVENTS_PER_BATCH = 1024   # u16 field, but bounded far tighter: one
# FRAME_BATCH at the cap is ~8.5 MB — anything claiming more is a
# corrupted length, and bounding it keeps StreamDecoder's wait-for-more
# state finite so a flipped payload_len cannot stall the stream forever.
MAX_PAYLOAD_BYTES = _FRAME_PREFIX.size + MAX_EVENTS_PER_BATCH * FRAME_EVENT_BYTES

# The classic 64 KiB UDP datagram ceiling: how many frame events fit one
# datagram (the replay client's UDP batch bound).
UDP_MAX_EVENTS = (65507 - HEADER_BYTES - _FRAME_PREFIX.size) // FRAME_EVENT_BYTES

ACK_COUNTERS = (
    "batches_in", "events_in", "events_admitted", "events_shed",
    "events_queue_dropped", "seq_gaps", "reorders", "duplicates",
    "decode_errors", "resyncs",
)
_ACK = struct.Struct("<" + "Q" * len(ACK_COUNTERS))


class ProtocolError(WireFormatError):
    """Base of the named decode-error family (subclasses below). Shares
    the ``WireFormatError`` root with the sparse trigger pack so 'this
    buffer is malformed' is one except-clause across the stack."""


class TruncatedError(ProtocolError):
    """Buffer ends before the frame does. ``needed`` carries the byte
    count that would complete it — StreamDecoder's wait-for-more signal."""

    def __init__(self, msg: str, needed: int = 0):
        super().__init__(msg)
        self.needed = needed


class BadMagicError(ProtocolError):
    """The 4 bytes at the frame boundary are not MAGIC."""


class BadCrcError(ProtocolError):
    """CRC32 over header[0:16]+payload disagrees with the frame's CRC."""


class VersionSkewError(ProtocolError):
    """Frame is well-formed (CRC passes) but speaks another version."""


class FieldBoundsError(ProtocolError):
    """A header or payload field is outside its documented bounds
    (unknown msg_type, oversized payload_len, count past the records,
    index outside the batch, payload length inconsistent with counts)."""


@dataclasses.dataclass(frozen=True)
class Message:
    """One decoded frame. Fields beyond (msg_type, sensor_id, seq) are
    populated per type: frames/y0 for FRAME_BATCH; orig_seq/n_events/
    n_admitted/idx/scores for TRIGGER_BATCH; counters for FLUSH_ACK."""

    msg_type: int
    sensor_id: int
    seq: int
    frames: Optional[np.ndarray] = None   # (n, N_T, N_Y, N_X) f32
    y0: Optional[np.ndarray] = None       # (n,) f32
    orig_seq: int = 0
    n_events: int = 0
    n_admitted: int = 0
    idx: Optional[np.ndarray] = None      # (count,) i32 in-batch indices
    scores: Optional[np.ndarray] = None   # (count,) i32
    counters: Optional[Dict[str, int]] = None


def _check_u16(name: str, v: int) -> int:
    if not (0 <= int(v) <= 0xFFFF):
        raise FieldBoundsError(f"{name} {v} outside u16")
    return int(v)


def _check_u32(name: str, v: int) -> int:
    if not (0 <= int(v) <= 0xFFFFFFFF):
        raise FieldBoundsError(f"{name} {v} outside u32")
    return int(v)


def _frame(msg_type: int, sensor_id: int, seq: int, payload: bytes,
           version: int = PROTOCOL_VERSION) -> bytes:
    head = _HEADER.pack(MAGIC, version, msg_type,
                        _check_u16("sensor_id", sensor_id),
                        _check_u32("seq", seq), len(payload))
    crc = zlib.crc32(payload, zlib.crc32(head))
    return head + _CRC.pack(crc) + payload


def encode_frame_batch(sensor_id: int, seq: int, frames: np.ndarray,
                       y0: np.ndarray,
                       version: int = PROTOCOL_VERSION) -> bytes:
    """Frame a raw-frame batch: exactly the ``submit_frames`` arrays."""
    frames = np.ascontiguousarray(frames, np.float32)
    y0 = np.ascontiguousarray(y0, np.float32)
    if frames.ndim != 4 or frames.shape[1:] != (N_T, N_Y, N_X):
        raise FieldBoundsError(
            f"frames must be (n, {N_T}, {N_Y}, {N_X}), got {frames.shape}")
    n = len(frames)
    if len(y0) != n:
        raise FieldBoundsError(f"{n} frames but {len(y0)} y0 values")
    if not (1 <= n <= MAX_EVENTS_PER_BATCH):
        raise FieldBoundsError(
            f"n_events {n} outside 1..{MAX_EVENTS_PER_BATCH}")
    payload = _FRAME_PREFIX.pack(n, 0) + y0.tobytes() + frames.tobytes()
    return _frame(MSG_FRAME_BATCH, sensor_id, seq, payload, version)


def encode_trigger_batch(sensor_id: int, seq: int, orig_seq: int,
                         n_events: int, n_admitted: int,
                         idx, scores,
                         version: int = PROTOCOL_VERSION) -> bytes:
    """Frame a sparse trigger answer for FRAME_BATCH ``orig_seq``.

    idx/scores are the kept events only (ascending in-batch positions),
    the count-sliced form of the sparse trigger pack."""
    idx = np.ascontiguousarray(idx, "<i4").ravel()
    scores = np.ascontiguousarray(scores, "<i4").ravel()
    if idx.size != scores.size:
        raise FieldBoundsError(
            f"{idx.size} indices but {scores.size} scores")
    n_events = _check_u16("n_events", n_events)
    n_admitted = _check_u16("n_admitted", n_admitted)
    if n_admitted > n_events:
        raise FieldBoundsError(
            f"n_admitted {n_admitted} > n_events {n_events}")
    if idx.size > n_admitted:
        raise FieldBoundsError(
            f"{idx.size} kept events > n_admitted {n_admitted}")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n_events):
        raise FieldBoundsError(
            f"kept index outside batch of {n_events} events")
    rec = np.empty(idx.size, _SPARSE_REC_DT)
    rec["idx"] = idx
    rec["score"] = scores
    payload = (_TRIG_PREFIX.pack(_check_u32("orig_seq", orig_seq),
                                 n_events, n_admitted)
               + struct.pack(SPARSE_COUNT_STRUCT, idx.size)
               + rec.tobytes())
    return _frame(MSG_TRIGGER_BATCH, sensor_id, seq, payload, version)


def encode_flush(sensor_id: int, seq: int,
                 version: int = PROTOCOL_VERSION) -> bytes:
    return _frame(MSG_FLUSH, sensor_id, seq, b"", version)


def encode_flush_ack(sensor_id: int, seq: int, counters: Dict[str, int],
                     version: int = PROTOCOL_VERSION) -> bytes:
    vals = [int(counters.get(k, 0)) for k in ACK_COUNTERS]
    return _frame(MSG_FLUSH_ACK, sensor_id, seq, _ACK.pack(*vals), version)


def _parse_frame_batch(sensor_id: int, seq: int, payload: memoryview
                       ) -> Message:
    if len(payload) < _FRAME_PREFIX.size:
        raise FieldBoundsError("frame_batch payload shorter than prefix")
    n, reserved = _FRAME_PREFIX.unpack_from(payload, 0)
    if reserved != 0:
        raise FieldBoundsError(f"frame_batch reserved field {reserved} != 0")
    if not (1 <= n <= MAX_EVENTS_PER_BATCH):
        raise FieldBoundsError(
            f"frame_batch n_events {n} outside 1..{MAX_EVENTS_PER_BATCH}")
    want = _FRAME_PREFIX.size + n * FRAME_EVENT_BYTES
    if len(payload) != want:
        raise FieldBoundsError(
            f"frame_batch payload {len(payload)} B != {want} B "
            f"for {n} events")
    off = _FRAME_PREFIX.size
    y0 = np.frombuffer(payload, "<f4", count=n, offset=off).copy()
    frames = np.frombuffer(
        payload, "<f4", count=n * _FRAME_VALUES, offset=off + 4 * n
    ).reshape(n, N_T, N_Y, N_X).copy()
    return Message(MSG_FRAME_BATCH, sensor_id, seq,
                   frames=frames, y0=y0, n_events=n)


def _parse_trigger_batch(sensor_id: int, seq: int, payload: memoryview
                         ) -> Message:
    prefix = _TRIG_PREFIX.size + SPARSE_HEADER_BYTES
    if len(payload) < prefix:
        raise FieldBoundsError("trigger_batch payload shorter than prefix")
    orig_seq, n_events, n_admitted = _TRIG_PREFIX.unpack_from(payload, 0)
    (count,) = struct.unpack_from(SPARSE_COUNT_STRUCT, payload,
                                  _TRIG_PREFIX.size)
    if n_admitted > n_events:
        raise FieldBoundsError(
            f"trigger_batch n_admitted {n_admitted} > n_events {n_events}")
    avail = (len(payload) - prefix) // SPARSE_BYTES_PER_EVENT
    if count > avail or count > n_admitted:
        # the count-prefix-larger-than-buffer corruption, caught HERE
        # (same family the unpack fix raises for the in-process link)
        raise FieldBoundsError(
            f"trigger_batch count {count} exceeds the {avail} records "
            f"on the wire (n_admitted {n_admitted})")
    if len(payload) != prefix + count * SPARSE_BYTES_PER_EVENT:
        raise FieldBoundsError(
            f"trigger_batch payload {len(payload)} B != "
            f"{prefix + count * SPARSE_BYTES_PER_EVENT} B for count {count}")
    rec = np.frombuffer(payload, _SPARSE_REC_DT, count=count, offset=prefix)
    idx = rec["idx"].astype(np.int32)
    scores = rec["score"].astype(np.int32)
    if count and (int(idx.min()) < 0 or int(idx.max()) >= n_events):
        raise FieldBoundsError(
            f"trigger_batch index outside batch of {n_events} events")
    return Message(MSG_TRIGGER_BATCH, sensor_id, seq, orig_seq=orig_seq,
                   n_events=n_events, n_admitted=n_admitted,
                   idx=idx, scores=scores)


def _parse_flush_ack(sensor_id: int, seq: int, payload: memoryview
                     ) -> Message:
    if len(payload) != _ACK.size:
        raise FieldBoundsError(
            f"flush_ack payload {len(payload)} B != {_ACK.size} B")
    vals = _ACK.unpack_from(payload, 0)
    return Message(MSG_FLUSH_ACK, sensor_id, seq,
                   counters=dict(zip(ACK_COUNTERS, vals)))


def decode_message(buf, offset: int = 0) -> Tuple[Message, int]:
    """Decode one frame at ``offset``; returns (message, bytes consumed).

    Raises the named ProtocolError family on anything malformed; raises
    TruncatedError (with ``.needed``) when the buffer simply ends early —
    the only error that means 'feed me more bytes', every other one means
    'this frame is garbage, resync'."""
    view = memoryview(buf)[offset:]
    if len(view) < len(MAGIC):
        raise TruncatedError("short of the magic",
                             needed=len(MAGIC) - len(view))
    if bytes(view[:len(MAGIC)]) != MAGIC:
        raise BadMagicError(
            f"bad magic {bytes(view[:len(MAGIC)])!r} at offset {offset}")
    if len(view) < HEADER_BYTES:
        raise TruncatedError("short of the header",
                             needed=HEADER_BYTES - len(view))
    magic, version, msg_type, sensor_id, seq, payload_len = \
        _HEADER.unpack_from(view, 0)
    (crc,) = _CRC.unpack_from(view, _CRC_OFFSET)
    if payload_len > MAX_PAYLOAD_BYTES:
        raise FieldBoundsError(
            f"payload_len {payload_len} > MAX_PAYLOAD_BYTES "
            f"{MAX_PAYLOAD_BYTES} (corrupted length)")
    total = HEADER_BYTES + payload_len
    if len(view) < total:
        raise TruncatedError("short of the payload",
                             needed=total - len(view))
    payload = view[HEADER_BYTES:total]
    got_crc = zlib.crc32(payload, zlib.crc32(view[:_CRC_OFFSET]))
    if got_crc != crc:
        raise BadCrcError(
            f"crc mismatch: frame says {crc:#010x}, bytes hash to "
            f"{got_crc:#010x}")
    if version != PROTOCOL_VERSION:
        raise VersionSkewError(
            f"frame speaks version {version}, this decoder speaks "
            f"{PROTOCOL_VERSION}")
    if msg_type == MSG_FRAME_BATCH:
        msg = _parse_frame_batch(sensor_id, seq, payload)
    elif msg_type == MSG_TRIGGER_BATCH:
        msg = _parse_trigger_batch(sensor_id, seq, payload)
    elif msg_type == MSG_FLUSH:
        if payload_len != 0:
            raise FieldBoundsError(
                f"flush payload must be empty, got {payload_len} B")
        msg = Message(MSG_FLUSH, sensor_id, seq)
    elif msg_type == MSG_FLUSH_ACK:
        msg = _parse_flush_ack(sensor_id, seq, payload)
    else:
        raise FieldBoundsError(f"unknown msg_type {msg_type}")
    return msg, total


def decode_datagram(data: bytes) -> Message:
    """Decode a datagram holding exactly one frame (the UDP contract)."""
    msg, consumed = decode_message(data, 0)
    if consumed != len(data):
        raise FieldBoundsError(
            f"datagram has {len(data) - consumed} trailing bytes after "
            "the frame")
    return msg


def _magic_tail(buf: bytearray, start: int) -> int:
    """Where the bytes that may begin the next frame start, when no whole
    MAGIC lies in ``buf[start:]``: at the longest suffix (at most
    ``len(MAGIC) - 1`` bytes) that is a prefix of MAGIC, else at the
    end. A transport chunk can end inside the next frame's magic; keeping
    that partial magic lets the next chunk complete it."""
    for k in range(min(len(MAGIC) - 1, len(buf) - start), 0, -1):
        if buf.endswith(MAGIC[:k]):
            return len(buf) - k
    return len(buf)


class StreamDecoder:
    """Incremental TCP-side decoder: buffer, decode, resync.

    ``feed(data)`` returns every complete message now decodable. A
    malformed frame is counted (``errors`` by class name), the buffer
    scans forward to the next MAGIC (``resyncs``) and decoding
    continues — one corrupted frame never takes down the connection.
    TruncatedError is NOT an error: it just means wait for more bytes
    (bounded: payload_len is capped, so at most MAX_PAYLOAD_BYTES +
    header are ever held back)."""

    def __init__(self):
        self._buf = bytearray()
        self.messages = 0
        self.resyncs = 0
        self.errors: Dict[str, int] = {}

    @property
    def errors_total(self) -> int:
        return sum(self.errors.values())

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def _count(self, exc: ProtocolError) -> None:
        name = type(exc).__name__
        self.errors[name] = self.errors.get(name, 0) + 1

    def feed(self, data: bytes) -> List[Message]:
        # decode IN PLACE on the bytearray — snapshotting it to bytes
        # would copy the whole backlog on every feed, O(backlog^2) under
        # a flood. Safe because nothing keeps a view alive past this
        # call: a caught exception (and the memoryviews its traceback
        # pins) is released when its except block exits, and every
        # decoded Message holds .copy()'d arrays.
        buf = self._buf
        buf.extend(data)
        pos = 0
        out: List[Message] = []
        while pos < len(buf):
            try:
                msg, consumed = decode_message(buf, pos)
            except TruncatedError:
                break                     # wait for more bytes
            except ProtocolError as exc:
                self._count(exc)
                # resync: skip to the NEXT magic (scan starts one byte
                # in, else a frame with a valid magic but corrupt body
                # would loop forever)
                nxt = buf.find(MAGIC, pos + 1)
                pos = nxt if nxt >= 0 else _magic_tail(buf, pos + 1)
                self.resyncs += 1
                continue
            pos += consumed
            self.messages += 1
            out.append(msg)
        if pos:
            try:
                del buf[:pos]
            except BufferError:
                # some traceback still pins a view over the buffer (a
                # resize would invalidate it) — fall back to rebuilding,
                # which copies instead of resizing
                self._buf = bytearray(memoryview(buf)[pos:])
        return out
