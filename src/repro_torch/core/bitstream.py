# Copy of repro/core/bitstream.py with imports rewritten: the PyTorch port keeps its own
# numpy modules and imports nothing of the JAX package.
"""Bitstream encode/decode for the eFPGA fabric (paper §2.2/§4.2).

On the real ASIC the bitstream is shifted in through the eFPGA
configuration/status module over AXI-Lite (SUGOI control plane). Here the
bitstream is a byte string with a framed format:

    magic "FABU" | version u16 | fabric-name (u8 len + bytes)
    | header: n_nets n_inputs n_ffs n_outputs n_luts n_levels (u32 each)
    | level_sizes u32[n_levels]
    | lut_inputs  i32[n_luts*4]
    | lut_tables  packed u16[n_luts]      (16-bit truth tables)
    | output_nets i32[n_outputs]
    | ff_d_nets   i32[n_ffs] | ff_init u8[n_ffs]
    | cell_of_lut i32[n_luts] | cell_of_ff i32[n_ffs]
    | crc32 u32 over everything above

Round-tripping through bytes (including the CRC check) is the software
analogue of the paper's "successful loading of the bitstream" bring-up test;
corrupting any byte must be detected (tests/test_bitstream.py).

The scrubbing subsystem (launch/readout_server.py) extends this integrity
story from load time to *run* time: ``GoldenImageStore`` keeps each served
chip's golden bitstream plus per-replica CRC digests of its packed
configuration-memory truth-table image (core.fabric.packed_table_image),
so a background readback->verify loop can *detect* an accumulated SEU —
not just outvote it — and heal by re-encoding from the golden bitstream.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.fabric import FabricConfig

MAGIC = b"FABU"
VERSION = 2


class BitstreamError(RuntimeError):
    pass


class GoldenSlotError(BitstreamError, KeyError):
    """Lookup of a slot/tenant with no registered golden image.

    Raised by ``GoldenImageStore`` when ``digest``/``n_replicas``/
    ``verify``/``golden_config`` name a slot that was never registered or
    was discarded (e.g. a tenant evicted from the fleet whose golden image
    was dropped). Named — like the ``WireFormatError``/``ProtocolError``
    family — so callers can distinguish "unknown tenant" from a genuine
    bug, and subclasses ``KeyError`` so pre-existing ``except KeyError``
    handlers keep working.
    """

    def __init__(self, slot):
        self.slot = slot
        super().__init__(
            f"no golden image registered for slot {slot!r} "
            f"(never registered, or evicted/discarded)")

    def __str__(self) -> str:  # KeyError.__str__ would repr() the args
        return self.args[0]


def _pack_tables(tables: np.ndarray) -> np.ndarray:
    """(n, 16) 0/1 -> (n,) uint16."""
    weights = (1 << np.arange(16)).astype(np.uint32)
    return (tables.astype(np.uint32) * weights).sum(-1).astype(np.uint16)


def _unpack_tables(packed: np.ndarray) -> np.ndarray:
    return ((packed[:, None].astype(np.uint32) >> np.arange(16)) & 1).astype(np.uint8)


def encode(config: FabricConfig) -> bytes:
    c = config
    name = c.fabric_name.encode()
    parts = [
        MAGIC,
        struct.pack("<HB", VERSION, len(name)),
        name,
        struct.pack(
            "<6I",
            c.n_nets, c.n_inputs, c.n_ffs,
            len(c.output_nets), c.n_luts, len(c.level_sizes),
        ),
        np.asarray(c.level_sizes, "<u4").tobytes(),
        np.asarray(c.lut_inputs, "<i4").tobytes(),
        _pack_tables(c.lut_tables).astype("<u2").tobytes(),
        np.asarray(c.output_nets, "<i4").tobytes(),
        np.asarray(c.ff_d_nets, "<i4").tobytes(),
        np.asarray(c.ff_init, "u1").tobytes(),
        np.asarray(c.cell_of_lut, "<i4").tobytes(),
        np.asarray(c.cell_of_ff, "<i4").tobytes(),
    ]
    payload = b"".join(parts)
    return payload + struct.pack("<I", zlib.crc32(payload))


def decode(data: bytes) -> FabricConfig:
    if len(data) < 12 or data[:4] != MAGIC:
        raise BitstreamError("bad magic")
    payload, (crc,) = data[:-4], struct.unpack("<I", data[-4:])
    if zlib.crc32(payload) != crc:
        raise BitstreamError("CRC mismatch — corrupted bitstream")
    off = 4
    version, name_len = struct.unpack_from("<HB", data, off)
    off += 3
    if version != VERSION:
        raise BitstreamError(f"unsupported bitstream version {version}")
    fabric_name = data[off : off + name_len].decode()
    off += name_len
    n_nets, n_inputs, n_ffs, n_outputs, n_luts, n_levels = struct.unpack_from(
        "<6I", data, off
    )
    off += 24

    def take(dtype, count):
        nonlocal off
        a = np.frombuffer(data, dtype=dtype, count=count, offset=off)
        off += a.nbytes
        return a

    level_sizes = take("<u4", n_levels).astype(np.int64).tolist()
    lut_inputs = take("<i4", n_luts * 4).reshape(n_luts, 4).astype(np.int32)
    lut_tables = _unpack_tables(take("<u2", n_luts).astype(np.uint16))
    output_nets = take("<i4", n_outputs).astype(np.int32)
    ff_d_nets = take("<i4", n_ffs).astype(np.int32)
    ff_init = take("u1", n_ffs).astype(np.uint8)
    cell_of_lut = take("<i4", n_luts).astype(np.int32)
    cell_of_ff = take("<i4", n_ffs).astype(np.int32)
    return FabricConfig(
        fabric_name=fabric_name,
        n_nets=int(n_nets),
        n_inputs=int(n_inputs),
        n_ffs=int(n_ffs),
        level_sizes=level_sizes,
        lut_inputs=lut_inputs.copy(),
        lut_tables=lut_tables.reshape(n_luts, 16).copy(),
        output_nets=output_nets.copy(),
        ff_d_nets=ff_d_nets.copy(),
        ff_init=ff_init.copy(),
        cell_of_lut=cell_of_lut.copy(),
        cell_of_ff=cell_of_ff.copy(),
    )


# --------------------------------------------------------------------------
# Golden-image store (the reference side of the scrub loop)
# --------------------------------------------------------------------------


def table_digest(tables: np.ndarray) -> int:
    """CRC32 digest of a truth-table configuration-memory image.

    Canonicalized to contiguous uint8 bytes first, so the digest is
    identical whether the image was read back from the device stack
    (float32 0.0/1.0 arrays), from the host-oracle twin (uint8), or
    computed fresh from a decoded bitstream.
    """
    a = np.ascontiguousarray(np.asarray(tables).astype(np.uint8))
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GoldenImage:
    """One served slot's golden reference: the encoded (CRC-framed)
    bitstream to heal from, plus per-replica digests to verify against."""

    bitstream: bytes
    digests: Tuple[int, ...]


class GoldenImageStore:
    """Per-chip golden bitstreams + per-replica CRC digests.

    The scrub scheduler's reference memory: ``register`` snapshots a
    slot's golden truth at (re)configuration time, ``verify`` CRC-checks a
    live readback image against it, and ``golden_config`` decodes the
    stored bitstream (itself CRC-framed, so the reference cannot rot
    silently either) for the heal re-encode. Digests are per *replica*
    because TMR replicas are placement-rotated — each one is a distinct
    configuration-memory image of the same function (core.tmr).
    """

    def __init__(self):
        self._slots: Dict[int, GoldenImage] = {}

    def __contains__(self, slot: int) -> bool:
        return slot in self._slots

    def __len__(self) -> int:
        return len(self._slots)

    def _get(self, slot: int) -> GoldenImage:
        try:
            return self._slots[slot]
        except KeyError:
            raise GoldenSlotError(slot) from None

    def register(
        self, slot: int, config: FabricConfig,
        replica_images: Sequence[np.ndarray],
    ) -> None:
        """(Re)register a slot's golden truth: the config's bitstream and
        one packed table image per served replica encoding."""
        if not replica_images:
            raise ValueError("need at least one replica image")
        self._slots[slot] = GoldenImage(
            bitstream=encode(config),
            digests=tuple(table_digest(im) for im in replica_images),
        )

    def discard(self, slot: int) -> None:
        """Drop a slot's golden image (no-op if absent) — the terminal
        state of a tenant retired from the fleet. A later lookup raises
        ``GoldenSlotError``; an LRU-*evicted* tenant, by contrast, keeps
        its golden image so it can re-admit from it."""
        self._slots.pop(slot, None)

    def n_replicas(self, slot: int) -> int:
        return len(self._get(slot).digests)

    def digest(self, slot: int, replica: int) -> int:
        d = self._get(slot).digests
        if not 0 <= replica < len(d):
            raise ValueError(
                f"replica must be in [0, {len(d)}), got {replica!r}")
        return d[replica]

    def verify(self, slot: int, replica: int, tables: np.ndarray) -> bool:
        """True iff the live image's CRC matches the golden digest.

        Raises ``GoldenSlotError`` if the slot has no registered image —
        an unverifiable readback must not silently pass OR fail.
        """
        return table_digest(tables) == self.digest(slot, replica)

    def golden_config(self, slot: int) -> FabricConfig:
        """Decode the stored golden bitstream (CRC-checked) for healing
        or fleet re-admission. Raises ``GoldenSlotError`` on an
        unknown/discarded slot."""
        return decode(self._get(slot).bitstream)
