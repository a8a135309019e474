"""Packing + serving entry points of the fabric evaluators (torch port).

The JAX package's kernels/lut_eval/ops.py, both device layouts:

* ``layout="matmul"`` (the default, as in the reference): the one-hot
  selection tensor ``sel`` routes every level through a selection product
  (lut_eval.py, dense or banded, csrc/lut_eval.cu on the card);
* ``layout="bitsliced"``: compact ``src`` gather indices, 32 events per
  word (bitsliced.py, csrc/bitsliced.cu on the card).

``pack_fabric`` packs one decoded bitstream into a ``PackedFabric`` and
``fabric_eval`` evaluates a batch of events on it (the §5 path of
``ReadoutChip.verify_vs_golden`` through ``KernelBackend``).
``pack_fabrics`` stacks N bitstreams into one ``PackedFabricStack``
sharing a padded geometry (the chip axis is the leading tensor dimension
of one device's tensors) — the union of the configs, or a given envelope:
``bucket_envelope`` snaps a config onto a coarse grid of envelopes and
``pack_fabric_pool`` packs one stack a bucket, the geometry pool of the
multi-tenant fleet (launch/fleet.py) —, ``swap_chip`` hot-swaps one
chip's rows, ``swap_replica``
one replica row and ``readback_replica`` reads a replica's truth tables
back (the scrub loop's ports), and
``_eval_stack_scored`` is the fabric and decode stage of the fused
frontend: ``fabric_eval_bits_voted`` + ``decode_scores_device`` on a
matmul stack, the bit-sliced walk + kernel B6 (kernels/sparse_pack) on a
bit-sliced one.

Slabs: ``place_stack`` lays a stack out on a device plan
(launch.mesh.ReadoutMesh.slabs), a ``SlabStack`` of one
``PackedFabricStack`` a device, each holding a contiguous run of chips.
``scored_slabs`` launches every slab's dispatch on its own device, and
``merge_scored`` / ``merge_sparse`` join the slabs' results on the host,
equal to the one-slab dispatch's element for element (the reference
``shard_map``s the chip axis and compacts the sparse pairs after the
manual region, over one ascending flat index space).

Routing is packed *banded* whenever it is cheaper: level l's selection
rows cover only [input segment | window of the K preceding levels], K the
fan-in reach, and the dense layout is the fallback when K >= L. For the
bit-sliced layout the band is a pure reach envelope validated at pack and
swap time.

Redundancy: ``pack_fabrics(..., redundancy="tmr")`` packs three
placement-distinct replica encodings of every chip (core.tmr.
replicate_config) as contiguous rows ``slot*3 .. slot*3+2``; the matmul
layout evaluates every row and votes in torch ops, the bit-sliced kernel
votes inside the launch.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fabric import (
    FabricConfig,
    StackGeometry,
    check_stackable,
    packed_table_image,
    stack_event_bits,
)
from repro_torch.core.tmr import N_REPLICAS, majority_vote, replicate_config
from repro_torch.device import resolve_device
from repro_torch.kernels.lut_eval import bitsliced as _bitsliced
from repro_torch.kernels.lut_eval.lut_eval import (
    lut_eval_banded_stacked,
    lut_eval_stacked,
)
from repro_torch.kernels.sparse_pack import sparse_pack as _sparse_pack
from repro_torch.stages import SPANS

LAYOUTS = ("matmul", "bitsliced")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_no_ffs(c: FabricConfig) -> None:
    if c.n_ffs:
        raise ValueError(
            "lut_eval kernel handles combinational modules (the readout "
            "classifier); sequential firmware uses core.fabric.FabricSim"
        )


def _sel_tensor(sel: np.ndarray, device) -> torch.Tensor:
    """0/1 float32 selection -> bf16 on ``device`` (exact for 0/1)."""
    return torch.as_tensor(sel, dtype=torch.float32).to(
        device=device, dtype=torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class PackedFabric:
    """Device-tensor form of one decoded bitstream.

    ``band_k`` < ``n_levels`` means the selection tensor is banded: ``sel``
    has ``in_seg + band_k*m_pad`` rows per level and ``win_base[l]`` is the
    window's read offset into the full net buffer. ``layout="bitsliced"``
    replaces ``sel`` (then None) with the compact ``src`` gather indices.
    ``tables`` is the same scrub-loop image in both layouts.
    """

    sel: Optional[torch.Tensor]   # (L, n_rows, 4*M) bf16 0/1
    tables: torch.Tensor          # (L, M, 16) f32
    level_base: torch.Tensor      # (L,) int32
    output_nets: torch.Tensor     # (n_outputs,) int32 (padded layout)
    win_base: torch.Tensor        # (L,) int32 — banded window read offsets
    n_inputs: int
    n_nets_pad: int
    m_pad: int
    n_levels: int
    in_seg: int
    band_k: int
    src: Optional[torch.Tensor] = None   # (L, M, 4) int32 — bitsliced only

    @property
    def banded(self) -> bool:
        return self.band_k < self.n_levels

    @property
    def bitsliced(self) -> bool:
        return self.src is not None

    @property
    def device(self) -> torch.device:
        return self.tables.device


@dataclasses.dataclass(frozen=True)
class PackedFabricStack:
    """N decoded bitstreams stacked into chip-batched device tensors.

    All chips share the padded geometry (L, M, in_seg); narrower chips are
    zero-padded and ``output_nets`` is padded with net 0 (const0). With
    ``n_replicas`` > 1 the leading axis holds the replica rows of each
    logical chip contiguously (chip ``c`` -> rows ``c*R .. c*R+R-1``); the
    width tuples stay per logical chip. Exactly one of ``sel`` (matmul
    layout) and ``src`` (bit-sliced layout) is set.
    """

    tables: torch.Tensor       # (R*C, L, M, 16) f32
    level_base: torch.Tensor   # (L,) int32 — shared
    output_nets: torch.Tensor  # (R*C, n_outputs_max) int32
    win_base: torch.Tensor     # (L,) int32 — shared banded window offsets
    n_inputs: int
    n_outputs: int
    n_inputs_each: Tuple[int, ...]
    n_outputs_each: Tuple[int, ...]
    n_nets_pad: int
    m_pad: int
    n_levels: int
    in_seg: int
    band_k: int
    n_replicas: int = 1
    sel: Optional[torch.Tensor] = None   # (R*C, L, n_rows, 4*M) bf16 0/1
    src: Optional[torch.Tensor] = None   # (R*C, L, M, 4) int32

    @property
    def n_chips(self) -> int:
        """LOGICAL chip count (replica rows are n_replicas * n_chips)."""
        return len(self.n_inputs_each)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @property
    def banded(self) -> bool:
        return self.band_k < self.n_levels

    @property
    def bitsliced(self) -> bool:
        return self.src is not None

    @property
    def layout(self) -> str:
        """'bitsliced', 'banded' or 'dense' — how this stack evaluates."""
        if self.bitsliced:
            return "bitsliced"
        return "banded" if self.banded else "dense"

    def _envelope(self) -> StackGeometry:
        return StackGeometry(
            n_levels=self.n_levels,
            max_level_size=self.m_pad,
            n_inputs=self.n_inputs,
            n_outputs=self.n_outputs,
            fanin_reach=self.band_k if self.banded else None,
        )

    def _check_admits(self, config: FabricConfig) -> None:
        geo = self._envelope()
        if config.n_ffs or not geo.admits(config):
            raise ValueError(
                f"config does not fit stack envelope {geo} "
                f"(levels={len(config.level_sizes)}, "
                f"widest={max(config.level_sizes, default=1)}, "
                f"inputs={config.n_inputs}, outputs={len(config.output_nets)},"
                f" ffs={config.n_ffs}, fanin_reach={config.fanin_reach()})"
            )

    def swap_chip(self, slot: int, config: FabricConfig, *,
                  in_place: bool = False) -> "PackedFabricStack":
        """Hot-swap one chip's bitstream: a row update of fresh tensors
        (the old stack stays valid for batches already in flight), or with
        ``in_place`` a write into this stack's own tensors, which the
        returned stack shares (the readout server's hot swap: it has
        drained every batch first, and a CUDA write is ordered behind the
        launches before it on the stream). On a redundant stack all
        replica rows are re-encoded."""
        self._check_admits(config)
        R = self.n_replicas
        pack_one = _pack_arrays_bitsliced if self.bitsliced else _pack_arrays
        packed = [
            pack_one(replicate_config(config, r) if R > 1 else config,
                     self.n_levels, self.m_pad, self.in_seg, self.n_outputs,
                     band_k=self.band_k if self.banded else None)
            for r in range(R)
        ]
        lo = slot * R

        def rows(old: torch.Tensor, k: int) -> torch.Tensor:
            new = old if in_place else old.clone()
            new[lo : lo + R] = torch.as_tensor(
                np.stack([p[k] for p in packed])).to(old.device, old.dtype)
            return new

        routing = (dict(src=rows(self.src, 0)) if self.bitsliced
                   else dict(sel=rows(self.sel, 0)))
        each_in = list(self.n_inputs_each)
        each_out = list(self.n_outputs_each)
        each_in[slot] = config.n_inputs
        each_out[slot] = len(config.output_nets)
        return dataclasses.replace(
            self,
            tables=rows(self.tables, 1),
            output_nets=rows(self.output_nets, 2),
            n_inputs_each=tuple(each_in),
            n_outputs_each=tuple(each_out),
            **routing,
        )

    def swap_replica(
        self, slot: int, replica: int, config: FabricConfig
    ) -> "PackedFabricStack":
        """Replace ONE replica row — the fault-injection and heal port of
        the scrub loop — as a row update of fresh tensors, like
        ``swap_chip``. The other replicas and the per-chip widths are
        untouched; the config must keep the slot's IO widths."""
        R = self.n_replicas
        if not 0 <= replica < R:
            raise ValueError(f"replica must be in [0, {R}), got {replica!r}")
        self._check_admits(config)
        if (config.n_inputs != self.n_inputs_each[slot]
                or len(config.output_nets) != self.n_outputs_each[slot]):
            raise ValueError(
                f"replica IO widths ({config.n_inputs} in, "
                f"{len(config.output_nets)} out) must match slot {slot}'s "
                f"({self.n_inputs_each[slot]} in, "
                f"{self.n_outputs_each[slot]} out)"
            )
        pack_one = _pack_arrays_bitsliced if self.bitsliced else _pack_arrays
        packed = pack_one(config, self.n_levels, self.m_pad, self.in_seg,
                          self.n_outputs,
                          band_k=self.band_k if self.banded else None)
        r = slot * R + replica

        def row(old: torch.Tensor, k: int) -> torch.Tensor:
            new = old.clone()
            new[r] = torch.as_tensor(packed[k]).to(old.device, old.dtype)
            return new

        routing = (dict(src=row(self.src, 0)) if self.bitsliced
                   else dict(sel=row(self.sel, 0)))
        return dataclasses.replace(
            self, tables=row(self.tables, 1),
            output_nets=row(self.output_nets, 2), **routing)

    def replica_tables(self, slot: int, replica: int = 0) -> torch.Tensor:
        """The live (n_levels, m_pad, 16) tables row of one replica, on
        the stack's device (the scrub loop's readback source)."""
        return self.tables[slot * self.n_replicas + replica]

    def readback_replica(self, slot: int, replica: int = 0) -> np.ndarray:
        """ONE replica's live truth tables as the (n_levels, m_pad, 16)
        uint8 scrub-loop image (core.fabric.packed_table_image): what the
        kernels evaluate with, any injected upset included. The tables
        are exact 0.0/1.0, so the cast is lossless. Synchronous."""
        R = self.n_replicas
        if not 0 <= slot < self.n_chips:
            raise ValueError(
                f"slot must be in [0, {self.n_chips}), got {slot!r}")
        if not 0 <= replica < R:
            raise ValueError(f"replica must be in [0, {R}), got {replica!r}")
        return self.tables[slot * R + replica].cpu().numpy().astype(np.uint8)

    def readback_chip(self, slot: int) -> np.ndarray:
        """Every replica row of one logical chip: (n_replicas, n_levels,
        m_pad, 16) uint8."""
        return np.stack([
            self.readback_replica(slot, r) for r in range(self.n_replicas)
        ])


# the geometry a SlabStack's slabs share, read from its first slab
_SHARED = ("n_inputs", "n_outputs", "n_nets_pad", "m_pad", "n_levels",
           "in_seg", "band_k", "n_replicas", "banded", "bitsliced",
           "layout")
# a stack's tensors with a row a (chip, replica), and those it shares
_CHIP_ROWS = ("tables", "output_nets", "sel", "src")
_COMMON = ("level_base", "win_base")


def _slab_index(first_chips: Sequence[int], n_chips: int,
                slot: int) -> Tuple[int, int]:
    """(slab, slot within it) of chip ``slot``."""
    if not 0 <= slot < n_chips:
        raise ValueError(f"slot must be in [0, {n_chips}), got {slot!r}")
    s = bisect.bisect_right(first_chips, slot) - 1
    return s, slot - first_chips[s]


@dataclasses.dataclass(frozen=True)
class SlabStack:
    """A stack split over a device plan: ``slabs[s]`` is the
    ``PackedFabricStack`` of the chips from ``first_chips[s]`` on, on its
    own device, every slab of one geometry (``place_stack`` builds it).
    The cut falls on chip boundaries, so a chip's replica rows, and its
    TMR vote, stay inside one slab. The geometry attributes read the
    first slab's; ``swap_chip``, ``swap_replica``, ``readback_replica``,
    ``readback_chip`` and ``replica_tables`` route a slot to its slab."""

    slabs: Tuple[PackedFabricStack, ...]
    first_chips: Tuple[int, ...]

    def __getattr__(self, name):
        if name in _SHARED:
            return getattr(self.slabs[0], name)
        raise AttributeError(name)

    @property
    def n_chips(self) -> int:
        return sum(s.n_chips for s in self.slabs)

    @property
    def n_inputs_each(self) -> Tuple[int, ...]:
        return sum((s.n_inputs_each for s in self.slabs), ())

    def slab_of(self, slot: int) -> Tuple[int, int]:
        return _slab_index(self.first_chips, self.n_chips, slot)

    def _with(self, s: int, slab: PackedFabricStack) -> "SlabStack":
        slabs = list(self.slabs)
        slabs[s] = slab
        return dataclasses.replace(self, slabs=tuple(slabs))

    def swap_chip(self, slot: int, config: FabricConfig, *,
                  in_place: bool = False) -> "SlabStack":
        s, j = self.slab_of(slot)
        return self._with(s, self.slabs[s].swap_chip(j, config,
                                                     in_place=in_place))

    def swap_replica(self, slot: int, replica: int,
                     config: FabricConfig) -> "SlabStack":
        s, j = self.slab_of(slot)
        return self._with(s, self.slabs[s].swap_replica(j, replica, config))

    def replica_tables(self, slot: int, replica: int = 0) -> torch.Tensor:
        s, j = self.slab_of(slot)
        return self.slabs[s].replica_tables(j, replica)

    def readback_replica(self, slot: int, replica: int = 0) -> np.ndarray:
        s, j = self.slab_of(slot)
        return self.slabs[s].readback_replica(j, replica)

    def readback_chip(self, slot: int) -> np.ndarray:
        s, j = self.slab_of(slot)
        return self.slabs[s].readback_chip(j)


def slabs_of(x) -> List[Tuple[object, int]]:
    """[(slab, its first chip)] of a stack or a fused frontend: the one
    whole slab ``(x, 0)`` unless ``x`` is split (``SlabStack``,
    ``kernels.frontend.SlabFrontend``)."""
    first = getattr(x, "first_chips", None)
    return [(x, 0)] if first is None else list(zip(x.slabs, first))


def overlap(have: Sequence[Tuple[object, int]], c0: int,
            n: int) -> List[Tuple[object, int, int]]:
    """(slab, first row, end row) of every slab of ``have`` ([(slab, its
    first chip)]) that holds chips of [c0, c0 + n), rows local to it."""
    out = []
    for part, a in have:
        lo, hi = max(c0, a), min(c0 + n, a + part.n_chips)
        if lo < hi:
            out.append((part, lo - a, hi - a))
    return out


def _rows(stack: PackedFabricStack, lo: int, hi: int) -> PackedFabricStack:
    """Chips [lo, hi) of a stack as views of its tensors (the stack
    itself when that is all of it)."""
    if (lo, hi) == (0, stack.n_chips):
        return stack
    R = stack.n_replicas
    return dataclasses.replace(
        stack, n_inputs_each=stack.n_inputs_each[lo:hi],
        n_outputs_each=stack.n_outputs_each[lo:hi],
        **{k: None if getattr(stack, k) is None
           else getattr(stack, k)[lo * R : hi * R] for k in _CHIP_ROWS})


def _stack_on(stack: PackedFabricStack, dev) -> PackedFabricStack:
    """The stack on ``dev``: itself when it is there, else every tensor
    moved (``.to``: a peer copy between cards)."""
    if stack.device == dev:
        return stack
    return dataclasses.replace(stack, **{
        k: None if getattr(stack, k) is None else getattr(stack, k).to(dev)
        for k in _CHIP_ROWS + _COMMON})


def _join(parts: Sequence[PackedFabricStack]) -> PackedFabricStack:
    """Stacks of one geometry on one device, their chips in order."""
    if len(parts) == 1:
        return parts[0]
    return dataclasses.replace(
        parts[0],
        n_inputs_each=sum((p.n_inputs_each for p in parts), ()),
        n_outputs_each=sum((p.n_outputs_each for p in parts), ()),
        **{k: None if getattr(parts[0], k) is None
           else torch.cat([getattr(p, k) for p in parts]) for k in _CHIP_ROWS})


def place_stack(stack, slabs: Sequence[Tuple[torch.device, int, int]]):
    """A stack (split or not) laid out as ``slabs``, the (device, first
    chip, chips) of a plan (launch.mesh.ReadoutMesh.slabs): one
    ``PackedFabricStack`` for one slab, else a ``SlabStack``. A slab that
    already holds its chips on its device is kept as it is, so an equal
    plan copies nothing; a slab whose chips sit in one slab of ``stack``
    is a view of those rows, moved only if its device changed; one whose
    chips sit in several is joined on its device."""
    if sum(n for _, _, n in slabs) != stack.n_chips:
        raise ValueError(f"the slabs hold {sum(n for _, _, n in slabs)} "
                         f"chips, the stack {stack.n_chips}")
    have = slabs_of(stack)
    out = [_join([_stack_on(_rows(p, lo, hi), dev)
                  for p, lo, hi in overlap(have, c0, n)])
           for dev, c0, n in slabs]
    if len(out) == 1:
        return out[0]
    return SlabStack(tuple(out), tuple(c0 for _, c0, _ in slabs))


def _win_base(L: int, band_k: int, m_pad: int, in_seg: int) -> np.ndarray:
    """Per-level window read offsets: level l sees levels [max(0,l-K), l)."""
    return (
        in_seg + np.maximum(np.arange(L, dtype=np.int64) - band_k, 0) * m_pad
    ).astype(np.int32)


def _net_layout(
    c: FabricConfig, m_pad: int, in_seg: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel-order net ids -> the dense padded segmented layout
    ([const0 | const1 | inputs | level slots]).

    Returns (remap (n_nets,), lut_level (n_luts,), pos (n_luts,))."""
    level_sizes = np.asarray(c.level_sizes, np.int64)
    n_luts = c.n_luts
    base_comb = 2 + c.n_inputs  # no FFs
    remap = np.zeros(c.n_nets, np.int64)
    remap[1] = 1
    remap[2:base_comb] = np.arange(2, base_comb)
    if n_luts:
        lut_level = np.repeat(np.arange(len(level_sizes)), level_sizes)
        level_start = np.concatenate([[0], np.cumsum(level_sizes)])
        pos = np.arange(n_luts) - level_start[lut_level]
        remap[base_comb : base_comb + n_luts] = in_seg + lut_level * m_pad + pos
    else:
        lut_level = np.zeros(0, np.int64)
        pos = np.zeros(0, np.int64)
    return remap, lut_level, pos


def _pack_arrays(
    c: FabricConfig,
    L: int,
    m_pad: int,
    in_seg: int,
    n_out_pad: int,
    band_k: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack one config into the matmul (L, m_pad, in_seg) geometry.

    band_k=None packs the dense layout: sel rows are the full padded net
    space. With band_k=K, sel rows are [input segment | K-level window]
    and every level source row is shifted by its consumer level's window
    start max(0, l-K)*m_pad.

    Returns (sel (L, n_rows, 4*M) f32 0/1, tables (L, M, 16) f32 — the
    scrub-loop image —, output_nets (n_out_pad,) int32, const0-padded).
    """
    _check_no_ffs(c)
    assert len(c.level_sizes) <= L
    assert max(c.level_sizes, default=1) <= m_pad
    assert 2 + c.n_inputs <= in_seg
    K = L if band_k is None else min(band_k, L)
    n_rows = in_seg + K * m_pad
    remap, lut_level, pos = _net_layout(c, m_pad, in_seg)
    sel = np.zeros((L, n_rows, 4 * m_pad), np.float32)
    tables = packed_table_image(c, L, m_pad).astype(np.float32)
    if c.n_luts:
        src = remap[c.lut_inputs]                  # (n_luts, 4) dense rows
        shift = np.maximum(lut_level - K, 0) * m_pad
        rows = np.where(src >= in_seg, src - shift[:, None], src)
        if band_k is not None:
            bad = (src >= in_seg) & ((rows < in_seg) | (rows >= n_rows))
            if bad.any():
                raise ValueError(
                    f"fan-in reach exceeds band: K={K} but a LUT reads "
                    f"{int(bad.sum())} net(s) from outside its window"
                )
        cols = np.arange(4)[None, :] * m_pad + pos[:, None]
        sel[lut_level[:, None], rows, cols] = 1.0
    out_nets = np.zeros(n_out_pad, np.int64)  # pad with net 0 == const0
    out_nets[: len(c.output_nets)] = remap[c.output_nets]
    return sel, tables, out_nets.astype(np.int32)


def _pack_arrays_bitsliced(
    c: FabricConfig,
    L: int,
    m_pad: int,
    in_seg: int,
    n_out_pad: int,
    band_k: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack one config into the bit-sliced (L, m_pad) geometry.

    Returns (src (L, m_pad, 4) int32 gather indices into the padded net
    layout — padded slots read net 0 with an all-zero table —, tables
    (L, M, 16) f32 — the scrub-loop image —, output_nets (n_out_pad,)
    int32). ``band_k=K`` enforces the fan-in-reach envelope: a LUT at
    level l may only read nets from levels [l-K, l).
    """
    _check_no_ffs(c)
    assert len(c.level_sizes) <= L
    assert max(c.level_sizes, default=1) <= m_pad
    assert 2 + c.n_inputs <= in_seg
    remap, lut_level, pos = _net_layout(c, m_pad, in_seg)
    tables = packed_table_image(c, L, m_pad).astype(np.float32)
    src = np.zeros((L, m_pad, 4), np.int64)
    if c.n_luts:
        rows = remap[c.lut_inputs]                 # (n_luts, 4) dense rows
        if band_k is not None:
            K = min(band_k, L)
            src_level = (rows - in_seg) // m_pad
            bad = (rows >= in_seg) & (lut_level[:, None] - src_level > K)
            if bad.any():
                raise ValueError(
                    f"fan-in reach exceeds band: K={K} but a LUT reads "
                    f"{int(bad.sum())} net(s) from outside its window"
                )
        src[lut_level, pos] = rows
    out_nets = np.zeros(n_out_pad, np.int64)  # pad with net 0 == const0
    out_nets[: len(c.output_nets)] = remap[c.output_nets]
    return src.astype(np.int32), tables, out_nets.astype(np.int32)


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(
            f"unknown layout {layout!r} (expected 'matmul' or 'bitsliced')")


def _band_choice(reach: int, L: int, band: bool | None) -> int:
    """Resolve the band width: auto-band iff strictly narrower than the
    depth. Returns band_k in [1, L]; band_k == L is the dense envelope."""
    K = min(max(reach, 1), L)
    if band is None:
        band = K < L
    return K if (band and K < L) else L


def pack_fabric(
    config: FabricConfig,
    band: bool | None = None,
    layout: str = "matmul",
    *,
    device=None,
) -> PackedFabric:
    """Pack one decoded bitstream on ``device`` (default: CUDA). band=None
    bands the selection tensor when the config's fan-in reach is narrower
    than its depth; band=False forces the dense layout. For
    layout="bitsliced" the band is a pure reach budget."""
    _check_layout(layout)
    _check_no_ffs(config)
    dev = resolve_device(device)
    c = config
    L = max(len(c.level_sizes), 1)
    m_pad = _round_up(max(c.level_sizes, default=1), 128)
    in_seg = _round_up(2 + c.n_inputs, 128)
    band_k = _band_choice(c.fanin_reach(), L, band)
    bitsliced = layout == "bitsliced"
    pack_one = _pack_arrays_bitsliced if bitsliced else _pack_arrays
    routing, tables, out_nets = pack_one(
        c, L, m_pad, in_seg, len(c.output_nets),
        band_k=band_k if band_k < L else None)
    return PackedFabric(
        sel=None if bitsliced else _sel_tensor(routing, dev),
        src=torch.as_tensor(routing, device=dev) if bitsliced else None,
        tables=torch.as_tensor(tables, device=dev),
        level_base=torch.as_tensor(
            [in_seg + l * m_pad for l in range(L)], dtype=torch.int32,
            device=dev),
        output_nets=torch.as_tensor(out_nets, device=dev),
        win_base=torch.as_tensor(_win_base(L, band_k, m_pad, in_seg),
                                 device=dev),
        n_inputs=c.n_inputs,
        n_nets_pad=in_seg + L * m_pad,
        m_pad=m_pad,
        n_levels=L,
        in_seg=in_seg,
        band_k=band_k,
    )


def pack_fabrics(
    configs: Sequence[FabricConfig],
    band: bool | None = None,
    redundancy: str = "none",
    layout: str = "matmul",
    geometry: StackGeometry | None = None,
    *,
    device=None,
) -> PackedFabricStack:
    """Stack N decoded bitstreams into one chip-batched structure on
    ``device`` (default: CUDA).

    The shared geometry is the union envelope over all configs, and the
    band is shared too: K = the widest fan-in reach of the stack (dense
    when the window would span every level). ``redundancy="tmr"`` packs
    three replica encodings of every chip as contiguous rows.
    ``layout="bitsliced"`` packs the word layout's gather indices instead
    of the selection tensor.

    ``geometry`` replaces the union envelope: every config must fit it
    (``StackGeometry.admits``, its fan-in-reach budget included), the
    stack pads to it, and its ``fanin_reach`` IS the band (dense when
    None; ``band`` is then not consulted). Stacks packed against one
    envelope (``bucket_envelope``) share every shape their kernels are
    launched with, so a config never seen before swaps into a warm stack
    (``swap_chip``) without a new launch signature.
    """
    if redundancy not in ("none", "tmr"):
        raise ValueError(
            f"unknown redundancy {redundancy!r} (expected 'none' or 'tmr')")
    _check_layout(layout)
    dev = resolve_device(device)
    n_replicas = N_REPLICAS if redundancy == "tmr" else 1
    geo = check_stackable(configs)
    if geometry is not None:
        for i, c in enumerate(configs):
            if not geometry.admits(c):
                raise ValueError(
                    f"config {i} does not fit the requested envelope "
                    f"{geometry} (levels={len(c.level_sizes)}, "
                    f"widest={max(c.level_sizes, default=1)}, "
                    f"inputs={c.n_inputs}, outputs={len(c.output_nets)}, "
                    f"fanin_reach={c.fanin_reach()})")
        geo = geometry
    L = geo.n_levels
    m_pad = _round_up(geo.max_level_size, 128)
    in_seg = _round_up(2 + geo.n_inputs, 128)
    if geometry is not None:
        band_k = (min(geometry.fanin_reach, L)
                  if geometry.fanin_reach is not None else L)
    else:
        band_k = _band_choice(geo.fanin_reach or L, L, band)
    bitsliced = layout == "bitsliced"
    pack_one = _pack_arrays_bitsliced if bitsliced else _pack_arrays

    slot_configs = [
        replicate_config(c, r) for c in configs for r in range(n_replicas)
    ] if n_replicas > 1 else list(configs)
    packed = [
        pack_one(c, L, m_pad, in_seg, geo.n_outputs,
                 band_k=band_k if band_k < L else None)
        for c in slot_configs
    ]

    def stack(k: int) -> torch.Tensor:
        return torch.as_tensor(np.stack([p[k] for p in packed]), device=dev)

    if bitsliced:
        routing = dict(src=stack(0))
    else:   # one slot at a time to bf16: no float32 copy of the whole stack
        routing = dict(sel=torch.stack([_sel_tensor(p[0], dev)
                                        for p in packed]))
    return PackedFabricStack(
        tables=stack(1),
        level_base=torch.as_tensor(
            [in_seg + l * m_pad for l in range(L)], dtype=torch.int32,
            device=dev),
        output_nets=stack(2),
        win_base=torch.as_tensor(_win_base(L, band_k, m_pad, in_seg),
                                 device=dev),
        n_inputs=geo.n_inputs,
        n_outputs=geo.n_outputs,
        n_inputs_each=tuple(c.n_inputs for c in configs),
        n_outputs_each=tuple(len(c.output_nets) for c in configs),
        n_nets_pad=in_seg + L * m_pad,
        m_pad=m_pad,
        n_levels=L,
        in_seg=in_seg,
        band_k=band_k,
        n_replicas=n_replicas,
        **routing,
    )


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def bucket_envelope(
    config: FabricConfig,
    band: bool | None = None,
    width_quant: int = 128,
) -> StackGeometry:
    """Snap one config's shape onto a coarse grid: the bucket key of the
    geometry pool (``pack_fabric_pool``, launch/fleet.py). Every axis is
    a ceiling, so the envelope always ``admits`` its config:

    * ``n_levels``       -> the next power of two;
    * ``max_level_size`` -> the next multiple of ``width_quant``;
    * ``n_inputs``       -> the whole 128-aligned input segment
      (``in_seg - 2``);
    * ``n_outputs``      -> the next power of two, at most 31 (the int32
      score decode of ``decode_plan``);
    * ``fanin_reach``    -> the next power of two, at most the snapped
      depth; None (dense) when it reaches every level or ``band=False``
      (``band=True`` keeps a reach equal to the depth).

    The returned ``StackGeometry`` is hashable: the bucket key itself."""
    c = config
    L = _next_pow2(max(len(c.level_sizes), 1))
    width = _round_up(max(c.level_sizes, default=1), width_quant)
    n_inputs = _round_up(2 + c.n_inputs, 128) - 2
    n_outputs = min(_next_pow2(max(len(c.output_nets), 1)), 31)
    reach: int | None = min(_next_pow2(max(c.fanin_reach(), 1)), L)
    if band is False or (band is None and reach >= L):
        reach = None
    return StackGeometry(
        n_levels=L,
        max_level_size=width,
        n_inputs=n_inputs,
        n_outputs=n_outputs,
        fanin_reach=reach,
    )


@dataclasses.dataclass(frozen=True)
class FabricBucket:
    """One geometry bucket of a fabric pool: ``stack`` is packed against
    ``envelope`` (not the union of its members), and ``members[j]`` is
    the index, into the configs given to ``pack_fabric_pool``, of the
    config in stack slot ``j``."""

    envelope: StackGeometry
    stack: PackedFabricStack
    members: Tuple[int, ...]


def pack_fabric_pool(
    configs: Sequence[FabricConfig],
    band: bool | None = None,
    redundancy: str = "none",
    layout: str = "matmul",
    width_quant: int = 128,
    *,
    device=None,
) -> List[FabricBucket]:
    """Bin configs by ``bucket_envelope`` and pack each bin against its
    envelope on ``device`` (default: CUDA): one stack, and one set of
    launch signatures, a bucket. Buckets come in the first-seen order of
    their envelopes; ``redundancy`` and ``layout`` apply to all."""
    bins: dict = {}
    for i, c in enumerate(configs):
        bins.setdefault(bucket_envelope(c, band, width_quant), []).append(i)
    return [
        FabricBucket(
            envelope=env,
            stack=pack_fabrics(
                [configs[i] for i in idxs], band=band,
                redundancy=redundancy, layout=layout, geometry=env,
                device=device),
            members=tuple(idxs),
        )
        for env, idxs in bins.items()
    ]


def _bits_ext(bits: torch.Tensor, n_inputs: int, in_seg: int) -> torch.Tensor:
    """(..., B, n_inputs) 0/1 -> (..., B, in_seg) f32 input segment
    [const0, const1, inputs, 0-pad]."""
    ext = torch.zeros(bits.shape[:-1] + (in_seg,), dtype=torch.float32,
                      device=bits.device)
    ext[..., 1] = 1.0
    ext[..., 2 : 2 + n_inputs] = bits[..., :n_inputs].to(torch.float32)
    return ext


def _eval_packed(packed: PackedFabric, bits: torch.Tensor) -> torch.Tensor:
    """(B, n_inputs) device bits -> (B, n_outputs) uint8 on one fabric:
    the chip-batched ``fabric_eval_bits`` at C=1."""
    def one(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t[None]

    return fabric_eval_bits(
        one(packed.sel), packed.tables[None], packed.level_base,
        packed.win_base, packed.output_nets[None], bits[None],
        n_inputs=packed.n_inputs, n_nets_pad=packed.n_nets_pad,
        in_seg=packed.in_seg, src=one(packed.src))[0]


def fabric_eval(
    config_or_packed,
    bits,
    batch_tile: int = 128,
    band: bool | None = None,
    layout: str = "matmul",
    *,
    device=None,
) -> torch.Tensor:
    """Evaluate a batch of events on one configured fabric.

    bits: (B, n_inputs) 0/1, a host array or a tensor -> (B, n_outputs)
    uint8 on the packed fabric's device. B is padded up to a
    ``batch_tile`` multiple, as the reference pads it.
    ``band``/``layout``/``device`` apply when packing a raw config
    (ignored for an already-packed fabric). While a profiler records, the
    evaluation is the span ``readout.check.eval``, and the copy of host
    bits ``readout.check.h2d``."""
    packed = (
        config_or_packed
        if isinstance(config_or_packed, PackedFabric)
        else pack_fabric(config_or_packed, band=band, layout=layout,
                         device=device)
    )
    if isinstance(bits, torch.Tensor):
        b = bits.to(device=packed.device, dtype=torch.int32)
    else:
        with SPANS.time("check.h2d"):
            b = torch.as_tensor(np.asarray(bits), dtype=torch.int32,
                                device=packed.device)
    B = b.shape[0]
    Bp = _round_up(max(B, 1), batch_tile)
    if Bp != B:
        b = torch.nn.functional.pad(b, (0, 0, 0, Bp - B))
    with SPANS.time("check.eval"):
        return _eval_packed(packed, b)[:B]


def fabric_eval_bits(
    sel: Optional[torch.Tensor],
    tables: torch.Tensor,
    level_base: torch.Tensor,
    win_base: torch.Tensor,
    output_nets: torch.Tensor,
    bits: torch.Tensor,         # (C, B, n_inputs_max)
    *,
    n_inputs: int,
    n_nets_pad: int,
    in_seg: int,
    src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chip-batched evaluation of device-resident bits: (C, B, O) uint8.

    A non-None ``src`` selects the bit-sliced layout (``sel`` is None
    then). For the matmul layout, fewer ``sel`` rows than the padded net
    space means the banded kernel."""
    if src is not None:
        return _bitsliced.eval_bits(src, tables, output_nets, bits,
                                    n_inputs=n_inputs, in_seg=in_seg)
    ext = _bits_ext(bits, n_inputs, in_seg)
    if sel.shape[2] < n_nets_pad:
        vals = lut_eval_banded_stacked(ext, sel, tables, level_base,
                                       win_base, n_nets_pad=n_nets_pad)
    else:
        vals = lut_eval_stacked(ext, sel, tables, level_base,
                                n_nets_pad=n_nets_pad)        # (C, B, N)
    C, B = bits.shape[0], bits.shape[1]
    idx = output_nets[:, None, :].long().expand(C, B, output_nets.shape[1])
    return torch.gather(vals, 2, idx).to(torch.uint8)


def fabric_eval_bits_voted(
    sel: Optional[torch.Tensor],
    tables: torch.Tensor,
    level_base: torch.Tensor,
    win_base: torch.Tensor,
    output_nets: torch.Tensor,
    bits: torch.Tensor,         # (C, B, n_inputs_max) — per LOGICAL chip
    *,
    n_replicas: int,
    n_inputs: int,
    n_nets_pad: int,
    in_seg: int,
    src: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Redundant evaluation of device-resident bits: (voted output bits
    (C, B, O) uint8, disagree (C, R, B) bool; all False for
    n_replicas == 1).

    The bit-sliced layout (non-None ``src``) votes inside its kernel. The
    matmul layout repeats each chip's events for its R replica rows,
    evaluates all R*C rows in one launch, and then takes the 2-of-3 vote
    and the replica-vs-vote disagreement in torch ops."""
    if src is not None:
        return _bitsliced.eval_bits_voted(
            src, tables, output_nets, bits,
            n_replicas=n_replicas, n_inputs=n_inputs, in_seg=in_seg)
    C, B = bits.shape[0], bits.shape[1]
    rep = (torch.repeat_interleave(bits, n_replicas, dim=0)
           if n_replicas > 1 else bits)
    outs = fabric_eval_bits(
        sel, tables, level_base, win_base, output_nets, rep,
        n_inputs=n_inputs, n_nets_pad=n_nets_pad, in_seg=in_seg)
    if n_replicas == 1:
        return outs, torch.zeros((C, 1, B), dtype=torch.bool,
                                 device=bits.device)
    assert n_replicas == N_REPLICAS, n_replicas
    g = outs.reshape(C, n_replicas, B, outs.shape[-1])
    voted = majority_vote(g[:, 0], g[:, 1], g[:, 2])        # (C, B, O)
    disagree = torch.any(g != voted[:, None], dim=-1)       # (C, R, B)
    return voted, disagree


def decode_scores_device(
    outs: torch.Tensor,          # (C, B, O) voted output bits
    disagree: torch.Tensor,      # (C, R, B) bool replica-vs-vote mismatches
    out_weight: torch.Tensor,    # (C, O) int32 two's-complement weights
    threshold_raw: torch.Tensor, # (C,) int32
    valid: torch.Tensor,         # (C, B) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode two's-complement scores, apply the integer trigger cut
    masked by ``valid``, count valid-row disagreements per replica.
    Returns (score (C, B) int32, keep (C, B) bool, dis (C, R) int32).
    torch sums int32 in int64; the casts back to int32 wrap as the
    reference's int32 sums do."""
    score = torch.sum(outs.to(torch.int32) * out_weight[:, None, :],
                      dim=-1).to(torch.int32)
    keep = (score <= threshold_raw[:, None]) & valid
    dis = torch.sum(disagree & valid[:, None, :], dim=-1).to(torch.int32)
    return score, keep, dis


def decode_plan(
    configs: Sequence[FabricConfig],
    n_outputs: int,
) -> np.ndarray:
    """Per-chip score-decode weights: out_weight (C, n_outputs) int32 —
    two's-complement bit weights, zero on padded lanes (<= 31 bits)."""
    C = len(configs)
    weight = np.zeros((C, n_outputs), np.int64)
    for i, c in enumerate(configs):
        n_out = len(c.output_nets)
        if n_out > 31:
            raise ValueError(
                f"device score decode is int32: chip {i} has {n_out} "
                "output bits > 31"
            )
        weight[i, :n_out] = 1 << np.arange(n_out)
        if n_out:
            weight[i, n_out - 1] = -(1 << (n_out - 1))
    return weight.astype(np.int32)


def decode_keep_words_device(
    voted_w: torch.Tensor,       # (C, W, O) int32 voted output words
    dis_w: torch.Tensor,         # (C, R, W) int32 disagreement words
    out_weight: torch.Tensor,    # (C, O) int32 two's-complement weights
    threshold_raw: torch.Tensor, # (C,) int32
    valid: torch.Tensor,         # (C, B) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode_scores_device`` stopped in the word domain: (keep_w (C, W)
    int32 keep words masked by ``valid``, scores (C, W, 32) int32 lane
    scores — lane ``e`` of word ``w`` is event ``w*32+e`` —, dis (C, R)
    int32 disagree counts). The cut equals ``decode_scores_device``'s bit
    for bit. On the serving paths kernel B6 (kernels/sparse_pack) fuses
    this tail with the compaction of the kept lanes."""
    valid_w = _bitsliced.mask_words(valid)                  # (C, W)
    planes = _bitsliced.sign_extended_planes(voted_w, out_weight)
    keep_w = _bitsliced.keep_words(planes, threshold_raw, valid_w)
    scores = _bitsliced.lane_scores(planes)
    dis = _bitsliced.disagree_counts_words(dis_w, valid_w)
    return keep_w, scores, dis


def stack_input_bits(
    stack: PackedFabricStack, per_chip_bits: Sequence[np.ndarray]
) -> np.ndarray:
    """Zero-pad per-chip (B_i, n_inputs_i) bit arrays into the stacked
    (C, B_max, n_inputs_max) layout the chip-batched evaluators take."""
    if len(per_chip_bits) != stack.n_chips:
        raise ValueError(f"{len(per_chip_bits)} bit arrays for "
                         f"{stack.n_chips} chips")
    for i, b in enumerate(per_chip_bits):
        b = np.asarray(b)
        if b.size and b.shape[1] != stack.n_inputs_each[i]:
            raise ValueError(f"chip {i}: bits {b.shape} but the chip has "
                             f"{stack.n_inputs_each[i]} inputs")
    return stack_event_bits(per_chip_bits, stack.n_inputs)


def _device_bits(stack: PackedFabricStack, bits, batch_tile: int):
    """(C, B, n_inputs) bits as int32 on the stack's device, padded to a
    ``batch_tile`` multiple of events: (bits, B, Bp)."""
    b = torch.as_tensor(np.asarray(bits) if not torch.is_tensor(bits)
                        else bits).to(device=stack.device, dtype=torch.int32)
    C, B = b.shape[0], b.shape[1]
    if C != stack.n_chips:
        raise ValueError(f"bits for {C} chips, stack has {stack.n_chips}")
    Bp = _round_up(max(B, 1), batch_tile)
    if Bp != B:
        b = torch.nn.functional.pad(b, (0, 0, 0, Bp - B))
    return b, B, Bp


def fabric_eval_multi(
    stack_or_configs,
    bits,
    batch_tile: int = 128,
    band: bool | None = None,
    layout: str = "matmul",
    *,
    device=None,
) -> torch.Tensor:
    """Evaluate (chips, events) in one chip-batched call.

    bits: (C, B, n_inputs_max) 0/1 (see ``stack_input_bits``), or a list
    of per-chip (B_i, n_inputs_i) arrays, per LOGICAL chip. Returns
    (C, B, n_outputs_max) uint8, padded lanes 0. On a redundant stack all
    replicas evaluate and the result is the majority vote.
    ``band``/``layout``/``device`` apply when packing raw configs."""
    stack = (
        stack_or_configs
        if isinstance(stack_or_configs, PackedFabricStack)
        else pack_fabrics(list(stack_or_configs), band=band, layout=layout,
                          device=device)
    )
    if isinstance(bits, (list, tuple)):
        bits = stack_input_bits(stack, bits)
    b, B, _ = _device_bits(stack, bits, batch_tile)
    common = dict(n_inputs=stack.n_inputs, n_nets_pad=stack.n_nets_pad,
                  in_seg=stack.in_seg, src=stack.src)
    if stack.n_replicas > 1:
        out, _ = fabric_eval_bits_voted(
            stack.sel, stack.tables, stack.level_base, stack.win_base,
            stack.output_nets, b, n_replicas=stack.n_replicas, **common)
    else:
        out = fabric_eval_bits(
            stack.sel, stack.tables, stack.level_base, stack.win_base,
            stack.output_nets, b, **common)
    return out[:, :B]


def _eval_stack_scored(stack: PackedFabricStack, bits, out_weight,
                       threshold_raw, valid, *, sparse: bool = False):
    """Serving dispatch for padded device bits: evaluate every replica,
    vote, decode scores and apply the integer cut.

    Dense: (score (C, B) int32, keep (C, B) bool masked by ``valid``,
    dis (C, R) int32 voted-against events per replica over valid rows).
    ``sparse=True`` (bit-sliced stacks only) returns (count, idx, vals,
    dis), the ``parallel.compression`` wire format over flat indices
    ``chip*B + event``. A bit-sliced stack stays in the word domain: the
    fabric kernel's voted and disagreement words go straight to kernel B6
    (sparse: cut, count and compact the kept lanes; dense: every event's
    score and cut in event order), launched as the walk's programmatic
    dependent. The matmul layout votes and decodes in torch ops."""
    if stack.src is not None:
        voted_w, dis_w = _bitsliced.eval_words_voted(
            stack.src, stack.tables, stack.output_nets, bits,
            n_replicas=stack.n_replicas, n_inputs=stack.n_inputs,
            in_seg=stack.in_seg)
        tail = (_sparse_pack.decode_pack if sparse
                else _sparse_pack.decode_dense)
        return tail(voted_w, dis_w, out_weight, threshold_raw, valid)
    if sparse:
        raise ValueError(
            "sparse=True needs the word domain: pack the stack with "
            "layout='bitsliced' (matmul stacks have no word form)")
    outs, disagree = fabric_eval_bits_voted(
        stack.sel, stack.tables, stack.level_base, stack.win_base,
        stack.output_nets, bits, n_replicas=stack.n_replicas,
        n_inputs=stack.n_inputs, n_nets_pad=stack.n_nets_pad,
        in_seg=stack.in_seg)
    return decode_scores_device(outs, disagree, out_weight, threshold_raw,
                                valid)


def _scored_args(stack, bits, out_weight, threshold_raw, valid,
                 batch_tile):
    """Device tensors of one scored dispatch, the batch padded to a
    ``batch_tile`` multiple (padded rows invalid): (bits, weight, cut,
    valid, B, Bp)."""
    b, B, Bp = _device_bits(stack, bits, batch_tile)
    dev, C = stack.device, b.shape[0]
    if valid is None:
        v = torch.ones((C, B), dtype=torch.bool, device=dev)
    else:
        v = torch.as_tensor(np.asarray(valid) if not torch.is_tensor(valid)
                            else valid).to(device=dev, dtype=torch.bool)
    if Bp != B:
        v = torch.nn.functional.pad(v, (0, Bp - B))
    w = torch.as_tensor(np.asarray(out_weight, np.int32), device=dev)
    t = torch.as_tensor(np.asarray(threshold_raw, np.int32), device=dev)
    return b, w, t, v, B, Bp


def fabric_eval_multi_scored(
    stack: PackedFabricStack,
    bits,
    out_weight,
    threshold_raw,
    valid=None,
    *,
    batch_tile: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score (chips, events) input bits in one voted dispatch: (score
    (C, B) int32, keep (C, B) bool, dis (C, R) int32), with the decode
    weights of ``decode_plan`` and the integer cuts applied on the
    device. Nothing synchronises with the host. A ``SlabStack`` runs one
    dispatch a slab on the slab's device and merges them on the host
    (``merge_scored``)."""
    if isinstance(stack, SlabStack):
        return merge_scored(scored_slabs(stack, bits, out_weight,
                                         threshold_raw, valid,
                                         batch_tile=batch_tile))
    b, w, t, v, B, _ = _scored_args(stack, bits, out_weight, threshold_raw,
                                    valid, batch_tile)
    score, keep, dis = _eval_stack_scored(stack, b, w, t, v)
    return score[:, :B], keep[:, :B], dis


def fabric_eval_multi_scored_sparse(
    stack: PackedFabricStack,
    bits,
    out_weight,
    threshold_raw,
    valid=None,
    *,
    batch_tile: int = 128,
) -> Tuple[torch.Tensor, ...]:
    """Word-domain sparse twin of ``fabric_eval_multi_scored``: (count ()
    int32, idx (C*B,) int32 ascending flat indices ``chip*B + event`` -1
    padded, vals (C*B,) int32 kept scores 0 padded, dis (C, R) int32).
    The keep cut, SEU counters and compaction run in kernel B6 on the
    fabric kernel's words; dropped events never leave the word domain.
    Bit-sliced stacks only. A ``SlabStack`` runs one dispatch a slab on
    the slab's device and merges them on the host (``merge_sparse``)."""
    if isinstance(stack, SlabStack):
        return merge_sparse(scored_slabs(stack, bits, out_weight,
                                         threshold_raw, valid,
                                         batch_tile=batch_tile, sparse=True),
                            bits.shape[1])
    if stack.src is None:
        raise ValueError(
            "fabric_eval_multi_scored_sparse needs layout='bitsliced' "
            "(word-domain egress has no matmul form)")
    b, w, t, v, B, Bp = _scored_args(stack, bits, out_weight, threshold_raw,
                                     valid, batch_tile)
    count, idx, vals, dis = _eval_stack_scored(stack, b, w, t, v,
                                               sparse=True)
    if Bp != B:
        idx, vals = restride(idx, vals, stack.n_chips, B, Bp)
    return count, idx, vals, dis


def restride(idx: torch.Tensor, vals: torch.Tensor, C: int, B: int,
             Bp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat indices over a tile-padded batch Bp -> over the caller's B.
    Kept lanes sit below B (``valid`` kills the pad tail), so the map
    keeps ascending order and fits the packed vectors in C*B slots."""
    idx = torch.where(idx >= 0, (idx // Bp) * B + idx % Bp, -1)
    return idx[: C * B].to(torch.int32), vals[: C * B]


def _cut(x, c0: int, n: int):
    """Chips [c0, c0 + n) of a per-chip array (None stays None)."""
    if x is None:
        return None
    return (x if torch.is_tensor(x) else np.asarray(x))[c0 : c0 + n]


def scored_slabs(stack, bits, out_weight, threshold_raw, valid=None, *,
                 batch_tile: int = 128, sparse: bool = False) -> List:
    """One scored dispatch a slab of ``stack`` (split or not), each
    launched on its slab's device and left there, unmerged: [(first
    chip, result)], a result as ``fabric_eval_multi_scored`` (or, with
    ``sparse``, ``fabric_eval_multi_scored_sparse``: flat indices over
    the slab's own (chips, B)) returns it for the slab's chips. The
    slabs share nothing."""
    fn = (fabric_eval_multi_scored_sparse if sparse
          else fabric_eval_multi_scored)
    return [(c0, fn(slab, _cut(bits, c0, slab.n_chips),
                    _cut(out_weight, c0, slab.n_chips),
                    _cut(threshold_raw, c0, slab.n_chips),
                    _cut(valid, c0, slab.n_chips), batch_tile=batch_tile))
            for slab, c0 in slabs_of(stack)]


def merge_scored(parts) -> Tuple[torch.Tensor, ...]:
    """Dense results of the slabs ([(first chip, (score, keep, dis))], in
    slab order) joined on the host along the chip axis."""
    return tuple(torch.cat([r[k].cpu() for _, r in parts])
                 for k in range(3))


def merge_kept(kept, B: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kept prefixes of a dispatch's slabs ([(first chip, idx, vals)]
    in slab order, each slab's flat indices over its own (chips, B)) as
    one (idx, vals) pair over the whole (C, B), int64: every index
    offset by its slab's first chip x B, the slabs concatenated. Each
    prefix ascends and the slabs' index ranges follow one another, so
    the result ascends, as the one-slab compaction's does."""
    if not kept:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (np.concatenate([np.asarray(i, np.int64) + c0 * B
                            for c0, i, _ in kept]),
            np.concatenate([np.asarray(v, np.int64) for _, _, v in kept]))


def merge_sparse(parts, B: int) -> Tuple[torch.Tensor, ...]:
    """Sparse results of the slabs ([(first chip, (count, idx, vals,
    dis))] in slab order, as ``scored_slabs(..., sparse=True)`` gives
    them for a batch of ``B`` events a chip) merged on the host into the
    one-slab wire format: (count (), idx (C*B,) ascending flat indices -1
    padded, vals (C*B,) 0 padded, dis (C, R)), all int32. The count is
    the slabs' sum."""
    dis = torch.cat([r[3].cpu() for _, r in parts])
    C = dis.shape[0]
    kept = []
    for c0, (count, idx, vals, _) in parts:
        n = int(count)
        kept.append((c0, idx[:n].cpu(), vals[:n].cpu()))
    k_idx, k_vals = merge_kept(kept, B)
    n = len(k_idx)
    idx = torch.full((C * B,), -1, dtype=torch.int32)
    vals = torch.zeros((C * B,), dtype=torch.int32)
    idx[:n] = torch.from_numpy(k_idx)
    vals[:n] = torch.from_numpy(k_vals)
    return torch.tensor(n, dtype=torch.int32), idx, vals, dis
