"""Packing + serving entry points of the bit-sliced fabric evaluator.

The bit-sliced half of the JAX package's kernels/lut_eval/ops.py:
``pack_fabrics`` stacks N decoded bitstreams into one ``PackedFabricStack``
sharing a padded geometry (the chip axis is the leading tensor dimension
on one device), ``swap_chip`` hot-swaps one chip's rows, and
``fabric_eval_bits_voted`` + ``decode_scores_device`` are the fabric and
decode stages of the fused frontend.

The matmul layout (the Pallas selection-matmul kernels, dense and banded)
is not ported yet: ``layout="matmul"`` raises ``NotPortedError``.

Redundancy: ``pack_fabrics(..., redundancy="tmr")`` packs three
placement-distinct replica encodings of every chip (core.tmr.
replicate_config) as contiguous rows ``slot*3 .. slot*3+2``; the vote runs
inside the bit-sliced kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fabric import (
    FabricConfig,
    StackGeometry,
    check_stackable,
    packed_table_image,
)
from repro_torch.core.tmr import N_REPLICAS, replicate_config
from repro_torch.device import NotPortedError, resolve_device
from repro_torch.kernels.lut_eval import bitsliced as _bitsliced

MATMUL_NOT_PORTED = (
    "layout='matmul' (the Pallas selection-matmul lut_eval kernels) is not "
    "ported yet: ROADMAP queue B, items B2/B3")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class PackedFabricStack:
    """N decoded bitstreams stacked into chip-batched device tensors.

    All chips share the padded geometry (L, M, in_seg); narrower chips are
    zero-padded and ``output_nets`` is padded with net 0 (const0). With
    ``n_replicas`` > 1 the leading axis holds the replica rows of each
    logical chip contiguously (chip ``c`` -> rows ``c*R .. c*R+R-1``); the
    width tuples stay per logical chip.
    """

    src: torch.Tensor          # (R*C, L, M, 4) int32
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

    def swap_chip(self, slot: int, config: FabricConfig) -> "PackedFabricStack":
        """Hot-swap one chip's bitstream: a row update of fresh tensors
        (the old stack stays valid for batches already in flight). On a
        redundant stack all replica rows are re-encoded."""
        self._check_admits(config)
        R = self.n_replicas
        packed = [
            _pack_arrays_bitsliced(
                replicate_config(config, r) if R > 1 else config,
                self.n_levels, self.m_pad, self.in_seg, self.n_outputs,
                band_k=self.band_k if self.banded else None)
            for r in range(R)
        ]
        lo = slot * R

        def rows(old: torch.Tensor, k: int, dtype) -> torch.Tensor:
            new = old.clone()
            new[lo : lo + R] = torch.as_tensor(
                np.stack([p[k] for p in packed]), dtype=dtype,
                device=old.device)
            return new

        each_in = list(self.n_inputs_each)
        each_out = list(self.n_outputs_each)
        each_in[slot] = config.n_inputs
        each_out[slot] = len(config.output_nets)
        return dataclasses.replace(
            self,
            src=rows(self.src, 0, torch.int32),
            tables=rows(self.tables, 1, torch.float32),
            output_nets=rows(self.output_nets, 2, torch.int32),
            n_inputs_each=tuple(each_in),
            n_outputs_each=tuple(each_out),
        )


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
    if c.n_ffs:
        raise ValueError(
            "lut_eval kernel handles combinational modules (the readout "
            "classifier); sequential firmware uses core.fabric.FabricSim"
        )
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
    if layout == "matmul":
        raise NotPortedError(MATMUL_NOT_PORTED)
    if layout != "bitsliced":
        raise ValueError(
            f"unknown layout {layout!r} (expected 'matmul' or 'bitsliced')")


def _band_choice(reach: int, L: int, band: bool | None) -> int:
    """Resolve the band width: auto-band iff strictly narrower than the
    depth. Returns band_k in [1, L]; band_k == L is the dense envelope."""
    K = min(max(reach, 1), L)
    if band is None:
        band = K < L
    return K if (band and K < L) else L


def pack_fabrics(
    configs: Sequence[FabricConfig],
    band: bool | None = None,
    redundancy: str = "none",
    layout: str = "bitsliced",
    *,
    device=None,
) -> PackedFabricStack:
    """Stack N decoded bitstreams into one chip-batched structure on
    ``device`` (default: CUDA).

    The shared geometry is the union envelope over all configs. The band
    is a fan-in-reach envelope validated at pack and swap time; the word
    evaluator itself has no routing window. ``redundancy="tmr"`` packs
    three replica encodings of every chip as contiguous rows.
    """
    if redundancy not in ("none", "tmr"):
        raise ValueError(
            f"unknown redundancy {redundancy!r} (expected 'none' or 'tmr')")
    _check_layout(layout)
    dev = resolve_device(device)
    n_replicas = N_REPLICAS if redundancy == "tmr" else 1
    geo = check_stackable(configs)
    L = geo.n_levels
    m_pad = _round_up(geo.max_level_size, 128)
    in_seg = _round_up(2 + geo.n_inputs, 128)
    n_pad = in_seg + L * m_pad
    band_k = _band_choice(geo.fanin_reach or L, L, band)

    slot_configs = [
        replicate_config(c, r) for c in configs for r in range(n_replicas)
    ] if n_replicas > 1 else list(configs)
    packed = [
        _pack_arrays_bitsliced(c, L, m_pad, in_seg, geo.n_outputs,
                               band_k=band_k if band_k < L else None)
        for c in slot_configs
    ]

    def stack(k: int, dtype) -> torch.Tensor:
        return torch.as_tensor(np.stack([p[k] for p in packed]), dtype=dtype,
                               device=dev)

    return PackedFabricStack(
        src=stack(0, torch.int32),
        tables=stack(1, torch.float32),
        level_base=torch.as_tensor(
            [in_seg + l * m_pad for l in range(L)], dtype=torch.int32,
            device=dev),
        output_nets=stack(2, torch.int32),
        win_base=torch.as_tensor(_win_base(L, band_k, m_pad, in_seg),
                                 device=dev),
        n_inputs=geo.n_inputs,
        n_outputs=geo.n_outputs,
        n_inputs_each=tuple(c.n_inputs for c in configs),
        n_outputs_each=tuple(len(c.output_nets) for c in configs),
        n_nets_pad=n_pad,
        m_pad=m_pad,
        n_levels=L,
        in_seg=in_seg,
        band_k=band_k,
        n_replicas=n_replicas,
    )


def fabric_eval_bits_voted(
    src: torch.Tensor,
    tables: torch.Tensor,
    output_nets: torch.Tensor,
    bits: torch.Tensor,         # (C, B, n_inputs_max) — per LOGICAL chip
    *,
    n_replicas: int,
    n_inputs: int,
    in_seg: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Redundant evaluation of device-resident bits through the word
    evaluator (vote folded into the kernel): (voted output bits (C, B, O)
    uint8, disagree (C, R, B) bool; all False for n_replicas == 1)."""
    return _bitsliced.eval_bits_voted(
        src, tables, output_nets, bits,
        n_replicas=n_replicas, n_inputs=n_inputs, in_seg=in_seg)


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
