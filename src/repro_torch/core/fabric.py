# Copy of repro/core/fabric.py with imports rewritten: the PyTorch port keeps its own
# numpy modules and imports nothing of the JAX package.
"""FABulous-style eFPGA fabric model: tile grids, capacity, place, configure.

Reproduces the two fabricated fabrics of the paper:

  * 130nm (§2): 384 logic cells (48 LUT4AB tiles x 8 cells), 128 LUTRAM
    registers (4 RegFile tiles x 32x4b), 4 DSP slices (DSP_top/DSP_bot
    pairs), W_IO GPIO column (2b/tile), CPU_IO column (8b in / 12b out per
    tile), N/S termination tiles.
  * 28nm (§4): 448 logic cells (56 LUT4AB tiles), 4 DSP slices, RegFile
    removed (replaced by LUT4AB), WEST_IO / EAST_IO user tiles that expose
    the 32-bit bus + AXI-Stream data plane of the ASIC.

What we model bit-exactly: LUT truth tables, FF state, the levelized
evaluation a configured fabric performs, resource capacities, and the
bitstream contents (core/bitstream.py). What we abstract: the switch-matrix
routing graph — routing is modeled as a full crossbar (any cell input can
see any net) with *capacity* checks on cells and IO. This preserves
functional and resource fidelity; routability of the physical fabric was
proven by the paper's own tapeouts.

A configured fabric (``FabricConfig``) is exactly the levelized-array form
the Pallas kernel consumes — "loading a bitstream" on TPU is swapping these
arrays, with no recompilation (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.netlist import LevelizedNetlist, Netlist
from repro_torch.core.netlist import fanin_reach as _fanin_reach


# --------------------------------------------------------------------------
# Tile library (paper §2.1 / §4.1)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TileType:
    name: str
    logic_cells: int = 0      # LUT4+FF pairs
    lutram_bits: int = 0      # RegFile storage
    dsp_half: int = 0         # DSP_top+DSP_bot pair = one 8x8 MAC slice
    gpio_bits: int = 0        # W_IO-style general IO
    bus_in_bits: int = 0      # CPU_IO / EAST_IO style in
    bus_out_bits: int = 0


TILE_LIBRARY: Dict[str, TileType] = {
    "NULL": TileType("NULL"),
    "N_term_single2": TileType("N_term_single2"),
    "S_term_single2": TileType("S_term_single2"),
    "W_IO": TileType("W_IO", gpio_bits=2),
    "RegFile": TileType("RegFile", lutram_bits=32 * 4),
    "DSP_top": TileType("DSP_top", dsp_half=1),
    "DSP_bot": TileType("DSP_bot", dsp_half=1),
    "LUT4AB": TileType("LUT4AB", logic_cells=8),
    "CPU_IO": TileType("CPU_IO", bus_in_bits=8, bus_out_bits=12),
    "WEST_IO": TileType("WEST_IO", gpio_bits=2, bus_in_bits=16, bus_out_bits=16),
    "EAST_IO": TileType("EAST_IO", bus_in_bits=16, bus_out_bits=16),
}


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    name: str
    node: str                     # "130nm" | "28nm"
    grid: Tuple[Tuple[str, ...], ...]  # rows of tile names (the .csv of Fig 1/6)
    # The ASIC-side bus interface (32-bit buses into/out of the eFPGA):
    config_bus_in: int = 96       # bits loadable from AXI-Lite regs (3x32 @130nm)
    config_bus_out: int = 96
    stream_bits: int = 0          # AXI-Stream data plane width (28nm only)

    def tile_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for row in self.grid:
            for t in row:
                out[t] = out.get(t, 0) + 1
        return out

    def totals(self) -> Dict[str, int]:
        c = {"logic_cells": 0, "lutram_bits": 0, "dsp_slices": 0,
             "gpio_bits": 0, "bus_in_bits": 0, "bus_out_bits": 0}
        for row in self.grid:
            for t in row:
                tt = TILE_LIBRARY[t]
                c["logic_cells"] += tt.logic_cells
                c["lutram_bits"] += tt.lutram_bits
                c["dsp_slices"] += tt.dsp_half
                c["gpio_bits"] += tt.gpio_bits
                c["bus_in_bits"] += tt.bus_in_bits
                c["bus_out_bits"] += tt.bus_out_bits
        c["dsp_slices"] //= 2  # top+bot pair = one slice
        return c

    @property
    def n_logic_cells(self) -> int:
        return self.totals()["logic_cells"]

    @property
    def input_capacity(self) -> int:
        """Bits presentable to the fabric per evaluation: config-plane bus
        registers + streaming plane + GPIO inputs."""
        t = self.totals()
        return self.config_bus_in + self.stream_bits + t["gpio_bits"] + t["bus_in_bits"]

    @property
    def output_capacity(self) -> int:
        t = self.totals()
        return self.config_bus_out + self.stream_bits + t["gpio_bits"] + t["bus_out_bits"]


def _col(tile: str, n: int) -> List[str]:
    return [tile] * n


def _make_grid(cols: List[List[str]]) -> Tuple[Tuple[str, ...], ...]:
    n_rows = max(len(c) for c in cols)
    rows = []
    # N/S termination rows as in the paper's tile CSVs.
    rows.append(tuple("N_term_single2" for _ in cols))
    for r in range(n_rows):
        rows.append(tuple(c[r] if r < len(c) else "NULL" for c in cols))
    rows.append(tuple("S_term_single2" for _ in cols))
    return tuple(rows)


# 130nm (§2.1): 48 LUT4AB (384 cells), 4 RegFile (128 regs), 4 DSP slices.
FABRIC_130NM = FabricSpec(
    name="efpga_130nm",
    node="130nm",
    grid=_make_grid([
        _col("W_IO", 8),
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        ["DSP_top", "DSP_bot"] * 4,
        _col("RegFile", 4) + _col("LUT4AB", 4),
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        _col("LUT4AB", 4) + _col("NULL", 4),
        _col("CPU_IO", 8),
    ]),
    config_bus_in=96,    # three 32-bit buses (§2.2)
    config_bus_out=96,
    stream_bits=0,
)

# 28nm (§4.1): 56 LUT4AB (448 cells), 4 DSP slices, WEST_IO/EAST_IO.
FABRIC_28NM = FabricSpec(
    name="efpga_28nm",
    node="28nm",
    grid=_make_grid([
        _col("WEST_IO", 8),
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        ["DSP_top", "DSP_bot"] * 4,
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        _col("LUT4AB", 8),
        _col("EAST_IO", 8),
    ]),
    config_bus_in=128,   # four 32-bit buses (§4.2)
    config_bus_out=128,
    stream_bits=64,      # AXI-Stream to/from PGPv4 (§4.2)
)

# Next-generation 28nm fabric (paper §5: "A next-generation eFPGA with a
# larger logical capacity"): same tile library, 4x the LUT4AB columns
# (224 LUT4AB, 1,792 cells). The TMR readout chip and the boosted
# ensembles need it; it is the program's reading of §5, not a taped-out
# chip.
FABRIC_28NM_XL = FabricSpec(
    name="efpga_28nm_xl",
    node="28nm",
    grid=_make_grid(
        [_col("WEST_IO", 8)]
        + [_col("LUT4AB", 8) for _ in range(14)]
        + [["DSP_top", "DSP_bot"] * 4]
        + [_col("LUT4AB", 8) for _ in range(14)]
        + [_col("EAST_IO", 8)]
    ),
    config_bus_in=128,
    config_bus_out=128,
    stream_bits=64,
)

FABRICS: Dict[str, FabricSpec] = {
    "efpga_130nm": FABRIC_130NM,
    "efpga_28nm": FABRIC_28NM,
    "efpga_28nm_xl": FABRIC_28NM_XL,
    "130nm": FABRIC_130NM,
    "28nm": FABRIC_28NM,
}


class CapacityError(RuntimeError):
    pass


# --------------------------------------------------------------------------
# Configured fabric (== decoded bitstream)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FabricConfig:
    """Everything the bitstream encodes, in levelized-array form.

    ``cell_of_lut[i]`` maps kernel LUT slot i to a physical logic cell index
    (tile-major) — the placement. The arrays mirror LevelizedNetlist so the
    Pallas kernel and the host simulator consume a decoded bitstream
    directly.
    """

    fabric_name: str
    n_nets: int
    n_inputs: int
    n_ffs: int
    level_sizes: List[int]
    lut_inputs: np.ndarray    # (n_luts, 4) int32
    lut_tables: np.ndarray    # (n_luts, 16) uint8
    output_nets: np.ndarray   # (n_outputs,) int32
    ff_d_nets: np.ndarray     # (n_ffs,) int32
    ff_init: np.ndarray       # (n_ffs,) uint8
    cell_of_lut: np.ndarray   # (n_luts,) int32
    cell_of_ff: np.ndarray    # (n_ffs,) int32

    @property
    def n_luts(self) -> int:
        return len(self.lut_inputs)

    @property
    def spec(self) -> FabricSpec:
        return FABRICS[self.fabric_name]

    def fanin_reach(self) -> int:
        """Max levels any LUT-to-LUT edge spans (>= 1).

        This is the K of the banded lut_eval routing: level l only reads
        primary inputs plus LUT outputs from levels [l-K, l). Derived from
        the decoded bitstream arrays, so it survives encode/decode.
        """
        return _fanin_reach(
            self.level_sizes, self.lut_inputs, 2 + self.n_inputs + self.n_ffs
        )

    def utilization(self) -> Dict[str, float]:
        spec = self.spec
        cells_used = len(
            np.unique(np.concatenate([self.cell_of_lut, self.cell_of_ff]))
        ) if (self.n_luts or self.n_ffs) else 0
        return {
            "luts": self.n_luts,
            "ffs": self.n_ffs,
            "logic_cells_used": cells_used,
            "logic_cells_total": spec.n_logic_cells,
            "lut_utilization": self.n_luts / spec.n_logic_cells,
            "depth": len(self.level_sizes),
        }


def place_and_route(netlist: Netlist, fabric: FabricSpec) -> FabricConfig:
    """Map a netlist into the fabric (first-fit packing + capacity checks).

    Packing rule (mirrors LUT4AB cells): a FF whose D input is the output of
    a LUT shares that LUT's cell; other FFs take a cell of their own.
    """
    lv = netlist.to_levelized()
    spec = fabric

    n_cells = spec.n_logic_cells
    lut_out_net = {}  # kernel-order net of each lut slot
    base = lv.base_comb
    for i in range(lv.n_luts):
        lut_out_net[base + i] = i

    cell_of_lut = np.arange(lv.n_luts, dtype=np.int32)
    cell_of_ff = np.full(lv.n_ffs, -1, dtype=np.int32)
    next_free = lv.n_luts
    for s in range(lv.n_ffs):
        d = int(lv.ff_d_nets[s])
        if d in lut_out_net:  # pack with driving LUT's cell
            cell_of_ff[s] = cell_of_lut[lut_out_net[d]]
        else:
            cell_of_ff[s] = next_free
            next_free += 1

    cells_used = max(int(next_free), lv.n_luts)
    if cells_used > n_cells:
        raise CapacityError(
            f"{netlist.n_luts} LUTs + {netlist.n_ffs} FFs need {cells_used} "
            f"logic cells; fabric {spec.name} has {n_cells}"
        )
    if lv.n_inputs > spec.input_capacity:
        raise CapacityError(
            f"netlist needs {lv.n_inputs} input bits; fabric {spec.name} "
            f"exposes {spec.input_capacity}"
        )
    if len(lv.output_nets) > spec.output_capacity:
        raise CapacityError(
            f"netlist needs {len(lv.output_nets)} output bits; fabric "
            f"{spec.name} exposes {spec.output_capacity}"
        )

    return FabricConfig(
        fabric_name=spec.name,
        n_nets=lv.n_nets,
        n_inputs=lv.n_inputs,
        n_ffs=lv.n_ffs,
        level_sizes=list(lv.level_sizes),
        lut_inputs=lv.lut_inputs.copy(),
        lut_tables=lv.lut_tables.copy(),
        output_nets=lv.output_nets.copy(),
        ff_d_nets=lv.ff_d_nets.copy(),
        ff_init=lv.ff_init.copy(),
        cell_of_lut=cell_of_lut,
        cell_of_ff=cell_of_ff,
    )


# --------------------------------------------------------------------------
# Multi-config stacking (many configured chips, one batched evaluation)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    """Feature-stage metadata of a frames-ingesting (fused) stack.

    A stack that scores RAW sensor frames carries the featurizer contract
    alongside the fabric envelope: the frame tensor shape, the feature
    vector width the frames->features stage produces, and the
    zero-suppression threshold baked into that stage. A chip hot-swapping
    into such a stack must be *encodable* from those features (every used
    feature index < n_features, int32-representable spec) — the server
    enforces this on reconfigure, the same way the fabric axes are
    enforced via ``admits``.
    """

    n_features: int
    frame_shape: Tuple[int, int, int]   # (n_t, n_y, n_x)
    threshold_electrons: float


@dataclasses.dataclass(frozen=True)
class StackGeometry:
    """Shared padded geometry a set of decoded bitstreams can stack into.

    Two configs are stack-compatible when both fit the same (levels, widest
    level, inputs, outputs) envelope; a config narrower on any axis is
    zero-padded up to it. This is what lets N heterogeneous chips share one
    chip-batched kernel dispatch — and what lets a *new* bitstream hot-swap
    into a running stack without recompiling, as long as it fits the
    envelope (the paper's reconfigurability property, now per-slot).
    """

    n_levels: int
    max_level_size: int
    n_inputs: int
    n_outputs: int
    # Fan-in-reach budget of the envelope: a banded stack only routes a
    # window of this many preceding levels into each level's matmul, so a
    # config with larger reach cannot hot-swap in. None = unconstrained
    # (dense stacks admit any reach <= n_levels).
    fanin_reach: Optional[int] = None
    # Feature-stage metadata when the stack ingests raw frames (the fused
    # frontend, kernels/frontend.py). None = the stack is fed pre-packed
    # input bits / host-computed features and has no featurizer contract.
    frontend: Optional[FrontendSpec] = None

    @classmethod
    def union(cls, configs: Sequence["FabricConfig"]) -> "StackGeometry":
        if not configs:
            raise ValueError("cannot stack zero configs")
        return cls(
            n_levels=max(max(len(c.level_sizes), 1) for c in configs),
            max_level_size=max(
                max(c.level_sizes, default=1) for c in configs
            ),
            n_inputs=max(c.n_inputs for c in configs),
            n_outputs=max(len(c.output_nets) for c in configs),
            fanin_reach=max(c.fanin_reach() for c in configs),
        )

    def admits(self, config: "FabricConfig") -> bool:
        """True if `config` fits this envelope (can swap into the stack)."""
        return (
            len(config.level_sizes) <= self.n_levels
            and max(config.level_sizes, default=1) <= self.max_level_size
            and config.n_inputs <= self.n_inputs
            and len(config.output_nets) <= self.n_outputs
            and (
                self.fanin_reach is None
                or config.fanin_reach() <= self.fanin_reach
            )
        )


def check_stackable(configs: Sequence[FabricConfig]) -> StackGeometry:
    """Validate a set of configs for chip-batched evaluation.

    All must be combinational (the batched kernel path, like lut_eval) and
    each must individually respect its own fabric's capacity — stacking
    never relaxes per-chip capacity.
    """
    geo = StackGeometry.union(configs)
    for i, c in enumerate(configs):
        if c.n_ffs:
            raise CapacityError(
                f"config {i} ({c.fabric_name}) is sequential ({c.n_ffs} FFs);"
                " chip-batched evaluation is combinational-only"
            )
    return geo


def stack_event_bits(
    per_chip_bits: Sequence[np.ndarray], n_inputs: int
) -> np.ndarray:
    """Zero-pad per-chip (B_i, n_inputs_i) bit arrays into the stacked
    (C, B_max, n_inputs) layout. THE padding convention: both the Pallas
    kernel packing (kernels/lut_eval/ops.py) and the host oracle consume
    this one layout, so the bit-identical guarantee has a single source."""
    C = len(per_chip_bits)
    B = max((len(b) for b in per_chip_bits), default=0)
    out = np.zeros((C, B, n_inputs), np.uint8)
    for i, b in enumerate(per_chip_bits):
        b = np.asarray(b, np.uint8)
        if b.size:
            assert b.shape[1] <= n_inputs, (b.shape, n_inputs)
            out[i, : len(b), : b.shape[1]] = b
    return out


def packed_table_image(
    config: FabricConfig, n_levels: int, m_pad: int
) -> np.ndarray:
    """The configuration-memory image of a config's truth tables in the
    padded (level, slot-in-level) layout: (n_levels, m_pad, 16) uint8,
    zero on unoccupied slots.

    This is THE scrub-loop representation: the kernel stack packs its
    device ``tables`` arrays through this function (kernels/lut_eval),
    readback returns it, and the golden CRC digests (core.bitstream) are
    computed over it — so "readback equals golden" is a structural
    identity, not two parallel packings that merely happen to agree.
    """
    c = config
    assert len(c.level_sizes) <= n_levels, (len(c.level_sizes), n_levels)
    assert max(c.level_sizes, default=1) <= m_pad, (c.level_sizes, m_pad)
    img = np.zeros((n_levels, m_pad, 16), np.uint8)
    if c.n_luts:
        sizes = np.asarray(c.level_sizes, np.int64)
        lut_level = np.repeat(np.arange(len(sizes)), sizes)
        starts = np.concatenate([[0], np.cumsum(sizes)])
        pos = np.arange(c.n_luts) - starts[lut_level]
        img[lut_level, pos] = c.lut_tables
    return img


class MultiFabricSim:
    """Per-chip numpy oracle for a stacked batch of combinational chips.

    Input is the stacked layout the kernel consumes: bits (C, B, n_inputs)
    zero-padded to the geometry's input width. Output is (C, B, n_outputs)
    zero-padded — padded output lanes read constant 0, matching the
    kernel's const0-net padding.

    ``geometry`` pins an explicit (usually wider) envelope — e.g. a
    readout server's fixed stack envelope — so the oracle's dims stay
    stable when a chip is hot-swapped for a narrower one. Every config
    must fit it.
    """

    def __init__(self, configs: Sequence[FabricConfig],
                 geometry: Optional[StackGeometry] = None):
        base = check_stackable(configs)
        if geometry is None:
            geometry = base
        else:
            for i, c in enumerate(configs):
                if not geometry.admits(c):
                    raise CapacityError(
                        f"config {i} does not fit pinned envelope {geometry}"
                    )
        self.geometry = geometry
        self.configs = list(configs)
        self._sims = [FabricSim(c) for c in configs]

    def swap_config(self, index: int, config: "FabricConfig") -> None:
        """Replace ONE slot's config in place, rebuilding only that
        slot's simulator — the host-backend hot-swap/SEU-injection path
        (a full-fleet rebuild per flipped bit would make a fault-
        injection sweep O(chips x replicas) per flip). The config must
        fit the pinned envelope, like construction."""
        if config.n_ffs:
            raise CapacityError(
                f"config is sequential ({config.n_ffs} FFs); chip-batched "
                "evaluation is combinational-only")
        if not self.geometry.admits(config):
            raise CapacityError(
                f"config does not fit pinned envelope {self.geometry}")
        self.configs[index] = config
        self._sims[index] = FabricSim(config)

    def readback_tables(
        self, index: int, n_levels: int, m_pad: int
    ) -> np.ndarray:
        """Host-oracle scrub twin of ``PackedFabricStack.readback_replica``:
        the LIVE truth-table image of one simulated slot, in the same
        padded (n_levels, m_pad, 16) uint8 layout the device readback
        uses — so one golden CRC digest verifies both backends. Reads the
        simulator's own config (the image ``swap_config`` perturbs), not
        any cached golden copy."""
        if not 0 <= index < len(self.configs):
            raise ValueError(
                f"index must be in [0, {len(self.configs)}), got {index!r}")
        return packed_table_image(self.configs[index], n_levels, m_pad)

    def run(self, bits: np.ndarray) -> np.ndarray:
        bits = np.asarray(bits, np.uint8)
        C, B = bits.shape[0], bits.shape[1]
        assert C == len(self.configs), (C, len(self.configs))
        assert bits.shape[2] == self.geometry.n_inputs
        out = np.zeros((C, B, self.geometry.n_outputs), np.uint8)
        for i, sim in enumerate(self._sims):
            c = self.configs[i]
            o, _ = sim.run(bits[i, :, : c.n_inputs])
            out[i, :, : o.shape[1]] = o
        return out


# --------------------------------------------------------------------------
# Host-side functional simulator (bit-exact oracle for the Pallas kernel)
# --------------------------------------------------------------------------


class FabricSim:
    """Cycle simulator for a configured fabric (numpy, bit-exact)."""

    def __init__(self, config: FabricConfig):
        self.cfg = config
        c = config
        self._level_start = np.concatenate(
            [[0], np.cumsum(c.level_sizes)]
        ).astype(np.int64)

    def run(
        self,
        input_bits: np.ndarray,
        n_cycles: int = 1,
        state: Optional[np.ndarray] = None,
        trace_outputs: bool = False,
    ):
        """Same contract as Netlist.evaluate, but driven by the decoded
        bitstream arrays (closing the netlist->bitstream->fabric loop)."""
        c = self.cfg
        input_bits = np.asarray(input_bits, np.uint8)
        if input_bits.ndim == 2:
            input_bits = np.repeat(input_bits[:, None, :], n_cycles, axis=1)
        batch = input_bits.shape[0]
        assert input_bits.shape[2] == c.n_inputs

        values = np.zeros((batch, c.n_nets), np.uint8)
        values[:, 1] = 1
        if state is None:
            state = np.tile(c.ff_init, (batch, 1)) if c.n_ffs else np.zeros(
                (batch, 0), np.uint8)

        base = 2 + c.n_inputs + c.n_ffs
        traces = []
        for t in range(n_cycles):
            values[:, 2 : 2 + c.n_inputs] = input_bits[:, t, :]
            if c.n_ffs:
                values[:, 2 + c.n_inputs : base] = state
            for lvi in range(len(c.level_sizes)):
                lo, hi = self._level_start[lvi], self._level_start[lvi + 1]
                ins = c.lut_inputs[lo:hi]          # (m, 4)
                vals = values[:, ins]               # (batch, m, 4)
                idx = (
                    vals[..., 0] + 2 * vals[..., 1] + 4 * vals[..., 2] + 8 * vals[..., 3]
                )
                tbl = c.lut_tables[lo:hi]            # (m, 16)
                values[:, base + lo : base + hi] = np.take_along_axis(
                    tbl[None].repeat(batch, 0), idx[..., None].astype(np.int64), 2
                )[..., 0]
            if c.n_ffs:
                state = values[:, c.ff_d_nets].copy()
            if trace_outputs:
                traces.append(values[:, c.output_nets].copy())
        outs = np.stack(traces, 1) if trace_outputs else values[:, c.output_nets].copy()
        return outs, state


# --------------------------------------------------------------------------
# Bit-sliced host oracle (numpy twin of kernels/lut_eval/bitsliced.py)
# --------------------------------------------------------------------------

_WORD = 32
_ALL_ONES32 = np.uint32(0xFFFFFFFF)


def pack_event_words(bits: np.ndarray) -> np.ndarray:
    """Event-transpose for the bit-sliced layout: (..., B, n) 0/1 bits ->
    (..., W, n) uint32 words, W = ceil(B/32) (at least 1).

    THE word convention: bit ``e`` of word ``w`` is event ``w*32 + e``.
    The device packer (kernels.lut_eval.bitsliced.pack_words) is the jnp
    twin of this function; the property tests in tests/test_bitsliced.py
    hold the pair bit-identical (round-trip, arbitrary tails). Events
    past B land in zero tail lanes.
    """
    bits = np.asarray(bits, np.uint8)
    B = bits.shape[-2]
    W = max(-(-B // _WORD), 1)
    pad = W * _WORD - B
    if pad:
        widths = [(0, 0)] * (bits.ndim - 2) + [(0, pad), (0, 0)]
        bits = np.pad(bits, widths)
    b = bits.reshape(bits.shape[:-2] + (W, _WORD, bits.shape[-1]))
    b = b.astype(np.uint32)
    shifts = np.arange(_WORD, dtype=np.uint32)[:, None]     # (32, 1)
    return np.bitwise_or.reduce(b << shifts, axis=-2).astype(np.uint32)


def unpack_event_words(words: np.ndarray, n_events: int) -> np.ndarray:
    """Inverse event-transpose: (..., W, n) uint32 -> (..., B, n) uint8.

    Exact inverse of ``pack_event_words`` for n_events <= W*32; tail
    lanes (events >= n_events) are dropped — padding lanes can never
    leak past this function.
    """
    words = np.asarray(words, np.uint32)
    W = words.shape[-2]
    shifts = np.arange(_WORD, dtype=np.uint32)[:, None]     # (32, 1)
    b = (words[..., None, :] >> shifts) & np.uint32(1)
    b = b.reshape(words.shape[:-2] + (W * _WORD, words.shape[-1]))
    return b[..., :n_events, :].astype(np.uint8)


class BitslicedSim:
    """Host oracle for the bit-sliced evaluator: 32 events per word.

    Independently written against the RAW decoded-bitstream arrays (net
    ids, no kernel padding) — like FabricSim is for the matmul kernel —
    so agreement with the device path (kernels/lut_eval/bitsliced.py,
    which evaluates the PACKED layout) is a real cross-check, not the
    same packing read back twice. Each 4-LUT is the 15-op bitwise mux
    tree over uint32 words; combinational configs only.

    ``band_k`` makes this the BANDED oracle: the band is a fan-in-reach
    envelope (a routing constraint), not an evaluation structure, so a
    banded fabric must *reject* configs whose reach exceeds K at
    admission — with a named error, the host twin of the device
    packer's check — and then evaluate admitted configs identically to
    the unbanded case. That identity (validation changes, outputs don't)
    is exactly what the conformance suite pins.
    """

    def __init__(self, config: FabricConfig, band_k: int | None = None):
        if config.n_ffs:
            raise CapacityError(
                f"config is sequential ({config.n_ffs} FFs); bit-sliced "
                "evaluation is combinational-only"
            )
        if band_k is not None:
            reach = config.fanin_reach()
            if reach > band_k:
                raise ValueError(
                    f"fan-in reach exceeds band: K={band_k} but the "
                    f"config's reach is {reach}"
                )
        self.band_k = band_k
        self.cfg = config
        self._level_start = np.concatenate(
            [[0], np.cumsum(config.level_sizes)]
        ).astype(np.int64)

    def run_words(self, in_words: np.ndarray) -> np.ndarray:
        """(W, n_inputs) uint32 input words -> (W, n_outputs) uint32."""
        c = self.cfg
        in_words = np.asarray(in_words, np.uint32)
        W = in_words.shape[0]
        assert in_words.shape[1] == c.n_inputs, (
            in_words.shape, c.n_inputs)
        vals = np.zeros((W, c.n_nets), np.uint32)
        vals[:, 1] = _ALL_ONES32                       # const1: all lanes
        vals[:, 2 : 2 + c.n_inputs] = in_words
        base = 2 + c.n_inputs
        for lvi in range(len(c.level_sizes)):
            lo, hi = self._level_start[lvi], self._level_start[lvi + 1]
            g = vals[:, c.lut_inputs[lo:hi]]           # (W, m, 4)
            t = np.where(
                c.lut_tables[lo:hi][None] != 0, _ALL_ONES32, np.uint32(0)
            )                                          # (1, m, 16)
            for k in range(4):
                s = g[:, :, k : k + 1]                 # (W, m, 1)
                t = (s & t[..., 1::2]) | (~s & t[..., 0::2])
            vals[:, base + lo : base + hi] = t[..., 0]
        return vals[:, c.output_nets].copy()

    def run(self, bits: np.ndarray) -> np.ndarray:
        """Same contract as FabricSim.run for one combinational pass:
        (B, n_inputs) 0/1 -> (B, n_outputs) uint8, via the word
        transpose (pack -> run_words -> unpack)."""
        bits = np.asarray(bits, np.uint8)
        B = bits.shape[0]
        return unpack_event_words(self.run_words(pack_event_words(bits)), B)
