# Copy of repro/core/netlist.py with imports rewritten: the PyTorch port keeps its own
# numpy modules and imports nothing of the JAX package.
"""LUT4-level netlist IR — the logic representation the eFPGA fabric executes.

A netlist is a DAG of 4-input LUTs plus optional flip-flops, with primary
inputs and outputs. This mirrors what FABulous' flow (yosys + nextpnr) hands
to the fabric: every combinational function decomposed into LUT4s, every
state element a FF in a LUT4AB logic cell.

Net ordering convention (important — the Pallas kernel relies on it):

    [const0, const1, inputs..., ff_q..., level-0 LUT outs, level-1 LUT outs, ...]

so each level's outputs form a contiguous range and a levelized evaluation
is a sequence of dense "select inputs -> 16-way table lookup -> write slice"
steps. On TPU the select step is a one-hot matmul (MXU) and the lookup is a
16-way one-hot contraction — the fabric's *spatial* parallelism becomes
*batch* parallelism (see DESIGN.md §3).

The numpy evaluator in this file is the bit-exact host oracle; the pure-jnp
oracle lives in kernels/lut_eval/ref.py and the TPU kernel in
kernels/lut_eval/lut_eval.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

CONST0 = 0
CONST1 = 1


def fanin_reach(
    level_sizes: Sequence[int], lut_inputs: np.ndarray, base_comb: int
) -> int:
    """Max levels a LUT input edge spans in a levelized netlist.

    A level-``l`` LUT reads consts/inputs/FF outputs (reach 0, they live in
    the kernel's input segment) or nets produced by LUTs at levels
    ``l - reach``. The returned K bounds the window of preceding levels any
    level needs to see — the banded lut_eval kernel touches only
    ``in_seg + K * m_pad`` net columns per level instead of all of them.
    Returns at least 1 so a band is never degenerate.
    """
    level_sizes = np.asarray(level_sizes, np.int64)
    lut_inputs = np.asarray(lut_inputs, np.int64).reshape(-1, 4)
    n_luts = len(lut_inputs)
    if n_luts == 0:
        return 1
    assert int(level_sizes.sum()) == n_luts, (level_sizes, n_luts)
    # level of each LUT slot (kernel order = level-major)
    lut_level = np.repeat(np.arange(len(level_sizes)), level_sizes)
    is_comb = lut_inputs >= base_comb
    src_slot = np.where(is_comb, lut_inputs - base_comb, 0)
    src_level = lut_level[src_slot]
    reach = np.where(is_comb, lut_level[:, None] - src_level, 0)
    return max(int(reach.max(initial=0)), 1)


def table_from_fn(fn: Callable[..., int], n_inputs: int) -> int:
    """Build a 16-bit LUT4 truth table from a boolean function of n_inputs.

    Input bit k of the table index is LUT input k; unused high inputs are
    don't-care (tied to const0 by the builder, so entries with those bits set
    are unreachable but still filled consistently).
    """
    table = 0
    for idx in range(16):
        bits = [(idx >> k) & 1 for k in range(4)]
        if fn(*bits[:n_inputs]):
            table |= 1 << idx
    return table


TBL_NOT = table_from_fn(lambda a: 1 - a, 1)
TBL_BUF = table_from_fn(lambda a: a, 1)
TBL_AND2 = table_from_fn(lambda a, b: a & b, 2)
TBL_OR2 = table_from_fn(lambda a, b: a | b, 2)
TBL_XOR2 = table_from_fn(lambda a, b: a ^ b, 2)
TBL_MUX2 = table_from_fn(lambda s, a, b: b if s else a, 3)  # s=0 -> a
TBL_AND3 = table_from_fn(lambda a, b, c: a & b & c, 3)
TBL_OR3 = table_from_fn(lambda a, b, c: a | b | c, 3)
TBL_AND4 = table_from_fn(lambda a, b, c, d: a & b & c & d, 4)
TBL_OR4 = table_from_fn(lambda a, b, c, d: a | b | c | d, 4)


@dataclasses.dataclass(frozen=True)
class LUT:
    inputs: Tuple[int, int, int, int]  # net ids (pad with CONST0)
    table: int                          # 16-bit truth table
    out: int                            # output net id


@dataclasses.dataclass(frozen=True)
class FF:
    d: int      # combinational net sampled at the clock edge
    q: int      # state net driven by this FF
    init: int = 0


@dataclasses.dataclass
class Netlist:
    n_nets: int
    inputs: List[int]
    outputs: List[int]
    luts: List[LUT]
    ffs: List[FF]
    names: Dict[int, str]

    @property
    def n_luts(self) -> int:
        return len(self.luts)

    @property
    def n_ffs(self) -> int:
        return len(self.ffs)

    def resource_report(self) -> Dict[str, int]:
        lv = self.levelize()
        return {
            "luts": self.n_luts,
            "ffs": self.n_ffs,
            "inputs": len(self.inputs),
            "outputs": len(self.outputs),
            "nets": self.n_nets,
            "depth": len(lv),
        }

    def levelize(self) -> List[List[int]]:
        """Group LUT indices into combinational levels.

        Level of a LUT = 1 + max(level of driver LUTs); inputs/consts/FF
        outputs are level 0. Raises on combinational cycles.
        """
        driver: Dict[int, int] = {l.out: i for i, l in enumerate(self.luts)}
        level = [-1] * len(self.luts)

        def lut_level(i: int, visiting: set) -> int:
            if level[i] >= 0:
                return level[i]
            if i in visiting:
                raise ValueError("combinational cycle through LUT %d" % i)
            visiting.add(i)
            lv = 0
            for net in self.luts[i].inputs:
                j = driver.get(net)
                if j is not None:
                    lv = max(lv, lut_level(j, visiting) + 1)
            visiting.discard(i)
            level[i] = lv
            return lv

        for i in range(len(self.luts)):
            lut_level(i, set())
        n_levels = (max(level) + 1) if level else 0
        out: List[List[int]] = [[] for _ in range(n_levels)]
        for i, lv in enumerate(level):
            out[lv].append(i)
        return out

    # ---------------------------------------------------------------- eval
    def evaluate(
        self,
        input_bits: np.ndarray,
        n_cycles: int = 1,
        state: Optional[np.ndarray] = None,
        trace_outputs: bool = False,
    ):
        """Bit-exact batched evaluation (host oracle).

        input_bits: (batch, n_inputs) or (batch, n_cycles, n_inputs) 0/1.
        Returns (outputs, state): outputs (batch, n_outputs) for the final
        cycle, or (batch, n_cycles, n_outputs) if trace_outputs.
        """
        input_bits = np.asarray(input_bits, dtype=np.uint8)
        if input_bits.ndim == 2:
            input_bits = np.repeat(input_bits[:, None, :], n_cycles, axis=1)
        batch = input_bits.shape[0]
        assert input_bits.shape[1] == n_cycles
        assert input_bits.shape[2] == len(self.inputs), (
            input_bits.shape, len(self.inputs))

        levels = self.levelize()
        values = np.zeros((batch, self.n_nets), dtype=np.uint8)
        values[:, CONST1] = 1
        if state is None:
            state = np.tile(
                np.asarray([f.init for f in self.ffs], np.uint8), (batch, 1)
            ) if self.ffs else np.zeros((batch, 0), np.uint8)
        tables = np.array(
            [[(l.table >> k) & 1 for k in range(16)] for l in self.luts], np.uint8
        ) if self.luts else np.zeros((0, 16), np.uint8)

        traces = []
        for c in range(n_cycles):
            values[:, self.inputs] = input_bits[:, c, :]
            for f, s in zip(self.ffs, range(len(self.ffs))):
                values[:, f.q] = state[:, s]
            for lv in levels:
                for i in lv:
                    l = self.luts[i]
                    idx = (
                        values[:, l.inputs[0]]
                        + 2 * values[:, l.inputs[1]]
                        + 4 * values[:, l.inputs[2]]
                        + 8 * values[:, l.inputs[3]]
                    )
                    values[:, l.out] = tables[i][idx]
            if self.ffs:
                state = values[:, [f.d for f in self.ffs]].copy()
            if trace_outputs:
                traces.append(values[:, self.outputs].copy())
        outs = (
            np.stack(traces, axis=1) if trace_outputs else values[:, self.outputs].copy()
        )
        return outs, state

    def to_levelized(self) -> "LevelizedNetlist":
        return LevelizedNetlist.from_netlist(self)


@dataclasses.dataclass
class LevelizedNetlist:
    """Dense-array form consumed by the fabric simulator and Pallas kernel.

    Nets are RENUMBERED into kernel order:
      [const0, const1, inputs, ff_q, lvl0 outs, lvl1 outs, ...]
    """

    n_nets: int
    n_inputs: int
    n_ffs: int
    level_sizes: List[int]           # LUTs per level
    lut_inputs: np.ndarray           # (n_luts, 4) int32, kernel-order net ids
    lut_tables: np.ndarray           # (n_luts, 16) uint8
    output_nets: np.ndarray          # (n_outputs,) int32 kernel-order
    ff_d_nets: np.ndarray            # (n_ffs,) int32 kernel-order
    ff_init: np.ndarray              # (n_ffs,) uint8
    lut_order: np.ndarray            # (n_luts,) original LUT index per kernel slot

    @property
    def n_luts(self) -> int:
        return len(self.lut_inputs)

    @property
    def base_comb(self) -> int:
        """First net id of level-0 LUT outputs."""
        return 2 + self.n_inputs + self.n_ffs

    def fanin_reach(self) -> int:
        """Max levels any LUT-to-LUT edge spans (see module fanin_reach)."""
        return fanin_reach(self.level_sizes, self.lut_inputs, self.base_comb)

    @classmethod
    def from_netlist(cls, nl: Netlist) -> "LevelizedNetlist":
        levels = nl.levelize()
        remap = {CONST0: 0, CONST1: 1}
        nxt = 2
        for net in nl.inputs:
            remap[net] = nxt
            nxt += 1
        for f in nl.ffs:
            remap[f.q] = nxt
            nxt += 1
        order: List[int] = []
        for lv in levels:
            for i in lv:
                remap[nl.luts[i].out] = nxt
                nxt += 1
                order.append(i)
        lut_inputs = np.array(
            [[remap[n] for n in nl.luts[i].inputs] for i in order], np.int32
        ).reshape(-1, 4)
        lut_tables = np.array(
            [[(nl.luts[i].table >> k) & 1 for k in range(16)] for i in order],
            np.uint8,
        ).reshape(-1, 16)
        return cls(
            n_nets=nxt,
            n_inputs=len(nl.inputs),
            n_ffs=len(nl.ffs),
            level_sizes=[len(lv) for lv in levels],
            lut_inputs=lut_inputs,
            lut_tables=lut_tables,
            output_nets=np.array([remap[n] for n in nl.outputs], np.int32),
            ff_d_nets=np.array([remap[f.d] for f in nl.ffs], np.int32),
            ff_init=np.array([f.init for f in nl.ffs], np.uint8),
            lut_order=np.array(order, np.int32),
        )


# --------------------------------------------------------------------------
# Builder
# --------------------------------------------------------------------------


class NetlistBuilder:
    def __init__(self):
        self._n = 2  # const0, const1
        self._inputs: List[int] = []
        self._outputs: List[int] = []
        self._luts: List[LUT] = []
        self._ffs: List[FF] = []
        self._names: Dict[int, str] = {0: "const0", 1: "const1"}

    def _new_net(self, name: str = "") -> int:
        net = self._n
        self._n += 1
        if name:
            self._names[net] = name
        return net

    def input(self, name: str = "") -> int:
        net = self._new_net(name or f"in{len(self._inputs)}")
        self._inputs.append(net)
        return net

    def input_bus(self, width: int, name: str = "in") -> List[int]:
        return [self.input(f"{name}[{i}]") for i in range(width)]

    def mark_output(self, net: int, name: str = "") -> int:
        self._outputs.append(net)
        if name:
            self._names[net] = name
        return net

    def lut(self, table: int, ins: Sequence[int], name: str = "") -> int:
        ins = list(ins) + [CONST0] * (4 - len(ins))
        out = self._new_net(name)
        self._luts.append(LUT(inputs=tuple(ins[:4]), table=table & 0xFFFF, out=out))
        return out

    def ff(self, d: int, init: int = 0, name: str = "") -> int:
        q = self._new_net(name or f"ff{len(self._ffs)}")
        self._ffs.append(FF(d=d, q=q, init=init))
        return q

    # convenience gates --------------------------------------------------
    def not_(self, a: int) -> int:
        return self.lut(TBL_NOT, [a])

    def buf(self, a: int) -> int:
        return self.lut(TBL_BUF, [a])

    def and_(self, *nets: int) -> int:
        nets = list(nets)
        while len(nets) > 1:
            grp, rest = nets[:4], nets[4:]
            tbl = {2: TBL_AND2, 3: TBL_AND3, 4: TBL_AND4}[max(len(grp), 2)]
            nets = [self.lut(tbl, grp)] + rest
        return nets[0]

    def or_(self, *nets: int) -> int:
        nets = list(nets)
        while len(nets) > 1:
            grp, rest = nets[:4], nets[4:]
            tbl = {2: TBL_OR2, 3: TBL_OR3, 4: TBL_OR4}[max(len(grp), 2)]
            nets = [self.lut(tbl, grp)] + rest
        return nets[0]

    def xor_(self, a: int, b: int) -> int:
        return self.lut(TBL_XOR2, [a, b])

    def mux2(self, sel: int, a: int, b: int) -> int:
        """sel == 0 -> a, sel == 1 -> b."""
        return self.lut(TBL_MUX2, [sel, a, b])

    def fn(self, f: Callable[..., int], *nets: int) -> int:
        """LUT computing an arbitrary boolean fn of up to 4 nets."""
        assert 1 <= len(nets) <= 4
        return self.lut(table_from_fn(f, len(nets)), list(nets))

    # wide comparators (HLS-style, against a CONSTANT) --------------------
    def le_const(self, bits: Sequence[int], const: int) -> int:
        """Return net computing  unsigned(bits) <= const.

        bits are LSB-first. Synthesized like HLS does for constant
        comparison: 4-bit slices each produce (lt, eq) vs the constant
        nibble (1 LUT each), then a combine chain folds MSB->LSB:
            le = lt_hi | (eq_hi & le_lo)
        Cost: 2*ceil(W/4) + (ceil(W/4)-1) LUTs for W-bit compare.
        """
        W = len(bits)
        n_slices = (W + 3) // 4
        lts, eqs = [], []
        for s in range(n_slices):
            lo = s * 4
            grp = list(bits[lo : lo + 4])
            k = (const >> lo) & ((1 << len(grp)) - 1)
            nb = len(grp)

            def lt_fn(*xs, _k=k, _nb=nb):
                v = sum(x << i for i, x in enumerate(xs[:_nb]))
                return 1 if v < _k else 0

            def eq_fn(*xs, _k=k, _nb=nb):
                v = sum(x << i for i, x in enumerate(xs[:_nb]))
                return 1 if v == _k else 0

            lts.append(self.lut(table_from_fn(lt_fn, nb), grp))
            eqs.append(self.lut(table_from_fn(eq_fn, nb), grp))
        # Combine from LSB slice up: le_so_far starts as (lt_0 | eq_0).
        le = self.fn(lambda l, e: l | e, lts[0], eqs[0])
        for s in range(1, n_slices):
            # le_new = lt_s | (eq_s & le_prev)   (one LUT3)
            le = self.fn(lambda l, e, p: l | (e & p), lts[s], eqs[s], le)
        return le

    # arithmetic -----------------------------------------------------------
    def increment(self, bits: Sequence[int]) -> List[int]:
        """Return bits of unsigned(bits) + 1 (same width, wraps)."""
        out = []
        carry = CONST1
        for b in bits:
            out.append(self.xor_(b, carry))
            carry = self.and_(b, carry)
        return out

    def build(self) -> Netlist:
        return Netlist(
            n_nets=self._n,
            inputs=list(self._inputs),
            outputs=list(self._outputs),
            luts=list(self._luts),
            ffs=list(self._ffs),
            names=dict(self._names),
        )


# --------------------------------------------------------------------------
# Reference firmware (the paper's bring-up tests)
# --------------------------------------------------------------------------


def counter_netlist(width: int = 16) -> Netlist:
    """The paper's §2.4.1/§4.4.1 bring-up firmware: a free-running counter."""
    b = NetlistBuilder()
    qs = [b.ff(CONST0, name=f"q[{i}]") for i in range(width)]  # d patched below
    inc = b.increment(qs)
    # Rewire each FF's D input to the incremented bit.
    nl = b.build()
    ffs = [FF(d=inc[i], q=nl.ffs[i].q, init=0) for i in range(width)]
    nl = Netlist(
        n_nets=nl.n_nets, inputs=nl.inputs, outputs=nl.outputs,
        luts=nl.luts, ffs=ffs, names=nl.names,
    )
    for q in qs:
        nl.outputs.append(q)
    return nl


def loopback_netlist(width: int = 8) -> Netlist:
    """§4.4.3 AXI-Stream loopback: one register stage with valid/ready.

    Inputs:  data[width], in_valid, out_ready
    Outputs: out_data[width], out_valid, in_ready
    Single skid-free register stage: accepts when empty or when downstream
    consumes this cycle.
    """
    b = NetlistBuilder()
    data = b.input_bus(width, "in_data")
    in_valid = b.input("in_valid")
    out_ready = b.input("out_ready")

    full_q = b.ff(CONST0, name="full")  # d patched below
    # in_ready = !full | out_ready
    in_ready = b.fn(lambda f, r: (1 - f) | r, full_q, out_ready)
    accept = b.and_(in_valid, in_ready)
    # next_full = accept | (full & !out_ready)
    next_full = b.fn(lambda a, f, r: a | (f & (1 - r)), accept, full_q, out_ready)

    data_q = []
    for i, d_in in enumerate(data):
        dq = b.ff(CONST0, name=f"data_q[{i}]")
        data_q.append(dq)
    nl0 = b.build()

    # Patch FF D-inputs: full <- next_full; data_q <- accept ? in : hold.
    b2_luts = list(nl0.luts)
    ffs = []
    for f in nl0.ffs:
        ffs.append(f)
    # Build the hold muxes with a second pass builder-free (append LUTs).
    nets = nl0.n_nets

    def add_lut(table, ins):
        nonlocal nets
        out = nets
        nets += 1
        ins = list(ins) + [CONST0] * (4 - len(ins))
        b2_luts.append(LUT(inputs=tuple(ins[:4]), table=table & 0xFFFF, out=out))
        return out

    new_ffs = [FF(d=next_full, q=ffs[0].q, init=0)]
    for i, dq in enumerate(data_q):
        d_next = add_lut(TBL_MUX2, [accept, dq, data[i]])  # accept=1 -> take input
        new_ffs.append(FF(d=d_next, q=dq, init=0))

    outputs = list(data_q) + [ffs[0].q, in_ready]  # out_data, out_valid(=full), in_ready
    return Netlist(
        n_nets=nets, inputs=nl0.inputs, outputs=outputs,
        luts=b2_luts, ffs=new_ffs, names=nl0.names,
    )
