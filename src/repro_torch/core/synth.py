# Copy of repro/core/synth.py with imports rewritten: the PyTorch port keeps its own
# numpy modules and imports nothing of the JAX package.
"""Conifer-style synthesis: quantized BDT -> LUT4 netlist (paper §5).

The paper's flow: scikit-learn BDT -> Conifer -> HLS (C -> Verilog) ->
yosys/nextpnr -> 28nm eFPGA bitstream. The synthesized module had
"only 9 threshold parameters and 7 inputs" and "utilized 294 LUTs",
evaluating in a single combinational pass (< 25 ns).

We reproduce the same structure directly at the LUT level:

  1. thresholds/leaves quantized onto the ap_fixed<W,I> grid (quantize.py);
  2. per internal node, an HLS-style *constant comparator*:
     the feature's offset-binary bits are compared against the constant in
     4-bit slices (one LUT4 per (lt, eq) pair per slice) folded by a
     combine chain — 2*ceil(W/4) + ceil(W/4) - 1 LUTs per node;
  3. per leaf, a polarity-aware AND of the path conditions (one-hot);
  4. per output bit, an OR over the leaves whose (f0-folded) value has that
     bit set — constant bits across all leaves cost zero LUTs.

The result is a pure combinational netlist: one fabric pass per event, the
exact analogue of the paper's single decision-function module. Multi-tree
ensembles synthesize each tree and sum them (beyond the paper's single
tree, bounded by fabric capacity).

Two ensemble summation strategies (``synth_ensemble(..., adder=...)``):

  * ``"ripple"`` — the minimal-area chain: fold trees left-to-right with
    W-bit ripple-carry adders (2 LUTs/bit). The carry chain makes the
    levelized netlist ~W levels deeper per chain, and — worse for the
    banded lut_eval kernel — a deep carry LUT still reads the *flat* tree
    output bits many levels below it, so fan-in reach grows with depth.
  * ``"tree"`` (default) — balanced tree reduction with carry-select
    adders: each W-bit add splits into 4-bit blocks that ripple both
    carry-in polarities in parallel, then a short block-carry mux chain
    selects. Depth per add drops from ~W to ~(block + W/block) and every
    LUT reads at most ~(block + W/block) levels back, so both the level
    count L *and* the band K of the banded routing kernel stay small.
    Costs ~2.5x the adder LUTs of ripple — the classic speed/area trade.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bdt import LEAF, QuantizedEnsemble, QuantizedTree
from repro_torch.core.netlist import (
    CONST0,
    CONST1,
    Netlist,
    NetlistBuilder,
    table_from_fn,
)
from repro_torch.core.quantize import FixedSpec, to_unsigned_bits


@dataclasses.dataclass
class SynthResult:
    netlist: Netlist
    spec: FixedSpec
    used_features: List[int]            # feature indices that must be fed
    # input net order: for f in used_features: W bits LSB-first (offset-binary)
    n_thresholds: int
    report: Dict[str, int]
    adder: str = "tree"  # ensemble summation structure ("tree" | "ripple")

    def encode_inputs(self, X_raw: np.ndarray) -> np.ndarray:
        """(n, n_features) raw int64 -> (n, n_used * W) input bits."""
        u = to_unsigned_bits(X_raw[:, self.used_features], self.spec)
        W = self.spec.width
        bits = ((u[..., None] >> np.arange(W)) & 1).astype(np.uint8)
        return bits.reshape(len(X_raw), -1)

    def decode_outputs(self, out_bits: np.ndarray) -> np.ndarray:
        """(n, W) two's-complement bits LSB-first -> signed raw int64."""
        W = self.spec.width
        u = (out_bits.astype(np.int64) * (np.int64(1) << np.arange(W))).sum(-1)
        sign = np.int64(1) << (W - 1)
        return np.where(u >= sign, u - (sign << 1), u)


def _and_polarity(b: NetlistBuilder, terms: List[Tuple[int, bool]]) -> int:
    """AND of terms with polarities (net, keep_if_true) — negations folded
    into the LUT tables, 4 terms per LUT."""
    if not terms:
        return CONST1
    nets = list(terms)
    while len(nets) > 1 or (len(nets) == 1 and not nets[0][1]):
        grp, rest = nets[:4], nets[4:]
        pols = [p for _, p in grp]

        def fn(*xs, _p=pols):
            v = 1
            for x, p in zip(xs, _p):
                v &= x if p else (1 - x)
            return v

        out = b.lut(table_from_fn(fn, len(grp)), [n for n, _ in grp])
        nets = [(out, True)] + rest
    return nets[0][0]


def _ripple_add(b: NetlistBuilder, a: List[int], c: List[int]) -> List[int]:
    """W-bit two's-complement ripple-carry adder (wraps), 2 LUTs/bit."""
    W = len(a)
    out, carry = [], CONST0
    for i in range(W):
        s = b.fn(lambda x, y, ci: x ^ y ^ ci, a[i], c[i], carry)
        carry = b.fn(lambda x, y, ci: (x & y) | (ci & (x | y)), a[i], c[i], carry)
        out.append(s)
    return out


def _ripple_block(
    b: NetlistBuilder, a: List[int], c: List[int], carry: int
) -> Tuple[List[int], int]:
    """Ripple add of one block with an explicit carry-in net; returns
    (sum bits, carry-out net)."""
    out = []
    for x, y in zip(a, c):
        out.append(b.fn(lambda p, q, ci: p ^ q ^ ci, x, y, carry))
        carry = b.fn(lambda p, q, ci: (p & q) | (ci & (p | q)), x, y, carry)
    return out, carry


def _carry_select_add(
    b: NetlistBuilder, a: List[int], c: List[int], block: int = 4
) -> List[int]:
    """W-bit two's-complement carry-select adder (wraps).

    Blocks of ``block`` bits ripple both carry-in polarities in parallel;
    a mux chain on the block carries selects the real sums. Depth is
    ~(block + W/block + 1) levels instead of the ripple chain's ~W, and no
    LUT reads further than ~(block + W/block) levels back — the bounded
    fan-in reach the banded lut_eval kernel exploits. Cost: ~5 LUTs/bit
    vs ripple's 2.
    """
    W = len(a)
    assert len(c) == W and block >= 1
    # Low block needs no speculation: carry-in is 0.
    out, carry = _ripple_block(b, a[:block], c[:block], CONST0)
    for lo in range(block, W, block):
        hi = min(lo + block, W)
        s0, c0 = _ripple_block(b, a[lo:hi], c[lo:hi], CONST0)
        s1, c1 = _ripple_block(b, a[lo:hi], c[lo:hi], CONST1)
        out.extend(b.mux2(carry, z, o) for z, o in zip(s0, s1))
        carry = b.mux2(carry, c0, c1)
    return out


def _reduce_tree(
    b: NetlistBuilder, buses: List[List[int]], block: int = 4
) -> List[int]:
    """Balanced tree reduction of W-bit buses with carry-select adders:
    O(log2 n) adder layers instead of the ripple chain's O(n). Two's-
    complement wraparound is associative, so any reduction order is
    bit-exact vs the sequential sum."""
    while len(buses) > 1:
        nxt = [
            _carry_select_add(b, buses[i], buses[i + 1], block=block)
            for i in range(0, len(buses) - 1, 2)
        ]
        if len(buses) % 2:
            nxt.append(buses[-1])
        buses = nxt
    return buses[0]


def _const_bus(value_pattern: int, W: int) -> List[int]:
    return [CONST1 if (value_pattern >> k) & 1 else CONST0 for k in range(W)]


def _tc_pattern(v: int, W: int) -> int:
    """Two's complement bit pattern of signed v in W bits."""
    return v & ((1 << W) - 1)


def synth_tree(
    b: NetlistBuilder,
    qt: QuantizedTree,
    feat_bits: Dict[int, List[int]],
    fold_const: int = 0,
) -> Tuple[List[int], int]:
    """Emit one tree; returns (output bit bus, n_thresholds).

    fold_const is added into every leaf value at synth time (used to fold
    the ensemble's f0 into the first tree for free).
    """
    W = qt.spec.width
    # 1. comparators, deduplicated on (feature, threshold)
    cmp_net: Dict[Tuple[int, int], int] = {}
    for i in range(qt.n_nodes):
        f = int(qt.feature[i])
        if f == LEAF:
            continue
        t_raw = int(qt.threshold_raw[i])
        key = (f, t_raw)
        if key in cmp_net:
            continue
        t_u = int(to_unsigned_bits(np.asarray(t_raw), qt.spec))
        cmp_net[key] = b.le_const(feat_bits[f], t_u)

    # 2. leaf one-hots: AND of path conditions with polarity
    leaves: List[Tuple[int, int]] = []  # (onehot net, leaf value pattern)

    def walk(node: int, path: List[Tuple[int, bool]]):
        f = int(qt.feature[node])
        if f == LEAF:
            v = int(qt.value_raw[node]) + fold_const
            onehot = _and_polarity(b, path)
            leaves.append((onehot, _tc_pattern(v, W)))
            return
        c = cmp_net[(f, int(qt.threshold_raw[node]))]
        walk(int(qt.children_left[node]), path + [(c, True)])
        walk(int(qt.children_right[node]), path + [(c, False)])

    walk(0, [])

    # 3. output bits: OR of one-hots whose leaf value has the bit set.
    out_bits: List[int] = []
    for k in range(W):
        ones = [net for net, pat in leaves if (pat >> k) & 1]
        if not ones:
            out_bits.append(CONST0)
        elif len(ones) == len(leaves):
            out_bits.append(CONST1)
        else:
            out_bits.append(b.or_(*ones))
    return out_bits, len(cmp_net)


def synth_ensemble(
    ens: QuantizedEnsemble,
    adder: str = "tree",
    adder_block: int = 4,
) -> SynthResult:
    """Synthesize a quantized ensemble into a combinational LUT4 netlist.

    ``adder`` picks the ensemble summation structure (single trees have no
    adders, so the choice is a no-op there): "tree" = balanced carry-select
    tree reduction (shallow, reach-bounded — the default, what the banded
    lut_eval kernel wants); "ripple" = sequential ripple-carry chain
    (minimal LUTs, deep, reach ~ depth).
    """
    if adder not in ("tree", "ripple"):
        raise ValueError(f"unknown adder strategy {adder!r}")
    spec = ens.spec
    W = spec.width
    used = sorted(
        {int(f) for qt in ens.trees for f in qt.feature[qt.feature != LEAF]}
    )
    b = NetlistBuilder()
    feat_bits: Dict[int, List[int]] = {}
    for f in used:
        feat_bits[f] = b.input_bus(W, name=f"x{f}")

    total_thresholds = 0
    buses: List[List[int]] = []
    for ti, qt in enumerate(ens.trees):
        fold = ens.f0_raw if ti == 0 else 0
        bits, n_thr = synth_tree(b, qt, feat_bits, fold_const=fold)
        total_thresholds += n_thr
        buses.append(bits)

    if adder == "ripple":
        acc = buses[0]
        for bus in buses[1:]:
            acc = _ripple_add(b, acc, bus)
    else:
        acc = _reduce_tree(b, buses, block=adder_block)

    for k, net in enumerate(acc):
        b.mark_output(net, name=f"score[{k}]")
    nl = b.build()
    rep = nl.resource_report()
    rep["thresholds"] = total_thresholds
    rep["used_features"] = len(used)
    return SynthResult(
        netlist=nl,
        spec=spec,
        used_features=used,
        n_thresholds=total_thresholds,
        report=rep,
        adder=adder,
    )


def verify_against_golden(
    result: SynthResult,
    ens: QuantizedEnsemble,
    X_raw: np.ndarray,
    batch: int = 8192,
) -> Dict[str, float]:
    """The paper's §5 experiment: netlist output vs golden quantized model.

    Returns dict with n, n_match, accuracy. The paper reports 100%.
    """
    n = len(X_raw)
    n_match = 0
    for lo in range(0, n, batch):
        xs = X_raw[lo : lo + batch]
        bits = result.encode_inputs(xs)
        outs, _ = result.netlist.evaluate(bits)
        got = result.decode_outputs(outs)
        want = ens.decision_function_raw(xs)
        n_match += int((got == want).sum())
    return {"n": n, "n_match": n_match, "accuracy": n_match / max(n, 1)}
