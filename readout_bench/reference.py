"""Plain NumPy reference of the readout chain, and the comparison that
decides ``correct``.

It works every answer out again from the benchmark's own inputs (frames,
features) and its own fitted trees and trigger cut; it takes nothing the
program derived (no netlist, placement, bitstream, packed tables or
encode plan) and imports nothing of the program:

    frames (n, 8, 13, 21) float32 + y0
      -> y-profile: each y bin summed over t and x in float64, rounded
         once to float32, max(p, 0), zero-suppressed at the electron
         threshold, divided by 1000 in float32 (ke); y0 as float32
    features (n, 14) float32
      -> ap_fixed<W, I>: floor(x * 2**F) on the int64 grid, wrapped
      -> each tree walked on the grid (left iff x <= threshold), leaf
         values and f0 on the grid with the learning rate folded in
      -> score (int64) and keep = score <= cut

The float stage is the only one with rounding: the program sums a bin's
168 charges in float32 in an order of its own, so a feature that lies
within a few float32 ulps of an ap_fixed step can land on the
neighbouring grid point, and an event whose walk compares that feature
against a threshold on that very step can take the other branch. Those
events are counted, not excused: the share of wrong answers is held to a
limit set from measured readings (``checks/<cell>.json``).

``featurize(..., input_dtype="bfloat16")`` is the control: the same
reference with its frames rounded to bfloat16 first, the step below the
float32 the configuration states.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

N_T, N_Y, N_X = 8, 13, 21
_BLOCK = 4096   # events a float64 block of the featurizer
# a delivered event, as the comparison takes it
EVENT_DTYPE = np.dtype([("seq", np.int64), ("chip", np.int64),
                        ("score", np.int64), ("keep", np.bool_)])


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
    return (r & np.uint32(0xFFFF0000)).view(np.float32)


def featurize(frames: np.ndarray, y0: np.ndarray,
              threshold_electrons: float = 800.0,
              input_dtype: str = "float32") -> np.ndarray:
    """(n, 8, 13, 21) charge frames + (n,) y0 -> (n, 14) float32."""
    n = len(frames)
    out = np.empty((n, N_Y + 1), np.float32)
    thr = np.float32(threshold_electrons)
    for lo in range(0, n, _BLOCK):
        f = np.asarray(frames[lo:lo + _BLOCK], np.float32)
        if input_dtype == "bfloat16":
            f = to_bfloat16(f)
        elif input_dtype != "float32":
            raise ValueError(f"unknown input dtype {input_dtype!r}")
        p = f.astype(np.float64).sum(axis=(1, 3)).astype(np.float32)
        p = np.maximum(p, np.float32(0.0))
        p = np.where(p > thr, p, np.float32(0.0))
        out[lo:lo + _BLOCK, :N_Y] = p / np.float32(1000.0)
    out[:, N_Y] = np.asarray(y0, np.float32)
    return out


def quantize_raw(x, width: int, int_bits: int) -> np.ndarray:
    """float -> int64 on the ap_fixed<width, int_bits> grid: truncation
    toward minus infinity, two's-complement wrap."""
    scaled = np.asarray(x, np.float64) * float(2 ** (width - int_bits))
    raw = np.floor(scaled).astype(np.int64)
    half = np.int64(1) << np.int64(width - 1)
    return ((raw + half) % (half * 2)) - half


@dataclasses.dataclass
class Model:
    """One chip's classifier on the fixed grid: the fitted trees
    (``bdt_fit.Tree``), f0, the learning rate and the grid."""

    trees: Sequence
    f0: float
    learning_rate: float
    width: int
    int_bits: int

    def __post_init__(self):
        w, i = self.width, self.int_bits
        scale = float(2 ** (w - i))
        self._thr = [quantize_raw(t.threshold, w, i) for t in self.trees]
        self._val = [quantize_raw(quantize_raw(t.value, w, i) / scale
                                  * self.learning_rate, w, i)
                     for t in self.trees]
        self._f0 = int(quantize_raw(np.asarray(self.f0), w, i))

    def used_features(self) -> List[int]:
        return sorted({int(f) for t in self.trees for f in t.feature
                       if f >= 0})

    def score(self, features: np.ndarray) -> np.ndarray:
        """(n, 14) features -> (n,) int64 raw scores."""
        x = quantize_raw(features, self.width, self.int_bits)
        n = len(x)
        acc = np.full(n, self._f0, np.int64)
        rows = np.arange(n)
        for t, thr, val in zip(self.trees, self._thr, self._val):
            node = np.zeros(n, np.int64)
            leaf = t.feature[node] < 0
            while not leaf.all():
                f = np.maximum(t.feature[node], 0)
                left = x[rows, f] <= thr[node]
                nxt = np.where(left, t.children_left[node],
                               t.children_right[node])
                node = np.where(leaf, node, nxt)
                leaf = t.feature[node] < 0
            acc += val[node]
        return acc


def calibrate(model: Model, features: np.ndarray, is_pileup: np.ndarray,
              target_sig_eff: float) -> int:
    """The trigger cut: the score at which the signal efficiency on these
    tracks comes closest to the target (the paper's operating point)."""
    from readout_bench.bdt_fit import operating_point_at_signal_eff

    raw = model.score(features).astype(np.float64)
    thr, _, _ = operating_point_at_signal_eff(raw, is_pileup, target_sig_eff)
    return int(thr)


def answers(models: Sequence[Model], cuts: Sequence[int],
            features_by_sensor: Sequence[np.ndarray]):
    """Per sensor: (score (n,), keep (n,)) of each feature row."""
    out = []
    for m, cut, f in zip(models, cuts, features_by_sensor):
        s = m.score(f)
        out.append((s, s <= cut))
    return out


# ------------------------------------------------------------ comparison
def compare_events(want_chip: np.ndarray, want_score: np.ndarray,
                   want_keep: np.ndarray, got: np.ndarray,
                   kept_only: bool) -> Dict[str, int]:
    """Hold delivered events to the reference's answers.

    ``want_*`` are indexed by the server's sequence number: every event
    submitted has one. ``got`` is a structured array of delivered events
    (seq, chip, score, keep); with ``kept_only`` (sparse egress) only the
    events the program kept are delivered, and the kept set itself is
    compared. Returns counts: ``compared`` (events answered for),
    ``wrong`` (a delivered answer, chip or keep that differs, or, sparse,
    an event kept on one side only), ``lost`` (submitted, never
    delivered; dense only), ``stray`` (a sequence number never submitted,
    or delivered twice)."""
    n = len(want_chip)
    seq = got["seq"].astype(np.int64)
    ok_range = (seq >= 0) & (seq < n)
    stray = int((~ok_range).sum())
    seq_in = seq[ok_range]
    counts = np.bincount(seq_in, minlength=n)
    stray += int(np.maximum(counts - 1, 0).sum())
    first = np.zeros(len(seq), bool)
    _, idx = np.unique(seq, return_index=True)
    first[idx] = True
    g = got[first & ok_range]
    s = g["seq"].astype(np.int64)
    bad = ((g["chip"] != want_chip[s]) | (g["score"] != want_score[s])
           | (g["keep"] != want_keep[s]))
    if kept_only:
        bad |= ~want_keep[s]
        missing_kept = int((want_keep & (counts == 0)).sum())
        return {"compared": n, "wrong": int(bad.sum()) + missing_kept,
                "lost": 0, "stray": stray}
    lost = int((counts == 0).sum())
    return {"compared": n, "wrong": int(bad.sum()), "lost": lost,
            "stray": stray}
