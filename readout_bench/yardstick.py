"""The chip's published peaks and the least work of the benchmark's
events, counted from the configuration's sizes alone.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside
the tensor cores, and a 32-bit integer/logic rate of a quarter of that
(64 INT32 lanes a SM against 128 FP32 lanes, an FMA counted as two
operations). The same constants as ``chip_smoke.py``'s bounds.

Counts. Every byte an event needs is read once and written once, and
every operation is the least an implementation needs, whatever
implements it; anything a kernel reads again, pads or stages is not
counted, so a share of this least time cannot pass 100% unless a count
is wrong:

* featurizer (K1): the frame (8 x 13 x 21 float32) and y0 in, the 13
  profile sums and y0 out (14 float32); 2,184 float32 adds.
* fabric (K2, B3): the chip's input bus (``n_inputs`` bits) in, its
  ``n_outputs`` output bits and one disagreement bit a replica out.
  Operations as the bit-sliced evaluator counts them, the cheapest known
  (``chip_smoke.k2_cost``): a 4-input LUT is 15 two-way selects, one
  32-lane logic operation each, so 15 / 32 operations a LUT, replica and
  event; under TMR one vote operation and one disagreement operation a
  replica, each a 32nd of an event, an output bit. The tables (2 bytes a
  LUT and replica, once a call) are left out: that only lowers the bound.
* whole window (``*_mfu``): what an event needs from entry to verdict:
  its frame and y0 (served cells) or its used features as float32 (the
  check) in, its verdict out (4-byte score and 1-byte keep; 8 bytes a
  kept event on a sparse link; 4-byte score in the check), and the
  featurizer's adds and the fabric's operations. The least time is the
  larger of the bytes over HBM and the operations over their rates.
"""
from __future__ import annotations

import math
from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT_OPS_PER_S = 67e12 / 4

FRAME_VALUES = 8 * 13 * 21
FRAME_IN_BYTES = 4 * FRAME_VALUES + 4          # frame + y0
FEATURES_OUT_BYTES = 4 * 14
FEATURIZER_ADDS = FRAME_VALUES


def least_s(nbytes: float, fp32_ops: float = 0.0, int_ops: float = 0.0
            ) -> float:
    """The least time of some work: bytes over HBM, or operations over
    their rates, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S,
               fp32_ops / FP32_OPS_PER_S + int_ops / INT_OPS_PER_S)


def k1_least_s(events: float) -> float:
    """The featurizer's least time for ``events`` frames."""
    return least_s(events * (FRAME_IN_BYTES + FEATURES_OUT_BYTES),
                   fp32_ops=events * FEATURIZER_ADDS)


def fabric_ops(chip: Dict, events: float) -> float:
    """Least logic operations of ``events`` through one chip's fabric
    (every replica, the vote and the disagreement words)."""
    r, luts, outs = chip["replicas"], chip["n_luts"], chip["n_outputs"]
    vote = outs * (1 + r) / 32.0 if r > 1 else 0.0
    return events * (15.0 * r * luts / 32.0 + vote)


def fabric_bytes(chip: Dict, events: float) -> float:
    """Least bytes of ``events`` through one chip's fabric: input bus in,
    output bits and a disagreement bit a replica out."""
    r = chip["replicas"]
    bits_in = chip["n_inputs"]
    bits_out = chip["n_outputs"] + (r if r > 1 else 0)
    return events * (math.ceil(bits_in / 8) + math.ceil(bits_out / 8))


def fabric_least_s(chips, events_per_chip) -> float:
    """The fabric's least time for each chip's events."""
    ops = sum(fabric_ops(c, n) for c, n in zip(chips, events_per_chip))
    nbytes = sum(fabric_bytes(c, n) for c, n in zip(chips, events_per_chip))
    return least_s(nbytes, int_ops=ops)


def served_least_s(chips, events_per_chip, kept: float,
                   sparse: bool) -> float:
    """The least time of a served window: every event from frame to
    verdict (``kept`` events on a sparse link)."""
    events = float(sum(events_per_chip))
    out = kept * 8.0 if sparse else events * 5.0
    ops = sum(fabric_ops(c, n) for c, n in zip(chips, events_per_chip))
    return least_s(events * FRAME_IN_BYTES + out,
                   fp32_ops=events * FEATURIZER_ADDS, int_ops=ops)


def check_least_s(chip: Dict, events: float) -> float:
    """The least time of the section 5 check: the used features in as
    float32, the score out, the fabric's operations."""
    nbytes = events * (4.0 * chip["n_used_features"] + 4.0)
    return least_s(nbytes, int_ops=fabric_ops(chip, events))
