"""The control of a cell's comparison: the reference put in the
program's place, computed one precision below what the configuration
states (its float32 inputs rounded to bfloat16: the frames before the
featurizer in the served cells, the feature rows in the check),
and driven through a whole run of the cell (``run.run_cell``): the same
traffic, the same window, the same comparison against the reference and
the same limits (``checks/<cell>.json``), so its ``correct`` must come
out false.

    python3 -m readout_bench.control --workload <cell> --seconds <s> \\
        --seeds A B C ...

prints, a seed a line, the run's ``correct`` and its checks. The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from readout_bench import reference  # noqa: E402


class Answer(NamedTuple):
    """A delivered event, as the program's ``ScoredEvent`` gives it."""

    seq: int
    chip: int
    score_raw: int
    keep: bool


class ControlServer:
    """The reference in the place of the program's ``ReadoutServer``:
    ``submit_frames`` scores a block at once (frames rounded to
    ``input_dtype`` first), ``poll`` and ``flush`` deliver it, every
    event under dense egress and the kept events under sparse, and
    ``report`` counts as the program's does."""

    def __init__(self, dep, device=None, input_dtype: str = "bfloat16"):
        self.dep, self.input_dtype = dep, input_dtype
        self.sparse = bool(dep.config["server"]["sparse"])
        self.thr = float(dep.config["threshold_electrons"])
        self._seq = 0
        self._out: List[Answer] = []
        self._n_in = [0] * dep.n_sensors
        self._n_kept = [0] * dep.n_sensors

    def submit_frames(self, chip, frames, y0) -> List[int]:
        feats = reference.featurize(frames, y0, self.thr,
                                    input_dtype=self.input_dtype)
        (score, keep), = reference.answers(
            [self.dep.models[chip]], [self.dep.cuts[chip]], [feats])
        seqs = list(range(self._seq, self._seq + len(frames)))
        self._seq += len(frames)
        self._n_in[chip] += len(frames)
        self._n_kept[chip] += int(keep.sum())
        self._out.extend(Answer(q, chip, int(s), bool(k))
                         for q, s, k in zip(seqs, score, keep)
                         if k or not self.sparse)
        return seqs

    def poll(self) -> List[Answer]:
        out, self._out = self._out, []
        return out

    flush = poll

    def report(self):
        return {"per_chip": [{"n_in": a, "n_kept": b}
                             for a, b in zip(self._n_in, self._n_kept)],
                "stages": {}}


def control_scorer(dep, device=None):
    """The reference in the place of the check's fabric path: each chunk
    of feature rows rounded to bfloat16, then scored."""
    model = dep.models[0]
    return lambda X: model.score(reference.to_bfloat16(X))


CONTROLS = {"stream": ControlServer, "check": control_scorer}


def control_run(workload: str, seed: int, seconds: float, device: str,
                traffic_over=None, config_over=None):
    """One run of the cell with the control in the program's place: the
    result object ``run.run_cell`` gives (``correct``, ``checks``)."""
    from readout_bench import run
    from readout_bench.deploy import load_json

    bench = run.load_benchmark()
    cell = run.find(bench["workloads"], workload, "workload")
    mode = load_json("traffic", cell["traffic"])["mode"]
    return run.run_cell(bench, cell, seed, seconds, False, device,
                        time.perf_counter(), traffic_over=traffic_over,
                        config_over=config_over, program=CONTROLS[mode])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = control_run(args.workload, seed, args.seconds, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
