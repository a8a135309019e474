#!/usr/bin/env python3
"""Served events/s of the PyTorch port's ReadoutServer on one CUDA card,
every configuration in turns, with its spread. Run from the repo root:

    python3 benchmarks/torch_serve_rates.py [--reps 7] [--batches 32]

The 4 chips of chip_smoke.py (examples/serve_readout.py's recipe) serve
``--batches`` FrameStream batches of 256 events per sensor (no hot swap),
through every combination of layout (bit-sliced, matmul), redundancy
(none, TMR), egress (dense, sparse) and ingestion (raw frames through
submit_frames; their host features through submit_batch): 16
configurations. One round runs each once, in an order that alternates
between rounds; a first round warms up and is not kept. A run's rate is
``report()["events_per_s"]`` (first dispatch to last drain); each line
gives the median and quartiles over ``--reps`` rounds, the wire
reduction and the per-stage host seconds of the median run. chip_smoke.py
checks the same paths against the numpy oracle; here each run checks only
that every submitted event was scored.

Every line is JSON; the last names the card and its power limit.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig  # noqa: E402
from repro_torch.kernels.yprofile import ops as yp  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402

CONFIGS = list(itertools.product(("bitsliced", "matmul"), ("none", "tmr"),
                                 (False, True), ("frames", "features")))


def run_once(chips, blocks, feats, layout, red, sparse, ingest, device):
    server = ReadoutServer(list(chips), ServerConfig(
        layout=layout, redundancy=red, sparse=sparse), device=device)
    n = 0
    drained = 0
    for step, per_sensor in enumerate(blocks):
        for s, blk in enumerate(per_sensor):
            if ingest == "frames":
                n += len(server.submit_frames(s, blk["frames"], blk["y0"]))
            else:
                n += len(server.submit_batch(s, feats[step][s]))
            drained += len(server.poll())
    drained += len(server.flush())
    rep = server.report()
    if rep["n_in"] != n or (not sparse and drained != n):
        raise RuntimeError(f"{layout}/{red}/{sparse}/{ingest}: {n} "
                           f"submitted, {rep['n_in']} scored, {drained} "
                           "drained")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--batches", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' rehearses the "
                         "script through the plain twins, no timing claim)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("torch_serve_rates: no CUDA device", file=sys.stderr)
        return 2
    device = args.device or "cuda"
    chips = [cs.train_chip(2024 + i, depth=5 - (i % 2), leaves=10 - (i % 3))
             for i in range(cs.N_CHIPS)]
    stream = FrameStream(FrameStreamConfig(n_sensors=cs.N_CHIPS,
                                           batch=cs.SERVE_EVENTS))
    blocks = [[stream.batch_at(step, s) for s in range(cs.N_CHIPS)]
              for step in range(args.batches)]
    feats = [[yp.yprofile(b["frames"], b["y0"], device=device).cpu().numpy()
              .astype(np.float64) for b in per_sensor]
             for per_sensor in blocks]
    rates = {c: [] for c in CONFIGS}
    reports = {c: [] for c in CONFIGS}
    for r in range(args.reps + 1):
        order = CONFIGS if r % 2 == 0 else CONFIGS[::-1]
        for c in order:
            rep = run_once(chips, blocks, feats, *c, device)
            if r:                                   # round 0 warms up
                rates[c].append(rep["events_per_s"])
                reports[c].append(rep)
    for c in CONFIGS:
        x = np.asarray(rates[c])
        mid = reports[c][int(np.argsort(x)[len(x) // 2])]
        print(json.dumps({
            "layout": c[0], "redundancy": c[1], "sparse": c[2],
            "ingest": c[3], "events": mid["n_in"], "reps": len(x),
            "events_per_s_median": float(np.median(x)),
            "events_per_s_q1": float(np.percentile(x, 25)),
            "events_per_s_q3": float(np.percentile(x, 75)),
            "events_per_s": [float(v) for v in x],
            "fraction_kept": mid["fraction_kept"],
            "wire_reduction": mid["link_bytes"]["wire_reduction"],
            "stages_s": {k: v["seconds"] for k, v in mid["stages"].items()},
        }), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if device != "cpu" else "cpu"
    print(json.dumps({"card": smi, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
