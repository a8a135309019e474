"""Traffic of mode ``check``: the section 5 fabric-vs-golden check as a
batch job.

The fabric half of ``ReadoutChip.verify_vs_golden``:
``chip.infer_raw(X, backend=KernelBackend())`` (the selection-matmul
layout, banded where the chip's fan-in reach makes that cheaper, as the
check runs by default) over ``chunk_events``-event chunks of feature
rows, back to back, from a pool of ``pool_events`` tracks made from the
seed and cycled. Every chunk's scores are held to the reference's once
the window has closed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from readout_bench import smartpixel
from readout_bench.deploy import Deployment, sub_seed
from readout_bench.trace import Tracer, now


def program_scorer(dep: Deployment, device):
    """The system under test: the fabric half of the program's check,
    feature rows to raw scores on the kernel backend."""
    from repro_torch.core.readout import KernelBackend

    chip, backend = dep.chips[0], KernelBackend(device=device)
    return lambda X: chip.infer_raw(X, backend=backend)


def run(dep: Deployment, traffic: Dict, seconds: float, tracer: Tracer,
        device, seed: int, timer, program=program_scorer) -> Dict:
    """As ``stream.run``; ``program`` makes the scorer of a chunk."""
    import torch

    model = dep.models[0]
    n = int(traffic["pool_events"])
    chunk = int(traffic["chunk_events"])
    n_chunks = n // chunk
    X = smartpixel.generate(smartpixel.SmartPixelConfig(
        n_events=n, seed=sub_seed(seed, 3)))["features"]
    score = program(dep, device)
    got = []
    for c in range(int(traffic["warmup_chunks"])):
        lo = (c % n_chunks) * chunk
        got.append((lo, score(X[lo:lo + chunk])))
    setup_s = timer()
    tracer.start()
    events = 0
    i = 0
    with tracer.span("bench.window"):
        t0 = now()
        while True:
            lo = (i % n_chunks) * chunk
            with tracer.span("bench.infer_raw"):
                got.append((lo, score(X[lo:lo + chunk])))
            events += chunk
            i += 1
            t1 = now()
            if t1 - t0 >= seconds:
                break
    tracer.stop()
    peak = (torch.cuda.max_memory_allocated(torch.device(device))
            if torch.device(device).type == "cuda" else 0)
    del score
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    want = model.score(X)
    wrong = compared = lost = 0
    for lo, scores in got:
        scores = np.asarray(scores)
        if scores.shape != (chunk,):
            lost += chunk
            continue
        compared += chunk
        wrong += int((scores.astype(np.int64) != want[lo:lo + chunk]).sum())
    return {
        "setup_s": setup_s,
        "window_s": t1 - t0,
        "counts": {"events": events, "events_per_chip": [events],
                   "kept": 0, "stages": {}},
        "sparse": False,
        "compare": {"compared": compared, "wrong": wrong, "lost": lost,
                    "stray": 0},
        "memory_peak_bytes": int(peak),
    }
