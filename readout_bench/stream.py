"""Traffic of mode ``stream``: raw frames from every sensor through
``ReadoutServer.submit_frames``, in a closed loop.

Each sensor submits blocks of ``block_events`` frames from its pool (made
at set-up from the seed and cycled), keeps at most
``max_blocks_outstanding`` blocks submitted and not yet delivered, and
the loop calls ``poll()`` after each submission. Delivered means scored
and drained by the server: its per-chip ``n_in`` counter. Warm-up runs
the same loop on the same server until every sensor has submitted
``warmup_blocks_per_sensor`` blocks; the window opens on the running
stream, and every count of the window is a difference of two snapshots
of ``report()``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from readout_bench import reference, smartpixel
from readout_bench.deploy import Deployment, sub_seed
from readout_bench.trace import Tracer, now


def frame_pool(n_sensors: int, n: int, seed: int):
    """(S, n, 8, 13, 21) float32 frames and (S, n) y0 from the seed."""
    frames = np.empty((n_sensors, n, 8, 13, 21), np.float32)
    y0 = np.empty((n_sensors, n), np.float32)
    for s in range(n_sensors):
        d = smartpixel.generate(smartpixel.SmartPixelConfig(
            n_events=n, seed=sub_seed(seed, 2, s)), return_frames=True)
        frames[s] = d["frames"]
        y0[s] = d["features"][:, -1]
    return frames, y0


def snapshot(rep: Dict) -> Dict:
    """The counters of one ``report()`` that the window differences."""
    return {
        "n_in": [pc["n_in"] for pc in rep["per_chip"]],
        "n_kept": [pc["n_kept"] for pc in rep["per_chip"]],
        "stages": {k: dict(v) for k, v in rep["stages"].items()},
    }


def window_counts(a: Dict, b: Dict) -> Dict:
    stages = {}
    for k, v in b["stages"].items():
        u = a["stages"].get(k, {"seconds": 0.0, "calls": 0})
        stages[k] = {"seconds": v["seconds"] - u["seconds"],
                     "calls": v["calls"] - u["calls"]}
    per_chip = [y - x for x, y in zip(a["n_in"], b["n_in"])]
    return {"events_per_chip": per_chip, "events": int(sum(per_chip)),
            "kept": int(sum(b["n_kept"]) - sum(a["n_kept"])),
            "stages": stages}


class _Loop:
    """The closed loop's state: blocks submitted a sensor, the pool
    position of every sequence number, the delivered events."""

    def __init__(self, server, frames, y0, block: int, cap: int,
                 tracer: Tracer):
        self.server, self.frames, self.y0 = server, frames, y0
        self.block, self.cap, self.tracer = block, cap, tracer
        self.S, n = frames.shape[0], frames.shape[1]
        self.n_blocks = n // block
        self.submitted = [0] * self.S
        self.n_in = [0] * self.S
        self.blocks: List = []          # (first seq, sensor, pool offset, n)
        self.got: List[np.ndarray] = []
        self.shed = 0
        self.rep = None

    def take(self, results) -> None:
        if results:
            self.got.append(np.fromiter(
                ((r.seq, r.chip, r.score_raw, r.keep) for r in results),
                reference.EVENT_DTYPE, len(results)))

    def turn(self) -> None:
        span, server = self.tracer.span, self.server
        for s in range(self.S):
            if self.submitted[s] - self.n_in[s] // self.block < self.cap:
                lo = (self.submitted[s] % self.n_blocks) * self.block
                with span("bench.submit_frames"):
                    seqs = server.submit_frames(
                        s, self.frames[s, lo:lo + self.block],
                        self.y0[s, lo:lo + self.block])
                if None not in seqs and seqs[-1] - seqs[0] == len(seqs) - 1:
                    self.blocks.append((seqs[0], s, lo, len(seqs)))
                else:
                    for i, q in enumerate(seqs):
                        if q is None:
                            self.shed += 1
                        else:
                            self.blocks.append((q, s, lo + i, 1))
                self.submitted[s] += 1
            with span("bench.poll"):
                self.take(server.poll())
        with span("bench.report"):
            self.rep = server.report()
        self.n_in = [pc["n_in"] for pc in self.rep["per_chip"]]

    def want(self, deploy_answers):
        """want_chip, want_score, want_keep indexed by sequence number."""
        b = np.asarray(self.blocks, np.int64).reshape(-1, 4)
        n = int((b[:, 0] + b[:, 3]).max()) if len(b) else 0
        chip = np.full(n, -1, np.int64)
        score = np.zeros(n, np.int64)
        keep = np.zeros(n, bool)
        for q0, s, lo, k in b:
            q = slice(q0, q0 + k)
            chip[q] = s
            score[q] = deploy_answers[s][0][lo:lo + k]
            keep[q] = deploy_answers[s][1][lo:lo + k]
        return chip, score, keep


def program_server(dep: Deployment, device):
    """The system under test: the program's ``ReadoutServer``."""
    from repro_torch.launch.readout_server import ReadoutServer

    return ReadoutServer(dep.chips, dep.server_config(), device=device)


def run(dep: Deployment, traffic: Dict, seconds: float, tracer: Tracer,
        device, seed: int, timer, program=program_server) -> Dict:
    """Set up, warm up, measure, then check. ``timer`` is called once
    the window is about to open (set-up ends there). ``program`` makes
    the server the loop drives (``control.ControlServer`` puts the
    reference in its place)."""
    import torch

    S = dep.n_sensors
    n = int(traffic["pool_events_per_sensor"])
    block = int(traffic["block_events"])
    frames, y0 = frame_pool(S, n, seed)
    server = program(dep, device)
    loop = _Loop(server, frames, y0, block,
                 int(traffic["max_blocks_outstanding"]), tracer)
    warm = int(traffic["warmup_blocks_per_sensor"])
    while min(loop.submitted) < warm:
        loop.turn()
    if loop.rep is None:
        loop.turn()
    setup_s = timer()
    tracer.start()
    with tracer.span("bench.window"):
        a = snapshot(loop.rep)
        t0 = now()
        while True:
            loop.turn()
            t1 = now()
            if t1 - t0 >= seconds:
                break
    tracer.stop()
    counts = window_counts(a, snapshot(loop.rep))
    loop.take(server.flush())
    final = server.report()
    peak = (torch.cuda.max_memory_allocated(torch.device(device))
            if torch.device(device).type == "cuda" else 0)
    scored_total = sum(pc["n_in"] for pc in final["per_chip"])
    del server
    loop.server = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the server is gone
    feats = [reference.featurize(frames[s], y0[s],
                                 dep.config["threshold_electrons"])
             for s in range(S)]
    ans = reference.answers(dep.models, dep.cuts, feats)
    chip, score, keep = loop.want(ans)
    got = (np.concatenate(loop.got) if loop.got
           else np.zeros(0, reference.EVENT_DTYPE))
    sparse = bool(dep.config["server"]["sparse"])
    cmp = reference.compare_events(chip, score, keep, got, kept_only=sparse)
    cmp["lost"] += len(chip) - scored_total if sparse else 0
    cmp["lost"] += loop.shed
    return {
        "setup_s": setup_s,
        "window_s": t1 - t0,
        "counts": counts,
        "sparse": sparse,
        "compare": cmp,
        "memory_peak_bytes": int(peak),
    }
