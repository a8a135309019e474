#!/usr/bin/env python3
"""Where the host time of the port's network front door goes, on one CUDA
card. Run from the repo root:

    python3 benchmarks/torch_net_profile.py [--reps 3] [--top 25]

chip_smoke.py phase 11's unpaced TCP run (the 4 served chips,
``ServerConfig()`` plain, one replay client a sensor, 32 batches of 64
events each: 8,192 events) in three forms, in turns, ``--reps`` rounds:

* ``inprocess`` — the same events through ``submit_frames`` in-process
  (the burst rate, chip_smoke.net_inprocess);
* ``wire`` — through the front door on loopback, every trigger verified
  (chip_smoke.net_wire);
* ``wire_stub`` — through the front door over a server that scores
  nothing (each event answered at once, score 0, kept): the protocol,
  socket and event-loop toll alone. Its triggers are not verified.
  ``wire_stub_inline`` is the same with ``offload_decode=False`` (CRC and
  payload decode on the event loop's thread, not on the worker).

Then one ``wire`` run under cProfile: the ``--top`` functions by own
time in the main thread (the decode worker is not profiled), set-up and
verification included. cProfile adds a cost to every Python call, so
read its shares, not its seconds. Every line is JSON; the last names the
card and its power limit.
"""
import argparse
import asyncio
import cProfile
import json
import os
import pstats
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.lut_eval import bitsliced as bs  # noqa: E402
from repro_torch.kernels.sparse_pack import sparse_pack as sp  # noqa: E402
from repro_torch.kernels.yprofile import ops as yp  # noqa: E402
from repro_torch.launch.readout_server import ScoredEvent  # noqa: E402
from repro_torch.net.ingress import FrontDoorConfig, ReadoutFrontDoor  # noqa: E402
from repro_torch.net.replay import ReplayConfig, replay  # noqa: E402


class StubServer:
    """What the front door needs of a server, scoring nothing: every
    submitted event is answered at the next poll (score 0, kept)."""

    config = types.SimpleNamespace(sparse=False)
    n_chips = cs.N_CHIPS

    def __init__(self):
        self._seq = 0
        self._ready = []

    def attach_net_stats(self, provider):
        pass

    def submit_frames(self, chip, frames, y0):
        seqs = list(range(self._seq, self._seq + len(frames)))
        self._seq += len(frames)
        self._ready += [ScoredEvent(q, chip, 0, True) for q in seqs]
        return seqs

    def poll(self):
        out, self._ready = self._ready, []
        return out

    flush = poll


def wire_stub(sources, offload=True):
    """Events/s of the unpaced TCP run through a door over StubServer:
    every client's events over the longest client's span."""
    door = ReadoutFrontDoor(StubServer(),
                            FrontDoorConfig(offload_decode=offload))
    cfgs = [ReplayConfig(n_batches=cs.NET_BATCHES,
                         events_per_batch=cs.NET_EVENTS, sensor=s, seed=s,
                         timeout_s=cs.NET_TIMEOUT_S, pre_encode=True)
            for s in range(cs.N_CHIPS)]

    async def go():
        await door.start()
        try:
            return await asyncio.gather(*(
                replay("127.0.0.1", door.tcp_port,
                       sources[s](cs.NET_EVENTS), cfgs[s])
                for s in range(cs.N_CHIPS)))
        finally:
            await door.stop()

    reps = asyncio.run(go())
    if any(r.unanswered or r.n_admitted != r.n_events for r in reps):
        raise RuntimeError("stub run: a batch went unanswered")
    n = sum(r.n_events for r in reps)
    return n / max(r.n_events / r.achieved_ev_s for r in reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_net_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    build.build()
    chips = [cs.train_chip(2024 + i, depth=5 - (i % 2), leaves=10 - (i % 3))
             for i in range(cs.N_CHIPS)]
    stream = FrameStream(FrameStreamConfig(n_sensors=cs.N_CHIPS,
                                           batch=cs.SERVE_EVENTS))
    blocks = [[stream.batch_at(t, s) for s in range(cs.N_CHIPS)]
              for t in range(cs.SERVE_BATCHES)]
    sources = cs.net_sources(np, blocks)
    oracles = cs.net_oracles(np, chips, sources)
    counters = {"yprofile": yp.yprofile_traced,
                "eval_words_voted": bs.eval_seg_voted,
                "decode_dense": sp.decode_dense}

    def wire():
        return cs.net_wire(torch, chips, "none", sources, oracles, counters,
                           "tcp", 0.0)["wire_ev_s"]

    runs = {"inprocess": lambda: cs.net_inprocess(torch, chips, "none",
                                                  sources),
            "wire": wire, "wire_stub": lambda: wire_stub(sources),
            "wire_stub_inline": lambda: wire_stub(sources, offload=False)}
    rates = {k: [] for k in runs}
    for rep in range(args.reps):
        for name in (list(runs) if rep % 2 == 0 else list(runs)[::-1]):
            rates[name].append(runs[name]())
    print(json.dumps({"rates_ev_s": rates, "median_ev_s": {
        k: float(np.median(v)) for k, v in rates.items()},
        "us_per_event": {k: 1e6 / float(np.median(v))
                         for k, v in rates.items()}}), flush=True)

    prof = cProfile.Profile()
    prof.enable()
    profiled = wire()
    prof.disable()
    stats = pstats.Stats(prof)
    total = sum(v[2] for v in stats.stats.values())
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])
    top = [{"fn": f"{os.path.relpath(path, HERE)}:{line}:{name}"
                  if path.startswith(HERE) else f"{path}:{line}:{name}",
            "calls": v[1], "own_s": v[2], "own_share": v[2] / total,
            "cum_s": v[3]}
           for (path, line, name), v in rows[:args.top]]
    print(json.dumps({"profiled_wire_ev_s": profiled, "total_s": total,
                      "top": top}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
