"""Whole runs of every cell on the CPU (the harness's look for a card
skipped, ``device="cpu"``, at a size a test can hold): sound, each run
comes out correct and prints its metrics; with the timed path broken
underneath, ``correct`` comes out false, once for each fault a cell can
have: an answer altered where it is produced, and half of a batch left
out. (No cell exchanges between chips or keeps training state, so those
faults have no place here.)"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from readout_bench import run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SMALL_CHIPS = 20_000
TRAFFIC = {
    "stream": {"pool_events_per_sensor": 512, "block_events": 256,
               "warmup_blocks_per_sensor": 1},
    "check": {"pool_events": 4096, "chunk_events": 1024,
              "warmup_chunks": 1},
}
CELLS = ["tmr28.stream", "paper28.check"]


def cpu_run(cell, trace=False, seconds=1.0, seed=2_718_281_828):
    bench = run.load_benchmark()
    w = run.find(bench["workloads"], cell, "workload")
    with open(os.path.join(HERE, "configs", f"{w['config']}.json")) as f:
        cfg = json.load(f)
    chips = [dict(c, events=SMALL_CHIPS) for c in cfg["chips"]]
    return run.run_cell(bench, w, seed, seconds, trace, "cpu",
                        time.perf_counter(), traffic_over=TRAFFIC[
                            w["traffic"]], config_over={"chips": chips})


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = cpu_run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"]
    assert len(r["metrics"]) >= 2


def per_layer_names():
    return {m["name"] for m in run.load_benchmark()["per_layer"]}


def test_traced_run_reads_per_layer_metrics():
    r = cpu_run("tmr28.stream", trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] > 0
    assert {"host_us_per_event.stream", "events_per_dispatch.stream"} \
        <= set(r["metrics"]) <= per_layer_names()


def _answer_altered(monkeypatch, cell):
    from repro_torch.core.readout import KernelBackend
    from repro_torch.kernels.frontend import FusedFrontend

    if cell.endswith(".check"):
        orig = KernelBackend.score_bits

        def score_bits(self, config, bits):
            out = np.array(orig(self, config, bits))
            out[:, 0] ^= 1
            return out

        monkeypatch.setattr(KernelBackend, "score_bits", score_bits)
        return
    dense, sparse = (FusedFrontend.score_frames_voted,
                     FusedFrontend.score_frames_sparse)

    def voted(self, *a, **k):
        score, keep, dis = dense(self, *a, **k)
        return score + 1, keep, dis

    def packed(self, *a, **k):
        count, idx, vals, dis = sparse(self, *a, **k)
        return count, idx, vals + 1, dis

    monkeypatch.setattr(FusedFrontend, "score_frames_voted", voted)
    monkeypatch.setattr(FusedFrontend, "score_frames_sparse", packed)


def _half_left_out(monkeypatch, cell):
    from repro_torch.core.readout import KernelBackend
    from repro_torch.launch.readout_server import ReadoutServer

    if cell.endswith(".check"):
        orig = KernelBackend.score_bits

        def score_bits(self, config, bits):
            out = orig(self, config, bits)
            return out[: len(out) // 2]

        monkeypatch.setattr(KernelBackend, "score_bits", score_bits)
        return
    drain = ReadoutServer._drain_one

    def drain_one(self):
        out = drain(self)
        return out[: len(out) // 2]

    monkeypatch.setattr(ReadoutServer, "_drain_one", drain_one)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_run_incorrect(monkeypatch, cell, fault):
    {"answer_altered": _answer_altered,
     "half_left_out": _half_left_out}[fault](monkeypatch, cell)
    r = cpu_run(cell)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_run_loads_neither_jax_nor_the_jax_package():
    """A whole run in a fresh interpreter, as on the card, loads no
    module named jax, jaxlib, flax or repro."""
    code = (
        "import sys, time, json\n"
        "from readout_bench import run\n"
        "from readout_bench.test_readout_bench_faults import cpu_run\n"
        "r = cpu_run('tmr28.stream', seconds=0.5)\n"
        "print(json.dumps([r['correct'], run.forbidden_modules()]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]
