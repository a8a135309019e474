"""The ``ens5xl.stream`` cell on the CPU (the program's plain twins, at
the faults test's small size): a sound run is correct and prints its
metrics; each fault of ``test_readout_bench_faults`` (an answer altered
where it is produced, half of a batch left out) makes it incorrect. Its
entries in ``BENCHMARK.json`` report what the cell has to, and its
configuration is served as ``tmr28``'s, on the larger fabric with 5
boosting rounds a chip."""
from __future__ import annotations

import pytest

from readout_bench import deploy, run
from readout_bench.test_readout_bench_faults import (_answer_altered,
                                                     _half_left_out, cpu_run)

CELL = "ens5xl.stream"


def test_sound_run_is_correct():
    r = cpu_run(CELL)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert {"setup_s", "events_per_s"} <= set(r["metrics"])
    # 5 trees a chip on efpga_28nm_xl: far past the small fabric's 448
    assert all(s["n_luts"] > 448 and s["replicas"] == 3 for s in r["sizes"])


def test_traced_run_reads_the_host_stage_metrics():
    r = cpu_run(CELL, trace=True)
    assert r["correct"]
    names = {m["name"] for m in run.metrics_of(run.load_benchmark(), CELL,
                                               True)}
    assert {"host_us_per_event.stream", "events_per_dispatch.stream"} \
        <= set(r["metrics"]) <= names
    # K2's kernel time comes from a trace of the card only
    assert "k2_device_us_per_event.stream" not in r["metrics"]
    assert "k2_walk_roofline.stream" not in r["metrics"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_fault_makes_run_incorrect(monkeypatch, fault):
    {"answer_altered": _answer_altered,
     "half_left_out": _half_left_out}[fault](monkeypatch, CELL)
    r = cpu_run(CELL)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_cell_entries_and_configuration():
    bench = run.load_benchmark()
    cell = run.find(bench["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ens5xl", "stream", 1)
    e2e = {m["name"] for m in run.metrics_of(bench, CELL, False)}
    assert e2e == {"events_per_s", "setup_s"}
    per_layer = {m["name"] for m in run.metrics_of(bench, CELL, True)}
    tmr28 = {m["name"] for m in run.metrics_of(bench, "tmr28.stream", True)}
    # every stream metric of tmr28 but the three-kernel K2 share, which
    # would miss the streamed walk's kernel, and the walk's own share
    assert per_layer == (tmr28 - {"k2_roofline.stream"}) | {
        "k2_walk_roofline.stream"}
    assert deploy.load_json("checks", CELL) == deploy.load_json(
        "checks", "tmr28.stream")
    ens, tmr = (deploy.load_json("configs", n) for n in ("ens5xl", "tmr28"))
    assert ens["fabric"] == "efpga_28nm_xl" and ens["server"] == tmr["server"]
    assert ens["guarantees"] == tmr["guarantees"]
    assert all(c["n_estimators"] == 5 and c["max_depth"] == 5
               and c["max_leaf_nodes"] == 10 for c in ens["chips"])
    assert [c["train_seed"] for c in ens["chips"]] == [
        c["train_seed"] for c in tmr["chips"]]
