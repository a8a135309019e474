"""The benchmark's definition: ``BENCHMARK.json`` against its contract (names, units, keys,
bounds, which cells report which metric), every file it names present,
and no module of the harness importing JAX or the JAX package
(``repro``; top-level names compared whole), nor the reference and the
yardstick anything of the program."""
from __future__ import annotations

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    from readout_bench import run

    return run.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["readout_bench"]
    assert bench["command"] == ["python3", "readout_bench/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) \
            and _line(c["source"])
        assert c["file"].startswith("readout_bench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(cells)
    metrics = []
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.append(m)
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        metrics.append(m)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_what_it_must(bench):
    e2e = bench["end_to_end"]
    for w in bench["workloads"]:
        cell = w["name"]
        got = [m["name"] for m in e2e if _reports(m, cell)]
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(_reports(m, cell) for m in bench["per_layer"]), cell


def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert "workloads" in m
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_found_by_name(bench):
    for w in bench["workloads"]:
        for kind, name in (("configs", w["config"]),
                           ("traffic", w["traffic"]),
                           ("checks", w["name"])):
            assert os.path.isfile(os.path.join(HERE, kind, f"{name}.json"))
        with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
            mode = json.load(f)["mode"]
        assert os.path.isfile(os.path.join(HERE, f"{mode}.py"))
    from readout_bench.run import reader_path

    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(reader_path(m["name"])), m["name"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return {m.split(".")[0] for m in out if m}


def _sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    bad = {p: _imports(p) & {"jax", "jaxlib", "flax", "repro"}
           for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


@pytest.mark.parametrize("name", ["reference", "bdt_fit", "smartpixel",
                                  "yardstick"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in _imports(os.path.join(HERE, f"{name}.py"))
