"""Run one benchmark cell once and print its result line.

    python3 readout_bench/run.py --workload <cell> --seed <n> \\
        --seconds <window> --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``readout_bench/configs/<name>.json``) and a traffic mix
(``readout_bench/traffic/<name>.json``, whose ``mode`` picks the module
``readout_bench/<mode>.py``). Every metric is read by
``readout_bench/metrics/<metric name>.py`` (or the reader of the name's
stem before its first dot), the limits of the
comparison are ``readout_bench/checks/<cell>.json``: a cell or a metric
is added by adding files, never by editing one.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, from ``torch.profiler`` over the window. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, and with ``--trace 1``
``breakdown``); the numbers compared against the reference, each beside
its limit, end standard error and end the result line (``checks``).

Measures the PyTorch port (``repro_torch``) only, on the CUDA card it is
started on, in the environment ``STEADY_ENV`` sets (it starts itself
again to take it). Exits non-zero with no result where no card is present,
where ``repro_torch`` cannot be imported, or where the JAX package or
JAX itself has been loaded by the time the window has closed.
"""
from __future__ import annotations

import os
import time

# set-up is timed from the process's start: from the first start where
# ``steady_host`` starts the run again in a steady environment
T_START = float(os.environ.pop("READOUT_BENCH_T_START", None)
                or time.perf_counter())

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The environment every run is measured in. The program allocates and
# frees its padded frame staging (71.6 MB) every dispatch: under glibc's
# defaults each is a fresh mapping whose pages fault in again and are
# given back at the free: about a quarter of the process's CPU time in
# the kernel, at a cost that swings with the host. Heap memory kept
# across dispatches, one thread a math library and two cores of their
# own hold the host's share of a run steady.
STEADY_ENV = {
    "MALLOC_MMAP_THRESHOLD_": str(1 << 30),
    "MALLOC_TRIM_THRESHOLD_": str(1 << 32),
    "OMP_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
}
RUN_CPUS = (2, 3)


def pin(cpus) -> None:
    """Keep this process (and the threads it starts from now on) on
    ``cpus``, where the machine has them."""
    if set(cpus) <= os.sched_getaffinity(0):
        os.sched_setaffinity(0, set(cpus))


def steady_host(argv: List[str]) -> None:
    """Start this run again with ``STEADY_ENV`` (glibc reads its
    allocator settings when a process starts), unless it has them."""
    if all(os.environ.get(k) == v for k, v in STEADY_ENV.items()):
        return
    env = dict(os.environ, **STEADY_ENV,
               READOUT_BENCH_T_START=repr(T_START))
    os.execve(sys.executable,
              [sys.executable, os.path.abspath(__file__), *argv], env)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"unknown {what} {name!r}")


def reader_path(name: str) -> str:
    """``metrics/<name>.py``, or where there is none, the reader of the
    name's stem before its first dot (``idle_share.stream`` is read by
    ``metrics/idle_share.py``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    return path


def metric_reader(name: str):
    """The metric's reader's ``read``."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        f"readout_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell, or list no cells."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell in m.get("workloads", [cell])]


def card() -> Dict:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "unavailable"}
    return {"nvidia_smi": out[0] if out else ""}


def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             traffic_over: Optional[Dict] = None,
             config_over: Optional[Dict] = None,
             program=None) -> Dict:
    """One run of one cell (a ``workloads`` entry of ``bench``) on
    ``device``: its result object (with ``checks`` last).
    ``traffic_over`` / ``config_over`` replace keys of the traffic mix
    and the configuration (tests run cells at a size a CPU test can
    hold); ``program`` replaces the system under test in the traffic
    mode's ``run`` (the control)."""
    import torch

    from readout_bench import deploy
    from readout_bench.trace import Tracer, now

    workload = cell["name"]
    config = deploy.load_json("configs", cell["config"])
    config.update(config_over or {})
    traffic = deploy.load_json("traffic", cell["traffic"])
    traffic.update(traffic_over or {})
    limits = deploy.load_json("checks", workload)
    mode = importlib.import_module(f"readout_bench.{traffic['mode']}")

    dep = deploy.build(config)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build

        build.build()
        torch.empty(1, device=device)       # the context and allocator
        torch.cuda.reset_peak_memory_stats(torch.device(device))
    tracer = Tracer(trace)
    gc.collect()

    def timer():
        gc.collect()
        gc.freeze()
        return now() - t_start

    over = {} if program is None else {"program": program}
    out = mode.run(dep, traffic, seconds, tracer, device, seed, timer,
                   **over)
    gc.unfreeze()
    cmp = out["compare"]
    ctx = dict(out)
    ctx.update(cell=workload, mode=traffic["mode"], sizes=dep.sizes(),
               trace=tracer.summary, config=config, traffic=traffic)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {
        "wrong_share": {"value": cmp["wrong"] / max(cmp["compared"], 1),
                        "limit": float(limits["wrong_share"])},
        "lost": {"value": cmp["lost"] + cmp["stray"],
                 "limit": float(limits["lost"])},
    }
    correct = (cmp["compared"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    is_cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": (torch.cuda.get_device_name(torch.device(device)) if is_cuda
                    else "cpu"),
           "count": 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": int(cmp["compared"]),
              "failed": int(cmp["wrong"] + cmp["lost"] + cmp["stray"]),
              "metrics": metrics, "device": dev}
    if trace and tracer.summary is not None:
        dev["busy_s"] = tracer.summary["busy_s"]
        dev["window_s"] = tracer.summary["window_s"]
        result["breakdown"] = tracer.summary["breakdown"]
    result["sizes"] = dep.sizes()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady_host(sys.argv[1:] if argv is None else list(argv))
    pin(RUN_CPUS)
    bench = load_benchmark()
    cell = find(bench["workloads"], args.workload, "workload")

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"need {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here without the program)

    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result["device"]["card"] = card()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
