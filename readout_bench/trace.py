"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
whole measured window, reduced to what the per-layer readers take.

* ``busy_s``: the union of the device's activity (kernels, copies,
  memsets) inside the window, so overlapping work counts once;
* ``window_s``: the window, from the ``bench.window`` span the harness
  opens around its loop;
* ``device_s``: device seconds by kernel or copy name;
* ``breakdown``: the ten device operations that took most time, and the
  device's idle time by what the host was doing then: the innermost host
  span (a ``bench.*`` span of the harness, or a torch operation) that
  covers each gap's midpoint.

Spans come from the harness's own files only (``span``): around its
calls into the program. The trace is written as a Chrome trace to a
temporary file under ``TMPDIR``, read back and deleted.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW_SPAN = "bench.window"


class Tracer:
    """Spans and, when enabled, the profiler over the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.summary: Optional[Dict] = None

    def span(self, name: str):
        """A host span around a call into the program (free when the
        trace is off)."""
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False, profile_memory=False)
        self._prof.__enter__()

    def stop(self) -> None:
        """Close the profiler (after the device has finished) and reduce
        its trace."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = reduce_events(events)


_ANON = "(anonymous namespace)::"


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template
    arguments and argument list (copies and memsets keep theirs)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    base = name.replace(_ANON, "").split("(")[0].split("<")[0]
    base = base.split(" ")[-1].split("::")[-1]
    return base or name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _covering(starts, spans, t: float, limit: int = 256) -> Optional[str]:
    """The innermost span covering ``t``: the latest-starting one that
    ends after it (spans of one thread nest)."""
    i = bisect.bisect_right(starts, t) - 1
    steps = 0
    while i >= 0 and steps < limit:
        a, b, name = spans[i]
        if b > t:
            return name
        i -= 1
        steps += 1
    return None


def reduce_events(events: List[Dict]) -> Dict:
    """Chrome-trace events -> busy and window seconds, device seconds by
    name, and the breakdown."""
    window = None
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    bench: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((a, b, short_name(name)))
        elif cat in HOST_CATS:
            if name == WINDOW_SPAN:
                window = (a, b)
            elif name.startswith("bench."):
                bench.append((a, b, name))
            else:
                host.append((a, b, name))
    if window is None:
        return {"busy_s": 0.0, "window_s": 0.0, "device_s": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    w0, w1 = window
    device_s: Dict[str, float] = collections.defaultdict(float)
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            device_s[name] += (b - a) * 1e-6
            clipped.append((a, b))
    busy = _union(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # idle gaps inside the window, named by the host's innermost span
    gaps = []
    t = w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    bench.sort()
    h_starts = [s[0] for s in host]
    b_starts = [s[0] for s in bench]
    idle: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        outer = _covering(b_starts, bench, mid) or WINDOW_SPAN
        inner = _covering(h_starts, host, mid)
        idle[outer if inner is None else f"{outer}/{inner}"] += (b - a) * 1e-6
    top = sorted(device_s.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "device_s": dict(device_s),
        "breakdown": {"device_ops": [[k, v] for k, v in top],
                      "idle_gaps": [[k, v] for k, v in gaps_top]},
    }


def kernel_seconds(summary: Optional[Dict], *names: str) -> float:
    """Device seconds of the kernels whose short name is one of
    ``names``."""
    if not summary:
        return 0.0
    return sum(v for k, v in summary["device_s"].items() if k in names)


def now() -> float:
    return time.perf_counter()
