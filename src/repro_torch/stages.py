"""Stage timing for the readout paths: a stage is a counter, and a span
when a profiler records.

``Stages(clock)`` adds each stage's seconds (on ``clock``) and calls
under its key; ``ReadoutServer.report()["stages"]`` reads them. While a
``torch.profiler`` records, a stage also opens
``torch.profiler.record_function("readout.<key>")`` around the same code,
so the span lands in the profiler's trace beside the device's kernels and
copies, on the same clock. With no profiler recording a stage makes no
torch call: two clock reads, two dict updates and one flag read.

``SPANS`` is the recorder without a clock: spans only, no counters (the
section 5 check path, and a fused frontend called outside a server).

Stages are per call or per dispatch, never per event. A key with a dot
is a child of the stage before the dot (``drain_wait.sync`` runs inside
``drain_wait``).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "readout."


class _Timed:
    """One pass through a stage (``Stages.time``)."""

    __slots__ = ("_stages", "_key", "_t0", "_span")

    def __init__(self, stages: "Stages", key: str):
        self._stages = stages
        self._key = key
        self._span = None

    def __enter__(self) -> "_Timed":
        if _autograd_profiler._is_profiler_enabled:     # a profiler records
            self._span = torch.profiler.record_function(
                SPAN_PREFIX + self._key)
            self._span.__enter__()
        clock = self._stages._clock
        if clock is not None:
            self._t0 = clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        st = self._stages
        if st._clock is not None and exc_type is None:
            st.seconds[self._key] += st._clock() - self._t0
            st.calls[self._key] += 1
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
        return False


class Stages:
    """Seconds and calls a stage key, on an injected clock (None: spans
    only, nothing counted)."""

    def __init__(self, clock: Optional[Callable[[], float]]):
        self._clock = clock
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)

    def time(self, key: str) -> _Timed:
        """``with stages.time(key):`` counts the block's seconds and one
        call under ``key`` (not when it raises), inside a
        ``readout.<key>`` span while a profiler records."""
        return _Timed(self, key)

    def add(self, key: str, seconds: float) -> None:
        """One call of ``seconds`` measured elsewhere (device seconds
        from a CUDA event pair)."""
        if self._clock is not None:
            self.seconds[key] += seconds
            self.calls[key] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        """{key: {"seconds", "calls"}}, keys sorted."""
        return {k: {"seconds": self.seconds[k], "calls": self.calls[k]}
                for k in sorted(self.seconds)}


SPANS = Stages(None)
