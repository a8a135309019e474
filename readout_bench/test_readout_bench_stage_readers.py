"""The readers of the server's stage metrics on synthetic window counts:
each one's value from ``ctx["counts"]["stages"]``, and None where its
stage is absent (a program without that stage) or no event was
delivered."""
from __future__ import annotations

import pytest

from readout_bench.run import metric_reader

EVENTS = 4_000


def _stages(**seconds):
    return {k.replace("__", "."): {"seconds": v, "calls": 2}
            for k, v in seconds.items()}


FULL = _stages(submit=0.004, poll=0.080, coalesce=0.002, stack_frames=0.010,
               launch_fused=0.030, launch_fused__h2d=0.020, sparse_pack=0.0,
               enqueue_d2h=0.001, drain_wait=0.016, drain_wait__sync=0.006,
               drain_wait__fold=0.009, observe=0.003, scrub=0.002,
               dispatch_device=0.040)

# metric -> its value in us/event on FULL
WANT = {
    "submit_us_per_event.stream": 0.004,
    "coalesce_us_per_event.stream": 0.002,
    "h2d_us_per_event.stream": 0.020,
    "enqueue_us_per_event.stream": 0.001,
    "drain_sync_us_per_event.stream": 0.006,
    "drain_fold_us_per_event.stream": 0.009 + 0.003,
    "unstaged_us_per_event.stream":
        0.080 - (0.002 + 0.010 + 0.030 + 0.0 + 0.001 + 0.016 + 0.003
                 + 0.002),
    "dispatch_device_us_per_event.stream": 0.040,
}
# the stage a metric cannot do without
NEEDS = {
    "submit_us_per_event.stream": "submit",
    "coalesce_us_per_event.stream": "coalesce",
    "h2d_us_per_event.stream": "launch_fused.h2d",
    "enqueue_us_per_event.stream": "enqueue_d2h",
    "drain_sync_us_per_event.stream": "drain_wait.sync",
    "drain_fold_us_per_event.stream": "drain_wait.fold",
    "unstaged_us_per_event.stream": "poll",
    "dispatch_device_us_per_event.stream": "dispatch_device",
}


def _ctx(stages, events=EVENTS):
    return {"counts": {"events": events, "stages": stages}}


@pytest.mark.parametrize("name", sorted(WANT))
def test_stage_reader_value(name):
    got = metric_reader(name)(_ctx(FULL))
    assert got == pytest.approx(WANT[name] / EVENTS * 1e6)


@pytest.mark.parametrize("name", sorted(WANT))
def test_stage_reader_is_none_without_its_stage(name):
    read = metric_reader(name)
    stages = {k: v for k, v in FULL.items() if k != NEEDS[name]}
    assert read(_ctx(stages)) is None
    # the parent's stages (before the server had these keys)
    old = {k: FULL[k] for k in ("stack_frames", "launch_fused",
                                "drain_wait", "scrub")}
    assert read(_ctx(old)) is None
    assert read(_ctx(FULL, events=0)) is None
