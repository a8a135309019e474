"""The readout server's stage counters and spans (``repro_torch.stages``),
on the CPU.

Two small chips serve a seeded FrameStream (3 steps of 32 events a
sensor, one micro-batch a step) on a clock that steps 1 ms at every
read, so a stage's seconds count the clock reads inside it and a parent
covers its children. Checked: every stage key of the served loop on the
kernel and host backends; ``drain_wait``'s two children are called as
often as it is; ``launch_fused.h2d`` is called once a slab and dispatch;
each parent's seconds cover its children's; the keys that existed before
count one call a dispatch, drain or scrub as they did. Under
``torch.profiler`` the trace holds ``readout.*`` spans nested in
``readout.poll`` (and the check path's five spans); with no profiler
recording no ``record_function`` is entered. ``stack_frames.ring_wait``
(the fill of a staging-ring slot whose earlier copies have not landed)
is absent on the CPU, whose copies are synchronous; on a ring of one
slot whose copies never report landed it counts every fill after the
first, and its span nests in ``readout.stack_frames``.
"""
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch import stages as stages_mod
from repro_torch.core.bdt import GradientBoostedClassifier
from repro_torch.core.readout import KernelBackend, ReadoutChip
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig
from repro_torch.data.smartpixel import SmartPixelConfig, generate
from repro_torch.data.smartpixel import train_test_split
from repro_torch.kernels.frontend import StagingRing
from repro_torch.launch.mesh import ReadoutMesh
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

N_SENSORS, N_EV, N_STEPS = 2, 32, 3
CPU = torch.device("cpu")
# the keys every served frames stream has, on either backend
LOOP_KEYS = {"submit", "poll", "coalesce", "enqueue_d2h", "drain_wait",
             "drain_wait.sync", "drain_wait.fold", "observe"}
# poll's direct children (scrub also runs in flush, outside poll)
POLL_CHILDREN = ("coalesce", "stack_frames", "launch_fused", "sparse_pack",
                 "enqueue_d2h", "drain_wait", "observe", "scrub")


class SteppingClock:
    """1 ms later at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


@functools.lru_cache(maxsize=None)
def _chips():
    tr, _ = train_test_split(generate(SmartPixelConfig(n_events=6_000,
                                                       seed=5)))
    chips = []
    for fabric, depth, leaves in (("efpga_28nm", 4, 8),
                                  ("efpga_130nm", 3, 5)):
        clf = GradientBoostedClassifier(
            n_estimators=1, max_depth=depth, max_leaf_nodes=leaves,
            min_samples_leaf=200).fit(tr["features"], tr["label"])
        chip = ReadoutChip.build(clf, fabric=fabric)
        chip.calibrate(tr["features"], tr["label"], target_sig_eff=0.95)
        chips.append(chip)
    return chips


@functools.lru_cache(maxsize=None)
def _blocks():
    fs = FrameStream(FrameStreamConfig(n_sensors=N_SENSORS, batch=N_EV,
                                       seed=11))
    return [[fs.batch_at(step, s) for s in range(N_SENSORS)]
            for step in range(N_STEPS)]


def _server(backend="kernel", mesh=None, **kw):
    cfg = ServerConfig(backend=backend, max_batch=N_SENSORS * N_EV, **kw)
    return ReadoutServer(_chips(), cfg, clock=SteppingClock(), device="cpu",
                         mesh=mesh)


def _serve(server, flush=False):
    """Submit every sensor's block of a step, then poll, for every step;
    the report's stages (after a flush when asked)."""
    for per in _blocks():
        for s, b in enumerate(per):
            server.submit_frames(s, b["frames"], b["y0"])
        server.poll()
    server.poll()           # retires the last batch: CPU results are ready
    if flush:
        server.flush()
    return server.report()["stages"]


SERVED = {"kernel": {"backend": "kernel"},
          "kernel_tmr_sparse": {"backend": "kernel", "redundancy": "tmr",
                                "sparse": True, "scrub_interval": 1},
          "host": {"backend": "host"},
          "host_tmr_sparse": {"backend": "host", "redundancy": "tmr",
                              "sparse": True, "scrub_interval": 1}}


@pytest.mark.parametrize("case", sorted(SERVED))
def test_every_stage_key_of_the_served_loop(case):
    kw = SERVED[case]
    st = _serve(_server(**kw))
    keys = set(st)
    assert LOOP_KEYS <= keys
    if kw["backend"] == "kernel":
        assert {"stack_frames", "launch_fused", "launch_fused.h2d"} <= keys
    else:
        assert {"staged_featurize", "staged_encode",
                "staged_score"} <= keys
        assert "sparse_pack" in keys or not kw.get("sparse")
    assert ("scrub" in keys) == ("scrub_interval" in kw)
    # the CPU's copies are synchronous: no fill waits on the ring
    assert "stack_frames.ring_wait" not in keys
    # device seconds come from CUDA event pairs only
    assert "dispatch_device" not in keys


@pytest.mark.parametrize("case", sorted(SERVED))
def test_drain_children_are_called_as_often_as_drain_wait(case):
    st = _serve(_server(**SERVED[case]), flush=True)
    n = st["drain_wait"]["calls"]
    assert n == N_STEPS
    assert st["drain_wait.sync"]["calls"] == n
    assert st["drain_wait.fold"]["calls"] == n


@pytest.mark.parametrize("slabs", [1, 2])
def test_h2d_is_called_once_a_slab_and_dispatch(slabs):
    st = _serve(_server(mesh=ReadoutMesh((CPU,) * slabs)), flush=True)
    assert st["launch_fused"]["calls"] == N_STEPS
    assert st["launch_fused.h2d"]["calls"] == N_STEPS * slabs


@pytest.mark.parametrize("case", sorted(SERVED))
def test_each_parent_covers_its_children(case):
    st = _serve(_server(**SERVED[case]))        # poll only: no flush
    sec = {k: v["seconds"] for k, v in st.items()}
    assert sec["poll"] >= sum(sec.get(k, 0.0) for k in POLL_CHILDREN) > 0
    assert sec["drain_wait"] >= sec["drain_wait.sync"] + sec[
        "drain_wait.fold"]
    if "launch_fused" in sec:
        assert sec["launch_fused"] >= sec["launch_fused.h2d"] > 0


@pytest.mark.parametrize("case", sorted(SERVED))
def test_existing_keys_count_a_call_as_before(case):
    """One micro-batch a step: a dispatch, a drain and (scrub every
    dispatch) a scrub step each, and one scrub settle at the flush."""
    kw = SERVED[case]
    st = _serve(_server(**kw), flush=True)
    calls = {k: v["calls"] for k, v in st.items()}
    if kw["backend"] == "kernel":
        assert calls["stack_frames"] == calls["launch_fused"] == N_STEPS
    else:
        for k in ("staged_featurize", "staged_encode"):
            assert calls[k] == N_STEPS * N_SENSORS       # a chip a step
        assert calls["staged_score"] == N_STEPS          # a dispatch
    if kw["backend"] == "host" and kw.get("sparse"):
        assert calls["sparse_pack"] == N_STEPS
    if "scrub_interval" in kw:
        assert calls["scrub"] == N_STEPS + 1
    assert calls["drain_wait"] == N_STEPS
    # new keys: a call a submit_frames, a take plus a grouping a dispatch
    assert calls["submit"] == N_STEPS * N_SENSORS
    assert calls["coalesce"] == 2 * N_STEPS
    assert calls["enqueue_d2h"] == calls["observe"] == N_STEPS


def test_features_path_keeps_its_stages():
    server = _server()
    X = generate(SmartPixelConfig(n_events=2 * N_EV, seed=3))["features"]
    for s in range(N_SENSORS):
        server.submit_batch(s, X[s * N_EV:(s + 1) * N_EV])
    server.flush()
    calls = {k: v["calls"] for k, v in server.report()["stages"].items()}
    assert calls["encode_host"] == calls["launch_score"] == 1
    assert calls["submit"] == N_SENSORS
    assert "launch_fused" not in calls


def _trace(tmp_path, fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X"
            and e["name"].startswith(stages_mod.SPAN_PREFIX)]


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def test_profiler_trace_nests_stage_spans_in_poll(tmp_path):
    server = _server(redundancy="tmr", sparse=True, scrub_interval=1)
    spans = _trace(tmp_path, lambda: _serve(server))
    names = {s[0] for s in spans}
    for key in LOOP_KEYS | {"stack_frames", "launch_fused",
                            "launch_fused.h2d", "scrub"}:
        assert "readout." + key in names, key
    polls = [s for s in spans if s[0] == "readout.poll"]
    for key in POLL_CHILDREN + ("launch_fused.h2d", "drain_wait.sync",
                                "drain_wait.fold"):
        for s in spans:
            if s[0] == "readout." + key:
                assert any(_inside(s, p) for p in polls), s
    launches = [s for s in spans if s[0] == "readout.launch_fused"]
    for s in spans:
        if s[0] == "readout.launch_fused.h2d":
            assert any(_inside(s, p) for p in launches), s
    # spans follow the stages: one a call, never one an event
    assert len(polls) == server.report()["stages"]["poll"]["calls"]


class _NotLanded:
    """A CUDA event whose copies have not landed: a ring slot guarded by
    it waits (a no-op here)."""

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:
        pass


def test_ring_wait_nests_in_stack_frames(tmp_path):
    """A ring of one slot whose copies never report landed: every fill
    after the first waits, inside ``stack_frames``; the other keys keep
    one call a dispatch, and the results are those of the usual ring."""
    server = _server(redundancy="tmr", sparse=True, scrub_interval=1)
    ring = server._path.ring = StagingRing(1, pinned=False)
    take = ring.take

    def take_guarded(*a, **kw):
        rows = take(*a, **kw)
        rows.events.append(_NotLanded())
        return rows

    ring.take = take_guarded
    got = []

    def serve(srv, out):
        for per in _blocks():
            for s, b in enumerate(per):
                srv.submit_frames(s, b["frames"], b["y0"])
            out.extend(srv.poll())
        out.extend(srv.flush())

    spans = _trace(tmp_path, lambda: serve(server, got))
    want = []
    serve(_server(redundancy="tmr", sparse=True, scrub_interval=1), want)
    assert got and set(got) == set(want) and len(got) == len(want)
    calls = {k: v["calls"] for k, v in server.report()["stages"].items()}
    assert calls["stack_frames.ring_wait"] == N_STEPS - 1
    assert calls["stack_frames"] == calls["launch_fused"] == N_STEPS
    assert calls["launch_fused.h2d"] == calls["enqueue_d2h"] == N_STEPS
    waits = [s for s in spans if s[0] == "readout.stack_frames.ring_wait"]
    fills = [s for s in spans if s[0] == "readout.stack_frames"]
    assert len(waits) == N_STEPS - 1 and len(fills) == N_STEPS
    for s in waits:
        assert any(_inside(s, p) for p in fills), s


def test_check_path_spans_under_a_profiler(tmp_path):
    chip = _chips()[0]
    X = generate(SmartPixelConfig(n_events=256, seed=3))["features"]
    backend = KernelBackend(device="cpu")
    want = chip.infer_raw(X, backend=backend)
    got = []
    spans = _trace(tmp_path, lambda: got.append(
        chip.infer_raw(X, backend=backend)))
    assert np.array_equal(got[0], want)
    names = [s[0] for s in spans]
    assert names.count("readout.check.encode") == 1
    assert {"readout.check." + k for k in
            ("encode", "h2d", "eval", "d2h", "decode")} <= set(names)


def test_no_record_function_without_a_profiler(monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    server = _server(redundancy="tmr", sparse=True, scrub_interval=1)
    _serve(server, flush=True)
    chip = _chips()[0]
    X = generate(SmartPixelConfig(n_events=64, seed=3))["features"]
    chip.infer_raw(X, backend=KernelBackend(device="cpu"))
    assert entered == []
    # the same code under a profiler enters it (the patch is seen)
    _trace(tmp_path, lambda: _serve(_server()))
    assert "readout.poll" in entered


def test_recorder_counts_completed_blocks_and_spans_only_without_clock():
    st = stages_mod.Stages(SteppingClock())
    with st.time("a"):
        pass
    with pytest.raises(ValueError):
        with st.time("a"):
            raise ValueError("not counted")
    st.add("dev", 0.25)
    assert st.report() == {"a": {"seconds": pytest.approx(1e-3),
                                 "calls": 1},
                           "dev": {"seconds": 0.25, "calls": 1}}
    with stages_mod.SPANS.time("a"):
        pass
    stages_mod.SPANS.add("dev", 1.0)
    assert stages_mod.SPANS.report() == {}
