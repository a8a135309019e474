"""The port's server queue holds runs, not events.

A queue entry is a run of consecutive seqs of one chip and one kind: a
``submit_frames`` or ``submit_batch`` block is queued whole and cut only
where the coalesce ends a micro-batch. Each case holds a block
submission to the same events submitted one at a time (which queues a
run an event): the same ``ScoredEvent``s batch by batch, and the same
report but for ``queue`` and ``stages``. Deadline admission of a block is
held to the per-event admission loop it replaces, on a frozen clock and
a stubbed drain rate: the same shed positions and ``n_shed``.
"""
import collections

import numpy as np
import pytest

pytest.importorskip("jax")

from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from tests._torch_helpers import frames as _frames  # noqa: E402
from tests._torch_helpers import served_features, served_stream  # noqa: E402

BACKENDS = ["kernel", "host"]


def _chips(n=2):
    pairs = served_stream()[0]
    return [pairs[i % 2][1] for i in range(n)]


def _server(backend, n_chips=2, clock=lambda: 0.0, **kw):
    return ReadoutServer(_chips(n_chips),
                         ServerConfig(backend=backend, **kw), clock=clock,
                         device="cpu")


def _record_batches(server):
    """Wrap the server's drain: every drained batch's results, in the
    order the drain returns them."""
    batches, drain = [], server._drain_one

    def drain_one():
        got = drain()
        batches.append([(r.seq, r.chip, r.score_raw, r.keep) for r in got])
        return got

    server._drain_one = drain_one
    return batches


def _serve(server, items, per_event):
    """Submit ``items`` ((kind, chip, arrays)) as blocks or one event at a
    time, polling after each item, then flush. Returns (the seqs each
    submission gave, the drained batches, the report)."""
    batches = _record_batches(server)
    seqs = []
    for kind, chip, arrays in items:
        n = len(arrays[0])
        if kind == "frames" and per_event:
            got = [s for i in range(n) for s in server.submit_frames(
                chip, arrays[0][i:i + 1], arrays[1][i:i + 1])]
        elif kind == "frames":
            got = server.submit_frames(chip, *arrays)
        elif per_event:
            got = [server.submit(chip, row) for row in arrays[0]]
        else:
            got = server.submit_batch(chip, arrays[0])
        seqs.append(got)
        server.poll()
    server.flush()
    return seqs, batches, server.report()


def _same_as_per_event(backend, items, **kw):
    """Serve ``items`` as blocks and as single events on two servers;
    both agree. Returns the block server's (seqs, batches, report)."""
    runs = [_serve(_server(backend, **kw), items, per_event)
            for per_event in (False, True)]
    (seqs, batches, rep), (seqs1, batches1, rep1) = runs
    assert seqs == seqs1 and batches == batches1

    def drop(r):
        return {k: v for k, v in r.items() if k not in ("queue", "stages")}

    np.testing.assert_equal(drop(rep), drop(rep1))
    n = sum(len(a[0]) for _, _, a in items)
    assert rep["queue"]["events"] == rep1["queue"]["events"] == n
    assert rep1["queue"]["runs"] == n
    assert rep["queue"]["runs"] == len(items)
    return seqs, batches, rep


def _frame_items():
    blocks = served_stream()[2]
    return [("frames", s, (blk["frames"], blk["y0"]))
            for per_sensor in blocks for s, blk in enumerate(per_sensor)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_block_serves_as_single_events(backend):
    """The served stream's 64-event blocks against the same events one at
    a time, at ``max_batch`` 48 (runs cut mid-block) and 2,048 (whole)."""
    for max_batch in (48, 2048):
        _, batches, rep = _same_as_per_event(backend, _frame_items(),
                                             max_batch=max_batch)
        assert sorted(q for b in batches for q, *_ in b) == list(
            range(6 * 64))
        assert rep["n_in"] == 6 * 64


@pytest.mark.parametrize("backend", BACKENDS)
def test_interleaved_sensor_blocks_cut_mid_run(backend):
    """Four sensors' 2,048-event blocks interleaved, ``max_batch`` 1,000:
    batches cut runs mid-block; every seq is delivered once, each batch
    in seq order, as the per-event submission delivers them."""
    f, y0 = _frames(2048)
    items = [("frames", c, (f, y0)) for c in range(4)]
    _, batches, rep = _same_as_per_event(backend, items, n_chips=4,
                                         max_batch=1000)
    sizes = [len(b) for b in batches]
    assert sizes[:8] == [1000] * 8 and sum(sizes) == 4 * 2048
    flat = [q for b in batches for q, *_ in b]
    assert sorted(flat) == list(range(4 * 2048))
    for b in batches:
        assert [q for q, *_ in b] == sorted(q for q, *_ in b)
    # one dispatch a poll: the third batch is chip 0's last 48 events and
    # chip 1's first 952
    third = collections.Counter(c for _, c, *_ in batches[2])
    assert third == {0: 48, 1: 952}
    assert [pc["n_dispatches"] for pc in rep["per_chip"]] == [3, 3, 3, 3]


@pytest.mark.parametrize("backend", BACKENDS)
def test_frames_and_features_mix_in_one_coalesce(backend):
    """A frames block, a features block cut by the batch's end and single
    features events, coalesced together: two passes a batch, the same
    events as the per-event submission."""
    blocks, feats = served_stream()[2], served_features()
    items = [("frames", 0, (blocks[0][0]["frames"], blocks[0][0]["y0"])),
             ("features", 1, (feats[0][1],)),
             ("features", 0, (feats[1][0][:3],))]
    _, batches, rep = _same_as_per_event(backend, items, max_batch=100)
    # batch 1: 64 frames of chip 0 and 36 feature rows of chip 1, as two
    # passes; the flush scores the other 28 rows and the 3 single events
    assert [len(b) for b in batches] == [64, 36, 31]
    assert [q for q, *_ in batches[0]] == list(range(64))
    assert [q for q, *_ in batches[1]] == list(range(64, 100))
    assert rep["stages"]["encode_host"]["calls"] == 2
    assert [pc["n_dispatches"] for pc in rep["per_chip"]] == [2, 2]


@pytest.mark.parametrize("backend", BACKENDS)
def test_cancel_queued_over_a_partly_taken_run(backend):
    """Chip 0's run cut at the coalesce: ``cancel_queued(0)`` drops the
    rest of it and counts its events; chip 1's run is untouched."""
    blocks = served_stream()[2]
    server = _server(backend, max_batch=48)
    for s in (0, 1):
        server.submit_frames(s, blocks[0][s]["frames"], blocks[0][s]["y0"])
    assert server.queue_depth == 128
    got = server.poll()
    assert server.queue_depth == 80
    assert server.cancel_queued(0) == 16
    assert server.queue_depth == 64 and server.cancel_queued(0) == 0
    got += server.flush()
    assert sorted(r.seq for r in got) == list(range(48)) + list(
        range(64, 128))
    rep = server.report()
    assert [pc["n_in"] for pc in rep["per_chip"]] == [48, 64]
    assert rep["queue"] == {"runs": 2, "events": 128}


def test_queue_depth_counts_events():
    feats = served_features()
    server = _server("host", max_batch=50)
    assert server.queue_depth == 0
    server.submit_batch(0, feats[0][0])
    server.submit(1, feats[0][1][0])
    assert server.queue_depth == 65 and server.report()["queue_depth"] == 65
    server.poll()
    assert server.queue_depth == 15
    server.flush()
    assert server.queue_depth == 0


def test_queue_report_counts_runs_and_events():
    """events / runs is the events a queue entry carries: a block is one
    run, a ``submit`` one run, an empty or wholly shed block none."""
    feats = served_features()
    blocks = served_stream()[2]
    server = _server("host")
    server.submit_frames(0, blocks[0][0]["frames"], blocks[0][0]["y0"])
    assert server.report()["queue"] == {"runs": 1, "events": 64}
    server.submit_batch(1, feats[0][1])
    for row in feats[0][0][:3]:
        server.submit(0, row)
    server.submit_batch(1, feats[0][1][:0])
    assert server.report()["queue"] == {"runs": 5, "events": 131}
    server.flush()
    assert server.report()["queue"] == {"runs": 5, "events": 131}


class _FrozenClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _per_event_admission(q0, head_t, inflight, now, rate, ewma, dl, n):
    """The per-event admission loop (one ``_admit`` an event, the queue
    growing by each admitted event): [admitted?] per event."""
    out, q = [], q0
    for _ in range(n):
        if not q and not inflight:
            ok = True
        else:
            wait = (now - head_t) if q else 0.0
            backlog = (q / rate) if rate > 0.0 else 0.0
            ok = max(wait, backlog) + ewma < dl
        if ok:
            head_t = head_t if q else now
            q += 1
        out.append(ok)
    return out


# (queued before, head age s, a batch in flight, drain rate events/s,
# EWMA service s, block events, events the loop admits); deadline 5 ms
_STATES = [
    (0, 0.0, False, 0.0, 0.0, 64, 64),
    (0, 0.0, False, 0.0, 0.006, 64, 1),     # idle: only the first
    (0, 0.0, True, 0.0, 0.006, 64, 0),      # in flight: none
    (100, 0.001, True, 1e6, 0.001, 8192, 3900),     # cut by the backlog
    (100, 0.001, False, 3e5, 0.002, 2048, 800),
    (0, 0.0, False, 1e6, 0.001, 8192, 4000),
    (0, 0.0, True, 1e6, 0.001, 8192, 4000),
    (50, 0.0049, True, 1e6, 0.0, 64, 64),   # the head's wait admits
    (50, 0.005, True, 1e6, 0.0, 64, 0),     # ... and sheds all
    (4000, 0.0, True, 1e6, 0.001, 64, 0),   # the backlog full before
    (3999, 0.0, True, 1e6, 0.001, 64, 1),
    (2, 0.002, True, 1234.5678, 0.0001, 3000, 5),
]


@pytest.mark.parametrize("policy", ["shed", "degrade", "observe"])
@pytest.mark.parametrize("state", _STATES)
@pytest.mark.parametrize("kind", ["features", "frames"])
def test_block_admission_equals_the_per_event_loop(policy, state, kind):
    """One admission decision a block: the same None positions and
    ``n_shed`` as the per-event loop on the same state; under
    ``observe`` every event is admitted."""
    q0, age, inflight, rate, ewma, n, admitted = state
    dl = 0.005
    clock = _FrozenClock()
    kw = (dict(deadline_us=dl * 1e6, overload_policy=policy)
          if policy != "observe" else {})
    server = _server("host", clock=clock, max_batch=1 << 20,
                     max_latency_s=1e9, **kw)
    X = np.zeros((max(q0, 1), 14))
    if q0:
        assert None not in server.submit_batch(1, X[:q0])
    clock.t = age
    server._service_ewma_s = ewma
    server._drain_rate = lambda: rate
    if inflight:
        server._inflight.append(object())
    if kind == "frames":
        f = np.zeros((n, 8, 13, 21), np.float32)
        seqs = server.submit_frames(0, f, np.zeros(n, np.float32))
    else:
        seqs = server.submit_batch(0, np.zeros((n, 14)))
    want = ([True] * n if policy == "observe" else _per_event_admission(
        q0, 0.0, inflight, age, rate, ewma, dl, n))
    assert [s is not None for s in seqs] == want
    m = sum(want)
    assert m == (n if policy == "observe" else admitted)
    assert seqs[:m] == list(range(q0, q0 + m))
    assert all(isinstance(s, int) for s in seqs[:m])
    assert server.report()["per_chip"][0]["n_shed"] == n - m
    assert server.queue_depth == q0 + m
