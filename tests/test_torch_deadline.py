"""The port's deadline admission, adaptive batch and degrade ladder
against the JAX package's, on the CPU.

Two small chips, trained by both packages as the JAX package's
tests/test_deadline.py trains its pair, serve one seeded schedule of
submissions in both servers, each with its own injected FakeClock driven
by the same steps. Device time is emulated on that clock: each drained
batch advances it by the next of a seeded list of service times (the
first ones long, so the server is overloaded, the rest short, so it
recovers). Stated tolerance: exact. The port must equal JAX on which
submissions were shed (the None positions), every served event, the
histogram summaries and CDF, the deadline ledger (met, missed, shed,
EWMA, drain rate, effective batch knobs, shrinks and grows), the ladder's
transitions and the effective scrub interval after every step.

As in test_torch_scrub.py, the JAX server's readiness probe blocks on
its arrays, so both servers retire batches at the same points.
"""
import inspect

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.bdt import GradientBoostedClassifier as JaxGBC  # noqa: E402
from repro.core.readout import ReadoutChip as JaxChip  # noqa: E402
from repro.data.smartpixel import SmartPixelConfig as JaxSPC  # noqa: E402
from repro.data.smartpixel import generate as jax_generate  # noqa: E402
from repro.data.smartpixel import train_test_split as jax_split  # noqa: E402
from repro.launch.readout_server import LatencyHistogram as JaxHistogram  # noqa: E402
from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch.core.bdt import GradientBoostedClassifier as PortGBC  # noqa: E402
from repro_torch.core.readout import ReadoutChip as PortChip  # noqa: E402
from repro_torch.data.smartpixel import SmartPixelConfig as PortSPC  # noqa: E402
from repro_torch.data.smartpixel import generate as port_generate  # noqa: E402
from repro_torch.data.smartpixel import train_test_split as port_split  # noqa: E402
from repro_torch.launch import readout_server as port_mod  # noqa: E402
from repro_torch.launch.readout_server import (  # noqa: E402
    DEGRADE_RUNGS,
    SCRUB_RELAX_FACTOR,
    LatencyHistogram,
    ReadoutServer,
    ServerConfig,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _duo(gbc, chip_cls, spc, generate, split):
    tr, te = split(generate(spc(n_events=8_000, seed=11)))
    chips = []
    for depth, leaves in [(4, 8), (3, 5)]:
        clf = gbc(n_estimators=1, max_depth=depth, max_leaf_nodes=leaves,
                  min_samples_leaf=200).fit(tr["features"], tr["label"])
        chip = chip_cls.build(clf)
        chip.calibrate(tr["features"], tr["label"], target_sig_eff=0.95)
        chips.append(chip)
    return chips, te["features"]


@pytest.fixture(scope="module")
def duo():
    jax_chips, X = _duo(JaxGBC, JaxChip, JaxSPC, jax_generate, jax_split)
    port_chips, X2 = _duo(PortGBC, PortChip, PortSPC, port_generate,
                          port_split)
    assert np.array_equal(X, X2)
    return jax_chips, port_chips, X


def _server(pkg, chips, clock, **kw):
    if pkg == "jax":
        server = JaxServer(chips, JaxConfig(**kw), clock=clock)
        server._result_ready = lambda x: (jax.block_until_ready(x), True)[1]
        return server
    return ReadoutServer(chips, ServerConfig(**kw), clock=clock,
                         device="cpu")


def _schedule(seed, n_ticks=60):
    """[(chip, n events, clock step after the submit)] and the service
    time of each drained batch: 14 long ones, then short ones."""
    rng = np.random.default_rng(seed)
    ticks = [(int(rng.integers(0, 2)), int(rng.integers(1, 9)),
              float(rng.uniform(0, 8e-4))) for _ in range(n_ticks)]
    svc = np.concatenate([rng.uniform(5e-4, 2.5e-3, 14),
                          rng.uniform(0, 2e-4, 400)])
    return ticks, svc


def _drive(pkg, chips, X, sched, **kw):
    """Serve the schedule (submit, step the clock, poll; flush at the
    end). Returns (the seqs each submit returned, {seq: (chip, score,
    keep)}, the effective scrub interval after each poll, report)."""
    clock = FakeClock()
    server = _server(pkg, chips, clock, **kw)
    ticks, svc = sched
    drain, n_drained = server._drain_one, [0]

    def drain_after_service():
        clock.advance(float(svc[n_drained[0]]))
        n_drained[0] += 1
        return drain()

    server._drain_one = drain_after_service
    seqs, out, intervals, pos = [], [], [], 0
    for chip, n, dt in ticks:
        seqs.append(server.submit_batch(chip, X[pos:pos + n]))
        pos += n
        clock.advance(dt)
        out += server.poll()
        intervals.append(server._effective_scrub_interval())
    out += server.flush()
    return (seqs, {r.seq: (r.chip, r.score_raw, r.keep) for r in out},
            intervals, server.report())


@pytest.mark.parametrize("policy,seed,rungs", [
    ("shed", 0, DEGRADE_RUNGS),
    ("degrade", 0, DEGRADE_RUNGS),
    ("degrade", 2, DEGRADE_RUNGS),
    ("degrade", 2, ("sparse_egress",))])
def test_deadline_schedule_matches_jax(duo, policy, seed, rungs):
    jax_chips, port_chips, X = duo
    kw = dict(max_batch=16, min_batch=2, max_latency_s=1e-3,
              deadline_us=2000.0, overload_policy=policy, degrade_window=8,
              degrade_rungs=rungs, redundancy="tmr", scrub_interval=2)
    sched = _schedule(seed)
    want = _drive("jax", jax_chips, X, sched, **kw)
    got = _drive("port", port_chips, X, sched, **kw)
    assert got[0] == want[0]                        # shed positions
    assert got[1] == want[1]                        # every served event
    assert got[2] == want[2]                        # scrub interval
    for key in ("latency", "deadline", "link_bytes", "n_in", "n_kept"):
        assert got[3][key] == want[3][key], key
    for pc, jc in zip(got[3]["per_chip"], want[3]["per_chip"]):
        for key in ("n_in", "n_kept", "n_shed", "latency_p99_us"):
            assert pc[key] == jc[key], key
    rep = got[3]["deadline"]
    flat = [s for block in got[0] for s in block]
    n_shed = flat.count(None)
    assert n_shed == rep["shed"] > 0
    assert rep["met"] + rep["missed"] == got[3]["n_in"] == len(flat) - n_shed
    assert rep["batch_shrinks"] > 0 and rep["batch_grows"] > 0
    trans = rep["ladder"]["transitions"]
    if policy == "shed":
        assert trans == [] and set(got[2]) == {2}
    else:
        assert {t["direction"] for t in trans} == {"down", "up"}
        if "scrub_relax" in rungs:
            assert set(got[2]) == {2, 2 * SCRUB_RELAX_FACTOR}
    if rungs == ("sparse_egress",):
        # batches drained under the rung shipped the packed kept set
        assert got[3]["link_bytes"]["on_wire"] != 5 * got[3]["n_in"]


def test_matmul_sparse_egress_rung_matches_jax(duo):
    """layout="matmul": the rung switches egress from dense rows to the
    packed kept set (B6's keep-words entry on the card) and back, between
    dispatches of one stream; the port equals JAX on every event, the
    wire bytes and the ladder. Fixed 8-event batches keep the JAX
    interpreter to one shape."""
    jax_chips, port_chips, X = duo
    runs = []
    for pkg, chips in (("jax", jax_chips), ("port", port_chips)):
        clock = FakeClock()
        server = _server(pkg, chips[:1], clock, max_batch=8, min_batch=8,
                         max_latency_s=1e9, deadline_us=1_000.0,
                         layout="matmul", overload_policy="degrade",
                         degrade_window=8, degrade_rungs=("sparse_egress",))
        out, levels = [], []
        for k, stall in enumerate((0.005, 0.005, 0.0, 0.0)):
            server._drain_hist.clear()
            assert all(s is not None
                       for s in server.submit_batch(0, X[8 * k:8 * k + 8]))
            clock.advance(stall)
            out += server.poll() + server.flush()
            levels.append(server._rung_level)
        rep = server.report()
        runs.append(([(r.seq, r.score_raw, r.keep) for r in out], levels,
                     rep["link_bytes"], rep["deadline"]["ladder"]))
    assert runs[0] == runs[1]
    assert runs[1][1] == [1, 1, 0, 0]
    kept = [r for r in runs[1][0] if 8 <= r[0] < 24]
    assert all(r[2] for r in kept)          # rung on: only kept events


def test_crc_only_rung_defers_the_heal_like_jax(duo):
    """Under scrub_crc_only a detected upset is queued, not healed; the
    rung's exit heals it with a fresh readback — the same records, counts
    and counters as the JAX server, step by step."""
    jax_chips, port_chips, X = duo
    runs = []
    for pkg, chips in (("jax", jax_chips), ("port", port_chips)):
        clock = FakeClock()
        server = _server(pkg, chips[:1], clock, max_batch=8, min_batch=1,
                         max_latency_s=1e9, deadline_us=1_000.0,
                         overload_policy="degrade", degrade_window=8,
                         redundancy="tmr", scrub_interval=1,
                         degrade_rungs=("scrub_crc_only", "scrub_relax"))
        steps = []
        for k, stall in enumerate((0.005, 0.005, 0.0, 0.0)):
            if k == 1:
                server.inject_seu(0, 1, 3, 7)
            server._drain_hist.clear()
            server.submit_batch(0, X[8 * k:8 * k + 8])
            clock.advance(stall)
            got = server.poll() + server.flush()
            rep = server.report()
            steps.append(([(r.seq, r.score_raw, r.keep) for r in got],
                          server._rung_level, rep["scrub"],
                          rep["deadline"]["ladder"],
                          rep["per_chip"][0]["seu_disagreements"],
                          [server.verify_frame(0, r) for r in range(3)]))
        runs.append(steps)
    assert runs[0] == runs[1]
    port = runs[1]
    assert [step[1] for step in port] == [1, 2, 1, 0]
    # detected at step 2 with the rung on: queued, not healed
    assert port[2][2]["detections"] == 1 and port[2][2]["healed_bits"] == 0
    assert port[2][3]["deferred_heals_pending"] == 1
    assert port[2][5] == [True, False, True]
    # the rung's exit at step 3 heals it
    assert port[3][2]["healed_bits"] == 1
    assert port[3][3]["deferred_heals_pending"] == 0
    assert port[3][5] == [True] * 3


def test_adaptive_sizing_bands_match_jax(duo):
    """_adapt_batch on one sequence of service times: the same effective
    knobs, shrinks and grows, floors and ceilings as the reference."""
    jax_chips, port_chips, _ = duo
    servers = [
        _server(pkg, chips[:1], FakeClock(), backend="host", max_batch=64,
                min_batch=8, max_latency_s=1.0, deadline_us=10_000.0,
                overload_policy="shed")
        for pkg, chips in (("jax", jax_chips), ("port", port_chips))]
    dl = 0.010
    seq = [0.006] * 12 + [0.004, 0.002] + [0.0] * 10
    trail = []
    for server in servers:
        steps = []
        for svc in seq:
            server._adapt_batch(svc, dl)
            steps.append((server._eff_max_batch, server._eff_max_latency_s,
                          server._batch_shrinks, server._batch_grows))
        trail.append(steps)
    assert trail[0] == trail[1]
    assert min(s[0] for s in trail[1]) == 8
    assert trail[1][-1][0] == 64 and trail[1][-1][1] == pytest.approx(dl / 2)


@pytest.mark.parametrize("deadline_ms,ewma_ms,age_ms,depth", [
    (5.0, 0.0, 0.0, 0), (5.0, 1.0, 2.0, 8), (5.0, 3.0, 2.5, 8),
    (20.0, 19.0, 0.5, 1), (20.0, 5.0, 30.0, 32), (50.0, 60.0, 0.0, 4)])
def test_admission_decisions_match_jax(duo, deadline_ms, ewma_ms, age_ms,
                                       depth):
    """Admission on one state: the same decision and the same n_shed."""
    jax_chips, port_chips, X = duo
    got = []
    for pkg, chips in (("jax", jax_chips), ("port", port_chips)):
        clock = FakeClock()
        server = _server(pkg, chips[:1], clock, backend="host",
                         max_batch=4096, max_latency_s=1e9,
                         deadline_us=deadline_ms * 1e3,
                         overload_policy="shed")
        if depth:
            assert None not in server.submit_batch(0, X[:depth])
        server._service_ewma_s = ewma_ms * 1e-3
        clock.advance(age_ms * 1e-3)
        seq = server.submit(0, X[depth])
        got.append((seq, server.report()["per_chip"][0]["n_shed"]))
    assert got[0] == got[1]
    predicted = (age_ms if depth else 0.0) + ewma_ms
    assert (got[1][0] is None) == (depth > 0 and predicted >= deadline_ms)


def _samples(seed):
    rng = np.random.default_rng(seed)
    us = rng.lognormal(mean=5.0, sigma=2.5, size=2_000)
    return np.concatenate([us, [0.2, 0.0, 2e9, 1.0, 1e8]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_matches_reference(seed):
    """Percentiles, CDF, summary and merge on the same samples, exact."""
    us = _samples(seed)
    port, ref = LatencyHistogram(), JaxHistogram()
    port.add_many(us[:1_500])
    ref.add_many(us[:1_500])
    for h in (port, ref):
        h.add(float(us[1_500]))
    other_p, other_r = LatencyHistogram(), JaxHistogram()
    other_p.add_many(us[1_501:])
    other_r.add_many(us[1_501:])
    port.merge(other_p)
    ref.merge(other_r)
    np.testing.assert_array_equal(port.counts, ref.counts)
    for q in (0.0, 1.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert port.percentile(q) == ref.percentile(q), q
    assert port.cdf() == ref.cdf()
    assert port.summary() == ref.summary()
    assert port.count == len(us)
    assert LatencyHistogram().cdf() == [] and (
        LatencyHistogram().percentile(99.0) == 0.0)


def test_ladder_walks_down_and_up_like_jax(duo):
    """tests/test_deadline.py's deterministic ladder walk on both
    servers: three all-miss windows step down a rung each, three all-met
    windows step back up; every transition equal to the reference's."""
    jax_chips, port_chips, X = duo
    walks = []
    for pkg, chips in (("jax", jax_chips), ("port", port_chips)):
        clock = FakeClock()
        server = _server(pkg, chips[:1], clock, backend="host", max_batch=8,
                         min_batch=1, max_latency_s=1e9, deadline_us=1_000.0,
                         overload_policy="degrade", degrade_window=8,
                         scrub_interval=5)
        levels, intervals = [], []
        for stall in (0.005,) * 4 + (0.0,) * 3:
            server._drain_hist.clear()
            server.submit_batch(0, X[:8])
            clock.advance(stall)
            server.poll()
            server.flush()
            levels.append(server._rung_level)
            intervals.append(server._effective_scrub_interval())
        walks.append((levels, intervals,
                      server.report()["deadline"]["ladder"]))
    assert walks[0] == walks[1]
    assert walks[1][0] == [1, 2, 3, 3, 2, 1, 0]
    assert walks[1][1] == [20, 20, 20, 20, 20, 20, 5]


def test_reset_latency_metrics_keeps_trigger_accounting(duo):
    _, port_chips, X = duo
    clock = FakeClock()
    server = ReadoutServer(port_chips[:1], ServerConfig(
        backend="host", max_batch=8, max_latency_s=1e9, deadline_us=100.0,
        overload_policy="shed"), clock=clock, device="cpu")
    server.submit_batch(0, X[:8])
    clock.advance(0.001)
    server.poll()
    rep = server.report()
    assert rep["deadline"]["missed"] == 8 and rep["latency"]["total"][
        "count"] == 8
    server.reset_latency_metrics()
    rep = server.report()
    assert rep["n_in"] == 8 and rep["deadline"]["missed"] == 0
    assert rep["latency"]["total"]["count"] == 0
    assert rep["deadline"]["service_ewma_us"] == 0.0


def test_server_source_has_no_wall_clock_calls():
    """The injected clock is the only time source: the default
    ``time.monotonic`` appears once, as the constructor's default."""
    src = inspect.getsource(port_mod)
    assert "time.time(" not in src and "perf_counter" not in src
    assert src.count("time.monotonic") == 1
