"""The port's ReadoutServer (dense egress) against the JAX package's.

One seeded FrameStream — 2 chips x 3 batches x 64 events, chip 0
hot-swapped after the first batch (tests/_torch_helpers.served_stream) —
goes through the port's server on the CPU and the JAX server, in the
default (bit-sliced) layout and with ``layout="matmul"``. Per event (seq,
chip, score, keep) and the report's trigger counters must agree; the only
events allowed to differ are those whose quantized used-feature pattern
differs between the two featurizers (summation-order flips, see
test_torch_yprofile.py). The features path, fed the same host features,
agrees exactly. The scrub, deadline and tenant-quota knobs validate as
the JAX package's do (their serving is tested in test_torch_scrub.py,
test_torch_deadline.py and test_torch_fleet.py). Sparse egress is tested
in test_torch_sparse.py. The server's two scoring paths (kernel and host)
give the same events and reports through the one loop, in both egress
and ingest forms and through an upset and its heal.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from tests._torch_helpers import N_BATCHES, N_EVENTS, served_features  # noqa: E402
from tests._torch_helpers import drive as _drive  # noqa: E402
from tests._torch_helpers import served_stream  # noqa: E402
from tests._torch_helpers import flip_seqs  # noqa: E402



@pytest.fixture(scope="module")
def stream():
    pairs, swap, blocks = served_stream()
    jax_runs = {}
    for red in ("none", "tmr"):
        server = JaxServer([p[0] for p in pairs], JaxConfig(redundancy=red),
                           clock=lambda: 0.0)
        jax_runs[red] = _drive(server, swap[0], blocks)
    return pairs, swap, blocks, jax_runs


@pytest.fixture(scope="module")
def matmul_runs(stream):
    """The JAX server's runs with layout="matmul", in setup."""
    pairs, swap, blocks, _ = stream
    runs = {}
    for red in ("none", "tmr"):
        server = JaxServer([p[0] for p in pairs],
                           JaxConfig(redundancy=red, layout="matmul"),
                           clock=lambda: 0.0)
        runs[red] = _drive(server, swap[0], blocks)
    return runs


@pytest.mark.parametrize("backend,red", [
    ("kernel", "none"), ("kernel", "tmr"), ("host", "none")])
def test_server_events_and_counters_match_jax(stream, backend, red):
    pairs, swap, blocks, jax_runs = stream
    server = ReadoutServer([p[1] for p in pairs],
                           ServerConfig(backend=backend, redundancy=red),
                           clock=lambda: 0.0, device="cpu")
    got, rep = _drive(server, swap[1], blocks)
    want, jrep = jax_runs[red]
    assert sorted(got) == sorted(want) == list(range(2 * N_BATCHES * N_EVENTS))
    diff = {q for q in got if got[q] != want[q]}
    flips = flip_seqs(pairs, swap[1], blocks)
    print(f"{backend}/{red}: {len(flips)} flip events, {len(diff)} differ")
    assert diff <= flips and len(flips) <= 0.01 * len(got)
    assert all(got[q][0] == want[q][0] for q in got)          # chip tags
    for c, (pc, jc) in enumerate(zip(rep["per_chip"], jrep["per_chip"])):
        assert pc["n_in"] == jc["n_in"]
        assert pc["seu_disagreements"] == jc["seu_disagreements"]
        keep_diff = sum(int(got[q][2]) - int(want[q][2])
                        for q in diff if got[q][0] == c)
        assert pc["n_kept"] - jc["n_kept"] == keep_diff
    assert rep["n_in"] == jrep["n_in"] and rep["n_replicas"] == (
        3 if red == "tmr" else 1)
    assert rep["link_bytes"]["on_wire"] == jrep["link_bytes"]["on_wire"]
    stages = set(rep["stages"])
    assert ({"launch_fused", "stack_frames", "drain_wait"} <= stages
            if backend == "kernel" else
            {"staged_featurize", "staged_encode", "staged_score"} <= stages)


@pytest.mark.parametrize("red", ["none", "tmr"])
def test_matmul_server_events_and_counters_match_jax(stream, matmul_runs,
                                                     red):
    """ServerConfig(layout="matmul") serves through the selection-matmul
    kernels' twins (banded here) with the vote in torch ops; it agrees with
    the JAX server's matmul run and, exactly, with the port's bit-sliced
    server."""
    pairs, swap, blocks, _ = stream
    server = ReadoutServer([p[1] for p in pairs],
                           ServerConfig(layout="matmul", redundancy=red),
                           clock=lambda: 0.0, device="cpu")
    assert server._path.stack.layout == "banded" and server.layout == "matmul"
    got, rep = _drive(server, swap[1], blocks)
    want, jrep = matmul_runs[red]
    assert sorted(got) == sorted(want)
    diff = {q for q in got if got[q] != want[q]}
    assert diff <= flip_seqs(pairs, swap[1], blocks)
    for pc, jc in zip(rep["per_chip"], jrep["per_chip"]):
        assert pc["n_in"] == jc["n_in"]
        assert pc["seu_disagreements"] == jc["seu_disagreements"] == [0] * (
            3 if red == "tmr" else 1)
    assert rep["layout"] == jrep["layout"] == "matmul"
    bitsliced = ReadoutServer([p[1] for p in pairs],
                              ServerConfig(redundancy=red),
                              clock=lambda: 0.0, device="cpu")
    assert _drive(bitsliced, swap[1], blocks)[0] == got


def test_default_layout_stays_bitsliced():
    assert ServerConfig().effective_layout == "bitsliced"
    assert ServerConfig(layout="matmul").effective_layout == "matmul"


# The stage keys each scoring path reports on this stream, fixed: the
# benchmark's readers sum stages by name.
_LOOP_STAGES = {"submit", "poll", "coalesce", "enqueue_d2h", "drain_wait",
                "drain_wait.sync", "drain_wait.fold", "observe"}
_STAGE_KEYS = {
    ("kernel", "frames"): _LOOP_STAGES | {
        "stack_frames", "launch_fused", "launch_fused.h2d"},
    ("kernel", "features"): _LOOP_STAGES | {"encode_host", "launch_score"},
    ("host", "frames"): _LOOP_STAGES | {
        "staged_featurize", "staged_encode", "staged_score"},
    ("host", "features"): _LOOP_STAGES | {"encode_host", "launch_score"},
}


@pytest.mark.parametrize("case", ["dense-frames", "dense-features",
                                  "sparse-frames", "sparse-features",
                                  "seu"])
def test_host_and_kernel_backends_agree_exactly(stream, case):
    """Both scoring paths through the one loop, on the TMR stream, by
    egress (dense or sparse) and ingest (frames or features): identical
    ScoredEvents, identical reports but for ``backend``, ``slabs`` and
    ``stages``, and each path's stage keys as before. Case ``seu``: an
    upset in one replica of chip 1 before the stream, scrubbed every
    dispatch; both paths detect it once and heal the same bits (the
    kernel path verifies a sample a scrub step later, so detection
    latencies and disagreement counts are not compared)."""
    pairs, swap, blocks, _ = stream
    seu = case == "seu"
    egress, _, ingest = ("dense-frames" if seu else case).partition("-")
    runs = []
    for backend in ("kernel", "host"):
        server = ReadoutServer(
            [p[1] for p in pairs],
            ServerConfig(backend=backend, redundancy="tmr",
                         sparse=egress == "sparse",
                         **(dict(scrub_interval=1, max_batch=N_EVENTS)
                            if seu else {})),
            clock=lambda: 0.0, device="cpu")
        if seu:
            server.inject_seu(1, 1, 0, 0)
        got, rep = _drive(
            server, swap[1], blocks, frames=ingest == "frames",
            features=served_features() if ingest == "features" else None)
        want = (_STAGE_KEYS[backend, ingest]
                | ({"sparse_pack"} if backend == "host"
                   and egress == "sparse" else set())
                | ({"scrub"} if seu else set()))
        assert set(rep["stages"]) == want, backend
        runs.append((got, rep, [server.verify_frame(c, r)
                                for c in range(2) for r in range(3)]))
    (got, rep, healthy), (host_got, host_rep, host_healthy) = runs
    assert got == host_got and len(got) > 0
    if seu:
        for r in (rep, host_rep):
            assert r["scrub"]["detections"] == 1
        assert rep["scrub"]["healed_bits"] == host_rep["scrub"][
            "healed_bits"] == 1
        assert healthy == host_healthy == [True] * 6
    else:
        def drop(r):
            return {k: v for k, v in r.items()
                    if k not in ("backend", "slabs", "stages")}
        np.testing.assert_equal(drop(rep), drop(host_rep))


def test_score_stream_yields_every_event(stream):
    pairs, _, blocks, _ = stream
    server = ReadoutServer([p[1] for p in pairs], ServerConfig(max_batch=64),
                           device="cpu")
    items = [(s, blk["frames"], blk["y0"])
             for per_sensor in blocks for s, blk in enumerate(per_sensor)]
    seqs = [r.seq for got in server.score_stream(items) for r in got]
    assert sorted(seqs) == list(range(len(items) * N_EVENTS))
    # (chip, features) pairs take the features path
    feats = served_features()
    pairs_stream = [(s, feats[step][s]) for step in range(N_BATCHES)
                    for s in range(2)]
    seqs = [r.seq for got in server.score_stream(pairs_stream) for r in got]
    n0 = len(items) * N_EVENTS
    assert sorted(seqs) == list(range(n0, n0 + len(pairs_stream) * N_EVENTS))


def test_config_fields_and_defaults_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(ServerConfig)}
    jax = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert port == jax


# bad values of each scrub and deadline knob (the JAX package's
# tests/test_scrub.py and tests/test_deadline.py validation cases)
_BAD_VALUES = {
    "scrub_interval": [dict(scrub_interval=v)
                       for v in (0, -1, 1.5, "4", True)],
    "scrub_mode": [dict(scrub_mode="psychic")],
    "deadline_us": [dict(deadline_us=v) for v in
                    (0, -3.5, float("nan"), float("inf"), True)],
    "overload_policy": [dict(overload_policy="panic"),
                        dict(deadline_us=None)],
    "degrade_rungs": [dict(degrade_rungs=()),
                      dict(degrade_rungs=("scrub_relax", "scrub_relax")),
                      dict(degrade_rungs=("warp_core",))],
    "degrade_window": [dict(degrade_window=0), dict(degrade_window=True)],
    "degrade_enter_frac": [dict(degrade_enter_frac=0.05),
                           dict(degrade_enter_frac=1.5)],
    "degrade_exit_frac": [dict(degrade_exit_frac=0.0),
                          dict(degrade_exit_frac=0.7)],
    "min_batch": [dict(min_batch=0), dict(min_batch=True),
                  dict(min_batch=2.0)],
    "tenant_quota_queued": [dict(tenant_quota_queued=v)
                            for v in (0, -1, 1.5, "4", True)],
}


@pytest.mark.parametrize("knob", [
    dict(scrub_interval=4),
    dict(scrub_mode="round_robin"), dict(deadline_us=100.0),
    dict(deadline_us=100.0, overload_policy="shed"),
    dict(degrade_rungs=("scrub_relax",)), dict(degrade_window=8),
    dict(degrade_enter_frac=0.6), dict(degrade_exit_frac=0.1),
    dict(min_batch=16),
    dict(deadline_us=100.0, overload_policy="degrade"),
    dict(tenant_quota_queued=4)])
def test_scrub_and_deadline_knobs_validate_like_jax(knob):
    """Each scrub and deadline knob, and the fleet's tenant quota, is
    served: accepted with the value given, and each bad value raises the
    JAX package's ValueError text."""
    cfg = ServerConfig(**knob)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxConfig(**knob))
    name = list(knob)[-1]
    for bad in _BAD_VALUES[name]:
        kw = {**knob, **bad}
        with pytest.raises(ValueError) as port_err:
            ServerConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            JaxConfig(**kw)
        assert str(port_err.value) == str(jax_err.value), kw


def test_invalid_knob_still_raises_value_error():
    with pytest.raises(ValueError, match="max_batch"):
        ServerConfig(max_batch=0)


def test_sparse_knob_must_be_a_bool():
    assert ServerConfig(sparse=True, redundancy="tmr").sparse
    for bad in ("yes", 1):
        with pytest.raises(ValueError, match="sparse"):
            ServerConfig(sparse=bad)


def test_features_path_matches_jax(stream):
    """submit/submit_batch of the stream's host features: every event and
    the report's counters equal the JAX server's exactly (no featurizer
    in this path)."""
    pairs, swap, blocks, _ = stream
    feats = served_features()
    runs = []
    for server, chip in (
            (JaxServer([p[0] for p in pairs], JaxConfig(), clock=lambda: 0.0),
             swap[0]),
            (ReadoutServer([p[1] for p in pairs], ServerConfig(),
                           clock=lambda: 0.0, device="cpu"), swap[1])):
        runs.append(_drive(server, chip, blocks, features=feats,
                           frames=False))
    (want, jrep), (got, rep) = runs
    assert got == want and len(got) == 2 * N_BATCHES * N_EVENTS
    for pc, jc in zip(rep["per_chip"], jrep["per_chip"]):
        for k in ("n_in", "n_kept", "n_dispatches", "seu_disagreements"):
            assert pc[k] == jc[k], k
    assert rep["link_bytes"] == jrep["link_bytes"]
    assert {"encode_host", "launch_score", "drain_wait"} <= set(rep["stages"])
    with pytest.raises(ValueError, match="chip"):
        runs and ReadoutServer([p[1] for p in pairs],
                               device="cpu").submit(2, feats[0][0][0])


def test_submit_frames_validates_input(stream):
    server = ReadoutServer([p[1] for p in stream[0]], device="cpu")
    with pytest.raises(ValueError, match="chip"):
        server.submit_frames(2, np.zeros((1, 8, 13, 21)), np.zeros(1))
    with pytest.raises(ValueError, match="frames"):
        server.submit_frames(0, np.zeros((2, 8, 13, 20)), np.zeros(2))
    with pytest.raises(ValueError, match="y0"):
        server.submit_frames(0, np.zeros((2, 8, 13, 21)), np.zeros(3))
