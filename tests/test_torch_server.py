"""The port's ReadoutServer (frames path) against the JAX package's.

One seeded FrameStream — 2 chips x 3 batches x 64 events, chip 0
hot-swapped after the first batch — goes through the port's server on
the CPU and the JAX server, in the default (bit-sliced) layout and with
``layout="matmul"``. Per event (seq, chip, score, keep) and the report's
trigger counters must agree; the only events allowed to differ are those
whose quantized used-feature pattern differs between the two featurizers
(summation-order flips, see test_torch_yprofile.py). Knobs the port does
not carry yet raise NotPortedError.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch.core.quantize import quantize_raw  # noqa: E402
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig  # noqa: E402
from repro_torch.device import NotPortedError  # noqa: E402
from repro_torch.kernels.yprofile import ops as port_yp  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from tests._torch_helpers import chip_pair  # noqa: E402

FABRICS = ("efpga_28nm", "efpga_130nm")
N_BATCHES, N_EVENTS, SWAP_AT = 3, 64, 1


def _drive(server, chips_after_swap, blocks):
    """Serve the blocks with a frozen clock (batches form only at
    max_batch, reconfigure and flush — identical in both servers)."""
    out = []
    for step, per_sensor in enumerate(blocks):
        if step == SWAP_AT:
            out += server.reconfigure(0, chips_after_swap)
        for s, blk in enumerate(per_sensor):
            server.submit_frames(s, blk["frames"], blk["y0"])
            out += server.poll()
    out += server.flush()
    return {r.seq: (r.chip, r.score_raw, r.keep) for r in out}, server.report()


@pytest.fixture(scope="module")
def stream():
    pairs = [chip_pair(f) for f in FABRICS]
    swap = chip_pair("efpga_130nm", seed=6)
    fs = FrameStream(FrameStreamConfig(n_sensors=2, batch=N_EVENTS, seed=3))
    blocks = [[fs.batch_at(step, s) for s in range(2)]
              for step in range(N_BATCHES)]
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


def _flip_seqs(pairs, swap, blocks, jax_features):
    """seqs whose quantized used features differ between featurizers."""
    flips, seq = set(), 0
    for step, per_sensor in enumerate(blocks):
        for s, blk in enumerate(per_sensor):
            chip = swap if (s == 0 and step >= SWAP_AT) else pairs[s][1]
            used = list(chip.synth.used_features)
            a = port_yp.yprofile(blk["frames"], blk["y0"],
                                 device="cpu").numpy()[:, used]
            b = jax_features(blk["frames"], blk["y0"])[:, used]
            d = (quantize_raw(a, chip.golden.spec)
                 != quantize_raw(b, chip.golden.spec)).any(-1)
            flips |= {seq + i for i in np.flatnonzero(d)}
            seq += len(d)
    return flips


def _jax_features(frames, y0):
    from repro.kernels.yprofile import ops as jax_yp

    return np.asarray(jax_yp.yprofile(frames, y0, batch_tile=128))


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
    flips = _flip_seqs(pairs, swap[1], blocks, _jax_features)
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
    assert server._stack.layout == "banded" and server.layout == "matmul"
    got, rep = _drive(server, swap[1], blocks)
    want, jrep = matmul_runs[red]
    assert sorted(got) == sorted(want)
    diff = {q for q in got if got[q] != want[q]}
    assert diff <= _flip_seqs(pairs, swap[1], blocks, _jax_features)
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


def test_host_and_kernel_backends_agree_exactly(stream):
    pairs, swap, blocks, _ = stream
    runs = [_drive(ReadoutServer([p[1] for p in pairs],
                                 ServerConfig(backend=b, redundancy="tmr"),
                                 clock=lambda: 0.0, device="cpu"),
                   swap[1], blocks)[0] for b in ("kernel", "host")]
    assert runs[0] == runs[1]


def test_score_stream_yields_every_event(stream):
    pairs, _, blocks, _ = stream
    server = ReadoutServer([p[1] for p in pairs], ServerConfig(max_batch=64),
                           device="cpu")
    items = [(s, blk["frames"], blk["y0"])
             for per_sensor in blocks for s, blk in enumerate(per_sensor)]
    seqs = [r.seq for got in server.score_stream(items) for r in got]
    assert sorted(seqs) == list(range(len(items) * N_EVENTS))
    with pytest.raises(NotPortedError):
        list(server.score_stream([(0, np.zeros((2, 14)))]))


def test_config_fields_and_defaults_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(ServerConfig)}
    jax = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert port == jax


@pytest.mark.parametrize("knob", [
    dict(sparse=True), dict(scrub_interval=4),
    dict(scrub_mode="round_robin"), dict(deadline_us=100.0),
    dict(deadline_us=100.0, overload_policy="shed"),
    dict(degrade_rungs=("scrub_relax",)), dict(degrade_window=8),
    dict(degrade_enter_frac=0.6), dict(degrade_exit_frac=0.1),
    dict(min_batch=16), dict(tenant_quota_queued=4),
    dict(deadline_us=100.0, overload_policy="degrade")])
def test_unported_knob_raises_not_ported(knob):
    with pytest.raises(NotPortedError, match="ROADMAP"):
        ServerConfig(**knob)


def test_invalid_knob_still_raises_value_error():
    with pytest.raises(ValueError, match="max_batch"):
        ServerConfig(max_batch=0)


def test_features_path_not_ported(stream):
    pairs = stream[0]
    server = ReadoutServer([p[1] for p in pairs], device="cpu")
    with pytest.raises(NotPortedError, match="features"):
        server.submit(0, np.zeros(14))
    with pytest.raises(NotPortedError, match="features"):
        server.submit_batch(0, np.zeros((3, 14)))


def test_submit_frames_validates_input(stream):
    server = ReadoutServer([p[1] for p in stream[0]], device="cpu")
    with pytest.raises(ValueError, match="chip"):
        server.submit_frames(2, np.zeros((1, 8, 13, 21)), np.zeros(1))
    with pytest.raises(ValueError, match="frames"):
        server.submit_frames(0, np.zeros((2, 8, 13, 20)), np.zeros(2))
    with pytest.raises(ValueError, match="y0"):
        server.submit_frames(0, np.zeros((2, 8, 13, 21)), np.zeros(3))
