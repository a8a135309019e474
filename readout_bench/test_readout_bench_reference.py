"""The reference and the yardstick on the CPU: the program (``device=
"cpu"``, each kernel's plain twin) against the reference on a few
thousand events of each configuration, compared as the cells compare;
the bfloat16 control failing that comparison; the count functions
against hand-worked values."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from readout_bench import deploy, reference, yardstick
from readout_bench.stream import frame_pool

HERE = os.path.dirname(os.path.abspath(__file__))


def small(name: str, events: int = 20_000):
    cfg = deploy.load_json("configs", name)
    cfg["chips"] = [dict(c, events=events) for c in cfg["chips"]]
    return cfg


@pytest.fixture(scope="module", params=["paper28", "tmr28"])
def served(request):
    """A deployment at a CPU size, its pool of 1,024 frames a sensor
    and the reference's answers for them."""
    dep = deploy.build(small(request.param))
    frames, y0 = frame_pool(dep.n_sensors, 1024, seed=987_654_321)
    feats = [reference.featurize(frames[s], y0[s], 800.0)
             for s in range(dep.n_sensors)]
    return dep, frames, y0, reference.answers(dep.models, dep.cuts, feats)


def test_program_matches_reference_on_served_events(served):
    from repro_torch.launch.readout_server import ReadoutServer

    dep, frames, y0, ans = served
    server = ReadoutServer(dep.chips, dep.server_config(), device="cpu")
    for s in range(dep.n_sensors):
        server.submit_frames(s, frames[s], y0[s])
    res = server.flush()
    got = np.fromiter(((r.seq, r.chip, r.score_raw, r.keep) for r in res),
                      reference.EVENT_DTYPE, len(res))
    n = frames.shape[1]
    chip = np.repeat(np.arange(dep.n_sensors), n)
    score = np.concatenate([a[0] for a in ans])
    keep = np.concatenate([a[1] for a in ans])
    sparse = dep.config["server"]["sparse"]
    cmp = reference.compare_events(chip, score, keep, got, kept_only=sparse)
    assert cmp == {"compared": len(chip), "wrong": 0, "lost": 0, "stray": 0}
    assert 0.5 < keep.mean() < 1.0


CONTROL_TRAFFIC = {
    "stream": {"pool_events_per_sensor": 1024, "block_events": 256,
               "warmup_blocks_per_sensor": 1},
    "check": {"pool_events": 8192, "chunk_events": 2048,
              "warmup_chunks": 1},
}


@pytest.mark.parametrize("cell", ["tmr28.stream", "paper28.check"])
def test_bfloat16_control_fails_the_comparison(cell):
    """The reference in the program's place, its float32 inputs in
    bfloat16, through a whole run of the cell: the run's own comparison
    (dense, or the kept set where the cell compares the sparse egress)
    and the cell's limits make it incorrect."""
    from readout_bench.control import control_run

    name, traffic = cell.split(".")
    r = control_run(cell, 987_654_321, 0.5, "cpu",
                    traffic_over=CONTROL_TRAFFIC[traffic],
                    config_over={"chips": small(name)["chips"]})
    assert r["correct"] is False
    assert r["checks"]["wrong_share"]["value"] > \
        r["checks"]["wrong_share"]["limit"]
    assert r["checks"]["lost"]["value"] == 0


def test_check_path_matches_reference():
    from repro_torch.core.readout import KernelBackend

    dep = deploy.build(small("paper28"))
    X = reference_features(4096)
    got = dep.chips[0].infer_raw(X, backend=KernelBackend(device="cpu"))
    assert np.array_equal(np.asarray(got, np.int64), dep.models[0].score(X))


def reference_features(n):
    from readout_bench import smartpixel

    return smartpixel.generate(smartpixel.SmartPixelConfig(
        n_events=n, seed=4242))["features"]


def test_to_bfloat16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -2.5e4, 0.0],
                 np.float32)
    want = np.array([1.0, 1.0, 1.0 + 2 ** -7, -24960.0, 0.0], np.float32)
    assert np.array_equal(reference.to_bfloat16(x), want)


def test_quantize_raw_floors_and_wraps():
    assert reference.quantize_raw(0.00195, 28, 19) == 0
    assert reference.quantize_raw(1.0 / 512, 28, 19) == 1
    assert reference.quantize_raw(-1e-9, 28, 19) == -1
    assert reference.quantize_raw(2.0 ** 18, 28, 19) == -(2 ** 27)


def test_counts_against_hand_worked_values():
    # K1, 1,000 frames: (8,736 + 4) B in and 56 B out an event
    assert yardstick.k1_least_s(1000) == pytest.approx(
        1000 * (8740 + 56) / 3.35e12)
    chip = {"n_luts": 10, "n_inputs": 20, "n_outputs": 8, "replicas": 3,
            "n_used_features": 2}
    # 32 events x (15 x 3 x 10 / 32 selects + 8 x 4 / 32 vote) = 482
    assert yardstick.fabric_ops(chip, 32) == pytest.approx(482.0)
    # 32 events x (3 B of inputs + 2 B of 8 + 3 bits)
    assert yardstick.fabric_bytes(chip, 32) == 160
    assert yardstick.fabric_least_s([chip], [32]) == pytest.approx(
        160 / 3.35e12)
    plain = dict(chip, replicas=1, n_luts=1000)
    # 15 x 1,000 / 32 operations an event outweigh its 4 bytes
    assert yardstick.fabric_least_s([plain], [64]) == pytest.approx(
        64 * 15 * 1000 / 32 / (67e12 / 4))
    assert yardstick.check_least_s(plain, 64) == pytest.approx(
        max(64 * 12 / 3.35e12, 64 * 15 * 1000 / 32 / (67e12 / 4)))
    served = yardstick.served_least_s([chip], [100], kept=50, sparse=True)
    assert served == pytest.approx(max(
        (100 * 8740 + 50 * 8) / 3.35e12,
        100 * 2184 / 67e12 + yardstick.fabric_ops(chip, 100) / (67e12 / 4)))


def test_every_config_states_its_settings():
    for name in ("paper28", "tmr28"):
        with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        assert cfg["name"] == name and cfg["assumed"]
        assert len(cfg["source"]) <= 200
        assert cfg["server"]["max_batch"] == 2048
