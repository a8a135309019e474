"""Replay recorded sensor frames against a live network front door of the
PyTorch port (examples/replay_load.py, served by ``repro_torch`` on a
CUDA card).

    PYTHONPATH=src python examples/torch_replay_load.py
    PYTHONPATH=src python examples/torch_replay_load.py \
        --sensors 4 --rate 5000 --pattern square --batches 32
    PYTHONPATH=src python examples/torch_replay_load.py --device cpu

Builds the paper's single-tree readout chip per sensor, starts the
port's asyncio front door (TCP + UDP) on loopback, then drives one replay
client PER SENSOR concurrently — each streams deterministic
``FrameStream`` frames at a controlled Poisson or square-wave event
rate, collects the sparse trigger decisions coming back, and verifies
every one bit-exact against the host oracle (the server's featurizer on
the same device, then numpy). Prints per-sensor achieved rate +
end-to-end latency percentiles and the door's per-client accounting
(``report()["net"]``).

It takes every flag of examples/replay_load.py, and ``--device`` (the
card by default; ``cpu`` runs each kernel's plain PyTorch twin, and only
when asked). It imports nothing of the JAX package. ``--rate 0`` floods
unpaced (the loopback-throughput configuration).
"""
import argparse
import asyncio
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def build_chip(seed: int = 5):
    from repro_torch.core.bdt import GradientBoostedClassifier
    from repro_torch.core.readout import ReadoutChip
    from repro_torch.data.smartpixel import (
        SmartPixelConfig, generate, train_test_split)

    data = generate(SmartPixelConfig(n_events=8_000, seed=seed))
    tr, _ = train_test_split(data)
    clf = GradientBoostedClassifier(
        n_estimators=1, max_depth=5, max_leaf_nodes=10,
        min_samples_leaf=500,
    ).fit(tr["features"], tr["label"])
    chip = ReadoutChip.build(clf)
    chip.calibrate(tr["features"], tr["label"], target_sig_eff=0.95)
    return chip


async def main_async(args):
    from repro_torch.data.pipeline import FrameStream, FrameStreamConfig
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig
    from repro_torch.net.ingress import FrontDoorConfig, ReadoutFrontDoor
    from repro_torch.net.replay import (
        ReplayConfig, frame_stream_source, host_oracle, replay)

    print(f"== building {args.sensors} chip(s) ==")
    chip = build_chip()
    chips = [chip] * args.sensors
    srv = ReadoutServer(chips, ServerConfig(
        max_batch=256, max_latency_s=5e-3, backend=args.backend,
        batch_tile=128), device=args.device)
    door = ReadoutFrontDoor(srv, FrontDoorConfig())
    await door.start()
    print(f"== front door up on {srv.device}: tcp={door.tcp_port} "
          f"udp={door.udp_port} ==")

    stream = FrameStream(FrameStreamConfig(
        n_sensors=args.sensors, batch=max(args.events_per_batch, 8),
        seed=702))
    oracle = host_oracle(chip, device=args.device)

    async def one_sensor(sensor: int):
        cfg = ReplayConfig(
            rate_hz=args.rate, pattern=args.pattern,
            n_batches=args.batches,
            events_per_batch=args.events_per_batch, sensor=sensor,
            transport=args.transport, seed=11 + sensor)
        src = frame_stream_source(stream, sensor, args.events_per_batch)
        return await replay("127.0.0.1", door.tcp_port
                            if args.transport == "tcp" else door.udp_port,
                            src, cfg, oracle)

    try:
        reports = await asyncio.gather(
            *(one_sensor(s) for s in range(args.sensors)))
    finally:
        await door.stop()

    ok = True
    for s, rep in enumerate(reports):
        lat = rep.latency
        print(f"sensor {s}: {rep.n_events} events @ "
              f"{rep.achieved_ev_s:,.0f} ev/s  "
              f"p50={lat['p50_us'] / 1e3:.2f}ms "
              f"p99={lat['p99_us'] / 1e3:.2f}ms  "
              f"kept={rep.n_kept}/{rep.n_triggers}  "
              f"verified={rep.verified}")
        if rep.mismatches:
            ok = False
            print(f"  MISMATCHES: {rep.mismatches[:3]}")
    net = srv.report()["net"]
    print("== door accounting ==")
    print(json.dumps(net, indent=2, sort_keys=True, default=int))
    if not ok:
        raise SystemExit("trigger decisions did NOT match the host oracle")
    print("all trigger decisions bit-exact vs the host oracle")
    return reports


def main(argv=None):
    """Run the replay; returns the per-sensor ``ReplayReport``s."""
    ap = argparse.ArgumentParser(
        description="replay load generator for the port's front door")
    ap.add_argument("--sensors", type=int, default=2)
    ap.add_argument("--rate", type=float, default=2_000.0,
                    help="target events/s per sensor (0 = unpaced)")
    ap.add_argument("--pattern", default="poisson",
                    choices=["poisson", "square"])
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--events-per-batch", type=int, default=16)
    ap.add_argument("--transport", default="tcp", choices=["tcp", "udp"])
    ap.add_argument("--backend", default="host",
                    choices=["host", "kernel"])
    ap.add_argument("--device", default=None,
                    help="where the server and the oracle's featurizer "
                         "run: the CUDA card by default, or 'cpu'")
    args = ap.parse_args(argv)
    if args.transport == "udp":
        from repro_torch.net import protocol as P
        args.events_per_batch = min(args.events_per_batch,
                                    P.UDP_MAX_EVENTS)
    return asyncio.run(main_async(args))


if __name__ == "__main__":
    main()
