"""Multi-chip streaming front-end readout service on the PyTorch port
(examples/serve_readout.py, served by ``repro_torch`` on a CUDA card).

    PYTHONPATH=src python examples/torch_serve_readout.py [--chips 4] [--features]
    PYTHONPATH=src python examples/torch_serve_readout.py --device cpu

It takes every flag of examples/serve_readout.py, and ``--device`` (the
card by default; ``cpu`` runs each kernel's plain PyTorch twin, and only
when asked). It imports nothing of the JAX package.

Simulates a deployed multi-sensor duty cycle the way the paper deploys
it: RAW charge frames stream in from N sensors (the AXI-Stream/PGPv4
path of §4.2), each sensor owns a configured eFPGA, and every micro-
batch scores through ONE fused device pass (launch/readout_server.py +
kernels/frontend.py): yprofile featurization, ap_fixed quantization,
input-bit gather, the bit-sliced fabric walk and the keep/drop cut all
run on the card — the host never materializes features or bits. Only
retained hits go out, with running link-budget accounting and a per-
stage timing breakdown per dispatch stage. Mid-stream, one chip is hot-
swapped to a new bitstream (the SUGOI control-plane analogue) — an array
swap into the stacked geometry AND the fused encode plan, no rebuild, no
service stop.

``--features`` falls back to the legacy host-featurized ingestion
(submit features, host quantize+pack, scoring dispatch) for comparison —
the same stream, two frontends.

``--redundancy tmr`` serves every chip as THREE placement-distinct
replica encodings voted 2-of-3 on the card (the paper's §5 TMR requirement
as a serving mode); with ``--seu-at N`` the demo injects a
configuration-bit SEU into one replica mid-stream and the stream keeps
scoring bit-exactly while the per-replica disagreement counters — the
SEU health monitor — climb.
``--sparse`` switches the host link to the packed (indices, scores)
trigger format: only keep-flagged events cross it, and the report prints
measured bytes-on-wire vs the dense equivalent.
``--scrub-interval K`` turns on the background scrub task (readback ->
CRC verify -> heal every K dispatches, steered by the disagreement
counters) — the repair leg that makes injected upsets *transient*. It
works WITHOUT redundancy too (CRC-only detection; outputs are exposed
until the heal, which is exactly the window scrubbing bounds).
``--seu-rate R`` keeps faults coming as a Poisson process (R per batch)
so the scrub counters in the final report have something to show. Flag
combinations are validated up front: injecting faults with neither
``--redundancy tmr`` nor ``--scrub-interval`` is refused instead of
silently serving corrupted scores.
``--deadline-us B`` turns on deadline-aware serving: every event gets a
per-event latency budget, and ``--overload-policy`` picks what happens
when the budget is threatened — ``observe`` (count misses only),
``shed`` (admission control rejects at submit, counted per chip) or
``degrade`` (the hysteretic rung ladder: relax scrubbing, CRC-only
scrub, sparse-only egress). The final report prints the latency
percentiles, the met/missed/shed ledger and any ladder transitions.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.bdt import GradientBoostedClassifier
from repro_torch.core.readout import ReadoutChip
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig
from repro_torch.data.smartpixel import (
    SmartPixelConfig, generate, train_test_split)
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig


def train_chip(seed: int, depth: int, leaves: int, threshold: float = 0.97):
    data = generate(SmartPixelConfig(n_events=30_000, seed=seed))
    tr, _ = train_test_split(data)
    clf = GradientBoostedClassifier(
        n_estimators=1, max_depth=depth, max_leaf_nodes=leaves,
        min_samples_leaf=500,
    ).fit(tr["features"], tr["label"])
    chip = ReadoutChip.build(clf, fabric="efpga_28nm")
    chip.calibrate(tr["features"], tr["label"], target_sig_eff=threshold)
    return chip


def main(argv=None):
    """Run the service; returns the final ``report()``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--rate-batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256,
                    help="events per sensor per stream batch")
    ap.add_argument("--max-batch", type=int, default=8_192,
                    help="server micro-batch size (events, all chips)")
    ap.add_argument("--backend", default="kernel", choices=["kernel", "host"])
    ap.add_argument("--features", action="store_true",
                    help="legacy host-featurized ingestion instead of raw "
                         "frames through the fused frontend")
    ap.add_argument("--reconfigure-at", type=int, default=4,
                    help="hot-swap chip 0's bitstream after N batches")
    ap.add_argument("--redundancy", default="none", choices=["none", "tmr"],
                    help="serve 3 voted replica encodings per chip (SEU "
                         "resilience)")
    ap.add_argument("--sparse", action="store_true",
                    help="sparse trigger readout: only kept events cross "
                         "the host link as packed (indices, scores)")
    ap.add_argument("--seu-at", type=int, default=None,
                    help="inject a config-bit SEU into chip 0 after N "
                         "batches (replica 1 under TMR, the unprotected "
                         "replica 0 otherwise)")
    ap.add_argument("--seu-rate", type=float, default=0.0,
                    help="Poisson configuration-fault rate (faults/batch) "
                         "injected into random replica frames")
    ap.add_argument("--scrub-interval", type=int, default=None,
                    help="background config scrubbing: readback -> CRC "
                         "verify -> heal every K dispatches (off when "
                         "omitted; works without --redundancy via "
                         "CRC-only detection)")
    ap.add_argument("--scrub-mode", default=None,
                    choices=["steered", "round_robin"],
                    help="steer scrubs toward replicas whose disagreement "
                         "counters climb (default), or strict round-robin; "
                         "requires --scrub-interval")
    ap.add_argument("--deadline-us", type=float, default=None,
                    help="per-event latency budget in microseconds "
                         "(deadline-aware serving; off when omitted)")
    ap.add_argument("--overload-policy", default=None,
                    choices=["observe", "shed", "degrade"],
                    help="what to do when the deadline is threatened: "
                         "observe (count only), shed (admission control) "
                         "or degrade (the rung ladder); requires "
                         "--deadline-us")
    ap.add_argument("--device", default=None,
                    help="where the server runs: the CUDA card by default, "
                         "or 'cpu' (each kernel's plain PyTorch twin)")
    args = ap.parse_args(argv)

    # flag-combination validation: fail HERE with a named error instead of
    # silently ignoring a flag (or silently serving corrupted scores)
    if args.seu_rate < 0:
        ap.error("--seu-rate must be >= 0")
    if args.scrub_interval is not None and args.scrub_interval <= 0:
        ap.error("--scrub-interval must be a positive dispatch count")
    if args.scrub_mode is not None and args.scrub_interval is None:
        ap.error("--scrub-mode does nothing without --scrub-interval "
                 "(scrubbing is off)")
    scrub_mode = args.scrub_mode or "steered"
    if ((args.seu_at is not None or args.seu_rate > 0)
            and args.redundancy != "tmr" and args.scrub_interval is None):
        ap.error(
            "--seu-at/--seu-rate need --redundancy tmr (the vote masks "
            "the fault) and/or --scrub-interval (CRC detection heals it); "
            "an unprotected, unscrubbed server would keep serving "
            "corrupted scores")
    if args.deadline_us is not None and args.deadline_us <= 0:
        ap.error("--deadline-us must be a positive latency budget")
    if args.overload_policy is not None and args.deadline_us is None:
        ap.error("--overload-policy does nothing without --deadline-us "
                 "(there is no budget to act on)")
    overload_policy = args.overload_policy or "observe"

    print(f"training {args.chips} chips ...")
    chips = [
        train_chip(seed=2024 + i, depth=5 - (i % 2), leaves=10 - (i % 3))
        for i in range(args.chips)
    ]
    server = ReadoutServer(chips, ServerConfig(
        max_batch=args.max_batch, max_latency_s=50e-3, backend=args.backend,
        redundancy=args.redundancy, sparse=args.sparse,
        scrub_interval=args.scrub_interval, scrub_mode=scrub_mode,
        deadline_us=args.deadline_us, overload_policy=overload_policy),
        device=args.device)
    geo = server.geometry
    mode = "host-featurized" if args.features else "fused frames"
    extras = []
    if args.redundancy == "tmr":
        extras.append("TMR 2-of-3 vote (3 replica slots/chip)")
    if args.sparse:
        extras.append("sparse trigger link")
    if args.scrub_interval is not None:
        extras.append(f"config scrubbing every {args.scrub_interval} "
                      f"dispatches ({scrub_mode})")
    if args.deadline_us is not None:
        extras.append(f"deadline {args.deadline_us:.0f} us "
                      f"({overload_policy})")
    print(f"server online on {server.device}: {server.n_chips} chips, "
          f"{mode} ingestion, one stacked dispatch (levels={geo.n_levels}, "
          f"widest={geo.max_level_size}, inputs={geo.n_inputs}, "
          f"outputs={geo.n_outputs}, features={geo.frontend.n_features})"
          + (" [" + ", ".join(extras) + "]" if extras else ""))

    stream = FrameStream(FrameStreamConfig(
        n_sensors=args.chips, batch=args.batch))
    seu_rng = np.random.default_rng(2026)
    # monotonic: the server's latency ledger runs on the same clock
    # family, and wall-clock jumps (NTP) must not skew either
    t0 = time.monotonic()
    for bi in range(args.rate_batches):
        if bi == args.reconfigure_at:
            # live reconfiguration: new model into slot 0, stream keeps going
            server.reconfigure(0, train_chip(seed=31, depth=4, leaves=8))
            print(f"[batch {bi}] RECONFIGURED chip 0: new bitstream + encode "
                  "plan swapped into the stack (no recompile)")
        if bi == args.seu_at:
            # radiation strikes: one config bit of one replica flips. The
            # vote masks it (TMR) and/or the scrubber repairs it.
            replica = 1 if args.redundancy == "tmr" else 0
            server.inject_seu(0, replica=replica, lut_index=3, bit=7)
            print(f"[batch {bi}] SEU INJECTED: chip 0 replica {replica}, "
                  "LUT 3 bit 7 — watch the disagreement counters and the "
                  "scrub report")
        for _ in range(seu_rng.poisson(args.seu_rate)):
            slot = int(seu_rng.integers(0, args.chips))
            replica = int(seu_rng.integers(0, server.n_replicas))
            n = server.chips[slot].config.n_luts
            li = int(seu_rng.integers(0, n))
            b = int(seu_rng.integers(0, 16))
            server.inject_seu(slot, replica=replica, lut_index=li, bit=b)
            print(f"[batch {bi}] SEU INJECTED (poisson): chip {slot} "
                  f"replica {replica}, LUT {li} bit {b}")
        for c in range(args.chips):
            block = stream.batch_at(bi, c)
            if args.features:
                server.submit_batch(c, block["features"])
            else:
                server.submit_frames(c, block["frames"], block["y0"])
        server.poll()
        if (bi + 1) % 3 == 0:
            r = server.report()
            print(f"[batch {bi+1:3d}] in={r['n_in']:,} kept="
                  f"{r['fraction_kept']:.1%} queue={r['queue_depth']} "
                  f"inflight={r['inflight_batches']}")
    server.flush()

    r = server.report()
    dt = time.monotonic() - t0
    print(f"\ndone in {dt:.1f}s — {r['n_in']:,} events through "
          f"{r['n_chips']} chips ({r['n_in']/dt:,.0f} ev/s incl. host sim)")
    print("per-stage timing (seconds / calls; dispatch_device is device "
          "time, the rest host time):")
    for stage, t in r["stages"].items():
        print(f"  {stage:18s} {t['seconds']:8.3f}s  x{t['calls']}")
    for pc in r["per_chip"]:
        seu = (f", SEU disagreements {pc['seu_disagreements']}"
               if r["redundancy"] == "tmr" else "")
        print(f"  chip {pc['chip']}: kept {pc['fraction_kept']:.1%} "
              f"(x{pc['data_reduction_factor']:.2f} reduction, "
              f"link {pc['link_rate_in_gbps']:.0f} -> "
              f"{pc['link_rate_out_gbps']:.1f} Gb/s, "
              f"{pc['n_dispatches']} dispatches{seu})")
    lb = r["link_bytes"]
    if r["sparse"]:
        print(f"host link: {lb['on_wire']:,} B on the sparse wire vs "
              f"{lb['dense_equivalent']:,} B dense "
              f"(x{lb['wire_reduction']:.2f} reduction)")
    if args.deadline_us is not None:
        dd = r["deadline"]
        lt = r["latency"]["total"]
        print(f"deadline {dd['deadline_us']:.0f} us ({dd['policy']}): "
              f"{dd['met']:,} met / {dd['missed']:,} missed "
              f"({dd['miss_fraction']:.1%}) / {dd['shed']:,} shed — "
              f"latency p50 {lt['p50_us']:.0f} us, p99 {lt['p99_us']:.0f} "
              f"us, p99.9 {lt['p999_us']:.0f} us")
        lad = dd["ladder"]
        if lad["transitions"]:
            steps = ", ".join(
                f"{t['direction']} {t['rung']} (miss {t['miss_frac']:.0%})"
                for t in lad["transitions"])
            print(f"degrade ladder: level {lad['level']} "
                  f"[{', '.join(lad['active_rungs']) or 'none'}] — {steps}")
    sc = r["scrub"]
    if sc["enabled"]:
        lat = sc["detection_latency_dispatches"]
        print(f"scrubbing ({sc['mode']}, every {sc['interval']} "
              f"dispatches): {sc['frames_scrubbed']} frames scrubbed in "
              f"{sc['steps']} steps ({sc['cycles']} full cycles), "
              f"{sc['detections']} upsets detected, {sc['healed_bits']} "
              f"config bits healed, detection latency mean "
              f"{lat['mean']:.1f} / max {lat['max']} dispatches")
    return r


if __name__ == "__main__":
    main()
