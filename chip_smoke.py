#!/usr/bin/env python3
"""Build and drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device  — CUDA must be present (else exit 2, no result).
  2. build   — nvcc builds every kernel source of the main path, in
               parallel, from src/repro_torch/kernels/csrc.
  3. kernels — each kernel against its plain PyTorch twin on the card, at
               the served shape (512 events per chip per dispatch) and
               at a larger one: the featurizer (K1) at C=4, B=512 and
               B=8192 within |d| <= 2e-5 |x| + 1e-6 ke (summation order);
               the bit-sliced fabric walk (K2) on the 4-chip envelope, 16
               and 256 words, R=1 and R=3: exact. Times from CUDA events
               at the larger shape.
  4. serve   — the readout server (ServerConfig() defaults, on cuda) takes
               8 FrameStream batches of 256 events per sensor from 4
               trained chips, hot-swaps chip 0 at batch 4 and flushes;
               every (score, keep) must equal the numpy oracle
               (encode_features -> FabricSim -> decode_outputs) fed with
               the featurizer kernel's own features. Repeated with
               redundancy="tmr": 0 disagreements. Launch counters are
               zeroed before and read after each run; both must be > 0.
Then a `kernels` JSON line, the card's name and power limit, and the
final line {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# H100 SXM 32-bit integer/logic rate: 64 INT32 lanes per SM against the
# 128 FP32 lanes (an FMA counted as two operations) of the published
# 67 TFLOP/s float32 peak, at the same SM count and clock
INT_OPS_PER_S = 67e12 / 4
N_CHIPS = 4
K1_BATCH = 8192
K2_WORDS = 256
SERVE_BATCHES = 8
SERVE_EVENTS = 256
RECONFIGURE_AT = 4
# events per chip in one served dispatch: ServerConfig().max_batch (2048)
# events over the 4 chips
SERVED_B = 2048 // N_CHIPS


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(phase, msg):
    emit(phase, ok=False, error=msg)
    sys.exit(1)


def time_ms(fn, reps=20, inner=5, warm=3):
    """Median over `reps` CUDA-event samples of `inner` back-to-back calls."""
    import numpy as np
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return float(np.median(samples))


def train_chip(seed, depth, leaves, threshold=0.97):
    """examples/serve_readout.py's chip recipe, through the port's copy of
    the synthesis toolchain."""
    from repro_torch.core.bdt import GradientBoostedClassifier
    from repro_torch.core.readout import ReadoutChip
    from repro_torch.data.smartpixel import (
        SmartPixelConfig, generate, train_test_split)

    data = generate(SmartPixelConfig(n_events=30_000, seed=seed))
    tr, _ = train_test_split(data)
    clf = GradientBoostedClassifier(
        n_estimators=1, max_depth=depth, max_leaf_nodes=leaves,
        min_samples_leaf=500,
    ).fit(tr["features"], tr["label"])
    chip = ReadoutChip.build(clf, fabric="efpga_28nm")
    chip.calibrate(tr["features"], tr["label"], target_sig_eff=threshold)
    return chip


def k1_inputs(torch, C, B, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (C, B, 8, 13, 21)
    hits = torch.rand(shape, generator=g, device="cuda") < 0.05
    frames = (torch.randn(shape, generator=g, device="cuda").abs() * 900.0
              * hits + torch.randn(shape, generator=g, device="cuda") * 40.0)
    y0 = torch.randn((C, B), generator=g, device="cuda") * 10.0
    return frames, y0


def check_k1(torch, yp):
    """K1 against its twin at the served shape (C=4, B=SERVED_B) and at
    C=4, B=8192; times and bound at the larger."""
    thr = 800.0
    max_err = 0.0
    for B in (SERVED_B, K1_BATCH):
        frames, y0 = k1_inputs(torch, N_CHIPS, B, seed=11 + B)
        got = yp.yprofile_traced(frames, y0, threshold=thr)
        want = yp.yprofile_plain(frames, y0, thr)
        torch.cuda.synchronize()
        if got.shape != (N_CHIPS, B, 128) or not torch.isfinite(got).all():
            fail("kernels", f"yprofile B={B}: bad shape or non-finite output")
        err = (got - want).abs()
        bad = int((err > 2e-5 * want.abs() + 1e-6).sum())
        if bad:
            fail("kernels", f"yprofile B={B}: {bad} features outside "
                            f"tolerance (max |d| {float(err.max())})")
        max_err = max(max_err, float(err.max()))
    nbytes = frames.numel() * 4 + y0.numel() * 4 + got.numel() * 4
    out = torch.empty_like(got)
    return {
        "name": "yprofile",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/yprofile.cu",
        "replaces": "src/repro/kernels/yprofile/yprofile.py:78",
        "checked_batches": [SERVED_B, K1_BATCH],
        "timed_shape": list(frames.shape),
        "max_abs_err": max_err,
        "tolerance": "|d| <= 2e-5*|x| + 1e-6 ke",
        # the launch alone, into a preallocated output
        "ms": time_ms(lambda: yp._launch(frames, y0, thr, out)),
        "plain_ms": time_ms(lambda: yp.yprofile_plain(frames, y0, thr)),
        "library_ms": time_ms(lambda: torch.sum(frames, dim=(2, 4))),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bytes": nbytes,
    }


def check_k2(torch, np, bs, lut_ops, chips):
    """K2 on the 4-chip envelope against its twin, R=1 and R=3, at the
    served width (W=SERVED_B/32) and at W=256: exact, also on a TMR stack
    with one upset replica. Times and bound at W=256."""
    configs = [c.config for c in chips]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(12)
    out = {}
    for red in ("none", "tmr"):
        stack = lut_ops.pack_fabrics(configs, redundancy=red, device="cuda")
        R = stack.n_replicas
        # replica 1 of chip 0 upset, so that the disagreement words are
        # not trivially zero under TMR
        upset = stack.tables.clone()
        if R > 1:
            upset[1, :, :8, ::3] = 1.0 - upset[1, :, :8, ::3]
        tiles = {}
        for W in (SERVED_B // 32, K2_WORDS):
            bits = torch.as_tensor(
                rng.integers(0, 2, (N_CHIPS, W * 32, stack.n_inputs)),
                dtype=torch.int32, device="cuda")
            seg = bs.input_words(bits, stack.n_inputs, stack.in_seg)
            for tb in (stack.tables, upset):
                a = (stack.src, tb, stack.output_nets, seg, R)
                got = bs.eval_seg_voted(*a)
                want = bs.eval_seg_voted_plain(*a)
                torch.cuda.synchronize()
                for x, y, what in zip(got, want, ("voted", "disagree")):
                    if x.shape != y.shape or not torch.equal(x, y):
                        fail("kernels", f"bitsliced R={R} W={W}: {what} "
                                        f"words differ in "
                                        f"{int((x != y).sum())} places")
            if R > 1 and not bool((got[1] != 0).any()):
                fail("kernels", f"bitsliced R={R} W={W}: an upset replica "
                                "gave no disagreement words")
            C, _, in_seg = seg.shape
            L, M, O = stack.n_levels, stack.m_pad, stack.n_outputs
            tiles[W] = bs.word_tile(R, in_seg + L * M, W, C, n_sms)
        # timed on what the last pass left: the W=K2_WORDS inputs
        args = (stack.src, stack.tables, stack.output_nets, seg, R)
        n_luts = sum(c.n_luts for c in configs)
        # least work: one LOP3 per two-way select (15 per replica, word
        # and real LUT), 16 table-to-mask selects per replica and LUT, and
        # per (word, output) one LOP3 for the 2-of-3 vote and one per
        # replica for the disagreement word
        ops = (15 * R * W * n_luts + 16 * R * n_luts
               + (C * W * O * (1 + R) if R > 1 else 0))
        nbytes = (seg.numel() * 4 + stack.src.numel() * 4
                  + stack.tables.numel() * 4 + stack.output_nets.numel() * 4
                  + C * W * O * 4 + C * R * W * 4)
        t_ops, t_bytes = ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        tile = tiles[W]
        voted = torch.empty((C, W, O), dtype=torch.int32, device="cuda")
        dis = torch.empty((C, R, W), dtype=torch.int32, device="cuda")
        out[f"R{R}"] = {
            "words": W, "luts": n_luts, "in_seg": in_seg, "levels": L,
            "m_pad": M, "outputs": O,
            "tile": {str(w): t for w, t in tiles.items()},
            "ms": time_ms(lambda: bs._launch(
                stack.src, stack.tables, stack.output_nets, seg, voted,
                dis, R, tile), inner=20),
            "plain_ms": time_ms(lambda: bs.eval_seg_voted_plain(*args),
                                reps=10, inner=1),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes,
        }
    return {
        "name": "eval_words_voted",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitsliced.cu",
        "replaces": "src/repro/kernels/lut_eval/bitsliced.py:198",
        "checked_words": [SERVED_B // 32, K2_WORDS],
        "max_abs_err": 0.0,
        "library_ms": None,
        "runs": out,
    }


def serve(torch, np, chips, swap_chip, blocks, redundancy, yp, bs):
    """One server run over the pre-generated blocks; returns its results
    checked against the oracle, with the launch counts of the run."""
    from repro_torch.core.fabric import FabricSim
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    server = ReadoutServer(list(chips), ServerConfig(redundancy=redundancy),
                           device="cuda")
    yp.yprofile_traced.launches = 0
    bs.eval_seg_voted.launches = 0
    where = {}                       # seq -> (step, sensor, row)
    results = []
    for step in range(SERVE_BATCHES):
        if step == RECONFIGURE_AT:
            results += server.reconfigure(0, swap_chip)
        for s in range(N_CHIPS):
            blk = blocks[step][s]
            for row, seq in enumerate(
                    server.submit_frames(s, blk["frames"], blk["y0"])):
                where[seq] = (step, s, row)
            results += server.poll()
    results += server.flush()
    torch.cuda.synchronize()
    launches = {"yprofile": yp.yprofile_traced.launches,
                "eval_words_voted": bs.eval_seg_voted.launches}
    rep = server.report()

    seqs = [r.seq for r in results]
    if sorted(seqs) != sorted(where) or len(set(seqs)) != len(seqs):
        fail("serve", f"{redundancy}: drained {len(seqs)} results for "
                      f"{len(where)} submitted events (or duplicates)")
    got = {r.seq: (r.score_raw, r.keep) for r in results}
    mism = 0
    for step in range(SERVE_BATCHES):
        for s in range(N_CHIPS):
            chip = swap_chip if (s == 0 and step >= RECONFIGURE_AT) \
                else chips[s]
            blk = blocks[step][s]
            feats = yp.yprofile(blk["frames"], blk["y0"],
                                device="cuda").cpu().numpy()
            outs, _ = FabricSim(chip.config).run(chip.encode_features(feats))
            score = chip.synth.decode_outputs(np.asarray(outs))
            keep = score <= chip.score_threshold_raw
            seq_of = {row: q for q, (st, ss, row) in where.items()
                      if st == step and ss == s}
            for row in range(len(score)):
                if got[seq_of[row]] != (int(score[row]), bool(keep[row])):
                    mism += 1
    if mism:
        fail("serve", f"{redundancy}: {mism} events differ from the oracle")
    if rep["seu_disagreement_total"]:
        fail("serve", f"{redundancy}: {rep['seu_disagreement_total']} "
                      "replica disagreements on a healthy stack")
    for k, n in launches.items():
        if n <= 0:
            fail("serve", f"{redundancy}: kernel {k} never launched")
    return {"redundancy": redundancy, "events": len(results),
            "oracle_mismatches": mism,
            "disagreements": rep["seu_disagreement_total"],
            "launches": launches, "events_per_s": rep["events_per_s"],
            "fraction_kept": rep["fraction_kept"],
            "stages": rep["stages"]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.data.pipeline import FrameStream, FrameStreamConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_eval import bitsliced as bs
    from repro_torch.kernels.lut_eval import ops as lut_ops
    from repro_torch.kernels.yprofile import ops as yp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    emit("device", ok=True, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.monotonic()
    built = build.build()
    emit("build", ok=True, seconds=time.monotonic() - t0,
         kernels={k: {"seconds": v["seconds"], "cached": v["cached"],
                      "ptxas": [ln for ln in str(v["ptxas"]).splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in built.items()})

    t0 = time.monotonic()
    chips = [train_chip(2024 + i, depth=5 - (i % 2), leaves=10 - (i % 3))
             for i in range(N_CHIPS)]
    swap_chip = train_chip(31, depth=4, leaves=8)
    emit("train", ok=True, seconds=time.monotonic() - t0,
         luts=[c.config.n_luts for c in chips],
         levels=[len(c.config.level_sizes) for c in chips])

    k1 = check_k1(torch, yp)
    emit("kernel_yprofile", ok=True, **k1)
    k2 = check_k2(torch, np, bs, lut_ops, chips)
    emit("kernel_eval_words_voted", ok=True, **k2)

    stream = FrameStream(FrameStreamConfig(n_sensors=N_CHIPS,
                                           batch=SERVE_EVENTS))
    blocks = [[stream.batch_at(step, s) for s in range(N_CHIPS)]
              for step in range(SERVE_BATCHES)]
    runs = {}
    for red in ("none", "tmr"):
        runs[red] = serve(torch, np, chips, swap_chip, blocks, red, yp, bs)
        emit("serve", ok=True, card=card, **runs[red])

    kernels = []
    # K2's row carries the times of its R=3 (TMR) run
    for k, t, key in ((k1, k1, "yprofile"),
                      (k2, k2["runs"]["R3"], "eval_words_voted")):
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": runs["none"]["launches"][key],
            "max_abs_err": k["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": k["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
