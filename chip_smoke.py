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
               and 256 words, R=1 and R=3: exact, timed at both widths.
               Times from CUDA events at the larger shape; K2's and B4's
               `ms` from replaying a CUDA graph of the calls (`stream_ms`
               back to back from the host, whose launch cost sets calls
               this short).
               The selection-matmul fabric kernels, dense (B2) and
               banded (B3), on the same envelope at the served shape
               (C=4, B=512), with its TMR rows (12 rows, B=512), and on a
               synthetic 0/1 sel of the 4-row stack's shape (empty
               columns, one 1, two, and more than the kernel's column
               lists hold, at random rows of the window): the whole
               (C, B, N) net buffer exact. B2/B3 bounds count the ones of
               sel times the events (a gather), beside the dense
               tensor-core product count (dense_product_bound_ms). The
               BDT kernel (B4) on the paper's chip at B=512 and
               B=65,536, and on synthetic arrays that leave the one-hot
               form (BDT_RECIPES: the kernel's literal path) or keep it at
               extreme leaf values: exact. Its bound counts the walk (bytes
               bound it), beside the product form's count.
               The egress kernel (B6, one launch an entry): its
               decode-pack and dense entries on K2's voted/disagreement
               words of the served stack (W=16, R=1 and R=3 with an upset
               replica; launched alone and right behind the walk as its
               programmatic dependent) and on synthetic words at W=16 and
               W=2,048 (65,536 events a chip), for the decode rows
               B6_WEIGHTS (the sign at bit 0, at bit 30, no negative
               weight; the dense entry also arbitrary int32 weights) and
               keep fractions 0, ~1%, ~50%, 100%, with valid tails that
               end mid-word; its keep-words entry through
               compression.sparse_trigger_pack on (4, 512) and (4, 8)
               event masks: (count, idx, vals, dis) and (score, keep,
               dis) exact. All three entries timed at both widths by
               CUDA-graph replay and back to back; bound by bytes.
  4. serve   — the readout server (ServerConfig() defaults, on cuda) takes
               8 FrameStream batches of 256 events per sensor from 4
               trained chips, hot-swaps chip 0 at batch 4 and flushes;
               every (score, keep) must equal the numpy oracle
               (encode_features -> FabricSim -> decode_outputs) fed with
               the featurizer kernel's own features. Repeated with
               redundancy="tmr": 0 disagreements. Launch counters are
               zeroed before and read after each run; the featurizer's,
               the walk's and B6's dense entry's must be > 0.
               Every served run also checks its link bytes.
  5. §5      — the paper's proof of concept: examples/smartpixel_readout.py's
               chip (500,000 events, seed 2024, 1 tree of depth 5 with 10
               leaves, efpga_28nm) checked against its golden BDT with
               ReadoutChip.verify_vs_golden through KernelBackend on cuda,
               on every event in 65,536-event chunks: the default layout
               (banded, B3), then band=False (dense, B2), then the
               bit-sliced layout (K2, for its rate), then bdt_infer (B4)
               on the same raw features. Every event must match; B3 and B2
               are also held against their twin on the whole net buffer
               of the first full chunk (C=1, B=65,536), exact, and timed
               there beside the twin and the chunk's bounds. The
               counters are zeroed before and read after, and each of B2,
               B3 and B4 must have launched.
  6. serve   — phase 4 again with ServerConfig(layout="matmul"), plain and
     matmul    TMR: every event equal to the oracle, 0 disagreements, the
               featurizer and the selection-matmul kernel launched.
  7. serve   — phase 4's stream with sparse=True, plain and TMR, bit-sliced
     sparse    (K2 -> B6's decode entry) then layout="matmul" (B3 -> B6's
               keep-words entry): the drained events exactly the oracle's
               kept set (seq, chip, score), per-chip (n_in, n_kept) equal
               to the dense run's, 0 disagreements, link bytes 4 per
               batch + 8 per kept event on the wire and 5 per event dense,
               B6 launched.
  8. serve   — the stream's features (the featurizer kernel's, on the
     features  host) through submit_batch, both layouts, plain and TMR,
               dense and sparse: every result equal to the oracle on those
               features; K2 (bit-sliced) or B3 (matmul) launched, and B6
               when sparse.
  9. serve   — the scrub/SEU loop on the stream without its hot swap
     scrub     (7 batches, a flush, one batch more: 8,192 events),
               scrub_interval=1: TMR bit-sliced and matmul, steered and
               round-robin, then plain (CRC-only) bit-sliced. Before batch
               3, inject_seu flips one output-changing bit (searched with
               the numpy FabricSim oracle) of the replica frame the
               round-robin pointer samples next. Checks: under TMR every
               event equal to the oracle, without it every event submitted
               after the heal; one detection and one healed bit; the upset
               replica's counter climbed and stays after the heal; every
               frame verifies at the end; K1, K2 or B3, and (bit-sliced)
               B6's dense entry launched. Then served events/s of the TMR
               stream with scrub on and off, alternating rounds.
 10. serve   — deadline admission on the same stream, defaults: first
     deadline  overload_policy="observe" (10 ms deadline; latency p50,
               p99, p99.9), then "degrade" with the sparse_egress rung
               only, at half the first run's service p50. Checks: every
               drained event equal to the oracle, every admitted event
               missing from the drain dropped by the oracle, every shed
               submission None and counted, n_in + n_shed the submitted
               count a chip, a ladder transition, B6's decode-pack entry
               launched after it.
 11. serve   — the network front door (repro_torch/net) over the 4
     net       served chips, ServerConfig() on cuda, plain then TMR: the
               in-process submit_frames burst rate of 8,192 events, the
               same paced at half of it, then one replay client a sensor
               on loopback: TCP paced at half the burst rate, TCP
               unpaced (32 batches of 64 events a sensor each) and UDP
               (16 datagrams of 7 events a sensor at 100 events/s a
               sensor). Checks: every trigger verified against
               host_oracle on the card (K1, then numpy), each client's
               events_in == admitted + shed + queue_dropped + bad_sensor,
               0 TMR disagreements, K1, K2 and B6's dense entry launched.
               Prints events/s on the wire and in-process, their ratio,
               latency p50/p99 a client and wire bytes an event each way.
 12. examples — examples/torch_serve_readout.py --chips 2 --rate-batches 4
               and examples/torch_replay_load.py --sensors 2 --batches 8 as
               subprocesses on the card: exit 0, no mismatch printed.
 13. fleet   — the multi-tenant fleet (repro_torch/launch/fleet.py): the
               4 served chips and two more (depth 3 with 5 leaves, in an
               envelope of its own; depth 5 with 10 leaves) as six
               tenants, two slots a bucket, 6 FrameStream batches of 256
               events a tenant through submit_frames, in four runs:
               ServerConfig() (bit-sliced, plain), redundancy="tmr",
               layout="matmul" and tenant_quota_queued=128. Each bucket
               is opened by a founding tenant that serves one block and is
               retired. In the run: the sixth
               tenant's first batch at step 2 (a warm admission into a
               full bucket), LRU evictions and golden re-admissions as the
               stream goes round, one evict(drain=False). Checks: every
               delivered (seq, tenant, score, keep) equal to the oracle,
               every ledger closed with nothing outstanding, only the
               cancelled events missing, 0 disagreements, K1, K2 and B6's
               dense entry (B3 in the matmul run) launched, no admission
               miss (ReadoutServer.shape_misses, read to each admitted
               tenant's first result), every bucket's stack, encode plan,
               staging and copy stream where the founders left them. Then bench_fleet.py's numbers (cold and warm
               admission, evict + golden re-admit, the in-place swap in
               both layouts, events/s at 2, 16 and 64 tenants of 16
               events), K2 and B6's dense entry at the served chips'
               bucket envelope (16 levels, 31 outputs) against the union
               (13, 28): exact against their twins, K2 timed at W=16; the
               deep 4-tree ensemble's envelope (32 x 256) plain and under
               TMR, every event exact against the oracle, K2 launched (under
               TMR its split walk: a block a replica, then the vote pass),
               then K2 alone on each bucket's stack at W=16 exact against
               its twin (an upset replica under TMR) and timed; and a
               TCP replay through the front door with sensor_tenants in
               front of a fleet: sensors 0-3 verified, an unmapped and a
               retired tenant's sensor counted as events_bad_sensor.
 14. lm      — the dense LM serving path (repro_torch/models,
               launch/serve.py), plain PyTorch on the card: TINY and the
               smoke config of every dense arch and the VLM backbone, f32
               with TF32 off, the same weights on the card and the CPU: 8
               teacher-forced decode steps, logits within 1e-4 with f32 KV
               caches; with int8 caches within 1e-2, the int8 entries that
               differ (a float32 K at a rounding boundary) counted, each at
               most one step off, under 0.1% of those written; gemma-7b
               (bf16, int8 KV cache) and starcoder2-7b
               (bf16 cache) at full width and depth, batch 8, prompt 32
               (prefilled token by token), 64 greedy tokens through
               serve.build / serve.generate: prefill s, tokens/s, ms a
               step against its HBM bound, peak memory; gemma-7b at full
               width with 2 layers: decode against forward (rtol = atol =
               2e-2) in f32, as tests/test_models.py holds its f32 smoke
               configs (bf16 recorded), and the int8 cache against the bf16
               one on bf16 weights (max |dp| < 0.05, top-1 equal). Then the
               paper's NN baseline
               (core/nn_baseline.py) trained on the card on the §5
               training split, with its LUT cost.
 15. lm      — the MoE, SSM, hybrid and encoder-decoder families
     families  (repro_torch/models/{moe,ssm,hybrid,encdec}.py), plain
               PyTorch on the card, after phase 14's models are freed:
               the smoke configs of deepseek-moe-16b, grok-1-314b,
               mamba2-130m, zamba2-1.2b and whisper-tiny, f32 with TF32
               off, the same weights on the card and the CPU, 8
               teacher-forced decode steps within 1e-4 (the MoE's also
               with int8 caches, under phase 14's int8 rule); decode
               against forward over 16 tokens (MoE at capacity factor 16
               within 2e-2, SSM 3e-2, hybrid and encdec 2e-2) at the smoke
               configs and at full width with 2 layers, f32 weights and
               cache;
               deepseek-moe-16b, mamba2-130m, zamba2-1.2b and whisper-tiny
               (random encoder input at enc_len 1,500) at full width and
               depth in bf16 through serve.build / serve.generate, batch
               8, prompt 32, 64 greedy tokens: finite logits, tokens in
               the vocabulary, prefill s, tokens/s, ms a step against its
               HBM bound, peak memory. grok-1-314b (427 GB in bf16) runs
               only at its smoke width.
 16. lm      — the LM training path (repro_torch/train, launch/train.py):
     train     the family smoke configs card against CPU, TINY through the
               driver with resume, gemma-7b x 4 layers and mamba2-130m at
               full width.
 17. lm      — the sharded training path (parallel/{sharding,compression,
     sharded   hlo_analysis,transport}.py, launch/{specs,dryrun}.py,
               train/{train_step,elastic}.py over DTensors), plain
               PyTorch. (b) two ranks spawned on cuda:0 in a gloo world
               (NCCL refuses two ranks on one card; every collective is
               staged through the host): gemma-7b at full width cut to 2
               layers, f32, batch 8 x 256, 3 AdamW steps on a (pod=2,
               data=1, model=1) mesh with the int8 pod reduction (grads
               of the first batch within 4 (2 max|g| / 254 + 1e-5) of the
               exact one-rank grads, loss within 1e-4 relative; losses
               and params against the same compressed step on one rank
               (its grads bit-equal to the pod ranks', its params under
               train_param_diff's rule); the int8 all-gather
               wire bytes equal N + 4 x leaves) and on a (data=2,
               model=1) mesh without compression (against the one-rank
               step, same rule), ms a step; (c) TINY and its AdamW state
               resharded onto the (2, 1) plan and back, bit-equal. (a)
               the dry-run of gemma-7b train_4k on both production
               meshes, gemma-7b decode_32k and mamba2-130m train_4k on
               the single pod (deepseek-moe-16b train_4k takes 247 s
               alone and is left to the dry-run's CLI), full width and
               depth, one CPU process a cell (a fake world of 256 or 512
               ranks, fake tensors: no device memory), each with FLOPs
               and at least one collective: fits_hbm, peak GiB, wire
               bytes, seconds.
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
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores
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
# B6 (egress): words a chip at the large shape (65,536 events), the keep
# fractions, and the decode-weight rows of the synthetic words (the dense
# entry also takes arbitrary int32 rows)
B6_WORDS = 2048
B6_FRACTIONS = (0.0, 0.01, 0.5, 1.0)
B6_WEIGHTS = ("plan", "sign_bit0", "sign_bit30", "no_negative")
B6_DENSE_WEIGHTS = B6_WEIGHTS + ("arbitrary",)
# examples/smartpixel_readout.py: events, seed, chunk
S5_EVENTS = 500_000
S5_SEED = 2024
S5_CHUNK = 65_536


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


def graph_ms(fn, reps=20, inner=20):
    """Median over `reps` CUDA-event samples of one replay of a CUDA
    graph holding `inner` calls of `fn`, per call: the device's time
    without the host's launch cost, which sets the back-to-back time of
    a kernel of a few microseconds. `fn` must launch on the current
    stream, read when it is called; it is warmed up and captured on one
    side stream (B6 keeps its state a stream)."""
    import numpy as np
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
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
    with one upset replica. Times and bound at both widths."""
    configs = [c.config for c in chips]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(12)
    n_luts = sum(c.n_luts for c in configs)
    out = {}
    for red in ("none", "tmr"):
        stack = lut_ops.pack_fabrics(configs, redundancy=red,
                                     layout="bitsliced", device="cuda")
        R = stack.n_replicas
        # replica 1 of chip 0 upset, so that the disagreement words are
        # not trivially zero under TMR
        upset = stack.tables.clone()
        if R > 1:
            upset[1, :, :8, ::3] = 1.0 - upset[1, :, :8, ::3]
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
            tile = bs.word_tile(R, in_seg, L, M, W, C, n_sms)
            scratch = bs.scratch_for(C, R, L, M, "cuda")
            args = (stack.src, stack.tables, stack.output_nets, seg, R)
            ops, nbytes = k2_cost(stack, seg, n_luts)
            t_ops, t_bytes = ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S
            voted = torch.empty((C, W, O), dtype=torch.int32, device="cuda")
            dis = torch.empty((C, R, W), dtype=torch.int32, device="cuda")

            def k2_call():
                bs._launch(stack.src, stack.tables, stack.output_nets, seg,
                           scratch, voted, dis, R, tile)
            out[f"R{R}_W{W}"] = {
                "words": W, "luts": n_luts, "in_seg": in_seg, "levels": L,
                "m_pad": M, "outputs": O, "tile": tile,
                # both passes, the descriptors and the walk: replayed from
                # a CUDA graph, and back to back from the host, whose
                # launch cost sets a call this short
                "ms": graph_ms(k2_call),
                "stream_ms": time_ms(k2_call, inner=20),
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


def k2_cost(stack, seg, n_luts):
    """(operations, bytes) of the least work of one K2 call over input
    words ``seg`` (C, W, in_seg): one LOP3 per two-way select (15 per
    replica, word and real LUT), 16 table-to-mask selects per replica and
    LUT, and per (word, output) one LOP3 for the 2-of-3 vote and one per
    replica for the disagreement word; every input read once, the voted
    and disagreement words written once. Padded levels and slots cost
    nothing here."""
    C, W, _ = seg.shape
    R, O = stack.n_replicas, stack.n_outputs
    ops = (15 * R * W * n_luts + 16 * R * n_luts
           + (C * W * O * (1 + R) if R > 1 else 0))
    nbytes = (seg.numel() * 4 + stack.src.numel() * 4
              + stack.tables.numel() * 4 + stack.output_nets.numel() * 4
              + C * W * O * 4 + C * R * W * 4)
    return ops, nbytes


def synthetic_sel(np, shape, seed):
    """A 0/1 selection of `shape` (C, L, rows, 4M) that no packing makes:
    each column holds 0, 1, 2 or LIST_CAP + 1 ones (about 40/40/10/10%)
    at random rows, so some read window rows of levels not written yet,
    or of the level's own slots, and the several-ones columns go past the
    kernel's column lists."""
    from repro_torch.kernels.lut_eval.lut_eval import LIST_CAP

    C, L, rows, M4 = shape
    rng = np.random.default_rng(seed)
    sel = np.zeros(shape, np.float32)
    count = rng.choice([0, 1, 2, LIST_CAP + 1], size=(C, L, M4),
                       p=[0.4, 0.4, 0.1, 0.1])
    at = rng.integers(0, rows, size=(C, L, M4, LIST_CAP + 1))
    c, l, j, p = np.nonzero(np.arange(LIST_CAP + 1) < count[..., None])
    sel[c, l, at[c, l, j, p], j] = 1.0
    return sel, count


def lut_counts(sel, tables, ext, out, win):
    """Bytes and operations of one B2/B3 call on these inputs: bits in,
    sel, tables, level_base (and win_base), the buffer out; the ones of
    sel times the events plus 4M index/table steps per level and event;
    and the dense tensor-core product count it replaced."""
    C, L, n_rows, M4 = sel.shape
    B, N = out.shape[1], out.shape[2]
    nbytes = (ext.numel() * 4 + sel.numel() * 2 + tables.numel() * 4
              + L * 4 * (1 if win is None else 2) + C * B * N * 4)
    ops = B * int((sel != 0).sum()) + C * B * L * M4
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    flops = 2 * C * B * L * n_rows * M4
    return {
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "dense_product_bound_ms": max(flops / BF16_FLOPS_PER_S,
                                      t_bytes) * 1e3,
        "ops": ops, "bytes": nbytes, "dense_product_flops": flops,
    }


def check_lut(torch, np, le, lut_ops, chips, band):
    """B2 (band=False: dense) or B3 (band=None: the 4-chip envelope packs
    banded) against its twin at the served shape, C=4 and B=SERVED_B, and
    on the TMR stack's 12 rows, then on a synthetic 0/1 sel of the
    4-chip stack's shape with empty, one-hot and several-ones columns:
    the whole net buffer exact. Times and bound on the 12 rows."""
    configs = [c.config for c in chips]
    layout = "dense" if band is False else "banded"
    name = "lut_eval" if band is False else "lut_eval_banded"
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(13)

    def run(stack, sel, tables, ext, what):
        win = stack.win_base if stack.banded else None
        fn = (le.lut_eval_banded_stacked if stack.banded
              else le.lut_eval_stacked)
        got = fn(ext, sel, tables, stack.level_base,
                 *([win] if stack.banded else []),
                 n_nets_pad=stack.n_nets_pad)
        want = le.lut_eval_plain(ext, sel, tables, stack.level_base, win,
                                 n_nets_pad=stack.n_nets_pad)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail("kernels", f"{name} {what}: net buffer differs in "
                            f"{int((got != want).sum())} places")
        return got, win

    checked = []
    for red in ("none", "tmr"):
        stack = lut_ops.pack_fabrics(configs, band=band, redundancy=red,
                                     device="cuda")
        if stack.layout != layout:
            fail("kernels", f"{name}: the envelope packs {stack.layout}, "
                            f"not {layout}")
        rows = stack.tables.shape[0]
        bits = torch.as_tensor(
            rng.integers(0, 2, (rows, SERVED_B, stack.n_inputs)),
            dtype=torch.int32, device="cuda")
        ext = lut_ops._bits_ext(bits, stack.n_inputs, stack.in_seg)
        if red == "none":
            sel, count = synthetic_sel(np, tuple(stack.sel.shape), seed=14)
            tables = torch.as_tensor(
                rng.integers(0, 2, tuple(stack.tables.shape)),
                dtype=torch.float32, device="cuda")
            run(stack, torch.as_tensor(sel, dtype=torch.bfloat16,
                                       device="cuda"), tables, ext,
                "synthetic sel")
            synthetic = {"columns_by_ones": {
                str(k): int((count == k).sum())
                for k in np.unique(count)}}
        got, win = run(stack, stack.sel, stack.tables, ext, f"rows={rows}")
        checked.append(rows)
    L, n_rows, M4 = stack.sel.shape[1], stack.sel.shape[2], stack.sel.shape[3]
    N = stack.n_nets_pad
    tile = le.lut_tile(N, M4 // 4, SERVED_B, rows, n_sms)
    out = torch.empty_like(got)
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_eval.cu",
        "replaces": ("src/repro/kernels/lut_eval/lut_eval.py:86"
                     if band is False else
                     "src/repro/kernels/lut_eval/lut_eval.py:167"),
        "checked_rows": checked, "events": SERVED_B, "levels": L,
        "sel_rows": n_rows, "n_nets_pad": N, "tile": tile,
        "synthetic": synthetic,
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: le._launch(ext, stack.sel, stack.tables,
                                         stack.level_base, win, out, tile)),
        "plain_ms": time_ms(lambda: le.lut_eval_plain(
            ext, stack.sel, stack.tables, stack.level_base, win,
            n_nets_pad=N), reps=10, inner=1),
        "library_ms": None,
        **lut_counts(stack.sel, stack.tables, ext, out, win),
    }


def b6_weights(np, recipe, C, O, seed):
    """(C, O) int32 decode-weight rows: "plan" as decode_plan makes them
    (28, 7, 1 or 16 outputs, the sign at the top one), or synthetic rows
    with the sign at bit 0, at bit 30 (O >= 31), no negative weight
    (every plane then reads output word 0), or arbitrary int32 values."""
    rng = np.random.default_rng(seed)
    w = np.zeros((C, O), np.int64)
    for c in range(C):
        if recipe == "plan":
            n = min((28, 7, 1, 16)[c % 4], O)
            w[c, :n] = 1 << np.arange(n)
            w[c, n - 1] = -(1 << (n - 1))
        elif recipe == "sign_bit0":
            w[c, 0] = -1
            w[c, 1:] = rng.integers(0, 2, O - 1)
        elif recipe == "sign_bit30":
            w[c, :30] = 1 << np.arange(30)
            w[c, 30] = -(1 << 30)
        elif recipe == "no_negative":
            w[c] = rng.integers(0, 4, O)
        elif recipe == "arbitrary":
            w[c] = rng.integers(-2**31, 2**31, O)
        else:
            raise ValueError(f"unknown weight recipe {recipe!r}")
    return w.astype(np.int32)


def b6_thresholds(torch, bs, voted, weight, valid, frac, dense=False):
    """Per-chip int32 cuts that keep about ``frac`` of the valid events
    of these words (0: below every score, 1: the int32 maximum): scores
    of the sparse entries' planes, or (``dense``) the weighted sums."""
    if dense:
        bits = bs.unpack_words(voted, voted.shape[1] * 32).to(torch.int64)
        scores = torch.sum(bits * weight[:, None, :].to(torch.int64), -1)
        scores = ((scores + 2**31) % 2**32 - 2**31).to(torch.int32)
    else:
        scores = bs.lane_scores(bs.sign_extended_planes(voted, weight))
    C = voted.shape[0]
    flat = scores.reshape(C, -1)[:, : valid.shape[1]]
    thr = []
    for c in range(C):
        s = torch.sort(flat[c][valid[c]].to(torch.int64)).values
        if frac >= 1.0 or not len(s):
            thr.append(2**31 - 1)
        elif frac <= 0.0:
            thr.append(max(int(s[0]) - 1, -2**31))
        else:
            thr.append(int(s[max(int(frac * len(s)) - 1, 0)]))
    return torch.as_tensor(thr, dtype=torch.int32, device=voted.device)


def b6_case(torch, np, bs, C, W, R, O, recipe, frac, seed, voted=None,
            dis=None, weight=None, dense=False):
    """One input set of B6's decode entries on the card: random (or
    given) voted words (C, W, O), disagreement words (C, R, W) and decode
    rows (of ``recipe``), cuts keeping about ``frac`` (of the dense
    entry's scores with ``dense``), and a valid mask whose tail ends 13
    events into the last word."""
    rng = np.random.default_rng(seed)
    if voted is None:
        voted = torch.as_tensor(rng.integers(-2**31, 2**31, (C, W, O)),
                                dtype=torch.int32, device="cuda")
    if dis is None:
        dis = torch.as_tensor(rng.integers(-2**31, 2**31, (C, R, W)),
                              dtype=torch.int32, device="cuda")
    B = W * 32 - 19
    valid = torch.as_tensor(rng.random((C, B)) < 0.97, device="cuda")
    if weight is None:
        weight = torch.as_tensor(b6_weights(np, recipe, C, O, seed),
                                 device="cuda")
    thr = b6_thresholds(torch, bs, voted, weight, valid, frac, dense)
    return voted, dis, weight, thr, valid


def b6_counts(C, W, O, R, B):
    """Bytes and operations of one B6 decode-pack call: voted and
    disagreement words, weights, cuts and the valid mask in once, count,
    (idx, vals) and dis out once; per event the reference's word-parallel
    cut (4 word operations a plane, 32 planes, a 32nd of a word each) and
    a butterfly 32x32 bit transpose for the lane scores (15 operations an
    event)."""
    n = C * W * 32
    nbytes = (C * W * O * 4 + C * R * W * 4 + C * O * 4 + C * 4 + C * B
              + 4 + n * 8 + C * R * 4)
    return bound(n * (4 + 15), nbytes)


def b6_keep_words_counts(C, W):
    """Bytes and operations of one keep-words call: the keep words and
    the kept lanes' scores in (a lane's score is read only when it is
    kept; this run's inputs keep about half, counted as ``kept``), count
    and (idx, vals) with padding out; a popcount and a rank an event."""
    n = C * W * 32
    return lambda kept: bound(2 * n, C * W * 4 + kept * 4 + 4 + n * 8)


def b6_dense_counts(C, W, O, R, B):
    """Bytes and operations of one dense call: voted and disagreement
    words, weights, cuts and the valid mask in once; score (int32), keep
    (bool) and dis out once; per event the butterfly 32x32 bit transpose
    that hands it its output bits (15 operations), a table lookup and an
    add for each nibble of its first 32 output bits, a select and an add
    for each output past them, and the cut (a compare and an and); per
    chip its nibble tables (16 sums of up to 4 weights a nibble)."""
    nbytes = (C * W * O * 4 + C * R * W * 4 + C * O * 4 + C * 4 + C * B
              + C * B * 5 + C * R * 4)
    nib = -(-min(O, 32) // 4)
    per_event = 15 + 2 * nib + 2 * max(O - 32, 0) + 2
    return bound(C * B * per_event + C * nib * 16 * 4, nbytes)


def bound(ops, nbytes):
    """The least time of a call of integer operations and bytes, and the
    bytes' time alone."""
    t_ops, t_bytes = ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes_ms": t_bytes * 1e3, "ops": ops, "bytes": nbytes}


def b6_equal(torch, what, got, want, names):
    torch.cuda.synchronize()
    for x, y, k in zip(got, want, names):
        if x.shape != y.shape or not torch.equal(x, y):
            fail("kernels", f"sparse_pack {what}: {k} differs in "
                            f"{int((x != y).sum())} places")


def check_b6(torch, np, bs, sp, cp, lut_ops, chips):
    """B6's three entries against their plain twins on the card, exact:
    decode-pack (count, idx, vals, dis) and dense (score, keep, dis) on
    K2's real voted words of the 4-chip served stack (W=SERVED_B/32, R=1
    and R=3 with an upset replica) at every keep fraction, launched alone
    and right behind the walk that makes them, and on synthetic words at
    the served width and at B6_WORDS a chip, for every weight recipe and
    keep fraction; the keep-words entry through
    compression.sparse_trigger_pack on (4, 512) and (4, 8) event masks.
    Every entry timed at both widths by CUDA-graph replay (``ms``) and
    back to back (``stream_ms``), its outputs exact after each."""
    configs = [c.config for c in chips]
    checked = []
    pack_names = ("count", "idx", "vals", "dis")
    dense_names = ("score", "keep", "dis")

    def held(what, args, walk=None):
        """Both decode entries on one input set (the plan's rows, so the
        planes and the weighted sums agree); with ``walk`` also launched
        right behind K2 on the words it makes again, as when served."""
        want = sp.decode_pack_plain(*args)
        got = sp.decode_pack(*args)
        b6_equal(torch, what, got, want, pack_names)
        want_d = sp.decode_dense_plain(*args)
        b6_equal(torch, f"dense {what}", sp.decode_dense(*args), want_d,
                 dense_names)
        if walk is not None:
            b6_equal(torch, f"{what} after the walk", sp.decode_pack(
                *walk(), *args[2:]), want, pack_names)
            b6_equal(torch, f"dense {what} after the walk", sp.decode_dense(
                *walk(), *args[2:]), want_d, dense_names)
        checked.append(what)
        return got

    W = SERVED_B // 32
    rng = np.random.default_rng(15)
    kept = {}
    for red in ("none", "tmr"):
        stack = lut_ops.pack_fabrics(configs, redundancy=red,
                                     layout="bitsliced", device="cuda")
        R = stack.n_replicas
        tables = stack.tables.clone()
        if R > 1:
            tables[1, :, :8, ::3] = 1.0 - tables[1, :, :8, ::3]
        bits = torch.as_tensor(
            rng.integers(0, 2, (N_CHIPS, SERVED_B, stack.n_inputs)),
            dtype=torch.int32, device="cuda")
        seg = bs.input_words(bits, stack.n_inputs, stack.in_seg)

        def walk():
            return bs.eval_seg_voted(stack.src, tables, stack.output_nets,
                                     seg, R)
        voted, dis = walk()
        weight = torch.as_tensor(lut_ops.decode_plan(
            configs, stack.n_outputs), device="cuda")
        for frac in B6_FRACTIONS:
            args = b6_case(torch, np, bs, N_CHIPS, W, R, stack.n_outputs,
                           "plan", frac, seed=16, voted=voted, dis=dis,
                           weight=weight)
            got = held(f"K2 words R={R} keep~{frac}", args, walk)
            kept[f"K2_R{R}_keep{frac}"] = int(got[0])
        if R > 1 and not bool((got[3] != 0).any()):
            fail("kernels", "sparse_pack: an upset replica gave no "
                            "disagreement counts")
    for words in (W, B6_WORDS):
        for recipe in B6_DENSE_WEIGHTS:
            for frac in B6_FRACTIONS:
                seed = words + len(recipe)
                args = b6_case(torch, np, bs, N_CHIPS, words, 3, 32, recipe,
                               frac, seed=seed)
                if recipe in B6_WEIGHTS:
                    got = held(f"W={words} {recipe} keep~{frac}", args)
                    kept[f"W{words}_{recipe}_keep{frac}"] = int(got[0])
                # the dense entry with cuts set on its own scores
                args = b6_case(torch, np, bs, N_CHIPS, words, 3, 32, recipe,
                               frac, seed=seed, dense=True)
                b6_equal(torch, f"dense W={words} {recipe} keep~{frac}",
                         sp.decode_dense(*args), sp.decode_dense_plain(*args),
                         dense_names)
                checked.append(f"dense W={words} {recipe} keep~{frac}")
    for shape in ((N_CHIPS, SERVED_B), (N_CHIPS, 8)):
        for frac in B6_FRACTIONS:
            score = torch.as_tensor(rng.integers(-2**31, 2**31, shape),
                                    dtype=torch.int32, device="cuda")
            keep = torch.as_tensor(rng.random(shape) < frac, device="cuda")
            got = cp.sparse_trigger_pack(score, keep)
            want = cp.sparse_trigger_pack(score.cpu(), keep.cpu())
            torch.cuda.synchronize()
            for x, y, k in zip(got, want, ("count", "idx", "vals")):
                if not torch.equal(x.cpu(), y):
                    fail("kernels", f"sparse_pack keep-words {shape} "
                                    f"keep~{frac}: {k} differs")
            checked.append(f"keep-words {shape} keep~{frac}")
    return {
        "name": "sparse_pack",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_pack.cu",
        "replaces": "src/repro/parallel/compression.py:207",
        "also_replaces": "src/repro/kernels/lut_eval/ops.py:1004",
        "checked": len(checked), "kept": kept,
        "max_abs_err": 0.0,
        "library_ms": None,
        "library_note": "no one torch call decodes the score planes and "
                        "compacts without a host synchronisation "
                        "(torch.nonzero, masked_select and boolean "
                        "indexing size their output by the data)",
        "runs": time_b6(torch, np, bs, sp),
    }


def time_b6(torch, np, bs, sp):
    """The three entries at the served width and at B6_WORDS a chip (4
    chips, R=3, O=28, the plan's rows, about half kept), outputs
    preallocated so that a call is the launch alone; the outputs of the
    last graph replay and of the last call back to back held against the
    plain twin."""
    from repro_torch.kernels.lut_eval.ops import decode_keep_words_device

    runs = {}
    for words in (SERVED_B // 32, B6_WORDS):
        args = b6_case(torch, np, bs, N_CHIPS, words, 3, 28, "plan", 0.5,
                       seed=17)
        voted, dis, weight, thr, valid = args
        C, _, O = voted.shape
        B = valid.shape[1]
        n = C * words * 32
        count, idx, vals = (torch.empty((), dtype=torch.int32, device="cuda"),
                            torch.empty(n, dtype=torch.int32, device="cuda"),
                            torch.empty(n, dtype=torch.int32, device="cuda"))
        d = torch.empty((C, 3), dtype=torch.int32, device="cuda")
        score = torch.empty((C, B), dtype=torch.int32, device="cuda")
        keep = torch.empty((C, B), dtype=torch.bool, device="cuda")
        keep_w, scores, _ = decode_keep_words_device(*args)

        def pack():
            sp.launch_pack(voted, dis, weight, thr, valid, None, None, count,
                           idx, vals, d, C, words, O, 3, B)

        def keep_words():
            sp.launch_pack(None, None, None, None, None, keep_w, scores,
                           count, idx, vals, None, C, words, 0, 0, 0)

        def dense():
            sp.launch_dense(voted, dis, weight, thr, valid, score, keep, d,
                            C, words, O, 3, B)
        kept = int(bs.popcount(keep_w).sum())
        for name, fn, plain, outs, counts in (
                ("decode_pack", pack, lambda: sp.decode_pack_plain(*args),
                 (count, idx, vals, d), b6_counts(C, words, O, 3, B)),
                ("keep_words", keep_words,
                 lambda: sp.pack_words_plain(keep_w, scores),
                 (count, idx, vals), b6_keep_words_counts(C, words)(kept)),
                ("dense", dense, lambda: sp.decode_dense_plain(*args),
                 (score, keep, d), b6_dense_counts(C, words, O, 3, B))):
            names = (("score", "keep", "dis") if name == "dense"
                     else ("count", "idx", "vals", "dis"))
            want = plain()
            ms = graph_ms(fn)
            b6_equal(torch, f"{name} W={words} after graph replays", outs,
                     want, names)
            stream_ms = time_ms(fn, inner=20)
            b6_equal(torch, f"{name} W={words} back to back", outs, want,
                     names)
            runs[f"{name}_R3_W{words}"] = {
                "words": words, "events": n, "outputs": O,
                "ms": ms, "stream_ms": stream_ms,
                "plain_ms": time_ms(plain, reps=10, inner=1),
                **counts,
            }
    return runs


def paper_chip():
    """examples/smartpixel_readout.py's chip, through the port's copy of
    the toolchain: (chip, test split, train split)."""
    from repro_torch.core.bdt import GradientBoostedClassifier
    from repro_torch.core.readout import ReadoutChip
    from repro_torch.data.smartpixel import (
        SmartPixelConfig, generate, train_test_split)

    data = generate(SmartPixelConfig(n_events=S5_EVENTS, seed=S5_SEED))
    tr, te = train_test_split(data)
    clf = GradientBoostedClassifier(
        n_estimators=1, max_depth=5, max_leaf_nodes=10, min_samples_leaf=500
    ).fit(tr["features"], tr["label"])
    return ReadoutChip.build(clf, fabric="efpga_28nm"), te, tr


# ways to leave the one-hot form of ops.pack_ensemble's arrays (the
# walk's precondition), and one that keeps it at extreme leaf values
BDT_RECIPES = ("left_two_ones", "featsel_two_ones", "root_two",
               "shared_node", "big_leaves")


def bdt_nodes(np, left, right, root):
    """The nodes the packed trees reach from their roots (children are
    the argmax of a one-hot row), and the internal ones among them."""
    seen, todo = set(), list(np.nonzero(root[0])[0])
    while todo:
        p = int(todo.pop())
        if p not in seen:
            seen.add(p)
            todo += [int(np.argmax(left[p])), int(np.argmax(right[p]))]
    reached = np.array(sorted(seen))
    inner = reached[[left[p, p] != 1.0 for p in reached]]
    return reached, inner


def synthetic_ensemble(np, arrays, x, recipe, seed=0):
    """A copy of packed BDT arrays (numpy, pack_ensemble's names and
    shapes) and of raw features x broken as `recipe` says:
      left_two_ones    the first root's left row gets a second 1 (its
                       right child), so mass doubles down that path;
      featsel_two_ones the first root's featsel column gets a second
                       feature, and rows with int32-extreme values of the
                       two are appended to x, so the MAC wraps;
      root_two         the first root's entry is 2.0;
      shared_node      a padding slot becomes one more root whose
                       children are the first root's, so two trees reach
                       the same nodes;
      big_leaves       every reached leaf gets values near +-2^27 in all
                       128 columns, split into hi/lo as the packer splits
                       them (one-hot form kept).
    Every sum stays an integer below 2^24, where any summation order
    gives the same float32 result."""
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    rng = np.random.default_rng(seed)
    F, P = a["featsel"].shape
    reached, inner = bdt_nodes(np, a["left"], a["right"], a["root_onehot"])
    r0 = int(np.nonzero(a["root_onehot"][0])[0][0])
    lc, rc = int(np.argmax(a["left"][r0])), int(np.argmax(a["right"][r0]))
    f0 = int(np.argmax(a["featsel"][:, r0]))
    if recipe == "left_two_ones":
        a["left"][r0, rc] = 1.0
    elif recipe == "featsel_two_ones":
        f1 = (f0 + 1) % F
        a["featsel"][f1, r0] = 1
        ext = np.array([2**31 - 1, -2**31, 2**30, -2**30, 1, -1], np.int64)
        rows = x[:48].astype(np.int64)
        rows[:, f0] = rng.choice(ext, len(rows))
        rows[:, f1] = rng.choice(ext, len(rows))
        x = np.concatenate([x, rows.astype(np.int32)])
    elif recipe == "root_two":
        a["root_onehot"][0, r0] = 2.0
    elif recipe == "shared_node":
        q = int(reached.max()) + 1
        if q >= P:
            raise ValueError("no padding slot for a shared-node tree")
        a["root_onehot"][0, q] = 1.0
        a["featsel"][f0, q] = 1
        a["thr"][0, q] = a["thr"][0, r0]
        a["left"][q] = 0.0
        a["right"][q] = 0.0
        a["left"][q, lc] = 1.0
        a["right"][q, rc] = 1.0
    elif recipe == "big_leaves":
        leaves = np.setdiff1d(reached, inner)
        mag = rng.integers(2**27 - 2**20, 2**27, (len(leaves), 128))
        value = mag * rng.choice([-1, 1], mag.shape)
        a["value_hi"][leaves] = (value >> 14).astype(np.float32)
        a["value_lo"][leaves] = (value & 0x3FFF).astype(np.float32)
    else:
        raise ValueError(f"unknown recipe {recipe!r}")
    return a, x


def bdt_counts(bdt, x, arrays, depth):
    """Bytes and operations of one B4 call on these inputs: x in, every
    array once, the (B, 128) output out; per event and tree `depth`
    compare/select pairs and 2 x 128 readout adds, per event 128
    shift-adds; and the dense product count of the TPU's form."""
    B, F = x.shape
    P = arrays[0].shape[1]
    n_trees = int((arrays[2] != 0).sum())
    nbytes = (x.numel() * 4 + sum(a.numel() * 4 for a in arrays)
              + B * bdt.OUT_COLS * 4)
    int_ops = B * (n_trees * depth * 2 + bdt.OUT_COLS * 2)
    adds = B * n_trees * 2 * bdt.OUT_COLS
    # an FMA counts as two operations in the float32 peak, an add as one
    t_ops = int_ops / INT_OPS_PER_S + adds / (FP32_OPS_PER_S / 2)
    t_bytes = nbytes / HBM_BYTES_PER_S
    # multiply-adds per event of the product form: feature select, 2
    # routing products per step, the two readout products
    flops = 2 * B * (F * P + depth * 2 * P * P + 2 * P * bdt.OUT_COLS)
    return {
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "dense_product_bound_ms": max(flops / BF16_FLOPS_PER_S,
                                      t_bytes) * 1e3,
        "trees": n_trees, "ops": int_ops + adds, "bytes": nbytes,
        "dense_product_flops": flops,
    }


def check_bdt(torch, np, bdt, bdt_ops, chip, X):
    """B4 on the paper chip's golden ensemble against its twin, at B=512
    and B=S5_CHUNK raw feature rows of X, and at B=512 on each of
    BDT_RECIPES' synthetic arrays: exact. Times and bound at the larger."""
    packed = bdt_ops.pack_ensemble(chip.golden, X.shape[1], device="cuda")
    names = ("featsel", "thr", "root_onehot", "left", "right", "value_hi",
             "value_lo")
    arrays = tuple(getattr(packed, k) for k in names)
    depth = packed.depth
    x_raw = chip.golden.quantize_features(X[:S5_CHUNK]).astype(np.int32)

    def held(what, x, arrays):
        got = bdt.bdt_traverse(x, *arrays, depth=depth)
        want = bdt.bdt_traverse_plain(x, *arrays, depth=depth)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail("kernels", f"bdt_infer {what}: {int((got != want).sum())} "
                            "outputs differ from the twin")
        return got

    host = {k: a.cpu().numpy() for k, a in zip(names, arrays)}
    synthetic = {}
    for recipe in BDT_RECIPES:
        a, xs = synthetic_ensemble(np, host, x_raw[:SERVED_B], recipe)
        got = held(recipe, torch.as_tensor(xs, device="cuda"),
                   tuple(torch.as_tensor(a[k], device="cuda")
                         for k in names))
        synthetic[recipe] = {"events": len(xs),
                             "nonzero_columns": int((got != 0).any(0).sum())}
    for B in (SERVED_B, S5_CHUNK):
        x = torch.as_tensor(x_raw[:B], device="cuda")
        got = held(f"B={B}", x, arrays)
    B, P = x.shape[0], packed.featsel.shape[1]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = bdt.bdt_tile(P, x.shape[1], B, n_sms)
    out = torch.empty_like(got)
    scratch = bdt.scratch_for(P, x.device)

    def b4_call():
        bdt._launch(x, *arrays, scratch, out, depth, tile)
    return {
        "name": "bdt_infer",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bdt_infer.cu",
        "replaces": "src/repro/kernels/bdt_infer/bdt_infer.py:68",
        "checked_batches": [SERVED_B, S5_CHUNK], "synthetic": synthetic,
        "nodes": P, "depth": depth, "tile": tile, "max_abs_err": 0.0,
        # both passes, the node table and the walk: replayed from a CUDA
        # graph, and back to back from the host (host-bound at this size)
        "ms": graph_ms(b4_call),
        "stream_ms": time_ms(b4_call),
        "plain_ms": time_ms(lambda: bdt.bdt_traverse_plain(
            x, *arrays, depth=depth), reps=10, inner=1),
        "library_ms": None,
        **bdt_counts(bdt, x, arrays, depth),
    }


def section5(torch, np, chip, te, tr, counters):
    """The paper's §5 check on every event: fabric (banded, dense, then
    bit-sliced) and bdt_infer against the golden BDT, with the launch
    counts of the run; B3 and B2 against their twin on one full chunk."""
    from repro_torch.core.readout import KernelBackend
    from repro_torch.kernels.bdt_infer import ops as bdt_ops
    from repro_torch.kernels.lut_eval import lut_eval as le
    from repro_torch.kernels.lut_eval import ops as lut_ops

    def chunks():
        # the example's order: the test split, then the train split
        for split in (te, tr):
            for lo in range(0, len(split["features"]), S5_CHUNK):
                yield split["features"][lo : lo + S5_CHUNK]

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    reset(counters)
    runs = {}
    # the default layout (banded B3), then band=False (dense B2), then the
    # bit-sliced layout that was KernelBackend's default before the matmul
    # layout was ported, for its rate
    for layout, backend in (
            ("banded", KernelBackend(device="cuda")),
            ("dense", KernelBackend(band=False, device="cuda")),
            ("bitsliced", KernelBackend(layout="bitsliced", device="cuda"))):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n = n_match = 0
        for X in chunks():
            v = chip.verify_vs_golden(X, backend=backend)
            n += int(v["n"])
            n_match += int(v["n_match"])
        dt = time.monotonic() - t0
        packed = backend._packed.get(chip.config)
        packed_as = ("bitsliced" if packed.bitsliced
                     else "banded" if packed.banded else "dense")
        if packed_as != layout:
            fail("s5", f"KernelBackend packed the chip {packed_as!r}, not "
                       f"{layout!r}: band_k={packed.band_k}, "
                       f"levels={packed.n_levels}")
        if n != S5_EVENTS or n_match != n:
            fail("s5", f"{layout}: {n_match} of {n} events match the "
                       "golden BDT")
        runs[layout] = {"events": n, "n_match": n_match, "seconds": dt,
                        "events_per_s": n / dt}
        if packed.bitsliced:
            continue
        # the kernel alone on the first full chunk, at the shape this path
        # gives it (C=1, B=S5_CHUNK): the whole net buffer against the twin
        bits = torch.as_tensor(chip.encode_features(next(chunks())),
                               dtype=torch.int32, device="cuda")
        ext = lut_ops._bits_ext(bits, packed.n_inputs, packed.in_seg)[None]
        win = packed.win_base if packed.banded else None
        arrays = (ext, packed.sel[None], packed.tables[None],
                  packed.level_base, win)
        out = torch.empty((1, len(bits), packed.n_nets_pad),
                          dtype=torch.float32, device="cuda")
        tile = le.lut_tile(packed.n_nets_pad, packed.m_pad, len(bits), 1,
                           n_sms)
        le._launch(*arrays, out, tile)
        want = le.lut_eval_plain(*arrays, n_nets_pad=packed.n_nets_pad)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            fail("s5", f"{layout}: the net buffer of a {len(bits)}-event "
                       f"chunk differs from the twin in "
                       f"{int((out != want).sum())} places")
        del want
        counts = lut_counts(arrays[1], arrays[2], ext, out, win)
        runs[layout].update({
            "sel_rows": packed.sel.shape[1], "band_k": packed.band_k,
            "tile": tile, "chunk_checked_events": len(bits),
            "chunk_kernel_ms": time_ms(lambda: le._launch(*arrays, out, tile),
                                       reps=10, inner=2),
            "chunk_plain_ms": time_ms(lambda: le.lut_eval_plain(
                *arrays, n_nets_pad=packed.n_nets_pad), reps=5, inner=1),
            "chunk_bound_ms": counts["bound_ms"],
            "chunk_bound_by": counts["bound_by"],
            "chunk_dense_product_bound_ms": counts["dense_product_bound_ms"],
        })
    packed = bdt_ops.pack_ensemble(chip.golden, 14, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    n = n_match = 0
    for X in chunks():
        x_raw = chip.golden.quantize_features(X)
        got = bdt_ops.bdt_infer(packed, x_raw).cpu().numpy()
        n += len(X)
        n_match += int((got == chip.golden.decision_function_raw(x_raw)).sum())
    dt = time.monotonic() - t0
    if n != S5_EVENTS or n_match != n:
        fail("s5", f"bdt_infer: {n_match} of {n} events match the golden "
                   "BDT")
    runs["bdt_infer"] = {"events": n, "n_match": n_match, "seconds": dt,
                         "events_per_s": n / dt}
    launches = read(counters)
    for k in ("lut_eval", "lut_eval_banded", "bdt_infer"):
        if launches[k] <= 0:
            fail("s5", f"kernel {k} never launched")
    return runs, launches


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def read(counters):
    return {k: fn.launches for k, fn in counters.items()}


def oracle(np, chips, swap_chip, blocks, yp):
    """Per (step, sensor): the featurizer kernel's features of the block
    (float64, the features path's input) and the numpy oracle's (score,
    keep) on them (encode_features -> FabricSim -> decode_outputs), for
    the chip serving that sensor at that step."""
    from repro_torch.core.fabric import FabricSim

    out = []
    for step in range(SERVE_BATCHES):
        row = []
        for s in range(N_CHIPS):
            chip = swap_chip if (s == 0 and step >= RECONFIGURE_AT) \
                else chips[s]
            blk = blocks[step][s]
            feats = yp.yprofile(blk["frames"], blk["y0"],
                                device="cuda").cpu().numpy()
            outs, _ = FabricSim(chip.config).run(chip.encode_features(feats))
            score = chip.synth.decode_outputs(np.asarray(outs))
            row.append((feats.astype(np.float64), score,
                        score <= chip.score_threshold_raw))
        out.append(row)
    return out


# the fabric kernel a served stack runs, by PackedFabricStack.layout
FABRIC_KERNEL = {"bitsliced": "eval_words_voted",
                 "banded": "lut_eval_banded", "dense": "lut_eval"}


def serve(torch, np, chips, swap_chip, blocks, want, redundancy, counters,
          layout=None, sparse=False, features=False):
    """One server run over the pre-generated blocks, raw frames or (with
    ``features``) their features through submit_batch; its results
    checked against the oracle ``want``, with the launch counts of the
    run. With ``sparse`` the drained events must be exactly the oracle's
    kept set and the link bytes must follow the wire format."""
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    server = ReadoutServer(
        list(chips), ServerConfig(redundancy=redundancy, layout=layout,
                                  sparse=sparse), device="cuda")
    phase = ("serve_features" if features else "serve_sparse" if sparse
             else "serve" if layout is None else "serve_matmul")
    what = (f"{server.layout} {redundancy}"
            f"{' sparse' if sparse else ''}")
    reset(counters)
    where = {}                       # seq -> (step, sensor, row)
    results = []
    for step in range(SERVE_BATCHES):
        if step == RECONFIGURE_AT:
            results += server.reconfigure(0, swap_chip)
        for s in range(N_CHIPS):
            blk = blocks[step][s]
            seqs = (server.submit_batch(s, want[step][s][0]) if features
                    else server.submit_frames(s, blk["frames"], blk["y0"]))
            for row, seq in enumerate(seqs):
                where[seq] = (step, s, row)
            results += server.poll()
    results += server.flush()
    torch.cuda.synchronize()
    launches = read(counters)
    rep = server.report()

    seqs = [r.seq for r in results]
    if len(set(seqs)) != len(seqs) or not set(seqs) <= set(where):
        fail(phase, f"{what}: duplicate or unknown seqs among "
                    f"{len(seqs)} drained results")
    got = {r.seq: (r.chip, r.score_raw, r.keep) for r in results}
    expect = {}
    for seq, (step, s, row) in where.items():
        _, score, keep = want[step][s]
        if keep[row] or not sparse:
            expect[seq] = (s, int(score[row]), bool(keep[row]))
    mism = len(set(got) ^ set(expect)) + sum(
        got[q] != expect[q] for q in set(got) & set(expect))
    if mism:
        fail(phase, f"{what}: {mism} events differ from the oracle "
                    f"({len(got)} drained, {len(expect)} expected)")
    if rep["seu_disagreement_total"]:
        fail(phase, f"{what}: {rep['seu_disagreement_total']} replica "
                    "disagreements on a healthy stack")
    need = [FABRIC_KERNEL[server._stack.layout]]
    if not features:
        need.append("yprofile")
    if sparse:
        need.append("sparse_pack_decode" if server._stack.bitsliced
                    else "sparse_pack_keep_words")
    elif server._stack.bitsliced:
        need.append("decode_dense")
    for k in need:
        if launches[k] <= 0:
            fail(phase, f"{what}: kernel {k} never launched")
    link = rep["link_bytes"]
    n_in = rep["n_in"]
    wire = (4 * rep["stages"]["drain_wait"]["calls"] + 8 * rep["n_kept"]
            if sparse else 5 * n_in)
    if (n_in != len(where) or link["on_wire"] != wire
            or link["dense_equivalent"] != 5 * n_in):
        fail(phase, f"{what}: link bytes {link} for {n_in} events, "
                    f"{rep['n_kept']} kept (wire {wire} expected)")
    return {"layout": rep["layout"], "stack": server._stack.layout,
            "redundancy": redundancy, "sparse": sparse,
            "ingest": "features" if features else "frames",
            "events": n_in, "drained": len(results),
            "oracle_mismatches": mism,
            "disagreements": rep["seu_disagreement_total"],
            "launches": launches, "events_per_s": rep["events_per_s"],
            "fraction_kept": rep["fraction_kept"],
            "per_chip": [(c["n_in"], c["n_kept"]) for c in rep["per_chip"]],
            "link_bytes": link, "stages": rep["stages"]}


# 9-10: the scrub/SEU loop and deadline admission, on the served stream
# without its hot swap (7 batches a stream, then one more after a flush:
# 8,192 events a configuration)
SEU_AT = 3
SCRUB_RATE_ROUNDS = 3
DEADLINE_OBSERVE_US = 10_000.0


def effective_flips(np, chips, want):
    """Per chip: the (lut, bit) of its base encoding, among the first 64
    that change its outputs on its batch SEU_AT block, that changes the
    most events there (the numpy FabricSim oracle)."""
    from repro_torch.core.fabric import FabricSim
    from repro_torch.core.tmr import inject_seu

    flips = []
    for s, chip in enumerate(chips):
        bits = chip.encode_features(want[SEU_AT][s][0])
        good = np.asarray(FabricSim(chip.config).run(bits)[0])
        best, n_found = None, 0
        for li in range(chip.config.n_luts):
            for bi in range(16):
                outs = np.asarray(FabricSim(
                    inject_seu(chip.config, li, bi)).run(bits)[0])
                n = int((outs != good).any(-1).sum())
                if n:
                    n_found += 1
                    if best is None or n > best[2]:
                        best = (li, bi, n)
            if n_found >= 64:
                break
        if best is None:
            raise RuntimeError(f"chip {s}: no output-changing flip")
        flips.append(best)
    return flips


def drive_frames(server, blocks, steps, results, where, before=None,
                 after=None):
    """Submit each step's sensor blocks as raw frames, polling after each,
    with ``before(step)`` / ``after(step)`` hooks; records every admitted
    event's (step, sensor, row) in ``where`` and the drained results."""
    for step in steps:
        if before is not None:
            before(step)
        for s in range(N_CHIPS):
            blk = blocks[step][s]
            seqs = server.submit_frames(s, blk["frames"], blk["y0"])
            for row, seq in enumerate(seqs):
                if seq is not None:
                    where[seq] = (step, s, row)
            results += server.poll()
        if after is not None:
            after(step)


def mismatches(want, results, where, steps=None):
    """Drained results that differ from the oracle (seq -> (chip, score,
    keep)); only events of ``steps`` when given."""
    bad = 0
    for r in results:
        step, s, row = where[r.seq]
        if steps is not None and step not in steps:
            continue
        _, score, keep = want[step][s]
        bad += (r.chip, r.score_raw, r.keep) != (s, int(score[row]),
                                                 bool(keep[row]))
    return bad


def serve_scrub(torch, np, chips, blocks, want, flips, counters, layout,
                redundancy, mode):
    """One scrub run: scrub_interval=1; before batch SEU_AT one
    output-changing bit of the replica frame the round-robin pointer
    samples next is flipped (``flips``, in replica coordinates under
    TMR), so both scrub modes reach it within the stream. Under TMR every event
    must equal the oracle; without it, every event submitted after the
    heal. Exactly one detection and one healed bit, the upset replica's
    counter climbing and then still after the heal, every frame clean at
    the end, the fabric kernel and (bit-sliced) B6's dense entry
    launched."""
    from repro_torch.core.tmr import replica_lut_index
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    phase = "serve_scrub"
    server = ReadoutServer(list(chips), ServerConfig(
        redundancy=redundancy, layout=layout, scrub_interval=1,
        scrub_mode=mode), device="cuda")
    what = f"{server.layout} {redundancy} {mode}"
    R = server.n_replicas
    hit = {}

    def inject(step):
        if step != SEU_AT:
            return
        slot, replica = divmod(server._scrub_rr, R)
        li, bi, n = flips[slot]
        server.inject_seu(slot, replica,
                          replica_lut_index(chips[slot].config, replica, li)
                          if R > 1 else li, bi)
        if server.verify_frame(slot, replica):
            fail(phase, f"{what}: the injected upset verifies clean")
        hit.update(slot=slot, replica=replica, events_changed=n)

    healed_after = []

    def note_heal(step):
        if not healed_after and server.report()["scrub"]["healed_bits"]:
            healed_after.append(step)

    reset(counters)
    results, where = [], {}
    drive_frames(server, blocks, range(SERVE_BATCHES - 1), results, where,
                 before=inject, after=note_heal)
    results += server.flush()
    slot, replica = hit["slot"], hit["replica"]
    climbed = server.report()["per_chip"][slot]["seu_disagreements"][replica]
    drive_frames(server, blocks, [SERVE_BATCHES - 1], results, where)
    results += server.flush()
    torch.cuda.synchronize()
    launches = read(counters)
    rep = server.report()
    scrub = rep["scrub"]
    after = rep["per_chip"][slot]["seu_disagreements"][replica]
    if len(results) != len(where) or {r.seq for r in results} != set(where):
        fail(phase, f"{what}: {len(results)} results for {len(where)} "
                    "events")
    checked = (None if R > 1 else
               set(range((healed_after or [SERVE_BATCHES - 2])[0] + 1,
                         SERVE_BATCHES)))
    mism = mismatches(want, results, where, checked)
    # without TMR the events served while the upset was live may differ
    wrong_before = mismatches(want, results, where) - mism
    if mism:
        fail(phase, f"{what}: {mism} events differ from the oracle")
    if scrub["detections"] != 1 or scrub["healed_bits"] != 1:
        fail(phase, f"{what}: scrub report {scrub}")
    if R > 1 and not (climbed > 0 and after == climbed):
        fail(phase, f"{what}: upset replica's disagreements {climbed} at "
                    f"the flush, {after} after one more batch")
    clean = [server.verify_frame(s, r) for s in range(N_CHIPS)
             for r in range(R)]
    if not all(clean):
        fail(phase, f"{what}: frames failing verify at the end: {clean}")
    need = ["yprofile", FABRIC_KERNEL[server._stack.layout]]
    if server._stack.bitsliced:
        need.append("decode_dense")
    for k in need:
        if launches[k] <= 0:
            fail(phase, f"{what}: kernel {k} never launched")
    return {"layout": rep["layout"], "stack": server._stack.layout,
            "redundancy": redundancy, "mode": mode,
            "events": rep["n_in"], "upset": hit,
            "healed_after_batch": (healed_after or [None])[0],
            "oracle_mismatches": mism,
            "wrong_before_heal": wrong_before,
            "upset_disagreements": climbed, "scrub": scrub,
            "scrub_stage": rep["stages"].get("scrub"),
            "launches": launches, "events_per_s": rep["events_per_s"]}


def scrub_rates(np, chips, blocks):
    """Served events/s of the TMR bit-sliced stream (no upset) with a
    scrub step every dispatch and without scrubbing, in alternating
    rounds (off, on, on, off, ...), with each run's host stage seconds
    and the seconds Python's garbage collector ran during it."""
    import gc

    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    rates = {"on": [], "off": []}
    stages = {"on": [], "off": []}
    gc_s = {"on": [], "off": []}
    scrub_s = []
    t_gc = [0.0, 0.0]            # start of the running collection, total

    def gc_clock(phase, info):
        if phase == "start":
            t_gc[0] = time.monotonic()
        else:
            t_gc[1] += time.monotonic() - t_gc[0]
    order = [("off", "on") if k % 2 == 0 else ("on", "off")
             for k in range(SCRUB_RATE_ROUNDS)]
    for pair in order:
        for side in pair:
            server = ReadoutServer(list(chips), ServerConfig(
                redundancy="tmr",
                scrub_interval=1 if side == "on" else None), device="cuda")
            results, where = [], {}
            t_gc[1] = 0.0
            gc.callbacks.append(gc_clock)
            try:
                drive_frames(server, blocks, range(SERVE_BATCHES), results,
                             where)
                results += server.flush()
            finally:
                gc.callbacks.remove(gc_clock)
            gc_s[side].append(round(t_gc[1], 6))
            rep = server.report()
            if len(results) != len(where):
                fail("serve_scrub", f"scrub {side}: {len(results)} results "
                                    f"for {len(where)} events")
            rates[side].append(rep["events_per_s"])
            stages[side].append({k: round(v["seconds"], 6)
                                 for k, v in rep["stages"].items()})
            if side == "on":
                scrub_s.append(rep["stages"]["scrub"]["seconds"])
    return {"order": [s for pair in order for s in pair],
            "events_per_s": rates,
            "median_on": float(np.median(rates["on"])),
            "median_off": float(np.median(rates["off"])),
            "scrub_stage_seconds": scrub_s, "stage_seconds": stages,
            "gc_seconds": gc_s}


def serve_deadline(torch, np, chips, blocks, want, counters, deadline_us,
                   policy, rungs=None):
    """One deadline run of the served stream (8,192 events submitted).
    Checks: every drained event equals the oracle, every admitted event
    missing from the drain was dropped by the oracle (a sparse batch),
    every shed submission returned None and is counted in n_shed, and
    n_in + n_shed is the submitted count a chip."""
    from repro_torch.launch.readout_server import (DEGRADE_RUNGS,
                                                   ReadoutServer,
                                                   ServerConfig)

    phase = "serve_deadline"
    server = ReadoutServer(list(chips), ServerConfig(
        deadline_us=deadline_us, overload_policy=policy,
        degrade_rungs=rungs or DEGRADE_RUNGS), device="cuda")
    what = f"{policy} deadline {deadline_us:.1f} us"
    reset(counters)
    results, where = [], {}
    drive_frames(server, blocks, range(SERVE_BATCHES), results, where)
    results += server.flush()
    torch.cuda.synchronize()
    launches = read(counters)
    rep = server.report()
    mism = mismatches(want, results, where)
    drained = {r.seq for r in results}
    missing_kept = sum(bool(want[st][s][2][row])
                       for q, (st, s, row) in where.items()
                       if q not in drained)
    if mism or missing_kept or not drained <= set(where):
        fail(phase, f"{what}: {mism} drained events differ from the "
                    f"oracle, {missing_kept} kept events missing")
    submitted = SERVE_BATCHES * SERVE_EVENTS
    for c, row in enumerate(rep["per_chip"]):
        admitted = sum(1 for (_, s, _) in where.values() if s == c)
        if row["n_in"] != admitted or row["n_in"] + row["n_shed"] != submitted:
            fail(phase, f"{what}: chip {c} n_in {row['n_in']} + n_shed "
                        f"{row['n_shed']} against {admitted} admitted of "
                        f"{submitted} submitted")
    lat = rep["latency"]
    return {"policy": policy, "deadline_us": deadline_us,
            "rungs": list(rungs or DEGRADE_RUNGS),
            "submitted": submitted * N_CHIPS, "admitted": len(where),
            "drained": len(results), "n_in": rep["n_in"],
            "shed": rep["deadline"]["shed"],
            "oracle_mismatches": mism,
            "latency_us": {k: lat["total"][k] for k in (
                "count", "p50_us", "p99_us", "p999_us", "max_us")},
            "service_us": {k: lat["service"][k] for k in (
                "p50_us", "p99_us")},
            "queue_wait_us": {k: lat["queue_wait"][k] for k in (
                "p50_us", "p99_us")},
            "deadline": {k: rep["deadline"][k] for k in (
                "met", "missed", "miss_fraction", "effective_max_batch",
                "batch_shrinks", "batch_grows")},
            "transitions": rep["deadline"]["ladder"]["transitions"],
            "link_bytes": rep["link_bytes"], "launches": launches,
            "events_per_s": rep["events_per_s"]}


# 11: the network front door. TCP: 32 batches of 64 events a sensor
# (8,192 events a run, the stream's frames); UDP: 16 datagrams of 7
# events a sensor, paced at NET_UDP_RATE events/s a sensor, slow enough
# that the door's loop reads each datagram before the socket's receive
# buffer (Linux's default, 212,992 B: three 61 KB datagrams) fills; a
# datagram past it is lost, the FLUSH behind a full buffer among them.
# The TCP paced run goes at NET_PACE_FRAC of the in-process burst rate,
# as benchmarks/bench_net.py does.
NET_BATCHES = 32
NET_EVENTS = 64
NET_UDP_BATCHES = 16
NET_UDP_RATE = 100.0
NET_PACE_FRAC = 0.5
NET_TIMEOUT_S = 20.0


def net_sources(np, blocks):
    """Per sensor, ``per -> replay.array_source`` over the stream's frames
    (the 8 batches of 256 events concatenated: 2,048 events a sensor,
    each with its own y0)."""
    from repro_torch.net.replay import array_source

    pools = [tuple(np.concatenate([blocks[t][s][k]
                                   for t in range(SERVE_BATCHES)])
                   for k in ("frames", "y0")) for s in range(N_CHIPS)]
    for frames, y0 in pools:
        if len(np.unique(y0)) != len(y0):
            fail("serve_net", "two events of a sensor's pool share a y0")
    return [lambda per, pool=pool: array_source(*pool, per)
            for pool in pools]


def net_oracles(np, chips, sources):
    """Per sensor, host_oracle on the card (K1, then numpy) applied to
    every batch either transport replays, before any run: the clients
    share the door's event loop, and a client that verified its triggers
    with the oracle as it finished would hold the loop for the oracle's
    time while the others still send. Each returned oracle answers from
    those results, keyed by the batch's y0 values (no two events of a
    pool share one, net_sources)."""
    from repro_torch.net.protocol import UDP_MAX_EVENTS
    from repro_torch.net.replay import host_oracle

    out = []
    for s, chip in enumerate(chips):
        oracle = host_oracle(chip, device="cuda")
        memo = {}
        for per, n_batches in ((NET_EVENTS, NET_BATCHES),
                               (UDP_MAX_EVENTS, NET_UDP_BATCHES)):
            src = sources[s](per)
            for b in range(n_batches):
                frames, y0 = src(b)
                memo[y0.tobytes()] = oracle(frames, y0)
        out.append(lambda frames, y0, memo=memo: memo[y0.tobytes()])
    return out


def net_server(chips, redundancy, sources):
    """A ServerConfig() server on the card with its fused pass built and
    run once (one 64-event batch a chip, in-process) before any timing."""
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    server = ReadoutServer(list(chips), ServerConfig(redundancy=redundancy),
                           device="cuda")
    for s in range(N_CHIPS):
        server.submit_frames(s, *sources[s](NET_EVENTS)(0))
    server.flush()
    return server


def net_inprocess(torch, chips, redundancy, sources, rate=None):
    """In-process submit_frames of the TCP runs' events: unpaced (the
    burst rate), or batch b of every sensor submitted once b * 4 * 64 /
    ``rate`` seconds have passed, polling between (bench_net.py's
    driver). Returns events/s, first submit to the last result."""
    server = net_server(chips, redundancy, sources)
    srcs = [src(NET_EVENTS) for src in sources]
    n_events = NET_BATCHES * NET_EVENTS * N_CHIPS
    got = 0
    t0 = time.perf_counter()
    for b in range(NET_BATCHES):
        while rate and b * NET_EVENTS * N_CHIPS / rate > (
                time.perf_counter() - t0):
            got += len(server.poll())
        for s in range(N_CHIPS):
            server.submit_frames(s, *srcs[s](b))
        got += len(server.poll())
    got += len(server.flush())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if got != n_events:
        fail("serve_net", f"in-process {redundancy}: {got} results for "
                          f"{n_events} events")
    return n_events / dt


def net_wire(torch, chips, redundancy, sources, oracles, counters,
             transport, rate):
    """One replay client a sensor against the port's front door over a
    fresh server, on loopback. Checks every trigger against the oracle
    (ReplayReport.verified), the accounting identity of every client,
    0 TMR disagreements and the default path's kernels launched (the
    counters zeroed just before the clients start, read just after)."""
    import asyncio

    from repro_torch.net.ingress import ReadoutFrontDoor
    from repro_torch.net.protocol import UDP_MAX_EVENTS
    from repro_torch.net.replay import ReplayConfig, replay

    phase = "serve_net"
    server = net_server(chips, redundancy, sources)
    door = ReadoutFrontDoor(server)
    udp = transport == "udp"
    per = UDP_MAX_EVENTS if udp else NET_EVENTS
    n_batches = NET_UDP_BATCHES if udp else NET_BATCHES
    cfgs = [ReplayConfig(rate_hz=rate / N_CHIPS, n_batches=n_batches,
                         events_per_batch=per, sensor=s,
                         transport=transport, seed=s,
                         timeout_s=NET_TIMEOUT_S, pre_encode=not rate)
            for s in range(N_CHIPS)]

    async def go():
        await door.start()
        port = door.udp_port if udp else door.tcp_port
        try:
            reset(counters)
            return await asyncio.gather(*(
                replay("127.0.0.1", port, sources[s](per), cfgs[s],
                       oracles[s]) for s in range(N_CHIPS)))
        finally:
            await door.stop()

    reps = asyncio.run(go())
    torch.cuda.synchronize()
    launches = read(counters)
    rep = server.report()
    what = f"{transport} {redundancy} at {rate:.0f} events/s"
    for s, r in enumerate(reps):
        if not r.verified:
            fail(phase, f"{what}: sensor {s} not verified: "
                        f"{r.unanswered} unanswered, mismatches "
                        f"{r.mismatches[:3]}")
    for key, c in rep["net"]["per_client"].items():
        if c["events_in"] != (c["events_admitted"] + c["events_shed"]
                              + c["events_queue_dropped"]
                              + c["events_bad_sensor"]):
            fail(phase, f"{what}: client {key} accounting {c}")
    if rep["seu_disagreement_total"]:
        fail(phase, f"{what}: {rep['seu_disagreement_total']} replica "
                    "disagreements on a healthy stack")
    for k in ("yprofile", "eval_words_voted", "decode_dense"):
        if launches[k] <= 0:
            fail(phase, f"{what}: kernel {k} never launched")
    n = sum(r.n_events for r in reps)
    # every client's events over the longest client's span (its first
    # send to its last answer; an unpaced client frames its batches
    # before its clock starts, as bench_net.py's flood does)
    longest = max(r.n_events / r.achieved_ev_s for r in reps)
    return {"transport": transport, "redundancy": redundancy,
            "target_ev_s": rate, "events": n,
            "wire_ev_s": n / longest,
            "client_ev_s": [r.achieved_ev_s for r in reps],
            "p50_us": [r.latency["p50_us"] for r in reps],
            "p99_us": [r.latency["p99_us"] for r in reps],
            "kept": sum(r.n_kept for r in reps),
            "bytes_per_event_in": sum(r.bytes_out for r in reps) / n,
            "bytes_per_event_out": sum(r.bytes_in for r in reps) / n,
            "totals": rep["net"]["totals"], "launches": launches}


def serve_net(torch, np, chips, blocks, counters, card):
    """Phase 11, plain then TMR: the in-process burst and paced rates,
    then TCP paced at NET_PACE_FRAC of the burst, TCP unpaced and UDP;
    a line each. Returns the runs by (redundancy, transport, paced)."""
    sources = net_sources(np, blocks)
    oracles = net_oracles(np, chips, sources)
    out = {}
    for red in ("none", "tmr"):
        burst = net_inprocess(torch, chips, red, sources)
        bench = NET_PACE_FRAC * burst
        paced = net_inprocess(torch, chips, red, sources, rate=bench)
        emit("serve_net_inprocess", ok=True, card=card, redundancy=red,
             events=NET_BATCHES * NET_EVENTS * N_CHIPS,
             burst_ev_s=burst, paced_target_ev_s=bench, paced_ev_s=paced)
        for transport, rate, base in (("tcp", bench, paced),
                                      ("tcp", 0.0, burst),
                                      ("udp", NET_UDP_RATE * N_CHIPS, None)):
            run = net_wire(torch, chips, red, sources, oracles, counters,
                           transport, rate)
            if base is not None:
                run["inprocess_ev_s"] = base
                run["wire_over_inprocess"] = run["wire_ev_s"] / base
            emit("serve_net", ok=True, card=card, **run)
            out[red, transport, rate > 0] = run
    return out


def run_examples():
    """Phase 12: the port's example drivers as subprocesses on the card;
    a non-zero exit or a printed mismatch fails."""
    runs = []
    for argv in (["examples/torch_serve_readout.py", "--chips", "2",
                  "--rate-batches", "4"],
                 ["examples/torch_replay_load.py", "--sensors", "2",
                  "--batches", "8"]):
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, *argv], cwd=HERE,
                              capture_output=True, text=True, timeout=600)
        tail = proc.stdout.strip().splitlines()[-4:]
        if proc.returncode != 0 or "MISMATCH" in proc.stdout.upper():
            fail("examples", f"{' '.join(argv)}: exit {proc.returncode}; "
                             f"{tail} {proc.stderr[-2000:]}")
        runs.append({"argv": argv, "seconds": time.monotonic() - t0,
                     "tail": tail})
    return runs


# 13: the multi-tenant fleet (launch/fleet.py). Six tenants: the four
# served chips and two more (FLEET_EXTRA: one of depth 3 with 5 leaves,
# whose inputs put it in an envelope of its own, one of depth 5 with 10
# leaves), two chip slots a bucket, so that the stream going round the
# five tenants of the large envelope evicts the least recently used one
# and re-admits it from its golden image at its next batch.
FLEET_EXTRA = ((40, 3, 5), (41, 5, 10))          # (seed, depth, leaves)
FLEET_TENANTS = N_CHIPS + len(FLEET_EXTRA)
FLEET_SLOTS = 2
FLEET_STEPS = 6
FLEET_LATE_AT = 2      # the last tenant's first batch: a warm admission
FLEET_EVICT_AT = 3     # tenant 1 evicted with drain=False right after its
#                        batch of this step is queued
FLEET_QUOTA = 128
# benchmarks/bench_fleet.py: 4 slots a bucket, 16 events a tenant
FLEET_BENCH_SLOTS = 4
FLEET_BENCH_TENANTS = (2, 16, 64)
FLEET_BENCH_EVENTS = 16
FLEET_BENCH_REPS = 3
# the door in front of the fleet: sensors 0-3 are tenants t0-t3, sensor
# FLEET_DOOR_UNMAPPED maps to nothing and FLEET_DOOR_RETIRED to a retired
# tenant; each of the two sends FLEET_DOOR_BAD_BATCHES batches
FLEET_DOOR_UNMAPPED = 4
FLEET_DOOR_RETIRED = 5
FLEET_DOOR_BAD_BATCHES = 4
# the deep ensemble of benchmarks/bench_fabric.py (4 trees of depth 3 with
# 6 leaves, efpga_28nm_xl, a 16-bit spec with 8 integer bits)
FLEET_DEEP_SEED = 2040


def fleet_oracle(np, chips, blocks, yp):
    """Per (step, tenant): the numpy oracle's (score, keep) on the
    featurizer kernel's features of the tenant's block."""
    from repro_torch.core.fabric import FabricSim

    out = []
    for step in range(FLEET_STEPS):
        row = []
        for t, chip in enumerate(chips):
            blk = blocks[step][t]
            feats = yp.yprofile(blk["frames"], blk["y0"],
                                device="cuda").cpu().numpy()
            outs, _ = FabricSim(chip.config).run(chip.encode_features(feats))
            score = chip.synth.decode_outputs(np.asarray(outs))
            row.append((score, score <= chip.score_threshold_raw))
        out.append(row)
    return out


def found_buckets(fleet, chips, blocks):
    """Open every bucket through a founding tenant (the first chip of each
    envelope) that serves one block, then retire the founders: the
    buckets stay, their fused passes built, with every slot free. Returns
    the founders' admission infos (cold)."""
    from repro_torch.kernels.lut_eval.ops import bucket_envelope

    infos, seen = [], set()
    for t, chip in enumerate(chips):
        env = bucket_envelope(chip.config, fleet.config.band)
        if env in seen:
            continue
        seen.add(env)
        key = f"founder{t}"
        infos.append(fleet.admit(key, chip))
        fleet.submit_frames(key, blocks[0][t]["frames"], blocks[0][t]["y0"])
        fleet.flush()
        fleet.retire(key)
    return infos


def bucket_state(fleet):
    """Per bucket: the storage of its stack's and fused pass's tensors and
    its copy stream — what a warm admission must leave as it is."""
    out = []
    for b in fleet._buckets:
        srv = b.server
        st = srv._stack
        fe = srv._frontend
        out.append({
            "stack": [t.data_ptr() for t in (st.tables, st.output_nets,
                                             st.src if st.bitsliced
                                             else st.sel)],
            "plan": ({k: v.data_ptr() for k, v in fe.plan.items()}
                     if fe is not None else None),
            "staging": ({str(k): [t.data_ptr() for t in v]
                         for k, v in fe.staging.items()}
                        if fe is not None else None),
            "copy_stream": srv._copy_stream,
        })
    return out


def buckets_kept(before, after):
    """Every bucket of ``before`` with its stack, encode plan and copy
    stream where they were, and every staging buffer it had still there
    (a batch width first seen later adds buffers of its own)."""
    return len(after) >= len(before) and all(
        {k: a[k] for k in ("stack", "plan", "copy_stream")}
        == {k: b[k] for k in ("stack", "plan", "copy_stream")}
        and all(b["staging"].get(k) == v
                for k, v in (a["staging"] or {}).items())
        for a, b in zip(before, after))


def serve_fleet(torch, np, chips, blocks, want, counters, what, **cfg_kw):
    """One fleet run over the six tenants' stream (FLEET_STEPS batches of
    256 events a tenant through submit_frames, polled after each), the
    buckets opened first (found_buckets). Tenant FLEET_TENANTS-1 first
    submits at FLEET_LATE_AT (a warm admission mid-stream, into a full
    bucket); tenant 1 is evicted without draining right after its batch
    of FLEET_EVICT_AT is queued. Checks: every delivered (seq, tenant,
    score, keep) equals the oracle, no admitted event lost but the
    cancelled ones, every tenant's ledger closes with nothing
    outstanding, 0 TMR disagreements, the path's kernels launched (the
    counters zeroed just before the stream and read just after), no
    admission miss (a swap, or a launch at a batch width its bucket had
    launched, adding a build or a launch signature, up to the admitted
    tenant's first result), every bucket's stack, fused pass, copy stream
    and staging buffers where the founders left them, and (without a
    quota) evictions and
    golden re-admissions."""
    from repro_torch.launch.fleet import TenantFleet
    from repro_torch.launch.readout_server import ServerConfig

    phase = "serve_fleet"
    fleet = TenantFleet(ServerConfig(**cfg_kw), bucket_slots=FLEET_SLOTS,
                        device="cuda")
    founders = found_buckets(fleet, chips, blocks)
    torch.cuda.synchronize()
    state0 = bucket_state(fleet)
    reset(counters)
    where, results, infos = {}, [], []
    t0 = time.perf_counter()
    for step in range(FLEET_STEPS):
        for t in range(FLEET_TENANTS):
            key = f"t{t}"
            if t == FLEET_TENANTS - 1 and step < FLEET_LATE_AT:
                continue
            if not fleet.has_tenant(key):
                infos.append((step, key, fleet.admit(key, chips[t])))
            blk = blocks[step][t]
            seqs = fleet.submit_frames(key, blk["frames"], blk["y0"])
            for row, s in enumerate(seqs):
                if s is not None:
                    where[s] = (step, t, row)
            if step == FLEET_EVICT_AT and t == 1:
                fleet.evict(key, drain=False)
            results += fleet.poll()
    results += fleet.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read(counters)
    rep = fleet.report()

    seqs = [r.seq for r in results]
    if len(set(seqs)) != len(seqs) or not set(seqs) <= set(where):
        fail(phase, f"{what}: duplicate or unknown seqs among "
                    f"{len(seqs)} delivered events")
    mism = 0
    for r in results:
        step, t, row = where[r.seq]
        score, keep = want[step][t]
        mism += (r.tenant, r.score_raw, r.keep) != (
            f"t{t}", int(score[row]), bool(keep[row]))
    if mism:
        fail(phase, f"{what}: {mism} of {len(results)} delivered events "
                    "differ from the oracle")
    led = rep["tenants"]
    for key, row in led.items():
        if row["outstanding"] or row["events_in"] != (
                row["events_out"] + row["shed"] + row["quota_shed"]
                + row["evicted_while_queued"]):
            fail(phase, f"{what}: tenant {key}'s ledger does not close: "
                        f"{row}")
        if any(row["seu_disagreements"]):
            fail(phase, f"{what}: tenant {key}: replica disagreements "
                        f"{row['seu_disagreements']} on healthy stacks")
    cancelled = sum(led[f"t{t}"]["evicted_while_queued"]
                    for t in range(FLEET_TENANTS))
    if len(results) + cancelled != len(where):
        fail(phase, f"{what}: {len(results)} delivered + {cancelled} "
                    f"cancelled != {len(where)} admitted")
    if not led["t1"]["evicted_while_queued"]:
        fail(phase, f"{what}: evict(drain=False) cancelled nothing")
    layouts = sorted({b.server._stack.layout for b in fleet._buckets})
    need = ["yprofile"] + [FABRIC_KERNEL[k] for k in layouts]
    if "bitsliced" in layouts:
        need.append("decode_dense")
    for k in need:
        if launches[k] <= 0:
            fail(phase, f"{what}: kernel {k} never launched")
    late = [i for s, key, i in infos if key == f"t{FLEET_TENANTS - 1}"]
    if not late or late[0]["cold"] or not late[0]["evicted"]:
        fail(phase, f"{what}: the late tenant's admission {late} was not "
                    "a warm one into a full bucket")
    if rep["admission_misses"]:
        fail(phase, f"{what}: {rep['admission_misses']} warm admissions "
                    "added an nvcc build, a library load or a launch "
                    "signature")
    if not buckets_kept(state0, bucket_state(fleet)):
        fail(phase, f"{what}: a warm admission reallocated a bucket's "
                    "stack, fused pass or copy stream")
    n_evict = sum(row["evictions"] for row in led.values())
    n_readmit = sum(row["readmissions"] for row in led.values())
    if "tenant_quota_queued" not in cfg_kw and not (n_evict and n_readmit):
        fail(phase, f"{what}: {n_evict} evictions, {n_readmit} "
                    "re-admissions")
    if "tenant_quota_queued" in cfg_kw and not rep["quota_shed"]:
        fail(phase, f"{what}: the quota shed nothing")
    return {"config": what, "layouts": layouts,
            "buckets": [{"envelope": b["envelope"],
                         "slots": len(b["slots"])} for b in rep["buckets"]],
            "founders": founders,
            "admissions": [{"step": s, "tenant": k, **i}
                           for s, k, i in infos],
            "events_admitted": len(where), "delivered": len(results),
            "cancelled": cancelled, "quota_shed": rep["quota_shed"],
            "oracle_mismatches": mism, "evictions": n_evict,
            "readmissions": n_readmit,
            "warm_admissions": sum(not i["cold"] for _, _, i in infos),
            "admission_misses": rep["admission_misses"],
            "events_per_s": len(where) / dt, "seconds": dt,
            "launches": launches}


def fleet_bench(torch, np, chips, X):
    """benchmarks/bench_fleet.py on the card (features, max_batch 512,
    4 slots a bucket, bit-sliced): cold admission (a new bucket: its
    server, packed stack and first one-event dispatch, then a flush) and
    warm admission (a same-envelope tenant into that bucket, the same
    dispatch) in microseconds, FLEET_BENCH_REPS each, and of that the
    admit call alone; evict plus the golden re-admission of a one-event
    request, exact against the oracle; the in-place row swap of one
    chip into a 4-slot stack at the bucket's envelope, both layouts;
    then events/s of FLEET_BENCH_EVENTS events a tenant at
    FLEET_BENCH_TENANTS tenants (each cycling over the farm), first
    submit to the flush, admissions before the clock."""
    from repro_torch.core.fabric import FabricSim
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_eval import ops as lut_ops
    from repro_torch.launch.fleet import TenantFleet
    from repro_torch.launch.readout_server import ServerConfig

    phase = "fleet_bench"
    cfg = ServerConfig(max_batch=512, max_latency_s=1e9, batch_tile=128)
    envs = [lut_ops.bucket_envelope(c.config) for c in chips]
    a, b = next((i, j) for i in range(len(envs))
                for j in range(i + 1, len(envs)) if envs[i] == envs[j])

    admit_us = {"cold": [], "warm": []}

    def admit_and_serve(fleet, tenant, chip, kind):
        t0 = time.perf_counter()
        fleet.admit(tenant, chip)
        torch.cuda.synchronize()
        admit_us[kind].append((time.perf_counter() - t0) * 1e6)
        fleet.submit(tenant, X[0])
        fleet.flush()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    def oracle_raw(chip, row):
        outs, _ = FabricSim(chip.config).run(chip.encode_features(row[None]))
        return int(chip.synth.decode_outputs(np.asarray(outs))[0])

    cold, warm, evict_us, readmit_us = [], [], [], []
    misses0 = build.miss_counts()
    for rep in range(FLEET_BENCH_REPS):
        fleet = TenantFleet(cfg, bucket_slots=FLEET_BENCH_SLOTS,
                            device="cuda")
        cold.append(admit_and_serve(fleet, "t_cold", chips[a], "cold"))
        warm.append(admit_and_serve(fleet, "t_warm", chips[b], "warm"))
        if fleet.report()["admission_misses"]:
            fail(phase, "a warm admission added a build or a launch "
                        "signature")
        t0 = time.perf_counter()
        fleet.evict("t_warm")
        evict_us.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        s = fleet.submit("t_warm", X[1 + rep])
        (r,) = [e for e in fleet.flush() if e.seq == s]
        torch.cuda.synchronize()
        readmit_us.append((time.perf_counter() - t0) * 1e6)
        if r.score_raw != oracle_raw(chips[b], X[1 + rep]):
            fail(phase, "the re-admitted tenant diverged from the oracle")
    swap_us = {}
    for layout in ("bitsliced", "matmul"):
        stack = lut_ops.pack_fabrics(
            [chips[a].config] * FLEET_BENCH_SLOTS, layout=layout,
            geometry=envs[a], device="cuda")
        samples = []
        for rep in range(FLEET_BENCH_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stack.swap_chip(1, chips[b if rep % 2 else a].config,
                            in_place=True)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e6)
        swap_us[layout] = samples[1:]
    rates = {}
    for n_tenants in FLEET_BENCH_TENANTS:
        fl = TenantFleet(cfg, bucket_slots=FLEET_BENCH_SLOTS, device="cuda")
        for i in range(n_tenants):
            fl.admit(f"t{i}", chips[i % len(chips)])
        fl.flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = 0
        for i in range(n_tenants):
            got += sum(s is not None for s in fl.submit_batch(
                f"t{i}", X[:FLEET_BENCH_EVENTS]))
        done = fl.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rep = fl.report()
        if len(done) != got or rep["events_in"] != rep["events_out"]:
            fail(phase, f"{n_tenants} tenants: {len(done)} delivered of "
                        f"{got} admitted")
        rates[n_tenants] = {
            "events_per_s": n_tenants * FLEET_BENCH_EVENTS / dt,
            "seconds": dt, "buckets": rep["n_buckets"],
            "readmissions": sum(v["readmissions"]
                                for v in rep["tenants"].values())}
    return {"bucket_slots": FLEET_BENCH_SLOTS, "features_path": True,
            "cold_us": cold, "warm_us": warm,
            "cold_us_median": float(np.median(cold)),
            "warm_us_median": float(np.median(warm)),
            "warm_over_cold": float(np.median(cold) / np.median(warm)),
            "admit_us": admit_us, "swap_us": swap_us,
            "evict_us": evict_us, "readmit_us": readmit_us,
            "evict_readmit_us_median": float(np.median(
                np.add(evict_us, readmit_us))),
            "build_and_signature_misses": [
                x - y for x, y in zip(build.miss_counts(), misses0)],
            "events_per_tenant": FLEET_BENCH_EVENTS, "rates": rates}


def fleet_k2_depth(torch, np, bs, sp, lut_ops, chips):
    """K2 and B6's dense entry on the four served chips packed to their
    union (13 levels, 28 outputs) and to their bucket envelope (16
    levels, 31 outputs), R=1 and R=3, at the served W=16: the kernels
    exact against their twins on random bits (and the dense entry on the
    walk's words), K2 timed at both depths by CUDA-graph replay, with
    its tile, shared memory and bound (its operations count the real
    LUTs, the same at both depths; its bytes the padded arrays)."""
    configs = [c.config for c in chips]
    env = lut_ops.bucket_envelope(configs[0])
    if not all(env.admits(c) for c in configs):
        fail("fleet_k2", f"the served chips do not share {env}")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(19)
    W = SERVED_B // 32
    thr = torch.as_tensor([c.score_threshold_raw for c in chips],
                          dtype=torch.int32, device="cuda")
    out = {}
    for red in ("none", "tmr"):
        for name, geo in (("union", None), ("envelope", env)):
            stack = lut_ops.pack_fabrics(configs, redundancy=red,
                                         layout="bitsliced", geometry=geo,
                                         device="cuda")
            R, L, M = stack.n_replicas, stack.n_levels, stack.m_pad
            bits = torch.as_tensor(
                rng.integers(0, 2, (N_CHIPS, W * 32, stack.n_inputs)),
                dtype=torch.int32, device="cuda")
            seg = bs.input_words(bits, stack.n_inputs, stack.in_seg)
            args = (stack.src, stack.tables, stack.output_nets, seg, R)
            got = bs.eval_seg_voted(*args)
            want = bs.eval_seg_voted_plain(*args)
            torch.cuda.synchronize()
            for x, y, k in zip(got, want, ("voted", "disagree")):
                if not torch.equal(x, y):
                    fail("fleet_k2", f"{name} R={R}: K2 {k} words differ")
            weight = torch.as_tensor(
                lut_ops.decode_plan(configs, stack.n_outputs),
                device="cuda")
            valid = torch.ones((N_CHIPS, W * 32), dtype=torch.bool,
                               device="cuda")
            dense = sp.decode_dense(got[0], got[1], weight, thr, valid)
            plain = sp.decode_dense_plain(got[0], got[1], weight, thr, valid)
            torch.cuda.synchronize()
            for x, y, k in zip(dense, plain, ("score", "keep", "dis")):
                if not torch.equal(x, y):
                    fail("fleet_k2", f"{name} R={R}: B6 dense {k} differs")
            C, _, in_seg = seg.shape
            tile = bs.word_tile(R, in_seg, L, M, W, C, n_sms)
            scratch = bs.scratch_for(C, R, L, M, "cuda")
            voted = torch.empty_like(got[0])
            dis = torch.empty_like(got[1])

            def k2_call():
                bs._launch(stack.src, stack.tables, stack.output_nets, seg,
                           scratch, voted, dis, R, tile)
            cost = k2_cost(stack, seg, sum(c.n_luts for c in configs))
            out[f"R{R}_{name}"] = {
                "levels": L, "m_pad": M, "outputs": stack.n_outputs,
                "in_seg": in_seg, "words": W, "tile": tile,
                "smem_bytes": bs.smem_bytes(R, in_seg, L, M, tile),
                "ms": graph_ms(k2_call),
                "plain_ms": time_ms(lambda: bs.eval_seg_voted_plain(*args),
                                    reps=10, inner=1),
                **bound(*cost)}
    for R in (1, 3):
        out[f"R{R}_envelope_over_union"] = (
            out[f"R{R}_envelope"]["ms"] / out[f"R{R}_union"]["ms"])
    return out


def synthetic_walk_stack(torch, np, C, R, L, M, in_seg, n_inputs, O, seed,
                         device="cuda"):
    """Bit-sliced stack arrays of the kernel's contract that no packing
    makes: (src (R*C, L, M, 4), tables (R*C, L, M, 16) 0/1, output_nets
    (R*C, O)). Level l's LUTs read any net below its slots (const0/1, the
    inputs and every earlier level's slots), the outputs any level slot;
    the replicas of a chip differ."""
    rng = np.random.default_rng(seed)
    n_in = 2 + n_inputs
    n_valid = n_in + np.arange(L) * M                 # nets below level l
    u = (rng.random((R * C, L, M, 4)) * n_valid[None, :, None, None])
    u = u.astype(np.int64)
    src = np.where(u < n_in, u, in_seg + u - n_in).astype(np.int32)
    tables = rng.integers(0, 2, (R * C, L, M, 16)).astype(np.float32)
    outs = rng.integers(in_seg, in_seg + L * M, (R * C, O)).astype(np.int32)
    return (torch.as_tensor(src, device=device),
            torch.as_tensor(tables, device=device),
            torch.as_tensor(outs, device=device))


def deep_case(torch, np, bs, st, words, n_luts, seed):
    """K2 on the deep bucket's stack ``st`` at ``words`` words a chip:
    exact against its twin on random bits, also with replica 1's tables
    upset under TMR (which must give disagreement words); the walk's path,
    tile and shared memory, its time by CUDA-graph replay, its twin's time
    and its bound."""
    R, L, M = st.n_replicas, st.n_levels, st.m_pad
    C = st.src.shape[0] // R
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (C, words * 32, st.n_inputs)),
                           dtype=torch.int32, device="cuda")
    seg = bs.input_words(bits, st.n_inputs, st.in_seg)
    upset = st.tables.clone()
    if R > 1:
        upset[1, :, :16, ::3] = 1.0 - upset[1, :, :16, ::3]
    for tb in (st.tables, upset):
        a = (st.src, tb, st.output_nets, seg, R)
        got = bs.eval_seg_voted(*a)
        want = bs.eval_seg_voted_plain(*a)
        torch.cuda.synchronize()
        for x, y, what in zip(got, want, ("voted", "disagree")):
            if x.shape != y.shape or not torch.equal(x, y):
                fail("fleet_deep", f"K2 R={R} W={words}: {what} words "
                                   f"differ in {int((x != y).sum())} places")
    if R > 1 and not bool((got[1] != 0).any()):
        fail("fleet_deep", f"K2 R={R}: an upset replica gave no "
                           "disagreement words")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    in_seg, O = st.in_seg, st.n_outputs
    tile = bs.word_tile(R, in_seg, L, M, words, C, n_sms)
    scratch = bs.scratch_for(C, R, L, M, "cuda")
    path = bs.walk_path(R, in_seg, L, M)
    rep = (bs.split_buffers(C, R, words, O, "cuda") if path == "split"
           else None)
    voted = torch.empty((C, words, O), dtype=torch.int32, device="cuda")
    dis = torch.empty((C, R, words), dtype=torch.int32, device="cuda")
    args = (st.src, st.tables, st.output_nets, seg, R)

    def k2_call():
        bs._launch(st.src, st.tables, st.output_nets, seg, scratch, voted,
                   dis, R, tile, rep)
    return {"path": path, "words": words, "tile": tile,
            "smem_bytes": bs.smem_bytes(R, in_seg, L, M, tile),
            "levels": L, "m_pad": M, "in_seg": in_seg,
            "ms": graph_ms(k2_call),
            "plain_ms": time_ms(lambda: bs.eval_seg_voted_plain(*args),
                                reps=5, inner=1),
            **bound(*k2_cost(st, seg, n_luts))}


def fleet_deep(torch, np, counters):
    """The deep ensemble of benchmarks/bench_fabric.py through a
    bit-sliced fleet on the card: its bucket envelope (32 levels x 256),
    plain and under TMR, 64 events each exact against the oracle. Under
    TMR one word's block of every replica (bitsliced.smem_bytes of the
    staged walk) exceeds shared memory, so K2 takes its split walk (a
    block a replica, then a vote pass: ROADMAP C.3, repaired); K2 must
    have launched in each run. Then K2 alone on each bucket's stack at
    W=16: exact against its twin (an upset replica under TMR), with its
    path, shared memory, time and bound."""
    import repro_torch.core.tmr  # noqa: F401  (registers efpga_28nm_xl)
    from repro_torch.core.bdt import GradientBoostedClassifier
    from repro_torch.core.fabric import FabricSim
    from repro_torch.core.quantize import FixedSpec
    from repro_torch.core.readout import ReadoutChip
    from repro_torch.data.smartpixel import (
        SmartPixelConfig, generate, train_test_split)
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_eval import bitsliced as bs
    from repro_torch.kernels.lut_eval.ops import bucket_envelope
    from repro_torch.launch.fleet import TenantFleet
    from repro_torch.launch.readout_server import ServerConfig

    tr, te = train_test_split(generate(SmartPixelConfig(
        n_events=30_000, seed=FLEET_DEEP_SEED)))
    clf = GradientBoostedClassifier(
        n_estimators=4, max_depth=3, max_leaf_nodes=6,
        min_samples_leaf=300).fit(tr["features"], tr["label"])
    chip = ReadoutChip.build(clf, fabric="efpga_28nm_xl",
                             spec=FixedSpec(width=16, int_bits=8))
    cfg = chip.config
    env = bucket_envelope(cfg)
    X = te["features"][:64]
    outs, _ = FabricSim(cfg).run(chip.encode_features(X))
    want = chip.synth.decode_outputs(np.asarray(outs))
    in_seg = -(-(2 + env.n_inputs) // 128) * 128
    out = {"levels": len(cfg.level_sizes),
           "widest": max(cfg.level_sizes), "inputs": cfg.n_inputs,
           "outputs": len(cfg.output_nets),
           "envelope": {"n_levels": env.n_levels,
                        "max_level_size": env.max_level_size,
                        "n_inputs": env.n_inputs,
                        "n_outputs": env.n_outputs,
                        "fanin_reach": env.fanin_reach},
           "smem_limit_bytes": build.SMEM_LIMIT_BYTES}
    for red in ("none", "tmr"):
        R = 3 if red == "tmr" else 1
        L, M = env.n_levels, env.max_level_size
        row = {"descriptor_bytes": bs._chip_desc_bytes(R, L, M),
               "staged_one_word_smem_bytes": bs._block_bytes(
                   R, in_seg, L, M, 1),
               "path": bs.walk_path(R, in_seg, L, M),
               "one_word_smem_bytes": bs.smem_bytes(R, in_seg, L, M, 1)}
        fleet = TenantFleet(ServerConfig(redundancy=red), bucket_slots=2,
                            device="cuda")
        fleet.admit("deep", chip)
        st = fleet._buckets[0].server._stack
        reset(counters)
        seqs = fleet.submit_batch("deep", X)
        got = {r.seq: r.score_raw for r in fleet.flush()}
        torch.cuda.synchronize()
        row["launches"] = read(counters)
        row["oracle_mismatches"] = int(sum(
            got.get(s) != int(w) for s, w in zip(seqs, want)))
        if len(got) != len(seqs) or row["oracle_mismatches"]:
            fail("fleet_deep", f"{red}: {row['oracle_mismatches']} "
                               f"events differ from the oracle, "
                               f"{len(seqs) - len(got)} missing")
        if row["launches"]["eval_words_voted"] <= 0:
            fail("fleet_deep", f"{red}: K2 never launched")
        row["served"] = True
        row["kernel"] = deep_case(torch, np, bs, st, SERVED_B // 32,
                                  cfg.n_luts, seed=41 + R)
        out[red] = row
    if out["tmr"]["path"] != "split":
        fail("fleet_deep", f"TMR took K2's {out['tmr']['path']} walk, "
                           "expected the split walk")
    return out


def fleet_door(torch, np, chips, blocks, counters):
    """One TCP replay client a sensor against the port's front door with
    sensor_tenants in front of a fleet on the card (ServerConfig(), two
    slots a bucket): sensors 0-3 are tenants t0-t3 (the served chips),
    FLEET_DOOR_UNMAPPED maps to no tenant and FLEET_DOOR_RETIRED to a
    retired one. Checks: every mapped sensor's triggers verified against
    host_oracle on the card, the two others answered nothing and counted
    as events_bad_sensor (FLEET_DOOR_BAD_BATCHES x 64 events each), each
    client's accounting identity, the default path's kernels launched."""
    import asyncio

    from repro_torch.launch.fleet import TenantFleet
    from repro_torch.launch.readout_server import ServerConfig
    from repro_torch.net.ingress import FrontDoorConfig, ReadoutFrontDoor
    from repro_torch.net.replay import ReplayConfig, replay

    phase = "fleet_door"
    sources = net_sources(np, blocks)
    oracles = net_oracles(np, chips, sources)
    fleet = TenantFleet(ServerConfig(), bucket_slots=FLEET_SLOTS,
                        device="cuda")
    for s in range(N_CHIPS):
        fleet.admit(f"t{s}", chips[s])
        fleet.submit_frames(f"t{s}", *sources[s](NET_EVENTS)(0))
    fleet.admit("gone", chips[1])
    fleet.retire("gone")
    fleet.flush()
    mapping = {s: f"t{s}" for s in range(N_CHIPS)}
    mapping[FLEET_DOOR_RETIRED] = "gone"
    door = ReadoutFrontDoor(fleet, FrontDoorConfig(sensor_tenants=mapping))
    sensors = list(range(N_CHIPS)) + [FLEET_DOOR_UNMAPPED,
                                      FLEET_DOOR_RETIRED]
    cfgs = [ReplayConfig(rate_hz=0.0, n_batches=NET_BATCHES,
                         events_per_batch=NET_EVENTS, sensor=s,
                         transport="tcp", seed=s, timeout_s=NET_TIMEOUT_S,
                         pre_encode=True) for s in range(N_CHIPS)]
    cfgs += [ReplayConfig(rate_hz=0.0, n_batches=FLEET_DOOR_BAD_BATCHES,
                          events_per_batch=NET_EVENTS, sensor=s,
                          transport="tcp", seed=s, timeout_s=2.0,
                          pre_encode=True) for s in sensors[N_CHIPS:]]

    async def go():
        await door.start()
        try:
            reset(counters)
            return await asyncio.gather(*(
                replay("127.0.0.1", door.tcp_port,
                       sources[i % N_CHIPS](NET_EVENTS), cfg,
                       oracles[i] if i < N_CHIPS else None)
                for i, cfg in enumerate(cfgs)))
        finally:
            await door.stop()

    t0 = time.perf_counter()
    reps = asyncio.run(go())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read(counters)
    rep = fleet.report()
    for s, r in zip(sensors, reps):
        if s < N_CHIPS and not r.verified:
            fail(phase, f"sensor {s} not verified: {r.unanswered} "
                        f"unanswered, mismatches {r.mismatches[:3]}")
        if s >= N_CHIPS and r.n_triggers:
            fail(phase, f"sensor {s} got {r.n_triggers} triggers")
    totals = rep["net"]["totals"]
    bad = 2 * FLEET_DOOR_BAD_BATCHES * NET_EVENTS
    if totals["events_bad_sensor"] != bad:
        fail(phase, f"events_bad_sensor {totals['events_bad_sensor']}, "
                    f"the two sensors sent {bad}")
    for key, c in rep["net"]["per_client"].items():
        if c["events_in"] != (c["events_admitted"] + c["events_shed"]
                              + c["events_queue_dropped"]
                              + c["events_bad_sensor"]):
            fail(phase, f"client {key} accounting {c}")
    for k in ("yprofile", "eval_words_voted", "decode_dense"):
        if launches[k] <= 0:
            fail(phase, f"kernel {k} never launched")
    return {"sensor_tenants": {str(k): v for k, v in mapping.items()},
            "events": sum(r.n_events for r in reps),
            "verified_sensors": [s for s, r in zip(sensors, reps)
                                 if r.verified],
            "events_bad_sensor": totals["events_bad_sensor"],
            "events_admitted": totals["events_admitted"],
            "kept": sum(r.n_kept for r in reps), "seconds": dt,
            "readmissions": sum(v["readmissions"]
                                for v in rep["tenants"].values()),
            "admission_misses": rep["admission_misses"],
            "launches": launches}


# the LM serving phase: the full-width models, their serve shape, the
# card-vs-CPU decode steps and the decode-vs-forward / int8-vs-bf16 checks
LM_FULL = ("gemma-7b", "starcoder2-7b")
LM_BATCH, LM_PROMPT, LM_GEN = 8, 32, 64
LM_CPU_STEPS = 8
LM_CPU_TOL = 1e-4
# int8 KV caches, card against CPU: the two sides' float32 K/V differ in
# the last bits (summation order), so an entry at a rounding boundary can
# land one int8 step apart, and the logits then differ by about 5e-4 (an
# H100 run of TINY). Such entries are counted; each may be one step off,
# and they must be under LM_INT8_FLIP_SHARE of the written entries
LM_INT8_TOL = 1e-2
LM_INT8_FLIP_SHARE = 1e-3
LM_CHECK_LAYERS = 2
LM_CHECK_T = 12


def lm_smoke_cases():
    """(name, config) of TINY and the smoke config of every dense arch and
    the VLM backbone, as the CPU tests hold them against JAX."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.train import TINY

    return [("tiny", TINY)] + [
        (n, smoke_config(n)) for n in sorted(ARCHS)
        if ARCHS[n].family in ("dense", "vlm")]


def lm_inputs(torch, cfg, B, n, seed):
    g = torch.Generator().manual_seed(seed)
    if cfg.embeds_in:
        return torch.randn((B, n, cfg.d_model), generator=g) * 0.02
    return torch.randint(0, cfg.vocab, (B, n), generator=g,
                         dtype=torch.int32)


def lm_enc_embeds(torch, cfg, B, seed):
    """An encdec model's encoder input (B, enc_len, d_model), on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, cfg.enc_len, cfg.d_model), generator=g) * 0.02


def lm_cache(registry, cfg, B, T, device, params, enc):
    """``registry.init_cache`` on ``device``; an encdec model's runs its
    encoder on ``enc``."""
    kw = {}
    if cfg.family == "encdec":
        kw = {"params": params, "enc_embeds": enc.to(device)}
    return registry.init_cache(cfg, B, T, device=device, **kw)


def lm_card_vs_cpu(torch, np, serve, registry, cases, phase):
    """(i) each (name, config, KV cache dtypes) of ``cases`` in f32 (TF32
    off), the same weights on the card and on the CPU: 8 teacher-forced
    decode steps, logits within LM_CPU_TOL with f32 KV caches; with int8
    caches within LM_INT8_TOL, the int8 entries that differ counted (at
    most one step each, under LM_INT8_FLIP_SHARE of those written)."""
    import dataclasses

    out = {}
    for name, base, kvs in cases:
        for kv in kvs:
            cfg = dataclasses.replace(base, kv_cache_dtype=kv)
            cpu = serve.build(cfg, 0, "cpu")
            card = _tree_to(cpu, "cuda")
            x = lm_inputs(torch, cfg, 2, LM_CPU_STEPS, seed=5)
            enc = lm_enc_embeds(torch, cfg, 2, seed=6)
            with torch.no_grad():
                caches = {"cpu": lm_cache(registry, cfg, 2, LM_CPU_STEPS,
                                          "cpu", cpu, enc),
                          "cuda": lm_cache(registry, cfg, 2, LM_CPU_STEPS,
                                           "cuda", card, enc)}
            worst = 0.0
            with torch.no_grad():
                for t in range(LM_CPU_STEPS):
                    lc, caches["cpu"] = registry.decode_step(
                        cfg, cpu, caches["cpu"], x[:, t:t + 1])
                    lg, caches["cuda"] = registry.decode_step(
                        cfg, card, caches["cuda"], x[:, t:t + 1].cuda())
                    d = (lg.float().cpu() - lc.float()).abs()
                    tol = LM_CPU_TOL if kv == "float32" else LM_INT8_TOL
                    lim = tol + tol * lc.float().abs()
                    worst = max(worst, float((d / lim).max()))
                    if not bool(torch.isfinite(lg).all()) or \
                            bool((d > lim).any()):
                        fail(phase, f"{name} kv={kv} step {t}: card "
                                    f"logits differ from the CPU's by "
                                    f"{float(d.max()):.3g}")
            row = {"max_err_over_tol": worst, "vocab": cfg.vocab}
            if kv == "int8":
                cc, cg = caches["cpu"], caches["cuda"]
                steps = [(cg[k].cpu().int() - cc[k].int()).abs()
                         for k in ("k", "v")]
                row["int8_entries_differing"] = sum(
                    int((x != 0).sum()) for x in steps)
                row["int8_entries_written"] = sum(
                    x.numel() for x in steps)
                row["int8_max_step"] = max(int(x.max()) for x in steps)
                if row["int8_max_step"] > 1 or row[
                        "int8_entries_differing"] > LM_INT8_FLIP_SHARE * \
                        row["int8_entries_written"]:
                    fail(phase, f"{name} int8: "
                                f"{row['int8_entries_differing']} "
                                f"cache entries differ, up to "
                                f"{row['int8_max_step']} steps")
            out[f"{name}/{kv}"] = row
    return out


def lm_bound_ms(params, cfg, B, pos):
    """The least time of one decode step at position ``pos``, over the HBM
    rate: every parameter byte read once but an untied input embedding
    table, of which the step gathers B rows (the MoE's capacity dispatch
    runs every expert, so all of them count); the KV entries (and int8
    scales) up to ``pos`` of every attention layer (the hybrid's: one
    cache an application of its shared block); the SSM state and conv
    buffer, read and written; encdec's cross K/V. Returns (ms, parameter
    bytes, cache bytes)."""
    import torch

    from repro_torch.models.hybrid import n_shared_applications
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.ssm import _dims

    p_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if not cfg.tie_embeddings:
        tok = params["embed"]["tok"]
        p_bytes -= (tok.shape[0] - B) * tok.shape[1] * tok.element_size()
    es = torch.empty((), dtype=dtype_of(cfg)).element_size()
    hd = cfg.resolved_head_dim()
    int8 = cfg.family in ("dense", "vlm", "moe") and \
        cfg.kv_cache_dtype == "int8"
    kv_layers = {"ssm": 0, "hybrid": n_shared_applications(cfg)}.get(
        cfg.family, cfg.n_layers)
    c_bytes = 2 * kv_layers * B * pos * cfg.n_kv_heads * hd * (
        1 if int8 else es)
    if int8:
        c_bytes += 2 * kv_layers * B * pos * 2
    if cfg.family in ("ssm", "hybrid"):
        _, H, N, conv_ch = _dims(cfg)
        c_bytes += 2 * cfg.n_layers * B * (
            H * cfg.ssm_head_dim * N * 4 + (cfg.ssm_conv - 1) * conv_ch * es)
    if cfg.family == "encdec":
        c_bytes += 2 * cfg.n_layers * B * cfg.enc_len * cfg.n_kv_heads * \
            hd * es
    return (p_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3, p_bytes, c_bytes


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def lm_full(torch, np, serve, name, phase="lm_serve"):
    """(ii) ``name`` at full width and depth on the card, bf16, with its
    own KV cache dtype: batch 8, prompt 32, generation 64 through
    launch/serve.py's build and generate, greedy (an encdec model on
    random encoder input at its enc_len)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = serve.build(cfg, 0, "cuda")
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    enc = (lm_enc_embeds(torch, cfg, LM_BATCH, seed=4)
           if cfg.family == "encdec" else None)
    r = serve.generate(cfg, params, batch=LM_BATCH, prompt_len=LM_PROMPT,
                       gen=LM_GEN, seed=0, temperature=0.0, device="cuda",
                       enc_embeds=enc)
    toks = r["tokens"]
    if tuple(toks.shape) != (LM_BATCH, LM_GEN) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab or \
            not bool(torch.isfinite(r["logits"]).all()):
        fail(phase, f"{name}: generation gave {tuple(toks.shape)} "
                    "tokens out of range or non-finite logits")
    # the generation steps read the cache up to positions 32..95
    mid = LM_PROMPT + LM_GEN // 2
    bound, p_bytes, c_bytes = lm_bound_ms(params, cfg, LM_BATCH, mid)
    row = {"family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model,
           "vocab": cfg.vocab, "param_dtype": cfg.param_dtype,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "params": sum(t.numel() for t in _leaves(params)),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in _leaves(params)),
           "param_bytes_read": p_bytes, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "gen": LM_GEN,
           "init_s": t_init, "prefill_s": r["prefill_s"],
           "gen_s": r["gen_s"], "gen_tok_s": r["tok_s"],
           "step_ms": r["step_ms"],
           "step_bound_ms": bound, "bound_cache_bytes_at": mid,
           "step_bound_cache_bytes": c_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "first_tokens": toks[0, :8].tolist()}
    del params, r
    torch.cuda.empty_cache()
    return row


def lm_decode_vs_forward(torch, serve, registry, dense, cfg, seed):
    """Token-by-token decode of ``cfg`` on the card against its forward on
    the same tokens: (decode logits (2, T, V) f32, forward's, the largest
    |difference| over rtol = atol = 2e-2)."""
    params = serve.build(cfg, seed, "cuda")
    toks = lm_inputs(torch, cfg, 2, LM_CHECK_T, seed=2).cuda()
    with torch.no_grad():
        full = dense.forward(cfg, params, toks).float()
        cache = registry.init_cache(cfg, 2, LM_CHECK_T, device="cuda")
        steps = []
        for t in range(LM_CHECK_T):
            logits, cache = registry.decode_step(cfg, params, cache,
                                                 toks[:, t:t + 1])
            steps.append(logits[:, 0].float())
    got = torch.stack(steps, 1)
    d = (got - full).abs()
    del params
    torch.cuda.empty_cache()
    return got, full, float((d / (2e-2 + 2e-2 * full.abs())).max()), \
        float(d.max()), int((d > 2e-2 + 2e-2 * full.abs()).sum())


def lm_checks(torch, np, serve, registry, dense):
    """(iii) gemma-7b at full width with LM_CHECK_LAYERS layers on the
    card. Token-by-token decode against forward within rtol = atol = 2e-2
    in f32 (TF32 off), as tests/test_models.py holds it (its smoke
    configs are f32); the same in bf16, recorded (the logits are bf16 and
    the two paths round in other places). The int8 KV cache against the
    bf16 one on the same bf16 weights and tokens: max |dp| < 0.05 and
    top-1 equal at the last step."""
    import dataclasses

    from repro_torch.configs import get_arch

    base = dataclasses.replace(get_arch("gemma-7b"), n_layers=LM_CHECK_LAYERS,
                               kv_cache_dtype="bfloat16")
    out = {}
    cfg32 = dataclasses.replace(base, param_dtype="float32")
    _, _, over, worst, n_over = lm_decode_vs_forward(
        torch, serve, registry, dense, cfg32, seed=1)
    out["f32_decode_vs_forward"] = {"max_abs": worst, "max_over_tol": over,
                                    "entries_over_tol": n_over}
    if n_over:
        fail("lm_serve", f"gemma-7b x{LM_CHECK_LAYERS} f32: decode differs "
                         f"from forward by {worst:.3g} ({n_over} entries "
                         "over 2e-2)")
    got_bf, _, over, worst, n_over = lm_decode_vs_forward(
        torch, serve, registry, dense, base, seed=1)
    out["bf16_decode_vs_forward"] = {"max_abs": worst, "max_over_tol": over,
                                     "entries_over_tol": n_over,
                                     "entries": got_bf.numel()}
    got_q, _, _, _, _ = lm_decode_vs_forward(
        torch, serve, registry, dense,
        dataclasses.replace(base, kv_cache_dtype="int8"), seed=1)
    pq = torch.softmax(got_q[:, -1], -1)
    pf = torch.softmax(got_bf[:, -1], -1)
    out["int8_vs_bf16_max_dp"] = float((pq - pf).abs().max())
    out["int8_vs_bf16_top1_equal"] = bool(
        (pq.argmax(-1) == pf.argmax(-1)).all())
    out["int8_vs_bf16_max_abs_logit"] = float((got_q - got_bf).abs().max())
    if out["int8_vs_bf16_max_dp"] >= 0.05 or \
            not out["int8_vs_bf16_top1_equal"]:
        fail("lm_serve", f"gemma-7b x{LM_CHECK_LAYERS}: int8 cache against "
                         f"bf16: max |dp| {out['int8_vs_bf16_max_dp']:.3g}, "
                         f"top-1 equal {out['int8_vs_bf16_top1_equal']}")
    return out


def lm_serve(torch, np):
    """The dense LM serving path (repro_torch/models, launch/serve.py) on
    the card: (i) card against CPU, (ii) gemma-7b and starcoder2-7b at
    full width and depth, (iii) decode against forward and int8 against
    bf16 at gemma-7b's full width."""
    from repro_torch.launch import serve
    from repro_torch.models import dense, registry

    out = {"card_vs_cpu": lm_card_vs_cpu(
        torch, np, serve, registry,
        [(n, c, ("float32", "int8")) for n, c in lm_smoke_cases()],
        "lm_serve")}
    emit("lm_card_vs_cpu", ok=True, **out["card_vs_cpu"])
    out["full"] = {}
    for n in LM_FULL:
        out["full"][n] = lm_full(torch, np, serve, n)
        emit("lm_full", ok=True, name=n, **out["full"][n])
    out["checks"] = lm_checks(torch, np, serve, registry, dense)
    return out


# 15: the MoE, SSM, hybrid and encoder-decoder families
# (repro_torch/models/{moe,ssm,hybrid,encdec}.py): their smoke configs on
# the card against the CPU (the MoE's also with int8 caches), decode
# against forward at tests/test_models.py's settings (the MoE at capacity
# factor 16: at 1.25 its drops depend on the token grouping), and the
# four that fit one card at full width and depth (grok-1-314b, 427 GB in
# bf16, only at its smoke width)
LM_FAMILY_SMOKE = ("deepseek-moe-16b", "grok-1-314b", "mamba2-130m",
                   "zamba2-1.2b", "whisper-tiny")
LM_FAMILY_FULL = ("deepseek-moe-16b", "mamba2-130m", "zamba2-1.2b",
                  "whisper-tiny")
LM_DVF = {"moe": ({"capacity_factor": 16.0}, 2e-2), "ssm": ({}, 3e-2),
          "hybrid": ({}, 2e-2), "encdec": ({}, 2e-2)}
LM_DVF_T = 16


def lm_family_decode_vs_forward(torch, serve, registry, cfg, tol, seed):
    """Token-by-token decode of ``cfg`` on the card (f32, TF32 off)
    against its forward on the same tokens: the largest |difference|,
    its ratio to tol + tol * |forward| and the entries over it."""
    params = serve.build(cfg, seed, "cuda")
    toks = lm_inputs(torch, cfg, 2, LM_DVF_T, seed=2).cuda()
    enc = lm_enc_embeds(torch, cfg, 2, seed=3).cuda()
    mod = registry.model_for(cfg)
    with torch.no_grad():
        full = (mod.forward(cfg, params, enc, toks) if cfg.family == "encdec"
                else mod.forward(cfg, params, toks))
        full = (full[0] if isinstance(full, tuple) else full).float()
        cache = lm_cache(registry, cfg, 2, LM_DVF_T, "cuda", params, enc)
        steps = []
        for t in range(LM_DVF_T):
            logits, cache = registry.decode_step(cfg, params, cache,
                                                 toks[:, t:t + 1])
            steps.append(logits[:, 0].float())
    d = (torch.stack(steps, 1) - full).abs()
    lim = tol + tol * full.abs()
    del params, cache
    torch.cuda.empty_cache()
    return {"tol": tol, "max_abs": float(d.max()),
            "max_over_tol": float((d / lim).max()),
            "entries_over_tol": int((d > lim).sum()),
            "finite": bool(torch.isfinite(full).all())}


def lm_families(torch, np, card):
    """Phase 15: (i) card against CPU on the smoke configs, (ii) decode
    against forward on the card at the smoke configs and at full width
    with LM_CHECK_LAYERS layers, (iii) the full-width runs."""
    import dataclasses

    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import registry

    phase = "lm_families"
    out = {"card_vs_cpu": lm_card_vs_cpu(
        torch, np, serve, registry,
        [(n, smoke_config(n), ("float32", "int8")
          if get_arch(n).family == "moe" else ("float32",))
         for n in LM_FAMILY_SMOKE], phase)}
    emit("lm_families_card_vs_cpu", ok=True, card=card, **out["card_vs_cpu"])

    out["decode_vs_forward"] = {}
    for n in LM_FAMILY_SMOKE:
        kw, tol = LM_DVF[get_arch(n).family]
        cases = [("smoke", smoke_config(n))]
        if n in LM_FAMILY_FULL:
            # an f32 cache, as the smoke configs': the int8 cache's
            # rounding is held apart (card against CPU)
            cases.append((f"full_x{LM_CHECK_LAYERS}", dataclasses.replace(
                get_arch(n), n_layers=LM_CHECK_LAYERS,
                param_dtype="float32", kv_cache_dtype="float32")))
        for what, base in cases:
            row = lm_family_decode_vs_forward(
                torch, serve, registry, dataclasses.replace(base, **kw), tol,
                seed=1)
            out["decode_vs_forward"][f"{n}/{what}"] = row
            if row["entries_over_tol"] or not row["finite"]:
                fail(phase, f"{n} {what}: decode differs from forward by "
                            f"{row['max_abs']:.3g} ({row['entries_over_tol']}"
                            f" entries over {tol}), finite {row['finite']}")
    emit("lm_families_decode_vs_forward", ok=True, card=card,
         **out["decode_vs_forward"])

    out["full"] = {}
    for n in LM_FAMILY_FULL:
        out["full"][n] = lm_full(torch, np, serve, n, phase=phase)
        emit("lm_families_full", ok=True, card=card, name=n,
             **out["full"][n])
    return out


# 16: the LM training path (repro_torch/train, launch/train.py): the
# family smoke configs card against CPU, TINY through the driver with
# resume, gemma-7b at full width with its depth cut to 4 layers (f32
# params, grads and AdamW moments of all 28 layers are 8.54 B x 16 B =
# 137 GB, over the card's 80 GB; 4 layers are 1.89 B parameters, 30.3 GB)
# and mamba2-130m at full width and depth
TRAIN_CASES = ("tiny", "gemma-7b", "deepseek-moe-16b", "mamba2-130m",
               "zamba2-1.2b", "whisper-tiny")
TRAIN_LR, TRAIN_WD, TRAIN_CHECK_STEPS = 1e-3, 0.01, 3
# loss within rtol 1e-5; every grad leaf within 1e-4 max|g_leaf| + 1e-6
TRAIN_LOSS_RTOL, TRAIN_G_REL, TRAIN_G_ABS = 1e-5, 1e-4, 1e-6
# params: entries outside 1e-6 + 1e-4 |p| (AdamW's g / (|g| + eps) turns
# the last bits of a grad near zero into a share of lr) under 0.1% of
# all, each within 2 lr (1 + wd): tests/test_torch_train.py's rule
TRAIN_P_REL, TRAIN_P_ABS, TRAIN_MAX_SHARE = 1e-4, 1e-6, 1e-3
TRAIN_TINY = ("--preset", "tiny", "--batch", "16", "--seq", "128", "--lr",
              "2e-3", "--ckpt-every", "20", "--log-every", "1")
TRAIN_TINY_STEPS, TRAIN_TINY_RESUME = 60, 80
TRAIN_FULL = {"gemma-7b": {"n_layers": 4, "remat": "full",
                           "loss_chunk": 1024, "batch": 8, "seq": 256},
              "mamba2-130m": {"batch": 8, "seq": 512}}
TRAIN_FULL_STEPS = 6


def train_param_diff(np, got, want, lr, wd, small=None):
    """Params ({key: array}) against a reference under the rule above.
    ``small`` ({key: bool array}, optional): the entries allowed outside
    1e-6 + 1e-4 |p| (grads below the grads' own tolerance); with it, any
    other entry outside counts in ``outside_small``."""
    over = entries = outside = 0
    worst = 0.0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        o = d > TRAIN_P_ABS + TRAIN_P_REL * np.abs(w)
        if small is not None:
            outside += int((o & ~small[k]).sum())
        over += int(o.sum())
        entries += d.size
        if o.any():
            worst = max(worst, float(d[o].max()) / lr)
    return {"over": over, "entries": entries, "max_over_lr": worst,
            "outside_small": outside,
            "ok": (outside == 0 and over <= TRAIN_MAX_SHARE * entries
                   and worst <= 2 * (1 + wd))}


def _np_leaves(tree):
    from repro_torch.train import tree as T

    return {k: v.detach().float().cpu().numpy() for k, v in T.items(tree)}


def train_cfg(name):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import TINY

    return TINY if name == "tiny" else smoke_config(name)


def train_card_vs_cpu(torch, np, name, phase="lm_train"):
    """(i) ``name``'s config (f32, TF32 off), the same weights and batches
    on the card and the CPU: loss and grads at the initial weights, then
    TRAIN_CHECK_STEPS AdamW steps (TINY also Adafactor)."""
    import functools

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (make_opt_init, make_train_step,
                                              value_and_grad)

    cfg = train_cfg(name)
    cpu = registry.init_params(cfg, torch.Generator().manual_seed(0))
    card = _tree_to(cpu, "cuda")
    shape = ShapeSpec("train", 64, 2, "train")
    batches = [registry.make_batch(cfg, shape,
                                   torch.Generator().manual_seed(1 + i))
               for i in range(TRAIN_CHECK_STEPS)]
    vag = value_and_grad(functools.partial(registry.loss_fn, cfg))
    lc, gc = vag(cpu, batches[0])
    lg, gg = vag(card, _tree_to(batches[0], "cuda"))
    gc, gg = _np_leaves(gc), _np_leaves(gg)
    worst = max(float(np.abs(gg[k] - w).max())
                / (TRAIN_G_REL * float(np.abs(w).max()) + TRAIN_G_ABS)
                for k, w in gc.items())
    row = {"loss_cpu": float(lc), "loss_card": float(lg),
           "loss_rel": abs(float(lg) - float(lc)) / abs(float(lc)),
           "grad_err_over_tol": worst}
    if not row["loss_rel"] <= TRAIN_LOSS_RTOL or not worst <= 1.0:
        fail(phase, f"{name}: card loss {float(lg)} against the CPU's "
                    f"{float(lc)}, grads at {worst:.3g} of the tolerance")
    for opt in ("adamw", "adafactor") if name == "tiny" else ("adamw",):
        opt_cfg = OptimizerConfig(name=opt, lr=TRAIN_LR, warmup_steps=0,
                                  weight_decay=TRAIN_WD)
        step_fn = make_train_step(cfg, opt_cfg)
        sides = {"cpu": [cpu, make_opt_init(cfg, opt_cfg)(cpu)],
                 "cuda": [card, make_opt_init(cfg, opt_cfg)(card)]}
        for batch in batches:
            for dev, side in sides.items():
                side[0], side[1], metrics = step_fn(
                    side[0], side[1], _tree_to(batch, dev))
                if not bool(torch.isfinite(metrics["loss"])):
                    fail(phase, f"{name} {opt}: loss {metrics['loss']} "
                                f"on {dev}")
        diff = train_param_diff(np, _np_leaves(sides["cuda"][0]),
                                _np_leaves(sides["cpu"][0]), TRAIN_LR,
                                TRAIN_WD)
        row[f"{opt}_params"] = diff
        if not diff["ok"]:
            fail(phase, f"{name} {opt}: after {TRAIN_CHECK_STEPS} steps "
                        f"{diff['over']} of {diff['entries']} params "
                        f"outside 1e-6 + 1e-4 |p|, up to "
                        f"{diff['max_over_lr']:.3g} lr")
    return row


def train_tiny_driver(torch, np, phase="lm_train"):
    """(ii) TINY through launch/train.py's main on the card: 60 steps at
    batch 16 x seq 128 with a checkpoint every 20 into a temporary
    directory, then --resume --steps 80. The loss must fall by more than
    0.5 nats (mean of the last 5 steps against the first 5), and the
    second run must restore step 60."""
    import contextlib
    import io
    import re
    import tempfile

    from repro_torch.launch import train

    logs = []
    with tempfile.TemporaryDirectory() as d:
        for extra in (["--steps", str(TRAIN_TINY_STEPS)],
                      ["--steps", str(TRAIN_TINY_RESUME), "--resume"]):
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                rc = train.main(list(TRAIN_TINY) + ["--ckpt-dir", d] + extra)
            torch.cuda.synchronize()
            logs.append((rc, buf.getvalue(), time.monotonic() - t0))
    steps = [re.match(r"step\s+(\d+)\s+loss\s+(\S+).*\s([\d,]+) tok/s", ln)
             for ln in logs[0][1].splitlines() if ln.startswith("step")]
    losses = [float(m.group(2)) for m in steps]
    tok_s = [float(m.group(3).replace(",", "")) for m in steps]
    drop = float(np.mean(losses[:5]) - np.mean(losses[-5:]))
    row = {"rc": [r[0] for r in logs], "steps": len(losses),
           "first_losses": losses[:5], "last_losses": losses[-5:],
           "loss_drop": drop,
           "tok_s_median": float(np.median(tok_s[1:])),
           "run_s": logs[0][2],
           "run_tok_s": TRAIN_TINY_STEPS * 16 * 128 / logs[0][2],
           "final_line": logs[0][1].splitlines()[-1],
           "resumed": f"[resume] restored step {TRAIN_TINY_STEPS}" in
           logs[1][1],
           "resume_final_line": logs[1][1].splitlines()[-1]}
    if row["rc"] != [0, 0] or len(losses) != TRAIN_TINY_STEPS or \
            not np.isfinite(losses).all():
        fail(phase, f"TINY driver: exit codes {row['rc']}, "
                    f"{len(losses)} logged losses")
    if not drop > 0.5:
        fail(phase, f"TINY driver: the loss fell {drop:.3f} nats, not more "
                    "than 0.5")
    if not row["resumed"]:
        fail(phase, f"TINY driver: no '[resume] restored step "
                    f"{TRAIN_TINY_STEPS}' in {logs[1][1][:200]!r}")
    return row


def train_bound_ms(cfg, n_params, tokens):
    """The least time of one train step: its FLOPs (6 N tokens, 8 N tokens
    with the full remat's second forward; attention's and the SSD scan's
    own products not counted) over the float32 rate (TF32 is off), or the
    optimizer's bytes (params, grads and both moments read, params and
    moments written, float32) over the HBM rate, whichever is larger."""
    flops = (8 if cfg.remat == "full" else 6) * n_params * tokens
    nbytes = 7 * 4 * n_params
    ms = {"operations": flops / FP32_OPS_PER_S * 1e3,
          "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(ms, key=ms.get)
    return ms[by], by, flops


def train_full(torch, np, name, phase="lm_train"):
    """(iii) ``name`` at full width (its depth as TRAIN_FULL says), f32
    weights and AdamW moments, trained TRAIN_FULL_STEPS steps on the markov
    TokenPipeline through make_train_step(donate=True): finite loss and
    grad norm at every step; ms a step (median of steps 2-6), tokens/s,
    peak memory, the bound."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import registry
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_opt_init, make_train_step

    spec = dict(TRAIN_FULL[name])
    batch, seq = spec.pop("batch"), spec.pop("seq")
    cfg = dataclasses.replace(get_arch(name), param_dtype="float32",
                              num_microbatches=1, **spec)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt_cfg = OptimizerConfig(name="adamw", lr=1e-4, warmup_steps=2,
                              total_steps=TRAIN_FULL_STEPS)
    state = make_opt_init(cfg, opt_cfg)(params)
    n_params = sum(t.numel() for t in _leaves(params))
    state_bytes = sum(t.numel() * t.element_size()
                      for tree in (params, state["m"], state["v"])
                      for t in _leaves(tree))
    step_fn = make_train_step(cfg, opt_cfg, donate=True)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0))
    times, losses, norms = [], [], []
    for i in range(TRAIN_FULL_STEPS):
        b = {k: torch.from_numpy(v).cuda() for k, v in
             data.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tokens = batch * seq
    ms = float(np.median(times[1:])) * 1e3
    bound, by, flops = train_bound_ms(cfg, n_params, tokens)
    row = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "remat": cfg.remat,
           "loss_chunk": cfg.loss_chunk, "batch": batch, "seq": seq,
           "params": n_params, "state_bytes": state_bytes,
           "losses": losses, "grad_norms": norms,
           "step_ms": ms, "step_ms_all": [t * 1e3 for t in times],
           "tok_s": tokens / (ms / 1e3), "step_bound_ms": bound,
           "bound_by": by, "flops": flops,
           "bound_share": bound / ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(phase, f"{name}: non-finite loss or grad norm {losses} "
                    f"{norms}")
    del params, state, m
    torch.cuda.empty_cache()
    return row


def lm_train(torch, np, card):
    """Phase 16: (i) card against CPU, (ii) TINY through the driver, (iii)
    gemma-7b x 4 layers and mamba2-130m trained at full width."""
    out = {"card_vs_cpu": {n: train_card_vs_cpu(torch, np, n)
                           for n in TRAIN_CASES}}
    emit("lm_train_card_vs_cpu", ok=True, card=card, **out["card_vs_cpu"])
    out["tiny_driver"] = train_tiny_driver(torch, np)
    emit("lm_train_tiny", ok=True, card=card, **out["tiny_driver"])
    out["full"] = {}
    for n in TRAIN_FULL:
        out["full"][n] = train_full(torch, np, n)
        emit("lm_train_full", ok=True, card=card, name=n, **out["full"][n])
    return out


# 17: the sharded training path (parallel/{sharding,compression,
# hlo_analysis}.py, launch/{specs,dryrun}.py, train/{train_step,elastic}.py
# over DTensors). (a) dry-run cells at full width and depth on fake worlds
# of the production meshes, one process a cell, all at once, each within
# its own time limit; (b) two ranks on cuda:0 (gloo: NCCL refuses two
# ranks on one card; parallel/transport stages the collectives through
# the host), gemma-7b at full width cut to 2 layers (f32 params, grads and
# AdamW moments: 1.34 B x 16 B = 21.4 GB a rank), against one rank;
# (c) TINY and its AdamW state resharded onto the (2, 1) plan and back
SHARDED_CELLS = (("gemma-7b", "train_4k", "single"),
                 ("gemma-7b", "train_4k", "multi"),
                 ("gemma-7b", "decode_32k", "single"),
                 ("mamba2-130m", "train_4k", "single"))
# deepseek-moe-16b train_4k (expert parallelism) runs through the same
# dry-run in 247 s of one core (1.73 M local ops, 8 microbatches), over
# the phase's time: `python -m repro_torch.launch.dryrun --arch
# deepseek-moe-16b --shape train_4k`
SHARDED_CELL_TIMEOUT_S = 420
SHARDED_RANKS = {"arch": "gemma-7b", "n_layers": 2, "smoke": False,
                 "batch": 8, "seq": 256, "steps": 3}
SHARDED_MESHES = (("pod", {"pod": 2, "data": 1, "model": 1}),
                  ("data", {"data": 2, "model": 1}))
SHARDED_LOSS_RTOL = 1e-4
SHARDED_TIMEOUT_S = 600


def dryrun_cells(cells=SHARDED_CELLS, timeout=SHARDED_CELL_TIMEOUT_S):
    """(a): every cell through ``python -m repro_torch.launch.dryrun`` in
    its own process, all started together; {cell: summary}. A cell must
    report FLOPs and at least one collective."""
    import tempfile

    out = tempfile.mkdtemp(prefix="torch_dryrun_")
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {}
    for arch, shape, mesh in cells:
        procs[arch, shape, mesh] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--out", out],
            env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    res = {}
    for (arch, shape, mesh), proc in procs.items():
        try:
            log, _ = proc.communicate(
                timeout=max(1, timeout - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.wait()
            raise RuntimeError(f"dry-run {arch} {shape} {mesh}: over "
                               f"{timeout} s")
        if proc.returncode != 0:
            raise RuntimeError(f"dry-run {arch} {shape} {mesh} failed: "
                               f"{log[-2000:]}")
        name = "multi_pod_2x16x16" if mesh == "multi" else "single_pod_16x16"
        with open(os.path.join(out, name, f"{arch}__{shape}.json")) as f:
            s = json.load(f)
        if not (s["flops_per_device"] > 0 and s["collective_count"] > 0):
            raise RuntimeError(f"dry-run {arch} {shape} {mesh}: flops "
                               f"{s['flops_per_device']}, "
                               f"{s['collective_count']} collectives")
        res[f"{arch} {shape} {name}"] = {
            "fits_hbm": s["fits_hbm"],
            "peak_gib": s["memory"]["peak_bytes"] / 2**30,
            "argument_gib": s["memory"]["argument_bytes"] / 2**30,
            "peak_top": s["memory"]["peak_top"][:3],
            "flops_per_device": s["flops_per_device"],
            "collective_wire_bytes_per_device":
                s["collective_wire_bytes_per_device"],
            "collective_count": s["collective_count"],
            "collective_by_op": s["collective_by_op"],
            "num_microbatches": s["num_microbatches"],
            "profile": s["profile"], "local_ops": s["local_ops"],
            "seconds": s["lower_s"]}
    return res


def sharded_cfg(spec):
    import dataclasses

    from repro_torch.configs import get_arch, smoke_config

    base = smoke_config(spec["arch"]) if spec["smoke"] else get_arch(
        spec["arch"])
    # both meshes of (b) have model = 1, where sequence parallelism has
    # nothing to shard: act_shard "none"
    return dataclasses.replace(base, n_layers=spec["n_layers"],
                               param_dtype="float32", num_microbatches=1,
                               remat="none", act_shard="none")


def sharded_worker(rank, world, store, out, spec):
    """One rank of (b)/(c) on cuda:0 in a gloo world; rank 0 writes the
    result JSON to ``out``."""
    # two ranks share the card: growable segments, no stranded blocks;
    # cuBLAS's deterministic workspace (the int8 reduction rounds each
    # grad: a grad one ulp off can land a quantum away)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.use_deterministic_algorithms(True, warn_only=True)
    if spec.get("device", "cuda") == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = sharded_ranks(torch, np, rank, spec)
        dist.barrier()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _timed(torch, fn):
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    r = fn()
    sync()
    return r, (time.perf_counter() - t0) * 1e3


def sharded_ranks(torch, np, rank, spec):
    """(b) and (c) on this rank; the comparisons on rank 0."""
    import contextlib

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import TINY
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.compression import (
        make_compressed_value_and_grad)
    from repro_torch.parallel.hlo_analysis import (StepTrace,
                                                   collectives_of_trace)
    from repro_torch.parallel.transport import transport_for
    from repro_torch.train import elastic
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (
        make_loss_fn, make_opt_init, make_train_step, sharded_context,
        value_and_grad)

    dev = torch.device(spec.get("device", "cuda"), 0)
    cfg = sharded_cfg(spec)
    B, S = spec["batch"], spec["seq"]
    opt_cfg = OptimizerConfig(name="adamw", lr=TRAIN_LR, warmup_steps=0,
                              weight_decay=TRAIN_WD)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(i).items()}
               for i in range(spec["steps"])]

    def fresh():
        return registry.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))

    mem = {}

    def free(stage=None):
        # hand freed blocks back: two ranks share the card's 80 GB
        import gc

        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            if stage:
                mem[stage] = {
                    "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
                torch.cuda.reset_peak_memory_stats()

    res = {}
    if rank == 0:
        # the one-rank step: grads of the first batch, then the steps
        p = fresh()
        loss_e, grads_e = value_and_grad(make_loss_fn(cfg))(p, batches[0])
        grads_e = {k: v.cpu() for k, v in T.items(grads_e)}
        opt = make_opt_init(cfg, opt_cfg)(p)
        step = make_train_step(cfg, opt_cfg, donate=True)
        ref_losses, ref_ms = [], []
        for b in batches:
            (p, opt, m), ms = _timed(torch, lambda: step(p, opt, b))
            ref_losses.append(float(m["loss"]))
            ref_ms.append(ms)
        ref = {"data": {k: v.cpu().numpy() for k, v in T.items(p)}}
        del p, opt
        free()
        res["one_rank"] = {"losses": ref_losses, "step_ms": ref_ms}
        ref_losses = {"data": ref_losses}
    dist.barrier()
    for name, shape in SHARDED_MESHES:
        mesh = init_device_mesh(dev.type, tuple(shape.values()),
                                mesh_dim_names=tuple(shape))
        run = {}
        if name == "pod":
            inner = mesh["data", "model"]
            if rank == 0:
                p, ref_losses["pod"], pod_g1 = pod_reference_steps(
                    torch, cfg, opt_cfg, fresh(), batches, inner)
                ref["pod"] = {k: v.cpu().numpy() for k, v in T.items(p)}
                del p
                free()
            dist.barrier()
        with transport_for(mesh) as staged:
            host = fresh()
            res["n_params"] = sum(x.numel() for x in T.leaves(host))
            params = elastic.reshard_params(cfg, mesh, host)
            opt = elastic.reshard_opt_state(
                cfg, mesh, make_opt_init(cfg, opt_cfg)(host), host)
            del host
            free(f"{name}: placed")
            bspecs = shd.batch_specs(cfg, mesh, ShapeSpec("b", S, B, "train"))
            bsh = shd.named(mesh, bspecs)
            gspecs = shd.grad_specs(cfg, mesh, params)

            def place(b):
                return {k: shd.distribute(v, bsh[k], src_data_rank=None)
                        for k, v in b.items()}

            if name == "pod":
                vag = make_compressed_value_and_grad(
                    make_loss_fn(cfg), mesh, bspecs, grad_specs=gspecs)
                trace = StepTrace()
                with sharded_context(params), trace:
                    loss_c, g_c = vag(params, place(batches[0]))
                # the int8 leaves and one f32 scale a leaf, all-gathered
                # over the pod (g = 2): (g-1)/g of each result on the wire
                run["int8_wire_bytes"] = collectives_of_trace(
                    trace.records, 2).by_op.get("all-gather", 0.0)
                run["int8_wire_formula"] = float(
                    res["n_params"] + 4 * len(T.leaves(params)))
                g_c = {k: v.full_tensor().cpu()
                       for k, v in T.items(g_c)}
                if rank == 0:
                    worst = 0.0
                    for k, ge in grads_e.items():
                        bound = 4 * (2 * float(ge.abs().max()) / 254 + 1e-5)
                        err = float((g_c[k] - ge).abs().max())
                        worst = max(worst, err / bound)
                    run["loss_rel_err"] = abs(
                        float(loss_c.full_tensor()) - float(loss_e)) / abs(
                        float(loss_e))
                    run["grad_err_over_bound"] = worst
                    # the pod ranks' reduced grads against the one-rank
                    # compressed step's: entries that differ, a leaf
                    run["grads_vs_one_rank_differ"] = {
                        k: int((g_c[k] != pod_g1[k]).sum()) for k in g_c}
                    del grads_e, pod_g1
                del g_c
                free(f"{name}: compressed grads")
            step = make_train_step(
                cfg, opt_cfg, grad_specs=shd.named(mesh, gspecs),
                compress_pod=(mesh, bspecs) if name == "pod" else None,
                donate=True)
            losses, ms = [], []
            for i, b in enumerate(batches):
                # the first step traced (its collectives), the rest timed
                trace = StepTrace() if i == 0 else contextlib.nullcontext()
                with trace:
                    (params, opt, m), t = _timed(
                        torch, lambda: step(params, opt, place(b)))
                losses.append(float(m["loss"]))
                ms.append(t)
                if i == 0:
                    coll = collectives_of_trace(trace.records, 2)
            run["collective_by_op"] = coll.by_op
            run["collective_count"] = coll.count
            got = dict(T.items(elastic.gather_to_host(params)))
            run.update(losses=losses, step_ms=ms)
            if staged is not None and hasattr(staged, "staged"):
                run["staged_to_host"] = dict(staged.staged)
            if name == "data":
                # (c) TINY and its AdamW state onto the (2, 1) plan and back
                tiny = registry.init_params(
                    TINY, torch.Generator(device=dev).manual_seed(0))
                tiny_opt = make_opt_init(TINY, opt_cfg)(tiny)
                back = elastic.gather_to_host(
                    elastic.reshard_params(TINY, mesh, tiny))
                opt_back = elastic.gather_to_host(elastic.reshard_opt_state(
                    TINY, mesh, tiny_opt, tiny))
                run["reshard_bit_equal"] = all(
                    np.array_equal(b, v.cpu().numpy()) for b, v in zip(
                        T.leaves(back), T.leaves(tiny))) and all(
                    np.array_equal(np.asarray(b), v.cpu().numpy())
                    for b, v in zip(T.leaves(opt_back), T.leaves(tiny_opt)))
        del params, opt
        free(f"{name}: steps")
        if rank == 0:
            run["loss_vs_one_rank"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses, ref_losses[name]))
            run["params"] = train_param_diff(np, got, ref[name], TRAIN_LR,
                                             TRAIN_WD)
            res[name] = run
        del got
    res["memory"] = mem
    return res


def pod_reference_steps(torch, cfg, opt_cfg, params, batches, inner,
                        n_pod=2):
    """The compressed pod step on one rank: each pod's grads of its slice
    of the batch, computed as a pod rank computes them (DTensors on
    ``inner``, this rank's one-device intra-pod mesh: the same ops, so
    the same bits, which the int8 rounding needs), int8-quantized,
    dequantized and summed in pod order, over the pod count
    (parallel/compression.quantized_psum's arithmetic); the loss the pods'
    mean. -> (params, losses, the first step's reduced grads on the
    host)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel.compression import quantize_int8
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (make_loss_fn, sharded_context,
                                              value_and_grad)

    init, update = make_optimizer(opt_cfg)
    opt = init(params)
    vag = value_and_grad(make_loss_fn(cfg))
    rep = [Replicate()] * inner.ndim
    on_inner = lambda x: DTensor.from_local(x, inner, rep, run_check=False)
    local = lambda x: x.to_local() if isinstance(x, DTensor) else x

    def pod_part(b, i):
        # each pod's slice a tensor of its own, as a pod rank holds it
        half = {k: v.chunk(n_pod)[i].clone() for k, v in b.items()}
        p_in = T.map_leaves(on_inner, params)
        with sharded_context(p_in):
            loss, g = vag(p_in, T.map_leaves(on_inner, half))
        return local(loss), T.map_leaves(local, g)

    losses = []
    for b in batches:
        parts = [pod_part(b, i) for i in range(n_pod)]

        def reduce(*gs):
            qs = [quantize_int8(g) for g in gs]
            deq = torch.stack([q.to(torch.float32) for q, _ in qs]) * \
                torch.stack([sc for _, sc in qs]).reshape(
                    (-1,) + (1,) * gs[0].ndim)
            return torch.sum(deq, dim=0).to(gs[0].dtype) / n_pod

        grads = T.map_leaves(reduce, *[g for _, g in parts])
        if not losses:
            first = {k: v.cpu() for k, v in T.items(grads)}
        loss = sum(l for l, _ in parts) / n_pod
        params, opt, _ = update(grads, opt, params, donate=True)
        losses.append(float(loss))
    return params, losses, first


def lm_sharded_ranks(spec=SHARDED_RANKS, timeout=SHARDED_TIMEOUT_S):
    """(b)/(c): two ranks spawned on cuda:0; the rank-0 result, checked.
    Every failure raises."""
    import multiprocessing as mp
    import tempfile

    d = tempfile.mkdtemp(prefix="torch_sharded_")
    out = os.path.join(d, "result.json")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=sharded_worker,
                         args=(r, 2, os.path.join(d, "store"), out, spec))
             for r in range(2)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    for p in procs:
        p.join(max(1, timeout - (time.monotonic() - t0)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"sharded ranks: exit codes "
                           f"{[p.exitcode for p in procs]}"
                           f"{' (timed out)' if alive else ''}")
    with open(out) as f:
        res = json.load(f)
    pod, data = res["pod"], res["data"]
    checks = {
        "pod loss vs exact": pod["loss_rel_err"] <= SHARDED_LOSS_RTOL,
        "pod grads within 4 (2 max|g| / 254 + 1e-5)":
            pod["grad_err_over_bound"] <= 1.0,
        "pod grads bit-equal to the one-rank compressed step's":
            not any(pod["grads_vs_one_rank_differ"].values()),
        "pod params (train_param_diff)": pod["params"]["ok"],
        "pod losses vs the one-rank compressed step":
            pod["loss_vs_one_rank"] <= SHARDED_LOSS_RTOL,
        "int8 wire bytes by formula":
            pod["int8_wire_bytes"] == pod["int8_wire_formula"],
        "data params (train_param_diff)": data["params"]["ok"],
        "data losses vs one rank":
            data["loss_vs_one_rank"] <= TRAIN_LOSS_RTOL * 10,
        "reshard (2, 1) and back bit-equal": data["reshard_bit_equal"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"sharded ranks: {bad}: {json.dumps(res)[:3000]}")
    return res


def lm_sharded(torch, np, card):
    """Phase 17: (b) and (c) on the card, then (a) on the host."""
    out = {"ranks": lm_sharded_ranks()}
    emit("lm_sharded_ranks", ok=True, card=card, **out["ranks"])
    out["dryrun"] = dryrun_cells()
    for cell, r in out["dryrun"].items():
        emit("lm_sharded_dryrun", ok=True, card=card, cell=cell, **r)
    return out


def nn_baseline(torch, np, tr, te):
    """The paper's NN baseline on the card, as
    examples/smartpixel_readout.py runs it: train_mlp on the first 100,000
    events of the §5 training split (150 steps), its background rejection
    at 0.978 signal efficiency on 50,000 test events, and its LUT cost."""
    from repro_torch.core.bdt import operating_point_at_signal_eff
    from repro_torch.core.nn_baseline import (
        MLPSpec, dsp_schedule, lut_cost, mlp_proba, train_mlp)

    t0 = time.monotonic()
    model, norm, loss = train_mlp(tr["features"][:100_000],
                                  tr["label"][:100_000].astype(np.float32),
                                  steps=150, device="cuda")
    torch.cuda.synchronize()
    t_train = time.monotonic() - t0
    p = mlp_proba(model, norm, te["features"][:50_000])
    _, se, br = operating_point_at_signal_eff(p, te["label"][:50_000], 0.978)
    if not np.isfinite(loss) or not np.isfinite(p).all():
        fail("nn_baseline", f"loss {loss}, non-finite probabilities")
    cost = lut_cost(MLPSpec())
    return {"device": str(model.w[0].device), "loss": loss,
            "train_s": t_train, "sig_eff": float(se), "bkg_rej": float(br),
            "lut_total": cost["lut_total"], "fits_448": cost["lut_total"] <= 448,
            "dsp_schedule": dsp_schedule(MLPSpec())}


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
    from repro_torch.kernels.bdt_infer import bdt_infer as bdt
    from repro_torch.kernels.bdt_infer import ops as bdt_ops
    from repro_torch.kernels.lut_eval import bitsliced as bs
    from repro_torch.kernels.lut_eval import lut_eval as le
    from repro_torch.kernels.lut_eval import ops as lut_ops
    from repro_torch.kernels.sparse_pack import sparse_pack as sp
    from repro_torch.kernels.yprofile import ops as yp
    from repro_torch.parallel import compression as cp

    # each kernel wrapper's launch counter, by the kernel's name (B6 has
    # three entries, each with its wrapper)
    counters = {"yprofile": yp.yprofile_traced,
                "eval_words_voted": bs.eval_seg_voted,
                "lut_eval": le.lut_eval_stacked,
                "lut_eval_banded": le.lut_eval_banded_stacked,
                "bdt_infer": bdt.bdt_traverse,
                "sparse_pack_decode": sp.decode_pack,
                "sparse_pack_keep_words": sp.pack_keep_words,
                "decode_dense": sp.decode_dense}

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
    s5_chip, te, tr = paper_chip()
    c5 = s5_chip.config
    emit("train", ok=True, seconds=time.monotonic() - t0,
         luts=[c.config.n_luts for c in chips],
         levels=[len(c.config.level_sizes) for c in chips],
         s5_chip={"luts": c5.n_luts, "levels": len(c5.level_sizes),
                  "fanin_reach": c5.fanin_reach(), "inputs": c5.n_inputs,
                  "outputs": len(c5.output_nets)})

    k1 = check_k1(torch, yp)
    emit("kernel_yprofile", ok=True, **k1)
    k2 = check_k2(torch, np, bs, lut_ops, chips)
    emit("kernel_eval_words_voted", ok=True, **k2)
    b2 = check_lut(torch, np, le, lut_ops, chips, band=False)
    emit("kernel_lut_eval", ok=True, **b2)
    b3 = check_lut(torch, np, le, lut_ops, chips, band=None)
    emit("kernel_lut_eval_banded", ok=True, **b3)
    b4 = check_bdt(torch, np, bdt, bdt_ops, s5_chip, te["features"])
    emit("kernel_bdt_infer", ok=True, **b4)
    b6 = check_b6(torch, np, bs, sp, cp, lut_ops, chips)
    emit("kernel_sparse_pack", ok=True, **b6)
    # B6's dense entry: its own row of the kernels line
    b6_dense = {"name": "sparse_pack_dense", "route": "cuda",
                "source": b6["source"],
                "replaces": "src/repro/kernels/lut_eval/ops.py:985",
                "also_replaces": "src/repro/kernels/lut_eval/bitsliced.py:84",
                "max_abs_err": 0.0, "library_ms": None}

    stream = FrameStream(FrameStreamConfig(n_sensors=N_CHIPS,
                                           batch=SERVE_EVENTS))
    blocks = [[stream.batch_at(step, s) for s in range(N_CHIPS)]
              for step in range(SERVE_BATCHES)]
    want = oracle(np, chips, swap_chip, blocks, yp)
    runs = {}
    for red in ("none", "tmr"):
        runs[red] = serve(torch, np, chips, swap_chip, blocks, want, red,
                          counters)
        emit("serve", ok=True, card=card, **runs[red])

    t0 = time.monotonic()
    s5_runs, s5_launches = section5(torch, np, s5_chip, te, tr, counters)
    emit("s5", ok=True, card=card, seconds=time.monotonic() - t0,
         launches=s5_launches, **s5_runs)

    for red in ("none", "tmr"):
        runs["matmul", red] = serve(torch, np, chips, swap_chip, blocks,
                                    want, red, counters, layout="matmul")
        emit("serve_matmul", ok=True, card=card, **runs["matmul", red])

    # 7. sparse egress: the same stream, the drained events exactly the
    # oracle's kept set; per chip (n_in, n_kept) as in the dense runs
    for layout in (None, "matmul"):
        for red in ("none", "tmr"):
            run = serve(torch, np, chips, swap_chip, blocks, want, red,
                        counters, layout=layout, sparse=True)
            dense = runs[red] if layout is None else runs["matmul", red]
            if run["per_chip"] != dense["per_chip"]:
                fail("serve_sparse", f"{run['layout']} {red}: per-chip "
                                     f"(n_in, n_kept) {run['per_chip']} "
                                     f"!= dense {dense['per_chip']}")
            run["dense_events_per_s"] = dense["events_per_s"]
            runs["sparse", layout, red] = run
            emit("serve_sparse", ok=True, card=card, **run)

    # 8. the features path: the stream's features through submit_batch,
    # both layouts, plain and TMR, dense and sparse
    for layout in (None, "matmul"):
        for red in ("none", "tmr"):
            for sparse in (False, True):
                run = serve(torch, np, chips, swap_chip, blocks, want, red,
                            counters, layout=layout, sparse=sparse,
                            features=True)
                frames_run = (runs["sparse", layout, red] if sparse else
                              runs[red] if layout is None
                              else runs["matmul", red])
                run["frames_events_per_s"] = frames_run["events_per_s"]
                emit("serve_features", ok=True, card=card, **run)

    # 9. the scrub/SEU loop on the stream without its hot swap
    want0 = oracle(np, chips, chips[0], blocks, yp)
    flips = effective_flips(np, chips, want0)
    for layout, red, mode in ((None, "tmr", "steered"),
                              (None, "tmr", "round_robin"),
                              ("matmul", "tmr", "steered"),
                              ("matmul", "tmr", "round_robin"),
                              (None, "none", "steered")):
        run = serve_scrub(torch, np, chips, blocks, want0, flips, counters,
                          layout, red, mode)
        emit("serve_scrub", ok=True, card=card, **run)
    emit("serve_scrub_rates", ok=True, card=card,
         **scrub_rates(np, chips, blocks))

    # 10. deadline admission: observe, then the ladder's sparse_egress
    # rung under a deadline below the observed service time
    observe = serve_deadline(torch, np, chips, blocks, want0, counters,
                             DEADLINE_OBSERVE_US, "observe")
    emit("serve_deadline", ok=True, card=card, **observe)
    tight = 0.5 * observe["service_us"]["p50_us"]
    degrade = serve_deadline(torch, np, chips, blocks, want0, counters,
                             tight, "degrade", rungs=("sparse_egress",))
    if not degrade["transitions"]:
        fail("serve_deadline", f"degrade at {tight:.1f} us: no ladder "
                               "transition")
    if degrade["launches"]["sparse_pack_decode"] <= 0:
        fail("serve_deadline", "degrade: B6's sparse entry never launched "
                               "after the sparse_egress transition")
    emit("serve_deadline", ok=True, card=card, **degrade)

    # 11. the network front door over the served chips, plain and TMR
    net = serve_net(torch, np, chips, blocks, counters, card)
    # 12. the port's example drivers, as an operator runs them
    emit("examples", ok=True, card=card, runs=run_examples())

    # 13. the multi-tenant fleet: six tenants' raw frames through
    # TenantFleet.submit_frames in three configurations and under a
    # quota, then bench_fleet.py's numbers, K2 at the padded depth, the
    # deep ensemble's envelope and the front door in front of the fleet
    fleet_chips = list(chips) + [train_chip(seed, depth=d, leaves=lv)
                                 for seed, d, lv in FLEET_EXTRA]
    fstream = FrameStream(FrameStreamConfig(n_sensors=FLEET_TENANTS,
                                            batch=SERVE_EVENTS, seed=703))
    fblocks = [[fstream.batch_at(step, t) for t in range(FLEET_TENANTS)]
               for step in range(FLEET_STEPS)]
    fwant = fleet_oracle(np, fleet_chips, fblocks, yp)
    fleet_runs = {}
    for what, kw in (("bitsliced none", {}),
                     ("bitsliced tmr", dict(redundancy="tmr")),
                     ("matmul none", dict(layout="matmul")),
                     ("bitsliced none quota", dict(
                         tenant_quota_queued=FLEET_QUOTA))):
        fleet_runs[what] = serve_fleet(torch, np, fleet_chips, fblocks,
                                       fwant, counters, what, **kw)
        emit("serve_fleet", ok=True, card=card, **fleet_runs[what])
    X = yp.yprofile(fblocks[0][0]["frames"], fblocks[0][0]["y0"],
                    device="cuda").cpu().numpy().astype(np.float64)
    emit("fleet_bench", ok=True, card=card,
         **fleet_bench(torch, np, fleet_chips, X))
    k2_depth = fleet_k2_depth(torch, np, bs, sp, lut_ops, chips)
    emit("fleet_k2", ok=True, card=card, runs=k2_depth)
    deep = fleet_deep(torch, np, counters)
    emit("fleet_deep", ok=True, card=card, **deep)
    emit("fleet_door", ok=True, card=card,
         **fleet_door(torch, np, chips, blocks, counters))

    # 14. the dense LM serving path and the paper's NN baseline (no kernel
    # of the port: plain PyTorch on the card)
    t0 = time.monotonic()
    lm = lm_serve(torch, np)
    emit("lm_serve", ok=True, card=card, seconds=time.monotonic() - t0, **lm)
    emit("nn_baseline", ok=True, card=card, **nn_baseline(torch, np, tr, te))

    # 15. the MoE, SSM, hybrid and encoder-decoder families (plain
    # PyTorch on the card, no kernel of the port), after phase 14's
    # models are freed
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    fam = lm_families(torch, np, card)
    emit("lm_families", ok=True, card=card, seconds=time.monotonic() - t0,
         full={n: {k: r[k] for k in ("step_ms", "step_bound_ms",
                                     "gen_tok_s", "prefill_s",
                                     "max_memory_allocated")}
               for n, r in fam["full"].items()})

    # 16. the LM training path (plain PyTorch on the card, no kernel of
    # the port), after phase 15's models are freed
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    tr16 = lm_train(torch, np, card)
    emit("lm_train", ok=True, card=card, seconds=time.monotonic() - t0,
         tiny_tok_s=tr16["tiny_driver"]["tok_s_median"],
         full={n: {k: r[k] for k in ("step_ms", "step_bound_ms", "bound_by",
                                     "tok_s", "max_memory_allocated")}
               for n, r in tr16["full"].items()})

    # 17. the sharded training path: two ranks on the card, resharding, and
    # the dry-run of the production meshes (CPU processes: fake tensors)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    sh17 = lm_sharded(torch, np, card)
    emit("lm_sharded", ok=True, card=card, seconds=time.monotonic() - t0,
         step_ms={k: sh17["ranks"][k]["step_ms"]
                  for k in ("one_rank", "pod", "data")},
         int8_wire_bytes=sh17["ranks"]["pod"]["int8_wire_bytes"],
         dryrun={c: {k: r[k] for k in ("fits_hbm", "peak_gib",
                                       "collective_wire_bytes_per_device",
                                       "seconds")}
                 for c, r in sh17["dryrun"].items()})

    kernels = []
    # K2's row carries the times of its R=3 (TMR) run; K1, K2 and B6's
    # dense entry count their launches in the default served stream,
    # B2-B4 in the §5 check, B6's sparse entries in the sparse stream
    for k, t, n in ((k1, k1, runs["none"]["launches"]["yprofile"]),
                    (k2, k2["runs"][f"R3_W{K2_WORDS}"],
                     runs["none"]["launches"]["eval_words_voted"]),
                    (b2, b2, s5_launches["lut_eval"]),
                    (b3, b3, s5_launches["lut_eval_banded"]),
                    (b4, b4, s5_launches["bdt_infer"]),
                    (b6, b6["runs"][f"decode_pack_R3_W{B6_WORDS}"],
                     sum(runs["sparse", None, "none"]["launches"][k]
                         for k in ("sparse_pack_decode",
                                   "sparse_pack_keep_words"))),
                    (b6_dense, b6["runs"][f"dense_R3_W{B6_WORDS}"],
                     runs["none"]["launches"]["decode_dense"])):
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": n,
            "max_abs_err": k["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": k["library_ms"],
        })
    # B2/B3: the tensor-core product count their bound used before the
    # gather, and their time and bound at the §5 chunk shape
    for row, layout in ((kernels[2], "dense"), (kernels[3], "banded")):
        k = b2 if layout == "dense" else b3
        row["dense_product_bound_ms"] = k["dense_product_bound_ms"]
        row.update({key: s5_runs[layout][key] for key in (
            "chunk_kernel_ms", "chunk_plain_ms", "chunk_bound_ms",
            "chunk_dense_product_bound_ms")})
    # K2 at every checked width and replica count; B4's product-form bound
    kernels[1]["runs"] = {
        key: {k: r[k] for k in ("tile", "ms", "stream_ms", "plain_ms",
                                "bound_ms", "bound_by")}
        for key, r in k2["runs"].items()}
    kernels[4]["dense_product_bound_ms"] = b4["dense_product_bound_ms"]
    kernels[4]["stream_ms"] = b4["stream_ms"]
    # B6's entries at both widths, its second source line, why it has no
    # library call, and its launches in the matmul sparse stream
    # (keep-words entry); the dense entry's launches under TMR
    b6_runs = {key: {k: r[k] for k in ("ms", "stream_ms", "plain_ms",
                                       "bound_ms", "bound_by", "bytes_ms")}
               for key, r in b6["runs"].items()}
    kernels[5]["runs"] = {k: r for k, r in b6_runs.items()
                          if not k.startswith("dense")}
    kernels[5]["also_replaces"] = b6["also_replaces"]
    kernels[5]["library_note"] = b6["library_note"]
    kernels[5]["launches_matmul_sparse"] = runs[
        "sparse", "matmul", "none"]["launches"]["sparse_pack_keep_words"]
    kernels[6]["runs"] = {k: r for k, r in b6_runs.items()
                          if k.startswith("dense")}
    kernels[6]["also_replaces"] = b6_dense["also_replaces"]
    kernels[6]["launches_tmr"] = runs["tmr"]["launches"]["decode_dense"]
    # K1, K2 and B6's dense entry behind the front door (phase 11, plain,
    # TCP unpaced)
    for row, k in ((kernels[0], "yprofile"), (kernels[1], "eval_words_voted"),
                   (kernels[6], "decode_dense")):
        row["launches_serve_net"] = net["none", "tcp", False]["launches"][k]
    # the fleet phase (13): K1, K2 and B6's dense entry in the bit-sliced
    # plain run, B2/B3 in the matmul one; K2 at the served chips' union
    # and bucket-envelope depths
    for row, k in ((kernels[0], "yprofile"), (kernels[1], "eval_words_voted"),
                   (kernels[6], "decode_dense")):
        row["launches_fleet"] = fleet_runs["bitsliced none"]["launches"][k]
    for row, k in ((kernels[2], "lut_eval"), (kernels[3], "lut_eval_banded")):
        row["launches_fleet"] = fleet_runs["matmul none"]["launches"][k]
    kernels[1]["fleet_deep"] = {
        red: {"launches": deep[red]["launches"]["eval_words_voted"],
              **{k: deep[red]["kernel"][k] for k in (
                  "path", "tile", "smem_bytes", "ms", "plain_ms",
                  "bound_ms", "bound_by")}}
        for red in ("none", "tmr")}
    kernels[1]["fleet_depth"] = {
        key: ({k: r[k] for k in ("levels", "tile", "smem_bytes", "ms",
                                 "plain_ms", "bound_ms", "bound_by")}
              if isinstance(r, dict) else r)
        for key, r in k2_depth.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
