#!/usr/bin/env python3
"""Where the time of one LM train step goes on one CUDA card, and what
the stacked leaves' backward costs. Run from the repo root:

    python3 benchmarks/torch_train_probe.py stacked [--rounds 2] [--steps 3]
    python3 benchmarks/torch_train_probe.py profile [--arch gemma-7b ...] [--steps 2] [--top 15]

Each config is chip_smoke.py's phase-16 run (``chip_smoke.TRAIN_FULL``:
gemma-7b at full width with 4 layers, mamba2-130m at full width and
depth; f32 weights and AdamW moments, markov TokenPipeline batches, the
step of ``make_train_step(donate=True)``, TF32 off).

``stacked``: the forward takes each layer's weights from the stacked
leaves either by one ``torch.unbind`` a leaf (``layers.layer_params``,
the port's choice: backward stacks the layers' grads once) or by
indexing a layer at a time (``layers.index_layer``: the backward of each
index writes a zero-filled grad the size of the whole leaf and sums
them). The two run in turns (index, unbind, unbind, index, ...) in one
process on gemma-7b x 4: ms a step (median of ``--steps`` after one
warm-up step) and peak memory of each turn.

``profile``: ``--steps`` traced steps under ``torch.profiler`` after two
untraced ones: the device's busy time over the wall time, kernels a
step, the device time of the matrix products (cuBLAS and CUTLASS
kernels), and the ``--top`` kernels by device time.

Every line is JSON; the last names the card and its power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def build(name):
    """(config, params, optimizer state, step function, batch of step i)
    of chip_smoke's phase-16 run of ``name`` on the card."""
    import dataclasses

    import torch

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import registry
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_opt_init, make_train_step

    spec = dict(chip_smoke.TRAIN_FULL[name])
    batch, seq = spec.pop("batch"), spec.pop("seq")
    cfg = dataclasses.replace(get_arch(name), param_dtype="float32",
                              num_microbatches=1, **spec)
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt_cfg = OptimizerConfig(name="adamw", lr=1e-4, warmup_steps=2,
                              total_steps=100)
    state = make_opt_init(cfg, opt_cfg)(params)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0))

    def batch_at(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in data.batch_at(i).items()}
    return (cfg, params, state, make_train_step(cfg, opt_cfg, donate=True),
            batch_at)


def timed_steps(step_fn, params, state, batch_at, n, start=0):
    """n steps, each timed on the host clock between synchronisations."""
    import torch

    times = []
    for i in range(start, start + n):
        b = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, b)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return params, state, times


def stacked(rounds, steps):
    import numpy as np
    import torch

    from repro_torch.models import layers

    unbind = layers.layer_params

    def by_index(tree, n_layers):
        return [layers.index_layer(tree, i) for i in range(n_layers)]

    cfg, params, state, step_fn, batch_at = build("gemma-7b")
    i = 0
    for r in range(rounds):
        for how in (("index", "unbind") if r % 2 == 0
                    else ("unbind", "index")):
            layers.layer_params = unbind if how == "unbind" else by_index
            params, state, _ = timed_steps(step_fn, params, state, batch_at,
                                           1, i)
            torch.cuda.reset_peak_memory_stats()
            params, state, times = timed_steps(step_fn, params, state,
                                               batch_at, steps, i + 1)
            i += steps + 1
            print(json.dumps({
                "probe": "stacked", "arch": cfg.name,
                "layers": cfg.n_layers, "round": r, "layer_weights": how,
                "step_ms_median": 1e3 * float(np.median(times)),
                "step_ms": [1e3 * t for t in times],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
            }), flush=True)
    layers.layer_params = unbind


def profile(names, steps, top):
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    for name in names:
        cfg, params, state, step_fn, batch_at = build(name)
        params, state, _ = timed_steps(step_fn, params, state, batch_at, 2)
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, _ = timed_steps(step_fn, params, state, batch_at,
                                           steps, 2)
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and str(e.device_type).endswith("CUDA")]
        dev_us = sum(e.self_device_time_total for e in events)
        gemm = ("gemm", "nvjet", "cutlass", "sm90_xmma", "ampere_sgemm")
        gemm_us = sum(e.self_device_time_total for e in events
                      if any(g in e.key.lower() for g in gemm))
        print(json.dumps({
            "probe": "profile", "arch": cfg.name, "layers": cfg.n_layers,
            "traced_step_ms": 1e3 * wall / steps,
            "device_busy_ms_a_step": dev_us / 1e3 / steps,
            "device_busy_share": dev_us / 1e6 / wall,
            "matmul_ms_a_step": gemm_us / 1e3 / steps,
            "kernels_a_step": sum(e.count for e in events) / steps,
        }), flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
            print(json.dumps({
                "arch": cfg.name, "kernel": e.key[:120],
                "calls_a_step": e.count / steps,
                "device_ms_a_step": e.self_device_time_total / 1e3 / steps,
            }), flush=True)
        del params, state
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["stacked", "profile"])
    ap.add_argument("--arch", nargs="+", default=["gemma-7b"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.what == "stacked":
        stacked(args.rounds, args.steps)
    else:
        profile(args.arch, args.steps, args.top)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
