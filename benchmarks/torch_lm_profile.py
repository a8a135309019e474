#!/usr/bin/env python3
"""Where the time of one LM decode step goes on one CUDA card. Run from
the repo root:

    python3 benchmarks/torch_lm_profile.py [--arch gemma-7b ...] [--steps 8] [--top 15]

For each ``--arch`` (one or more; an encoder-decoder model gets random
encoder input at its enc_len), builds it at full width and depth (bf16,
random weights from seed 0, its own KV cache dtype), prefills a batch of
8 prompts of 32 tokens one by one through the decode step, then times
``--steps`` decode steps on the host clock with a synchronisation after
each, and traces the same number under ``torch.profiler``: the device's
busy time (the sum of kernel times) over the steps' wall time, the
kernels a step, and the ``--top`` kernels by device time. Every line is
JSON; the last names the card and its power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def profile_arch(cfg, n_steps, top):
    """Time and trace ``n_steps`` decode steps of ``cfg`` (one JSON line,
    then one a kernel of the ``top``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import registry

    params = serve.build(cfg, 0, "cuda")
    B, P = 8, 32
    prompt = torch.randint(0, cfg.vocab, (B, P), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    kw = {}
    if cfg.family == "encdec":
        enc = torch.randn((B, cfg.enc_len, cfg.d_model),
                          generator=torch.Generator().manual_seed(2)) * 0.02
        kw = {"params": params, "enc_embeds": enc.cuda()}
    with torch.no_grad():
        cache = registry.init_cache(cfg, B, P + 2 * n_steps + 2,
                                    device="cuda", **kw)
        for i in range(P):
            logits, cache = registry.decode_step(
                cfg, params, cache, prompt[:, i:i + 1].cuda())
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)

        def step():
            nonlocal cache, tok
            logits, cache = registry.decode_step(cfg, params, cache, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)

        torch.cuda.synchronize()
        walls = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    kernels = sorted(events, key=lambda e: -e.self_device_time_total)
    walls.sort()
    print(json.dumps({
        "arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
        "batch": B, "kv_cache_dtype": cfg.kv_cache_dtype,
        "step_ms_median": 1e3 * walls[len(walls) // 2],
        "step_ms_min": 1e3 * walls[0],
        "traced_steps_ms": 1e3 * wall / n_steps,
        "device_busy_ms_a_step": dev_us / 1e3 / n_steps,
        "device_busy_share": dev_us / 1e6 / wall,
        "kernels_a_step": sum(e.count for e in events) / n_steps,
    }), flush=True)
    for e in kernels[:top]:
        print(json.dumps({
            "arch": cfg.name, "kernel": e.key[:120],
            "calls_a_step": e.count / n_steps,
            "device_ms_a_step": e.self_device_time_total / 1e3 / n_steps,
        }), flush=True)
    del params, cache
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["gemma-7b"])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_lm_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch

    for arch in args.arch:
        profile_arch(get_arch(arch), args.steps, args.top)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
