"""Serving driver: batched decode with a KV cache, on the card (the port
of the JAX package's launch/serve.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --preset tiny --batch 8 \
      --prompt-len 32 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --preset tiny --device cpu

It takes the reference's flags and ``--device`` (the CUDA card by
default; ``cpu`` only when asked); ``--preset smoke --arch`` serves the
smoke config of any token-LM family (dense, moe, ssm, hybrid), and
encdec and the VLM are refused, as the reference refuses them. As the
reference does, it prefills token by token through the decode step,
then generates ``--gen`` tokens,
greedy at ``--temperature 0``. Weights, prompts and samples come from
explicit torch generators seeded from ``--seed`` (the weights' on the
device, the prompt's and the sampler's on the CPU), so sampled tokens are
not comparable with the JAX driver's. ``generate`` is what chip_smoke.py
drives at full width.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import TINY
from repro_torch.models import registry


def build(cfg: ArchConfig, seed: int, device) -> Dict:
    """Random parameters of ``cfg`` on ``device`` (default: CUDA) from a
    generator there seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    with torch.no_grad():
        return registry.init_params(cfg, gen)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(cfg: ArchConfig, params: Dict, *, batch: int, prompt_len: int,
             gen: int, seed: int = 0, temperature: float = 1.0,
             device=None, enc_embeds: Optional[torch.Tensor] = None) -> Dict:
    """Prefill ``prompt_len`` tokens one by one, then generate ``gen``
    tokens. An encdec model needs its encoder's input ``enc_embeds``
    (batch, enc_len, d_model), which its cache runs through the encoder.
    Returns the tokens and the wall times (each phase ends with a device
    synchronisation; prefill includes making the cache, the encoder
    too): {"prompt", "tokens" (batch, gen) int64, "prefill_s", "gen_s",
    "tok_s", "step_ms", "logits" (the last)}."""
    dev = resolve_device(device)
    host = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=host,
                           dtype=torch.int32).to(dev)
    kw = {}
    if cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} decodes against its encoder's "
                             "output: pass enc_embeds (batch, enc_len, "
                             "d_model)")
        kw = {"params": params, "enc_embeds": enc_embeds.to(dev)}

    _sync(dev)
    t0 = time.perf_counter()
    cache = registry.init_cache(cfg, batch, prompt_len + gen, device=dev,
                                **kw)
    for i in range(prompt_len):
        logits, cache = registry.decode_step(cfg, params, cache,
                                             prompt[:, i:i + 1])
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    sampler = torch.Generator().manual_seed(seed + 2)
    out = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for _ in range(gen):
        out.append(tok)
        logits, cache = registry.decode_step(cfg, params, cache, tok)
        last = logits[:, -1].float()
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1).cpu()
            tok = torch.multinomial(probs, 1, generator=sampler).to(
                device=dev, dtype=torch.int32)
        else:
            tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    tokens = torch.cat(out, dim=1).cpu().to(torch.int64)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    return {"prompt": prompt, "tokens": tokens, "prefill_s": t_prefill,
            "gen_s": t_gen, "tok_s": batch * gen / max(t_gen, 1e-9),
            "step_ms": 1e3 * t_gen / max(gen, 1), "logits": logits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--preset", default="tiny", choices=["tiny", "smoke"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default, or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = TINY if (args.preset == "tiny" or args.arch is None) else smoke_config(args.arch)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("token-LM families only in this driver; see examples/")

    params = build(cfg, args.seed, device)
    r = generate(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, seed=args.seed, temperature=args.temperature,
                 device=device)
    gen = np.asarray(r["tokens"])
    print(f"prefill {args.prompt_len} tokens x {args.batch} reqs: {r['prefill_s']:.2f}s")
    print(f"generated {args.gen} tokens x {args.batch} reqs: {r['gen_s']:.2f}s "
          f"({r['tok_s']:,.0f} tok/s)")
    print("first request tokens:", gen[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
