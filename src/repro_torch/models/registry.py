"""Family -> model-module dispatch and the uniform step API of the LM
scaffold (the port of the JAX package's models/registry.py).

API per family module:
  init(cfg, generator) -> params
  loss_fn(cfg, params, batch) -> scalar
  init_cache(cfg, batch, max_len[, ...], device=None) -> cache
  decode_step(cfg, params, cache, tokens) -> (logits, cache)

The port serves and trains every family of the reference: dense and the
VLM backbone (the same module, ``embeds_in=True``), moe, ssm, hybrid and
encdec (``init_cache(..., params=, enc_embeds=)`` runs its encoder).

Batch contents by family:
  dense/moe/ssm/hybrid: {"tokens": (B,S) i32, "labels": (B,S) i32}
  vlm:    {"embeds": (B,S,D) f32, "labels": (B,S) i32}   (stub frontend)
  encdec: {"enc_embeds": (B,enc_len,D) f32, "tokens", "labels"}
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dense, encdec, hybrid, moe, ssm

_FAMILIES = {
    "dense": dense,
    "vlm": dense,      # backbone only; embeds_in=True switches the input path
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
}


def model_for(cfg: ArchConfig):
    return _FAMILIES[cfg.family]


def init_params(cfg: ArchConfig, generator: torch.Generator):
    return model_for(cfg).init(cfg, generator)


def loss_fn(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    """The family's training loss on ``batch``, a float32 scalar."""
    return model_for(cfg).loss_fn(cfg, params, batch)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None, **kw):
    """The family's cache on ``device`` (default: CUDA); ``kw`` goes to the
    family (encdec: ``params``, ``enc_embeds``)."""
    return model_for(cfg).init_cache(cfg, batch, max_len, device=device,
                                     **kw)


def decode_step(cfg: ArchConfig, params, cache, tokens):
    """tokens: (B,1) int for LMs; (B,1,D) embeds for VLM."""
    return model_for(cfg).decode_step(cfg, params, cache, tokens)


def make_batch(cfg: ArchConfig, shape, generator: torch.Generator) -> Dict:
    """Random batch from ``generator``, on its device (smoke tests and
    examples)."""
    B, S = shape.global_batch, shape.seq_len
    dev = generator.device

    def tokens():
        return torch.randint(0, cfg.vocab, (B, S), generator=generator,
                             dtype=torch.int32, device=dev)

    def embeds(n):
        return torch.randn((B, n, cfg.d_model), generator=generator,
                           dtype=torch.float32, device=dev) * 0.02

    if cfg.family == "vlm" or cfg.embeds_in:
        return {"embeds": embeds(S), "labels": tokens()}
    if cfg.family == "encdec":
        return {"enc_embeds": embeds(cfg.enc_len), "tokens": tokens(),
                "labels": tokens()}
    return {"tokens": tokens(), "labels": tokens()}
