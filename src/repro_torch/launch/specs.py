"""Stand-ins for every model input of a dry-run cell (the port of the JAX
package's launch/specs.py).

The reference's ``ShapeDtypeStruct``s become fake tensors: the family's
own ``init`` / ``init_cache`` run under a ``FakeTensorMode`` with a CPU
generator, so every leaf has its real shape and dtype and nothing is
allocated (grok-1-314b and nemotron-4-340b included). Each builder runs
under the caller's ``FakeTensorMode`` when one is active (the dry-run's),
else under a new one. For train/prefill cells the inputs are the batch
dict; for decode cells, (cache, tokens) with the KV cache at the cell's
seq_len.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import registry
from repro_torch.models.layers import dtype_of

PyTree = Any


def fake_mode():
    """The active ``FakeTensorMode``'s context (a no-op), or a new mode."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="cpu")


def batch_specs_sds(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg)
    with fake_mode():
        if cfg.family == "vlm" or cfg.embeds_in:
            return {"embeds": _sds((B, S, cfg.d_model), dt),
                    "labels": _sds((B, S), torch.int32)}
        if cfg.family == "encdec":
            return {"enc_embeds": _sds((B, cfg.enc_len, cfg.d_model), dt),
                    "tokens": _sds((B, S), torch.int32),
                    "labels": _sds((B, S), torch.int32)}
        return {"tokens": _sds((B, S), torch.int32),
                "labels": _sds((B, S), torch.int32)}


def params_sds(cfg: ArchConfig) -> PyTree:
    with fake_mode():
        return registry.init_params(cfg, torch.Generator())


def cache_specs_sds(cfg: ArchConfig, shape: ShapeSpec) -> PyTree:
    """The decode cache sized to the cell's seq_len (encdec: its cross K/V
    zeroed, as the reference's cache without params)."""
    B, T = shape.global_batch, shape.seq_len
    with fake_mode():
        return registry.init_cache(cfg, B, T, device="cpu")


def decode_tokens_sds(cfg: ArchConfig, shape: ShapeSpec) -> torch.Tensor:
    B = shape.global_batch
    with fake_mode():
        if cfg.family == "vlm" or cfg.embeds_in:
            return _sds((B, 1, cfg.d_model), dtype_of(cfg))
        return _sds((B, 1), torch.int32)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, PyTree]:
    """Everything a cell needs, keyed by role."""
    out: Dict[str, PyTree] = {"params": params_sds(cfg)}
    if shape.kind in ("train", "prefill"):
        out["batch"] = batch_specs_sds(cfg, shape)
    else:
        out["cache"] = cache_specs_sds(cfg, shape)
        out["tokens"] = decode_tokens_sds(cfg, shape)
    return out
