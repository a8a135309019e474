"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

The port's own copy of the JAX package's configs (imports rewritten): the
same ``ArchConfig`` fields, archs and smoke reductions. The sharding
fields (``act_shard``, ``fsdp``, ``moe_token_axes``, ...) are kept and
have no effect on one card."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, SMOKE_SHAPE

from repro_torch.configs.internvl2_76b import CONFIG as _internvl2_76b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2_7b
from repro_torch.configs.gemma_7b import CONFIG as _gemma_7b
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3_medium_14b
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron_4_340b
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek_moe_16b
from repro_torch.configs.grok_1_314b import CONFIG as _grok_1_314b
from repro_torch.configs.whisper_tiny import CONFIG as _whisper_tiny
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2_1_2b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _internvl2_76b,
        _mamba2_130m,
        _starcoder2_7b,
        _gemma_7b,
        _phi3_medium_14b,
        _nemotron_4_340b,
        _deepseek_moe_16b,
        _grok_1_314b,
        _whisper_tiny,
        _zamba2_1_2b,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: small widths/layers/experts/vocab, so one
    forward/train step runs on CPU in the smoke tests. The FULL configs are
    exercised only via the dry-run (ShapeDtypeStruct, no allocation)."""
    c = get_arch(name)
    return dataclasses.replace(
        c,
        n_layers=2,
        n_enc_layers=min(c.n_enc_layers, 2),
        enc_len=16 if c.family == "encdec" else c.enc_len,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if c.n_kv_heads < c.n_heads else 4,
        head_dim=16,
        d_ff=128 if c.d_ff else 0,
        vocab=512,
        n_experts=8 if c.n_experts else 0,
        n_shared_experts=min(c.n_shared_experts, 1),
        top_k=min(c.top_k, 2),
        expert_d_ff=64 if c.expert_d_ff else 0,
        moe_group_size=32,
        ssm_state=16 if c.ssm_state else 0,
        ssm_head_dim=16 if c.ssm_state else c.ssm_head_dim,
        ssm_chunk=16 if c.ssm_state else c.ssm_chunk,
        shared_attn_every=2 if c.shared_attn_every else 0,
        param_dtype="float32",
        num_microbatches=1,
        fsdp=False,
        act_shard="none",  # no mesh context in smoke tests
        loss_chunk=32,
        kv_cache_dtype="float32",
        moe_token_axes=(),
    )


__all__ = [
    "ARCHS", "ArchConfig", "ShapeSpec", "SHAPES", "SMOKE_SHAPE",
    "get_arch", "smoke_config",
]
