"""Hybrid SSM + shared-attention model (zamba2-1.2b): the port of the JAX
package's models/hybrid.py.

A Mamba2 backbone (``ssm``) with ONE weight-shared transformer block
(attention + MLP) applied before every segment of ``shared_attn_every``
SSM layers. The shared block's weights are the same at every application;
in decode each application keeps its own KV cache, read through
``layers.attention(cache=)``: the token's K/V written at ``pos`` in place,
then all T entries under ``t <= pos``, as the reference reads them.
In the full-sequence forward (and ``loss_fn``) the SSM blocks follow the
config's remat policy and the shared block is fully rematerialised
whenever the policy is not "none", as in the reference: its attention
probabilities would otherwise be saved at every application.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def n_shared_applications(cfg: ArchConfig) -> int:
    every = max(cfg.shared_attn_every, 1)
    return (cfg.n_layers + every - 1) // every


def _segment_sizes(cfg: ArchConfig) -> List[int]:
    every = max(cfg.shared_attn_every, 1)
    sizes, rest = [], cfg.n_layers
    while rest > 0:
        sizes.append(min(every, rest))
        rest -= every
    return sizes


def _segments(cfg: ArchConfig):
    """(application index, range of SSM layers after it)."""
    off = 0
    for app, seg in enumerate(_segment_sizes(cfg)):
        yield app, range(off, off + seg)
        off += seg


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    """Random parameters from ``generator``, on its device (the reference's
    scales; the draws are torch's, not JAX's)."""
    dev = generator.device
    return {
        "embed": L.init_embed(cfg, generator),
        "blocks": S.init_ssm_block(cfg, generator, cfg.n_layers),
        "shared": {
            "ln1": L.init_norm(cfg, cfg.d_model, dev),
            "attn": L.init_attention(cfg, generator, None),
            "ln2": L.init_norm(cfg, cfg.d_model, dev),
            "mlp": L.init_mlp(cfg, generator, None),
        },
        "final_norm": L.init_norm(cfg, cfg.d_model, dev),
    }


def _shared_apply(cfg: ArchConfig, sp: Dict, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h, new_cache = L.attention(cfg, sp["attn"], L.apply_norm(cfg, sp["ln1"], x),
                               positions, cache=cache)
    x = x + h
    x = x + L.mlp(cfg, sp["mlp"], L.apply_norm(cfg, sp["ln2"], x))
    return x, new_cache


def hidden_states(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (B, S, D); the shared
    block's attention is query-chunked as the dense model's."""
    x = L.embed_tokens(params["embed"], tokens)
    B, Ssz = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(Ssz, dtype=torch.int32,
                                 device=x.device).expand(B, Ssz)
    x = L.act_constraint(cfg, x)
    shared = L.remat("none" if cfg.remat == "none" else "full",
                     functools.partial(_shared_out, cfg))
    blocks = L.layer_params(params["blocks"], cfg.n_layers)
    for _, layers in _segments(cfg):
        x = L.act_constraint(cfg, shared(params["shared"], x, positions))
        x = S.run_blocks(cfg, blocks[layers.start:layers.stop], x)
    return L.apply_norm(cfg, params["final_norm"], x)


def _shared_out(cfg: ArchConfig, sp: Dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    return _shared_apply(cfg, sp, x, positions)[0]


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full logits (B, S, vocab)."""
    return L.lm_logits(cfg, params["embed"],
                       hidden_states(cfg, params, tokens, positions))


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch``, a float32 scalar."""
    x = hidden_states(cfg, params, batch["tokens"])
    return L.chunked_xent(cfg, params["embed"], x, batch["labels"])


# ------------------------------------------------------------------ decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Zeroed cache on ``device`` (default: CUDA): the SSM state and conv
    buffers of every layer (``ssm.init_cache``) and a (B, T, KV, hd) KV
    cache for each application of the shared block, stacked: k/v (n_app,
    B, T, KV, hd) in the param dtype."""
    device = resolve_device(device)
    cache = S.init_cache(cfg, batch, max_len, device=device)
    kv_shape = (n_shared_applications(cfg), batch, max_len, cfg.n_kv_heads,
                cfg.resolved_head_dim())
    dt = L.dtype_of(cfg)
    cache["k"] = torch.zeros(kv_shape, dtype=dt, device=device)
    cache["v"] = torch.zeros(kv_shape, dtype=dt, device=device)
    return cache


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One-token decode (tokens (B, 1)): (logits (B, 1, vocab), the cache
    with every state and KV entry written in place and ``pos`` advanced)."""
    x = L.embed_tokens(params["embed"], tokens)
    B = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for app, layers in _segments(cfg):
        x, _ = _shared_apply(
            cfg, params["shared"], x, positions,
            cache={"k": cache["k"][app], "v": cache["v"][app], "pos": pos})
        x = S.step_blocks(cfg, params["blocks"], cache, x, layers)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(cfg, params["embed"], x), {**cache, "pos": pos + 1}
