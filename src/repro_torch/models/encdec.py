"""Encoder-decoder transformer (whisper-tiny backbone): the port of the JAX
package's models/encdec.py.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, enc_len, d_model). Encoder: bidirectional
self-attention blocks with RoPE. Decoder: causal self-attention (a KV
cache in decode) + cross-attention over the encoder output without RoPE
+ MLP. ``init_cache(params=, enc_embeds=)`` runs the encoder once and
stores each decoder layer's cross K/V, which every decode step attends
to in full. ``loss_fn``: the decoder's chunked cross entropy over the
encoder's output (no remat, as in the reference).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    """Random parameters from ``generator``, on its device (the reference's
    scales; the draws are torch's, not JAX's)."""
    dev, ne, nd = generator.device, cfg.n_enc_layers, cfg.n_layers
    D = cfg.d_model
    enc = {"ln1": L.init_norm(cfg, D, dev, ne),
           "attn": L.init_attention(cfg, generator, ne),
           "ln2": L.init_norm(cfg, D, dev, ne),
           "mlp": L.init_mlp(cfg, generator, ne)}
    dec = {"ln1": L.init_norm(cfg, D, dev, nd),
           "self_attn": L.init_attention(cfg, generator, nd),
           "ln_x": L.init_norm(cfg, D, dev, nd),
           "cross_attn": L.init_attention(cfg, generator, nd),
           "ln2": L.init_norm(cfg, D, dev, nd),
           "mlp": L.init_mlp(cfg, generator, nd)}
    return {"embed": L.init_embed(cfg, generator), "enc_blocks": enc,
            "enc_norm": L.init_norm(cfg, D, dev), "dec_blocks": dec,
            "final_norm": L.init_norm(cfg, D, dev)}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def encode(cfg: ArchConfig, params: Dict, enc_embeds: torch.Tensor
           ) -> torch.Tensor:
    """(B, T, D) frame embeddings -> the normed encoder output, in the
    param dtype."""
    x = enc_embeds.to(L.dtype_of(cfg))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for lp in L.layer_params(params["enc_blocks"], cfg.n_enc_layers):
        h, _ = L.attention(cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x),
                           positions, causal=False)
        x = x + h
        x = x + L.mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))
    return L.apply_norm(cfg, params["enc_norm"], x)


def _dec_block(cfg: ArchConfig, lp: Dict, x: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor
               ) -> torch.Tensor:
    h, _ = L.attention(cfg, lp["self_attn"], L.apply_norm(cfg, lp["ln1"], x),
                       positions)
    x = x + h
    hx, _ = L.attention(cfg, lp["cross_attn"],
                        L.apply_norm(cfg, lp["ln_x"], x), positions,
                        kv=(enc_out, enc_out), causal=False, use_rope=False)
    x = x + hx
    return x + L.mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))


def _cross_from_cached(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cross-attention over precomputed K/V (B, T, KV, hd), every entry
    attended."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, KV, H // KV, hd)
    out = L._gqa_scores_softmax_v(q, k, v, None, L._scale(hd))
    return out.reshape(B, S, H * hd) @ p["wo"]


def hidden_states(cfg: ArchConfig, params: Dict, enc_embeds: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Encoder, then the decoder over ``tokens`` -> final hidden states
    (B, S, D)."""
    enc_out = encode(cfg, params, enc_embeds)
    x = L.embed_tokens(params["embed"], tokens)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for lp in L.layer_params(params["dec_blocks"], cfg.n_layers):
        x = _dec_block(cfg, lp, x, positions, enc_out)
    return L.apply_norm(cfg, params["final_norm"], x)


def forward(cfg: ArchConfig, params: Dict, enc_embeds: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full logits (B, S, vocab)."""
    return L.lm_logits(cfg, params["embed"],
                       hidden_states(cfg, params, enc_embeds, tokens))


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({"enc_embeds",
    "tokens", "labels"}), a float32 scalar."""
    x = hidden_states(cfg, params, batch["enc_embeds"], batch["tokens"])
    return L.chunked_xent(cfg, params["embed"], x, batch["labels"])


# ------------------------------------------------------------------ decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               params: Optional[Dict] = None,
               enc_embeds: Optional[torch.Tensor] = None,
               device=None) -> Dict:
    """On ``device`` (default: CUDA): a zeroed self-attention KV cache k/v
    (L, B, T, KV, hd) in the param dtype (never int8, as in the
    reference), and the cross K/V of every decoder layer (L, B, enc_len,
    KV, hd): projected from the encoder's output when ``params`` and
    ``enc_embeds`` are given, else zeros."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim()
    dt = L.dtype_of(cfg)
    kv_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    cache = {"k": torch.zeros(kv_shape, dtype=dt, device=device),
             "v": torch.zeros(kv_shape, dtype=dt, device=device), "pos": 0}
    if params is not None and enc_embeds is not None:
        enc_out = encode(cfg, params, enc_embeds.to(device))
        T = enc_out.shape[1]
        blocks = params["dec_blocks"]["cross_attn"]
        cache["cross_k"] = torch.stack([
            (enc_out @ blocks["wk"][l]).reshape(batch, T, cfg.n_kv_heads, hd)
            for l in range(cfg.n_layers)])
        cache["cross_v"] = torch.stack([
            (enc_out @ blocks["wv"][l]).reshape(batch, T, cfg.n_kv_heads, hd)
            for l in range(cfg.n_layers)])
    else:
        shape = (cfg.n_layers, batch, cfg.enc_len, cfg.n_kv_heads, hd)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One-token decode (tokens (B, 1)): (logits (B, 1, vocab), the cache
    with this token's self-attention K/V written in place and ``pos``
    advanced)."""
    x = L.embed_tokens(params["embed"], tokens)
    pos = int(cache["pos"])
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"cache is full: pos {pos} of "
                         f"{cache['k'].shape[2]} positions")
    for layer in range(cfg.n_layers):
        lp = L.index_layer(params["dec_blocks"], layer)
        h = L.attention_decode_inplace(
            cfg, lp["self_attn"], L.apply_norm(cfg, lp["ln1"], x), pos,
            cache["k"], cache["v"], layer)[0]
        x = x + h
        x = x + _cross_from_cached(
            cfg, lp["cross_attn"], L.apply_norm(cfg, lp["ln_x"], x),
            cache["cross_k"][layer], cache["cross_v"][layer])
        x = x + L.mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(cfg, params["embed"], x), {**cache, "pos": pos + 1}
