"""Decoder-only dense transformer (GQA + RoPE + configurable MLP/norm).

Covers starcoder2-7b, gemma-7b, phi3-medium-14b, nemotron-4-340b, and the
internvl2-76b VLM backbone (embeds_in=True: the patch/text embeddings
arrive precomputed). The port of the JAX package's models/dense.py:
``init``, ``hidden_states`` / ``forward``, ``loss_fn`` (chunked cross
entropy, each block under the config's remat policy), ``init_cache`` and
``decode_step``.

Parameters keep the reference's pytree: per-layer leaves stacked on a
leading layer axis under the same names ({"blocks": {"ln1", "attn",
"ln2", "mlp"}, "final_norm", "embed"}), so a JAX tree carries across
(``convert.lm_params_from_numpy``). The layers loop in Python over the
stacked leaves (``decode_unroll`` has no effect). The KV cache is updated
in place; its ``pos`` is a Python int.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    """Random parameters from ``generator``, on its device: N(0, 1/fan_in)
    projections, N(0, 0.02) embeddings, unit norms (the reference's
    scales; the draws are torch's, not JAX's)."""
    n, dev = cfg.n_layers, generator.device
    blocks = {
        "ln1": L.init_norm(cfg, cfg.d_model, dev, n),
        "attn": L.init_attention(cfg, generator, n),
        "ln2": L.init_norm(cfg, cfg.d_model, dev, n),
        "mlp": L.init_mlp(cfg, generator, n),
    }
    return {"blocks": blocks,
            "final_norm": L.init_norm(cfg, cfg.d_model, dev),
            "embed": L.init_embed(cfg, generator)}


def _block_apply(cfg: ArchConfig, lp: Dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h, _ = L.attention(cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x),
                       positions)
    x = x + h
    return x + L.mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))


def _inputs(cfg: ArchConfig, params: Dict, tokens_or_embeds: torch.Tensor):
    if cfg.embeds_in:
        return tokens_or_embeds.to(L.dtype_of(cfg))
    return L.embed_tokens(params["embed"], tokens_or_embeds)


def hidden_states(
    cfg: ArchConfig,
    params: Dict,
    tokens_or_embeds: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (B, S, D)."""
    x = _inputs(cfg, params, tokens_or_embeds)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    block = L.remat(cfg.remat, functools.partial(_block_apply, cfg))
    for lp in L.layer_params(params["blocks"], cfg.n_layers):
        x = block(lp, x, positions)
    return L.apply_norm(cfg, params["final_norm"], x)


def forward(cfg: ArchConfig, params: Dict, tokens_or_embeds: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full logits (B, S, vocab)."""
    return L.lm_logits(cfg, params["embed"],
                       hidden_states(cfg, params, tokens_or_embeds, positions))


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({"tokens" or, for the
    VLM, "embeds"; "labels"}), a float32 scalar."""
    inp = batch["embeds"] if cfg.embeds_in else batch["tokens"]
    x = hidden_states(cfg, params, inp)
    return L.chunked_xent(cfg, params["embed"], x, batch["labels"])


# ------------------------------------------------------------------ decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Zeroed static-shape cache on ``device`` (default: CUDA): k/v (L, B,
    T, KV, hd) in the param dtype, or int8 with per-(layer, batch, pos)
    bf16 scales; ``pos`` 0."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim()
    kv_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    if cfg.kv_cache_dtype == "int8":
        sc_shape = (cfg.n_layers, batch, max_len)
        return {
            "k": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "v": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sc_shape, dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(sc_shape, dtype=torch.bfloat16,
                                   device=device),
            "pos": 0,
        }
    dt = L.dtype_of(cfg)
    return {"k": torch.zeros(kv_shape, dtype=dt, device=device),
            "v": torch.zeros(kv_shape, dtype=dt, device=device),
            "pos": 0}


def decode_step(
    cfg: ArchConfig,
    params: Dict,
    cache: Dict,
    tokens_or_embeds: torch.Tensor,  # (B, 1) int  or (B, 1, D) embeds
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the static-shape KV cache: (logits (B, 1,
    vocab), the cache with this token written and ``pos`` advanced)."""
    return decode_blocks(cfg, params, cache,
                         _inputs(cfg, params, tokens_or_embeds),
                         lambda lp, h: L.mlp(cfg, lp["mlp"], h))


def decode_blocks(cfg: ArchConfig, params: Dict, cache: Dict,
                  x: torch.Tensor, ffn: Callable) -> Tuple[torch.Tensor, Dict]:
    """The decode step's layer loop from the embedded token x (B, 1, D):
    attention against the stacked cache, then ``ffn(layer params, normed
    x)`` on the residual; the MoE model passes its expert MLP."""
    pos = int(cache["pos"])
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"cache is full: pos {pos} of "
                         f"{cache['k'].shape[2]} positions")
    quant = cfg.kv_cache_dtype == "int8"
    scales = (cache["k_scale"], cache["v_scale"]) if quant else None
    for layer in range(cfg.n_layers):
        lp = L.index_layer(params["blocks"], layer)
        h = L.attention_decode_inplace(
            cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x), pos,
            cache["k"], cache["v"], layer, scales=scales)[0]
        x = x + h
        x = x + ffn(lp, L.apply_norm(cfg, lp["ln2"], x))
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(cfg, params["embed"], x), {**cache, "pos": pos + 1}


def _as_module(tree: Dict) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _as_module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


class DenseLM(nn.Module):
    """A dense LM's parameters as a module (``state_dict`` names follow the
    pytree: ``blocks.attn.wq``, ...), with the module-level functions as
    methods. ``params`` is the pytree of the same tensors."""

    def __init__(self, cfg: ArchConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.tree = _as_module(params)

    def forward(self, tokens_or_embeds: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self.cfg, self.params, tokens_or_embeds, positions)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        dev = self.params["final_norm"]["scale"].device
        return init_cache(self.cfg, batch, max_len, device=dev)

    def decode_step(self, cache: Dict, tokens_or_embeds: torch.Tensor):
        return decode_step(self.cfg, self.params, cache, tokens_or_embeds)
