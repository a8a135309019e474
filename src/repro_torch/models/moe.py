"""Mixture-of-Experts transformer (deepseek-moe-16b, grok-1-314b): the port
of the JAX package's models/moe.py.

Token-choice top-k routing with GShard-style capacity dispatch, as grouped
one-hot einsums (dense and statically shaped):

  * tokens are processed in groups of ``moe_group_size``;
  * per (token, slot) the routed expert gets a capacity slot by a ranked
    float32 cumsum (token-major, then slot); tokens over capacity drop to
    the residual path;
  * experts: stacked (E, D, F) MLP weights; grok's ``expert_slices``
    splits each expert's hidden width into slices that every token routed
    to that expert visits with the same gate; deepseek-style shared
    experts run densely on every token;
  * the Switch-style aux load-balance loss is returned, as the reference
    returns it.

Attention, norms and embeddings are the dense model's (``layers``); the
KV cache is the dense cache, int8 included. ``loss_fn`` is the chunked
cross entropy plus 0.01 times the aux loss, each block under the
config's remat policy. The reference's sharding
hints (``moe_token_axes``, ``act_constraint``) are the identity on one
card and are not carried (ROADMAP A.18). The router and its softmax are
float32, as the reference's promotion makes them: x is cast to float32
before the router product (torch does not promote a bf16 @ f32 product).
Top-k breaks ties toward the lower expert index, as ``lax.top_k`` does.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dense
from repro_torch.models import layers as L


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).to(dtype)


# --------------------------------------------------------------- routing
def _route(cfg: ArchConfig, router_w: torch.Tensor, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (G, T, D) -> (gates (G,T,k) f32, idx (G,T,k) int32, probs (G,T,E)
    f32)."""
    logits = x.to(torch.float32) @ router_w
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts equal probabilities in index order
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    return gates, idx.to(torch.int32), probs


def _dispatch_tensors(cfg: ArchConfig, gates: torch.Tensor,
                      idx: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch/combine one-hots: (dispatch (G,T,E,C) 0/1, combine
    (G,T,E,C), kept (G,T,k)), in the param dtype but ``kept`` (f32).
    Slots are ranked token-major then slot-major (GShard order)."""
    G, T, k = idx.shape
    E, _ = _eff_experts(cfg)
    dt = L.dtype_of(cfg)
    # ranks in f32: the cumsum over T*k entries is exact
    onehot_flat = _one_hot(idx, E, torch.float32).reshape(G, T * k, E)
    ranks = torch.cumsum(onehot_flat, dim=1) - onehot_flat
    keep = (ranks < capacity) * onehot_flat                 # (G, T*k, E)
    rank_idx = torch.sum(ranks * onehot_flat, dim=-1).to(torch.int32)
    rank_oh = _one_hot(rank_idx, capacity, dt)              # (G, T*k, C)
    disp_flat = keep.to(dt)[..., None] * rank_oh[:, :, None, :]
    dispatch = disp_flat.reshape(G, T, k, E, capacity).sum(dim=2)
    gate_flat = gates.reshape(G, T * k).to(dt)
    comb_flat = disp_flat * gate_flat[..., None, None]
    combine = comb_flat.reshape(G, T, k, E, capacity).sum(dim=2)
    kept_any = keep.reshape(G, T, k, E).sum(dim=-1)
    return dispatch, combine, kept_any


def moe_capacity(cfg: ArchConfig, group_tokens: int) -> int:
    c = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, (c + 3) // 4 * 4)


def _eff_experts(cfg: ArchConfig) -> Tuple[int, int]:
    """(E_eff, F_eff) after expert slicing."""
    s = max(cfg.expert_slices, 1)
    return cfg.n_experts * s, cfg.expert_d_ff // s


def init_moe_mlp(cfg: ArchConfig, generator: torch.Generator,
                 n_layers: int) -> Dict:
    """Stacked over ``n_layers``: a float32 router (D, E) and the experts'
    (E_eff, D, F_eff) / (E_eff, F_eff, D) weights in the param dtype (each
    drawn one layer at a time), plus the shared experts' MLP."""
    D, E_ = cfg.d_model, cfg.n_experts
    E, Fe = _eff_experts(cfg)
    dt = L.dtype_of(cfg)
    sc_in, sc_out = 1 / math.sqrt(D), 1 / math.sqrt(Fe)
    p = {
        "router": L._normal(generator, (n_layers, D, E_), sc_in,
                            torch.float32),
        "w_up": L._normal(generator, (n_layers, E, D, Fe), sc_in, dt),
        "w_down": L._normal(generator, (n_layers, E, Fe, D), sc_out, dt),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = L._normal(generator, (n_layers, E, D, Fe), sc_in, dt)
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(cfg, generator, n_layers,
                                 d_ff=cfg.n_shared_experts * cfg.expert_d_ff)
    return p


def _expert_act(cfg: ArchConfig, p: Dict, h_in: torch.Tensor
                ) -> torch.Tensor:
    """h_in: (G, E, C, D) -> (G, E, C, D) through the per-expert MLPs, in
    the param dtype."""
    h_in = h_in.to(L.dtype_of(cfg))
    up = torch.einsum("gecd,edf->gecf", h_in, p["w_up"])
    if cfg.mlp == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", h_in, p["w_gate"])) * up
    elif cfg.mlp == "geglu":
        h = L._gelu(torch.einsum("gecd,edf->gecf", h_in, p["w_gate"])) * up
    elif cfg.mlp == "relu2":
        h = torch.square(torch.relu(up))
    else:
        h = L._gelu(up)
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def moe_mlp(cfg: ArchConfig, p: Dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux loss, a float32 scalar)."""
    Bsz, S, D = x.shape
    T_all = Bsz * S
    Tg = min(cfg.moe_group_size, T_all)
    if T_all % Tg:
        raise ValueError(f"{T_all} tokens do not split into groups of {Tg}")
    G = T_all // Tg
    xg = x.reshape(G, Tg, D)

    gates, idx, probs = _route(cfg, p["router"], xg)
    s = max(cfg.expert_slices, 1)
    if s > 1:
        # a token routed to expert e visits every slice e*s+j with the same
        # gate (the slices' outputs sum to the expert's)
        idx = (idx[..., None] * s + torch.arange(
            s, dtype=idx.dtype, device=idx.device)).reshape(G, Tg, -1)
        gates = torch.repeat_interleave(gates, s, dim=-1)
    C = moe_capacity(cfg, Tg)
    dispatch, combine, _ = _dispatch_tensors(cfg, gates, idx, C)

    h_in = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)
    h_out = _expert_act(cfg, p, h_in)
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), h_out)

    # Switch-style aux loss: E * sum_e(frac_tokens_e * mean_prob_e); with
    # expert slices the first slot's index is a slice index, and indices
    # past n_experts count nowhere, as jax.nn.one_hot makes them
    frac = torch.mean(_one_hot(idx[..., 0], cfg.n_experts, torch.float32),
                      dim=(0, 1))
    pmean = torch.mean(probs, dim=(0, 1))
    aux = cfg.n_experts * torch.sum(frac * pmean)

    if cfg.n_shared_experts:
        y = y + L.mlp(cfg, p["shared"], xg)
    return y.reshape(Bsz, S, D), aux


# ----------------------------------------------------------------- blocks
def init(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    """Random parameters from ``generator``, on its device (the reference's
    scales; the draws are torch's, not JAX's)."""
    n, dev = cfg.n_layers, generator.device
    blocks = {
        "ln1": L.init_norm(cfg, cfg.d_model, dev, n),
        "attn": L.init_attention(cfg, generator, n),
        "ln2": L.init_norm(cfg, cfg.d_model, dev, n),
        "moe": init_moe_mlp(cfg, generator, n),
    }
    return {"embed": L.init_embed(cfg, generator), "blocks": blocks,
            "final_norm": L.init_norm(cfg, cfg.d_model, dev)}


def hidden_states(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (final hidden states (B, S, D), the aux
    loss averaged over the layers)."""
    x = L.embed_tokens(params["embed"], tokens)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = L.remat(cfg.remat, functools.partial(_block_apply, cfg))
    for lp in L.layer_params(params["blocks"], cfg.n_layers):
        x, aux = block(lp, x, aux, positions)
    return L.apply_norm(cfg, params["final_norm"], x), aux / cfg.n_layers


def _block_apply(cfg: ArchConfig, lp: Dict, x: torch.Tensor,
                 aux: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    h, _ = L.attention(cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x),
                       positions)
    x = x + h
    m, a = moe_mlp(cfg, lp["moe"], L.apply_norm(cfg, lp["ln2"], x))
    return x + m, aux + a


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full logits (B, S, vocab), aux loss)."""
    x, aux = hidden_states(cfg, params, tokens, positions)
    return L.lm_logits(cfg, params["embed"], x), aux


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Chunked cross entropy of ``batch`` plus 0.01 times the aux load
    -balance loss, a float32 scalar."""
    x, aux = hidden_states(cfg, params, batch["tokens"])
    return (L.chunked_xent(cfg, params["embed"], x, batch["labels"])
            + 0.01 * aux)


# ------------------------------------------------------------------ decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """The dense model's KV cache (``dense.init_cache``)."""
    return dense.init_cache(cfg, batch, max_len, device=device)


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One-token decode (tokens (B, 1)): (logits (B, 1, vocab), the cache
    with this token written in place and ``pos`` advanced)."""
    return dense.decode_blocks(
        cfg, params, cache, L.embed_tokens(params["embed"], tokens),
        lambda lp, h: moe_mlp(cfg, lp["moe"], h)[0])
