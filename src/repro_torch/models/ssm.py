"""Mamba2 / SSD (state-space duality) model: mamba2-130m, and the backbone
blocks of zamba2 (hybrid.py). The port of the JAX package's models/ssm.py:
the full-sequence forward and ``loss_fn`` (each block under the config's
remat policy), and the one-token decode step.

The chunked SSD algorithm of arXiv:2405.21060 (single B/C group):

  per layer:  x -> in_proj -> [z | xBC | dt];  xBC -> causal conv (K taps,
  silu) -> [x_ssm | B | C];  dt -> softplus(dt + bias);  a_t = dt_t A_h

  chunked scan (chunk length Q), in float32:
    diag block:   Y[t] = sum_{s<=t, same chunk} (C_t.B_s) exp(A_cum_t - A_cum_s) x_s
    chunk state:  S_c  = sum_q exp(A_last - A_q) B_q x_q^T
    recurrence:   S_c  = exp(A_sum_c) S_{c-1} + S_c   (a loop over chunks)
    off-diag:     Y[t] += C_t . S_{c-1} exp(A_cum_t)

  gate + RMSNorm + out_proj, residual. Decode carries a constant-size
  state: the SSM state (float32) and the conv buffer of the last K-1
  inputs (param dtype), both updated in place in the cache.

The segment sums are masked at -1e30 BEFORE ``exp`` (the reference's
order: exp of the unmasked upper triangle can overflow to inf).
``A_log``, ``D_skip`` and ``dt_bias`` are float32 leaves whatever the
param dtype, as in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_in, heads H, state N, conv channels)."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    return d_in, H, N, d_in + 2 * N


def init_ssm_block(cfg: ArchConfig, generator: torch.Generator,
                   n_layers: int) -> Dict:
    """``n_layers`` SSM blocks stacked on a leading axis."""
    D = cfg.d_model
    d_in, H, N, conv_ch = _dims(cfg)
    dt, dev, n = L.dtype_of(cfg), generator.device, n_layers
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev))
    return {
        "norm": L.init_norm(cfg, D, dev, n),
        "in_proj": L._normal(generator, (n, D, 2 * d_in + 2 * N + H),
                             1 / math.sqrt(D), dt),
        "conv_w": L._normal(generator, (n, cfg.ssm_conv, conv_ch), 0.3, dt),
        "conv_b": torch.zeros((n, conv_ch), dtype=dt, device=dev),
        "A_log": a_log.expand(n, H).clone(),          # A = -exp(A_log)
        "D_skip": torch.ones((n, H), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n, H), dtype=torch.float32, device=dev),
        "gate_norm": {"scale": torch.ones((n, d_in), dtype=dt, device=dev)},
        "out_proj": L._normal(generator, (n, d_in, D), 1 / math.sqrt(d_in),
                              dt),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """u: (B, S, C), w: (K, C): depthwise causal conv, the taps summed in
    the reference's order."""
    K, S = w.shape[0], u.shape[1]
    out = torch.zeros_like(u)
    for k in range(K):
        shift = K - 1 - k
        pad = F.pad(u, (0, 0, shift, 0))[:, :S, :]
        out = out + pad * w[k]
    return out + b


def _ssd_scan(
    x: torch.Tensor,     # (B, S, H, P), already dt-scaled
    a: torch.Tensor,     # (B, S, H), log decay (negative)
    Bv: torch.Tensor,    # (B, S, N)
    Cv: torch.Tensor,    # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32)."""
    B, S, H, P = x.shape
    N = Bv.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    ac = a.reshape(B, nc, chunk, H).to(f32)
    Bc = Bv.reshape(B, nc, chunk, N).to(f32)
    Cc = Cv.reshape(B, nc, chunk, N).to(f32)

    A_cum = torch.cumsum(ac, dim=2)                       # inclusive
    A_tot = A_cum[:, :, -1, :]                            # (B, nc, H)

    # intra-chunk (diagonal block); mask before exp
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    seg = A_cum[:, :, :, None, :] - A_cum[:, :, None, :, :]   # (B,nc,Q,K,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    seg = seg.masked_fill(~tri[None, None, :, :, None], L.MASKED)
    y_diag = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, torch.exp(seg),
                          xc)

    # chunk states
    decay_to_end = torch.exp(A_tot[:, :, None, :] - A_cum)    # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, decay_to_end, xc)

    # inter-chunk recurrence: the state entering each chunk
    carry = (init_state.to(f32) if init_state is not None
             else torch.zeros((B, H, P, N), dtype=f32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(A_tot[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (B,nc,H,P,N)

    # off-diagonal contribution
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, prev_states,
                         torch.exp(A_cum))
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), carry


def ssm_block_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                    state: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, D) -> (out, new state). ``state`` (decode, S == 1):
    {"ssm": (B, H, P, N), "conv": (B, K-1, C)}; the new state is returned
    as fresh tensors ({"ssm" f32, "conv" in the conv buffer's dtype})."""
    B, S, D = x.shape
    d_in, H, N, conv_ch = _dims(cfg)
    P = cfg.ssm_head_dim

    h = L.apply_norm(cfg, p["norm"], x)
    proj = h @ p["in_proj"]                                # (B,S,2d_in+2N+H)
    z, xBC, dt_raw = torch.split(proj, [d_in, conv_ch, H], dim=-1)

    new_state = None
    if state is None:
        xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    else:
        # one-token decode: roll the conv buffer
        buf = torch.cat([state["conv"], xBC.to(state["conv"].dtype)], dim=1)
        conv_out = torch.einsum("bkc,kc->bc", buf, p["conv_w"]) + p["conv_b"]
        xBC = F.silu(conv_out)[:, None, :]
        new_conv = buf[:, 1:, :]

    x_ssm, Bv, Cv = torch.split(xBC, [d_in, N, N], dim=-1)
    x_ssm = x_ssm.reshape(B, S, H, P)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # (B,S,H)
    A = -torch.exp(p["A_log"])                                 # (H,)
    a = dt * A                                                 # log decay
    x_bar = x_ssm.to(torch.float32) * dt[..., None]

    if state is None:
        y, _ = _ssd_scan(x_bar, a, Bv, Cv, min(cfg.ssm_chunk, S))
    else:
        # recurrent step: S' = exp(a) S + B x^T ; y = C . S'
        s_prev = state["ssm"].to(torch.float32)
        a1 = torch.exp(a[:, 0, :])                             # (B, H)
        outer = torch.einsum("bn,bhp->bhpn", Bv[:, 0].to(torch.float32),
                             x_bar[:, 0])
        s_new = s_prev * a1[:, :, None, None] + outer
        y = torch.einsum("bn,bhpn->bhp", Cv[:, 0].to(torch.float32),
                         s_new)[:, None]
        new_state = {"ssm": s_new, "conv": new_conv}

    y = y + p["D_skip"][None, None, :, None] * x_ssm.to(torch.float32)
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["gate_norm"]["scale"])
    return x + y @ p["out_proj"], new_state


def init(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    """Random parameters from ``generator``, on its device (the reference's
    scales; the draws are torch's, not JAX's)."""
    return {"embed": L.init_embed(cfg, generator),
            "blocks": init_ssm_block(cfg, generator, cfg.n_layers),
            "final_norm": L.init_norm(cfg, cfg.d_model, generator.device)}


def _block_out(cfg: ArchConfig, lp: Dict, x: torch.Tensor) -> torch.Tensor:
    return ssm_block_apply(cfg, lp, x)[0]


def run_blocks(cfg: ArchConfig, layers: List[Dict], x: torch.Tensor
               ) -> torch.Tensor:
    """The full-sequence forward through the blocks ``layers`` (per-layer
    param trees, ``layers.layer_params``), each under the config's remat
    policy."""
    block = L.remat(cfg.remat, functools.partial(_block_out, cfg))
    for lp in layers:
        x = block(lp, x)
    return x


def step_blocks(cfg: ArchConfig, blocks: Dict, cache: Dict, x: torch.Tensor,
                layers: range) -> torch.Tensor:
    """One token (x (B, 1, D)) through the blocks ``layers``, each layer's
    SSM state and conv buffer updated in place in ``cache``."""
    for layer in layers:
        x, st = ssm_block_apply(
            cfg, L.index_layer(blocks, layer), x,
            state={"ssm": cache["ssm"][layer], "conv": cache["conv"][layer]})
        cache["ssm"][layer] = st["ssm"]
        cache["conv"][layer] = st["conv"]
    return x


def hidden_states(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                  positions=None) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (B, S, D) (positions
    are not used: the model has no attention)."""
    x = L.embed_tokens(params["embed"], tokens)
    x = run_blocks(cfg, L.layer_params(params["blocks"], cfg.n_layers), x)
    return L.apply_norm(cfg, params["final_norm"], x)


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
            positions=None) -> torch.Tensor:
    """Full logits (B, S, vocab)."""
    return L.lm_logits(cfg, params["embed"],
                       hidden_states(cfg, params, tokens))


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch``, a float32 scalar."""
    x = hidden_states(cfg, params, batch["tokens"])
    return L.chunked_xent(cfg, params["embed"], x, batch["labels"])


# ------------------------------------------------------------------ decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Zeroed constant-size recurrent state on ``device`` (default: CUDA):
    ``ssm`` (L, B, H, P, N) float32 and ``conv`` (L, B, K-1, C) in the
    param dtype; ``max_len`` does not enter it."""
    device = resolve_device(device)
    d_in, H, N, conv_ch = _dims(cfg)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, H, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=L.dtype_of(cfg), device=device),
        "pos": 0,
    }


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One-token decode (tokens (B, 1)): (logits (B, 1, vocab), the cache
    with every layer's state updated in place and ``pos`` advanced)."""
    x = L.embed_tokens(params["embed"], tokens)
    x = step_blocks(cfg, params["blocks"], cache, x, range(cfg.n_layers))
    x = L.apply_norm(cfg, params["final_norm"], x)
    return (L.lm_logits(cfg, params["embed"], x),
            {**cache, "pos": int(cache["pos"]) + 1})
