"""Shared model-layer primitives of the LM scaffold (PyTorch, dict params).

The port of the JAX package's models/layers.py:
  * params are nested dicts of tensors; per-layer weights are STACKED on a
    leading L axis under the reference's names, and the model loops over
    them in Python: a full-sequence forward splits each stacked leaf once
    (``layer_params``, one ``unbind`` whose backward stacks the layers'
    grads once), a decode step indexes it (``index_layer``);
  * activations flow as (batch, seq, d_model) in the config's param_dtype
    (bf16 by default), norm statistics and softmax in f32, in the
    reference's order of casts (below);
  * attention supports GQA (n_kv_heads <= n_heads), RoPE, causal or
    bidirectional masking, cross-attention over a source sequence,
    query-chunked attention, a one-token step against a cache that reads
    all T entries under ``t <= pos`` (the hybrid's shared block), and a
    one-token decode path that updates a static-shape stacked KV cache in
    place (bf16 or int8 with bf16 scales); the initialisers make the
    stacked leaves directly, one leading index at a time.

The matrix products are plain ``@``/``einsum``: none of them is a Pallas
kernel in the reference. ``scaled_dot_product_attention`` is not used: it
does not follow the reference's casts (f32 scores, -1e30 masking,
probabilities cast to v's dtype before the second product).
The reference's sharding constraints (``act_constraint``,
``act_entry``) redistribute a DTensor activation to the reference's spec
and are the identity on a plain tensor, so one device computes what it
computed without them.

Training: ``softmax_xent`` and ``chunked_xent`` (the LM head folded into
a cross entropy chunked over the sequence, each chunk recomputed in
backward), and ``remat``, the reference's rematerialisation policies
("full", "dots", "none") as ``torch.utils.checkpoint``. Both act only
while autograd records (``torch.is_grad_enabled()``); under
``torch.no_grad`` they run the plain function, so serving is unchanged.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.sharding import is_dtensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# masked attention scores, as the reference's (not -inf)
MASKED = -1e30


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# leaves the reference keeps in float32 whatever the config's param_dtype
# (moe.py:91, ssm.py:53-57)
F32_LEAVES = frozenset({"router", "A_log", "D_skip", "dt_bias"})


def _lead(n_layers: Optional[int]) -> Tuple[int, ...]:
    return () if n_layers is None else (n_layers,)


def _normal(generator: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 on the generator's device, then cast.
    A stacked leaf (3 or more dims) is drawn one leading index at a time
    into the cast tensor, so the f32 draw never holds more than one layer
    (deepseek-moe-16b's stacked experts are 20.7 GB in f32)."""
    shape = tuple(shape)
    if len(shape) < 3:
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for i in range(shape[0]):
        out[i] = _normal(generator, shape[1:], scale, dtype)
    return out


# ----------------------------------------------------------------- norms
# Statistics in f32; rsqrt is cast to x's dtype BEFORE it multiplies x and
# w (reference layers.py:33-44): in bf16 that order shows.
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    var = torch.mean(torch.square(x).float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x.float(), dim=-1, keepdim=True)
    xc = x - mu.to(x.dtype)
    var = torch.mean(torch.square(xc).float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return xc * inv * w + b


def apply_norm(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(cfg: ArchConfig, d: int, device, n_layers: Optional[int] = None
              ) -> Dict:
    """Unit scale (and zero bias for layernorm), stacked on a leading axis
    of ``n_layers`` when given."""
    lead = _lead(n_layers)
    p = {"scale": torch.ones(lead + (d,), dtype=dtype_of(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype_of(cfg),
                                device=device)
    return p


# ------------------------------------------------------------------ rope
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python base: a 0-d device tensor here would be a blocking copy
    # from the host at every call
    freq = torch.pow(float(theta), exps)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, n, head_dim); cos/sin: (..., S, half) broadcast over n.
    The two halves rotate (concatenated, not interleaved) in f32; the
    result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention
def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   n_layers: Optional[int]) -> Dict:
    """Stacked on a leading axis of ``n_layers``, or one block (None)."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dt = dtype_of(cfg)
    lead = _lead(n_layers)
    return {
        "wq": _normal(generator, lead + (D, H * hd), 1 / math.sqrt(D), dt),
        "wk": _normal(generator, lead + (D, KV * hd), 1 / math.sqrt(D), dt),
        "wv": _normal(generator, lead + (D, KV * hd), 1 / math.sqrt(D), dt),
        "wo": _normal(generator, lead + (H * hd, D), 1 / math.sqrt(H * hd),
                      dt),
    }


def _scale(hd: int) -> float:
    """1 / sqrt(float32(hd)) rounded to float32, as the reference computes
    it (a float32 tensor times this Python float stays float32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _gqa_scores_softmax_v(q, k, v, mask, scale):
    """q: (B,S,KV,G,hd)  k/v: (B,T,KV,hd)  mask: None (attend to every
    entry) or broadcastable (B,1,1,S,T).

    Returns (B,S,KV,G,hd). Scores and softmax in f32, masked entries at
    -1e30, probabilities cast to v's dtype before the second product.
    DTensor q/k/v: ``_sharded_attention``."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, mask, scale)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, MASKED)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def _sharded_attention(q, k, v, mask, scale):
    """Attention of DTensors, shard by shard: every (batch row, KV head)
    is independent, so each rank runs the plain body on its local rows
    and heads (DTensor cannot propagate the einsums, whose flattened batch
    dim would mix two sharded dims). q keeps its batch (dim 0), KV-head
    (2) and group (3) shards, k/v take q's batch and KV-head shards (the
    rest gathered), and the mask its batch rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    q_pl = [p if isinstance(p, Shard) and p.dim in (0, 2, 3) else Replicate()
            for p in q.placements]
    kv_pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
             for p in q_pl]
    # k/v replicated where q splits its query groups: their grads are
    # partial sums there
    kv_grad = [Partial() if isinstance(p, Shard) and p.dim == 3 else k_
               for p, k_ in zip(q_pl, kv_pl)]
    m_pl = [p if mask is not None and mask.shape[0] > 1 and p.is_shard(0)
            else Replicate() for p in q_pl]
    return local_map(
        lambda q_, k_, v_, m_: _gqa_scores_softmax_v(q_, k_, v_, m_, scale),
        q.device_mesh, [(q, q_pl, q_pl), (k, kv_pl, kv_grad),
                        (v, kv_pl, kv_grad), (mask, m_pl, m_pl)],
        q_pl, q.shape)


class _LocalShard(torch.autograd.Function):
    """DTensor x redistributed to ``placements``, as this rank's local
    tensor. Backward reads the local grad as ``grad_placements`` and
    reduces it at once to x's own layout."""

    @staticmethod
    def forward(ctx, x, placements, grad_placements):
        ctx.spec = (x.device_mesh, tuple(x.placements), grad_placements,
                    x.shape, x.stride())
        return x.redistribute(x.device_mesh, placements).to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh, pl, grad_pl, shape, stride = ctx.spec
        d = DTensor.from_local(g.contiguous(), mesh, grad_pl,
                               run_check=False, shape=shape, stride=stride)
        return d.redistribute(mesh, pl), None, None


def local_map(fn, mesh, args, out_placements, out_shape):
    """The plain body ``fn`` on this rank's shards: the one place where
    the models leave DTensor, for ops whose DTensor rules would refuse
    the layout (a flattened batch dim mixing two sharded dims).

    ``args``: one ``(x, placements, grad_placements)`` a positional
    argument of ``fn``; x is a tensor, a dict of them, or None. A DTensor
    x (a plain tensor counts as replicated on ``mesh``) is redistributed
    to ``placements`` and handed on as its local tensor. In backward its
    local grad, read as ``grad_placements`` (partial sums where ranks do
    different work on the same data), is reduced at once to x's own
    layout, so the op before sees its grad laid out as its output was
    (DTensor would otherwise pick a layout for a partial grad, a strided
    shard its product rules refuse). ``fn``'s local result becomes a
    DTensor of ``out_placements`` and global ``out_shape``."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor, Replicate

    def local(x, pl, grad_pl):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: local(v, pl, grad_pl) for k, v in x.items()}
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return _LocalShard.apply(x, tuple(pl), tuple(grad_pl))

    out = fn(*(local(*a) for a in args))
    # the einsums leave their outputs permuted: made contiguous
    return DTensor.from_local(out.contiguous(), mesh, out_placements,
                              run_check=False, shape=out_shape,
                              stride=make_contiguous_strides_for(out_shape))


def batch_sharded_only(x):
    """DTensor x with every shard but its batch dim's (dim 0) gathered."""
    from torch.distributed.tensor import Replicate

    pl = [p if p.is_shard(0) else Replicate() for p in x.placements]
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


class _GradLayout(torch.autograd.Function):
    """The identity on a DTensor whose backward lays its grad out as
    ``placements`` (a grad that reaches a reshape sharded on two of the
    dims it merges would become a strided shard)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def grad_layout(x, placements):
    return _GradLayout.apply(x, tuple(placements))


def _attn_chunked(cfg: ArchConfig, q, k, v, positions, scale):
    """Query-chunked causal attention: the live score block is (B, H,
    chunk, T) instead of (B, H, S, T)."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    chunk = cfg.attn_chunk
    t_idx = torch.arange(T, dtype=torch.int32, device=q.device)
    # each chunk is recomputed in backward, as the reference's
    # jax.checkpoint body: otherwise every chunk's (B,H,C,T) f32
    # probabilities would be saved
    body = remat("full", _gqa_scores_softmax_v)
    outs = []
    for lo in range(0, S, chunk):
        qc = q[:, lo:lo + chunk]
        pc = positions[:, lo:lo + chunk]
        mask = pc[:, None, None, :, None] >= t_idx[None, None, None, None, :]
        outs.append(body(qc, k, v, mask, scale))
    return torch.cat(outs, dim=1)


def attention(
    cfg: ArchConfig,
    p: Dict,
    x: torch.Tensor,                    # (B, S, D)
    positions: torch.Tensor,            # (B, S) int
    *,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attn source
    causal: bool = True,
    use_rope: bool = True,
    cache: Optional[Dict] = None,       # {"k","v": (B,T,KV,hd), "pos": int}
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The reference's attention (layers.py:132-187) -> (out, new cache).

    ``kv``: cross-attention, K/V projected from the source (B, T, D)
    tensors, no RoPE. ``causal=False``: every entry attended, no query
    chunks (the reference chunks only its causal branch). ``cache``: the
    one-token step of the hybrid's shared block: this token's K/V are
    written at ``cache["pos"]`` in place, then all T entries are read
    under ``t <= pos``; the returned cache holds the same tensors and
    ``pos + S``. Otherwise causal, query-chunked when ``cfg.attn_chunk``
    divides S and is smaller."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV

    q = (x @ p["wq"]).reshape(B, S, KV, G, hd)
    if kv is None:
        k = (x @ p["wk"]).reshape(B, S, KV, hd)
        v = (x @ p["wv"]).reshape(B, S, KV, hd)
    else:
        src_k, src_v = kv
        k = (src_k @ p["wk"]).reshape(B, src_k.shape[1], KV, hd)
        v = (src_v @ p["wv"]).reshape(B, src_v.shape[1], KV, hd)

    if use_rope and kv is None:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q.reshape(B, S, KV * G, hd), cos, sin).reshape(
            B, S, KV, G, hd)
        k = apply_rope(k, cos, sin)

    scale = _scale(hd)
    new_cache = None
    if cache is not None:
        pos = int(cache["pos"])
        ck, cv = cache["k"], cache["v"]
        T = ck.shape[1]
        if pos + S > T:
            raise ValueError(f"cache is full: pos {pos} of {T} positions")
        ck[:, pos:pos + S] = k.to(ck.dtype)
        cv[:, pos:pos + S] = v.to(cv.dtype)
        k, v = ck, cv
        new_cache = {"k": ck, "v": cv, "pos": pos + S}
        t_idx = torch.arange(T, dtype=torch.int32, device=x.device)
        mask = (t_idx <= pos)[None, None, None, None, :]
    elif causal:
        if cfg.attn_chunk and S > cfg.attn_chunk and S % cfg.attn_chunk == 0:
            out = _attn_chunked(cfg, q, k, v, positions, scale)
            return out.reshape(B, S, H * hd) @ p["wo"], None
        t_idx = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        mask = (positions[:, None, None, :, None]
                >= t_idx[None, None, None, None, :])
    else:
        mask = None
    out = _gqa_scores_softmax_v(q, k, v, mask, scale)
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache


def quantize_kv_entry(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's K or V (B, S, KV, hd) -> (int8 entries, f32 scale (B, S)):
    absmax over (KV, hd) / 127 + 1e-30, round half to even, clip to
    +-127 (reference layers.py:236-246)."""
    tf = t.to(torch.float32)
    sc = torch.amax(torch.abs(tf), dim=(2, 3)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(tf / sc[..., None, None]), -127, 127)
    return q.to(torch.int8), sc


def attention_decode_inplace(
    cfg: ArchConfig,
    p: Dict,                 # per-layer attention params (already indexed)
    x: torch.Tensor,         # (B, 1, D)
    pos: int,
    k_all: torch.Tensor,     # (L, B, T, KV, hd) — full stacked cache
    v_all: torch.Tensor,
    layer: int,
    use_rope: bool = True,
    scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # int8 cache
) -> Tuple[torch.Tensor, ...]:
    """One-token decode that writes this token's K/V into the stacked cache
    at ``pos`` in place and attends over [prefix ; current].

    The prefix is the cache's first ``pos`` entries (the reference reads
    all T and masks t >= pos at -1e30, whose probabilities are exactly 0).
    The current token enters attention as computed: unquantized in the
    int8 mode, where the prefix is dequantized (entries times their bf16
    scale, through f32) — writing the token and reading it back would
    quantize it and change the logits. Returns (out, k_all, v_all[,
    ks_all, vs_all]), the cache tensors themselves."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV

    q = (x @ p["wq"]).reshape(B, S, KV, G, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if use_rope:
        positions = torch.full((B, S), pos, dtype=torch.int32,
                               device=x.device)
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q.reshape(B, S, KV * G, hd), cos, sin).reshape(
            B, S, KV, G, hd)
        k = apply_rope(k, cos, sin)

    k_l, v_l = k_all[layer, :, :pos], v_all[layer, :, :pos]
    if scales is not None:
        ks_all, vs_all = scales
        dt = x.dtype
        k_cat = torch.cat([(k_l.float() * ks_all[layer, :, :pos, None, None]
                            .float()).to(dt), k.to(dt)], dim=1)
        v_cat = torch.cat([(v_l.float() * vs_all[layer, :, :pos, None, None]
                            .float()).to(dt), v.to(dt)], dim=1)
        k_q, k_sc = quantize_kv_entry(k)
        v_q, v_sc = quantize_kv_entry(v)
        k_all[layer, :, pos:pos + S] = k_q
        v_all[layer, :, pos:pos + S] = v_q
        ks_all[layer, :, pos:pos + S] = k_sc.to(ks_all.dtype)
        vs_all[layer, :, pos:pos + S] = v_sc.to(vs_all.dtype)
    else:
        k_cat = torch.cat([k_l, k.to(k_l.dtype)], dim=1)
        v_cat = torch.cat([v_l, v.to(v_l.dtype)], dim=1)
        k_all[layer, :, pos:pos + S] = k.to(k_all.dtype)
        v_all[layer, :, pos:pos + S] = v.to(v_all.dtype)
    out = _gqa_scores_softmax_v(q, k_cat, v_cat, None, _scale(hd))
    out = out.reshape(B, S, H * hd) @ p["wo"]
    if scales is not None:
        return out, k_all, v_all, ks_all, vs_all
    return out, k_all, v_all


def index_layer(tree, layer: int):
    """Layer ``layer`` of a stacked param pytree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: index_layer(v, layer) for k, v in tree.items()}
    return tree[layer]


def layer_params(tree, n_layers: int) -> List[Dict]:
    """Every layer of a stacked param pytree: ``n_layers`` trees of views,
    from one ``torch.unbind`` a leaf. Its backward writes each leaf's
    grad once (a stack of the layers' grads), where indexing a layer at a
    time (``index_layer``) writes a zero-filled grad the size of the
    whole leaf for every layer and sums them."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        parts = torch.unbind(node)
        if len(parts) != n_layers:
            raise ValueError(f"a stacked leaf has {len(parts)} layers, "
                             f"the config {n_layers}")
        return parts

    parts = split(tree)
    return [index_layer(parts, layer) for layer in range(n_layers)]


# ----------------------------------------------------------------- remat
# The ops whose outputs the "dots" policy keeps: the matrix products (the
# reference's dots_with_no_batch_dims_saveable keeps dot_general outputs)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(mode: str, fn: Callable) -> Callable:
    """``fn`` under the reference's remat policy ``mode``: "none" saves
    what autograd saves; "full" keeps only the inputs and recomputes the
    rest in backward; "dots" keeps the matrix products' outputs and
    recomputes the rest. Memory changes, values do not. Without autograd
    recording, ``fn`` itself."""
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {mode!r}")
    if mode == "none":
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if mode == "full":
            return ckpt.checkpoint(fn, *args, use_reentrant=False)
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    return wrapped


# ------------------------------------------------------------------- mlp
def init_mlp(cfg: ArchConfig, generator: torch.Generator,
             n_layers: Optional[int], d_ff: Optional[int] = None) -> Dict:
    """Stacked on a leading axis of ``n_layers``, or one block (None);
    hidden width ``d_ff`` (default ``cfg.d_ff``)."""
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    lead = _lead(n_layers)
    p = {
        "w_up": _normal(generator, lead + (D, Fd), 1 / math.sqrt(D), dt),
        "w_down": _normal(generator, lead + (Fd, D), 1 / math.sqrt(Fd), dt),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = _normal(generator, lead + (D, Fd), 1 / math.sqrt(D),
                              dt)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation, not erf
    return F.gelu(x, approximate="tanh")


def mlp(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp == "geglu":
        h = _gelu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp == "relu2":
        h = torch.square(torch.relu(x @ p["w_up"]))
    else:  # gelu
        h = _gelu(x @ p["w_up"])
    return h @ p["w_down"]


# ------------------------------------------------------------- embedding
def init_embed(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    p = {"tok": _normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(generator, (cfg.d_model, cfg.vocab),
                               1 / math.sqrt(cfg.d_model), dt)
    return p


def embed_tokens(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the table. ``F.embedding`` rather than indexing:
    the same rows, and its backward adds a repeated token's grads in a
    fixed order (indexing's, on the CPU, depends on the threads).

    A DTensor table sharded over its vocab rows is first gathered over
    those mesh dims (DTensor's backward of a vocab-sharded lookup fails
    in its partial-sum bookkeeping); its grad goes back to the table's
    placements through the gather's backward."""
    table = p["tok"]
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate

        mesh = table.device_mesh
        gather = [pl.is_shard(0) and mesh.size(i) > 1
                  for i, pl in enumerate(table.placements)]
        if any(gather):
            table = table.redistribute(mesh, [
                Replicate() if g else pl
                for g, pl in zip(gather, table.placements)])
    return F.embedding(tokens.long(), table)


def lm_logits(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["lm_head"]


# ------------------------------------------------------------------ loss
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy; logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _xent_sum(cfg: ArchConfig, embed_p: Dict, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    logits = lm_logits(cfg, embed_p, x).to(torch.float32)
    if is_dtensor(logits):
        return _xent_sum_sharded(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def _xent_sum_sharded(logits, labels):
    """``_xent_sum``'s sum for DTensor logits (B, chunk, V), without a
    full-vocab row on any rank. Where V is sharded, the log-sum-exp comes
    from each shard's max and sum of exponentials (``torch.logsumexp``
    would gather V). Every per-token term is laid out on its rows alone,
    and so is its grad: the scalar sum's grad arrives replicated, and
    redistributing it after its broadcast over V, one mesh dim at a time,
    made a copy of every rank's rows of the pod at full vocab (31 GiB a
    device on gemma-7b's multi-pod train cell); a term left partial over
    V would be reduce-scattered over the sequence instead, a layout the
    head's weight-grad product refuses."""
    from torch.distributed.tensor import Replicate

    mesh = logits.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in logits.placements]
    if any(p.is_shard(logits.ndim - 1) for p in logits.placements):
        m = torch.amax(logits.detach(), dim=-1, keepdim=True).redistribute(
            mesh, rows)
        s = torch.sum(torch.exp(logits - m), dim=-1).redistribute(mesh, rows)
        logz = torch.log(s) + m[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
    gold = _gold_sharded(logits, labels).redistribute(mesh, rows)
    return torch.sum(grad_layout(logz - gold, rows))


def _gold_sharded(logits, labels):
    """The label's logit of DTensor logits (B, chunk, V) whose vocab dim
    may be sharded (DTensor has no sharded ``gather``), shard by shard:
    a rank gathers the labels that fall in its vocab slice and gives 0
    for the rest, a partial sum over the mesh dims that split V. (A
    one-hot of the labels against vocab ids, DTensor's broadcast
    compare, came out at full vocab under torch 2.11: 4.9 GiB a device
    on gemma-7b's single-pod train cell.)"""
    from torch.distributed.tensor import Partial, Replicate

    mesh, d = logits.device_mesh, logits.ndim - 1
    pl = [p if p.is_shard(0) or p.is_shard(d) else Replicate()
          for p in logits.placements]
    lo, n = 0, logits.shape[d]       # this rank's vocab slice, as chunked
    for i, p in enumerate(pl):
        if p.is_shard(d):
            size = -(-n // mesh.size(i))
            r = mesh.get_local_rank(i)
            lo, n = lo + r * size, max(0, min(size, n - r * size))

    def body(lg, lab):
        idx = lab.long() - lo
        mine = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, max(lg.shape[-1] - 1, 0))
                         [..., None])[..., 0]
        return torch.where(mine, g, torch.zeros_like(g))

    rows = [p if p.is_shard(0) else Replicate() for p in pl]
    out = [Partial() if p.is_shard(d) else q for p, q in zip(pl, rows)]
    return local_map(body, mesh, [(logits, pl, pl), (labels, rows, rows)],
                     out, logits.shape[:-1])


def chunked_xent(cfg: ArchConfig, embed_p: Dict, x: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy with the LM head folded in, chunked over the sequence
    in ``cfg.loss_chunk`` positions (the whole sequence when that does not
    divide it): the live logits are (B, chunk, V), never (B, S, V), and
    each chunk's are recomputed in backward rather than saved. The chunk
    sums add up in float32, in order; the mean is over B * S."""
    B, S, _ = x.shape
    chunk = min(cfg.loss_chunk, S)
    if S % chunk != 0:
        chunk = S
    if is_dtensor(x):
        # the head's product flattens (B, chunk): a sequence-sharded x is
        # gathered first, as Megatron-SP gathers before the head
        x = batch_sharded_only(x)
    body = remat("full", functools.partial(_xent_sum, cfg))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, chunk):
        total = total + body(embed_p, x[:, lo:lo + chunk],
                             labels[:, lo:lo + chunk])
    return total / (B * S)


# --------------------------------------------------- activation sharding
def _act_spec(cfg: ArchConfig, seq_axis):
    dp = cfg.act_dp_axes
    bdim = dp if len(dp) > 1 else dp[0]
    return (bdim, seq_axis, None)


def _constrain(x, spec):
    from repro_torch.parallel.sharding import placements

    pl = placements(x.device_mesh, spec)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def act_constraint(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Residual-stream sharding between blocks (cfg.act_shard), for a
    DTensor x; a plain tensor passes through. The models also pin each
    branch's output before adding it to the residual: its redistribute's
    backward then gathers the sequence of the branch's grad, where an
    add's own resharding would hand the branch's weight-grad product a
    grad sharded on batch and sequence at once, which DTensor's product
    rules refuse.

    "seq":   batch -> act_dp_axes, sequence -> "model" (Megatron-style
             sequence parallelism; the >=7B archs).
    "batch": batch -> act_dp_axes (re-pins pure-DP sharding; the
             dp-profile archs with all-axis DP)."""
    if x.ndim != 3 or cfg.act_shard == "none" or not is_dtensor(x):
        return x
    if cfg.act_shard == "seq":
        return _constrain(x, _act_spec(cfg, "model"))
    if cfg.act_shard == "batch":
        return _constrain(x, _act_spec(cfg, None))
    return x


def act_entry(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Megatron-SP entry: all-gather the sequence dim at the attention/MLP
    input, for a DTensor x under ``act_shard == "seq"``; a plain tensor
    passes through."""
    if x.ndim != 3 or cfg.act_shard != "seq" or not is_dtensor(x):
        return x
    return _constrain(x, _act_spec(cfg, None))
