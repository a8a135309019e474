"""Optimizers from scratch: AdamW and Adafactor (the port of the JAX
package's train/optimizer.py).

Both are (init, update) pairs over the port's param pytrees (nested dicts
of tensors, ``train/tree.py``), with global-norm clipping and a
linear-warmup cosine schedule. The state trees keep the reference's keys
and dtypes: AdamW {"m", "v", "step"} (moments in ``moment_dtype``, the
step an int32 scalar), Adafactor {"v": {"vr", "vc"} | {"v"} a leaf,
"step"} (float32), so a state converts leaf for leaf between the two
packages (``convert.opt_state_from_numpy``, the checkpoints).

The arithmetic is the reference's, in its order and dtypes: the gradient
is clipped as ``(g.f32 * scale).to(g.dtype)``, the schedule is read at
the incremented step, ``b ** t`` and ``t ** -0.8`` are float32, weight
decay goes on every leaf with ``ndim >= 2`` (in the stacked layout that
includes the (n_layers, D) norm scales), and Adafactor updates a stacked
factored leaf (``ndim >= 3``, more than one layer) one layer at a time,
so its RMS clip and ``vr / mean(vr)`` are per layer, as the reference's
``lax.map``. The reported ``grad_norm`` is the norm before clipping.

Memory: the clip is folded into each leaf's update instead of making a
clipped copy of the grads, and AdamW walks each leaf in slices of
``_SLICE`` elements (its arithmetic is elementwise, so the values are the
whole leaf's), so the float32 transients stay a slice in size.
``update(..., donate=True)`` writes the new params and moments into the
old tensors and returns them, the port's form of the reference driver's
``jax.jit(donate_argnums=(0, 1))``; by default the inputs are left as
they are.

DTensor leaves (a sharded plan): the global norm reduces each leaf's sum
of squares across the mesh. AdamW updates a leaf in its moments'
(ZeRO-1) placements: the grad is redistributed there (a reduce-scatter
of partial grads), the param sliced there, the 64 MB slices walk the
local shards, and the new param is all-gathered back to its own
placements (written into the old local tensors with ``donate=True``).
Adafactor runs its ops on the DTensors as they are (DTensor inserts the
collectives) and returns new tensors, donated or not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.parallel.sharding import is_dtensor
from repro_torch.train import tree as T

PyTree = Any
# elements of a leaf that one AdamW slice updates (64 MB of float32)
_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.999            # adafactor uses a step-dependent decay
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a scalar tensor), float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _full(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if is_dtensor(x) else x


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in sorted key order) of each leaf's
    sum of squares, accumulated in float64 and returned as float32. A
    DTensor leaf's sum is its shards' partial sums reduced over the mesh:
    in float64 the order of that reduction does not reach the float32
    result, so a sharded step clips by the norm one device computes (the
    int8 pod reduction would turn a clip one ulp off into whole quanta)."""
    sums = [_full(torch.sum(torch.square(x.to(torch.float32)),
                            dtype=torch.float64))
            for x in T.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums))).to(torch.float32)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The clipped gradient in float32: (g.f32 * scale) rounded to g's
    dtype, as the reference's clipped tree holds it."""
    return (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)


def clip_by_global_norm(tree: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """(the tree scaled down to ``max_norm`` if its global norm exceeds it,
    in each leaf's dtype; the norm before clipping)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return T.map_leaves(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                        tree), norm


def _out(x: torch.Tensor, donate: bool) -> torch.Tensor:
    """Where an update of ``x`` goes: ``x`` itself when donated."""
    return x if donate else torch.empty_like(x)


# ------------------------------------------------------------------ AdamW
def adamw_init(cfg: OptimizerConfig, params: PyTree) -> Dict:
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=mdt,
                                       memory_format=torch.contiguous_format)
    dev = T.leaves(params)[0].device
    return {"m": T.map_leaves(zeros, params),
            "v": T.map_leaves(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: PyTree, state: Dict,
                 params: PyTree, donate: bool = False):
    """-> (new params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)

    def slices(p, g, m, v, out_p, out_m, out_v, decay):
        pf, gf, mf, vf = (x.view(-1) for x in (p, g, m, v))
        op, om, ov = (x.view(-1) for x in (out_p, out_m, out_v))
        for lo in range(0, max(pf.numel(), 1), _SLICE):
            s = slice(lo, lo + _SLICE)
            g32 = _clipped(gf[s], scale)
            m32 = mf[s].to(torch.float32) * b1 + (1 - b1) * g32
            v32 = vf[s].to(torch.float32) * b2 + (1 - b2) * g32 * g32
            update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if decay:
                update = update + cfg.weight_decay * pf[s].to(torch.float32)
            op[s] = (pf[s].to(torch.float32) - lr * update).to(p.dtype)
            om[s] = m32.to(m.dtype)
            ov[s] = v32.to(v.dtype)

    def upd(p, g, m, v):
        decay = p.ndim >= 2     # decoupled weight decay on matrices only
        if is_dtensor(p):
            return _adamw_sharded(p, g, m, v, decay, slices, donate)
        out_p, out_m, out_v = (_out(x, donate) for x in (p, m, v))
        slices(p, g, m, v, out_p, out_m, out_v, decay)
        return out_p, out_m, out_v

    out = T.map_leaves(upd, params, grads, state["m"], state["v"])
    pick = lambda i: T.map_leaves(lambda o: o[i], out)
    step_out = state["step"].copy_(step) if donate else step
    return pick(0), {"m": pick(1), "v": pick(2), "step": step_out}, {
        "grad_norm": gnorm, "lr": lr}


def _adamw_sharded(p, g, m, v, decay, slices, donate):
    """One DTensor leaf of AdamW in the moments' placements: ``slices``
    walks the local shards, the new param goes back to p's placements."""
    from torch.distributed.tensor import DTensor

    mesh, pl = m.device_mesh, tuple(m.placements)
    g = g if tuple(g.placements) == pl else g.redistribute(mesh, pl)
    p_sh = p if tuple(p.placements) == pl else p.redistribute(mesh, pl)
    # a slice of a replicated param, or a reduce-scattered grad, may be a
    # strided view: the slices walk contiguous shards
    pl_l, gl = p_sh.to_local().contiguous(), g.to_local().contiguous()
    ml, vl = m.to_local(), v.to_local()
    out_p = torch.empty_like(pl_l)
    out_m, out_v = (_out(x, donate) for x in (ml, vl))
    slices(pl_l, gl, ml, vl, out_p, out_m, out_v, decay)
    new_p = DTensor.from_local(out_p, mesh, pl, run_check=False,
                               shape=p.shape, stride=p.stride())
    if tuple(p.placements) != pl:
        new_p = new_p.redistribute(mesh, p.placements)
    wrap = lambda x, ref: DTensor.from_local(
        x, mesh, pl, run_check=False, shape=ref.shape, stride=ref.stride())
    if donate:
        p.to_local().copy_(new_p.to_local())
        return p, m, v
    return new_p, wrap(out_m, m), wrap(out_v, v)


# -------------------------------------------------------------- Adafactor
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(cfg: OptimizerConfig, params: PyTree) -> Dict:
    def make(p):
        if is_dtensor(p):
            # a DTensor leaf's stats take the layout of its row/column sums
            z = torch.zeros_like(p, dtype=torch.float32)
            if _factored(p.shape):
                return {"vr": z.sum(dim=-1), "vc": z.sum(dim=-2)}
            return {"v": z}
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **f32),      # row stats
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    dev = T.leaves(params)[0].device
    return {"v": T.map_leaves(make, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _adafactor_one(cfg: OptimizerConfig, p, g, v, scale, lr, beta2t):
    """One (leaf or layer) update -> (new p in p's dtype, new v)."""
    gf = _clipped(g, scale)
    g2 = gf * gf + 1e-30
    if _factored(p.shape):
        vr = v["vr"] * beta2t + torch.mean(g2, dim=-1) * (1 - beta2t)
        vc = v["vc"] * beta2t + torch.mean(g2, dim=-2) * (1 - beta2t)
        rfac = vr / torch.mean(vr, dim=-1, keepdim=True)
        denom = torch.sqrt(rfac[..., None] * vc[..., None, :])
        update = gf / (denom + cfg.eps)
        newv = {"vr": vr, "vc": vc}
    else:
        vv = v["v"] * beta2t + g2 * (1 - beta2t)
        update = gf / (torch.sqrt(vv) + cfg.eps)
        newv = {"v": vv}
    # relative step-size clipping (RMS-based, as in the paper)
    rms = torch.sqrt(torch.mean(update * update) + 1e-30)
    update = update / torch.clamp(rms, min=1.0)
    if p.ndim >= 2:
        update = update + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * update).to(p.dtype), newv


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads: PyTree, state: Dict,
                     params: PyTree, donate: bool = False):
    """-> (new params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    lr = schedule(cfg, step)
    t = step.to(torch.float32)
    beta2t = 1.0 - t ** (-0.8)  # Adafactor's step-dependent decay

    def upd(p, g, v):
        if is_dtensor(p) and p.ndim >= 3 and _factored(p.shape) \
                and p.shape[0] > 1:
            # a stacked DTensor leaf: the layers' results stacked
            outs = [_adafactor_one(cfg, p[i], g[i],
                                   {k: x[i] for k, x in v.items()}, scale,
                                   lr, beta2t) for i in range(p.shape[0])]
            return (torch.stack([o[0] for o in outs]),
                    {k: torch.stack([o[1][k] for o in outs]) for k in v})
        if is_dtensor(p):
            return _adafactor_one(cfg, p, g, v, scale, lr, beta2t)
        if p.ndim >= 3 and _factored(p.shape) and p.shape[0] > 1:
            # a stacked leaf: one layer at a time (per-layer RMS clip and
            # row factor, and layer-sized float32 transients)
            out_p = _out(p, donate)
            out_v = {k: _out(x, donate) for k, x in v.items()}
            for i in range(p.shape[0]):
                newp, newv = _adafactor_one(
                    cfg, p[i], g[i], {k: x[i] for k, x in v.items()}, scale,
                    lr, beta2t)
                out_p[i] = newp
                for k, x in newv.items():
                    out_v[k][i] = x
            return out_p, out_v
        newp, newv = _adafactor_one(cfg, p, g, v, scale, lr, beta2t)
        if not donate:
            return newp, newv
        p.copy_(newp)
        for k, x in newv.items():
            v[k].copy_(x)
        return p, v

    out = T.map_leaves(upd, params, grads, state["v"])
    pick = lambda i: T.map_leaves(lambda o: o[i], out)
    step_out = state["step"].copy_(step) if donate else step
    return pick(0), {"v": pick(1), "step": step_out}, {
        "grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------------------- facade
def make_optimizer(cfg: OptimizerConfig):
    """(init(params) -> state, update(grads, state, params, donate=False)
    -> (params, state, metrics))."""
    if cfg.name == "adamw":
        return (lambda p: adamw_init(cfg, p),
                lambda g, s, p, donate=False: adamw_update(cfg, g, s, p,
                                                           donate))
    if cfg.name == "adafactor":
        return (lambda p: adafactor_init(cfg, p),
                lambda g, s, p, donate=False: adafactor_update(cfg, g, s, p,
                                                               donate))
    raise ValueError(f"unknown optimizer {cfg.name!r}")
