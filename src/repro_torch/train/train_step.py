"""Generic train/serve steps: microbatched grad accumulation + optimizer
(the port of the JAX package's train/train_step.py).

``make_train_step`` builds

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

with ``metrics`` = {"loss", "grad_norm", "lr"}. The grads are
``torch.autograd.grad`` of the family's loss over the leaves of the param
pytree (plain tensors, as ``init`` or ``convert`` make them;
``value_and_grad`` is the port's ``jax.value_and_grad``). It records
autograd whatever the caller's mode, so a serving path's
``torch.no_grad`` does not reach it.

Microbatching (cfg.num_microbatches > 1) splits the batch leaf-wise into
``n_mb`` consecutive slices of B/n_mb and accumulates the grads in
``cfg.grad_accum_dtype``; the loss sum and the grads are each divided by
``n_mb``, as the reference's ``lax.scan`` does. ``donate=True`` updates
the params and the optimizer state in place (the reference driver's
``donate_argnums``).

``grad_specs`` and ``compress_pod`` (sharded grad accumulators, the
int8-compressed cross-pod all-reduce) need a device mesh: they raise
``NotPortedError`` (ROADMAP A.18).

``make_serve_step`` builds the one-token decode step and
``make_prefill_step`` the full-sequence loss, in waves of
``cfg.prefill_microbatches``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import NotPortedError
from repro_torch.models import registry
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

PyTree = Any


def _split_microbatches(batch: Dict, n_mb: int) -> Dict:
    """Every leaf (B, ...) -> (n_mb, B/n_mb, ...)."""
    def resh(x):
        if x.shape[0] % n_mb:
            raise ValueError(f"batch {tuple(x.shape)} does not split into "
                             f"{n_mb} microbatches")
        return x.reshape((n_mb, x.shape[0] // n_mb) + tuple(x.shape[1:]))

    return T.map_leaves(resh, batch)


def make_loss_fn(cfg: ArchConfig) -> Callable:
    return functools.partial(registry.loss_fn, cfg)


def value_and_grad(fn: Callable) -> Callable:
    """``vag(params, *args) -> (fn(params, *args) detached, grads)``: the
    grad of every leaf of the param pytree, a zero tensor for a leaf the
    value does not use (as JAX gives)."""
    def vag(params: PyTree, *args):
        keys, leaves = zip(*T.items(params))
        req = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            value = fn(T.unflatten(keys, req), *args)
            grads = torch.autograd.grad(value, req, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(req, grads)]
        return value.detach(), T.unflatten(keys, grads)
    return vag


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    grad_specs=None, compress_pod=None,
                    donate: bool = False):
    if grad_specs is not None or compress_pod is not None:
        raise NotPortedError("grad_specs and compress_pod shard the grads "
                             "over a device mesh: ROADMAP A.18")
    _, opt_update = make_optimizer(opt_cfg)
    vag = value_and_grad(make_loss_fn(cfg))
    n_mb = max(cfg.num_microbatches, 1)
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        if n_mb == 1:
            loss, grads = vag(params, batch)
        else:
            mbs = _split_microbatches(batch, n_mb)
            dev = T.leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = T.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=acc_dt, device=dev),
                params)
            for i in range(n_mb):
                l, g = vag(params, T.map_leaves(lambda x: x[i], mbs))
                grads = T.map_leaves(lambda a, b: a + b.to(acc_dt), grads, g)
                loss = loss + l
            loss = loss / n_mb
            grads = T.map_leaves(lambda g: g / n_mb, grads)

        new_params, new_opt, om = opt_update(grads, opt_state, params,
                                             donate=donate)
        return new_params, new_opt, {"loss": loss.to(torch.float32), **om}

    return train_step


def make_opt_init(cfg: ArchConfig, opt_cfg: OptimizerConfig):
    opt_init, _ = make_optimizer(opt_cfg)
    return opt_init


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens):
        return registry.decode_step(cfg, params, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """Full-sequence forward returning the loss (a float32 scalar), in
    ``cfg.prefill_microbatches`` sequential waves of the batch."""
    loss_fn = make_loss_fn(cfg)
    n_mb = max(cfg.prefill_microbatches, 1)

    @torch.no_grad()
    def prefill_step(params, batch):
        if n_mb == 1:
            return loss_fn(params, batch)
        mbs = _split_microbatches(batch, n_mb)
        total = torch.zeros((), dtype=torch.float32,
                            device=T.leaves(params)[0].device)
        for i in range(n_mb):
            total = total + loss_fn(params, T.map_leaves(lambda x: x[i], mbs))
        return total / n_mb

    return prefill_step


def default_opt_config(cfg: ArchConfig, total_steps: int = 10_000
                       ) -> OptimizerConfig:
    return OptimizerConfig(
        name=cfg.optimizer,
        lr=3e-4 if cfg.param_count() < 20e9 else 1e-4,
        total_steps=total_steps,
    )
