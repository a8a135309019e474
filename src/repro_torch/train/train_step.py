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

On a sharded plan the params, optimizer state and batch are DTensors
(``parallel/sharding``; the step runs under DTensor's implicit
replication, so a plain tensor made inside the model counts as
replicated). A microbatch is each rank's own slice of its local batch
rows: the same rows in another grouping than the plain split, so the
summed grads agree up to float order. ``grad_specs`` (a tree of
``NamedSharding``s or of specs, on the params' mesh) redistributes the
grads and the microbatch accumulator to the ZeRO-2 placements: the
partial grads are reduce-scattered. ``compress_pod=(mesh,
batch_spec_tree)`` reduces the grads over the mesh's "pod" dim in int8
(``parallel/compression.make_compressed_value_and_grad``).

``make_serve_step`` builds the one-token decode step and
``make_prefill_step`` the full-sequence loss, in waves of
``cfg.prefill_microbatches``.
"""
from __future__ import annotations

import contextlib
import functools
import gc
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.parallel.sharding import is_dtensor
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

PyTree = Any


def _split_microbatches(batch: Dict, n_mb: int) -> Dict:
    """Every leaf (B, ...) -> (n_mb, B/n_mb, ...); a DTensor leaf splits
    its local rows (rank r's microbatch i is its i-th local slice)."""
    def resh(x):
        local = x.to_local() if is_dtensor(x) else x
        if x.shape[0] % n_mb or local.shape[0] % n_mb:
            raise ValueError(f"batch {tuple(x.shape)} does not split into "
                             f"{n_mb} microbatches")
        if not is_dtensor(x):
            return x.reshape((n_mb, x.shape[0] // n_mb)
                             + tuple(x.shape[1:]))
        from torch.distributed.tensor import DTensor

        parts = local.reshape((n_mb, local.shape[0] // n_mb)
                              + tuple(local.shape[1:]))
        shape = (x.shape[0] // n_mb,) + tuple(x.shape[1:])
        return [DTensor.from_local(parts[i], x.device_mesh, x.placements,
                                   run_check=False, shape=shape,
                                   stride=parts[i].stride())
                for i in range(n_mb)]

    return T.map_leaves(resh, batch)


def sharded_context(tree):
    """DTensor's implicit replication when ``tree`` holds DTensor leaves
    (plain tensors made inside the step then count as replicated)."""
    if any(is_dtensor(x) for x in T.leaves(tree)):
        from torch.distributed.tensor.experimental import (
            implicit_replication)

        return implicit_replication()
    return contextlib.nullcontext()


def _place(g, sharding, p):
    """Grad ``g`` redistributed to ``sharding`` (a NamedSharding or a spec
    on p's mesh); a plain grad stays as it is (one device)."""
    if not is_dtensor(g):
        return g
    from repro_torch.parallel.sharding import NamedSharding, placements

    if isinstance(sharding, NamedSharding):
        mesh, pl = sharding.mesh, sharding.placements
    else:
        mesh = p.device_mesh
        pl = placements(mesh, sharding)
    if tuple(g.placements) == tuple(pl) and g.device_mesh == mesh:
        return g
    return g.redistribute(mesh, pl)


def _spec_tree(grad_specs):
    from repro_torch.parallel.sharding import NamedSharding

    return T.map_leaves(
        lambda s: s.spec if isinstance(s, NamedSharding) else s, grad_specs)


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
        if any(is_dtensor(x) for x in leaves):
            # DTensor's backward leaves reference cycles that hold
            # param-sized grads until the cycle collector runs: two
            # copies of the tied table at gemma-7b's width (6 GB a rank)
            gc.collect()
        return value.detach(), T.unflatten(keys, grads)
    return vag


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    grad_specs=None, compress_pod=None,
                    donate: bool = False):
    _, opt_update = make_optimizer(opt_cfg)
    loss_fn = make_loss_fn(cfg)
    vag = value_and_grad(loss_fn)
    if compress_pod is not None:
        # the pods' partial grads cross the pod link in int8
        from repro_torch.parallel.compression import (
            make_compressed_value_and_grad)

        mesh, batch_spec_tree = compress_pod
        vag = make_compressed_value_and_grad(
            loss_fn, mesh, batch_spec_tree,
            grad_specs=None if grad_specs is None else _spec_tree(grad_specs))
    n_mb = max(cfg.num_microbatches, 1)
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def constrain(tree, params):
        if grad_specs is None:
            return tree
        return T.map_leaves(_place, tree, grad_specs, params)

    def train_step(params, opt_state, batch):
        with sharded_context(params):
            if n_mb == 1:
                loss, grads = vag(params, batch)
                grads = constrain(grads, params)
            else:
                mbs = _split_microbatches(batch, n_mb)
                dev = T.leaves(params)[0].device
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = constrain(T.map_leaves(
                    lambda p: torch.zeros_like(
                        p, dtype=acc_dt, memory_format=torch.contiguous_format),
                    params), params)
                for i in range(n_mb):
                    l, g = vag(params, T.map_leaves(lambda x: x[i], mbs))
                    g = constrain(T.map_leaves(lambda b: b.to(acc_dt), g),
                                  params)
                    grads = constrain(T.map_leaves(lambda a, b: a + b,
                                                   grads, g), params)
                    loss = loss + l
                loss = loss / n_mb
                grads = T.map_leaves(lambda g: g / n_mb, grads)

            new_params, new_opt, om = opt_update(grads, opt_state, params,
                                                 donate=donate)
        if is_dtensor(loss):
            loss = loss.full_tensor()
        return new_params, new_opt, {"loss": loss.to(torch.float32), **om}

    return train_step


def make_opt_init(cfg: ArchConfig, opt_cfg: OptimizerConfig):
    opt_init, _ = make_optimizer(opt_cfg)
    return opt_init


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens):
        with sharded_context(params):
            return registry.decode_step(cfg, params, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """Full-sequence forward returning the loss (a float32 scalar), in
    ``cfg.prefill_microbatches`` sequential waves of the batch."""
    loss_fn = make_loss_fn(cfg)
    n_mb = max(cfg.prefill_microbatches, 1)

    @torch.no_grad()
    def prefill_step(params, batch):
        with sharded_context(params):
            if n_mb == 1:
                return loss_fn(params, batch)
            mbs = _split_microbatches(batch, n_mb)
            total = torch.zeros((), dtype=torch.float32,
                                device=T.leaves(params)[0].device)
            for i in range(n_mb):
                total = total + loss_fn(params,
                                        T.map_leaves(lambda x: x[i], mbs))
            return total / n_mb

    return prefill_step


def default_opt_config(cfg: ArchConfig, total_steps: int = 10_000
                       ) -> OptimizerConfig:
    return OptimizerConfig(
        name=cfg.optimizer,
        lr=3e-4 if cfg.param_count() < 20e9 else 1e-4,
        total_steps=total_steps,
    )
