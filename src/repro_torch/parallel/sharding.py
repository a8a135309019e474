"""Sharding rules: param/optimizer/cache/batch partition specs per arch (the
port of the JAX package's parallel/sharding.py, rule for rule).

Profiles (chosen per arch by size):

  * "tp"       (7B-16B dense/MoE): tensor parallel over "model"; params
                replicated over "data"; batch/activations over ("pod","data").
  * "tp_fsdp"  (>=70B): TP over "model" + ZeRO-3/FSDP over "data": every
                matrix sharded on two axes; optimizer state inherits the
                same specs (sharded optimizer = ZeRO).
  * "dp"       (<3B: mamba2, zamba2, whisper): params replicated; pure data
                parallel.

MoE experts shard over "model" (expert parallelism); the "pod" axis is
pure DP (the gradient all-reduce that crosses pods is where
parallel/compression.py's int8 reduction lands).

KV caches shard batch->("pod","data") and heads->"model" when divisible,
falling back to head_dim->"model" (GQA with few KV heads), else replicated.

A spec is the port's ``PartitionSpec``: a tuple with one entry a tensor
dim, each an axis name, a tuple of axis names or None (``P(...)`` builds
one; JAX's ``PartitionSpec`` turned into a tuple is the same thing). The
rules take any mesh with ``.shape`` ({axis: size}) and ``.axis_names``,
or a ``torch.distributed`` ``DeviceMesh``. ``placements(mesh, spec)``
turns a spec into DTensor placements: a mesh dim that shards tensor dim d
is ``Shard(d)``, any other ``Replicate()``; a tensor dim that takes a
tuple of axes is sharded on each of them, in the tuple's order, which
must be the mesh's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.train import tree as T

PyTree = Any
Spec = Tuple


def P(*parts) -> Spec:
    """A partition spec: one entry a tensor dim."""
    return tuple(parts)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a fake mesh or a ``DeviceMesh``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():   # the mesh's rank tensor is real
            return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def profile_of(cfg: ArchConfig) -> str:
    if cfg.pure_fsdp:
        return "fsdp_pure"
    n = cfg.param_count()
    if n < 3e9:
        return "dp"
    return "tp_fsdp" if cfg.fsdp else "tp"


def dp_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _model_dim(mesh) -> int:
    return axis_sizes(mesh)["model"]


def spec_for_param(cfg: ArchConfig, mesh, path: str, shape) -> Spec:
    """The spec of one parameter leaf (path is '/'-joined)."""
    ndim = len(shape)
    prof = profile_of(cfg)
    if prof == "dp":
        return P()
    if prof == "fsdp_pure":
        # ZeRO-3: shard the largest divisible dim over every mesh axis
        names = axis_names(mesh)
        axes = tuple(a for a in ("pod", "data", "model") if a in names)
        n = _prod(mesh, axes)
        for d in range(ndim - 1, -1, -1):
            if shape[d] % n == 0 and shape[d] >= n:
                parts = [None] * ndim
                parts[d] = axes
                return P(*parts)
        return P()
    fsdp = "data" if prof == "tp_fsdp" else None

    def last_two(a, b):
        # stacked leaves carry a leading layer axis -> None-pad on the left
        return P(*([None] * (ndim - 2) + [a, b]))

    if "embed/tok" in path:
        return P("model", fsdp)
    if "lm_head" in path:
        return P(fsdp, "model")
    # MoE experts: (L, E, D, F) / (L, E, F, D). Expert-parallel over
    # "model" when E divides; few-big-expert models fall back to
    # intra-expert TP on the FFN dim.
    if "moe/w_up" in path or "moe/w_gate" in path:
        if shape[1] % _model_dim(mesh) == 0:
            return P(None, "model", fsdp, None)
        return P(None, None, fsdp, "model")
    if "moe/w_down" in path:
        if shape[1] % _model_dim(mesh) == 0:
            return P(None, "model", None, fsdp)
        return P(None, None, "model", fsdp)
    if "moe/router" in path:
        return P(None, fsdp, None)
    if "moe/shared" in path:
        if "w_down" in path:
            return last_two("model", fsdp)
        return last_two(fsdp, "model")
    # attention / dense MLP
    if any(k in path for k in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj")):
        return last_two(fsdp, "model")
    if any(k in path for k in ("wo", "w_down", "out_proj")):
        return last_two("model", fsdp)
    # SSM small tensors, norms, biases, scalars
    return P(*([None] * ndim))


def _map_with_path(fn, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over a dict tree's leaves."""
    keys, values = zip(*((k, fn(k, v)) for k, v in T.items(tree)))
    return T.unflatten(keys, values)


def param_specs(cfg: ArchConfig, mesh, params_shape: PyTree) -> PyTree:
    return _map_with_path(
        lambda path, leaf: spec_for_param(cfg, mesh, path, leaf.shape),
        params_shape)


def _zero1_spec(mesh, spec: Spec, shape) -> Spec:
    """ZeRO-1: shard a moment leaf over every mesh axis the param spec
    leaves unused, picking divisible dims (moments are elementwise state,
    so any sharding is valid)."""
    used = set()
    for s in spec:
        if isinstance(s, (tuple, list)):
            used.update(s)
        elif s is not None:
            used.add(s)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    for axis in ("data", "model", "pod"):
        if axis not in names or axis in used:
            continue
        n = sizes[axis]
        for d in range(len(shape) - 1, -1, -1):
            if parts[d] is None and shape[d] % n == 0 and shape[d] >= n:
                parts[d] = axis
                used.add(axis)
                break
    return P(*parts)


def grad_specs(cfg: ArchConfig, mesh, params_shape: PyTree) -> PyTree:
    """ZeRO-2 gradient sharding: gradients (and the microbatch accumulator)
    shard over every mesh axis the parameter leaves idle, so the grad
    all-reduce becomes a reduce-scatter (and an all-gather folded into the
    optimizer's param update)."""
    return _map_with_path(
        lambda path, leaf: _zero1_spec(
            mesh, spec_for_param(cfg, mesh, path, leaf.shape), leaf.shape),
        params_shape)


def opt_state_specs(cfg: ArchConfig, mesh, opt_shape: PyTree,
                    pspecs: PyTree) -> PyTree:
    """Optimizer-state specs derived from parameter specs.

    adamw:     {"m": ZeRO-1(params), "v": ZeRO-1(params), "step": P()}
    adafactor: {"v": {leafwise {"vr": spec[:-1], "vc": spec[:-2]+[-1]}
                or {"v": spec}}, "step": P()}
    """
    if "m" in opt_shape:  # adamw
        mspecs = _map_with_path(
            lambda path, leaf: _zero1_spec(
                mesh, spec_for_param(cfg, mesh, path, leaf.shape),
                leaf.shape),
            opt_shape["m"])
        return {"m": mspecs, "v": mspecs, "step": P()}

    def fac(spec, leaf):
        parts = list(spec)
        if isinstance(leaf, dict) and "vr" in leaf:
            nd_r = len(leaf["vr"].shape)
            nd_c = len(leaf["vc"].shape)
            parts_full = parts + [None] * (nd_r + 1 - len(parts))
            return {
                "vr": P(*parts_full[:nd_r]),
                "vc": P(*(parts_full[: nd_c - 1]
                          + parts_full[nd_r:nd_r + 1])),
            }
        return {"v": P(*parts) if parts else P()}

    # walk the opt "v" tree in step with the param specs
    return {"v": T.map_leaves(fac, pspecs, opt_shape["v"]), "step": P()}


def _prod(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def batch_dim(cfg: ArchConfig, mesh, global_batch: int):
    """Mesh axes carrying the batch dim.

    dp-profile archs (params replicated) are data-parallel over every axis
    when divisible; TP profiles keep "model" for weights and use
    ("pod","data")."""
    cands = []
    names = axis_names(mesh)
    all_axes = tuple(a for a in ("pod", "data", "model") if a in names)
    if profile_of(cfg) in ("dp", "fsdp_pure"):
        cands.append(all_axes)
    cands.append(dp_axes(mesh))
    cands.append(("data",))
    for c in cands:
        if global_batch % max(_prod(mesh, c), 1) == 0:
            return c if len(c) > 1 else c[0]
    return None


def batch_specs(cfg: ArchConfig, mesh, shape: ShapeSpec) -> PyTree:
    """Input batch specs."""
    bdim = batch_dim(cfg, mesh, shape.global_batch)
    if cfg.family == "vlm" or cfg.embeds_in:
        return {"embeds": P(bdim, None, None), "labels": P(bdim, None)}
    if cfg.family == "encdec":
        return {
            "enc_embeds": P(bdim, None, None),
            "tokens": P(bdim, None),
            "labels": P(bdim, None),
        }
    return {"tokens": P(bdim, None), "labels": P(bdim, None)}


def _uses_model(bdim) -> bool:
    if bdim is None:
        return False
    if isinstance(bdim, str):
        return bdim == "model"
    return "model" in bdim


def _kv_spec(cfg: ArchConfig, mesh, bdim) -> Spec:
    """(n_stack, B, T, KV, hd) cache spec."""
    m = _model_dim(mesh)
    if _uses_model(bdim):  # all-axis DP already consumes "model"
        return P(None, bdim, None, None, None)
    if cfg.n_kv_heads % m == 0:
        return P(None, bdim, None, "model", None)
    if cfg.resolved_head_dim() % m == 0:
        return P(None, bdim, None, None, "model")
    return P(None, bdim, None, None, None)


def cache_specs(cfg: ArchConfig, mesh, shape: ShapeSpec,
                cache_shape: PyTree) -> PyTree:
    """Specs of a decode cache's leaves (its Python-int ``pos``: P())."""
    bdim = batch_dim(cfg, mesh, shape.global_batch)
    kv = _kv_spec(cfg, mesh, bdim)
    m = _model_dim(mesh)

    def f(p, leaf):
        nd = len(getattr(leaf, "shape", ()))
        if p in ("k", "v", "cross_k", "cross_v"):
            return kv
        if p in ("k_scale", "v_scale"):  # (L, B, T)
            return P(None, bdim, None)
        if p == "ssm":  # (L, B, H, P, N)
            d_in_heads = leaf.shape[2]
            if not _uses_model(bdim) and d_in_heads % m == 0:
                return P(None, bdim, "model", None, None)
            return P(None, bdim, None, None, None)
        if p == "conv":  # (L, B, K-1, C)
            return P(None, bdim, None, None)
        return P(*([None] * nd))

    return _map_with_path(f, cache_shape)


def decode_tokens_spec(cfg: ArchConfig, mesh, shape: ShapeSpec) -> Spec:
    bdim = batch_dim(cfg, mesh, shape.global_batch)
    if cfg.family == "vlm" or cfg.embeds_in:
        return P(bdim, None, None)
    return P(bdim, None)


# ------------------------------------------------------- DTensor placement
def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    each mesh dim that shards tensor dim d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec!r} shards dim {d} over {axes}, "
                             f"out of the mesh's order {names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def named(mesh, spec_tree: PyTree) -> PyTree:
    """Every spec of a tree as a ``NamedSharding`` on ``mesh``."""
    return T.map_leaves(lambda s: NamedSharding(mesh, s), spec_tree)


def distribute(x, sharding: NamedSharding, src_data_rank: Optional[int] = 0):
    """The full tensor ``x`` (the same on every rank) placed as a DTensor
    under ``sharding``; a DTensor leaf is redistributed on its mesh."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        if x.device_mesh == sharding.mesh:
            return x.redistribute(sharding.mesh, sharding.placements)
        x = x.full_tensor()
    d = distribute_tensor(x, sharding.mesh, sharding.placements,
                          src_data_rank=src_data_rank)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # a shard sliced out of x holds all of x's storage: own a copy
        d = DTensor.from_local(local.clone(), sharding.mesh,
                               sharding.placements, run_check=False,
                               shape=d.shape, stride=d.stride())
    return d
