"""Multi-pod dry-run: one step of every (arch x shape x mesh) cell on a
fake world (the port of the JAX package's launch/dryrun.py).

For each cell this driver
  1. builds the step (train_step with its optimizer for train_4k, the
     forward loss for prefill_32k, serve_step for decode_32k /
     long_500k),
  2. places the params, optimizer state, batch and cache as DTensors by
     the sharding rules (parallel/sharding.py) on the production mesh:
     16x16 ("data","model") single-pod, 2x16x16 ("pod","data","model")
     multi-pod,
  3. runs the step once in a fake world of the mesh's size (a "fake"
     process group whose collectives do nothing, and a ``FakeTensorMode``
     whose tensors have shapes but no storage: no device memory and no
     arithmetic), under ``parallel/hlo_analysis.StepTrace``, which sees
     rank 0's local ops: its matrix-product FLOPs, the collectives
     DTensor issues and the peak of its live bytes,
  4. writes reports/torch_dryrun/<mesh>/<arch>__<shape>.json with the
     reference's summary keys.

The stand-ins for XLA's machinery: a ``DeviceMesh`` for the ``Mesh``,
DTensor placements for ``PartitionSpec``s, fake tensors for
``ShapeDtypeStruct``s, and the recorded c10d collectives for the parsed
HLO. The fake world is made and destroyed inside ``lower_cell``, so no
process group outlives the call (a caller with a process group of its
own gets an error). The numbers differ from the JAX JSONs by method:
XLA's ``cost_analysis`` counts a loop body once, the port loops in
Python and counts every layer and microbatch; the port counts matrix
products only. Memory is the step's arguments (the local shards) plus
the peak of what it allocates, at the op level (no fusion, no buffer
reuse beyond what Python frees); ``memory.peak_top`` lists the largest
storages live near that peak, by the op that made them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (HBM_BYTES, make_world_mesh,
                                     production_mesh_shape)
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.hlo_analysis import StepTrace, summarize
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import (
    default_opt_config, make_opt_init, make_prefill_step, make_serve_step,
    make_train_step,
)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes, in order, without devices: what the sharding rules
    read (``.shape``, ``.axis_names``) and what ``lower_cell`` builds a
    fake world of."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, sizes: Dict[str, int]) -> "MeshShape":
        return cls(tuple(sizes.items()))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)


MESHES = {
    "single_pod_16x16": MeshShape.of(production_mesh_shape(False)),
    "multi_pod_2x16x16": MeshShape.of(production_mesh_shape(True)),
}


def _adjust_cfg(cfg: ArchConfig, shape: ShapeSpec, mesh) -> ArchConfig:
    """Mesh/shape-dependent config fix-ups: act-shard axes, microbatch
    divisibility, MoE group divisibility."""
    sizes = shd.axis_sizes(mesh)
    dp = shd.dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    changes: Dict = {"act_dp_axes": tuple(dp)}
    if shape.kind == "train":
        n_mb = max(cfg.num_microbatches, 1)
        while n_mb > 1 and (shape.global_batch % (n_mb * n_dp) != 0):
            n_mb //= 2
        changes["num_microbatches"] = n_mb
    else:
        changes["num_microbatches"] = 1
    if shd.profile_of(cfg) in ("dp", "fsdp_pure") and cfg.act_shard == "none":
        # dp-profile: re-pin pure-DP activation sharding between blocks
        n_mb = changes["num_microbatches"]
        per_mb = shape.global_batch // max(n_mb, 1)
        bdim = shd.batch_dim(cfg, mesh, per_mb)
        if bdim is not None:
            axes = bdim if isinstance(bdim, tuple) else (bdim,)
            changes["act_shard"] = "batch"
            changes["act_dp_axes"] = tuple(axes)
    if cfg.family == "moe":
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        g = min(cfg.moe_group_size, max(tokens // max(n_dp, 1), 1))
        changes["moe_group_size"] = g
        if cfg.moe_token_axes:
            # per-microbatch token count determines the group count G
            if shape.kind == "train":
                mb_tokens = (shape.global_batch // changes["num_microbatches"]) * shape.seq_len
            elif shape.kind == "prefill":
                mb_tokens = (shape.global_batch // max(cfg.prefill_microbatches, 1)) * shape.seq_len
            else:
                mb_tokens = shape.global_batch
            names = shd.axis_names(mesh)
            axes = tuple(a for a in ("pod", "data", "model") if a in names)
            n_all = 1
            for a in axes:
                n_all *= sizes[a]
            # shrink the group so G divides the full device count
            while g > 1 and (mb_tokens // g) % n_all != 0:
                g //= 2
            if g >= 1 and mb_tokens >= g and (mb_tokens // g) % n_all == 0:
                changes["moe_group_size"] = g
                changes["moe_token_axes"] = axes
            else:
                changes["moe_token_axes"] = ()
    return dataclasses.replace(cfg, **changes)


@contextlib.contextmanager
def fake_world(mesh):
    """A fake process group of ``mesh``'s size (this process is rank 0;
    collectives return at once) and its ``DeviceMesh`` on the CPU,
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("lower_cell makes its own fake world: a process "
                           "group is already initialised")
    sizes = shd.axis_sizes(mesh)
    dist.init_process_group("fake", rank=0, world_size=math.prod(
        sizes.values()), store=FakeStore())
    try:
        yield make_world_mesh(sizes, "cpu")
    finally:
        dist.destroy_process_group()


def _shard(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """A fake full tensor as a DTensor whose local tensor is rank 0's
    shard (fake too)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    pl = shd.placements(mesh, spec)
    with unset_fake_temporarily():   # the mesh's coordinates are real
        local_shape, _ = compute_local_shape_and_global_offset(
            x.shape, mesh, pl)
    local = torch.empty(local_shape, dtype=x.dtype, device=x.device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def _shard_tree(tree, spec_tree, mesh):
    return T.map_leaves(
        lambda x, s: _shard(x, mesh, s) if torch.is_tensor(x) else x,
        tree, spec_tree)


def _local_bytes(*trees) -> int:
    n = 0
    for tree in trees:
        for x in T.leaves(tree):
            if torch.is_tensor(x):
                loc = x.to_local() if hasattr(x, "to_local") else x
                n += loc.numel() * loc.element_size()
    return n


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               opt_override: Optional[OptimizerConfig] = None,
               cfg_override: Optional[ArchConfig] = None) -> Dict:
    """Run one step of the cell on a fake world of ``mesh`` (a
    ``MeshShape``, or anything with ``.shape`` and ``.axis_names``) and
    return its summary (the reference's keys)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = SHAPES[shape_name]
    cfg = cfg_override or get_arch(arch)
    if shape.name in cfg.skip_shapes:
        raise ValueError(f"{arch} skips {shape_name} (sub-quadratic only)")
    cfg = _adjust_cfg(cfg, shape, mesh)
    n_dev = math.prod(shd.axis_sizes(mesh).values())

    t0 = time.time()
    fake = FakeTensorMode()
    trace = StepTrace(fake_mode=fake)
    with fake_world(mesh) as dmesh, fake:
        params_full = S.params_sds(cfg)
        pspecs = shd.param_specs(cfg, dmesh, params_full)
        params = _shard_tree(params_full, pspecs, dmesh)
        if shape.kind == "train":
            opt_cfg = opt_override or default_opt_config(cfg)
            opt_full = make_opt_init(cfg, opt_cfg)(params_full)
            ospecs = shd.opt_state_specs(cfg, dmesh, opt_full, pspecs)
            opt = {k: (v if k == "step" else _shard_tree(v, ospecs[k], dmesh))
                   for k, v in opt_full.items()}
            bspecs = shd.batch_specs(cfg, dmesh, shape)
            batch = _shard_tree(S.batch_specs_sds(cfg, shape), bspecs, dmesh)
            step = make_train_step(
                cfg, opt_cfg, donate=True,
                grad_specs=shd.named(dmesh, shd.grad_specs(cfg, dmesh,
                                                           params_full)))
            arg_bytes = _local_bytes(params, opt, batch)
            with trace:
                step(params, opt, batch)
        elif shape.kind == "prefill":
            batch = _shard_tree(S.batch_specs_sds(cfg, shape),
                                shd.batch_specs(cfg, dmesh, shape), dmesh)
            arg_bytes = _local_bytes(params, batch)
            with trace:
                make_prefill_step(cfg)(params, batch)
        else:  # decode
            cache_full = S.cache_specs_sds(cfg, shape)
            cache = _shard_tree(cache_full, shd.cache_specs(
                cfg, dmesh, shape, cache_full), dmesh)
            tokens = _shard(S.decode_tokens_sds(cfg, shape), dmesh,
                            shd.decode_tokens_spec(cfg, dmesh, shape))
            arg_bytes = _local_bytes(params, cache, tokens)
            with torch.no_grad(), trace:
                make_serve_step(cfg)(params, cache, tokens)
    t_step = time.time() - t0

    summary = summarize(trace, n_dev, arg_bytes)
    summary.update({
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "num_microbatches": cfg.num_microbatches,
        "act_shard": cfg.act_shard,
        "profile": shd.profile_of(cfg),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "local_ops": trace.n_ops,
        "lower_s": round(t_step, 2),
        "compile_s": 0.0,
    })
    summary["fits_hbm"] = bool(summary["memory"]["peak_bytes"] <= HBM_BYTES)
    return summary


def cells_for(arch: str):
    return [s.name for s in get_arch(arch).shapes()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/torch_dryrun")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append("single_pod_16x16")
    if args.mesh in ("multi", "both"):
        meshes.append("multi_pod_2x16x16")

    archs = [args.arch] if args.arch else list(ARCHS)
    failures = []
    for mesh_name in meshes:
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        for arch in archs:
            shapes = [args.shape] if args.shape else cells_for(arch)
            for shape_name in shapes:
                if shape_name in get_arch(arch).skip_shapes:
                    print(f"[skip] {arch} x {shape_name} "
                          "(sub-quadratic required)")
                    continue
                path = os.path.join(outdir, f"{arch}__{shape_name}.json")
                if args.resume and os.path.exists(path):
                    print(f"[resume] {arch} x {shape_name} exists")
                    continue
                print(f"[fake step] {mesh_name}: {arch} x {shape_name} ...",
                      flush=True)
                try:
                    summary = lower_cell(arch, shape_name, MESHES[mesh_name],
                                         mesh_name)
                    mem = summary["memory"]
                    print(
                        f"  ok: flops/dev={summary['flops_per_device']:.3e} "
                        f"bytes/dev={summary['bytes_per_device']:.3e} "
                        f"coll_wire/dev="
                        f"{summary['collective_wire_bytes_per_device']:.3e} "
                        f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
                        f"fits={summary['fits_hbm']} "
                        f"step={summary['lower_s']}s", flush=True)
                    for t in mem["peak_top"][:3]:
                        print(f"    {t['bytes'] / 2**30:.3f} GiB {t['op']} "
                              f"{tuple(t['shape'])} {t['dtype']} "
                              f"x{t['count']}", flush=True)
                    with open(path, "w") as f:
                        json.dump(summary, f, indent=1)
                except Exception as e:
                    failures.append((mesh_name, arch, shape_name, repr(e)))
                    traceback.print_exc()
                    if not args.keep_going:
                        return 1
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("dry-run complete: every cell ran its step.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
