"""Elastic placement of training and serving state (the port of the JAX
package's train/elastic.py).

Training: a run restarts from its latest checkpoint (launch/train.py
``--resume``), ``gather_to_host`` brings a state tree to host numpy, and
``reshard_params`` / ``reshard_opt_state`` place host state on a plan. A
plan of one device (``ReadoutMesh``, ``make_host_mesh(1, 1)``) takes the
state whole; a ``DeviceMesh`` takes it as DTensors placed by the sharding
rules (``parallel/sharding.param_specs`` / ``opt_state_specs``), any
(data, model) shape, because checkpoints are stored unsharded and the
rules are pure functions of (config, mesh). Every rank holds the same
host tree (one checkpoint), so each takes its own shards without
communication; a DTensor leaf (a live state on another plan) is gathered
first. ``gather_to_host`` gathers DTensor leaves (``full_tensor``, a
collective every rank calls). Batches need no migration: they are pure
functions of (seed, step, shard) (data/pipeline.py).

Serving: a packed stack is replicated state (the chip axis is a tensor dimension,
not a split), so any device plan (launch.mesh.ReadoutMesh) will take it.
The port's fleet plans every bucket on its one device, so no live server
moves yet (``ReadoutServer.rebind_mesh`` refuses a plan of another
device); this places a stack, or any tree of tensors, on a plan's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import ReadoutMesh
from repro_torch.parallel import sharding as shd
from repro_torch.train import tree as T


def _one_device(mesh: ReadoutMesh) -> torch.device:
    if mesh.size != 1:
        raise ValueError(f"a readout plan of {mesh.size} devices does not "
                         "shard training state: pass a DeviceMesh "
                         "(launch.mesh.make_host_mesh)")
    return mesh.device


def _host_tensor(x, device) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return torch.as_tensor(x).to(device)


def _place(tree: Any, spec_tree: Any, mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` under its spec."""
    dev = torch.device(mesh.device_type)
    return T.map_leaves(
        lambda x, s: shd.distribute(_host_tensor(x, dev),
                                    shd.NamedSharding(mesh, s),
                                    src_data_rank=None),
        tree, spec_tree)


def reshard_params(cfg, mesh, params_host: Any) -> Any:
    """Host (numpy or tensor) params -> tensors on the plan's one device,
    dtypes kept; on a ``DeviceMesh``, DTensors under ``param_specs``."""
    if isinstance(mesh, ReadoutMesh):
        dev = _one_device(mesh)
        return T.map_leaves(lambda x: torch.as_tensor(x).to(dev),
                            params_host)
    return _place(params_host, shd.param_specs(cfg, mesh, params_host), mesh)


def reshard_opt_state(cfg, mesh, opt_host: Any,
                      params_template: Any) -> Any:
    """Host optimizer state -> tensors on the plan's one device; on a
    ``DeviceMesh``, DTensors under ``opt_state_specs`` (the step scalar
    replicated)."""
    if isinstance(mesh, ReadoutMesh):
        dev = _one_device(mesh)
        return T.map_leaves(lambda x: torch.as_tensor(x).to(dev), opt_host)
    pspecs = shd.param_specs(cfg, mesh, params_template)
    ospecs = shd.opt_state_specs(cfg, mesh, opt_host, pspecs)
    step = _host_tensor(opt_host["step"], torch.device(mesh.device_type))
    return {**_place({k: v for k, v in opt_host.items() if k != "step"},
                     {k: v for k, v in ospecs.items() if k != "step"},
                     mesh), "step": step}


def gather_to_host(tree: Any) -> Any:
    """Every tensor leaf as a host numpy array (pre-save), a DTensor leaf
    gathered whole (every rank must call this); a bf16 leaf, which numpy
    cannot hold, raises ValueError naming it."""
    from torch.distributed.tensor import DTensor

    def host(key, x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if torch.is_tensor(x):
            if x.dtype == torch.bfloat16:
                raise ValueError(f"leaf {key!r} is bfloat16, which numpy "
                                 "cannot hold")
            return x.detach().cpu().numpy()
        return np.asarray(x)

    keys, values = zip(*((k, host(k, v)) for k, v in T.items(tree)))
    return T.unflatten(keys, values) if isinstance(tree, dict) else values[0]


def reshard_replicated(tree: Any, mesh: ReadoutMesh) -> Any:
    """``tree`` with every tensor on the plan's device: the fields of a
    dataclass, the values of a dict and the items of a list or tuple are
    mapped; ``None`` and every other (static) value pass through. A
    tensor already there is not copied."""
    dev = mesh.device

    def move(x):
        if torch.is_tensor(x):
            return x.to(dev)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if type(x) in (list, tuple):
            return type(x)(move(v) for v in x)
        return x

    return move(tree)
