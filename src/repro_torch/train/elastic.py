"""Elastic placement of training and serving state (the port of the JAX
package's train/elastic.py).

Training: a run restarts from its latest checkpoint (launch/train.py
``--resume``), ``gather_to_host`` brings a state tree to host numpy, and
``reshard_params`` / ``reshard_opt_state`` place host state on a plan.
The port trains on one device: a plan of one device (``ReadoutMesh``,
``make_host_mesh(1, 1)``) takes the state whole; a plan over several
devices needs the sharding rules (``parallel/sharding.param_specs``) and
raises ``NotPortedError`` (ROADMAP A.18). Batches need no migration: they
are pure functions of (seed, step, shard) (data/pipeline.py).

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

from repro_torch.device import NotPortedError
from repro_torch.launch.mesh import ReadoutMesh
from repro_torch.train import tree as T


def _one_device(mesh: ReadoutMesh) -> torch.device:
    if mesh.size != 1:
        raise NotPortedError(f"placing training state on {mesh.size} "
                             "devices needs the sharding rules: ROADMAP A.18")
    return mesh.device


def reshard_params(cfg, mesh: ReadoutMesh, params_host: Any) -> Any:
    """Host (numpy or tensor) params -> tensors on the plan's one device,
    dtypes kept."""
    dev = _one_device(mesh)
    return T.map_leaves(lambda x: torch.as_tensor(x).to(dev), params_host)


def reshard_opt_state(cfg, mesh: ReadoutMesh, opt_host: Any,
                      params_template: Any) -> Any:
    """Host optimizer state -> tensors on the plan's one device."""
    dev = _one_device(mesh)
    return T.map_leaves(lambda x: torch.as_tensor(x).to(dev), opt_host)


def gather_to_host(tree: Any) -> Any:
    """Every tensor leaf as a host numpy array (pre-save); a bf16 leaf,
    which numpy cannot hold, raises ValueError naming it."""
    def host(key, x):
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
