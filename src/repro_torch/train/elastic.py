"""Elastic placement of serving state (the port's copy of
``reshard_replicated`` from the JAX package's train/elastic.py).

A packed stack is replicated state (the chip axis is a tensor dimension,
not a split), so any device plan (launch.mesh.ReadoutMesh) will take it.
The port's fleet plans every bucket on its one device, so no live server
moves yet (``ReadoutServer.rebind_mesh`` refuses a plan of another
device); this places a stack, or any tree of tensors, on a plan's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.launch.mesh import ReadoutMesh


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
