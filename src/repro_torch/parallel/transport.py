"""How a sharded step's collectives travel when its ranks share a card.

NCCL refuses two ranks on one GPU, so a world of several ranks on one
card runs gloo (``launch.mesh.init_world`` picks it). Gloo reduces CUDA
tensors in ``all_reduce`` only: its all-gather on a CUDA tensor ends the
process (SIGSEGV, H100 with torch 2.11). ``host_staged_collectives()``
stages every functional collective on a CUDA tensor (``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, the ops DTensor and ``parallel/compression``
issue) through the host: the input is copied to the CPU, the collective
runs there and waits, and the result is copied back to the input's
device. ``transport_for(mesh)`` is that mode for a gloo world on CUDA and
a no-op otherwise (NCCL, or a CPU world).
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _ops():
    c = torch.ops._c10d_functional
    return {c.all_reduce.default: "all_reduce",
            c.all_gather_into_tensor.default: "all_gather_into_tensor",
            c.reduce_scatter_tensor.default: "reduce_scatter_tensor",
            c.all_to_all_single.default: "all_to_all_single"}


class HostStagedCollectives(TorchDispatchMode):
    """Every functional collective on a CUDA tensor runs on a host copy;
    ``staged`` counts them by op."""

    def __init__(self):
        super().__init__()
        self.staged = collections.Counter()
        self._collectives = _ops()
        self._wait = torch.ops._c10d_functional.wait_tensor.default
        # the host-staged results still alive, whose waits are no-ops
        self._mine = weakref.WeakValueDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is self._wait and self._mine.get(id(args[0])) is args[0]:
            return args[0]          # already waited on the host
        name = self._collectives.get(func)
        if name is None or not args[0].is_cuda:
            return func(*args, **kwargs)
        dev = args[0].device
        out = func(args[0].cpu(), *args[1:], **kwargs)
        out = self._wait(out).to(dev)
        self.staged[name] += 1
        self._mine[id(out)] = out
        return out


def transport_for(mesh):
    """``HostStagedCollectives`` for a gloo world on CUDA, else a no-op."""
    import torch.distributed as dist

    if (getattr(mesh, "device_type", "cpu") == "cuda"
            and dist.is_initialized() and dist.get_backend() == "gloo"):
        return HostStagedCollectives()
    return contextlib.nullcontext()
