"""Device plans of the readout server, the multi-tenant fleet and the
trainer (the port of the JAX package's launch/mesh.py, without the
production mesh and its roofline constants, which serve the dry-run:
ROADMAP A.18).

A plan is a ``ReadoutMesh``: a frozen tuple of devices under one "chips"
axis. Two plans over the same devices compare equal, so the fleet can
re-plan after every grow or shrink and a bucket whose plan did not change
rebinds for free (``ReadoutServer.rebind_mesh``). The slab arithmetic is
the reference's, over the ``torch.cuda.device_count()`` cards (or the one
device asked for). The port's server keeps its whole chip axis on one
device, the plan's first, and the port's fleet asks for its one device,
so every bucket gets it: ``cuda:0`` on a card, the CPU with
``device="cpu"``. The trainer's plan (``make_host_mesh``) is one device
too: the port trains on one card, and a larger (data, model) plan raises
``NotPortedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.device import NotPortedError, resolve_device


@dataclasses.dataclass(frozen=True)
class ReadoutMesh:
    """The devices of one readout "chips" axis (at least one)."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a readout mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Where the port's server keeps the chip axis."""
        return self.devices[0]


def make_host_mesh(data: int = 1, model: int = 1, device=None
                   ) -> ReadoutMesh:
    """The trainer's plan: one device (``device``, default CUDA) for
    ``data == model == 1``. A plan over more devices shards the params
    and the batch (``parallel/sharding``), which is not ported: it raises
    ``NotPortedError`` (ROADMAP A.18)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"model={model}")
    if data * model > 1:
        raise NotPortedError(f"a (data={data}, model={model}) training mesh "
                             "shards the params and the batch: ROADMAP "
                             "A.18")
    return ReadoutMesh((resolve_device(device),))


def local_devices(device=None) -> List[torch.device]:
    """The devices a plan may use: every CUDA card for None or "cuda"
    (indexed, as tensors report them), else the one device asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _largest_divisor(n_chips: int, limit: int) -> int:
    return max(k for k in range(1, min(limit, n_chips) + 1)
               if n_chips % k == 0)


def make_readout_mesh(n_chips: int, device=None) -> ReadoutMesh:
    """One "chips" axis over the largest device count that divides
    ``n_chips`` evenly (every device an identical slab of chips); one
    device when there is one."""
    if n_chips < 1:
        raise ValueError(f"need n_chips >= 1, got {n_chips}")
    devices = local_devices(device)
    return ReadoutMesh(tuple(devices[: _largest_divisor(n_chips,
                                                        len(devices))]))


def make_fleet_meshes(bucket_chip_counts: Sequence[int],
                      device=None) -> List[ReadoutMesh]:
    """One readout plan a fleet bucket, over disjoint devices where there
    are enough: contiguous slices proportional to each bucket's chip
    count, at least one device a bucket; with fewer devices than buckets
    the slices wrap (one card: every bucket gets it). Within its slice a
    bucket uses the largest divisor of its chip count, as
    ``make_readout_mesh`` does. An unchanged bucket's new plan equals its
    old one, so only a bucket whose slab moved pays a move."""
    if not bucket_chip_counts:
        return []
    for n in bucket_chip_counts:
        if n < 1:
            raise ValueError(
                f"every bucket needs >= 1 chip, got {bucket_chip_counts!r}")
    devices = local_devices(device)
    n_dev, n_buckets = len(devices), len(bucket_chip_counts)
    total = sum(bucket_chip_counts)
    meshes: List[ReadoutMesh] = []
    start = 0
    for b, n_chips in enumerate(bucket_chip_counts):
        if n_dev >= n_buckets:
            width = max(1, (n_chips * n_dev) // total)
            width = min(width, n_dev - start - (n_buckets - 1 - b))
            slab = devices[start : start + width]
            start += width
        else:
            slab = [devices[b % n_dev]]
        meshes.append(ReadoutMesh(tuple(
            slab[: _largest_divisor(n_chips, len(slab))])))
    return meshes
