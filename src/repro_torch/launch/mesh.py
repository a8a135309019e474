"""Device plans of the readout server, the multi-tenant fleet, the
trainer and the dry-run (the port of the JAX package's launch/mesh.py).

A plan is a ``ReadoutMesh``: a frozen tuple of devices under one "chips"
axis. Two plans over the same devices compare equal, so the fleet can
re-plan after every grow or shrink and a bucket whose plan did not change
rebinds for free (``ReadoutServer.rebind_mesh``). The slab arithmetic is
the reference's, over the ``torch.cuda.device_count()`` cards (or the one
device asked for). The port's server keeps its whole chip axis on one
device, the plan's first, and the port's fleet asks for its one device,
so every bucket gets it: ``cuda:0`` on a card, the CPU with
``device="cpu"``.

The trainer's plan (``make_host_mesh``) is one device for a (1, 1) mesh;
a larger one, and the production meshes (``make_production_mesh``: a
(16, 16) ("data", "model") pod, or (2, 16, 16) with a pure data-parallel
"pod" axis in front), are ``DeviceMesh``es over the ranks of the process
group the caller has initialised (``torchrun``'s environment, or the
dry-run's fake world): a mesh of N devices needs a world of N ranks, and
without one they raise ``MeshUnavailableError`` instead of running on
fewer devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class MeshUnavailableError(RuntimeError):
    """A mesh over several devices was asked for without a process group
    of that many ranks to lay it over."""


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


def make_world_mesh(shape: Dict[str, int], device_type: str):
    """A ``DeviceMesh`` of ``shape`` ({axis name: size}, in mesh order) over
    the ranks of the initialised default process group, whose size must be
    the product of the sizes."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape.values())
    if not dist.is_available() or not dist.is_initialized():
        raise MeshUnavailableError(
            f"a {tuple(shape.values())} {tuple(shape)} mesh needs an "
            f"initialised process group of {n} ranks "
            "(torch.distributed.init_process_group; torchrun sets its "
            "environment)")
    if dist.get_world_size() != n:
        raise MeshUnavailableError(
            f"a {tuple(shape.values())} {tuple(shape)} mesh needs {n} "
            f"ranks, the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def init_world(device_type: str) -> bool:
    """Initialise the default process group from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``) unless one
    is already up; True when this call made it. CPU: gloo. CUDA: NCCL
    when every rank gets its own card, else gloo (NCCL refuses two ranks
    on one GPU; ``parallel/transport`` stages gloo's collectives), each
    rank on card ``LOCAL_RANK`` mod the cards."""
    import os

    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ:
        raise MeshUnavailableError(
            "no process group and no torchrun environment (WORLD_SIZE, "
            "RANK, MASTER_ADDR, MASTER_PORT): launch with torchrun "
            "--nproc-per-node N")
    world = int(os.environ["WORLD_SIZE"])
    backend = "gloo"
    if device_type == "cuda":
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % n_cards)
        if n_cards >= world:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    return True


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The axes of the production mesh: a (16, 16) ("data", "model") pod;
    multi-pod prepends a pure data-parallel "pod" axis of 2."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` (256 or 512 devices) over the
    initialised world (the dry-run's fake world of as many ranks)."""
    if device_type == "cuda":
        resolve_device("cuda")
    return make_world_mesh(production_mesh_shape(multi_pod), device_type)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """The trainer's plan. (1, 1): one device (``device``, default CUDA),
    a ``ReadoutMesh``. Larger: a (data, model) ``DeviceMesh`` over the
    initialised world of ``data * model`` ranks, on ``device``'s type
    (the CUDA cards, or the CPU with ``device="cpu"``)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"model={model}")
    dev = resolve_device(device)
    if data * model > 1:
        return make_world_mesh({"data": data, "model": model}, dev.type)
    return ReadoutMesh((dev,))


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


# H100 SXM5 80GB (700 W) constants of the roofline terms, a device: dense
# bf16 tensor-core peak, HBM3 rate, device memory, and one NVLink 4
# direction (the card's 18 links carry 900 GB/s both ways; 450 GB/s each
# way)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # B/s
ICI_BW = 450e9                # B/s a direction, NVLink 4
HBM_BYTES = 80 * 10**9        # 80 GB
