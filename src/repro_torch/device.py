"""Device resolution and the port's named errors.

The port serves on the card. ``resolve_device(None)`` means CUDA; when no
CUDA device is present the caller must ask for the CPU explicitly
(``device="cpu"``, as the CPU tests do) — an entry point never carries on
quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


class DeviceUnavailableError(RuntimeError):
    """CUDA was asked for (explicitly, or by default) but is not present."""


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """None -> ``cuda``; "cpu"/"cuda"/"cuda:N"/torch.device pass through.

    Raises DeviceUnavailableError for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s} (expected cuda or cpu)")
    return dev
