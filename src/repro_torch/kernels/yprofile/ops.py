"""Featurizer: charge frames -> 13-bin y-profile + y0 (the frontend's stage 1).

``yprofile_traced`` is the kernel wrapper: on a CUDA tensor it launches
the hand-written kernel (csrc/yprofile.cu, which replaces the JAX
package's ``yprofile_pallas_stacked``); on a CPU tensor it runs
``yprofile_plain``, the plain PyTorch twin. There is no fallback from one
to the other.

Float contract: the kernel, the twin and the JAX package's one-hot dot
each sum a bin's 168 charges in a different order, so features agree to
summation-order rounding (|d| <= 2e-5 |x| + 1e-6 ke, tests/test_torch_
yprofile.py), not bit for bit. A feature within that distance of an
ap_fixed step can quantize to the neighbouring grid point. Everything
downstream of the quantized bits is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.smartpixel import N_T, N_X, N_Y
from repro_torch.device import resolve_device
from repro_torch.kernels import build

N_FEATURES = N_Y + 1
OUT_COLS = 128                    # public (C, B, 128) layout, y0 in col N_Y


def yprofile_plain(frames: torch.Tensor, y0: torch.Tensor,
                   threshold: float) -> torch.Tensor:
    """Plain PyTorch twin: (C, B, T, Y, X) f32 + (C, B) -> (C, B, 128)."""
    C, B = frames.shape[0], frames.shape[1]
    prof = frames.to(torch.float32).sum(dim=(2, 4))             # (C, B, Y)
    prof = torch.clamp_min(prof, 0.0)
    prof = torch.where(prof > threshold, prof, torch.zeros_like(prof))
    # a tensor divisor: true IEEE division, as the reference's `/ 1000.0`
    # (a scalar divisor may become a multiply by the reciprocal)
    prof = prof / torch.full_like(prof, 1000.0)
    out = torch.zeros((C, B, OUT_COLS), dtype=torch.float32,
                      device=frames.device)
    out[:, :, :N_Y] = prof
    out[:, :, N_Y] = y0.to(torch.float32)
    return out


def _launch(frames: torch.Tensor, y0: torch.Tensor, threshold: float,
            out: torch.Tensor) -> None:
    lib = build.load("yprofile")
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        code = lib.yprofile_launch(
            frames.data_ptr(), y0.data_ptr(), out.data_ptr(),
            frames.shape[0] * frames.shape[1], float(threshold), stream)
    build.check(lib, code, "yprofile kernel")


def yprofile_traced(frames: torch.Tensor, y0: torch.Tensor, *,
                    threshold: float) -> torch.Tensor:
    """Chip-batched featurization, the fused frontend's stage 1:
    (C, B, T, Y, X) f32 + (C, B) f32 -> (C, B, 128) f32 with the profile
    in columns [0, N_Y), y0 in column N_Y and zeros elsewhere. CUDA
    tensors launch the kernel (counted in ``yprofile_traced.launches``);
    CPU tensors run the plain twin. The launch signature (C, B) is
    recorded first, on either."""
    if frames.ndim != 5 or tuple(frames.shape[2:]) != (N_T, N_Y, N_X):
        raise ValueError(f"frames must be (C, B, {N_T}, {N_Y}, {N_X}), "
                         f"got {tuple(frames.shape)}")
    if tuple(y0.shape) != tuple(frames.shape[:2]):
        raise ValueError(f"y0 {tuple(y0.shape)} != frames (C, B) "
                         f"{tuple(frames.shape[:2])}")
    build.note_signature("yprofile", tuple(frames.shape[:2]), frames.device)
    if frames.device.type == "cpu":
        return yprofile_plain(frames, y0, threshold)
    if frames.device.type != "cuda" or y0.device != frames.device:
        raise ValueError(f"frames on {frames.device}, y0 on {y0.device}: "
                         "both must be on one CUDA device (or the CPU)")
    frames = frames.to(torch.float32).contiguous()
    if frames.data_ptr() % 16:
        frames = frames.clone()             # float4 loads need 16 B
    y0 = y0.to(torch.float32).contiguous()
    C, B = frames.shape[0], frames.shape[1]
    out = torch.empty((C, B, OUT_COLS), dtype=torch.float32,
                      device=frames.device)
    _launch(frames, y0, threshold, out)
    yprofile_traced.launches += 1
    return out


yprofile_traced.launches = 0


def yprofile(frames, y0, threshold_electrons: float = 800.0, *,
             device=None) -> torch.Tensor:
    """frames (B, 8, 13, 21) electrons + y0 (B,) um -> features (B, 14),
    computed on ``device`` (default: CUDA) through the C=1 path."""
    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(frames, np.float32), device=dev)
    z = torch.as_tensor(np.asarray(y0, np.float32), device=dev)
    out = yprofile_traced(f[None], z[None],
                          threshold=float(threshold_electrons))
    return out[0, :, :N_FEATURES]
