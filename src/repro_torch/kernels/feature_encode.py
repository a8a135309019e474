"""The section 5 check's feature encode on the card: float feature rows ->
the fabric's offset-binary input bits (csrc/feature_encode.cu).

Replaces no TPU kernel: the JAX package quantizes and encodes the check's
rows on the host, and so did the port, whose check spent ~90% of its
window there. ``encode_rows`` is the wrapper: CUDA tensors launch the
kernel (counted in ``encode_rows.launches``); CPU tensors run
``encode_plain``, the plain PyTorch twin. There is no fallback from one to
the other.

Both compute ``SynthResult.encode_inputs(QuantizedEnsemble.
quantize_features(X))`` bit for bit, for every row: float64 ``x * scale``
(then ``+ 0.5`` for AP_RND, a separate rounding), floor, int64 as numpy
casts on x86_64 (INT64_MIN for NaN, +-inf and whatever lies past
[-2**63, 2**63)), wrap or clip, the sign bit flipped, W bits LSB-first in
``used`` order (column f * W + w).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import FixedSpec
from repro_torch.kernels import build

TWO_63 = 2.0 ** 63
# the kernel's 32 rows a block x 8 B a pattern in 48 KB of shared memory
MAX_USED = 192


def encode_plain(x: torch.Tensor, used: torch.Tensor,
                 spec: FixedSpec) -> torch.Tensor:
    """Plain PyTorch twin: (B, F) float32/float64 rows -> (B, n_used * W)
    int32 0/1."""
    W = spec.width
    s = x[:, used.long()].to(torch.float64) * spec.scale
    if spec.rounding == "rnd":
        s = s + 0.5
    s = torch.floor(s)
    cast = (s >= -TWO_63) & (s < TWO_63)            # False for NaN
    raw = torch.where(cast, torch.where(cast, s, 0.0).to(torch.int64),
                      torch.iinfo(torch.int64).min)
    mask, half = (1 << W) - 1, 1 << (W - 1)
    if spec.overflow == "sat":
        raw = raw.clamp(-half, half - 1)
    u = (raw & mask) ^ half                         # wrap: the low W bits
    shifts = torch.arange(W, dtype=torch.int64, device=x.device)
    return ((u[..., None] >> shifts) & 1).to(torch.int32).reshape(
        x.shape[0], used.shape[0] * W)


def _launch(x: torch.Tensor, used: torch.Tensor, spec: FixedSpec,
            bits: torch.Tensor) -> None:
    lib = build.load("feature_encode")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.feature_encode_launch(
            x.data_ptr(), int(x.dtype == torch.float64), x.shape[0],
            x.shape[1], used.data_ptr(), used.shape[0], spec.width,
            spec.frac_bits, int(spec.rounding == "rnd"),
            int(spec.overflow == "sat"), bits.data_ptr(), stream)
    build.check(lib, code, "feature_encode kernel")


def encode_rows(x: torch.Tensor, used: torch.Tensor, spec: FixedSpec,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, F) float32 or float64 feature rows + (n_used,) int32 column
    indices -> (B, n_used * W) int32 input bits, on the rows' device,
    written into ``out`` when it is given (a contiguous int32 tensor of
    that shape there, reused from call to call). CUDA tensors launch the
    kernel (counted in ``encode_rows.launches``); CPU tensors run the
    twin. The launch signature is recorded first, on either."""
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rows must be (B, F) float32 or float64, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not 0 < used.shape[0] <= MAX_USED:
        raise ValueError(f"{used.shape[0]} used features: the kernel "
                         f"takes 1 to {MAX_USED}")
    shape = (x.shape[0], used.shape[0] * spec.width)
    if used.device != x.device or (out is not None
                                   and out.device != x.device):
        raise ValueError(f"rows on {x.device}, used on {used.device}"
                         + ("" if out is None else f", out on {out.device}")
                         + ": all must be on one device")
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.int32
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {shape}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    build.note_signature("feature_encode",
                         (x.shape[0], x.shape[1], used.shape[0], spec.width),
                         x.device)
    if x.device.type == "cpu":
        bits = encode_plain(x, used, spec)
        return bits if out is None else out.copy_(bits)
    if x.device.type != "cuda":
        raise ValueError(f"rows on {x.device}: CUDA or the CPU")
    x = x.contiguous()
    used = used.to(torch.int32).contiguous()
    bits = (torch.empty(shape, dtype=torch.int32, device=x.device)
            if out is None else out)
    _launch(x, used, spec, bits)
    encode_rows.launches += 1
    return bits


encode_rows.launches = 0
