"""ap_fixed<W,I> fixed-point arithmetic, bit-exact with HLS semantics.

The paper synthesizes the BDT with ``ap_fixed<28,19>`` (Vivado/Vitis HLS):
  - W  = total width in bits (including sign)
  - I  = integer bits (including sign); F = W - I fractional bits
  - default quantization mode AP_TRN (truncate toward -inf)
  - default overflow mode     AP_WRAP (two's-complement wraparound)

We back the representation with exact int64 raw values (value = raw / 2**F)
so that threshold comparisons inside the synthesized netlist are *exact*
integer comparisons — this is what makes the paper's "100% agreement with the
golden model" experiment reproducible bit-for-bit.

The numpy part is a copy of the JAX package's core/quantize.py (the port
keeps its own numpy modules). The device twin at the bottom works on torch
tensors in the int32 raw domain (W <= 31); the full-precision multiply
path needs int64 and stays on host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class FixedSpec:
    """Static description of an ap_fixed<width, int_bits> type."""

    width: int = 28
    int_bits: int = 19
    rounding: str = "trn"  # "trn" (AP_TRN, floor) | "rnd" (AP_RND, round-half-up)
    overflow: str = "wrap"  # "wrap" (AP_WRAP) | "sat" (AP_SAT)

    def __post_init__(self):
        if not (1 <= self.width <= 62):
            raise ValueError(f"width must be in [1, 62], got {self.width}")
        if not (0 <= self.int_bits <= self.width):
            raise ValueError(f"int_bits must be in [0, width], got {self.int_bits}")
        if self.rounding not in ("trn", "rnd"):
            raise ValueError(f"unknown rounding mode {self.rounding!r}")
        if self.overflow not in ("wrap", "sat"):
            raise ValueError(f"unknown overflow mode {self.overflow!r}")

    @property
    def frac_bits(self) -> int:
        return self.width - self.int_bits

    @property
    def scale(self) -> float:
        return float(2.0 ** self.frac_bits)

    @property
    def raw_min(self) -> int:
        return -(1 << (self.width - 1))

    @property
    def raw_max(self) -> int:
        return (1 << (self.width - 1)) - 1

    @property
    def min_value(self) -> float:
        return self.raw_min / self.scale

    @property
    def max_value(self) -> float:
        return self.raw_max / self.scale

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale


# The paper's synthesis precision.
AP_FIXED_28_19 = FixedSpec(width=28, int_bits=19)


def _wrap(raw: np.ndarray, spec: FixedSpec) -> np.ndarray:
    """Two's complement wraparound into [raw_min, raw_max]."""
    span = np.int64(1) << np.int64(spec.width)
    half = np.int64(1) << np.int64(spec.width - 1)
    # ((raw + half) mod span) - half, with python-style (floored) modulo.
    return ((raw + half) % span) - half


def _saturate(raw: np.ndarray, spec: FixedSpec) -> np.ndarray:
    return np.clip(raw, spec.raw_min, spec.raw_max)


def _overflow(raw: np.ndarray, spec: FixedSpec) -> np.ndarray:
    if spec.overflow == "sat":
        return _saturate(raw, spec)
    return _wrap(raw, spec)


def quantize_raw(x, spec: FixedSpec) -> np.ndarray:
    """float -> raw int64 per the spec's rounding + overflow modes."""
    x = np.asarray(x, dtype=np.float64)
    scaled = x * spec.scale
    if spec.rounding == "trn":
        raw = np.floor(scaled)
    else:  # AP_RND: round-half-up (add 0.5 ulp then truncate)
        raw = np.floor(scaled + 0.5)
    raw = raw.astype(np.int64)
    return _overflow(raw, spec)


def dequantize_raw(raw, spec: FixedSpec) -> np.ndarray:
    return np.asarray(raw, dtype=np.float64) / spec.scale


def quantize(x, spec: FixedSpec = AP_FIXED_28_19) -> np.ndarray:
    """Round-trip a float array through the fixed-point grid."""
    return dequantize_raw(quantize_raw(x, spec), spec)


# --- raw-domain arithmetic (the synthesized netlist's integer semantics) ----


def fx_add(a_raw, b_raw, spec: FixedSpec) -> np.ndarray:
    return _overflow(np.asarray(a_raw, np.int64) + np.asarray(b_raw, np.int64), spec)


def fx_sub(a_raw, b_raw, spec: FixedSpec) -> np.ndarray:
    return _overflow(np.asarray(a_raw, np.int64) - np.asarray(b_raw, np.int64), spec)


def fx_mul(a_raw, b_raw, spec: FixedSpec) -> np.ndarray:
    """Full-precision product then truncate back to spec (AP_TRN).

    The product of two W-bit values carries 2F fractional bits; the arithmetic
    right shift by F is AP_TRN (floor) for two's complement.
    """
    if 2 * spec.width > 62:
        raise ValueError("product would overflow int64; reduce width")
    prod = np.asarray(a_raw, np.int64) * np.asarray(b_raw, np.int64)
    shifted = prod >> np.int64(spec.frac_bits)
    return _overflow(shifted, spec)


def fx_lt(a_raw, b_raw) -> np.ndarray:
    """Exact fixed-point comparison (what the LUT comparators compute)."""
    return np.asarray(a_raw, np.int64) < np.asarray(b_raw, np.int64)


def fx_le(a_raw, b_raw) -> np.ndarray:
    return np.asarray(a_raw, np.int64) <= np.asarray(b_raw, np.int64)


def to_unsigned_bits(raw, spec: FixedSpec) -> np.ndarray:
    """Map signed raw to an order-preserving unsigned bit pattern.

    For building *unsigned* LUT comparators we flip the sign bit: the mapping
    u = twos_complement_pattern(raw) XOR (1 << (W-1)) is monotone from signed
    order to unsigned order, so ``a < b  <=>  u(a) < u(b)`` with plain
    unsigned comparison. This is the standard trick used by HLS comparator
    synthesis.
    """
    sign = np.int64(1) << np.int64(spec.width - 1)
    span = np.int64(1) << np.int64(spec.width)
    raw = np.asarray(raw, np.int64)
    pattern = np.where(raw < 0, raw + span, raw)  # two's-complement bit pattern
    return pattern ^ sign  # flip sign bit -> offset binary (order-preserving)


def unsigned_bit(u, bit: int) -> np.ndarray:
    return (np.asarray(u, np.int64) >> np.int64(bit)) & np.int64(1)


# --- device-side (torch) quantize + offset-binary bit packing ----------------
#
# The fused frontend (kernels/frontend.py) quantizes features and packs
# fabric input bits on the device, so the host packer above has an int32
# twin on tensors. Bit-exact with the numpy path under the same
# preconditions as the JAX package's device path: |x * scale| < 2**31, and
# |x * scale| < 2**23 for rounding="rnd". The spec is carried as tensors
# broadcastable against x (a per-chip plan), never as a static FixedSpec.


def spec_device_params(spec: FixedSpec) -> Dict[str, np.ndarray]:
    """The per-spec scalars ``quantize_pattern_device`` consumes, as numpy
    values ready to be stacked into a per-chip plan."""
    if spec.width > 31:
        raise ValueError(
            f"device quantize path is int32 (W <= 31), got W={spec.width}"
        )
    no_clip = np.int32(2**31 - 1)
    return {
        "scale": np.float32(spec.scale),
        "rnd_off": np.float32(0.5 if spec.rounding == "rnd" else 0.0),
        "wrap_mask": np.int32((1 << spec.width) - 1),
        "sign_bit": np.int32(1 << (spec.width - 1)),
        "sat_lo": np.int32(spec.raw_min) if spec.overflow == "sat" else -no_clip,
        "sat_hi": np.int32(spec.raw_max) if spec.overflow == "sat" else no_clip,
    }


# Largest float32 values inside int32's range: the float -> int32
# conversion saturates here instead of hitting C's undefined overflow.
_F32_INT32_LO = -2147483648.0
_F32_INT32_HI = 2147483520.0


def quantize_pattern_device(x, *, scale, rnd_off, wrap_mask, sign_bit,
                            sat_lo, sat_hi):
    """float tensor -> offset-binary bit pattern, int32 tensor.

    Mirrors quantize_raw + to_unsigned_bits: scale, round (trn/rnd via
    rnd_off), overflow (sat via the clip bounds, wrap via the mask - the
    masked low W bits of an int32 ARE the two's-complement pattern), then
    the order-preserving sign-bit flip. Every spec parameter is a tensor
    broadcastable against x, so one call serves per-chip specs.
    """
    import torch

    scaled = x.to(torch.float32) * scale + rnd_off
    raw = torch.floor(scaled).clamp(_F32_INT32_LO, _F32_INT32_HI)
    raw = raw.to(torch.int32)
    raw = torch.minimum(torch.maximum(raw, sat_lo), sat_hi)
    return (raw & wrap_mask) ^ sign_bit


def _spec_tensors(spec: FixedSpec, device):
    """``spec_device_params`` as 0-d tensors on ``device``."""
    import torch

    return {k: torch.as_tensor(v, device=device)
            for k, v in spec_device_params(spec).items()}


def quantize_raw_device(x, spec: FixedSpec):
    """float tensor -> raw int32 tensor, the device twin of
    ``quantize_raw`` (reference: repro/core/quantize.py:232
    ``quantize_raw_jax``): the offset-binary pattern of
    ``quantize_pattern_device``, its sign bit flipped back, and patterns
    at or above the sign bit mapped to their negative values."""
    import torch

    p = _spec_tensors(spec, x.device)
    u = quantize_pattern_device(x, **p)
    pattern = u ^ p["sign_bit"]
    span = 1 << spec.width          # W <= 31: the difference fits int32
    return torch.where(pattern >= p["sign_bit"], pattern - span, pattern)


def to_unsigned_bits_device(raw, spec: FixedSpec):
    """raw int32 tensor -> offset-binary pattern, the device twin of
    ``to_unsigned_bits`` (reference: repro/core/quantize.py:247
    ``to_unsigned_bits_jax``): the low W bits of the int32 (its
    two's-complement pattern), the sign bit flipped."""
    import torch

    p = _spec_tensors(spec, raw.device)
    return (raw.to(torch.int32) & p["wrap_mask"]) ^ p["sign_bit"]


def encode_offset_binary_device(x, spec: FixedSpec):
    """float tensor (..., n) -> 0/1 int32 bits (..., n, W), LSB first: the
    device twin of the host packer (quantize_raw -> to_unsigned_bits ->
    unpack; reference: repro/core/quantize.py:257
    ``encode_offset_binary_jax``). The pattern is below 2**31, so the
    arithmetic right shift of int32 is the logical one; the mask after
    it keeps one bit either way."""
    import torch

    u = quantize_pattern_device(x, **_spec_tensors(spec, x.device))
    shifts = torch.arange(spec.width, dtype=torch.int32, device=x.device)
    return (u[..., None] >> shifts) & 1

