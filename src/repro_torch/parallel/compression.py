"""Sparse trigger readout: the at-source reduction on the server's host link.

The trigger half of the JAX package's parallel/compression.py, and the
int8 quantizers of its other half (``quantize_int8`` / ``dequantize_int8``,
``quantize_kv`` / ``dequantize_kv``); its collectives
(``quantized_psum``, ``make_compressed_value_and_grad``) come with the
training slice (ROADMAP A.17). The keep/drop cut runs on
the device; instead of shipping the dense (chips, events) score + keep
tensors across the host link, only keep-flagged events cross it, as a
packed (flat index, score) pair, so the bytes on the wire scale with the
trigger rate and not with the event rate. The pack is shape-static
(padded with -1 / 0), so it needs no host synchronisation; the server
copies the ``count`` prefix, which is what crosses the link.

Both packs launch kernel B6 (kernels/sparse_pack, csrc/sparse_pack.cu) on
CUDA tensors and run its plain twin on CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.lut_eval.bitsliced import WORD, mask_words
from repro_torch.kernels.sparse_pack.sparse_pack import pack_keep_words

# Wire cost model for the report's accounting: a sparse event ships a
# flat int32 index + int32 score; the dense alternative ships an int32
# score + a keep byte for EVERY scored event, kept or not.
SPARSE_BYTES_PER_EVENT = 8
DENSE_BYTES_PER_EVENT = 5
SPARSE_HEADER_BYTES = 4  # the count word
# Little-endian struct formats of the sparse wire units (the network
# protocol frames exactly these on the socket).
SPARSE_RECORD_STRUCT = "<ii"   # (flat index i32, score i32) per kept event
SPARSE_COUNT_STRUCT = "<I"     # the SPARSE_HEADER_BYTES count prefix


class WireFormatError(ValueError):
    """A wire-format unit failed validation (count prefix out of range,
    index out of the dense shape, mismatched index/score buffers): every
    malformed buffer raises from this family, never a raw numpy
    IndexError and never a silent partial decode."""


Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def sparse_trigger_pack(score: torch.Tensor, keep: torch.Tensor) -> Packed:
    """Compact keep-flagged events: (count () int32, idx (n,) int32
    ascending flat indices of kept events -1 padded, vals (n,) int32 kept
    scores 0 padded), n = keep.numel(), for score/keep of any matching
    shape (the server's is (chips, events): flat index ``c*B + b``).

    The word pack over the flattened mask: it is packed into words as one
    row with the tail lanes 0, so the shape need not be a multiple of 32,
    and the padded output is cut back to n slots."""
    if tuple(score.shape) != tuple(keep.shape):
        raise ValueError(f"score {tuple(score.shape)} and keep "
                         f"{tuple(keep.shape)} differ in shape")
    n = keep.numel()
    flat_keep = keep.reshape(1, n).to(torch.bool)
    keep_w = mask_words(flat_keep)                          # (1, W)
    W = keep_w.shape[1]
    scores = torch.zeros((W * WORD,), dtype=torch.int32, device=score.device)
    scores[:n] = score.reshape(n).to(torch.int32)
    count, idx, vals = pack_keep_words(keep_w, scores.reshape(1, W, WORD))
    return count, idx[:n], vals[:n]


def sparse_trigger_pack_words(keep_w: torch.Tensor,
                              scores: torch.Tensor) -> Packed:
    """``sparse_trigger_pack`` computed from the word domain: (C, W) int32
    keep words (bit ``e`` of word ``w`` = event ``w*32+e``) and (C, W, 32)
    int32 lane scores -> (count, idx (C*W*32,), vals), the same ascending
    wire format, without an event-order mask."""
    return pack_keep_words(keep_w, scores)


def sparse_trigger_unpack(
    idx, vals, shape, count: int | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of ``sparse_trigger_pack``: the packed pair
    (padded or already count-sliced) and the dense shape -> (score (shape)
    int32, 0 where dropped; keep (shape) bool).

    ``count``, when given, is the wire's count prefix: the first ``count``
    records are the payload, the rest padding. The buffers are validated
    before any scatter: a count prefix larger than the buffer, mismatched
    idx/vals lengths or an index outside the dense shape raise
    :class:`WireFormatError`."""
    idx = np.asarray(idx, np.int64).ravel()
    vals = np.asarray(vals, np.int64).ravel()
    if idx.shape != vals.shape:
        raise WireFormatError(
            f"sparse trigger buffers disagree: {idx.size} indices vs "
            f"{vals.size} scores")
    if count is not None:
        if not (0 <= count <= idx.size):
            raise WireFormatError(
                f"sparse trigger count prefix {count} outside the "
                f"record buffer (0..{idx.size})")
        idx = idx[:count]
        vals = vals[:count]
    n = int(np.prod(shape))
    kept = idx >= 0
    kidx = idx[kept]
    if kidx.size and (int(kidx.max()) >= n or int(idx.min()) < -1):
        raise WireFormatError(
            f"sparse trigger index outside dense shape {tuple(shape)}: "
            f"indices span [{int(idx.min())}, {int(kidx.max())}], "
            f"valid flat range is [-1 (padding), {n - 1}]")
    score = np.zeros(n, np.int32)
    keep = np.zeros(n, bool)
    score[kidx] = vals[kept]
    keep[kidx] = True
    return score.reshape(shape), keep.reshape(shape)


# ------------------------------------------------------------ int8 (absmax)
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """absmax-scaled symmetric int8 over the whole tensor: (q int8, scale
    f32 0-d) with scale = max|x| / 127 + 1e-30, round half to even
    (reference: repro/parallel/compression.py:55)."""
    xf = x.to(torch.float32)
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def quantize_kv(kv: torch.Tensor, axis: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector absmax int8 along ``axis`` (head_dim by default): (q
    int8, scale f32 with ``axis`` kept as 1) (reference:
    repro/parallel/compression.py:297)."""
    xf = kv.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=axis, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
