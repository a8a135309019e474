"""Sparse trigger egress, kernel B6: word-domain keep cut + compaction.

The JAX package derives sparse egress from the fabric's voted output
words in one jit: ``ops.decode_keep_words_device`` (trigger cut, lane
scores and SEU counters on sliced words) followed by
``parallel.compression.sparse_trigger_pack_words`` (popcount prefix-sum
compaction of the kept lanes). Both wrappers here launch
csrc/sparse_pack.cu on CUDA tensors and run a plain PyTorch twin on CPU
tensors; there is no fallback from one to the other:

* ``decode_pack`` — voted words, disagreement words, decode weights,
  cut and valid mask -> (count, idx, vals, dis), the two fused (counted
  in ``decode_pack.launches``); twin ``decode_pack_plain``.
* ``pack_keep_words`` — keep words + per-lane scores -> (count, idx,
  vals): ``sparse_trigger_pack_words`` alone, which the event-domain pack
  of the matmul layout runs (counted in ``pack_keep_words.launches``);
  twin ``pack_words_plain``.

Wire contract, bit for bit the reference's: ``count`` () int32 kept
events; ``idx`` (C*W*32,) int32 ascending flat indices ``w*32 + e`` of
chip-major words, -1 padded; ``vals`` (C*W*32,) int32 kept scores, 0
padded. Nothing synchronises with the host: ``count`` stays on the
device, and every output has a size fixed by the shapes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_eval.bitsliced import WORD, popcount

MAX_REPLICAS = 32

Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pack_words_plain(keep_w: torch.Tensor, scores: torch.Tensor) -> Packed:
    """Plain twin of the keep-words entry: (C, W) int32 keep words and
    (C, W, 32) int32 lane scores -> (count, idx, vals). The reference's
    algorithm: per-word popcounts, their exclusive cumsum as each word's
    base, a lane's rank as the popcount of the keep bits below it, and a
    scatter of the kept lanes into static-size buffers (dropped lanes
    aim at one spare slot past the end, which is cut off)."""
    C, W = keep_w.shape
    n = C * W * WORD
    dev = keep_w.device
    flat_kw = keep_w.reshape(C * W).to(torch.int64) & 0xFFFFFFFF
    counts = popcount(flat_kw).to(torch.int64)
    word_base = torch.cumsum(counts, 0) - counts
    count = torch.sum(counts).to(torch.int32)
    lane = torch.arange(WORD, dtype=torch.int64, device=dev)
    keep_bit = (flat_kw[:, None] >> lane) & 1                 # (CW, 32)
    rank = popcount(flat_kw[:, None] & ((1 << lane) - 1)).to(torch.int64)
    dest = torch.where(keep_bit == 1, word_base[:, None] + rank, n)
    flat_idx = torch.arange(C * W, dtype=torch.int64, device=dev)[:, None] \
        * WORD + lane
    idx = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    idx.scatter_(0, dest.reshape(-1), flat_idx.reshape(-1).to(torch.int32))
    vals = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    vals.scatter_(0, dest.reshape(-1), scores.reshape(-1).to(torch.int32))
    return count, idx[:n], vals[:n]


def decode_pack_plain(voted_w, dis_w, out_weight, threshold_raw, valid
                      ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of the decode entry: ``decode_keep_words_device`` then
    ``pack_words_plain`` -> (count, idx, vals, dis (C, R) int32)."""
    from repro_torch.kernels.lut_eval.ops import decode_keep_words_device

    keep_w, scores, dis = decode_keep_words_device(
        voted_w, dis_w, out_weight, threshold_raw, valid)
    return (*pack_words_plain(keep_w, scores), dis)


def _outputs(C: int, W: int, device):
    n = C * W * WORD
    return (torch.empty((), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device))


def _launch(voted, dis_w, out_weight, threshold, valid, keep_in, scores_in,
            scratch, count, idx, vals, dis, C, W, O, R, B) -> None:
    """One call of the C entry; a None array is passed as a null pointer
    (voted None selects the keep-words entry)."""
    lib = build.load("sparse_pack")
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    dev = (voted if voted is not None else keep_in).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.sparse_pack_launch(
        ptr(voted), ptr(dis_w), ptr(out_weight), ptr(threshold), ptr(valid),
        ptr(keep_in), ptr(scores_in), scratch.data_ptr(), count.data_ptr(),
        idx.data_ptr(), vals.data_ptr(), ptr(dis), C, W, O, R, B, stream)
    build.check(lib, code, "sparse_pack kernel")


def _check_cuda(tensors, dtypes, what: str) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: arrays must share one device")
    if any(t.dtype != d for t, d in zip(tensors, dtypes)):
        raise ValueError(f"{what}: expected dtypes "
                         f"{[str(d) for d in dtypes]}, got "
                         f"{[str(t.dtype) for t in tensors]}")


def decode_pack(
    voted_w: torch.Tensor,       # (C, W, O) int32 voted output words
    dis_w: torch.Tensor,         # (C, R, W) int32 disagreement words
    out_weight: torch.Tensor,    # (C, O) int32 two's-complement weights
    threshold_raw: torch.Tensor, # (C,) int32
    valid: torch.Tensor,         # (C, B) bool, W == ceil(B/32)
) -> Tuple[torch.Tensor, ...]:
    """Word-domain keep cut, SEU counters and compaction in one call:
    (count (), idx (C*W*32,), vals (C*W*32,), dis (C, R)) int32. CUDA
    tensors launch B6; CPU tensors run ``decode_pack_plain``."""
    C, W, O = voted_w.shape
    R = dis_w.shape[1]
    B = valid.shape[-1]
    if (tuple(dis_w.shape) != (C, R, W) or tuple(out_weight.shape) != (C, O)
            or tuple(threshold_raw.shape) != (C,)
            or tuple(valid.shape) != (C, B) or W != max(-(-B // WORD), 1)):
        raise ValueError(
            f"decode_pack shapes disagree: voted {tuple(voted_w.shape)}, "
            f"dis {tuple(dis_w.shape)}, out_weight {tuple(out_weight.shape)}"
            f", threshold {tuple(threshold_raw.shape)}, valid "
            f"{tuple(valid.shape)} (need W == ceil(B/32))")
    if voted_w.device.type == "cpu":
        return decode_pack_plain(voted_w, dis_w, out_weight, threshold_raw,
                                 valid)
    arrays = (voted_w, dis_w, out_weight, threshold_raw, valid)
    _check_cuda(arrays, (torch.int32,) * 4 + (torch.bool,), "decode_pack")
    if R > MAX_REPLICAS:
        raise ValueError(f"decode_pack takes at most {MAX_REPLICAS} "
                         f"replicas, got {R}")
    voted_w, dis_w, out_weight, threshold_raw, valid = (
        t.contiguous() for t in arrays)
    count, idx, vals = _outputs(C, W, voted_w.device)
    dis = torch.empty((C, R), dtype=torch.int32, device=voted_w.device)
    scratch = torch.empty((2 * C * W,), dtype=torch.int32,
                          device=voted_w.device)
    _launch(voted_w, dis_w, out_weight, threshold_raw, valid, None, None,
            scratch, count, idx, vals, dis, C, W, O, R, B)
    decode_pack.launches += 1
    return count, idx, vals, dis


decode_pack.launches = 0


def pack_keep_words(keep_w: torch.Tensor, scores: torch.Tensor) -> Packed:
    """Popcount prefix-sum compaction of (C, W) int32 keep words with
    (C, W, 32) int32 lane scores -> (count, idx, vals). CUDA tensors
    launch B6's keep-words entry; CPU tensors run ``pack_words_plain``."""
    C, W = keep_w.shape
    if tuple(scores.shape) != (C, W, WORD):
        raise ValueError(f"scores {tuple(scores.shape)} != (C, W, 32) = "
                         f"{(C, W, WORD)}")
    if keep_w.device.type == "cpu":
        return pack_words_plain(keep_w, scores)
    _check_cuda((keep_w, scores), (torch.int32, torch.int32),
                "pack_keep_words")
    keep_w, scores = keep_w.contiguous(), scores.contiguous()
    count, idx, vals = _outputs(C, W, keep_w.device)
    scratch = torch.empty((max(C * W, 1),), dtype=torch.int32,
                          device=keep_w.device)
    _launch(None, None, None, None, None, keep_w, scores, scratch, count,
            idx, vals, None, C, W, 0, 0, 0)
    pack_keep_words.launches += 1
    return count, idx, vals


pack_keep_words.launches = 0
