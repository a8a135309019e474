"""Sparse trigger egress and its dense twin, kernel B6.

The JAX package derives the served results from the fabric's voted
output words in one jit: sparse, ``ops.decode_keep_words_device``
(trigger cut, lane scores and SEU counters on sliced words) followed by
``parallel.compression.sparse_trigger_pack_words`` (popcount prefix-sum
compaction of the kept lanes); dense, ``bitsliced.unpack_words`` followed
by ``ops.decode_scores_device``. The three wrappers here each make ONE
launch of csrc/sparse_pack.cu on CUDA tensors and run a plain PyTorch
twin on CPU tensors; there is no fallback from one to the other:

* ``decode_pack`` — voted words, disagreement words, decode weights, cut
  and valid mask -> (count, idx, vals, dis), the two fused (counted in
  ``decode_pack.launches``); twin ``decode_pack_plain``.
* ``pack_keep_words`` — keep words + per-lane scores -> (count, idx,
  vals): ``sparse_trigger_pack_words`` alone, which the event-domain pack
  of the matmul layout runs (counted in ``pack_keep_words.launches``);
  twin ``pack_words_plain``.
* ``decode_dense`` — the same inputs as ``decode_pack`` -> (score (C, B)
  int32, keep (C, B) bool, dis (C, R) int32) in event order (counted in
  ``decode_dense.launches``); twin ``decode_dense_plain``, today's torch
  chain.

Wire contract of the sparse entries, bit for bit the reference's:
``count`` () int32 kept events; ``idx`` (C*W*32,) int32 ascending flat
indices ``w*32 + e`` of chip-major words, -1 padded; ``vals`` (C*W*32,)
int32 kept scores, 0 padded. Nothing synchronises with the host:
``count`` stays on the device, and every output has a size fixed by the
shapes.

Every launch is a programmatic dependent of the kernel before it on the
stream, which it waits for before it touches memory. The kernel's
look-back scan and SEU counters keep a persistent state for each device
and stream (``_state``): zeroed once when it is allocated, left zero by
every launch, so the launches that share it are ordered by their stream.
A captured CUDA graph keeps its capture stream's state: make one call at
the largest shape on that stream before capturing
(``torch.cuda.graph(g, stream=s)``), and do not replay the graph while
launches on that stream, or another replay of it, run.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_eval.bitsliced import WORD, popcount, unpack_voted

MAX_REPLICAS = 32
# csrc/sparse_pack.cu: words a block, and the status word's value bits
TILE_WORDS = 64
MAX_SLOTS = 2**30 - 1
# the state a device starts with: enough for about 2**22 words (134M
# events)
STATE_WORDS_MIN = 1 << 16

Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# (device, CUDA stream handle) -> that stream's state
_STATE: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# states outgrown, kept alive: a captured graph may still point at one
_RETIRED: List[torch.Tensor] = []


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


def decode_dense_plain(voted_w, dis_w, out_weight, threshold_raw, valid
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of the dense entry, the torch chain it replaces: the
    words back to event order (``unpack_words``), then
    ``decode_scores_device`` -> (score (C, B) int32, keep (C, B) bool,
    dis (C, R) int32)."""
    from repro_torch.kernels.lut_eval.ops import decode_scores_device

    return decode_scores_device(*unpack_voted(voted_w, dis_w,
                                              valid.shape[-1]),
                                out_weight, threshold_raw, valid)


def state_words(C: int, R: int, W: int) -> int:
    """uint32 words of state one launch uses (csrc/sparse_pack.cu
    sparse_pack_state_words): done, C*R counters, a status a tile."""
    return 1 + C * R + max(-(-C * W // TILE_WORDS), 1)


def _state(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The persistent kernel state of a stream of the device (its CUDA
    handle), at least ``n`` words, zero. It grows by a fresh zeroed
    buffer (a fill kernel, once), never while a CUDA graph is being
    captured."""
    key = (device, stream)
    st = _STATE.get(key)
    if st is None or st.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "B6's state must grow outside CUDA graph capture: call "
                "the wrapper once at this shape on the capture stream "
                "before capturing")
        old = 0
        if st is not None:
            _RETIRED.append(st)
            old = st.numel()
        st = torch.zeros((max(n, STATE_WORDS_MIN, 2 * old),),
                         dtype=torch.int32, device=device)
        _STATE[key] = st
    return st


def _check_cuda(tensors, dtypes, what: str) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: arrays must share one device")
    if any(t.dtype != d for t, d in zip(tensors, dtypes)):
        raise ValueError(f"{what}: expected dtypes "
                         f"{[str(d) for d in dtypes]}, got "
                         f"{[str(t.dtype) for t in tensors]}")


def _decode_inputs(voted_w, dis_w, out_weight, threshold_raw, valid,
                   what: str):
    """Shapes (C, W, O, R, B) of a decode call, checked."""
    C, W, O = voted_w.shape
    R = dis_w.shape[1]
    B = valid.shape[-1]
    if (tuple(dis_w.shape) != (C, R, W) or tuple(out_weight.shape) != (C, O)
            or tuple(threshold_raw.shape) != (C,)
            or tuple(valid.shape) != (C, B) or W != max(-(-B // WORD), 1)):
        raise ValueError(
            f"{what} shapes disagree: voted {tuple(voted_w.shape)}, "
            f"dis {tuple(dis_w.shape)}, out_weight {tuple(out_weight.shape)}"
            f", threshold {tuple(threshold_raw.shape)}, valid "
            f"{tuple(valid.shape)} (need W == ceil(B/32))")
    return C, W, O, R, B


def _cuda_decode_arrays(arrays, R: int, what: str):
    """The decode arrays contiguous on their card."""
    _check_cuda(arrays, (torch.int32,) * 4 + (torch.bool,), what)
    if R > MAX_REPLICAS:
        raise ValueError(f"{what} takes at most {MAX_REPLICAS} replicas, "
                         f"got {R}")
    return tuple(t.contiguous() for t in arrays)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_pack(voted, dis_w, out_weight, threshold, valid, keep_in,
                scores_in, count, idx, vals, dis, C, W, O, R, B) -> None:
    """One launch of the sparse entry (voted None selects keep-words; a
    None array is a null pointer) into the given outputs."""
    lib = build.load("sparse_pack")
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    dev = idx.device
    with torch.cuda.device(dev):
        stream = _stream(dev)
        st = _state(dev, stream,
                    state_words(C, R if voted is not None else 0, W))
        code = lib.sparse_pack_launch(
            ptr(voted), ptr(dis_w), ptr(out_weight), ptr(threshold),
            ptr(valid), ptr(keep_in), ptr(scores_in), st.data_ptr(),
            count.data_ptr(), idx.data_ptr(), vals.data_ptr(), ptr(dis), C,
            W, O, R, B, st.numel(), stream)
    build.check(lib, code, "sparse_pack kernel")


def launch_dense(voted, dis_w, out_weight, threshold, valid, score, keep,
                 dis, C, W, O, R, B) -> None:
    """One launch of the dense entry into the given outputs."""
    lib = build.load("sparse_pack")
    with torch.cuda.device(voted.device):
        stream = _stream(voted.device)
        st = _state(voted.device, stream, state_words(C, R, W))
        code = lib.decode_dense_launch(
            voted.data_ptr(), dis_w.data_ptr(), out_weight.data_ptr(),
            threshold.data_ptr(), valid.data_ptr(), st.data_ptr(),
            score.data_ptr(), keep.data_ptr(), dis.data_ptr(), C, W, O, R,
            B, st.numel(), stream)
    build.check(lib, code, "sparse_pack dense kernel")


def _outputs(C: int, W: int, device):
    n = C * W * WORD
    if n > MAX_SLOTS:
        raise ValueError(f"B6 packs at most {MAX_SLOTS} events, got {n}")
    return (torch.empty((), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device))


def decode_pack(
    voted_w: torch.Tensor,       # (C, W, O) int32 voted output words
    dis_w: torch.Tensor,         # (C, R, W) int32 disagreement words
    out_weight: torch.Tensor,    # (C, O) int32 two's-complement weights
    threshold_raw: torch.Tensor, # (C,) int32
    valid: torch.Tensor,         # (C, B) bool, W == ceil(B/32)
) -> Tuple[torch.Tensor, ...]:
    """Word-domain keep cut, SEU counters and compaction in one launch:
    (count (), idx (C*W*32,), vals (C*W*32,), dis (C, R)) int32. CUDA
    tensors launch B6; CPU tensors run ``decode_pack_plain``."""
    C, W, O, R, B = _decode_inputs(voted_w, dis_w, out_weight,
                                   threshold_raw, valid, "decode_pack")
    build.note_signature("sparse_pack_decode", (C, W, O, R, B),
                         voted_w.device)
    if voted_w.device.type == "cpu":
        return decode_pack_plain(voted_w, dis_w, out_weight, threshold_raw,
                                 valid)
    arrays = _cuda_decode_arrays(
        (voted_w, dis_w, out_weight, threshold_raw, valid), R, "decode_pack")
    count, idx, vals = _outputs(C, W, voted_w.device)
    dis = torch.empty((C, R), dtype=torch.int32, device=voted_w.device)
    launch_pack(*arrays, None, None, count, idx, vals, dis, C, W, O, R, B)
    decode_pack.launches += 1
    return count, idx, vals, dis


decode_pack.launches = 0


def pack_keep_words(keep_w: torch.Tensor, scores: torch.Tensor) -> Packed:
    """Popcount prefix-sum compaction of (C, W) int32 keep words with
    (C, W, 32) int32 lane scores -> (count, idx, vals), one launch. CUDA
    tensors launch B6's keep-words entry; CPU tensors run
    ``pack_words_plain``."""
    C, W = keep_w.shape
    if tuple(scores.shape) != (C, W, WORD):
        raise ValueError(f"scores {tuple(scores.shape)} != (C, W, 32) = "
                         f"{(C, W, WORD)}")
    build.note_signature("sparse_pack_keep_words", (C, W), keep_w.device)
    if keep_w.device.type == "cpu":
        return pack_words_plain(keep_w, scores)
    _check_cuda((keep_w, scores), (torch.int32, torch.int32),
                "pack_keep_words")
    if W < 1:
        raise ValueError("pack_keep_words needs at least one word a row")
    keep_w, scores = keep_w.contiguous(), scores.contiguous()
    count, idx, vals = _outputs(C, W, keep_w.device)
    launch_pack(None, None, None, None, None, keep_w, scores, count, idx,
                vals, None, C, W, 0, 0, 0)
    pack_keep_words.launches += 1
    return count, idx, vals


pack_keep_words.launches = 0


def decode_dense(
    voted_w: torch.Tensor,       # (C, W, O) int32 voted output words
    dis_w: torch.Tensor,         # (C, R, W) int32 disagreement words
    out_weight: torch.Tensor,    # (C, O) int32 weights, any values
    threshold_raw: torch.Tensor, # (C,) int32
    valid: torch.Tensor,         # (C, B) bool, W == ceil(B/32)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score every event of the words in one launch: (score (C, B) int32
    = the sum of output bit o times ``out_weight[:, o]`` with int32 wrap,
    keep (C, B) bool = score <= cut on valid events, dis (C, R) int32
    disagreements over valid events). CUDA tensors launch B6's dense
    entry; CPU tensors run ``decode_dense_plain``."""
    C, W, O, R, B = _decode_inputs(voted_w, dis_w, out_weight,
                                   threshold_raw, valid, "decode_dense")
    build.note_signature("decode_dense", (C, W, O, R, B), voted_w.device)
    if voted_w.device.type == "cpu":
        return decode_dense_plain(voted_w, dis_w, out_weight, threshold_raw,
                                  valid)
    arrays = _cuda_decode_arrays(
        (voted_w, dis_w, out_weight, threshold_raw, valid), R,
        "decode_dense")
    dev = voted_w.device
    score = torch.empty((C, B), dtype=torch.int32, device=dev)
    keep = torch.empty((C, B), dtype=torch.bool, device=dev)
    dis = torch.empty((C, R), dtype=torch.int32, device=dev)
    launch_dense(*arrays, score, keep, dis, C, W, O, R, B)
    decode_dense.launches += 1
    return score, keep, dis


decode_dense.launches = 0
