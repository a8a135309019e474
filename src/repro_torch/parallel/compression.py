"""At-source compression before the expensive link: the sparse trigger
readout on the server's host link, and the int8 gradient reduction across
pods (the port of the JAX package's parallel/compression.py).

Gradients: ``quantized_psum`` sums each rank's partial over a process
group with an int8 wire format: every rank's absmax-quantized int8 leaf
and its one float32 scale are all-gathered, then dequantized and summed
locally in rank order (an int8 sum would overflow).
``make_compressed_value_and_grad`` runs it over the "pod" dim of a
``DeviceMesh``: each pod computes the grads of its own slice of the
batch, and the pods' grads cross the pod link as int8. Error: absmax
int8 has per-element error <= scale/2 = max|g| / 254 a pod.

Trigger: the keep/drop cut runs on
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

from typing import Any, Callable, Tuple

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


# ------------------------------------------- int8 gradient all-reduce
# elements of a leaf that one slice of the int8 sum dequantizes
_SLICE = 1 << 24


def quantized_psum_leaf(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` (this rank's partial, a plain tensor) over the ranks of
    ``group`` (a ProcessGroup) with an int8 wire format: the int8 leaves
    and the float32 scales are all-gathered, then dequantized and added
    in rank order in float32 and cast back to x's dtype. The sum walks
    the leaf in slices of ``_SLICE`` elements, so its float32 transients
    stay a slice in size."""
    import torch.distributed._functional_collectives as funcol

    q, s = quantize_int8(x)
    qs = funcol.all_gather_tensor(q.reshape(1, -1), 0, group)
    ss = funcol.all_gather_tensor(s.reshape(1), 0, group)
    del q
    acc = torch.empty(x.numel(), dtype=torch.float32, device=x.device)
    for lo in range(0, max(x.numel(), 1), _SLICE):
        sl = slice(lo, lo + _SLICE)
        acc[sl] = qs[0, sl].to(torch.float32) * ss[0]
        for r in range(1, qs.shape[0]):
            acc[sl] += qs[r, sl].to(torch.float32) * ss[r]
    return acc.reshape(x.shape).to(x.dtype)


def quantized_psum(tree: Any, group) -> Any:
    """``quantized_psum_leaf`` over every leaf of a dict tree."""
    from repro_torch.train import tree as T

    return T.map_leaves(lambda x: quantized_psum_leaf(x, group), tree)


def _strip_pod(spec):
    parts = []
    for s in spec:
        if isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a != "pod")
            parts.append(kept if len(kept) > 1 else (kept[0] if kept
                                                     else None))
        else:
            parts.append(None if s == "pod" else s)
    return tuple(parts)


def make_compressed_value_and_grad(loss_fn: Callable, mesh,
                                   batch_spec_tree: Any,
                                   grad_specs: Any = None) -> Callable:
    """``vag(params, batch) -> (loss, grads)`` with the grads reduced over
    the mesh's "pod" dim in int8 (``quantized_psum``), then divided by the
    pod count; the loss is the pods' mean.

    ``params`` are DTensors on ``mesh`` replicated over "pod" (or plain
    tensors, the same on every rank), ``batch`` DTensors placed by
    ``batch_spec_tree``, whose batch dim must include "pod". Each pod
    computes ``value_and_grad`` of its own slice of the batch on the
    intra-pod dims ("data", "model"); ``grad_specs`` (the ZeRO-2 specs,
    "pod" stripped) pin the pod's partial grads to their shards before
    they cross the pod link, else they are reduced to the params'
    placements. The results are DTensors on ``mesh``, replicated over
    "pod"."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel import sharding as shd
    from repro_torch.train import tree as T
    from repro_torch.train.train_step import value_and_grad

    names = shd.axis_names(mesh)
    if "pod" not in names:
        raise ValueError("compressed grad reduction needs a 'pod' mesh axis")
    n_pod = shd.axis_sizes(mesh)["pod"]
    pod_dim = names.index("pod")
    inner = tuple(a for a in names if a != "pod")
    inner_mesh = mesh[inner] if inner else None
    pod_group = mesh.get_group("pod")
    vag = value_and_grad(loss_fn)

    def to_inner(x):
        """This rank's pod slice of x: a DTensor on the intra-pod mesh (a
        plain tensor is replicated there), or its local tensor when the
        mesh has no other dim."""
        if isinstance(x, DTensor):
            local = x.to_local()
            pl = [p for i, p in enumerate(x.placements) if i != pod_dim]
        else:
            local, pl = x, [Replicate()] * len(inner)
        if inner_mesh is None:
            return local
        return DTensor.from_local(local, inner_mesh, pl, run_check=False)

    def pin(g, p, spec):
        """The pod's partial grad reduced inside the pod to its shard."""
        if inner_mesh is None:
            return g
        pl = (shd.placements(inner_mesh, _strip_pod(spec))
              if spec is not None else p.placements)
        return g.redistribute(inner_mesh, pl)

    def to_outer(summed, g):
        if inner_mesh is None:
            pl = [Replicate()]
        else:
            pl = list(g.placements)
            pl.insert(pod_dim, Replicate())
        return DTensor.from_local(summed, mesh, pl, run_check=False,
                                  shape=g.shape, stride=g.stride())

    def vag_pod(params, batch):
        p_in = T.map_leaves(to_inner, params)
        loss, grads = vag(p_in, T.map_leaves(to_inner, batch))
        keys, parts = zip(*T.items(grads))
        del grads
        parts = list(parts)
        specs = (T.leaves(grad_specs) if grad_specs is not None
                 else [None] * len(parts))
        out = []
        for i, (p, spec) in enumerate(zip(T.leaves(p_in), specs)):
            # a leaf at a time, its pod partial dropped once reduced
            g = pin(parts[i], p, spec)
            parts[i] = None
            local = g.to_local() if isinstance(g, DTensor) else g
            summed = quantized_psum_leaf(local, pod_group)  # int8 on the wire
            out.append(to_outer(summed.div_(n_pod), g))     # pod mean
            del g, local, summed
        grads = T.unflatten(keys, out)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        loss = funcol.all_reduce(loss, "sum", pod_group) / n_pod
        return DTensor.from_local(loss, mesh, [Replicate()] * len(names),
                                  run_check=False), grads

    return vag_pod
