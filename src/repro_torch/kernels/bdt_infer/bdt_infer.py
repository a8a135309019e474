"""Node-parallel quantized BDT inference: the kernel wrapper (torch port).

The JAX package's kernels/bdt_infer/bdt_infer.py evaluates a tree
ensemble with one-hot products instead of pointer chasing. All trees
traverse at once over one padded node axis P (block-diagonal child
matrices, leaves and padding self-loop):

    fval = sum_f x[:, f] * featsel[f, :]          (B, P) int32, wrapping
    cond = fval <= thr                             (B, P)
    h    = root                                    one-hot per tree
    depth times:  h = (h*cond) @ left + (h - h*cond) @ right    float32
    out  = (int(h @ value_hi) << 14) + int(h @ value_lo)        (B, 128)

Leaf values are split into 14-bit halves so that the float32 products
stay integer-exact (|value_raw| < 2**27). ``bdt_traverse`` launches
csrc/bdt_infer.cu on CUDA tensors (counted in ``bdt_traverse.launches``)
and runs the plain twin ``bdt_traverse_plain`` on CPU tensors. The
kernel walks each event down its trees where the arrays are in the
one-hot form the packing makes, and runs these products literally where
they are not; either way it equals the twin bit for bit.

Array contract (ops.pack_ensemble):
  x        (B, F)    int32 raw fixed-point features
  featsel  (F, P)    int32 0/1
  thr      (1, P)    int32 (int32 max on leaves and padding)
  root     (1, P)    f32 one-hot of every tree's root
  left, right (P, P) f32 0/1
  value_hi, value_lo (P, 128) f32, column 0 set
  -> (B, 128) int32; column 0 is the sum of the trees' leaf values.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

OUT_COLS = 128
# events per block (multiples of the kernel's 8-event literal sub-tile)
TILES = (128, 64, 32, 16, 8)
# blocks per SM the tile rule aims for (8 warps each; 4 fit at once)
BLOCKS_PER_SM = 3
# scratch the launch rebuilds: a 16-byte table entry and a meta word a node
SCRATCH_BYTES_PER_NODE = 20


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def bdt_traverse_plain(x, featsel, thr, root, left, right, value_hi,
                       value_lo, *, depth: int) -> torch.Tensor:
    """Plain twin of the kernel: (B, F) int32 -> (B, 128) int32. The
    feature MAC runs in int64 and keeps the low 32 bits, as the
    reference's wrapping int32 sum does."""
    B = x.shape[0]
    P = featsel.shape[1]
    xs = x.to(torch.int64)
    fs = featsel.to(torch.int64)
    fval = torch.zeros((B, P), dtype=torch.int64, device=x.device)
    for f in range(x.shape[1]):
        fval = fval + xs[:, f : f + 1] * fs[f : f + 1, :]
    cond = (_wrap_int32(fval) <= thr).to(torch.float32)
    h = root.to(torch.float32).expand(B, P)
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    for _ in range(depth):
        go_l = h * cond
        go_r = h - go_l
        h = go_l @ left + go_r @ right
    hi = (h @ value_hi.to(torch.float32)).to(torch.int64)
    lo = (h @ value_lo.to(torch.float32)).to(torch.int64)
    return _wrap_int32((hi << 14) + lo)


def smem_bytes(n_nodes: int, n_features: int, tile: int) -> int:
    """Dynamic shared memory of a block of ``tile`` events
    (csrc/bdt_infer.cu bdt_infer_smem_bytes): the larger of the literal
    body's 4 x P x 8 f32 and the walk's node table, segments, roots, root
    bits and the tile's features."""
    walk = 24 * n_nodes + 4 * -(-n_nodes // 32) + 4 * tile * n_features
    return max(walk, 4 * n_nodes * 8 * 4)


def bdt_tile(n_nodes: int, n_features: int, n_events: int,
             n_sms: int = 1) -> int:
    """Events per block: the largest of TILES whose ``smem_bytes`` fit
    and that still gives every one of ``n_sms`` SMs BLOCKS_PER_SM blocks,
    else the smallest that fits."""
    fits = [t for t in TILES if smem_bytes(n_nodes, n_features, t)
            <= build.SMEM_LIMIT_BYTES]
    if not fits:
        raise ValueError(
            f"a {TILES[-1]}-event block ({n_nodes} padded nodes, "
            f"{n_features} features: "
            f"{smem_bytes(n_nodes, n_features, TILES[-1])} B) exceeds "
            f"{build.SMEM_LIMIT_BYTES} B of shared memory")
    for t in fits:
        if -(-n_events // t) >= BLOCKS_PER_SM * n_sms:
            return t
    return fits[-1]


def _launch(x, featsel, thr, root, left, right, value_hi, value_lo,
            scratch, out, depth, tile) -> None:
    lib = build.load("bdt_infer")
    B, F = x.shape
    P = featsel.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.bdt_infer_launch(
            x.data_ptr(), featsel.data_ptr(), thr.data_ptr(),
            root.data_ptr(), left.data_ptr(), right.data_ptr(),
            value_hi.data_ptr(), value_lo.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), B, F, P, depth, tile, stream)
    build.check(lib, code, "bdt_infer kernel")


def scratch_for(n_nodes: int, device) -> torch.Tensor:
    """The node-table scratch one launch rebuilds (int32, 16-byte
    aligned as torch allocates)."""
    return torch.empty(SCRATCH_BYTES_PER_NODE * n_nodes // 4,
                       dtype=torch.int32, device=device)


def bdt_traverse(x, featsel, thr, root, left, right, value_hi, value_lo,
                 *, depth: int) -> torch.Tensor:
    """(B, F) int32 raw features -> (B, 128) int32 (column 0: the sum of
    leaf values, no f0). CUDA tensors launch the kernel; CPU tensors run
    ``bdt_traverse_plain``. The launch signature (B, F, P, depth) is
    recorded first, on either."""
    B, F = x.shape
    P = featsel.shape[1]
    shapes = {"featsel": (featsel, (F, P)), "thr": (thr, (1, P)),
              "root": (root, (1, P)), "left": (left, (P, P)),
              "right": (right, (P, P)),
              "value_hi": (value_hi, (P, OUT_COLS)),
              "value_lo": (value_lo, (P, OUT_COLS))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    build.note_signature("bdt_infer", (B, F, P, depth), x.device)
    if x.device.type == "cpu":
        return bdt_traverse_plain(x, featsel, thr, root, left, right,
                                  value_hi, value_lo, depth=depth)
    arrays = [x, featsel, thr, root, left, right, value_hi, value_lo]
    if any(t.device != x.device for t in arrays):
        raise ValueError("bdt_infer arrays must share one device")
    want = [torch.int32] * 3 + [torch.float32] * 5
    if any(t.dtype != d for t, d in zip(arrays, want)):
        raise ValueError("expected int32 x/featsel/thr, f32 root/left/"
                         "right/value_hi/value_lo")
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile = bdt_tile(P, F, B, n_sms)
    out = torch.empty((B, OUT_COLS), dtype=torch.int32, device=x.device)
    _launch(*[build.aligned(t) for t in arrays], scratch_for(P, x.device),
            out, depth, tile)
    bdt_traverse.launches += 1
    return out


bdt_traverse.launches = 0
