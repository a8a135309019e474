"""Selection-matmul fabric evaluation, dense and banded (torch port).

The matmul layout of the JAX package's kernels/lut_eval/lut_eval.py. A
chip's net values live in one (B, N) f32 buffer, N the segmented padded
net count ``[const0 | const1 | inputs | pad | level 0 | level 1 | ...]``;
per level l:

    ins = V_l @ sel[l]                     (B, rows) x (rows, 4M) 0/1
    idx = ins[:, 0:M] + 2 ins[:, M:2M] + 4 ins[:, 2M:3M] + 8 ins[:, 3M:4M]
    V[:, level_base[l] : level_base[l] + M] = tables[l][m, idx]   (0 if idx
                                                  is outside [0, 16))

where ``V_l`` is the row view of the routing product: the whole buffer
for a dense stack (rows == N), or the input segment followed by the
K-level window ``[win_base[l], win_base[l] + K*M)`` for a banded one
(rows == in_seg + K*M). Levels before the window's written prefix read
zero-initialized columns whose selection rows are all zero, so the buffer
is zeroed before the first level.

``lut_eval_stacked`` / ``lut_eval_banded_stacked`` are the kernel
wrappers: on CUDA tensors they launch csrc/lut_eval.cu (one source for
both; a null window pointer selects the dense row view) and count the
launch; on CPU tensors they run the plain twins below. The C=1 forms
``lut_eval`` / ``lut_eval_banded`` slice the stacked ones.

The kernel does not multiply: ``sel`` is a one-hot selection (the
packing writes exactly one 1 in each column of a real LUT input and none
in a padded slot), so a first pass lists, per (chip, level, column), the
rows holding a 1 (``LIST_CAP`` of them, and a count), and the main pass
sums the buffer values at those rows from shared memory. A column with
more ones than ``LIST_CAP``, or an entry other than 0/1, is summed by
walking ``sel`` itself, so the result is the product for any ``sel``.
Exactness contract: with 0/1 buffer values (0/1 ``bits_ext`` and
``tables``, as the packing makes them) every column sum is a small
integer, exact in float32 in any order, so the kernel's buffer equals
``lut_eval_plain``'s bit for bit (``torch.equal``) for any 0/1 ``sel``.

Array contract (the ``layout="matmul"`` packing, ops.py):
  bits_ext   (C, B, in_seg)   f32  — [const0, const1, inputs, 0-pad]
  sel        (C, L, rows, 4M) bf16 — 0/1 selection
  tables     (C, L, M, 16)    f32  — the scrub-loop truth-table image
  level_base (L,)             int32 — write offset per level
  win_base   (L,)             int32 — banded window read offset per level
  -> (C, B, N) f32, the whole net buffer.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

TILES = (32, 16, 8, 4)
# rows listed per selection column by the kernel's first pass (kCap in
# csrc/lut_eval.cu; the launch refuses another value)
LIST_CAP = 4


def lut_eval_plain(
    bits_ext: torch.Tensor,
    sel: torch.Tensor,
    tables: torch.Tensor,
    level_base: torch.Tensor,
    win_base: Optional[torch.Tensor] = None,
    *,
    n_nets_pad: int,
) -> torch.Tensor:
    """Plain twin of both kernels (``win_base=None``: the dense row view).

    The routing product runs in float32 (0/1 operands and sums below
    2**24 are exact in any order); the table read is a gather where the
    reference sums a 16-way one-hot, the same value for 0/1 tables."""
    C, B, in_seg = bits_ext.shape
    L, rows, M4 = sel.shape[1], sel.shape[2], sel.shape[3]
    M = M4 // 4
    band_m = rows - in_seg
    vals = torch.zeros((C, B, n_nets_pad), dtype=torch.float32,
                       device=bits_ext.device)
    vals[:, :, :in_seg] = bits_ext.to(torch.float32)
    bases = level_base.tolist()
    wins = None if win_base is None else win_base.tolist()
    for l in range(L):
        if wins is None:
            v_l = vals
        else:
            w = wins[l]
            v_l = torch.cat([vals[:, :, :in_seg], vals[:, :, w : w + band_m]],
                            dim=2)
        ins = torch.bmm(v_l, sel[:, l].to(torch.float32)).reshape(C, B, 4, M)
        idx = (ins[:, :, 0] + 2.0 * ins[:, :, 1] + 4.0 * ins[:, :, 2]
               + 8.0 * ins[:, :, 3]).to(torch.int32)            # (C, B, M)
        ok = (idx >= 0) & (idx < 16)
        tbl = tables[:, l][:, None].expand(C, B, M, 16)
        got = torch.gather(tbl, 3, (idx * ok)[..., None].long())[..., 0]
        vals[:, :, bases[l] : bases[l] + M] = torch.where(
            ok, got, torch.zeros_like(got))
    return vals


def smem_bytes(n_nets: int, m_pad: int, tile: int) -> int:
    """Shared memory of one block: the net buffer and the result staging
    ((N + M) x tile f32), and two level stages of tables (M x 16 f32),
    column lists (4M x LIST_CAP int32) and counts (4M int32)."""
    stage = 16 * m_pad + 4 * m_pad * LIST_CAP + 4 * m_pad
    return ((n_nets + m_pad) * tile + 2 * stage) * 4


def lut_tile(n_nets: int, m_pad: int, n_events: int, n_chips: int = 1,
             n_sms: int = 1) -> int:
    """Events per block: the largest of TILES whose ``smem_bytes`` fit in
    shared memory and that still gives every one of ``n_sms`` SMs a
    block; else the smallest that fits."""
    fits = [t for t in TILES
            if smem_bytes(n_nets, m_pad, t) <= build.SMEM_LIMIT_BYTES]
    if not fits:
        raise ValueError(
            f"a {TILES[-1]}-event block ({n_nets} nets, m_pad {m_pad}: "
            f"{smem_bytes(n_nets, m_pad, TILES[-1])} B) exceeds "
            f"{build.SMEM_LIMIT_BYTES} B of shared memory")
    for t in fits:
        if n_chips * -(-n_events // t) >= n_sms:
            return t
    return fits[-1]


def _launch(bits_ext, sel, tables, level_base, win_base, out, tile) -> None:
    """Both passes: the column lists (scratch from ``torch.empty``), then
    the evaluation into ``out``."""
    lib = build.load("lut_eval")
    C, B, in_seg = bits_ext.shape
    L, rows, M = sel.shape[1], sel.shape[2], sel.shape[3] // 4
    lists = torch.empty((C, L, 4 * M, LIST_CAP), dtype=torch.int32,
                        device=bits_ext.device)
    counts = torch.empty((C, L, 4 * M), dtype=torch.int32,
                         device=bits_ext.device)
    with torch.cuda.device(bits_ext.device):
        stream = torch.cuda.current_stream(bits_ext.device).cuda_stream
        code = lib.lut_eval_launch(
            bits_ext.data_ptr(), sel.data_ptr(), tables.data_ptr(),
            level_base.data_ptr(),
            None if win_base is None else win_base.data_ptr(),
            lists.data_ptr(), counts.data_ptr(), out.data_ptr(), C, B,
            in_seg, L, rows, M, out.shape[2], tile, LIST_CAP, stream)
    build.check(lib, code, "lut_eval kernel")


def _check(bits_ext, sel, tables, level_base, win_base, n_nets_pad) -> None:
    C, B, in_seg = bits_ext.shape
    if sel.ndim != 4 or sel.shape[0] != C or sel.shape[3] % 4:
        raise ValueError(f"sel must be (C={C}, L, rows, 4M), got "
                         f"{tuple(sel.shape)}")
    L, rows, M = sel.shape[1], sel.shape[2], sel.shape[3] // 4
    if tuple(tables.shape) != (C, L, M, 16):
        raise ValueError(f"tables {tuple(tables.shape)} != {(C, L, M, 16)}")
    if tuple(level_base.shape) != (L,) or (
            win_base is not None and tuple(win_base.shape) != (L,)):
        raise ValueError("level_base / win_base must be (L,)")
    if win_base is None and rows != n_nets_pad:
        raise ValueError(f"dense sel has {rows} rows, not n_nets_pad="
                         f"{n_nets_pad}")
    if win_base is not None and not in_seg < rows <= n_nets_pad:
        raise ValueError(f"banded sel rows {rows} must lie in "
                         f"(in_seg={in_seg}, n_nets_pad={n_nets_pad}]")


def _run(bits_ext, sel, tables, level_base, win_base, n_nets_pad):
    """Check, record the launch signature (C, B, in_seg, L, rows, M,
    n_nets_pad) under the dense or banded kernel's name, and evaluate:
    the kernel on CUDA tensors, the plain twin on CPU ones."""
    _check(bits_ext, sel, tables, level_base, win_base, n_nets_pad)
    kernel = "lut_eval" if win_base is None else "lut_eval_banded"
    C, B, in_seg = bits_ext.shape
    L, rows, M = sel.shape[1], sel.shape[2], sel.shape[3] // 4
    build.note_signature(kernel, (C, B, in_seg, L, rows, M, n_nets_pad),
                         bits_ext.device)
    if bits_ext.device.type == "cpu":
        return lut_eval_plain(bits_ext, sel, tables, level_base, win_base,
                              n_nets_pad=n_nets_pad)
    arrays = [bits_ext, sel, tables, level_base] + (
        [] if win_base is None else [win_base])
    if any(t.device != bits_ext.device for t in arrays):
        raise ValueError("lut_eval arrays must share one device")
    want = [torch.float32, torch.bfloat16, torch.float32, torch.int32,
            torch.int32]
    if any(t.dtype != d for t, d in zip(arrays, want)):
        raise ValueError("expected f32 bits_ext/tables, bf16 sel, int32 "
                         "level_base/win_base")
    if M % 2 or n_nets_pad % 4:
        raise ValueError(f"the kernel reads sel rows and writes buffer "
                         f"rows in 16-byte units: M must be even and "
                         f"n_nets_pad a multiple of 4, got M={M}, "
                         f"n_nets_pad={n_nets_pad}")
    n_sms = torch.cuda.get_device_properties(
        bits_ext.device).multi_processor_count
    tile = lut_tile(n_nets_pad, M, B, C, n_sms)
    out = torch.empty((C, B, n_nets_pad), dtype=torch.float32,
                      device=bits_ext.device)
    _launch(build.aligned(bits_ext), build.aligned(sel),
            build.aligned(tables), level_base.contiguous(),
            None if win_base is None else win_base.contiguous(), out, tile)
    return out


def lut_eval_stacked(
    bits_ext: torch.Tensor,
    sel: torch.Tensor,
    tables: torch.Tensor,
    level_base: torch.Tensor,
    *,
    n_nets_pad: int,
) -> torch.Tensor:
    """Chip-batched dense evaluation: (C, B, N) f32 net buffer. CUDA
    tensors launch the kernel (counted in ``lut_eval_stacked.launches``);
    CPU tensors run ``lut_eval_plain``."""
    out = _run(bits_ext, sel, tables, level_base, None, n_nets_pad)
    if out.device.type == "cuda":
        lut_eval_stacked.launches += 1
    return out


lut_eval_stacked.launches = 0


def lut_eval_banded_stacked(
    bits_ext: torch.Tensor,
    sel: torch.Tensor,
    tables: torch.Tensor,
    level_base: torch.Tensor,
    win_base: torch.Tensor,
    *,
    n_nets_pad: int,
) -> torch.Tensor:
    """Chip-batched banded evaluation, same contract as
    ``lut_eval_stacked`` with a (C, L, in_seg + K*M, 4M) ``sel``. CUDA
    tensors launch the kernel (counted in
    ``lut_eval_banded_stacked.launches``)."""
    out = _run(bits_ext, sel, tables, level_base, win_base, n_nets_pad)
    if out.device.type == "cuda":
        lut_eval_banded_stacked.launches += 1
    return out


lut_eval_banded_stacked.launches = 0


def lut_eval(bits_ext, sel, tables, level_base, *, n_nets_pad: int
             ) -> torch.Tensor:
    """Single-chip dense evaluation: (B, in_seg) -> (B, N) f32."""
    return lut_eval_stacked(bits_ext[None], sel[None], tables[None],
                            level_base, n_nets_pad=n_nets_pad)[0]


def lut_eval_banded(bits_ext, sel, tables, level_base, win_base, *,
                    n_nets_pad: int) -> torch.Tensor:
    """Single-chip banded evaluation: (B, in_seg) -> (B, N) f32."""
    return lut_eval_banded_stacked(bits_ext[None], sel[None], tables[None],
                                   level_base, win_base,
                                   n_nets_pad=n_nets_pad)[0]
