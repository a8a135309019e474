"""Bit-sliced LUT evaluation: 32 events per 32-bit word (torch port).

Bit ``e`` of word ``w`` is event ``w*32 + e``; every 4-LUT is a 15-op
bitwise mux tree over whole words:

    r_j = (s0 & t[2j+1]) | (~s0 & t[2j])        j = 0..7   (select on in0)
    q_j = (s1 & r[2j+1]) | (~s1 & r[2j])        j = 0..3   (select on in1)
    p_j = (s2 & q[2j+1]) | (~s2 & q[2j])        j = 0..1   (select on in2)
    out =  s3 ? p1 : p0                                    (select on in3)

with each truth-table entry broadcast to an all-ones / all-zeros word. The
TMR vote is the per-bit identity (a&b)|(a&c)|(b&c) on the same words.

Word representation: int32 tensors holding the uint32 bit pattern (this
torch build has no ``~``, ``>>``, ``<<`` or gather for uint32 on the CPU).
Bitwise ``&``, ``|``, ``^`` and ``~`` are the same on both; a right shift
of an int32 is arithmetic, so every shift here is masked to the bits it
keeps.

``eval_seg_voted`` is the kernel wrapper: the level walk, vote and
disagreement words in one kernel call (csrc/bitsliced.cu: a descriptor
pass, then the walk; on an envelope too deep for one block under TMR a
walk a replica and a vote pass; on one whose descriptors do not fit
beside a word's net buffer, a walk that streams them level by level,
``walk_path``) on CUDA tensors, the plain twin ``eval_seg_voted_plain``
on CPU tensors.

Array contract (the ``layout="bitsliced"`` packing, ops.py):
  src         (R*C, L, M, 4)  int32 — per-LUT source nets in the padded
                                      net layout; padded slots read net 0
  tables      (R*C, L, M, 16) f32   — the scrub-loop truth-table image
  output_nets (R*C, O)        int32 — const0-padded gather indices
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.tmr import N_REPLICAS, majority_vote_words
from repro_torch.kernels import build

WORD = 32
MAX_TILE = 32
# the walk's forms, in the order ``walk_path`` tries them
FORMS = ("staged", "split", "streamed")
# levels of descriptors a streamed walk block holds (csrc/bitsliced.cu
# kRing)
RING = 4


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """Event-transpose: (..., B, n) 0/1 bits -> (..., W, n) int32 words.

    W = ceil(B/32) (at least 1). The 32 shifted bits are disjoint powers
    of two, summed in int64 (no overflow), then values >= 2**31 are mapped
    to their two's-complement int32 explicitly.
    """
    B = bits.shape[-2]
    W = max(-(-B // WORD), 1)
    pad = W * WORD - B
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    b = b.reshape(b.shape[:-2] + (W, WORD, b.shape[-1]))
    shifts = torch.arange(WORD, dtype=torch.int64, device=b.device)[:, None]
    v = torch.sum(b << shifts, dim=-2)
    v = torch.where(v >= 2**31, v - 2**32, v)
    return v.to(torch.int32)


def unpack_words(words: torch.Tensor, n_events: int) -> torch.Tensor:
    """Inverse event-transpose: (..., W, n) int32 -> (..., B, n) uint8.
    Tail lanes (events >= n_events) are dropped."""
    W = words.shape[-2]
    shifts = torch.arange(WORD, dtype=torch.int32,
                          device=words.device)[:, None]
    b = (words[..., None, :] >> shifts) & 1     # masked: shift sign is moot
    b = b.reshape(words.shape[:-2] + (W * WORD, words.shape[-1]))
    return b[..., :n_events, :].to(torch.uint8)


def input_words(bits: torch.Tensor, n_inputs: int, in_seg: int) -> torch.Tensor:
    """(C, B, n_inputs) event bits -> (C, W, in_seg) input-segment words.

    Column 0 is const0, column 1 const1 (all ones, tail lanes included),
    columns 2..2+n_inputs the transposed input bits."""
    words = pack_words(bits)                                # (C, W, n_in)
    C, W = words.shape[0], words.shape[1]
    seg = torch.zeros((C, W, in_seg), dtype=torch.int32, device=bits.device)
    seg[:, :, 1] = -1
    seg[:, :, 2 : 2 + n_inputs] = words
    return seg


def eval_words(
    src: torch.Tensor,          # (C, L, M, 4) int32
    tables: torch.Tensor,       # (C, L, M, 16) f32 (0.0/1.0)
    output_nets: torch.Tensor,  # (C, O) int32
    in_words: torch.Tensor,     # (C, W, in_seg) int32
) -> torch.Tensor:
    """Levelized word evaluation in torch ops: (C, W, O) int32 words.

    The net buffer is [const0 | const1 | inputs | level 0 slots | ...];
    each level gathers its 4 source words per LUT and runs the mux tree.
    """
    C, W, in_seg = in_words.shape
    L, M = src.shape[1], src.shape[2]
    vals = torch.zeros((C, W, in_seg + L * M), dtype=torch.int32,
                       device=in_words.device)
    vals[:, :, :in_seg] = in_words
    tbl = torch.where(tables > 0.5, -1, 0).to(torch.int32)  # (C, L, M, 16)
    for l in range(L):
        idx = src[:, l].reshape(C, 1, M * 4).expand(C, W, M * 4).long()
        g = torch.gather(vals, 2, idx).reshape(C, W, M, 4)
        t = tbl[:, l][:, None]                              # (C, 1, M, 16)
        for k in range(4):
            s = g[:, :, :, k : k + 1]                       # (C, W, M, 1)
            t = (s & t[..., 1::2]) | (~s & t[..., 0::2])
        base = in_seg + l * M
        vals[:, :, base : base + M] = t[..., 0]
    O = output_nets.shape[-1]
    out_idx = output_nets[:, None, :].long().expand(C, W, O)
    return torch.gather(vals, 2, out_idx)


def eval_seg_voted_plain(
    src: torch.Tensor,
    tables: torch.Tensor,
    output_nets: torch.Tensor,
    seg: torch.Tensor,          # (C, W, in_seg) — per LOGICAL chip
    n_replicas: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the kernel: (voted (C, W, O), dis (C, R, W)) int32."""
    C, W = seg.shape[0], seg.shape[1]
    if n_replicas == 1:
        out_w = eval_words(src, tables, output_nets, seg)
        return out_w, torch.zeros((C, 1, W), dtype=torch.int32,
                                  device=seg.device)
    assert n_replicas == N_REPLICAS, n_replicas
    rep = torch.repeat_interleave(seg, n_replicas, dim=0)   # (R*C, W, seg)
    out_w = eval_words(src, tables, output_nets, rep)       # (R*C, W, O)
    O = out_w.shape[2]
    g = out_w.reshape(C, n_replicas, W, O)
    voted_w = majority_vote_words(g[:, 0], g[:, 1], g[:, 2])  # (C, W, O)
    diff = g ^ voted_w[:, None]                             # (C, R, W, O)
    dis_w = torch.zeros((C, n_replicas, W), dtype=torch.int32,
                        device=seg.device)
    for j in range(O):
        dis_w = dis_w | diff[..., j]
    return voted_w, dis_w


def _chip_desc_bytes(n_replicas: int, n_levels: int, m_pad: int) -> int:
    """One chip's descriptors in the kernel's layout: 8 bytes of source
    nets and 2 of mask a LUT, each array padded to 16 bytes."""
    n = n_replicas * n_levels * m_pad
    return -(-n // 2) * 2 * 8 + -(-n // 8) * 8 * 2


def _block_bytes(block_replicas: int, in_seg: int, n_levels: int,
                 m_pad: int, tile: int) -> int:
    """Dynamic shared memory of a walk block that holds ``block_replicas``
    replicas (csrc/bitsliced.cu block_smem): their descriptors for every
    level, the net buffer of ``tile`` words (the input segment once, then
    each replica's level slots) and the disagreement words."""
    n_tot = in_seg + block_replicas * n_levels * m_pad
    return (_chip_desc_bytes(block_replicas, n_levels, m_pad)
            + tile * n_tot * 4 + block_replicas * tile * 4)


def _level_stride(m_pad: int) -> int:
    """LUT slots a level takes in the streamed walk's descriptor layout:
    ``m_pad`` rounded up to whole 16-byte pieces of masks."""
    return -(-m_pad // 8) * 8


def _streamed_block_bytes(in_seg: int, n_levels: int, m_pad: int,
                          tile: int) -> int:
    """Dynamic shared memory of a streamed walk block (csrc/bitsliced.cu
    streamed_smem): a ring of RING levels' descriptors and masks, and the
    net buffer of ``tile`` words (the input segment, then one replica's
    level slots)."""
    return (RING * _level_stride(m_pad) * 10
            + tile * (in_seg + n_levels * m_pad) * 4)


def _form_bytes(form: str, n_replicas: int, in_seg: int, n_levels: int,
                m_pad: int, tile: int) -> int:
    """A block's dynamic shared memory on walk form ``form``."""
    if form == "streamed":
        return _streamed_block_bytes(in_seg, n_levels, m_pad, tile)
    rb = n_replicas if form == "staged" else 1
    return _block_bytes(rb, in_seg, n_levels, m_pad, tile)


def walk_path(n_replicas: int, in_seg: int, n_levels: int,
              m_pad: int) -> str:
    """Which form of the walk takes this envelope, the first of FORMS
    whose block for one word fits in shared memory: ``"staged"`` (a block
    holds every replica of a chip), ``"split"`` (under TMR, a block per
    replica, then a vote pass), ``"streamed"`` (a block per replica that
    holds only the net buffer and streams each level's descriptors from
    the scratch; under TMR the split walk's vote pass). Raises ValueError
    when none fits."""
    sizes = {}
    for form in FORMS:
        if form == "split" and n_replicas == 1:
            continue        # one replica a block: the staged block
        sizes[form] = _form_bytes(form, n_replicas, in_seg, n_levels,
                                  m_pad, 1)
        if sizes[form] <= build.SMEM_LIMIT_BYTES:
            return form
    raise ValueError(
        f"one word's block ({n_levels} levels x {m_pad} LUTs, in_seg "
        f"{in_seg}, {n_replicas} replicas: "
        + ", ".join(f"{k} {v} B" for k, v in sizes.items())
        + f") exceeds {build.SMEM_LIMIT_BYTES} B of shared memory")


def scratch_bytes(n_chips: int, n_replicas: int, n_levels: int,
                  m_pad: int) -> int:
    """The descriptor scratch one launch rebuilds (csrc/bitsliced.cu
    eval_words_voted_scratch_bytes and
    eval_words_streamed_scratch_bytes): of ``n_chips`` chips of every
    replica (the staged walk), of their replica rows one by one (the
    split walk) or of those rows with each level at the streamed walk's
    stride, whichever is largest."""
    rows = n_chips * n_replicas
    return max(n_chips * _chip_desc_bytes(n_replicas, n_levels, m_pad),
               rows * _chip_desc_bytes(1, n_levels, m_pad),
               rows * n_levels * _level_stride(m_pad) * 10)


def smem_bytes(n_replicas: int, in_seg: int, n_levels: int, m_pad: int,
               tile: int) -> int:
    """Dynamic shared memory of a block of the walk that ``walk_path``
    picks for this envelope, at ``tile`` words."""
    return _form_bytes(walk_path(n_replicas, in_seg, n_levels, m_pad),
                       n_replicas, in_seg, n_levels, m_pad, tile)


def word_tile(n_replicas: int, in_seg: int, n_levels: int, m_pad: int,
              n_words: int, n_chips: int = 1, n_sms: int = 1) -> int:
    """Words per block of the walk that ``walk_path`` picks: as many as
    ``smem_bytes`` fit in shared memory, at most MAX_TILE, and no more
    than leaves every one of ``n_sms`` SMs a block of the grid (``n_chips``
    rows on the staged walk, ``n_chips`` x ``n_replicas`` on the others,
    of ``n_words`` words)."""
    form = walk_path(n_replicas, in_seg, n_levels, m_pad)
    fit = 1
    while fit < MAX_TILE and _form_bytes(
            form, n_replicas, in_seg, n_levels, m_pad,
            fit + 1) <= build.SMEM_LIMIT_BYTES:
        fit += 1
    rows = n_chips * (1 if form == "staged" else n_replicas)
    spread = -(-rows * n_words // n_sms)
    return max(1, min(fit, n_words, spread))


def split_buffers(n_chips: int, n_replicas: int, n_words: int,
                  n_outputs: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-replica output words (R*C, W, O) of the split and streamed
    walks under TMR and the split walk's (zero) disagreement words
    (R*C, 1, W), int32."""
    rows = n_chips * n_replicas
    return (torch.empty((rows, n_words, n_outputs), dtype=torch.int32,
                        device=device),
            torch.empty((rows, 1, n_words), dtype=torch.int32,
                        device=device))


def _launch(src, tables, output_nets, seg, scratch, voted, dis, R,
            tile, rep=None) -> None:
    """Both (staged; streamed at R=1) or all three (split; streamed under
    TMR) passes on the current stream. ``rep`` is ``split_buffers``'
    pair, needed on the split walk and on the streamed walk under TMR
    (made here when not given)."""
    lib = build.load("bitsliced")
    C, W, in_seg = seg.shape
    L, M, O = src.shape[1], src.shape[2], output_nets.shape[1]
    ptrs = (seg.data_ptr(), src.data_ptr(), tables.data_ptr(),
            output_nets.data_ptr(), scratch.data_ptr())
    form = walk_path(R, in_seg, L, M)
    if form != "staged" and R > 1:
        rep = rep or split_buffers(C, R, W, O, seg.device)
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        if form == "staged":
            code = lib.eval_words_voted_launch(
                *ptrs, voted.data_ptr(), dis.data_ptr(), C, R, W, in_seg, L,
                M, O, tile, stream)
        elif form == "split":
            code = lib.eval_words_split_launch(
                *ptrs, rep[0].data_ptr(), rep[1].data_ptr(),
                voted.data_ptr(), dis.data_ptr(), C, R, W, in_seg, L, M, O,
                tile, stream)
        else:
            code = lib.eval_words_streamed_launch(
                *ptrs, rep[0].data_ptr() if R > 1 else None,
                voted.data_ptr(), dis.data_ptr(), C, R, W, in_seg, L, M, O,
                tile, stream)
    build.check(lib, code, f"bitsliced {form} walk kernel")


def scratch_for(n_chips: int, n_replicas: int, n_levels: int, m_pad: int,
                device) -> torch.Tensor:
    """The descriptor scratch of one launch (int32, 16-byte aligned as
    torch allocates)."""
    n = scratch_bytes(n_chips, n_replicas, n_levels, m_pad)
    return torch.empty(-(-n // 4), dtype=torch.int32, device=device)


def eval_seg_voted(
    src: torch.Tensor,
    tables: torch.Tensor,
    output_nets: torch.Tensor,
    seg: torch.Tensor,
    n_replicas: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level walk + vote + disagreement words over input-segment words:
    (voted (C, W, O) int32, dis (C, R, W) int32; zeros for R=1). CUDA
    tensors launch the kernel (counted in ``eval_seg_voted.launches``),
    in the form ``walk_path`` picks from the envelope;
    CPU tensors run ``eval_seg_voted_plain``. Either way the launch
    signature (C, R, W, in_seg, L, M, O) is recorded first (the word tile
    is a function of it)."""
    C, W, in_seg = seg.shape
    R = n_replicas
    if R not in (1, N_REPLICAS):
        raise ValueError(f"n_replicas must be 1 or {N_REPLICAS}, got {R}")
    if src.shape[0] != R * C or tables.shape[0] != R * C \
            or output_nets.shape[0] != R * C:
        raise ValueError(
            f"stack rows {src.shape[0]}/{tables.shape[0]}/"
            f"{output_nets.shape[0]} != n_replicas*chips = {R * C}")
    L, M, O = src.shape[1], src.shape[2], output_nets.shape[1]
    build.note_signature("eval_words_voted", (C, R, W, in_seg, L, M, O),
                         seg.device)
    if seg.device.type == "cpu":
        return eval_seg_voted_plain(src, tables, output_nets, seg, R)
    if any(t.device != seg.device for t in (src, tables, output_nets)):
        raise ValueError("stack arrays and input words must share a device")
    if (src.dtype, tables.dtype, output_nets.dtype, seg.dtype) != (
            torch.int32, torch.float32, torch.int32, torch.int32):
        raise ValueError("expected int32 src/output_nets/words, f32 tables")
    n_sms = torch.cuda.get_device_properties(seg.device).multi_processor_count
    tile = word_tile(R, in_seg, L, M, W, C, n_sms)
    src, tables = build.aligned(src), build.aligned(tables)
    output_nets, seg = output_nets.contiguous(), seg.contiguous()
    voted = torch.empty((C, W, O), dtype=torch.int32, device=seg.device)
    dis = torch.empty((C, R, W), dtype=torch.int32, device=seg.device)
    _launch(src, tables, output_nets, seg,
            scratch_for(C, R, L, M, seg.device), voted, dis, R, tile)
    eval_seg_voted.launches += 1
    return voted, dis


eval_seg_voted.launches = 0


def eval_words_voted(
    src: torch.Tensor,
    tables: torch.Tensor,
    output_nets: torch.Tensor,
    bits: torch.Tensor,         # (C, B, n_inputs) — per LOGICAL chip
    *,
    n_replicas: int,
    n_inputs: int,
    in_seg: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Redundant evaluation stopped in the word domain: (voted output
    words (C, W, O), per-replica disagreement words (C, R, W)), bit ``e``
    of a disagreement word set iff that replica's output differs from the
    vote for event ``w*32+e``."""
    seg = input_words(bits, n_inputs, in_seg)
    return eval_seg_voted(src, tables, output_nets, seg, n_replicas)


def eval_bits_voted(
    src: torch.Tensor,
    tables: torch.Tensor,
    output_nets: torch.Tensor,
    bits: torch.Tensor,         # (C, B, n_inputs)
    *,
    n_replicas: int,
    n_inputs: int,
    in_seg: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(voted (C, B, O) uint8, disagree (C, R, B) bool)."""
    return unpack_voted(*eval_words_voted(
        src, tables, output_nets, bits,
        n_replicas=n_replicas, n_inputs=n_inputs, in_seg=in_seg),
        bits.shape[1])


def unpack_voted(voted_w: torch.Tensor, dis_w: torch.Tensor,
                 n_events: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voted words (C, W, O) and disagreement words (C, R, W) back to
    event order: (voted (C, B, O) uint8, disagree (C, R, B) bool)."""
    voted = unpack_words(voted_w, n_events)
    dis = unpack_words(dis_w[..., None], n_events)[..., 0].to(torch.bool)
    return voted, dis


def eval_bits(
    src: torch.Tensor,
    tables: torch.Tensor,
    output_nets: torch.Tensor,
    bits: torch.Tensor,         # (C, B, n_inputs)
    *,
    n_inputs: int,
    in_seg: int,
) -> torch.Tensor:
    """One replica per chip, no vote: (C, B, O) uint8."""
    voted, _ = eval_bits_voted(src, tables, output_nets, bits, n_replicas=1,
                               n_inputs=n_inputs, in_seg=in_seg)
    return voted


# ------------------------------------------- word-domain sparse egress
# The trigger cut, the SEU disagreement counters and the lane scores, all
# on sliced words, so dropped events are never transposed back to event
# order (kernels/sparse_pack compacts the kept lanes; csrc/sparse_pack.cu
# fuses this tail with the compaction on the card).

_SIGN = -2**31                  # 0x80000000 as an int32 bit pattern


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its uint32 pattern), as int32: a
    SWAR popcount in int64, where no shift drags the sign along."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def mask_words(mask: torch.Tensor) -> torch.Tensor:
    """(..., B) bool event mask -> (..., W) int32 mask words (bit ``e`` of
    word ``w`` = mask[w*32+e]; tail lanes past B are 0)."""
    return pack_words(mask.to(torch.int32)[..., None])[..., 0]


def sign_extended_planes(
    voted_w: torch.Tensor,      # (C, W, O) int32 output words
    out_weight: torch.Tensor,   # (C, O) int32 two's-complement weights
) -> torch.Tensor:
    """The 32 bit-planes of every lane's int32 score, still as words:
    (C, W, 32) int32, plane ``j`` holding bit ``j`` of each event's
    score. Every plane at or above the sign position (the first negative
    weight) replicates that output word: two's-complement sign extension.
    A chip with no negative weight reads output word 0 for every plane,
    as the reference's ``argmax`` of an all-False row does."""
    C, W, _ = voted_w.shape
    sign_pos = torch.argmax((out_weight < 0).to(torch.int32), dim=-1)
    j = torch.arange(WORD, device=voted_w.device)[None, None, :]
    idx = torch.minimum(j, sign_pos[:, None, None]).expand(C, W, WORD)
    return torch.gather(voted_w, 2, idx)


def keep_words(
    planes: torch.Tensor,        # (C, W, 32) sign-extended score planes
    threshold_raw: torch.Tensor, # (C,) int32
    valid_w: torch.Tensor,       # (C, W) int32 valid-lane words
) -> torch.Tensor:
    """The trigger cut ``score <= threshold`` in the word domain: flip the
    sign plane of both sides (biased unsigned), then an MSB-down (lt, eq)
    sweep, 32 lanes at a time. Returns (C, W) int32 keep words masked by
    ``valid_w``."""
    C, W = valid_w.shape
    thr_u = threshold_raw.to(torch.int32) ^ _SIGN                 # (C,)
    lt = torch.zeros((C, W), dtype=torch.int32, device=valid_w.device)
    eq = torch.full((C, W), -1, dtype=torch.int32, device=valid_w.device)
    for j in range(WORD - 1, -1, -1):
        a = planes[..., j]
        if j == WORD - 1:
            a = ~a                          # bias flip of the sign plane
        t = -((thr_u >> j) & 1)[:, None]    # all ones where the bit is 1
        lt = lt | (eq & ~a & t)
        eq = eq & ~(a ^ t)
    return (lt | eq) & valid_w


def lane_scores(planes: torch.Tensor) -> torch.Tensor:
    """(C, W, 32) score planes -> (C, W, 32) int32 per-lane scores: a
    32x32 bit transpose per word, lane ``e`` assembling bit ``e`` of every
    plane (summed in int64, wrapped to int32 as the reference's uint32)."""
    lane = torch.arange(WORD, dtype=torch.int32, device=planes.device)
    b = ((planes[..., None] >> lane) & 1).to(torch.int64)  # (C, W, 32j, 32e)
    s = torch.sum(b << lane.to(torch.int64)[:, None], dim=-2)
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def disagree_counts_words(
    dis_w: torch.Tensor,        # (C, R, W) int32 disagreement words
    valid_w: torch.Tensor,      # (C, W) int32
) -> torch.Tensor:
    """Per-replica voted-against event counts over valid lanes: popcount
    and sum over the words. Returns (C, R) int32."""
    return torch.sum(popcount(dis_w & valid_w[:, None]), dim=-1).to(
        torch.int32)
