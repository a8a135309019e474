"""Fused readout frontend on the device: frames -> features -> bits -> score.

    frames (C, B, T, Y, X) + y0 (C, B)
      -> yprofile                 (CUDA kernel, kernels/yprofile)
      -> ap_fixed quantize        (core/quantize device path, int32)
      -> offset-binary bit gather (per-chip encode plan, below)
      -> fabric evaluation        (selection-matmul kernel + TMR vote, or
                                   the bit-sliced kernel with the vote
                                   folded in)
      -> score decode + keep/drop (two's-complement weights, int32 cut;
                                   sparse: the word-domain cut and the
                                   compaction of the kept events, kernel
                                   B6 on the bit-sliced walk's words)

No stage materializes on the host: the feature tensor, the bit tensor and
the net words live and die on the device; the host sees only the (C, B)
scores and keep mask, or (sparse) the kept events' packed (index, score)
pairs and their count, and the (C, R) disagreement counts. Calls return
without synchronising (launches are asynchronous on the current stream).

Everything per chip — which features feed which input bit, the
fixed-point spec, the output decode weights, the trigger cut — is a
(C, ...) tensor row of the encode plan, so a hot-swap is a row update:
input bit j of chip c is bit ``bit_idx[c, j]`` of feature
``feat_idx[c, j]``'s offset-binary pattern (zero where j >= n_inputs_c).
The chip axis is the leading tensor dimension of one device's tensors;
on a device plan of several slabs (``pack_frontend(mesh=)``, a
``SlabFrontend``) each slab is a ``FusedFrontend`` of its own chips on
its own device: its stack rows, plan rows and staging buffers, and its
launches, there. The readout server dispatches the slabs one by one and
merges their results on the host at its drain.

Staging: a dispatch's input is its real rows (``FrameRows``): each
chip's events, chip-major and contiguous, with the per-chip counts; a
padded (C, B, ...) array is the case where every count is B. Each chip's
rows are copied into a preallocated padded device buffer (a slab's, on
its device), reused while the padded shape stays the same (the readout
server pads batch widths to powers of two, so the set of shapes is
small); the rows past a chip's count are zeroed and marked invalid on the
device, so the kernels read the same padded buffers whatever was staged
before. Reuse is safe across in-flight dispatches because every copy and
kernel runs in order on one stream. The readout server stages from a
``StagingRing`` of pinned host buffers: the copies are asynchronous, and
a CUDA event recorded behind them guards the ring slot until they have
landed, so the host fills the next slot while the device copies.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fabric import FabricConfig, FrontendSpec, StackGeometry
from repro_torch.core.quantize import (
    FixedSpec,
    quantize_pattern_device,
    spec_device_params,
)
from repro_torch.data.smartpixel import N_T, N_X, N_Y
from repro_torch.device import resolve_device
from repro_torch.kernels.lut_eval import ops as lut_ops
from repro_torch.kernels.yprofile import ops as yp_ops
from repro_torch.stages import SPANS, Stages


@dataclasses.dataclass(frozen=True)
class ChipFrontendSpec:
    """Per-chip encode/decode contract of the fused frontend.

    used_features: feature indices feeding the fabric, in input-bus order
        (SynthResult.used_features).
    spec: the chip's ap_fixed grid (int32-representable, W <= 31).
    threshold_raw: integer-domain trigger cut — keep iff score <= cut.
    """

    used_features: Tuple[int, ...]
    spec: FixedSpec
    threshold_raw: int


def default_frontend_spec(threshold_electrons: float = 800.0) -> FrontendSpec:
    """The smart-pixel featurizer contract (13 y-profile bins + y0)."""
    return FrontendSpec(
        n_features=yp_ops.N_FEATURES,
        frame_shape=(N_T, N_Y, N_X),
        threshold_electrons=threshold_electrons,
    )


def validate_chip_frontend(config: FabricConfig, cs: ChipFrontendSpec,
                           n_features: int) -> None:
    """Named, fail-fast check that a chip is encodable from the
    featurizer's output, raised at pack/swap time."""
    W = cs.spec.width
    if W > 31:
        raise ValueError(
            f"fused frontend quantizes in int32: spec width {W} > 31")
    if len(cs.used_features) * W != config.n_inputs:
        raise ValueError(
            f"encode plan mismatch: {len(cs.used_features)} used features x "
            f"W={W} bits != config n_inputs={config.n_inputs}")
    if cs.used_features and max(cs.used_features) >= n_features:
        raise ValueError(
            f"chip reads feature {max(cs.used_features)} but the featurizer "
            f"produces only {n_features}")
    if len(config.output_nets) > 31:
        raise ValueError(
            "fused frontend decodes scores in int32: "
            f"{len(config.output_nets)} output bits > 31")


def _plan_row(
    config: FabricConfig, cs: ChipFrontendSpec, J: int, O: int,
) -> Dict[str, np.ndarray]:
    """One chip's encode-plan row, zero-padded to the stack envelope."""
    W = cs.spec.width
    n_in = len(cs.used_features) * W
    assert n_in <= J and len(config.output_nets) <= O
    feat = np.zeros(J, np.int32)
    bit = np.zeros(J, np.int32)
    valid = np.zeros(J, np.int32)
    j = np.arange(n_in)
    if n_in:
        feat[:n_in] = np.asarray(cs.used_features, np.int64)[j // W]
        bit[:n_in] = j % W
        valid[:n_in] = 1
    weight = np.zeros(O, np.int64)
    n_out = len(config.output_nets)
    weight[:n_out] = 1 << np.arange(n_out)
    if n_out:
        weight[n_out - 1] = -(1 << (n_out - 1))  # two's-complement sign bit
    row = {"feat_idx": feat, "bit_idx": bit, "bit_valid": valid,
           "out_weight": weight.astype(np.int32),
           "threshold_raw": np.int32(cs.threshold_raw)}
    row.update(spec_device_params(cs.spec))
    return row


_PLAN_KEYS = ("feat_idx", "bit_idx", "bit_valid", "out_weight",
              "threshold_raw", "scale", "rnd_off", "wrap_mask", "sign_bit",
              "sat_lo", "sat_hi")


def encode_bits(feats: torch.Tensor, plan: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """Stages 2-3: (C, B, 128) features -> (C, B, J) int32 0/1 input bits
    (quantize every feature column to its chip's offset-binary pattern,
    then gather bit ``bit_idx`` of feature ``feat_idx`` per input)."""
    c1 = lambda a: a[:, None, None]                      # noqa: E731
    u = quantize_pattern_device(
        feats, scale=c1(plan["scale"]), rnd_off=c1(plan["rnd_off"]),
        wrap_mask=c1(plan["wrap_mask"]), sign_bit=c1(plan["sign_bit"]),
        sat_lo=c1(plan["sat_lo"]), sat_hi=c1(plan["sat_hi"]))
    C, B = u.shape[0], u.shape[1]
    J = plan["feat_idx"].shape[1]
    idx = plan["feat_idx"][:, None, :].long().expand(C, B, J)
    taken = torch.gather(u, 2, idx)
    # patterns are < 2**31 (W <= 31), so the arithmetic shift is logical
    return ((taken >> plan["bit_idx"][:, None, :]) & 1) \
        * plan["bit_valid"][:, None, :]


def score_features(
    feats: torch.Tensor,                # (C, B, 128) f32
    stack: lut_ops.PackedFabricStack,
    plan: Dict[str, torch.Tensor],
    valid: torch.Tensor,                # (C, B) bool
    *,
    sparse: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Stages 2-5 from device features: (score (C, B) int32, keep (C, B)
    bool, disagree counts (C, R) int32). ``sparse=True`` (bit-sliced
    stacks) stays in the word domain after the bit gather — the fabric
    kernel's words go to kernel B6 — and returns (count, idx, vals, dis)
    over flat indices ``chip*B + event``."""
    return lut_ops._eval_stack_scored(
        stack, encode_bits(feats, plan), plan["out_weight"],
        plan["threshold_raw"], valid, sparse=sparse)


def _score_frames_impl(
    frames: torch.Tensor,       # (C, B, T, Y, X) f32
    y0: torch.Tensor,           # (C, B) f32
    stack: lut_ops.PackedFabricStack,
    plan: Dict[str, torch.Tensor],
    valid: torch.Tensor,        # (C, B) bool — kills padded event rows
    *,
    threshold_electrons: float,
    sparse: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The fused body: featurize (stage 1) then ``score_features``."""
    feats = yp_ops.yprofile_traced(frames, y0, threshold=threshold_electrons)
    return score_features(feats, stack, plan, valid, sparse=sparse)


@dataclasses.dataclass(frozen=True)
class FrameRows:
    """A dispatch's real frame rows, chip-major: chip i's ``counts[i]``
    events are rows ``offsets[i]`` on of ``frames`` (N, T, Y, X) and
    ``y0`` (N,), float32 tensors; ``width`` is the dispatch's batch width,
    at least every count. ``events`` is the host buffer's guard (a
    ``StagingRing`` slot's list): every slab that copies out of it to a
    CUDA device records an event there behind its copies. None: nothing
    to guard."""

    frames: torch.Tensor
    y0: torch.Tensor
    counts: Tuple[int, ...]
    offsets: Tuple[int, ...]
    width: int
    events: Optional[List] = None

    @classmethod
    def padded(cls, frames, y0) -> "FrameRows":
        """A padded (C, B, T, Y, X) + (C, B) dispatch: every chip's count
        is B."""
        f = torch.as_tensor(frames, dtype=torch.float32)
        z = torch.as_tensor(y0, dtype=torch.float32)
        C, B = f.shape[0], f.shape[1]
        return cls(f.reshape(C * B, *f.shape[2:]), z.reshape(C * B),
                   (B,) * C, tuple(i * B for i in range(C)), B)

    def chips(self, c0: int, n: int) -> "FrameRows":
        """The rows of chips [c0, c0 + n) (a slab's), the same buffer."""
        return dataclasses.replace(self, counts=self.counts[c0 : c0 + n],
                                   offsets=self.offsets[c0 : c0 + n])


class StagingRing:
    """Reused host buffers for dispatches' frame rows: ``n_slots`` slots
    taken in turn, each a (frames (cap, T, Y, X), y0 (cap,)) float32 pair,
    page-locked when ``pinned`` (copies out of it then run asynchronously)
    and grown to the next power of two of rows a dispatch needs.

    A slot is refilled only once the copies out of it have landed:
    ``take`` waits on the CUDA events recorded behind them, timed as
    ``stack_frames.ring_wait`` on ``stages`` when one has not completed.
    With more slots than dispatches in flight, a fill never waits."""

    def __init__(self, n_slots: int, *, pinned: bool):
        self.pinned = pinned
        self._slots: List[Optional[FrameRows]] = [None] * n_slots
        self._next = 0

    def take(self, counts: Sequence[int], width: int,
             stages: Stages = SPANS) -> FrameRows:
        """The next slot, free to refill, laid out for ``counts`` rows a
        chip (chip-major, no gaps) at batch width ``width``."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        n_rows = int(sum(counts))
        if slot is not None:
            if not all(ev.query() for ev in slot.events):
                with stages.time("stack_frames.ring_wait"):
                    for ev in slot.events:
                        ev.synchronize()
            slot.events.clear()
        if slot is None or len(slot.frames) < n_rows:
            cap = 1 << (max(n_rows, 1) - 1).bit_length()
            slot = FrameRows(
                torch.empty((cap, N_T, N_Y, N_X), dtype=torch.float32,
                            pin_memory=self.pinned),
                torch.empty((cap,), dtype=torch.float32,
                            pin_memory=self.pinned),
                (), (), 0, [])
            self._slots[i] = slot
        counts = tuple(int(n) for n in counts)
        return dataclasses.replace(
            slot, counts=counts, width=int(width),
            offsets=tuple(itertools.accumulate(counts[:-1], initial=0)))


def _as_rows(frames, y0) -> FrameRows:
    return frames if isinstance(frames, FrameRows) else FrameRows.padded(
        frames, y0)


@dataclasses.dataclass(frozen=True)
class FusedFrontend:
    """N configured chips' whole frontends, one asynchronous dispatch.

    Built by ``pack_frontend``. ``score_frames*`` return device tensors
    without synchronising; the readout server keeps batches in flight and
    materializes them late.
    """

    stack: lut_ops.PackedFabricStack
    chip_specs: Tuple[ChipFrontendSpec, ...]
    plan: Dict[str, torch.Tensor]       # (C, ...) encode plan on device
    batch_tile: int
    threshold_electrons: float
    # padded (C, B) -> reusable device staging buffers (frames, y0, valid)
    staging: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = (
        dataclasses.field(default_factory=dict, compare=False, repr=False))

    @property
    def n_chips(self) -> int:
        return self.stack.n_chips

    @property
    def n_replicas(self) -> int:
        """TMR replica rows per chip (1 = no redundancy)."""
        return self.stack.n_replicas

    @property
    def device(self) -> torch.device:
        return self.stack.device

    @property
    def spec(self) -> FrontendSpec:
        return default_frontend_spec(self.threshold_electrons)

    def score_frames(self, frames, y0) -> Tuple[torch.Tensor, torch.Tensor]:
        """(C, B, T, Y, X) charge + (C, B) y0 -> ((C, B) int32 raw scores,
        (C, B) bool keep), decoded from the voted output on a TMR stack."""
        score, keep, _ = self.score_frames_voted(frames, y0)
        return score, keep

    def score_frames_voted(
        self, frames, y0=None, valid=None, *, stages: Stages = SPANS
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Like ``score_frames`` plus disagree_counts (C, n_replicas) int32:
        events (among ``valid`` rows; None = every chip's real rows) where
        that replica's output word was voted against. ``frames`` is the
        padded (C, B, T, Y, X) charge with ``y0`` (C, B), or a dispatch's
        ``FrameRows`` (``y0`` None); results are (C, width). The staging
        copies are timed as ``launch_fused.h2d`` on ``stages``."""
        rows = _as_rows(frames, y0)
        f, z, v = self._stage(rows, valid, stages)
        score, keep, dis = _score_frames_impl(
            f, z, self.stack, self.plan, v,
            threshold_electrons=self.threshold_electrons)
        return score[:, :rows.width], keep[:, :rows.width], dis

    def score_frames_sparse(
        self, frames, y0=None, valid=None, *, stages: Stages = SPANS
    ) -> Tuple[torch.Tensor, ...]:
        """Word-domain sparse egress form of ``score_frames_voted``
        (bit-sliced stacks only; the same inputs): the trigger cut, SEU
        counters and the popcount prefix-sum compaction run on sliced
        words in the same asynchronous pass (K1, quantize, bit gather, K2,
        B6), so dropped events are never transposed back to event order.

        Returns (count () int32, idx (C*B,) int32 ascending flat indices
        ``chip*B + event`` -1 padded, vals (C*B,) int32 kept scores 0
        padded, dis (C, R) int32), the ``parallel.compression`` wire
        format, B the batch width. Nothing synchronises: slice
        ``idx[:count]`` after the pass has finished to ship exactly the
        kept events. The staging copies are timed as ``launch_fused.h2d``
        on ``stages``."""
        if self.stack.src is None:
            raise ValueError(
                "sparse frame scoring needs the word domain: pack the "
                "frontend with layout='bitsliced'")
        rows = _as_rows(frames, y0)
        f, z, v = self._stage(rows, valid, stages)
        count, idx, vals, dis = _score_frames_impl(
            f, z, self.stack, self.plan, v,
            threshold_electrons=self.threshold_electrons, sparse=True)
        C, B, Bp = self.n_chips, rows.width, f.shape[1]
        if Bp != B:
            idx, vals = lut_ops.restride(idx, vals, C, B, Bp)
        return count, idx, vals, dis

    def _stage(self, rows: FrameRows, valid, stages: Stages):
        """Copy each chip's real rows into the (reused) padded device
        staging buffers, asynchronously where ``rows`` is pinned; zero the
        rows past each chip's count and mark the real rows valid (or
        ``valid``'s (C, width) rows, given), on the device. Where ``rows``
        carries its slot's events, record one behind the copies."""
        C, B = len(rows.counts), rows.width
        assert C == self.n_chips, (C, self.n_chips)
        Bp = -(-max(B, 1) // self.batch_tile) * self.batch_tile
        with stages.time("launch_fused.h2d"):
            bufs = self.staging.get((C, Bp))
            if bufs is None:
                dev = self.device
                bufs = (torch.zeros((C, Bp, N_T, N_Y, N_X),
                                    dtype=torch.float32, device=dev),
                        torch.zeros((C, Bp), dtype=torch.float32,
                                    device=dev),
                        torch.zeros((C, Bp), dtype=torch.bool, device=dev))
                self.staging[(C, Bp)] = bufs
            f, z, v = bufs
            for i, (n, o) in enumerate(zip(rows.counts, rows.offsets)):
                if n:
                    f[i, :n].copy_(rows.frames[o : o + n], non_blocking=True)
                    z[i, :n].copy_(rows.y0[o : o + n], non_blocking=True)
            if rows.events is not None and f.is_cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(f.device))
                rows.events.append(ev)
            for i, n in enumerate(rows.counts):
                if n < Bp:
                    f[i, n:].zero_()
                    z[i, n:].zero_()
                    if valid is None:
                        v[i, n:].fill_(False)
                if n and valid is None:
                    v[i, :n].fill_(True)
            if valid is not None:
                v[:, :B].copy_(torch.as_tensor(valid, dtype=torch.bool))
                v[:, B:].fill_(False)
        return f, z, v

    def swap_chip(
        self, slot: int, config: FabricConfig, chip_spec: ChipFrontendSpec,
        stack: Optional[lut_ops.PackedFabricStack] = None,
    ) -> "FusedFrontend":
        """Hot-swap one chip's whole frontend: fabric rows via
        PackedFabricStack.swap_chip plus this chip's encode-plan row,
        written in place into this frontend's plan (and stack) tensors, so
        call it once no dispatch of this frontend is in flight. A caller
        that already swapped its own shared stack passes it via
        ``stack``. The staging buffers are shared."""
        validate_chip_frontend(config, chip_spec, self.spec.n_features)
        if stack is None:
            stack = self.stack.swap_chip(slot, config, in_place=True)
        row = _plan_row(config, chip_spec, stack.n_inputs, stack.n_outputs)
        for k in _PLAN_KEYS:
            self.plan[k][slot] = torch.as_tensor(row[k],
                                                 dtype=self.plan[k].dtype)
        plan = dict(self.plan)
        specs = list(self.chip_specs)
        specs[slot] = chip_spec
        return dataclasses.replace(
            self, stack=stack, plan=plan, chip_specs=tuple(specs))

    def set_threshold(self, slot: int, threshold_raw: int) -> "FusedFrontend":
        """Retarget one chip's trigger cut (plan row update, no repack)."""
        specs = list(self.chip_specs)
        specs[slot] = dataclasses.replace(
            specs[slot], threshold_raw=int(threshold_raw))
        plan = dict(self.plan)
        plan["threshold_raw"] = self.plan["threshold_raw"].clone()
        plan["threshold_raw"][slot] = int(threshold_raw)
        return dataclasses.replace(self, plan=plan, chip_specs=tuple(specs))

    def with_stack(self, stack: lut_ops.PackedFabricStack
                   ) -> "FusedFrontend":
        """This frontend on ``stack``, the same chips' rows updated (a
        swapped replica, a healed frame)."""
        return dataclasses.replace(self, stack=stack)


@dataclasses.dataclass(frozen=True)
class SlabFrontend:
    """A fused frontend split over a device plan: ``slabs[s]`` is the
    ``FusedFrontend`` of the chips from ``first_chips[s]`` on, on its own
    device (its stack slab, plan rows and staging buffers). The
    ``score_frames*`` calls dispatch every slab on its device and merge on
    the host (``lut_ops.merge_scored`` / ``merge_sparse``), equal to the
    one-slab frontend's results element for element; ``swap_chip`` and
    ``set_threshold`` write the owning slab only."""

    slabs: Tuple[FusedFrontend, ...]
    first_chips: Tuple[int, ...]

    @property
    def n_chips(self) -> int:
        return sum(f.n_chips for f in self.slabs)

    @property
    def stack(self) -> lut_ops.SlabStack:
        return lut_ops.SlabStack(tuple(f.stack for f in self.slabs),
                                 self.first_chips)

    @property
    def batch_tile(self) -> int:
        return self.slabs[0].batch_tile

    @property
    def threshold_electrons(self) -> float:
        return self.slabs[0].threshold_electrons

    def _each(self, method: str, frames, y0, valid):
        return [(c0, getattr(f, method)(
                    frames[c0 : c0 + f.n_chips], y0[c0 : c0 + f.n_chips],
                    None if valid is None else valid[c0 : c0 + f.n_chips]))
                for f, c0 in zip(self.slabs, self.first_chips)]

    def score_frames_voted(self, frames, y0, valid=None
                           ) -> Tuple[torch.Tensor, ...]:
        """``FusedFrontend.score_frames_voted``, a dispatch a slab, merged
        on the host (CPU tensors)."""
        return lut_ops.merge_scored(self._each("score_frames_voted",
                                               frames, y0, valid))

    def score_frames_sparse(self, frames, y0, valid=None
                            ) -> Tuple[torch.Tensor, ...]:
        """``FusedFrontend.score_frames_sparse``, a dispatch a slab,
        merged on the host into the one-slab wire format."""
        return lut_ops.merge_sparse(
            self._each("score_frames_sparse", frames, y0, valid),
            np.shape(frames)[1])

    def _with(self, s: int, fe: FusedFrontend) -> "SlabFrontend":
        slabs = list(self.slabs)
        slabs[s] = fe
        return dataclasses.replace(self, slabs=tuple(slabs))

    def swap_chip(self, slot: int, config: FabricConfig,
                  chip_spec: ChipFrontendSpec,
                  stack: Optional[lut_ops.SlabStack] = None
                  ) -> "SlabFrontend":
        s, j = lut_ops._slab_index(self.first_chips, self.n_chips, slot)
        return self._with(s, self.slabs[s].swap_chip(
            j, config, chip_spec,
            stack=None if stack is None else stack.slabs[s]))

    def set_threshold(self, slot: int, threshold_raw: int) -> "SlabFrontend":
        s, j = lut_ops._slab_index(self.first_chips, self.n_chips, slot)
        return self._with(s, self.slabs[s].set_threshold(j, threshold_raw))

    def with_stack(self, stack: lut_ops.SlabStack) -> "SlabFrontend":
        return dataclasses.replace(self, slabs=tuple(
            f.with_stack(st) for f, st in zip(self.slabs, stack.slabs)))


def place_frontend(fe, stack):
    """A fused frontend (split or not) laid out as ``stack``'s slabs
    (``lut_ops.place_stack``'s result for a plan), each slab on its stack
    slab: a slab that keeps its chips and its device keeps its plan rows
    and staging buffers; another takes its plan rows from the slabs that
    held them (moved with ``.to``) and stages anew."""
    have = lut_ops.slabs_of(fe)
    out = []
    for slab, c0 in lut_ops.slabs_of(stack):
        parts = lut_ops.overlap(have, c0, slab.n_chips)
        part, lo, hi = parts[0]
        if (len(parts) == 1 and (lo, hi) == (0, part.n_chips)
                and part.device == slab.device):
            out.append(part.with_stack(slab))
            continue
        out.append(FusedFrontend(
            stack=slab,
            chip_specs=sum((p.chip_specs[a:b] for p, a, b in parts), ()),
            plan={k: torch.cat([p.plan[k][a:b].to(slab.device)
                                for p, a, b in parts]) for k in _PLAN_KEYS},
            batch_tile=fe.batch_tile,
            threshold_electrons=fe.threshold_electrons))
    if len(out) == 1:
        return out[0]
    return SlabFrontend(tuple(out), tuple(c0 for _, c0 in
                                          lut_ops.slabs_of(stack)))


def pack_frontend(
    configs: Sequence[FabricConfig],
    chip_specs: Sequence[ChipFrontendSpec],
    *,
    band: Optional[bool] = None,
    redundancy: str = "none",
    layout: str = "matmul",
    batch_tile: int = 128,
    threshold_electrons: float = 800.0,
    stack=None,
    geometry: Optional[StackGeometry] = None,
    device=None,
    mesh=None,
):
    """Pack N (config, frontend-spec) pairs into one fused dispatch on
    ``device`` (default: CUDA), or, given a device plan ``mesh``
    (launch.mesh.ReadoutMesh), split over its slabs (``device`` is then
    not consulted): a ``FusedFrontend`` for a plan of one, else a
    ``SlabFrontend``. A split ``stack`` (``lut_ops.SlabStack``) splits
    the frontend the same way.

    ``band``/``layout``/``redundancy``/``geometry`` feed the fabric stage
    as in ``pack_fabrics``: a pinned ``geometry`` sizes the stack and the
    encode plan by that envelope, so a chip swapped in later
    (``swap_chip``) changes no shape.
    ``batch_tile`` pads each dispatch's batch to a multiple of it. A caller
    that already packed the configs shares them via ``stack``.
    """
    if len(configs) != len(chip_specs):
        raise ValueError(f"{len(configs)} configs vs {len(chip_specs)} specs")
    n_features = default_frontend_spec(threshold_electrons).n_features
    for config, cs in zip(configs, chip_specs):
        validate_chip_frontend(config, cs, n_features)
    if stack is None:
        stack = lut_ops.pack_fabrics(
            list(configs), band=band, redundancy=redundancy, layout=layout,
            geometry=geometry,
            device=device if mesh is None else mesh.device)
    elif redundancy != "none" and stack.n_replicas == 1:
        raise ValueError(
            f"redundancy={redundancy!r} but the shared stack is not "
            "redundant — pack it with pack_fabrics(redundancy=...)")
    else:
        lut_ops._check_layout(layout)
    if geometry is not None and (
            stack.n_levels, stack.m_pad, stack.n_inputs, stack.n_outputs) != (
            geometry.n_levels, -(-geometry.max_level_size // 128) * 128,
            geometry.n_inputs, geometry.n_outputs):
        raise ValueError(f"the shared stack is not packed to {geometry}")
    assert stack.n_chips == len(configs), (stack.n_chips, len(configs))
    if mesh is not None:
        stack = lut_ops.place_stack(stack, mesh.slabs(len(configs)))
    elif device is not None and (resolve_device(device).type
                                 != lut_ops.slabs_of(stack)[0][0].device.type):
        raise ValueError(f"stack lives on {lut_ops.slabs_of(stack)[0][0].device}"
                         f", not {device}")
    slabs = []
    for slab, c0 in lut_ops.slabs_of(stack):
        specs = tuple(chip_specs[c0 : c0 + slab.n_chips])
        rows = [_plan_row(c, cs, stack.n_inputs, stack.n_outputs)
                for c, cs in zip(configs[c0 : c0 + slab.n_chips], specs)]
        slabs.append(FusedFrontend(
            stack=slab,
            chip_specs=specs,
            plan={k: torch.as_tensor(np.stack([r[k] for r in rows]),
                                     device=slab.device) for k in _PLAN_KEYS},
            batch_tile=batch_tile,
            threshold_electrons=float(threshold_electrons),
        ))
    if len(slabs) == 1:
        return slabs[0]
    return SlabFrontend(tuple(slabs), tuple(
        c0 for _, c0 in lut_ops.slabs_of(stack)))
