"""The readout server's two scoring paths, behind one interface.

``ReadoutServer`` keeps the loop and picks one path from
``ServerConfig.backend``: ``KernelPath`` ("kernel": the packed stack over
a device plan, the decode weights, the fused frames pass, its staging
ring and a side stream a card) or ``HostPath`` ("host": the staged numpy
oracle, a MultiFabricSim over the served replica configs). Both give the
same results bit for bit on the same features. A frames or features pass
returns (one record a slab, already in the egress kind its batch ships:
``Dense`` or ``Sparse``; a start mark a slab); the scrub loop reads
``readback`` (and, where ``deferred_scrub``, ``sample``) and the image
layout, and a hot swap, an upset or a heal goes through ``swap_chip`` or
``swap_replica``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fabric import (
    MultiFabricSim,
    StackGeometry,
    stack_event_bits,
)
from repro_torch.core.tmr import majority_vote, replicate_config
from repro_torch.parallel.compression import sparse_trigger_pack


@dataclasses.dataclass
class Dense:
    """A slab's score (C_s, B), keep (C_s, B) and per-replica
    disagreement counts dis (C_s, R); ``c0`` is its first chip."""

    c0: int
    score: object
    keep: object
    dis: object


@dataclasses.dataclass
class Sparse:
    """A slab's kept ``count``, its padded ``idx`` (ascending flat indices
    over the slab's own (C_s, width)) and ``vals`` (their scores), and
    dis (C_s, R); ``c0`` is its first chip."""

    c0: int
    count: object
    idx: object
    vals: object
    dis: object
    width: int


def pad_batch(B: int) -> int:
    """Round a kernel-path batch width up to a power of two, so the set of
    padded shapes (and of reused staging buffers) stays small."""
    return 1 << (max(int(B), 1) - 1).bit_length()


def valid_mask(counts: Sequence[int], B: int) -> np.ndarray:
    """(C, B) bool: True on real event rows, False on zero-padding."""
    return np.arange(max(B, 1))[None, :] < np.asarray(counts)[:, None]


def _device_mark(device: torch.device):
    """A timed CUDA event recorded now on ``device``'s current stream (a
    dispatch's start on the device); None off CUDA."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Path:
    """What both paths share. ``chips`` is the server's own list (its
    ``reconfigure`` puts the new chip in before ``swap_chip``); ``stages``
    and ``clock`` are the server's, and a pass stamps the batch's
    ``trace`` at ``t_encoded`` and ``t_launched``."""

    mesh = None             # the device plan served over (None: the host)
    # queue a scrub ``sample`` and verify it on a later step (else read
    # back and verify at once)
    deferred_scrub = False

    def __init__(self, chips: List, config, stages, clock):
        self.chips, self.config = chips, config
        self._stages, self._clock = stages, clock
        self.n_replicas = config.n_replicas
        # a side stream a card for the drain's kept-prefix copies
        self.copy_streams: Dict[torch.device, object] = {}
        self._cut_chips()

    def _cut_chips(self) -> None:
        self.thr_raw = np.array([c.score_threshold_raw for c in self.chips],
                                np.int32)

    def kept_prefix(self, rec: Sparse) -> Tuple[np.ndarray, np.ndarray]:
        """A drained sparse record's kept (flat index, score) prefix on
        the host, int64. A CUDA vector is copied on its card's side
        stream: its batch has finished, and the copy must not wait for
        the batches queued on the main stream behind it."""
        n = int(rec.count)
        out = []
        for t in (rec.idx, rec.vals):
            if torch.is_tensor(t) and t.is_cuda:
                with torch.cuda.stream(self.copy_streams[t.device]):
                    t = t[:n].cpu()
            out.append(np.asarray(t[:n]).astype(np.int64))
        return out[0], out[1]


class KernelPath(_Path):
    """The device path over a plan (launch.mesh.ReadoutMesh, by default
    ``make_readout_mesh`` over every card): C chips in d contiguous slabs
    of C/d chips, each slab's stack rows, encode-plan rows and staging
    buffers on its own device, and its launches there (K1 ->
    quantize/encode -> K2 -> B6, or B3 on a matmul stack). The slabs share
    nothing during a dispatch. Hot swaps, upsets, readbacks and heals go
    to the slab that owns the chip."""

    deferred_scrub = True

    def __init__(self, chips, config, stages, clock, *,
                 pinned: Optional[StackGeometry], device, mesh=None):
        super().__init__(chips, config, stages, clock)
        from repro_torch.kernels.lut_eval import ops as lut_ops
        from repro_torch.launch.mesh import make_readout_mesh

        self._lut_ops = lut_ops
        self._pinned = pinned   # the pinned envelope, or None
        self.mesh = (make_readout_mesh(len(chips), device=device)
                     if mesh is None else mesh)
        self.stack = lut_ops.place_stack(lut_ops.pack_fabrics(
            [c.config for c in chips], band=config.band,
            redundancy=config.redundancy, layout=config.effective_layout,
            geometry=pinned,
            device=self.mesh.device,
        ), self.mesh.slabs(len(chips)))
        self.out_weight = lut_ops.decode_plan(
            [c.config for c in chips], self.stack.n_outputs)
        self.frontend = None  # fused frames pass, built on first use
        self.ring = None  # its host staging ring, made at first use
        self._bind_copy_streams()
        self.image_levels, self.image_m_pad = (self.stack.n_levels,
                                               self.stack.m_pad)

    def widths(self, counts) -> Tuple[int, ...]:
        """The batch widths a pass of these per-chip counts launches at."""
        return (pad_batch(max(counts)),)

    def score_frames(self, per_chip_fy, counts, trace, sparse: bool):
        """ONE fused device pass a slab (``launch_fused``), out of a
        staging-ring slot (``stack_frames``)."""
        B = pad_batch(max(counts))
        if self.frontend is None:       # built on first use
            from repro_torch.kernels import frontend as fe

            self.frontend = fe.pack_frontend(
                [c.config for c in self.chips],
                [c.frontend_spec() for c in self.chips],
                band=self.config.band,
                redundancy=self.config.redundancy,
                layout=self.config.effective_layout,
                batch_tile=self.config.batch_tile,
                threshold_electrons=self.config.threshold_electrons,
                stack=self.stack,  # share the packed tensors
                geometry=self._pinned,
            )
        slabs = self._lut_ops.slabs_of(self.frontend)
        with self._stages.time("stack_frames"):
            rows = self._stage_rows(per_chip_fy, counts, B, slabs)
        trace["t_encoded"] = self._clock()
        with self._stages.time("launch_fused"):
            words = sparse and self.stack.bitsliced
            parts, starts = [], []
            for fe, c0 in slabs:
                score_fn = (fe.score_frames_sparse if words
                            else fe.score_frames_voted)
                starts.append(_device_mark(fe.device))
                parts.append((c0, score_fn(rows.chips(c0, fe.n_chips),
                                           stages=self._stages)))
        return self._records(parts, B, words, sparse, trace), starts

    def score_features(self, per_chip_bits, counts, trace, sparse: bool):
        """ONE chip-batched scoring pass a slab (``launch_score``:
        ``lut_eval.ops.scored_slabs``)."""
        words = sparse and self.stack.bitsliced
        with self._stages.time("launch_score"):
            B = pad_batch(max(counts))
            lead = per_chip_bits[0]
            if len(lead) < B:       # stack_event_bits pads to the max
                per_chip_bits[0] = np.vstack(
                    [lead, np.zeros((B - len(lead), lead.shape[1]),
                                    np.uint8)])
            valid = valid_mask(counts, B)
            starts = [_device_mark(slab.device)
                      for slab, _ in self._lut_ops.slabs_of(self.stack)]
            stacked = self._lut_ops.stack_input_bits(self.stack,
                                                     per_chip_bits)
            parts = self._lut_ops.scored_slabs(
                self.stack, stacked, self.out_weight, self.thr_raw, valid,
                batch_tile=self.config.batch_tile, sparse=words)
        return self._records(parts, B, words, sparse, trace), starts

    def _records(self, parts, B: int, words: bool, sparse: bool, trace):
        """[(first chip, result)] as records; a dense pass for sparse
        egress packed by ``compression.sparse_trigger_pack`` (kernel B6 on
        the card, asynchronous; ``sparse_pack``)."""
        trace["t_launched"] = self._clock()
        if words:
            return [Sparse(c0, *p, int(B)) for c0, p in parts]
        if not sparse:
            return [Dense(c0, *p) for c0, p in parts]
        with self._stages.time("sparse_pack"):
            return [Sparse(c0, *sparse_trigger_pack(score, keep), dis,
                           int(keep.shape[1]))
                    for c0, (score, keep, dis) in parts]

    def _stage_rows(self, per_chip_fy, counts: List[int], B: int, slabs):
        """``stack_frames``: each chip's real rows, chip-major with no
        padding, into the next slot of the staging ring (pinned where a
        slab is on a card; ``pipeline_depth + 2`` slots, so a slot's
        copies have landed by the time it comes round again).
        ``per_chip_fy`` holds per chip its (frames (n, T, Y, X), y0 (n,))
        pieces in seq order: one copy a piece and array."""
        from repro_torch.kernels.frontend import StagingRing

        pinned = any(fe.device.type == "cuda" for fe, _ in slabs)
        if self.ring is None or self.ring.pinned != pinned:
            self.ring = StagingRing(self.config.pipeline_depth + 2,
                                    pinned=pinned)
        rows = self.ring.take(counts, B, self._stages)
        frames, y0 = rows.frames.numpy(), rows.y0.numpy()
        for o, pieces in zip(rows.offsets, per_chip_fy):
            for fr, z in pieces:
                n = len(fr)
                np.copyto(frames[o : o + n], fr)
                np.copyto(y0[o : o + n], z)
                o += n
        return rows

    def swap_chip(self, slot: int, chip) -> None:
        """The slot's stack and encode-plan rows written in place."""
        self._cut_chips()
        self.stack = self.stack.swap_chip(slot, chip.config, in_place=True)
        self.out_weight = self._lut_ops.decode_plan(
            [c.config for c in self.chips], self.stack.n_outputs)
        if self.frontend is not None:
            self.frontend = self.frontend.swap_chip(
                slot, chip.config, chip.frontend_spec(), stack=self.stack)

    def swap_replica(self, slot: int, replica: int, config) -> None:
        """One replica row as fresh tensors: batches in flight keep the
        tables they were launched with."""
        self.stack = self.stack.swap_replica(slot, replica, config)
        if self.frontend is not None:
            self.frontend = self.frontend.with_stack(self.stack)

    def readback(self, slot: int, replica: int) -> np.ndarray:
        return self.stack.readback_replica(slot, replica)

    def sample(self, slot: int, replica: int):
        """A scrub step's sample of one replica's truth tables: (image,
        ready event, source). On the card the row is copied to pinned
        memory behind a CUDA event (the source row held so its storage
        outlives the copy), so the scrub never waits for the dispatch it
        runs behind."""
        row = self.stack.replica_tables(slot, replica)
        image, ready = row, None
        if row.is_cuda:
            with torch.cuda.device(row.device):
                image = torch.empty(row.shape, dtype=row.dtype,
                                    pin_memory=True)
                image.copy_(row, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(row.device))
        return image, ready, row

    def rebind(self, mesh) -> None:
        """The slabs moved to ``mesh`` (``train.elastic.reshard_replicated``
        copies only those whose chips or device changed)."""
        if mesh == self.mesh:
            return
        from repro_torch.kernels.frontend import place_frontend
        from repro_torch.train.elastic import reshard_replicated

        self.stack = reshard_replicated(self.stack, mesh)
        if self.frontend is not None:
            self.frontend = place_frontend(self.frontend, self.stack)
        self.mesh = mesh
        self._bind_copy_streams()

    def _bind_copy_streams(self) -> None:
        for dev in self.mesh.devices:
            if dev.type == "cuda" and dev not in self.copy_streams:
                self.copy_streams[dev] = torch.cuda.Stream(dev)

    def slabs(self) -> List[Dict]:
        return [{"device": str(slab.device),
                 "chips": [c0, c0 + slab.n_chips]}
                for slab, c0 in self._lut_ops.slabs_of(self.stack)]


class HostPath(_Path):
    """The staged numpy oracle: each stage materialized and timed, every
    replica of every chip a ``FabricSim`` (in one ``MultiFabricSim``),
    then the device's vote, decode, cut and disagreement counts."""

    def __init__(self, chips, config, stages, clock, *,
                 geometry: StackGeometry, replica_configs: Sequence,
                 device):
        super().__init__(chips, config, stages, clock)
        self.geometry, self.device = geometry, device
        self._multisim = MultiFabricSim(replica_configs, geometry=geometry)
        # the scrub image layout by the kernel stack's formula
        self.image_levels = geometry.n_levels
        self.image_m_pad = -(-geometry.max_level_size // 128) * 128

    def widths(self, counts) -> Tuple[int, ...]:
        """Each chip is featurized at its own count."""
        return tuple(sorted(set(counts)))

    def score_frames(self, per_chip_fy, counts, trace, sparse: bool):
        """Per chip: featurize on the device (``staged_featurize``) and
        encode (``staged_encode``); then the stacked bits scored
        (``staged_score``)."""
        from repro_torch.kernels.yprofile import ops as yp_ops

        per_chip_bits = []
        for chip, fy in zip(self.chips, per_chip_fy):
            if not fy:
                per_chip_bits.append(
                    np.zeros((0, chip.config.n_inputs), np.uint8))
                continue
            with self._stages.time("staged_featurize"):
                feats = yp_ops.yprofile(
                    np.concatenate([fr for fr, _ in fy]),
                    np.concatenate([z for _, z in fy]),
                    threshold_electrons=self.config.threshold_electrons,
                    device=self.device).cpu().numpy()
            with self._stages.time("staged_encode"):
                per_chip_bits.append(chip.encode_features(feats))
        trace["t_encoded"] = self._clock()
        return self._score("staged_score", per_chip_bits, counts, trace,
                           sparse)

    def score_features(self, per_chip_bits, counts, trace, sparse: bool):
        return self._score("launch_score", per_chip_bits, counts, trace,
                           sparse)

    def _score(self, stage: str, per_chip_bits, counts, trace,
               sparse: bool) -> Tuple[List, List]:
        """The stacked bits scored (timed ``stage``); for sparse egress
        packed with numpy (``sparse_pack``)."""
        with self._stages.time(stage):
            stacked = stack_event_bits(per_chip_bits, self.geometry.n_inputs)
            C, B = stacked.shape[0], stacked.shape[1]
            R = self.n_replicas
            rep = np.repeat(stacked, R, axis=0) if R > 1 else stacked
            outs = self._multisim.run(rep)              # (R*C, B, O)
            g = outs.reshape(C, R, B, outs.shape[-1])
            if R > 1:
                voted = majority_vote(g[:, 0], g[:, 1], g[:, 2])
                disagree = (g != voted[:, None]).any(-1)    # (C, R, B)
            else:
                voted = g[:, 0]
                disagree = np.zeros((C, 1, B), bool)
            score = np.zeros((C, B), np.int64)
            for i, chip in enumerate(self.chips):
                n_out = len(chip.config.output_nets)
                score[i] = chip.synth.decode_outputs(voted[i, :, :n_out])
            valid = valid_mask(counts, B)
            keep = (score <= self.thr_raw[:, None]) & valid
            dis = (disagree & valid[:, None, :]).sum(-1).astype(np.int64)
        trace["t_launched"] = self._clock()
        if not sparse:
            return [Dense(0, score, keep, dis)], [None]
        with self._stages.time("sparse_pack"):
            idx = np.flatnonzero(keep.ravel()).astype(np.int32)
            vals = score.ravel()[idx].astype(np.int32)
            return [Sparse(0, len(idx), idx, vals, dis, B)], [None]

    def swap_chip(self, slot: int, chip) -> None:
        self._cut_chips()
        for r in range(self.n_replicas):
            self.swap_replica(slot, r, replicate_config(chip.config, r))

    def swap_replica(self, slot: int, replica: int, config) -> None:
        self._multisim.swap_config(slot * self.n_replicas + replica, config)

    def readback(self, slot: int, replica: int) -> np.ndarray:
        return self._multisim.readback_tables(
            slot * self.n_replicas + replica, self.image_levels,
            self.image_m_pad)

    def slabs(self) -> List[Dict]:
        return []
