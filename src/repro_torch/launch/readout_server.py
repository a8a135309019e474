"""Multi-chip streaming readout server (PyTorch port).

The core loop of the JAX package's launch/readout_server.py, with both
ingestion forms:

    submit_frames(chip, frames, y0)   RAW charge frames
    submit(chip, features)            pre-featurized events
      -> micro-batch queue            (coalesce: max_batch / max_latency)
      -> device passes, one per kind  (frames: kernels/frontend.py,
                                       yprofile -> quantize -> bit gather
                                       -> fabric kernel + TMR vote ->
                                       score -> keep/drop; features: host
                                       encode, then lut_eval/ops.py
                                       fabric_eval_multi_scored)
      -> egress, dense or sparse      (sparse=True: only the kept events'
                                       (flat index, score) pairs, packed
                                       on the device by kernel B6)
      -> pinned host copy, drained    (poll never blocks; flush does)
      -> per-chip trigger report      (rates, reduction, link bytes,
                                       per-stage host timing, per-replica
                                       SEU disagreement counters)

Two backends: "kernel" is the device path; "host" is the staged numpy
oracle (featurize on the device, then numpy quantize + pack + FabricSim
per replica + vote), bit-identical to the kernel path given the same
features.

Pipelining: every launch enqueues its work on the current CUDA stream,
copies its small results (dense score/keep/disagree, or the sparse count
and disagree counts) into pinned host memory without blocking, and
records a CUDA event behind them; ``poll`` retires a batch only once its
event has completed, and up to ``pipeline_depth`` batches stay in flight.
A sparse batch's kept prefix ``idx[:count]``, ``vals[:count]`` is copied
at the drain, on a side stream, so it waits for no later batch.

Not ported yet (each raises NotPortedError — nothing is silently
ignored): scrubbing, deadline admission and the degrade ladder, and
per-tenant quotas. See ROADMAP queue A.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fabric import (
    FabricSim,
    FrontendSpec,
    MultiFabricSim,
    StackGeometry,
    check_stackable,
    stack_event_bits,
)
from repro_torch.core.readout import ReadoutChip
from repro_torch.core.tmr import N_REPLICAS, majority_vote, replicate_config
from repro_torch.data.smartpixel import N_FEATURES as _N_FEATURES
from repro_torch.data.smartpixel import N_T, N_X, N_Y
from repro_torch.device import NotPortedError, resolve_device
from repro_torch.parallel.compression import (
    DENSE_BYTES_PER_EVENT,
    SPARSE_BYTES_PER_EVENT,
    SPARSE_HEADER_BYTES,
    sparse_trigger_pack,
)

DEGRADE_RUNGS = ("scrub_relax", "scrub_crc_only", "sparse_egress")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Micro-batching knobs; the same fields and defaults as the JAX
    package's ServerConfig, validated on construction with named errors.

    Ported: max_batch, max_latency_s, backend ("kernel" | "host"),
    batch_tile, band, layout (None | "matmul" | "bitsliced"), redundancy
    ("none" | "tmr"), sparse, pipeline_depth, threshold_electrons,
    bits_per_hit, hit_rate_hz. Every other knob must keep its default: a
    non-default value raises NotPortedError naming the ROADMAP item.
    """

    max_batch: int = 2048
    max_latency_s: float = 5e-3
    backend: str = "kernel"
    batch_tile: int = 128
    band: Optional[bool] = None
    layout: Optional[str] = None
    redundancy: str = "none"
    sparse: bool = False
    scrub_interval: Optional[int] = None
    scrub_mode: str = "steered"
    pipeline_depth: int = 2
    threshold_electrons: float = 800.0
    bits_per_hit: int = 256
    hit_rate_hz: float = 40e6
    deadline_us: Optional[float] = None
    overload_policy: str = "observe"
    degrade_rungs: Tuple[str, ...] = DEGRADE_RUNGS
    degrade_window: int = 64
    degrade_enter_frac: float = 0.5
    degrade_exit_frac: float = 0.05
    min_batch: int = 32
    tenant_quota_queued: Optional[int] = None

    def __post_init__(self):
        if not (isinstance(self.max_batch, int) and self.max_batch > 0):
            raise ValueError(f"max_batch must be a positive int, got "
                             f"{self.max_batch!r}")
        if self.max_latency_s <= 0:
            raise ValueError(f"max_latency_s must be > 0, got "
                             f"{self.max_latency_s!r}")
        if not (isinstance(self.batch_tile, int) and self.batch_tile > 0
                and self.batch_tile % 128 == 0):
            raise ValueError(
                f"batch_tile must be a positive multiple of 128, got "
                f"{self.batch_tile!r}")
        if self.backend not in ("kernel", "host"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(expected 'kernel' or 'host')")
        if self.band is not None and not isinstance(self.band, bool):
            raise ValueError(
                f"band must be True, False or None (auto), got "
                f"{self.band!r}")
        if self.layout is not None and self.layout not in (
                "matmul", "bitsliced"):
            raise ValueError(f"unknown layout {self.layout!r} "
                             "(expected 'matmul' or 'bitsliced', or None "
                             "= auto-select)")
        if self.redundancy not in ("none", "tmr"):
            raise ValueError(f"unknown redundancy {self.redundancy!r} "
                             "(expected 'none' or 'tmr')")
        if not isinstance(self.sparse, bool):
            raise ValueError(f"sparse must be a bool, got {self.sparse!r}")
        if self.scrub_interval is not None and not (
                isinstance(self.scrub_interval, int)
                and not isinstance(self.scrub_interval, bool)
                and self.scrub_interval > 0):
            raise ValueError(
                f"scrub_interval must be a positive int (dispatches between "
                f"scrub steps) or None to disable, got "
                f"{self.scrub_interval!r}")
        if self.scrub_mode not in ("round_robin", "steered"):
            raise ValueError(
                f"unknown scrub_mode {self.scrub_mode!r} "
                "(expected 'round_robin' or 'steered')")
        if not (isinstance(self.pipeline_depth, int)
                and self.pipeline_depth >= 1):
            raise ValueError(f"pipeline_depth must be an int >= 1, got "
                             f"{self.pipeline_depth!r}")
        if self.threshold_electrons < 0:
            raise ValueError(f"threshold_electrons must be >= 0, got "
                             f"{self.threshold_electrons!r}")
        if self.deadline_us is not None and not (
                isinstance(self.deadline_us, (int, float))
                and not isinstance(self.deadline_us, bool)
                and math.isfinite(self.deadline_us)
                and self.deadline_us > 0):
            raise ValueError(
                f"deadline_us must be a positive finite number (per-event "
                f"latency budget in microseconds) or None to disable, got "
                f"{self.deadline_us!r}")
        if self.overload_policy not in ("observe", "shed", "degrade"):
            raise ValueError(
                f"unknown overload_policy {self.overload_policy!r} "
                "(expected 'observe', 'shed' or 'degrade')")
        if self.overload_policy != "observe" and self.deadline_us is None:
            raise ValueError(
                f"overload_policy={self.overload_policy!r} needs "
                "deadline_us set — without a deadline there is no slack "
                "to act on")
        rungs = self.degrade_rungs
        if isinstance(rungs, list):
            rungs = tuple(rungs)
            object.__setattr__(self, "degrade_rungs", rungs)
        if not (isinstance(rungs, tuple) and rungs):
            raise ValueError(
                f"degrade_rungs must be a non-empty tuple of rung names, "
                f"got {self.degrade_rungs!r}")
        for r in rungs:
            if r not in DEGRADE_RUNGS:
                raise ValueError(
                    f"unknown degrade rung {r!r} "
                    f"(known rungs: {list(DEGRADE_RUNGS)})")
        if len(set(rungs)) != len(rungs):
            raise ValueError(f"duplicate degrade rungs in {rungs!r}")
        if not (isinstance(self.degrade_window, int)
                and not isinstance(self.degrade_window, bool)
                and self.degrade_window >= 1):
            raise ValueError(
                f"degrade_window must be an int >= 1 (drained events per "
                f"ladder evaluation), got {self.degrade_window!r}")
        if not (0.0 < self.degrade_exit_frac
                < self.degrade_enter_frac <= 1.0):
            raise ValueError(
                "need 0 < degrade_exit_frac < degrade_enter_frac <= 1 "
                "(the hysteresis gap), got "
                f"exit={self.degrade_exit_frac!r} "
                f"enter={self.degrade_enter_frac!r}")
        if not (isinstance(self.min_batch, int)
                and not isinstance(self.min_batch, bool)
                and self.min_batch > 0):
            raise ValueError(f"min_batch must be a positive int, got "
                             f"{self.min_batch!r}")
        if self.tenant_quota_queued is not None and not (
                isinstance(self.tenant_quota_queued, int)
                and not isinstance(self.tenant_quota_queued, bool)
                and self.tenant_quota_queued > 0):
            raise ValueError(
                f"tenant_quota_queued must be a positive int (max "
                f"outstanding events per tenant) or None to disable, got "
                f"{self.tenant_quota_queued!r}")
        self._check_ported()

    def _check_ported(self) -> None:
        """A non-default value of a knob this port does not carry yet is
        refused here, by name — never silently ignored."""
        default = ServerConfig.__dataclass_fields__
        unported = {
            "scrub_interval": "scrubbing (server scrub/TMR-SEU slice)",
            "scrub_mode": "scrubbing (server scrub/TMR-SEU slice)",
            "deadline_us": "deadline admission (server deadline slice)",
            "overload_policy": "deadline admission (server deadline slice)",
            "degrade_rungs": "the degrade ladder (server deadline slice)",
            "degrade_window": "the degrade ladder (server deadline slice)",
            "degrade_enter_frac":
                "the degrade ladder (server deadline slice)",
            "degrade_exit_frac":
                "the degrade ladder (server deadline slice)",
            "min_batch": "adaptive batch sizing (server deadline slice)",
            "tenant_quota_queued": "tenant quotas (fleet slice)",
        }
        for name, item in unported.items():
            if getattr(self, name) != default[name].default:
                raise NotPortedError(
                    f"ServerConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet: ROADMAP queue A, {item}")

    @property
    def n_replicas(self) -> int:
        return N_REPLICAS if self.redundancy == "tmr" else 1

    @property
    def effective_layout(self) -> str:
        """The layout actually served: None selects "bitsliced"."""
        return self.layout if self.layout is not None else "bitsliced"


@dataclasses.dataclass(frozen=True)
class ScoredEvent:
    seq: int          # submission order (global, monotone)
    chip: int
    score_raw: int    # integer-domain fabric score (voted under TMR)
    keep: bool        # False = classified as pileup, dropped at source


@dataclasses.dataclass
class ChipStreamStats:
    """Running trigger/reduction accounting for one chip slot."""

    n_in: int = 0
    n_kept: int = 0
    n_dispatches: int = 0
    n_shed: int = 0
    # per-replica SEU health: events where replica r's output word was
    # voted against (always zeros on a healthy or non-redundant server)
    disagreements: List[int] = dataclasses.field(default_factory=list)

    def fraction_kept(self) -> float:
        return self.n_kept / self.n_in if self.n_in else 1.0


# (seq, chip, kind, payload, t_enqueue): kind "frames" carries
# (frame, y0), kind "features" a (n_features,) float64 row
_Event = Tuple[int, int, str, object, float]
# (kind, pending, per_chip_seq, counts, ready): kind "scored" holds
# (score (C, B), keep (C, B), disagree (C, R)), kind "sparse" holds
# (count, idx, vals, disagree (C, R), B); ready is the CUDA event behind
# the batch's pinned copies, or None for results already on the host
_Inflight = Tuple[str, Tuple, List[List[int]], List[int], object]


class ReadoutServer:
    """Serves N configured ReadoutChips from one micro-batched event loop."""

    def __init__(
        self,
        chips: Sequence[ReadoutChip],
        config: ServerConfig = ServerConfig(),
        clock=time.monotonic,
        *,
        device=None,
    ):
        """``device`` is where the fused pass (kernel backend) or the
        featurizer (host backend) runs: None means CUDA, and without CUDA
        only an explicit ``device="cpu"`` is accepted."""
        if not chips:
            raise ValueError("need at least one chip")
        self.device = resolve_device(device)
        self.chips: List[ReadoutChip] = list(chips)
        self.config = config
        self._clock = clock
        for i, c in enumerate(self.chips):
            if len(c.config.output_nets) > 31:
                raise ValueError(
                    f"device score decode is int32: chip {i} has "
                    f"{len(c.config.output_nets)} output bits > 31")
        # the server's FIXED envelope, validated on every hot-swap by
        # both backends (see the JAX package's server for the rationale)
        geo = check_stackable([c.config for c in self.chips])
        banded = (
            config.band is not False
            and (geo.fanin_reach or geo.n_levels) < geo.n_levels
        )
        self.layout = config.effective_layout
        self.geometry: StackGeometry = dataclasses.replace(
            geo if banded else dataclasses.replace(geo, fanin_reach=None),
            frontend=FrontendSpec(
                n_features=_N_FEATURES,
                frame_shape=(N_T, N_Y, N_X),
                threshold_electrons=config.threshold_electrons,
            ),
        )
        self.n_replicas = config.n_replicas
        # the SERVED replica encodings, slot-major (replica r of chip c
        # is _replica_configs[c*R + r]): the host oracle's simulators
        self._replica_configs: List = [
            replicate_config(c.config, r)
            for c in self.chips for r in range(self.n_replicas)
        ]
        self._thr_raw = np.array(
            [c.score_threshold_raw for c in self.chips], np.int32)
        self._stack = None
        self._frontend = None  # fused frames pass, built on first use
        # side stream of the drain's kept-prefix copies (CUDA only)
        self._copy_stream = None
        if config.backend == "kernel":
            from repro_torch.kernels.lut_eval import ops as lut_ops

            self._lut_ops = lut_ops
            self._stack = lut_ops.pack_fabrics(
                [c.config for c in self.chips], band=config.band,
                redundancy=config.redundancy, layout=self.layout,
                device=self.device,
            )
            self._out_weight = lut_ops.decode_plan(
                [c.config for c in self.chips], self._stack.n_outputs)
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
        else:
            self._multisim = MultiFabricSim(
                self._replica_configs, geometry=self.geometry)

        self._queue: Deque[_Event] = collections.deque()
        self._seq = 0
        # per-slot FabricSim cache (one per replica) for the host backend
        self._frame_sims: List[Optional[List[FabricSim]]] = (
            [None] * len(self.chips))
        self._inflight: Deque[_Inflight] = collections.deque()
        self._stats = [
            ChipStreamStats(disagreements=[0] * self.n_replicas)
            for _ in self.chips
        ]
        self._stage_s: Dict[str, float] = collections.defaultdict(float)
        self._stage_n: Dict[str, int] = collections.defaultdict(int)
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None
        self._n_scored = 0
        self._link_bytes_wire = 0
        self._link_bytes_dense = 0

    # ------------------------------------------------------------- intake
    @property
    def n_chips(self) -> int:
        return len(self.chips)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _check_chip(self, chip: int) -> None:
        if not 0 <= chip < self.n_chips:
            raise ValueError(
                f"chip must be in [0, {self.n_chips}), got {chip}")

    def submit(self, chip: int, features: np.ndarray) -> Optional[int]:
        """Enqueue one pre-featurized event for one chip; returns its seq
        (every event is admitted: deadline admission is not ported)."""
        self._check_chip(chip)
        seq = self._seq
        self._seq += 1
        self._queue.append((seq, chip, "features",
                            np.asarray(features, np.float64), self._clock()))
        return seq

    def submit_batch(self, chip: int, X: np.ndarray) -> List[Optional[int]]:
        """Enqueue a block of pre-featurized events (rows of X)."""
        return [self.submit(chip, row) for row in np.asarray(X)]

    def submit_frames(
        self, chip: int, frames: np.ndarray, y0: np.ndarray
    ) -> List[Optional[int]]:
        """Enqueue raw-frame events: (n, T, Y, X) charge + (n,) y0; returns
        their seqs (every event is admitted: deadline admission is not
        ported). Frames and features of one micro-batch score as two
        passes, so results follow the passes, not the global seq order
        (every event stays seq-tagged)."""
        self._check_chip(chip)
        frames = np.asarray(frames, np.float32)
        y0 = np.asarray(y0, np.float32)
        if frames.ndim != 4 or frames.shape[1:] != (N_T, N_Y, N_X) \
                or y0.shape != (len(frames),):
            raise ValueError(
                f"need frames (n, {N_T}, {N_Y}, {N_X}) and y0 (n,), got "
                f"{frames.shape} and {y0.shape}")
        seqs: List[Optional[int]] = []
        now = self._clock()
        for i in range(len(frames)):
            seq = self._seq
            self._seq += 1
            self._queue.append(
                (seq, chip, "frames", (frames[i], float(y0[i])), now))
            seqs.append(seq)
        return seqs

    # ------------------------------------------------------------ the loop
    def poll(self) -> List[ScoredEvent]:
        """One turn of the event loop: retire finished in-flight batches,
        dispatch if a micro-batch is due and the pipeline has room, and
        return completed results. Never blocks."""
        out = self._drain_ready()
        if self._due() and len(self._inflight) <= self.config.pipeline_depth:
            out.extend(self._dispatch(self._coalesce()))
        return out

    def flush(self) -> List[ScoredEvent]:
        """Force out everything: queued events and in-flight results."""
        out: List[ScoredEvent] = []
        while self._queue:
            out.extend(self._dispatch(self._coalesce()))
            while len(self._inflight) > self.config.pipeline_depth:
                out.extend(self._drain_one())       # flush MAY block
        out.extend(self._drain_all())
        return out

    def score_stream(
        self, batches: Iterable[Tuple]
    ) -> Iterable[List[ScoredEvent]]:
        """Drive the loop over (chip, frames, y0) triples and (chip,
        features-block) pairs, yielding completed results as they become
        available."""
        for item in batches:
            if len(item) == 3:
                self.submit_frames(*item)
            else:
                self.submit_batch(*item)
            got = self.poll()
            if got:
                yield got
        tail = self.flush()
        if tail:
            yield tail

    def _due(self) -> bool:
        if not self._queue:
            return False
        if len(self._queue) >= self.config.max_batch:
            return True
        oldest = self._queue[0][4]
        return (self._clock() - oldest) >= self.config.max_latency_s

    def _coalesce(self) -> List[_Event]:
        take = min(len(self._queue), self.config.max_batch)
        return [self._queue.popleft() for _ in range(take)]

    def _stage(self, key: str, t0: float) -> None:
        self._stage_s[key] += self._clock() - t0
        self._stage_n[key] += 1

    def _dispatch(self, events: List[_Event]) -> List[ScoredEvent]:
        """Launch one micro-batch (frames and features as two passes),
        then retire whatever finished."""
        if not events:
            return []
        if self._t_start is None:
            self._t_start = self._clock()
        frame_events = [e for e in events if e[2] == "frames"]
        feat_events = [e for e in events if e[2] == "features"]
        if frame_events:
            self._inflight.append(self._launch_frames(frame_events))
        if feat_events:
            self._inflight.append(self._launch_features(feat_events))
        return self._drain_ready()

    def _group(self, events: List[_Event]):
        per_chip_seq: List[List[int]] = [[] for _ in self.chips]
        per_chip_payload: List[List[object]] = [[] for _ in self.chips]
        for seq, chip, _, payload, _ in events:
            per_chip_seq[chip].append(seq)
            per_chip_payload[chip].append(payload)
        counts = [len(s) for s in per_chip_seq]
        for i, n in enumerate(counts):
            if n:
                self._stats[i].n_dispatches += 1
        return per_chip_seq, per_chip_payload, counts

    @staticmethod
    def _pad_batch(B: int) -> int:
        """Round a kernel-backend batch width up to a power of two, so the
        set of padded shapes (and of reused staging buffers) stays small."""
        return 1 << (max(int(B), 1) - 1).bit_length()

    def _valid_mask(self, counts: List[int], B: int) -> np.ndarray:
        """(C, B) bool: True on real event rows, False on zero-padding."""
        return (np.arange(max(B, 1))[None, :]
                < np.asarray(counts)[:, None])

    def _sparse_active(self) -> bool:
        """Sparse egress is on when configured (the degrade ladder's
        sparse_egress rung comes with the deadline slice)."""
        return self.config.sparse

    def _word_sparse_active(self) -> bool:
        """Sparse egress on a bit-sliced kernel stack: the keep cut, SEU
        counters and compaction run on the fabric kernel's words (kernel
        B6 in the same pass), so there is no separate pack."""
        return (self._sparse_active()
                and self.config.backend == "kernel"
                and self._stack is not None and self._stack.bitsliced)

    def _launch_frames(self, events: List[_Event]) -> _Inflight:
        """Kernel backend: ONE fused device pass (timed ``launch_fused``).
        Host backend: the same pipeline STAGED, each stage materialized
        and timed (``staged_featurize`` / ``staged_encode`` /
        ``staged_score``)."""
        per_chip_seq, per_chip_fy, counts = self._group(events)
        cfg = self.config
        B = max(counts) if counts else 0
        if cfg.backend == "kernel":
            B = self._pad_batch(B)
        valid = self._valid_mask(counts, B)

        if cfg.backend == "kernel":
            t0 = self._clock()
            frames = np.zeros((self.n_chips, B, N_T, N_Y, N_X), np.float32)
            y0 = np.zeros((self.n_chips, B), np.float32)
            for i, rows in enumerate(per_chip_fy):
                if rows:  # one vectorized copy per chip, not per event
                    frames[i, : len(rows)] = np.stack([fr for fr, _ in rows])
                    y0[i, : len(rows)] = [z for _, z in rows]
            self._stage("stack_frames", t0)
            t0 = self._clock()
            fe = self._get_frontend()
            if self._word_sparse_active():
                count, idx, vals, dis = fe.score_frames_sparse(
                    frames, y0, valid=valid)
                self._stage("launch_fused", t0)
                return self._finish_launch_sparse(
                    count, idx, vals, dis, B, per_chip_seq, counts)
            score, keep, dis = fe.score_frames_voted(frames, y0, valid=valid)
            self._stage("launch_fused", t0)
            return self._finish_launch(score, keep, dis, per_chip_seq,
                                       counts)

        from repro_torch.kernels.yprofile import ops as yp_ops

        R = self.n_replicas
        score = np.zeros((self.n_chips, B), np.int64)
        disagree = np.zeros((self.n_chips, R, B), bool)
        for i, chip in enumerate(self.chips):
            if not per_chip_fy[i]:
                continue
            n = counts[i]
            frames_i = np.stack([fr for fr, _ in per_chip_fy[i]])
            y0_i = np.asarray([z for _, z in per_chip_fy[i]], np.float32)
            t0 = self._clock()
            feats = yp_ops.yprofile(
                frames_i, y0_i, threshold_electrons=cfg.threshold_electrons,
                device=self.device).cpu().numpy()
            self._stage("staged_featurize", t0)
            t0 = self._clock()
            bits = chip.encode_features(feats)
            self._stage("staged_encode", t0)
            t0 = self._clock()
            if self._frame_sims[i] is None:
                self._frame_sims[i] = [
                    FabricSim(self._replica_configs[i * R + r])
                    for r in range(R)
                ]
            g = np.stack(
                [np.asarray(sim.run(bits)[0]) for sim in self._frame_sims[i]]
            )                                           # (R, n, O_i)
            if R > 1:
                voted = majority_vote(g[0], g[1], g[2])
                disagree[i, :, :n] = (g != voted[None]).any(-1)
            else:
                voted = g[0]
            score[i, :n] = chip.synth.decode_outputs(voted)
            self._stage("staged_score", t0)
        keep = (score <= self._thr_raw[:, None]) & valid
        dis = (disagree & valid[:, None, :]).sum(-1).astype(np.int64)
        return self._finish_launch(score, keep, dis, per_chip_seq, counts)

    def _launch_features(self, events: List[_Event]) -> _Inflight:
        """Features path: host encoding (quantize + offset-binary bits,
        timed ``encode_host``), then ONE chip-batched scoring pass (timed
        ``launch_score``): fabric evaluation of every replica, vote, score
        decode and trigger cut on the device (``fabric_eval_multi_scored``,
        or its word-domain sparse form with kernel B6)."""
        per_chip_seq, per_chip_X, counts = self._group(events)
        t0 = self._clock()
        per_chip_bits: List[np.ndarray] = []
        for i, chip in enumerate(self.chips):
            if per_chip_X[i]:
                bits = chip.encode_features(np.stack(per_chip_X[i]))
            else:
                bits = np.zeros((0, chip.config.n_inputs), np.uint8)
            per_chip_bits.append(bits)
        self._stage("encode_host", t0)

        t0 = self._clock()
        B = max(counts) if counts else 0
        if self.config.backend == "kernel":
            B = self._pad_batch(B)
            lead = per_chip_bits[0]
            if len(lead) < B:           # stack_event_bits pads to the max
                per_chip_bits[0] = np.vstack(
                    [lead, np.zeros((B - len(lead), lead.shape[1]),
                                    np.uint8)])
            valid = self._valid_mask(counts, B)
            stacked = self._lut_ops.stack_input_bits(self._stack,
                                                     per_chip_bits)
            args = (self._stack, stacked, self._out_weight, self._thr_raw)
            kw = dict(valid=valid, batch_tile=self.config.batch_tile)
            if self._word_sparse_active():
                count, idx, vals, dis = (
                    self._lut_ops.fabric_eval_multi_scored_sparse(*args,
                                                                  **kw))
                self._stage("launch_score", t0)
                return self._finish_launch_sparse(
                    count, idx, vals, dis, B, per_chip_seq, counts)
            score, keep, dis = self._lut_ops.fabric_eval_multi_scored(*args,
                                                                      **kw)
        else:
            valid = self._valid_mask(counts, B)
            stacked = stack_event_bits(per_chip_bits, self.geometry.n_inputs)
            score, keep, dis = self._score_bits_host(stacked, valid)
        self._stage("launch_score", t0)
        return self._finish_launch(score, keep, dis, per_chip_seq, counts)

    def _score_bits_host(
        self, stacked: np.ndarray, valid: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The numpy oracle of the device scoring pass: every replica
        (MultiFabricSim over the served replica configs), the same
        majority vote, two's-complement decode, cut and disagreement
        counts."""
        C, B = stacked.shape[0], stacked.shape[1]
        R = self.n_replicas
        rep = np.repeat(stacked, R, axis=0) if R > 1 else stacked
        outs = self._multisim.run(rep)                  # (R*C, B, O)
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
        keep = (score <= self._thr_raw[:, None]) & valid
        dis = (disagree & valid[:, None, :]).sum(-1).astype(np.int64)
        return score, keep, dis

    def _finish_launch(self, score, keep, dis, per_chip_seq,
                       counts) -> _Inflight:
        """Output stage of a dense pass: the dense (score, keep) or, with
        sparse egress on, its packed (count, idx, vals) — on the kernel
        backend through ``compression.sparse_trigger_pack`` (kernel B6 on
        the card, still asynchronous), on the host backend with numpy
        (timed ``sparse_pack``)."""
        if not self._sparse_active():
            return self._enqueue("scored", (score, keep, dis), (0, 1, 2),
                                 per_chip_seq, counts)
        t0 = self._clock()
        B = int(keep.shape[1])
        if self.config.backend == "kernel":
            count, idx, vals = sparse_trigger_pack(score, keep)
        else:
            idx = np.flatnonzero(np.asarray(keep).ravel()).astype(np.int32)
            vals = np.asarray(score).ravel()[idx].astype(np.int32)
            count = len(idx)
        self._stage("sparse_pack", t0)
        return self._finish_launch_sparse(count, idx, vals, dis, B,
                                          per_chip_seq, counts)

    def _finish_launch_sparse(self, count, idx, vals, dis, B, per_chip_seq,
                              counts) -> _Inflight:
        """Output stage of a sparse pass: the count and the disagree counts
        go to pinned memory behind the batch's event; the padded (idx,
        vals) stay on the device until the drain copies their kept
        prefix."""
        return self._enqueue("sparse", (count, idx, vals, dis, int(B)),
                             (0, 3), per_chip_seq, counts)

    def _enqueue(self, kind: str, parts: Tuple, to_host: Tuple[int, ...],
                 per_chip_seq, counts) -> _Inflight:
        """Start the device->host copies of ``parts[i]`` for i in
        ``to_host`` into pinned memory and record the batch's CUDA event
        after them, so a completed event means the copies landed. Results
        already on the host (host backend, CPU tensors) need no event."""
        if not any(torch.is_tensor(p) and p.is_cuda for p in parts):
            return kind, parts, per_chip_seq, counts, None
        parts = tuple(
            torch.empty(p.shape, dtype=p.dtype, pin_memory=True).copy_(
                p, non_blocking=True) if i in to_host else p
            for i, p in enumerate(parts))
        ready = torch.cuda.Event()
        ready.record()
        return kind, parts, per_chip_seq, counts, ready

    def _get_frontend(self):
        if self._frontend is None:
            from repro_torch.kernels import frontend as fe

            self._frontend = fe.pack_frontend(
                [c.config for c in self.chips],
                [c.frontend_spec() for c in self.chips],
                band=self.config.band,
                redundancy=self.config.redundancy,
                layout=self.layout,
                batch_tile=self.config.batch_tile,
                threshold_electrons=self.config.threshold_electrons,
                stack=self._stack,  # share the server's packed tensors
            )
        return self._frontend

    def _head_ready(self) -> bool:
        """Non-blocking probe: has the OLDEST in-flight batch's event
        completed (results already on the host always have)?"""
        if not self._inflight:
            return False
        ready = self._inflight[0][4]
        return ready is None or ready.query()

    def _drain_ready(self) -> List[ScoredEvent]:
        """Retire every finished in-flight batch, oldest first, never
        blocking."""
        out: List[ScoredEvent] = []
        while self._head_ready():
            out.extend(self._drain_one())
        return out

    def _kept_prefix(self, t, n: int) -> np.ndarray:
        """The first ``n`` entries of a packed vector on the host, int64.
        A CUDA vector is copied on the side stream: its batch has
        finished, and the copy must not wait for the batches queued on
        the main stream behind it."""
        if torch.is_tensor(t) and t.is_cuda:
            with torch.cuda.stream(self._copy_stream):
                t = t[:n].cpu()
        return np.asarray(t[:n]).astype(np.int64)

    def _drain_one(self) -> List[ScoredEvent]:
        """Materialize the OLDEST in-flight batch and fold it into the
        reports (``drain_wait`` is the host-visible blocking time). With
        sparse egress only the count prefix of the packed (idx, score)
        pair crosses the host link: the measured wire bytes."""
        if not self._inflight:
            return []
        kind, pending, per_chip_seq, counts, ready = self._inflight.popleft()
        t0 = self._clock()
        if ready is not None:
            ready.synchronize()                         # blocks here
        results: List[ScoredEvent] = []
        n_events = int(sum(counts))
        self._link_bytes_dense += DENSE_BYTES_PER_EVENT * n_events
        if kind == "sparse":
            count, idx, vals, dis, B = pending
            n_kept = int(count)
            idx_h = self._kept_prefix(idx, n_kept)
            vals_h = self._kept_prefix(vals, n_kept)
            self._link_bytes_wire += (
                SPARSE_HEADER_BYTES + SPARSE_BYTES_PER_EVENT * n_kept)
            chip_of = idx_h // max(B, 1)
            kept_per_chip = np.bincount(chip_of, minlength=self.n_chips)
            for i, st in enumerate(self._stats):
                st.n_in += counts[i]
                st.n_kept += int(kept_per_chip[i])
            for k, c, v in zip(idx_h, chip_of, vals_h):
                results.append(ScoredEvent(
                    seq=per_chip_seq[c][k % B], chip=int(c),
                    score_raw=int(v), keep=True))
        else:
            score, keep, dis = (np.asarray(x) for x in pending)
            self._link_bytes_wire += DENSE_BYTES_PER_EVENT * n_events
            for i in range(self.n_chips):
                n = counts[i]
                if n:
                    self._fold_chip(results, i, per_chip_seq[i],
                                    score[i, :n].astype(np.int64),
                                    keep[i, :n])
        self._fold_disagreements(dis)
        self._stage("drain_wait", t0)
        self._n_scored += len(results)
        self._t_last = self._clock()
        results.sort(key=lambda r: r.seq)
        return results

    def _fold_chip(self, results, i, seqs, scores, keep) -> None:
        st = self._stats[i]
        st.n_in += len(seqs)
        st.n_kept += int(np.asarray(keep).sum())
        for j, seq in enumerate(seqs):
            results.append(
                ScoredEvent(seq=seq, chip=i, score_raw=int(scores[j]),
                            keep=bool(keep[j])))

    def _fold_disagreements(self, dis) -> None:
        dis = np.asarray(dis)                           # (C, R)
        for i, st in enumerate(self._stats):
            st.disagreements = [
                a + int(b) for a, b in zip(st.disagreements, dis[i])
            ]

    def _drain_all(self) -> List[ScoredEvent]:
        out: List[ScoredEvent] = []
        while self._inflight:
            out.extend(self._drain_one())
        return out

    # ------------------------------------------------------- reconfigure
    def reconfigure(self, slot: int, new_chip: ReadoutChip) -> List[ScoredEvent]:
        """Hot-swap slot's bitstream: a row update of the stack and the
        encode plan, no rebuild. Pending events are flushed first (they
        were submitted against the old configuration); returns their
        results. The new config must fit the server's fixed envelope."""
        assert 0 <= slot < self.n_chips, slot
        cfg = new_chip.config
        if cfg.n_ffs or not self.geometry.admits(cfg):
            raise ValueError(
                f"new config does not fit server envelope {self.geometry} "
                f"(levels={len(cfg.level_sizes)}, "
                f"widest={max(cfg.level_sizes, default=1)}, "
                f"inputs={cfg.n_inputs}, outputs={len(cfg.output_nets)}, "
                f"ffs={cfg.n_ffs}, fanin_reach={cfg.fanin_reach()})"
            )
        from repro_torch.kernels.frontend import validate_chip_frontend

        validate_chip_frontend(cfg, new_chip.frontend_spec(),
                               self.geometry.frontend.n_features)
        done = self.flush()
        R = self.n_replicas
        self._replica_configs[slot * R : (slot + 1) * R] = [
            replicate_config(cfg, r) for r in range(R)
        ]
        self.chips[slot] = new_chip
        self._thr_raw = np.array(
            [c.score_threshold_raw for c in self.chips], np.int32)
        if self.config.backend == "kernel":
            self._stack = self._stack.swap_chip(slot, cfg)
            self._out_weight = self._lut_ops.decode_plan(
                [c.config for c in self.chips], self._stack.n_outputs)
            if self._frontend is not None:
                self._frontend = self._frontend.swap_chip(
                    slot, cfg, new_chip.frontend_spec(), stack=self._stack)
        else:
            self._multisim = MultiFabricSim(
                self._replica_configs, geometry=self.geometry)
        self._frame_sims[slot] = None
        return done

    # ------------------------------------------------------------ report
    def report(self) -> Dict[str, object]:
        """Per-chip trigger/reduction accounting over the stream, the
        host-link bytes (on the wire, and what dense egress would have
        shipped), the per-replica SEU disagreement counters and the
        per-stage host timing (seconds and calls per stage; the fused
        pass is one ``launch_fused`` entry, the staged host path itemizes
        it)."""
        cfg = self.config
        per_chip = []
        for i, st in enumerate(self._stats):
            frac = st.fraction_kept()
            per_chip.append({
                "chip": i,
                "n_in": st.n_in,
                "n_kept": st.n_kept,
                "n_dispatches": st.n_dispatches,
                "n_shed": st.n_shed,
                "fraction_kept": frac,
                "data_reduction_factor": 1.0 / max(frac, 1e-9),
                "link_rate_in_gbps": cfg.hit_rate_hz * cfg.bits_per_hit / 1e9,
                "link_rate_out_gbps":
                    cfg.hit_rate_hz * cfg.bits_per_hit * frac / 1e9,
                "seu_disagreements": list(st.disagreements),
            })
        n_in = sum(s.n_in for s in self._stats)
        n_kept = sum(s.n_kept for s in self._stats)
        dt = (
            (self._t_last - self._t_start)
            if (self._t_start is not None and self._t_last is not None)
            else 0.0
        )
        return {
            "backend": cfg.backend,
            "device": str(self.device),
            "layout": self.layout,
            "redundancy": cfg.redundancy,
            "n_replicas": self.n_replicas,
            "sparse": cfg.sparse,
            "n_chips": self.n_chips,
            "n_in": n_in,
            "n_kept": n_kept,
            "fraction_kept": n_kept / n_in if n_in else 1.0,
            "events_per_s": n_in / dt if dt > 0 else float("nan"),
            "queue_depth": self.queue_depth,
            "inflight_batches": len(self._inflight),
            "seu_disagreement_total": int(
                sum(sum(s.disagreements) for s in self._stats)),
            "link_bytes": {
                "on_wire": self._link_bytes_wire,
                "dense_equivalent": self._link_bytes_dense,
                "wire_reduction": (
                    self._link_bytes_dense / self._link_bytes_wire
                    if self._link_bytes_wire
                    and self._link_bytes_wire != self._link_bytes_dense
                    else 1.0),
            },
            "stages": {
                k: {"seconds": self._stage_s[k], "calls": self._stage_n[k]}
                for k in sorted(self._stage_s)
            },
            "per_chip": per_chip,
        }
