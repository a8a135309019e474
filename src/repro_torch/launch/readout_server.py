"""Multi-chip streaming readout server (PyTorch port).

The JAX package's launch/readout_server.py, with both ingestion forms:

    submit_frames(chip, frames, y0)   RAW charge frames
    submit(chip, features)            pre-featurized events
      -> deadline admission           (overload_policy "shed"/"degrade":
                                       a submission whose predicted
                                       completion blows deadline_us is
                                       shed, seq None, counted per chip)
      -> micro-batch queue            (an entry a run of consecutive
                                       seqs of one chip and one kind: a
                                       submitted block stays whole until
                                       the coalesce cuts it where a batch
                                       ends; coalesce: the effective
                                       max_batch / max_latency_s, shrunk
                                       and re-grown by the service time
                                       under a deadline)
      -> device passes, one per kind  (frames: kernels/frontend.py,
                                       yprofile -> quantize -> bit gather
                                       -> fabric kernel + TMR vote ->
                                       score -> keep/drop; features: host
                                       encode, then lut_eval/ops.py
                                       fabric_eval_multi_scored)
      -> egress, dense or sparse      (sparse=True, or the degrade
                                       ladder's sparse_egress rung: only
                                       the kept events' (flat index,
                                       score) pairs, packed on the device
                                       by kernel B6)
      -> pinned host copy, drained    (poll never blocks; flush does)
      -> background scrub             (scrub_interval=k: every k
                                       dispatches, read back one replica's
                                       live truth tables, CRC-verify them
                                       against the golden store and
                                       re-encode a corrupted replica)
      -> per-chip trigger report      (rates, reduction, link bytes,
                                       per-stage host timing, per-replica
                                       SEU disagreement counters, scrub
                                       detections and heals, latency
                                       histograms, the deadline ledger and
                                       the degrade ladder)

The server is the loop. Each pass goes to one of two scoring paths
(launch/scoring.py), picked once from ``ServerConfig.backend``: "kernel"
is the device path; "host" is the staged numpy oracle, bit-identical to
the kernel path given the same features. The kernel path serves over
slabs of a device plan (``rebind_mesh`` moves them); their results are
merged on the host at the drain, bit-identical to one slab's.

Pipelining: a frames dispatch stages only its real rows, into a slot of
a ring of pinned host buffers, and copies them to the device without
blocking; a CUDA event behind the copies guards the slot until it comes
round again. Every launch enqueues its work on its device's current CUDA
stream, copies its small results (dense score/keep/disagree, or the
sparse count and disagree counts) into pinned host memory without
blocking, and records a CUDA event a slab behind them; ``poll`` retires a
batch only once every one of its events has completed, and up to
``pipeline_depth`` batches stay in flight. A sparse batch's kept prefix
``idx[:count]``, ``vals[:count]`` is copied at the drain, on a side
stream of the slab's device, so it waits for no later batch. A scrub
readback is the same kind of copy: the replica's row of ``tables`` goes
to pinned memory behind a CUDA event and is verified on a later scrub
step, once the event has completed.

Every time comes from the one injected ``clock``.

The multi-tenant fleet (launch/fleet.py) drives one server a geometry
bucket through three hooks: ``envelope=`` pins the server's geometry to
the bucket's (kernels.lut_eval.ops.bucket_envelope), ``cancel_queued``
drops an evicted tenant's queued events, and ``rebind_mesh`` binds the
server to the plan the fleet re-makes after a grow or shrink (a flush,
then the slabs whose device changed move). The fleet, not the server, reads
``ServerConfig.tenant_quota_queued``; its admission misses read the
server's ``shape_misses``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import (Callable, Deque, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.bitstream import GoldenImageStore
from repro_torch.core.fabric import (
    FrontendSpec,
    StackGeometry,
    check_stackable,
    packed_table_image,
)
from repro_torch.core.readout import ReadoutChip
from repro_torch.core.tmr import (
    N_REPLICAS,
    inject_seu as _inject_seu_config,
    replica_table_images,
    replicate_config,
)
from repro_torch.data.smartpixel import N_FEATURES as _N_FEATURES
from repro_torch.data.smartpixel import N_T, N_X, N_Y
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.lut_eval.ops import merge_kept
from repro_torch.launch.scoring import HostPath, KernelPath, Sparse
from repro_torch.parallel.compression import (
    DENSE_BYTES_PER_EVENT,
    SPARSE_BYTES_PER_EVENT,
    SPARSE_HEADER_BYTES,
)
from repro_torch.stages import Stages

# The degrade ladder's rungs, in the default order (cheapest concession
# first). None changes the keep/drop of an admitted event:
#   scrub_relax     widen the scrub interval by SCRUB_RELAX_FACTOR
#   scrub_crc_only  keep CRC detection live, defer the heals until the
#                   rung exits
#   sparse_egress   ship only the kept events on the host link
DEGRADE_RUNGS = ("scrub_relax", "scrub_crc_only", "sparse_egress")
SCRUB_RELAX_FACTOR = 4

# The latency histograms' one shared grid: 8 log-scale buckets a decade
# from 1 us to 100 s, plus an underflow and an overflow slot (fixed, so
# the state stays O(1) and histograms merge across chips and runs).
_HIST_BUCKETS_PER_DECADE = 8
_HIST_DECADES = 8
_HIST_N = _HIST_BUCKETS_PER_DECADE * _HIST_DECADES
_HIST_EDGES_US = np.power(
    10.0, np.arange(_HIST_N + 1) / _HIST_BUCKETS_PER_DECADE)


class LatencyHistogram:
    """Streaming latency histogram on the shared log-scale grid.

    ``add_many`` is one bincount per drained batch; percentiles
    interpolate log-linearly inside the owning bucket, so they are exact
    to within one bucket width (~33% at 8 buckets a decade)."""

    __slots__ = ("counts", "_sum_us", "_max_us")

    def __init__(self):
        # counts[0] = underflow (<1 us), [1..N] = grid, [N+1] = overflow
        self.counts = np.zeros(_HIST_N + 2, np.int64)
        self._sum_us = 0.0
        self._max_us = 0.0

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def add(self, us: float) -> None:
        self.add_many(np.asarray([us], np.float64))

    def add_many(self, us: np.ndarray) -> None:
        us = np.asarray(us, np.float64)
        if us.size == 0:
            return
        idx = np.zeros(us.shape, np.int64)
        pos = us >= 1.0
        if pos.any():
            idx[pos] = 1 + np.minimum(
                (np.log10(us[pos]) * _HIST_BUCKETS_PER_DECADE).astype(
                    np.int64),
                _HIST_N,  # >= the top edge lands in the overflow slot
            )
        self.counts += np.bincount(idx, minlength=_HIST_N + 2)
        self._sum_us += float(us.sum())
        self._max_us = max(self._max_us, float(us.max()))

    def merge(self, other: "LatencyHistogram") -> None:
        self.counts += other.counts
        self._sum_us += other._sum_us
        self._max_us = max(self._max_us, other._max_us)

    def percentile(self, q: float) -> float:
        """q in [0, 100] -> latency in us, log-interpolated in-bucket."""
        total = int(self.counts.sum())
        if total == 0:
            return 0.0
        target = total * (q / 100.0)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, target, side="left"))
        if b <= 0:
            return float(_HIST_EDGES_US[0])     # underflow: "< 1 us"
        if b >= _HIST_N + 1:
            return float(self._max_us)          # overflow: observed max
        lo, hi = float(_HIST_EDGES_US[b - 1]), float(_HIST_EDGES_US[b])
        inside = int(self.counts[b])
        frac = ((target - float(cum[b - 1])) / inside) if inside else 0.0
        return lo * (hi / lo) ** min(max(frac, 0.0), 1.0)

    def cdf(self) -> List[List[float]]:
        """[[upper edge us, cumulative fraction], ...] over the non-empty
        buckets; underflow folds into the first point, and the last point
        is the observed max at fraction 1.0."""
        total = int(self.counts.sum())
        if total == 0:
            return []
        cum = np.cumsum(self.counts)
        out: List[List[float]] = []
        prev = -1
        for i in range(1, _HIST_N + 2):
            c = int(cum[i])
            if c != prev:
                edge = (float(_HIST_EDGES_US[i - 1]) if i <= _HIST_N
                        else float(self._max_us))
                out.append([round(edge, 3), round(c / total, 6)])
                prev = c
            if c == total:
                break
        return out

    def summary(self) -> Dict[str, float]:
        n = self.count
        return {
            "count": n,
            "mean_us": (self._sum_us / n) if n else 0.0,
            "max_us": self._max_us,
            "p50_us": self.percentile(50.0),
            "p99_us": self.percentile(99.0),
            "p999_us": self.percentile(99.9),
        }


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Micro-batching knobs; the same fields, defaults and validation
    errors as the JAX package's ServerConfig (its docstring documents
    each knob). ``tenant_quota_queued`` caps each tenant's outstanding
    events in a fleet (launch/fleet.py reads it; a lone server does
    not)."""

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

    @property
    def n_replicas(self) -> int:
        return N_REPLICAS if self.redundancy == "tmr" else 1

    @property
    def effective_layout(self) -> str:
        """The layout actually served: None selects "bitsliced"."""
        return self.layout if self.layout is not None else "bitsliced"

    @property
    def deadline_s(self) -> Optional[float]:
        return None if self.deadline_us is None else self.deadline_us * 1e-6


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
    # submissions shed by deadline admission (counted, never silent)
    n_shed: int = 0
    # per-replica SEU health: events where replica r's output word was
    # voted against (always zeros on a healthy or non-redundant server)
    disagreements: List[int] = dataclasses.field(default_factory=list)

    def fraction_kept(self) -> float:
        return self.n_kept / self.n_in if self.n_in else 1.0


class _Run(NamedTuple):
    """A queue entry: the events ``seq0`` .. ``seq0 + n - 1`` of one chip
    and one kind, enqueued at ``t_enq``. ``payload`` holds n rows an
    array: kind "frames" (frames (n, T, Y, X) float32, y0 (n,) float32),
    kind "features" ((n, n_features) float64,)."""

    seq0: int
    n: int
    chip: int
    kind: str
    payload: Tuple[np.ndarray, ...]
    t_enq: float

    def split(self, k: int) -> Tuple["_Run", "_Run"]:
        """(its first ``k`` events, the rest), the payload as views."""
        head = tuple(a[:k] for a in self.payload)
        rest = tuple(a[k:] for a in self.payload)
        return (self._replace(n=k, payload=head),
                self._replace(seq0=self.seq0 + k, n=self.n - k, payload=rest))


@dataclasses.dataclass
class _Batch:
    """One pass in flight: per chip its seqs (Python ints), counts and
    enqueue times (float64, an event), its stage trace, a record a slab
    (``Dense`` or ``Sparse``, kept whatever the ladder does before the
    drain), the CUDA events behind the slabs' pinned copies, and a
    (start, end) event pair a CUDA slab (``dispatch_device``)."""

    seqs: List[List[int]]
    counts: List[int]
    t_enq: List[np.ndarray]
    trace: Dict[str, float]
    slabs: List = dataclasses.field(default_factory=list)
    ready: List = dataclasses.field(default_factory=list)
    dispatch: List = dataclasses.field(default_factory=list)


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy of a device tensor into pinned host memory."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
        x, non_blocking=True)


@dataclasses.dataclass
class _Readback:
    """One scrub sample in flight: frame ``fi`` at generation ``gen``.
    On the card ``image`` is a pinned host tensor filled by an async copy
    of ``source`` (the sampled row of ``tables``, held so its storage
    outlives the copy) and ``ready`` the CUDA event behind it; on the CPU
    ``image`` is the row itself and ``ready`` None."""

    fi: int
    gen: int
    image: torch.Tensor
    ready: object
    source: torch.Tensor
    prev_pass: int
    issue_idx: int


class ReadoutServer:
    """Serves N configured ReadoutChips from one micro-batched event loop."""

    def __init__(
        self,
        chips: Sequence[ReadoutChip],
        config: ServerConfig = ServerConfig(),
        clock=time.monotonic,
        envelope: Optional[StackGeometry] = None,
        *,
        device=None,
        mesh=None,
    ):
        """``device`` is where the fused pass (kernel backend) or the
        featurizer (host backend) runs: None means CUDA, and without CUDA
        only an explicit ``device="cpu"`` is accepted. The kernel backend
        serves over ``make_readout_mesh(len(chips), device)``: the chips
        split over every card for None or "cuda", one card for "cuda:N",
        the CPU for "cpu"; a given ``mesh`` (launch.mesh.ReadoutMesh)
        replaces that plan, and ``rebind_mesh`` moves the server to
        another.

        ``envelope`` pins the server's fixed geometry to a given
        StackGeometry in place of the chips' union (the fleet's bucket,
        kernels.lut_eval.ops.bucket_envelope): every chip must fit it,
        the stack and the fused pass's encode plan pad to it, and its
        fan-in-reach budget decides banded or dense (``config.band`` is
        not consulted). Servers that share an envelope launch their
        kernels with the same shapes, so a chip that fits admits through
        ``reconfigure`` without a new launch signature."""
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
        if envelope is not None:
            for i, c in enumerate(self.chips):
                if not envelope.admits(c.config):
                    raise ValueError(
                        f"chip {i} does not fit the pinned envelope "
                        f"{envelope} (levels={len(c.config.level_sizes)}, "
                        f"widest={max(c.config.level_sizes, default=1)}, "
                        f"inputs={c.config.n_inputs}, "
                        f"outputs={len(c.config.output_nets)}, "
                        f"fanin_reach={c.config.fanin_reach()})")
            geo = envelope
            banded = (envelope.fanin_reach is not None
                      and envelope.fanin_reach < envelope.n_levels)
        else:
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
        # is _replica_configs[c*R + r]), upsets included
        self._replica_configs: List = [
            replicate_config(c.config, r)
            for c in self.chips for r in range(self.n_replicas)
        ]
        # per-stage host seconds and calls (report()["stages"]); spans
        # while a profiler records
        self._stages = Stages(clock)
        if config.backend == "kernel":
            self._path = KernelPath(
                self.chips, config, self._stages, clock,
                pinned=(None if envelope is None else
                        dataclasses.replace(self.geometry, frontend=None)),
                device=self.device, mesh=mesh)
        else:
            self._path = HostPath(
                self.chips, config, self._stages, clock,
                geometry=self.geometry,
                replica_configs=self._replica_configs, device=self.device)

        self._queue: Deque[_Run] = collections.deque()
        self._queued = 0            # events in the queue's runs
        # runs and events that entered the queue (report()["queue"])
        self._runs_in = 0
        self._events_in = 0
        self._seq = 0
        self._inflight: Deque[_Batch] = collections.deque()
        self._stats = [
            ChipStreamStats(disagreements=[0] * self.n_replicas)
            for _ in self.chips
        ]
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None
        self._link_bytes_wire = 0
        self._link_bytes_dense = 0

        # ---- latency ledger: end to end (enqueue -> drained) per chip and
        # in total, and the queue-wait (enqueue -> coalesce) and service
        # (coalesce -> drained) parts of the same batches
        self._hist_total = LatencyHistogram()
        self._hist_queue = LatencyHistogram()
        self._hist_service = LatencyHistogram()
        self._hist_chip = [LatencyHistogram() for _ in self.chips]
        self._last_batch_trace: Dict[str, float] = {}
        self._n_batches_drained = 0

        # ---- deadline enforcement
        self._deadline_met = 0
        self._deadline_missed = 0
        # EWMA of the batch service time: admission's look-ahead
        self._service_ewma_s = 0.0
        # (t_drained, n_events) of recent batches: admission's backlog term
        self._drain_hist: Deque[Tuple[float, int]] = collections.deque(
            maxlen=16)
        # adaptive micro-batch knobs: the coalescer reads THESE, the
        # config fields stay the ceilings
        self._eff_max_batch = config.max_batch
        self._min_batch = min(config.min_batch, config.max_batch)
        if (config.deadline_s is not None
                and config.overload_policy != "observe"):
            # never coalesce past half the budget: the rest is service
            self._lat_cap_s = min(config.max_latency_s,
                                  config.deadline_s / 2.0)
        else:
            self._lat_cap_s = config.max_latency_s
        self._eff_max_latency_s = self._lat_cap_s
        self._batch_shrinks = 0
        self._batch_grows = 0

        # ---- degrade ladder: level k = the first k configured rungs on
        self._rung_level = 0
        self._ladder_transitions: List[Dict[str, object]] = []
        self._window_missed = 0
        self._window_drained = 0
        # (slot, replica) frames whose heal scrub_crc_only deferred
        self._deferred_heals: List[Tuple[int, int]] = []

        # ---- scrubbing (readback -> verify -> heal). One image layout
        # for readbacks and golden digests, the path's (replica_images)
        self._golden = GoldenImageStore()
        for i in range(self.n_chips):
            self._register_golden(i)
        self._dispatch_idx = 0
        n_frames = self.n_chips * self.n_replicas
        self._scrub_rr = 0          # round-robin frame pointer
        self._scrub_cycles = 0      # completed round-robin passes
        self._scrub_steps = 0
        self._scrub_detections = 0
        self._scrub_healed_bits = 0
        # per detection: dispatches since the frame's last clean scrub
        self._scrub_latencies: List[int] = []
        self._scrub_per_frame = [0] * n_frames
        # disagreement count at each frame's last scrub (steering key)
        self._scrub_last_dis = [0] * n_frames
        # dispatch index at each frame's last scrub (latency reference)
        self._scrub_last_pass = [0] * n_frames
        # readbacks issued and not yet verified (a path's deferred_scrub)
        self._scrub_pending: Deque[_Readback] = collections.deque()
        # bumped whenever a frame is re-encoded (inject, heal,
        # reconfigure): an older pending sample is stale
        self._frame_gen = [0] * n_frames
        # the network front door's stats() (net/ingress.py attaches it)
        self._net_stats_provider: Optional[Callable[[], Dict]] = None
        # hot swaps, and launches at a (path, egress, batch width) launched
        # before, that added a build or a launch signature: 0 expected
        # (_launch_counted; the fleet's admission misses read it)
        self.shape_misses = 0
        self._launch_keys: set = set()

    def attach_net_stats(self, provider: Optional[Callable[[], Dict]]
                         ) -> None:
        """Register the network front door's ``stats`` callable; its
        snapshot appears under ``report()["net"]``. Pass None to detach."""
        self._net_stats_provider = provider

    # ------------------------------------------------------------- intake
    @property
    def n_chips(self) -> int:
        return len(self.chips)

    @property
    def queue_depth(self) -> int:
        """Events queued (admitted, not yet coalesced)."""
        return self._queued

    def _check_chip(self, chip: int) -> None:
        if not 0 <= chip < self.n_chips:
            raise ValueError(
                f"chip must be in [0, {self.n_chips}), got {chip}")

    def _admit(self, chip: int, n: int, now: float) -> int:
        """Deadline admission (overload_policy "shed"/"degrade") of ``n``
        events submitted together at ``now``, judged in turn as if those
        before had been queued: an event is shed, counted in the chip's
        ``n_shed``, when the worse of two predictors blows the deadline:
        the queue head's wait, or the backlog's drain time at the recent
        drain rate, plus the EWMA service time. An idle server always
        admits (the only way to refresh a stale EWMA). Only the backlog
        grows along a block, so the admitted events are a prefix; returns
        its length."""
        dl = self.config.deadline_s
        if dl is None or self.config.overload_policy == "observe" or not n:
            return n
        # the first event of a block on an idle server is admitted
        lo = 0 if (self._queue or self._inflight) else 1
        # the head's wait: a block put into an empty queue is its head
        wait = (now - self._queue[0].t_enq) if self._queue else 0.0
        rate = self._drain_rate()
        ewma = self._service_ewma_s

        def admits(k: int) -> bool:     # with k of the block queued
            backlog = ((self._queued + k) / rate) if rate > 0.0 else 0.0
            return max(wait, backlog) + ewma < dl

        # the first k in [lo, n) that admits(k) refuses, else n
        hi = n
        while lo < hi:
            mid = (lo + hi) // 2
            if admits(mid):
                lo = mid + 1
            else:
                hi = mid
        self._stats[chip].n_shed += n - lo
        return lo

    def _put(self, chip: int, kind: str, payload: Tuple[np.ndarray, ...]
             ) -> List[Optional[int]]:
        """Queue the admitted prefix of a block of events (``payload``'s
        rows, one kind, one chip) as one run; returns their seqs, None
        for each shed event."""
        now = self._clock()
        n_in = len(payload[0])
        n = self._admit(chip, n_in, now)
        seq0 = self._seq
        if n:
            if n < n_in:
                payload = tuple(a[:n] for a in payload)
            self._queue.append(_Run(seq0, n, chip, kind, payload, now))
            self._seq += n
            self._queued += n
            self._runs_in += 1
            self._events_in += n
        return [*range(seq0, seq0 + n), *([None] * (n_in - n))]

    def submit(self, chip: int, features: np.ndarray) -> Optional[int]:
        """Enqueue one pre-featurized event for one chip; returns its seq,
        or None when deadline admission shed it."""
        self._check_chip(chip)
        return self._put(chip, "features",
                         (np.asarray(features, np.float64)[None],))[0]

    def submit_batch(self, chip: int, X: np.ndarray) -> List[Optional[int]]:
        """Enqueue a block of pre-featurized events (rows of X); shed rows
        yield None."""
        self._check_chip(chip)
        with self._stages.time("submit"):
            return self._put(chip, "features", (np.asarray(X, np.float64),))

    def cancel_queued(self, chip: int) -> int:
        """Drop every QUEUED (admitted, not yet coalesced) event of one
        chip slot; returns how many. The fleet's eviction port: a tenant
        evicted without draining loses its queued events here, counted as
        ``evicted_while_queued``. Events already in an in-flight batch
        are not cancelled; they drain as usual. Other chips' events are
        untouched."""
        self._check_chip(chip)
        n = sum(r.n for r in self._queue if r.chip == chip)
        if n:
            self._queue = collections.deque(
                r for r in self._queue if r.chip != chip)
            self._queued -= n
        return n

    def submit_frames(
        self, chip: int, frames: np.ndarray, y0: np.ndarray
    ) -> List[Optional[int]]:
        """Enqueue raw-frame events: (n, T, Y, X) charge + (n,) y0; returns
        their seqs, None for each event deadline admission shed. The block
        is queued whole, its frames as given (not copied) and its y0
        copied. Frames and features of one micro-batch score as two
        passes, so results follow the passes, not the global seq order
        (every event stays seq-tagged)."""
        self._check_chip(chip)
        with self._stages.time("submit"):
            frames = np.asarray(frames, np.float32)
            y0 = np.array(y0, np.float32)
            if frames.ndim != 4 or frames.shape[1:] != (N_T, N_Y, N_X) \
                    or y0.shape != (len(frames),):
                raise ValueError(
                    f"need frames (n, {N_T}, {N_Y}, {N_X}) and y0 (n,), "
                    f"got {frames.shape} and {y0.shape}")
            return self._put(chip, "frames", (frames, y0))

    # ------------------------------------------------------------ the loop
    def poll(self) -> List[ScoredEvent]:
        """One turn of the event loop: retire finished in-flight batches,
        dispatch if a micro-batch is due and the pipeline has room, and
        return completed results. Never blocks."""
        with self._stages.time("poll"):
            out = self._drain_ready()
            if (self._due()
                    and len(self._inflight) <= self.config.pipeline_depth):
                out.extend(self._dispatch(*self._coalesce()))
            return out

    def flush(self) -> List[ScoredEvent]:
        """Force out everything: queued events and in-flight results.
        With scrubbing on it also settles the scrub loop: readbacks in
        flight are resolved, and a last steered check chases counters
        that folded only during this drain."""
        out: List[ScoredEvent] = []
        while self._queue:
            out.extend(self._dispatch(*self._coalesce()))
            while len(self._inflight) > self.config.pipeline_depth:
                out.extend(self._drain_one())       # flush MAY block
        while self._inflight:
            out.extend(self._drain_one())
        if self.config.scrub_interval is not None:
            with self._stages.time("scrub"):
                self.scrub_flush()
                if self.config.scrub_mode == "steered":
                    self._scrub_steered_check()
                    self.scrub_flush()      # device idle: resolve it now
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
        # the EFFECTIVE knobs: under deadline pressure _adapt_batch
        # shrinks both below the config ceilings
        if not self._queue:
            return False
        if self._queued >= self._eff_max_batch:
            return True
        oldest = self._queue[0].t_enq
        return (self._clock() - oldest) >= self._eff_max_latency_s

    def _coalesce(self) -> Tuple[List[_Run], List[_Run]]:
        """The next micro-batch off the queue, up to the effective
        max_batch events, split by kind: (frame runs, feature runs). Runs
        are taken whole; the last is cut where the batch ends, and its
        rest stays at the head with its enqueue time."""
        with self._stages.time("coalesce"):
            budget = min(self._queued, self._eff_max_batch)
            self._queued -= budget
            runs: List[_Run] = []
            while budget:
                run = self._queue.popleft()
                if run.n > budget:
                    run, rest = run.split(budget)
                    self._queue.appendleft(rest)
                runs.append(run)
                budget -= run.n
            return ([r for r in runs if r.kind == "frames"],
                    [r for r in runs if r.kind == "features"])

    def _dispatch(self, frame_runs: List[_Run],
                  feat_runs: List[_Run]) -> List[ScoredEvent]:
        """Launch one micro-batch (frames and features as two passes),
        retire whatever finished, then run the background scrub step when
        it is due: after the drain, so freshly folded disagreement
        counters can steer it, while the batch just launched is still on
        the device."""
        if not frame_runs and not feat_runs:
            return []
        if self._t_start is None:
            self._t_start = self._clock()
        if frame_runs:
            self._inflight.append(self._launch_counted(
                "frames", self._launch_frames, frame_runs))
        if feat_runs:
            self._inflight.append(self._launch_counted(
                "features", self._launch_features, feat_runs))
        done = self._drain_ready()
        self._dispatch_idx += 1
        si = self._effective_scrub_interval()
        if si is not None and self._dispatch_idx % si == 0:
            self.scrub_step()
        return done

    def _launch_counted(self, kind: str, launch, runs: List[_Run]
                        ) -> _Batch:
        """``launch(runs)``, counted in ``shape_misses`` if it added an
        nvcc build, a library load or a launch signature
        (kernels/build.py miss_counts) at a (path, egress, batch width)
        this server had launched before: every shape is a function of the
        fixed geometry and the batch width alone, so only a new width may
        add one (the host path featurizes each chip at its own count)."""
        counts: Dict[int, int] = collections.Counter()
        for r in runs:
            counts[r.chip] += r.n
        key = (kind, self._sparse_active(),
               self._path.widths(counts.values()))
        before = build.miss_counts()
        batch = launch(runs)
        if key in self._launch_keys and build.miss_counts() != before:
            self.shape_misses += 1
        self._launch_keys.add(key)
        return batch

    def _effective_scrub_interval(self) -> Optional[int]:
        """The configured scrub interval, widened by SCRUB_RELAX_FACTOR
        while the ladder's scrub_relax rung is active."""
        si = self.config.scrub_interval
        if si is not None and self._rung_active("scrub_relax"):
            si = si * SCRUB_RELAX_FACTOR
        return si

    def _open_batch(self, runs: List[_Run]):
        """A batch of ``runs`` opened at the coalesce, and per chip the
        payloads of its runs, in seq order."""
        per_chip: List[List[_Run]] = [[] for _ in self.chips]
        for r in runs:
            per_chip[r.chip].append(r)
        seqs: List[List[int]] = []
        for rs in per_chip:
            chip_seqs: List[int] = []
            for r in rs:
                chip_seqs.extend(range(r.seq0, r.seq0 + r.n))
            seqs.append(chip_seqs)
        counts = [len(q) for q in seqs]
        for i, n in enumerate(counts):
            if n:
                self._stats[i].n_dispatches += 1
        t_enq = [np.repeat(np.array([r.t_enq for r in rs], np.float64),
                           [r.n for r in rs]) for rs in per_chip]
        trace = {"t_enqueued": min(r.t_enq for r in runs),
                 "t_coalesced": self._clock()}
        return _Batch(seqs, counts, t_enq, trace), \
            [[r.payload for r in rs] for rs in per_chip]

    def _sparse_active(self) -> bool:
        """Sparse egress is on when configured or forced by the degrade
        ladder's sparse_egress rung (keep/drop stays exact: only the
        scores of dropped events stop crossing the link)."""
        return self.config.sparse or self._rung_active("sparse_egress")

    def _launch_frames(self, runs: List[_Run]) -> _Batch:
        """Frames: the path's pass (kernel: ONE fused device pass, timed
        ``launch_fused``; host: the same pipeline STAGED, each stage
        materialized and timed, ``staged_featurize`` / ``staged_encode`` /
        ``staged_score``)."""
        with self._stages.time("coalesce"):
            batch, per_chip_fy = self._open_batch(runs)
        return self._enqueue(batch, *self._path.score_frames(
            per_chip_fy, batch.counts, batch.trace, self._sparse_active()))

    def _launch_features(self, runs: List[_Run]) -> _Batch:
        """Features: host encoding (quantize + offset-binary bits, timed
        ``encode_host``), then the path's ONE chip-batched scoring pass
        (timed ``launch_score``)."""
        with self._stages.time("coalesce"):
            batch, per_chip_X = self._open_batch(runs)
        with self._stages.time("encode_host"):
            per_chip_bits: List[np.ndarray] = []
            for i, chip in enumerate(self.chips):
                if per_chip_X[i]:
                    bits = chip.encode_features(
                        np.concatenate([X for X, in per_chip_X[i]]))
                else:
                    bits = np.zeros((0, chip.config.n_inputs), np.uint8)
                per_chip_bits.append(bits)
        batch.trace["t_encoded"] = self._clock()
        return self._enqueue(batch, *self._path.score_features(
            per_chip_bits, batch.counts, batch.trace, self._sparse_active()))

    def _enqueue(self, batch: _Batch, slabs: List, starts: List) -> _Batch:
        """Per CUDA slab: copy what the drain reads first into pinned
        memory without blocking (a dense record's score, keep and dis; a
        sparse one's count and dis, its idx and vals staying on the device
        until the drain copies their kept prefixes), then record a timed
        CUDA event: its batch is ready once every event has completed, and
        with the slab's start mark it brackets ``dispatch_device``."""
        with self._stages.time("enqueue_d2h"):
            for rec, start in zip(slabs, starts):
                if not (torch.is_tensor(rec.dis) and rec.dis.is_cuda):
                    continue
                dev = rec.dis.device
                with torch.cuda.device(dev):
                    if isinstance(rec, Sparse):
                        rec.count, rec.dis = _pinned(rec.count), _pinned(
                            rec.dis)
                    else:
                        rec.score, rec.keep, rec.dis = (
                            _pinned(rec.score), _pinned(rec.keep),
                            _pinned(rec.dis))
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record(torch.cuda.current_stream(dev))
                batch.ready.append(ev)
                if start is not None:
                    batch.dispatch.append((start, ev))
            batch.slabs = slabs
            return batch

    def _head_ready(self) -> bool:
        """Non-blocking probe: has every event of the OLDEST in-flight
        batch completed (results already on the host always have)?"""
        if not self._inflight:
            return False
        return all(ev.query() for ev in self._inflight[0].ready)

    def _drain_ready(self) -> List[ScoredEvent]:
        """Retire every finished in-flight batch, oldest first, never
        blocking."""
        out: List[ScoredEvent] = []
        while self._head_ready():
            out.extend(self._drain_one())
        return out

    def _drain_one(self) -> List[ScoredEvent]:
        """Materialize the OLDEST in-flight batch and fold it into the
        reports. ``drain_wait`` is the sync plus the fold: its child
        ``drain_wait.sync`` is the host blocked on the batch's CUDA
        events, ``drain_wait.fold`` the host work on the results (the
        kept-prefix copies, the slab merge, a ``ScoredEvent`` an event,
        the disagreement fold); ``observe`` follows (the latency ledger
        and the result sort). With sparse egress only the count prefix of
        the packed (idx, score) pair crosses the host link: the measured
        wire bytes. The slabs' results are merged here, in slab order: a
        sparse batch is one packet of ascending flat indices over the
        whole (C, B)."""
        if not self._inflight:
            return []
        batch = self._inflight.popleft()
        with self._stages.time("drain_wait"):
            with self._stages.time("drain_wait.sync"):
                for ev in batch.ready:
                    ev.synchronize()                    # blocks here
            with self._stages.time("drain_wait.fold"):
                results = self._fold_batch(batch)
        t_done = self._clock()      # the host has seen the batch complete
        self._t_last = t_done
        with self._stages.time("observe"):
            self._observe_batch(batch, t_done)
            results.sort(key=lambda r: r.seq)
        return results

    def _fold_batch(self, batch: _Batch) -> List[ScoredEvent]:
        """A completed batch's results on the host, folded into the
        per-chip counters, the link bytes and the disagreement counters;
        and the device seconds of each of its slabs' dispatches."""
        for start, end in batch.dispatch:
            self._stages.add("dispatch_device",
                             start.elapsed_time(end) * 1e-3)
        results: List[ScoredEvent] = []
        slabs, counts, per_chip_seq = batch.slabs, batch.counts, batch.seqs
        n_events = int(sum(counts))
        self._link_bytes_dense += DENSE_BYTES_PER_EVENT * n_events
        dis = np.concatenate([np.asarray(r.dis) for r in slabs])
        if isinstance(slabs[0], Sparse):
            B = slabs[0].width
            idx_h, vals_h = merge_kept(
                [(r.c0, *self._path.kept_prefix(r)) for r in slabs], B)
            n_kept = len(idx_h)
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
            score = np.concatenate([np.asarray(r.score) for r in slabs])
            keep = np.concatenate([np.asarray(r.keep) for r in slabs])
            self._link_bytes_wire += DENSE_BYTES_PER_EVENT * n_events
            for i in range(self.n_chips):
                n = counts[i]
                if n:
                    self._fold_chip(results, i, per_chip_seq[i],
                                    score[i, :n].astype(np.int64),
                                    keep[i, :n])
        self._fold_disagreements(dis)
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

    # ------------------------------------------- latency / deadline loop
    def reset_latency_metrics(self) -> None:
        """Zero the latency/deadline ledger (histograms, met/missed/shed
        counters, the EWMA and the drain-rate window) without touching
        trigger accounting, scrub state or the ladder level — to measure
        a warmed-up server."""
        self._hist_total = LatencyHistogram()
        self._hist_queue = LatencyHistogram()
        self._hist_service = LatencyHistogram()
        self._hist_chip = [LatencyHistogram() for _ in self.chips]
        self._last_batch_trace = {}
        self._n_batches_drained = 0
        self._deadline_met = 0
        self._deadline_missed = 0
        self._service_ewma_s = 0.0
        self._drain_hist.clear()
        self._window_missed = 0
        self._window_drained = 0
        self._batch_shrinks = 0
        self._batch_grows = 0
        self._t_start = None
        self._t_last = None
        for st in self._stats:
            st.n_shed = 0

    def _observe_batch(self, batch: _Batch, t_done: float) -> None:
        """Fold one drained batch into the latency ledger (every admitted
        event, kept or not, sparse or dense), then let the deadline
        machinery act: the EWMA service update, adaptive batch sizing and
        the ladder evaluation."""
        trace = batch.trace
        trace["t_drained"] = t_done
        self._last_batch_trace = trace
        self._n_batches_drained += 1
        t_co = trace.get("t_coalesced", t_done)
        dl = self.config.deadline_s
        n_batch = 0
        for i, t_enq in enumerate(batch.t_enq):
            if not t_enq.size:
                continue
            lat_s = np.maximum(t_done - t_enq, 0.0)
            us = lat_s * 1e6
            self._hist_chip[i].add_many(us)
            self._hist_total.add_many(us)
            self._hist_queue.add_many(np.maximum(t_co - t_enq, 0.0) * 1e6)
            n_batch += t_enq.size
            if dl is not None:
                missed = int((lat_s > dl).sum())
                self._deadline_missed += missed
                self._deadline_met += t_enq.size - missed
                self._window_missed += missed
        self._hist_service.add(max(t_done - t_co, 0.0) * 1e6)
        self._window_drained += n_batch
        svc = max(t_done - t_co, 0.0)
        self._service_ewma_s = (
            svc if self._n_batches_drained == 1
            else 0.7 * self._service_ewma_s + 0.3 * svc)
        self._drain_hist.append((t_done, n_batch))
        if dl is None or self.config.overload_policy == "observe":
            return
        self._adapt_batch(svc, dl)
        if self.config.overload_policy == "degrade":
            self._ladder_evaluate(t_done)

    def _drain_rate(self) -> float:
        """Recent drain throughput (events/s) over the window of retired
        batches; 0.0 until two drains have landed."""
        h = self._drain_hist
        if len(h) < 2:
            return 0.0
        span = h[-1][0] - h[0][0]
        if span <= 0.0:
            return 0.0
        return (sum(n for _, n in h) - h[0][1]) / span

    def _adapt_batch(self, svc_s: float, dl: float) -> None:
        """Adaptive micro-batch sizing keyed on the service time (coalesce
        -> drained), the part of the latency the batch size controls:
        over half the budget halves the effective max_batch and
        max_latency_s (floors min_batch and deadline/8); under a quarter
        grows both back toward their ceilings."""
        if svc_s > dl / 2.0:
            nb = max(self._min_batch, self._eff_max_batch // 2)
            nl = max(dl / 8.0, self._eff_max_latency_s / 2.0)
            if nb < self._eff_max_batch or nl < self._eff_max_latency_s:
                self._batch_shrinks += 1
            self._eff_max_batch, self._eff_max_latency_s = nb, nl
        elif svc_s <= dl / 4.0:
            nb = min(self.config.max_batch, self._eff_max_batch * 2)
            nl = min(self._lat_cap_s, self._eff_max_latency_s * 2.0)
            if nb > self._eff_max_batch or nl > self._eff_max_latency_s:
                self._batch_grows += 1
            self._eff_max_batch, self._eff_max_latency_s = nb, nl

    def _rung_active(self, rung: str) -> bool:
        """Ladder level k activates the FIRST k configured rungs."""
        return rung in self.config.degrade_rungs[: self._rung_level]

    def _ladder_evaluate(self, now: float) -> None:
        """One hysteretic evaluation per degrade_window drained events: a
        miss fraction >= enter steps DOWN one rung, <= exit steps back UP,
        in between the ladder holds (at most one transition a window)."""
        if self._window_drained < self.config.degrade_window:
            return
        miss_frac = self._window_missed / self._window_drained
        self._window_missed = 0
        self._window_drained = 0
        level = self._rung_level
        if miss_frac >= self.config.degrade_enter_frac:
            new = min(level + 1, len(self.config.degrade_rungs))
        elif miss_frac <= self.config.degrade_exit_frac:
            new = max(level - 1, 0)
        else:
            new = level
        if new != level:
            self._set_rung_level(new, miss_frac, now)

    def _set_rung_level(self, new: int, miss_frac: float,
                        now: float) -> None:
        old = self._rung_level
        rungs = self.config.degrade_rungs
        crc_was_active = self._rung_active("scrub_crc_only")
        self._rung_level = new
        self._ladder_transitions.append({
            "t": now,
            "from_level": old,
            "to_level": new,
            "rung": rungs[new - 1] if new > old else rungs[old - 1],
            "direction": "down" if new > old else "up",
            "miss_frac": round(miss_frac, 4),
        })
        if crc_was_active and not self._rung_active("scrub_crc_only"):
            self._apply_deferred_heals()

    def _apply_deferred_heals(self) -> None:
        """Repair every frame whose heal scrub_crc_only deferred: a fresh
        synchronous readback, re-verified (a reconfigure may have healed
        it meanwhile), healed on mismatch; timed as ``scrub``."""
        pending, self._deferred_heals = self._deferred_heals, []
        if not pending:
            return
        with self._stages.time("scrub"):
            for slot, replica in pending:
                image = self.readback_frame(slot, replica)
                if not self._golden.verify(slot, replica, image):
                    self._scrub_healed_bits += self._heal_frame(
                        slot, replica, image)

    # ------------------------------------------------------- reconfigure
    def reconfigure(self, slot: int, new_chip: ReadoutChip) -> List[ScoredEvent]:
        """Hot-swap slot's bitstream: a row update of the stack and the
        encode plan, written in place (nothing is rebuilt or reallocated).
        Pending events are flushed first (they were submitted against the
        old configuration); returns their results. The new config must
        fit the server's fixed envelope."""
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
        before = build.miss_counts()
        R = self.n_replicas
        self._replica_configs[slot * R : (slot + 1) * R] = [
            replicate_config(cfg, r) for r in range(R)
        ]
        self.chips[slot] = new_chip
        self._path.swap_chip(slot, new_chip)
        if build.miss_counts() != before:
            self.shape_misses += 1
        # the slot's golden truth IS the new bitstream now; pending samples
        # of the old one are stale, and old disagreements must not steer
        self._register_golden(slot)
        for r in range(self.n_replicas):
            fi = self._frame_index(slot, r)
            self._frame_gen[fi] += 1
            self._scrub_last_dis[fi] = self._stats[slot].disagreements[r]
        return done

    def rebind_mesh(self, mesh) -> List[ScoredEvent]:
        """Bind the server to a device plan (launch.mesh.ReadoutMesh),
        the fleet's grow/shrink port. Pending work is flushed first and
        returned, as ``reconfigure`` does; then the stack and the fused
        pass take the plan's slabs (``train.elastic.reshard_replicated``):
        a plan equal to the current one copies nothing, and a move copies
        only the slabs whose chips or device changed. The first dispatch
        after a move launches at new slab shapes or on a new card, which
        counts once in ``shape_misses`` (the reference retraces once).
        ValueError, before anything is flushed, for a plan whose size
        does not divide the chips. A no-op on the host path (no plan)."""
        if self._path.mesh is None:
            return []
        mesh.slabs(self.n_chips)        # raises before the flush
        done = self.flush()
        self._path.rebind(mesh)
        return done

    # ----------------------------------------------------- fault injection
    def inject_seu(self, slot: int, replica: int, lut_index: int,
                   bit: int) -> None:
        """Flip one configuration bit of ONE served replica, addressed in
        that replica's own (placement-rotated) bitstream. Takes effect at
        the next dispatch; batches in flight keep the tables they were
        launched with. Both backends; replica 0 of a plain server is the
        unprotected case. Repeated calls accumulate flips."""
        i = self._frame_index(slot, replica)
        self._frame_gen[i] += 1     # invalidates pre-flip scrub samples
        self._replica_configs[i] = _inject_seu_config(
            self._replica_configs[i], lut_index, bit)
        self._path.swap_replica(slot, replica, self._replica_configs[i])

    # ----------------------------------------------------------- scrubbing
    def _register_golden(self, slot: int) -> None:
        """Snapshot slot's golden truth (bitstream + per-replica digests):
        at construction and on every reconfigure."""
        cfg = self.chips[slot].config
        self._golden.register(slot, cfg, self.replica_images(cfg))

    def replica_images(self, config) -> List[np.ndarray]:
        """Every replica's (n_levels, m_pad, 16) uint8 truth-table image of
        ``config`` in this server's scrub layout: what a readback of a
        healthy slot serving it returns, and what the golden store
        digests."""
        return replica_table_images(config, self._path.image_levels,
                                    self._path.image_m_pad, self.n_replicas)

    def slot_health(self, slot: int) -> Tuple[List[int], int]:
        """One slot's running health counters: the per-replica SEU
        disagreement counts, and the scrub samples of its replica
        frames."""
        R = self.n_replicas
        return (list(self._stats[slot].disagreements),
                int(sum(self._scrub_per_frame[slot * R : (slot + 1) * R])))

    def _frame_index(self, slot: int, replica: int) -> int:
        """The index of a (slot, replica) frame; ValueError off range."""
        self._check_chip(slot)
        R = self.n_replicas
        if not 0 <= replica < R:
            raise ValueError(f"replica must be in [0, {R}), got {replica!r}")
        return slot * R + replica

    def readback_frame(self, slot: int, replica: int = 0) -> np.ndarray:
        """Live (n_levels, m_pad, 16) uint8 truth-table image of one
        served replica, any upset included: the stack's tables on the
        kernel path (synchronous), the MultiFabricSim twin on the host
        path."""
        self._frame_index(slot, replica)
        return self._path.readback(slot, replica)

    def verify_frame(self, slot: int, replica: int = 0) -> bool:
        """CRC-check one replica's readback against its golden digest (no
        heal)."""
        return self._golden.verify(
            slot, replica, self.readback_frame(slot, replica))

    def scrub_step(self) -> List[Dict[str, int]]:
        """ONE background scrub step: verify the earlier readbacks whose
        copies have completed, then sample the next frames. In
        ``steered`` mode the frame whose disagreement counters climbed
        most since its last scrub is sampled first, without consuming the
        round-robin turn, so steering never starves a frame. Returns one
        record per healed (or, under scrub_crc_only, deferred) frame:
        {"slot", "replica", "healed_bits", "detection_latency_dispatches"}.
        """
        with self._stages.time("scrub"):
            healed: List[Dict[str, int]] = []
            # never wait here for a copy behind the batch just launched; a
            # sample still pending after one full frame cycle is forced
            n_frames = self.n_chips * self.n_replicas
            still_pending: Deque[_Readback] = collections.deque()
            while self._scrub_pending:
                entry = self._scrub_pending.popleft()
                ready = entry.ready is None or entry.ready.query()
                if ready or len(self._scrub_pending) >= n_frames:
                    rec = self._resolve_readback(entry)
                    if rec:
                        healed.append(rec)
                else:
                    still_pending.append(entry)
            self._scrub_pending = still_pending
            R = self.n_replicas
            if self.config.scrub_mode == "steered":
                healed.extend(self._scrub_steered_check())
            f = self._scrub_rr
            self._scrub_rr = (f + 1) % n_frames
            if self._scrub_rr == 0:
                self._scrub_cycles += 1
            rec = self._issue_scrub(f // R, f % R)
            if rec:
                healed.append(rec)
            self._scrub_steps += 1
        return healed

    def scrub_flush(self) -> List[Dict[str, int]]:
        """Resolve every readback still in flight (blocks on the copies)."""
        healed: List[Dict[str, int]] = []
        while self._scrub_pending:
            rec = self._resolve_readback(self._scrub_pending.popleft())
            if rec:
                healed.append(rec)
        return healed

    def scrub_cycle(self) -> List[Dict[str, int]]:
        """Force one full verified pass over every replica frame
        (n_chips x n_replicas scrub steps, then resolve the tail)."""
        out: List[Dict[str, int]] = []
        for _ in range(self.n_chips * self.n_replicas):
            out.extend(self.scrub_step())
        out.extend(self.scrub_flush())
        return out

    def _scrub_steered_check(self) -> List[Dict[str, int]]:
        """Sample the replica frame whose disagreement counters climbed
        most since its last scrub (no-op when none climbed)."""
        R = self.n_replicas
        deltas = [
            self._stats[f // R].disagreements[f % R]
            - self._scrub_last_dis[f]
            for f in range(self.n_chips * R)
        ]
        hot = int(np.argmax(deltas))
        if deltas[hot] <= 0:
            return []
        rec = self._issue_scrub(hot // R, hot % R)
        return [rec] if rec else []

    def _issue_scrub(self, slot: int,
                     replica: int) -> Optional[Dict[str, int]]:
        """Sample one frame's live truth tables. Host path: verify right
        here. Kernel path (``deferred_scrub``): queue the sample and
        verify it on a later step; on the card the row is copied to
        pinned memory asynchronously behind a CUDA event, so the scrub
        never waits for the dispatch it runs behind."""
        fi = self._frame_index(slot, replica)
        self._scrub_per_frame[fi] += 1
        # steering reacts to NEW disagreements only
        self._scrub_last_dis[fi] = self._stats[slot].disagreements[replica]
        prev_pass = self._scrub_last_pass[fi]
        self._scrub_last_pass[fi] = self._dispatch_idx
        if not self._path.deferred_scrub:
            return self._verify_heal(
                slot, replica, self._path.readback(slot, replica), prev_pass)
        image, ready, source = self._path.sample(slot, replica)
        self._scrub_pending.append(_Readback(
            fi, self._frame_gen[fi], image, ready, source, prev_pass,
            self._dispatch_idx))
        return None

    def _resolve_readback(self, entry: _Readback) -> Optional[Dict[str, int]]:
        fi = entry.fi
        if entry.gen != self._frame_gen[fi]:
            # re-encoded after the sample: drop it and roll back its
            # issue-time bookkeeping (the latency reference only if no
            # newer sample of the frame has advanced it)
            self._scrub_per_frame[fi] -= 1
            if self._scrub_last_pass[fi] == entry.issue_idx:
                self._scrub_last_pass[fi] = entry.prev_pass
            return None
        if entry.ready is not None and not entry.ready.query():
            entry.ready.synchronize()   # a forced or flushed sample
        R = self.n_replicas
        return self._verify_heal(
            fi // R, fi % R, entry.image.numpy().astype(np.uint8),
            entry.prev_pass)

    def _verify_heal(
        self, slot: int, replica: int, image: np.ndarray, prev_pass: int
    ) -> Optional[Dict[str, int]]:
        """CRC-verify one sampled image and heal on mismatch; the
        detection latency counts dispatches since ``prev_pass``, the
        frame's previous scrub."""
        if self._golden.verify(slot, replica, image):
            return None
        latency = self._dispatch_idx - prev_pass
        self._scrub_detections += 1
        self._scrub_latencies.append(latency)
        if self._rung_active("scrub_crc_only"):
            # detection stays live; the heal waits for the rung to exit
            # (TMR keeps masking meanwhile)
            key = (slot, replica)
            if key not in self._deferred_heals:
                self._deferred_heals.append(key)
            return {"slot": slot, "replica": replica,
                    "healed_bits": 0, "deferred": 1,
                    "detection_latency_dispatches": latency}
        healed_bits = self._heal_frame(slot, replica, image)
        self._scrub_healed_bits += healed_bits
        return {"slot": slot, "replica": replica,
                "healed_bits": healed_bits,
                "detection_latency_dispatches": latency}

    def _heal_frame(self, slot: int, replica: int, image: np.ndarray) -> int:
        """Re-encode ONE corrupted replica from the golden bitstream (the
        fault-injection swap pointed the other way); returns the number
        of healed configuration bits."""
        golden_cfg = self._golden.golden_config(slot)
        rep_cfg = replicate_config(golden_cfg, replica)
        golden_img = packed_table_image(
            rep_cfg, self._path.image_levels, self._path.image_m_pad)
        healed_bits = int(np.count_nonzero(image != golden_img))
        i = self._frame_index(slot, replica)
        self._frame_gen[i] += 1
        self._replica_configs[i] = rep_cfg
        self._path.swap_replica(slot, replica, rep_cfg)
        return healed_bits

    # ------------------------------------------------------------ report
    def report(self) -> Dict[str, object]:
        """Per-chip trigger/reduction accounting over the stream, the
        host-link bytes (on the wire, and what dense egress would have
        shipped), the per-replica SEU disagreement counters, the scrub
        accounting (steps, cycles, detections, healed bits, detection
        latency in dispatches), the latency histograms (p50/p99/p99.9, a
        CDF and the last drained batch's stage trace), the deadline
        ledger with the adaptive coalescer's knobs and the degrade
        ladder, the per-stage timing (``stages``, below), and the network
        front door's accounting (``net``: the attached door's
        ``stats()``, else ``{"attached": False}``). The same keys as the
        JAX package's report, and ``slabs``: each slab's device and chips
        [first, end) (kernel path; empty on the host path), and
        ``queue``: the runs and events that entered the queue (a run is
        the admitted events of one submit call, so events / runs is the
        events a queue entry carries).

        ``stages`` maps a key to its host seconds and calls (a key runs
        only where its path does; a dotted key is a child of the key
        before the dot, indentation is nesting)::

            submit              submit_frames / submit_batch, a call
            poll                the whole body of poll()
              coalesce          the queue take (whole runs, the last
                                cut where the batch ends) and kind
                                split; each pass's grouping into a batch
              stack_frames      frames: the fill of a staging-ring
                                slot with the real rows only, one copy a
                                run
                stack_frames.ring_wait  the host blocked on the slot's
                                earlier copies (only when one had not
                                landed)
              launch_fused      frames: the fused pass's launches, a
                                dispatch
                launch_fused.h2d  a slab: issuing its asynchronous copies
                                out of the slot, the pad zeroing and
                                the valid mask on the device
              encode_host       features: host quantize + bits
              launch_score      features: the scoring pass's launches
              staged_featurize, staged_encode, staged_score
                                frames on the host path: a chip each,
                                then the stacked bits scored
              sparse_pack       dense results packed for sparse egress
              enqueue_d2h       pinned buffers, async copies, CUDA events
              drain_wait        a batch drained: sync plus fold
                drain_wait.sync   the host blocked on the batch's events
                drain_wait.fold   kept prefixes, merge, ScoredEvents,
                                disagreements
              observe           the latency ledger, the result sort
              scrub             scrub steps (also in flush, and inside
                                observe when the ladder applies deferred
                                heals)
            dispatch_device     DEVICE seconds a slab's dispatch, from a
                                CUDA event pair (CUDA slabs only)

        ``flush`` runs the same stages outside ``poll``."""
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
                "latency_p99_us": self._hist_chip[i].percentile(99.0),
            })
        n_in = sum(s.n_in for s in self._stats)
        n_kept = sum(s.n_kept for s in self._stats)
        dt = (
            (self._t_last - self._t_start)
            if (self._t_start is not None and self._t_last is not None)
            else 0.0
        )
        t_base = self._last_batch_trace.get("t_enqueued")
        trace_us = {
            k: (v - t_base) * 1e6
            for k, v in self._last_batch_trace.items()
        } if t_base is not None else {}
        return {
            "backend": cfg.backend,
            "device": str(self.device),
            "slabs": self._path.slabs(),
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
            "queue": {"runs": self._runs_in, "events": self._events_in},
            "inflight_batches": len(self._inflight),
            "seu_disagreement_total": int(
                sum(sum(s.disagreements) for s in self._stats)),
            "scrub": {
                "enabled": cfg.scrub_interval is not None,
                "interval": cfg.scrub_interval,
                "mode": cfg.scrub_mode,
                "steps": self._scrub_steps,
                "cycles": self._scrub_cycles,
                "frames_scrubbed": int(sum(self._scrub_per_frame)),
                "detections": self._scrub_detections,
                "healed_bits": self._scrub_healed_bits,
                "detection_latency_dispatches": {
                    "mean": (float(np.mean(self._scrub_latencies))
                             if self._scrub_latencies else 0.0),
                    "max": int(max(self._scrub_latencies, default=0)),
                },
                "per_frame_scrubs": list(self._scrub_per_frame),
            },
            "link_bytes": {
                "on_wire": self._link_bytes_wire,
                "dense_equivalent": self._link_bytes_dense,
                "wire_reduction": (
                    self._link_bytes_dense / self._link_bytes_wire
                    if self._link_bytes_wire
                    and self._link_bytes_wire != self._link_bytes_dense
                    else 1.0),
            },
            "latency": {
                "total": self._hist_total.summary(),
                "queue_wait": self._hist_queue.summary(),
                "service": self._hist_service.summary(),
                "cdf_us": self._hist_total.cdf(),
                "last_batch_trace_us": trace_us,
            },
            "deadline": {
                "deadline_us": cfg.deadline_us,
                "policy": cfg.overload_policy,
                "met": self._deadline_met,
                "missed": self._deadline_missed,
                "shed": sum(s.n_shed for s in self._stats),
                "miss_fraction": (
                    self._deadline_missed
                    / max(self._deadline_met + self._deadline_missed, 1)),
                "service_ewma_us": self._service_ewma_s * 1e6,
                "drain_rate_ev_s": self._drain_rate(),
                "effective_max_batch": self._eff_max_batch,
                "effective_max_latency_s": self._eff_max_latency_s,
                "batch_shrinks": self._batch_shrinks,
                "batch_grows": self._batch_grows,
                "ladder": {
                    "level": self._rung_level,
                    "active_rungs": list(
                        cfg.degrade_rungs[: self._rung_level]),
                    "transitions": list(self._ladder_transitions),
                    "deferred_heals_pending": len(self._deferred_heals),
                },
            },
            "stages": self._stages.report(),
            "net": (self._net_stats_provider()
                    if self._net_stats_provider is not None
                    else {"attached": False}),
            "per_chip": per_chip,
        }
