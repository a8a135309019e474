"""Elastic multi-tenant fabric fleet: bucketed geometry pools, tenant
routing, LRU eviction and golden-image re-admission (the port's copy of
the JAX package's launch/fleet.py).

The paper's proof of concept serves ONE classifier on one eFPGA; the
production question is thousands of distinct tenant configs. The fleet
answers it with three mechanisms layered on machinery that already
exists:

* **Bucketed geometry pools** (kernels.lut_eval.ops.bucket_envelope /
  pack_fabric_pool): every tenant config snaps to a coarse padded
  envelope (levels, level width, inputs, outputs, band — each rounded up
  to a grid point), and the fleet runs ONE ``ReadoutServer`` per
  envelope, pinned to it (``ReadoutServer(envelope=...)``). Every shape a
  bucket's kernels are launched with is a function of the envelope and
  the batch alone, so an arbitrary new tenant whose envelope matches a
  warm bucket admits through ``reconfigure`` -> ``swap_chip`` (rows
  written in place) with no nvcc build, no library load and no launch
  signature the bucket's kernels have not seen at that batch width
  (kernels/build.py ``miss_counts``; an admission after which one is
  added, up to the tenant's first result, counts in
  ``report()["admission_misses"]``), and with zero dropped frames for
  incumbents (pending work is flushed and delivered, never discarded).

* **LRU eviction + golden re-admission** (core.bitstream.
  GoldenImageStore): a bucket has a fixed number of chip slots; when
  every slot is seated the least-recently-used tenant is evicted. Its
  golden image (the CRC-framed bitstream snapshotted at admission, the
  same store the scrub loop heals from) stays in the fleet store, and
  the tenant transparently re-admits FROM that image on its next
  request — the seated config is decoded from golden bytes, not from
  whatever host object happens to be around, so an evicted tenant
  returns exactly as verified. ``retire`` discards the golden image;
  subsequent requests raise the named ``GoldenSlotError``.

* **Grow/shrink** (launch.mesh.make_fleet_meshes): buckets are created
  on demand (``admit`` / ``prewarm``) and retired when empty
  (``shrink``); after every resize the per-bucket device plans are
  re-made over the fleet's cards (disjoint slices where there are
  enough) and every bucket rebinds to its plan
  (``ReadoutServer.rebind_mesh``): a bucket whose plan did not change
  only flushes and copies nothing, one whose slab moved copies its
  stack and encode-plan rows to its new cards. Each bucket server keeps
  a copy stream on each of its cards.

Per-tenant accounting (``report()["tenants"]``) closes the identity::

    events_in == events_out + shed + quota_shed
               + evicted_while_queued + outstanding

where ``shed`` is the bucket server's two-predictor deadline admission,
``quota_shed`` is the per-tenant outstanding-events quota
(``ServerConfig.tenant_quota_queued``), ``evicted_while_queued`` counts
events cancelled by a non-draining eviction, and ``outstanding`` drains
to zero at ``flush``. SEU-disagreement and scrub counters are folded
from the tenant's slot (baselined at seat time, so slot reuse never
bleeds one tenant's counters into another's).

The network front door (net/ingress.py) targets a fleet exactly like a
single server, with ``FrontDoorConfig.sensor_tenants`` mapping wire
sensor ids onto tenant keys.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, Hashable, List, Optional

import numpy as np

from repro_torch.core.bitstream import GoldenImageStore, encode
from repro_torch.core.fabric import StackGeometry
from repro_torch.core.readout import ReadoutChip
from repro_torch.device import resolve_device
from repro_torch.kernels.lut_eval.ops import bucket_envelope
from repro_torch.launch.mesh import make_fleet_meshes
from repro_torch.launch.readout_server import (
    ReadoutServer, ScoredEvent, ServerConfig,
)


class UnknownTenantError(KeyError):
    """A fleet request named a tenant that was never admitted.

    Named (like ``GoldenSlotError`` and the wire ``ProtocolError``
    family) so routing layers can answer "no such tenant" instead of
    crashing on a raw KeyError.
    """

    def __init__(self, tenant):
        self.tenant = tenant
        super().__init__(f"unknown tenant {tenant!r} (admit() it first)")

    def __str__(self) -> str:
        return self.args[0]


@dataclasses.dataclass(frozen=True)
class TenantScoredEvent:
    """One scored event leaving the fleet: fleet-global seq (monotone,
    unique across every bucket — the front door routes by it), the
    owning tenant, and the same integer score / keep decision a
    single-server ``ScoredEvent`` carries."""

    seq: int
    tenant: Hashable
    score_raw: int
    keep: bool


@dataclasses.dataclass
class _TenantState:
    tenant: Hashable
    chip: ReadoutChip
    envelope: StackGeometry
    state: str = "resident"            # resident | evicted | retired
    bucket: Optional[int] = None
    slot: Optional[int] = None
    last_used: float = 0.0
    # fleet-owned cumulative counters (survive evict/re-admit cycles)
    events_in: int = 0
    events_out: int = 0
    n_kept: int = 0
    shed: int = 0
    quota_shed: int = 0
    evicted_while_queued: int = 0
    admissions: int = 0
    evictions: int = 0
    readmissions: int = 0
    # server seq -> fleet seq for every admitted-but-undrained event
    outstanding: Dict[int, int] = dataclasses.field(default_factory=dict)
    # accumulated slot-folded health counters + seat-time baselines
    seu_disagreements: List[int] = dataclasses.field(default_factory=list)
    scrub_frames: int = 0
    _base_dis: List[int] = dataclasses.field(default_factory=list)
    _base_scrub: int = 0


class _Bucket:
    """One geometry bucket: a pinned ReadoutServer plus slot ownership."""

    def __init__(self, envelope: StackGeometry, server: ReadoutServer):
        self.envelope = envelope
        self.server = server
        self.slots: List[Optional[Hashable]] = [None] * server.n_chips
        # server seq -> tenant, for routing drained results
        self.route: Dict[int, Hashable] = {}
        # slot -> the server's shape_misses at a warm admission into it,
        # settled at the admitted tenant's first result (or eviction)
        self.watch: Dict[int, int] = {}


class TenantFleet:
    """Serve MANY tenants' chips from a small set of bucketed servers.

    ``config`` is the per-bucket ``ServerConfig`` template (every bucket
    server shares it; ``tenant_quota_queued`` is read HERE, by the
    fleet). ``bucket_slots`` is the fixed chip-slot count of every
    bucket server — the residency capacity per envelope; vacant slots
    hold a clone of the bucket's founding chip and receive no traffic.
    ``clock`` is injectable for deterministic tests, exactly like
    ``ReadoutServer``. ``device`` names the devices the buckets are
    planned on (launch.mesh.make_fleet_meshes): None or "cuda" every
    card, "cuda:N" that card alone (every bucket on it), "cpu" the CPU;
    without a card only ``device="cpu"`` is accepted.

    Lifecycle: ``admit`` seats a tenant (creating its bucket cold if no
    warm one matches), ``submit``/``submit_batch``/``submit_frames``
    score events (transparently re-admitting an evicted tenant from its
    golden image), ``evict`` frees the slot, ``retire`` additionally
    discards the golden image, ``shrink`` retires empty buckets, and
    ``report()["tenants"]`` carries the per-tenant ledger.
    """

    def __init__(
        self,
        config: ServerConfig = ServerConfig(),
        clock=time.monotonic,
        bucket_slots: int = 4,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        if not (isinstance(bucket_slots, int) and bucket_slots >= 1):
            raise ValueError(
                f"bucket_slots must be an int >= 1, got {bucket_slots!r}")
        if config.sparse:
            raise ValueError(
                "the fleet needs its bucket servers dense (sparse=False): "
                "tenant routing is by per-event seq; sparse egress belongs "
                "at the wire (net/ingress.py)")
        self.config = config
        self._clock = clock
        self.bucket_slots = bucket_slots
        self._buckets: List[_Bucket] = []
        self._by_envelope: Dict[StackGeometry, int] = {}
        self._tenants: Dict[Hashable, _TenantState] = {}
        self._golden = GoldenImageStore()      # keyed by TENANT, not slot
        self._seq = 0
        self._ready: Deque[TenantScoredEvent] = collections.deque()
        self._net_stats_provider: Optional[Callable[[], Dict]] = None
        # warm admissions after which, up to the tenant's first result,
        # an nvcc build, a library load or a launch signature was added
        # at a batch width the bucket had served (_warm_swap): 0 expected
        self._admission_misses = 0

    # --------------------------------------------------------- inventory
    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    @property
    def n_tenants(self) -> int:
        return len(self._tenants)

    def has_tenant(self, tenant: Hashable) -> bool:
        """True while the tenant can serve traffic (resident OR evicted
        — an evicted tenant re-admits on its next request). False for
        never-admitted and retired tenants; the front door uses this to
        answer bad-sensor instead of submitting."""
        t = self._tenants.get(tenant)
        return t is not None and t.state != "retired"

    def tenant_state(self, tenant: Hashable) -> str:
        t = self._tenants.get(tenant)
        if t is None:
            raise UnknownTenantError(tenant)
        return t.state

    def attach_net_stats(self, provider: Callable[[], Dict]) -> None:
        """Same contract as ``ReadoutServer.attach_net_stats``: the
        front door's counters surface under ``report()["net"]``."""
        self._net_stats_provider = provider

    # --------------------------------------------------------- admission
    def admit(self, tenant: Hashable, chip: ReadoutChip) -> Dict[str, object]:
        """Seat a tenant's chip; returns admission info.

        The chip's ``bucket_envelope`` picks the bucket: a matching warm
        bucket admits through ``reconfigure`` (rows swapped in place, no
        new launch shape, incumbents' pending work flushed and DELIVERED
        — via the next ``poll``); no match grows the fleet by one cold
        bucket (a new server, whose kernels meet new shapes on its first
        dispatch). A full bucket first
        LRU-evicts its least-recently-used tenant. Admitting an already
        resident tenant re-seats its (possibly new) chip in place.

        The tenant's golden image (CRC-framed bitstream + per-replica
        digests at the bucket's image geometry) is (re)registered in
        the fleet store — the source of truth eviction returns to.

        Returned info: ``bucket`` (index), ``slot``, ``cold`` (True if
        the bucket was created by this admission), ``evicted`` (the
        tenant LRU-evicted to make room, or None).
        """
        t = self._tenants.get(tenant)
        if t is not None and t.state == "resident" and t.chip is not chip:
            # config push: re-seat in place (stays in the same bucket iff
            # the envelope matches; otherwise move buckets via evict)
            if bucket_envelope(chip.config, self.config.band) == t.envelope:
                b = self._buckets[t.bucket]
                self._warm_swap(b, t.slot, chip)
                t.chip = chip
                t.admissions += 1
                self._register_golden(t, b)
                return {"bucket": t.bucket, "slot": t.slot, "cold": False,
                        "evicted": None}
            self.evict(tenant)
            t = self._tenants[tenant]
        if t is None:
            t = _TenantState(
                tenant=tenant, chip=chip,
                envelope=bucket_envelope(chip.config, self.config.band),
                last_used=self._clock(),
            )
            self._tenants[tenant] = t
        else:
            t.chip = chip
            t.envelope = bucket_envelope(chip.config, self.config.band)
        return self._seat(t, chip)

    def prewarm(self, chip: ReadoutChip, warmup: bool = True) -> int:
        """Ensure the bucket for ``chip``'s envelope exists; returns its
        index. ``warmup=True`` additionally runs one throwaway dispatch
        through the founding clone, so the bucket's libraries are loaded
        and its kernels have met the one-event batch's launch shapes. The
        explicit GROW half of the fleet's elasticity."""
        env = bucket_envelope(chip.config, self.config.band)
        idx = self._by_envelope.get(env)
        if idx is None:
            idx = self._grow_bucket(env, chip)
        if warmup:
            srv = self._buckets[idx].server
            n_feat = srv.geometry.frontend.n_features
            srv.submit(0, np.zeros(n_feat))
            # throwaway: the founding clone is not a tenant, so the
            # result is unrouted and dropped by _deliver
            self._deliver(self._buckets[idx], srv.flush())
        return idx

    def _grow_bucket(self, env: StackGeometry, chip: ReadoutChip) -> int:
        # the new bucket starts on the plan the re-plan below gives it
        plan = (make_fleet_meshes(
            [b.server.n_chips for b in self._buckets] + [self.bucket_slots],
            device=self.device)[-1]
            if self.config.backend == "kernel" else None)
        srv = ReadoutServer(
            [chip] * self.bucket_slots, self.config, self._clock,
            envelope=env, device=self.device, mesh=plan)
        self._buckets.append(_Bucket(env, srv))
        idx = len(self._buckets) - 1
        self._by_envelope[env] = idx
        self._replan_meshes()
        return idx

    def _seat(self, t: _TenantState, chip: ReadoutChip) -> Dict[str, object]:
        env = t.envelope
        idx = self._by_envelope.get(env)
        cold = idx is None
        evicted = None
        if cold:
            idx = self._grow_bucket(env, chip)
            slot = 0
        else:
            b = self._buckets[idx]
            if None not in b.slots:
                evicted = self._lru_victim(b)
                self.evict(evicted)
            slot = b.slots.index(None)
        b = self._buckets[idx]
        if not (cold and slot == 0):
            # warm admission: the in-place hot swap (flushed incumbents'
            # results are delivered on the next poll)
            self._warm_swap(b, slot, chip)
        b.slots[slot] = t.tenant
        was_evicted = t.state == "evicted"
        t.state, t.bucket, t.slot = "resident", idx, slot
        t.last_used = self._clock()
        t.admissions += 1
        if was_evicted:
            t.readmissions += 1
        self._baseline_slot(t, b)
        self._register_golden(t, b)
        return {"bucket": idx, "slot": slot, "cold": cold,
                "evicted": evicted}

    def _warm_swap(self, b: _Bucket, slot: int, chip: ReadoutChip) -> None:
        """Seat ``chip`` in a warm bucket's slot through ``reconfigure``
        (the incumbents' pending work is flushed and delivered first). The
        admission is a miss if the bucket server's shape misses
        (``ReadoutServer.shape_misses``: the swap, or a launch at a batch
        width the server had launched before, adding an nvcc build, a
        library load or a launch signature) grow between the swap and the
        admitted tenant's first result (``_settle``)."""
        self._settle(b, slot)
        mark = b.server.shape_misses
        self._deliver(b, b.server.reconfigure(slot, chip))
        b.watch[slot] = mark
        self._settle(b, slot, final=False)

    def _settle(self, b: _Bucket, slot: int, final: bool = True) -> None:
        """Count a miss for the warm admission watched in ``slot`` if the
        bucket's shape misses grew since its swap; ``final`` closes the
        watch (the tenant's first result, or its eviction)."""
        if slot not in b.watch:
            return
        if b.server.shape_misses > b.watch[slot]:
            self._admission_misses += 1
            del b.watch[slot]
        elif final:
            del b.watch[slot]

    def _lru_victim(self, b: _Bucket) -> Hashable:
        seated = [self._tenants[x] for x in b.slots if x is not None]
        return min(seated, key=lambda t: t.last_used).tenant

    def _register_golden(self, t: _TenantState, b: _Bucket) -> None:
        self._golden.register(t.tenant, t.chip.config,
                              b.server.replica_images(t.chip.config))

    def _baseline_slot(self, t: _TenantState, b: _Bucket) -> None:
        t._base_dis, t._base_scrub = b.server.slot_health(t.slot)
        if not t.seu_disagreements:
            t.seu_disagreements = [0] * b.server.n_replicas

    def _fold_slot(self, t: _TenantState, b: _Bucket) -> None:
        """Fold the slot's cumulative health counters into the tenant's
        ledger as deltas since seat time."""
        dis, scrubs = b.server.slot_health(t.slot)
        for r, d in enumerate(dis):
            t.seu_disagreements[r] += d - t._base_dis[r]
        t.scrub_frames += scrubs - t._base_scrub
        t._base_dis, t._base_scrub = dis, scrubs

    # ---------------------------------------------------------- eviction
    def evict(self, tenant: Hashable, drain: bool = True) -> None:
        """Free the tenant's slot (LRU calls this; operators may too).

        ``drain=True`` (default) flushes the bucket first, so every one
        of the tenant's admitted events is scored and delivered — the
        zero-loss eviction. ``drain=False`` cancels the tenant's QUEUED
        events (counted as ``evicted_while_queued``) and only waits for
        batches already on the device. Either way the golden image
        STAYS registered: the next request re-admits from it.
        """
        t = self._tenants.get(tenant)
        if t is None:
            raise UnknownTenantError(tenant)
        if t.state != "resident":
            return
        b = self._buckets[t.bucket]
        if not drain:
            n = b.server.cancel_queued(t.slot)
            t.evicted_while_queued += n
        self._deliver(b, b.server.flush())
        # anything still outstanding was cancelled above — unroute it
        for srv_seq in t.outstanding:
            b.route.pop(srv_seq, None)
        t.outstanding.clear()
        self._settle(b, t.slot)
        self._fold_slot(t, b)
        b.slots[t.slot] = None
        t.state, t.bucket, t.slot = "evicted", None, None
        t.evictions += 1

    def retire(self, tenant: Hashable) -> None:
        """Evict (draining) AND discard the golden image — the terminal
        state. Further requests for this tenant raise ``GoldenSlotError``
        (no golden image to re-admit from)."""
        t = self._tenants.get(tenant)
        if t is None:
            raise UnknownTenantError(tenant)
        if t.state == "resident":
            self.evict(tenant, drain=True)
        self._golden.discard(tenant)
        self._tenants[tenant].state = "retired"

    def shrink(self) -> int:
        """Retire every bucket with no resident tenants; returns how
        many were dropped. The SHRINK half of the fleet's elasticity:
        surviving buckets' device plans are re-made
        (make_fleet_meshes) and each rebinds to its plan
        (``rebind_mesh``: a flush, then a move of the buckets whose slab
        moved)."""
        keep = [b for b in self._buckets
                if any(s is not None for s in b.slots)]
        dropped = len(self._buckets) - len(keep)
        if not dropped:
            return 0
        for b in self._buckets:
            if b not in keep:
                self._deliver(b, b.server.flush())
        self._buckets = keep
        self._by_envelope = {b.envelope: i for i, b in enumerate(keep)}
        # re-index resident tenants' bucket pointers
        for i, b in enumerate(self._buckets):
            for slot, tenant in enumerate(b.slots):
                if tenant is not None:
                    self._tenants[tenant].bucket = i
        self._replan_meshes()
        return dropped

    def _replan_meshes(self) -> None:
        if self.config.backend != "kernel" or not self._buckets:
            return
        meshes = make_fleet_meshes(
            [b.server.n_chips for b in self._buckets], device=self.device)
        for b, m in zip(self._buckets, meshes):
            self._deliver(b, b.server.rebind_mesh(m))

    # --------------------------------------------------------- scoring
    def _resident(self, tenant: Hashable) -> _TenantState:
        t = self._tenants.get(tenant)
        if t is None:
            raise UnknownTenantError(tenant)
        if t.state != "resident":
            # re-admit from the golden image (GoldenSlotError if retired)
            golden_cfg = self._golden.golden_config(tenant)
            assert encode(golden_cfg) == encode(t.chip.config), \
                "golden image diverged from tenant chip"
            chip = dataclasses.replace(t.chip, config=golden_cfg)
            t.chip = chip
            self._seat(t, chip)
        return t

    def _quota_room(self, t: _TenantState, want: int) -> int:
        q = self.config.tenant_quota_queued
        if q is None:
            return want
        return max(0, min(want, q - len(t.outstanding)))

    def _issue(self, t: _TenantState, srv_seq: Optional[int],
               b: _Bucket) -> Optional[int]:
        if srv_seq is None:
            t.shed += 1
            return None
        fseq = self._seq
        self._seq += 1
        t.outstanding[srv_seq] = fseq
        b.route[srv_seq] = t.tenant
        return fseq

    def submit(self, tenant: Hashable,
               features: np.ndarray) -> Optional[int]:
        """Score one pre-featurized event for a tenant; returns the
        fleet-global seq, or None when shed (deadline admission or the
        per-tenant quota — both counted in the tenant's ledger). An
        evicted tenant is transparently re-admitted first."""
        t = self._resident(tenant)
        b = self._buckets[t.bucket]
        t.events_in += 1
        t.last_used = self._clock()
        if self._quota_room(t, 1) < 1:
            t.quota_shed += 1
            return None
        return self._issue(t, b.server.submit(t.slot, features), b)

    def submit_batch(self, tenant: Hashable,
                     X: np.ndarray) -> List[Optional[int]]:
        return [self.submit(tenant, row) for row in np.asarray(X)]

    def submit_frames(self, tenant: Hashable, frames: np.ndarray,
                      y0: np.ndarray) -> List[Optional[int]]:
        """Raw-frames ingestion for one tenant (the front door's path);
        shed/quota-shed rows yield None, exactly like the server."""
        t = self._resident(tenant)
        b = self._buckets[t.bucket]
        frames = np.asarray(frames, np.float32)
        n = len(frames)
        t.events_in += n
        t.last_used = self._clock()
        room = self._quota_room(t, n)
        t.quota_shed += n - room
        seqs: List[Optional[int]] = []
        if room:
            for s in b.server.submit_frames(
                    t.slot, frames[:room], np.asarray(y0)[:room]):
                seqs.append(self._issue(t, s, b))
        seqs.extend([None] * (n - room))
        return seqs

    # ---------------------------------------------------------- results
    def _deliver(self, b: _Bucket, results: List[ScoredEvent]) -> None:
        """Route a bucket's drained results into the ready queue (events
        of vacant clones / warmups are unrouted and dropped)."""
        for r in results:
            tenant = b.route.pop(r.seq, None)
            if tenant is None:
                continue
            t = self._tenants[tenant]
            self._settle(b, t.slot)
            fseq = t.outstanding.pop(r.seq)
            t.events_out += 1
            t.n_kept += bool(r.keep)
            self._ready.append(TenantScoredEvent(
                seq=fseq, tenant=tenant,
                score_raw=int(r.score_raw), keep=bool(r.keep)))

    def _take_ready(self) -> List[TenantScoredEvent]:
        out = list(self._ready)
        self._ready.clear()
        return out

    def poll(self) -> List[TenantScoredEvent]:
        """One non-blocking turn over every bucket server, plus any
        results drained internally by admissions/evictions."""
        for b in self._buckets:
            self._deliver(b, b.server.poll())
        return self._take_ready()

    def flush(self) -> List[TenantScoredEvent]:
        """Force everything out of every bucket (blocking)."""
        for b in self._buckets:
            self._deliver(b, b.server.flush())
        return self._take_ready()

    # ----------------------------------------------------------- report
    def report(self) -> Dict[str, object]:
        """Fleet-level accounting. ``"tenants"`` maps every tenant (also
        evicted/retired ones — history is part of the ledger) to its
        per-tenant trigger / SEU-disagreement / scrub / shed section;
        ``"buckets"`` carries each bucket's envelope, seating, devices
        (one a slab; empty on the host backend) and full per-server
        report. Top-level counters aggregate over tenants and
        close the same accounting identity the per-tenant ledgers do;
        ``admission_misses`` counts the warm admissions after which, up to
        the admitted tenant's first result, the bucket's swap or a launch
        at a batch width it had launched before added an nvcc build, a
        library load or a launch signature."""
        tenants: Dict = {}
        for key, t in self._tenants.items():
            if t.state == "resident":
                self._fold_slot(t, self._buckets[t.bucket])
            tenants[key] = {
                "state": t.state,
                "bucket": t.bucket,
                "slot": t.slot,
                "events_in": t.events_in,
                "events_out": t.events_out,
                "n_kept": t.n_kept,
                "fraction_kept": (
                    t.n_kept / t.events_out if t.events_out else 1.0),
                "shed": t.shed,
                "quota_shed": t.quota_shed,
                "evicted_while_queued": t.evicted_while_queued,
                "outstanding": len(t.outstanding),
                "admissions": t.admissions,
                "evictions": t.evictions,
                "readmissions": t.readmissions,
                "seu_disagreements": list(t.seu_disagreements),
                "scrub_frames": t.scrub_frames,
            }
        buckets = []
        for b in self._buckets:
            env = b.envelope
            srv_rep = b.server.report()
            buckets.append({
                "envelope": {
                    "n_levels": env.n_levels,
                    "max_level_size": env.max_level_size,
                    "n_inputs": env.n_inputs,
                    "n_outputs": env.n_outputs,
                    "fanin_reach": env.fanin_reach,
                },
                "slots": list(b.slots),
                "n_resident": sum(s is not None for s in b.slots),
                "devices": [sl["device"] for sl in srv_rep["slabs"]],
                "server": srv_rep,
            })
        ts = self._tenants.values()
        return {
            "backend": self.config.backend,
            "device": str(self.device),
            "layout": self.config.effective_layout,
            "bucket_slots": self.bucket_slots,
            "n_buckets": self.n_buckets,
            "n_tenants": self.n_tenants,
            "n_resident": sum(t.state == "resident" for t in ts),
            "n_evicted": sum(t.state == "evicted" for t in ts),
            "events_in": sum(t.events_in for t in ts),
            "events_out": sum(t.events_out for t in ts),
            "shed": sum(t.shed for t in ts),
            "quota_shed": sum(t.quota_shed for t in ts),
            "evicted_while_queued": sum(
                t.evicted_while_queued for t in ts),
            "admission_misses": self._admission_misses,
            "tenants": tenants,
            "buckets": buckets,
            "net": (self._net_stats_provider()
                    if self._net_stats_provider is not None
                    else {"attached": False}),
        }
