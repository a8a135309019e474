"""Closed-loop replay load generator for the network front door (the
port's copy of the JAX package's net/replay.py).

Streams recorded smartpixel frames (``data/pipeline.FrameStream`` or any
``source(batch_index) -> (frames, y0)`` callable) against a live
front-door socket at a controlled rate — Poisson or square-wave arrivals,
the same traffic shapes as the open-loop deadline bench — and CLOSES the
loop: every returned TRIGGER_BATCH is checked bit-exact against a host
oracle (``host_oracle(chip)`` builds one from ``MultiFabricSim``), end-
to-end latency lands in the serving stack's own ``LatencyHistogram``,
and the final FLUSH_ACK's counters are cross-checked against what the
client actually sent.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.fabric import MultiFabricSim
from repro_torch.device import resolve_device
from repro_torch.kernels.yprofile import ops as yp_ops
from repro_torch.launch.readout_server import LatencyHistogram
from repro_torch.net import protocol as P

# (frames (n, T, Y, X) f32, y0 (n,) f32) per replayed batch index
Source = Callable[[int], Tuple[np.ndarray, np.ndarray]]
# (frames, y0) -> (scores (n,) int, keep (n,) bool)
Oracle = Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Replay traffic shape.

    rate_hz: target EVENT rate; 0 = unpaced (send as fast as the loop
        accepts — the loopback-throughput configuration).
    pattern: "poisson" (exponential inter-batch gaps) or "square"
        (rate toggles hi/lo every half period — bursty).
    n_batches / events_per_batch: total traffic volume.
    sensor: sensor id stamped on every batch (= server chip slot).
    transport: "tcp" or "udp". UDP batches must fit one datagram
        (events_per_batch <= protocol.UDP_MAX_EVENTS).
    pre_encode: frame every batch to wire bytes BEFORE the clock starts
        (a recorded stream can live on disk already wire-framed) — the
        harness then only moves bytes inside the measured window, so a
        throughput number isn't bottlenecked by the load generator's
        own encode cost.
    """

    rate_hz: float = 0.0
    pattern: str = "poisson"
    n_batches: int = 64
    events_per_batch: int = 8
    sensor: int = 0
    transport: str = "tcp"
    seed: int = 0
    square_period_s: float = 0.1
    burst_factor: float = 2.0
    timeout_s: float = 60.0
    pre_encode: bool = False

    def __post_init__(self):
        if self.pattern not in ("poisson", "square"):
            raise ValueError(f"unknown pattern {self.pattern!r}")
        if self.transport not in ("tcp", "udp"):
            raise ValueError(f"unknown transport {self.transport!r}")
        if self.transport == "udp" \
                and self.events_per_batch > P.UDP_MAX_EVENTS:
            raise ValueError(
                f"events_per_batch {self.events_per_batch} won't fit a "
                f"datagram (max {P.UDP_MAX_EVENTS})")
        if self.rate_hz < 0 or self.burst_factor < 1:
            raise ValueError("rate_hz >= 0 and burst_factor >= 1 required")


@dataclasses.dataclass
class ReplayReport:
    """What one replay run measured (and whether it verified)."""

    n_batches: int
    n_events: int
    target_ev_s: float
    achieved_ev_s: float
    latency: Dict[str, float]          # LatencyHistogram.summary()
    ack: Dict[str, int]                # final FLUSH_ACK counters
    verified: bool
    mismatches: List[str]
    n_triggers: int
    n_kept: int
    n_admitted: int
    unanswered: int                    # sent batches with no trigger back
    bytes_out: int
    bytes_in: int

    @property
    def wire_bytes_per_event(self) -> float:
        return self.bytes_out / max(self.n_events, 1)


def frame_stream_source(stream, sensor: int, events_per_batch: int
                        ) -> Source:
    """Adapt a ``FrameStream`` to the replay source contract: batch b is
    the first ``events_per_batch`` events of ``batch_at(b, sensor)`` —
    (seed, step, sensor)-pure, so the oracle side can regenerate it."""
    if events_per_batch > stream.cfg.batch:
        raise ValueError(
            f"events_per_batch {events_per_batch} > stream batch "
            f"{stream.cfg.batch}")

    def source(b: int) -> Tuple[np.ndarray, np.ndarray]:
        blk = stream.batch_at(b, sensor)
        return (blk["frames"][:events_per_batch],
                blk["y0"][:events_per_batch])

    return source


def array_source(frames: np.ndarray, y0: np.ndarray,
                 events_per_batch: int) -> Source:
    """Replay a preloaded (n, T, Y, X) array, wrapping around — the
    bench path (no per-batch generation cost in the measured rate)."""
    n = len(frames)

    def source(b: int) -> Tuple[np.ndarray, np.ndarray]:
        lo = (b * events_per_batch) % n
        idx = (lo + np.arange(events_per_batch)) % n
        return frames[idx], y0[idx]

    return source


def host_oracle(chip, threshold_electrons: float = 800.0, *,
                device=None) -> Oracle:
    """The bit-exact host decision path for one chip: frames -> yprofile
    features -> fabric input bits -> ``MultiFabricSim`` -> decoded raw
    score, keep = score <= the chip's trigger cut. This is the oracle
    the closed loop compares EVERY returned trigger against.

    The features come from the server's own featurizer on ``device``
    (default CUDA: kernel K1; ``"cpu"``: its plain twin), so a feature
    within summation-order rounding of an ap_fixed step quantizes as the
    server's does; everything after the features is numpy."""
    dev = resolve_device(device)
    sim = MultiFabricSim([chip.config])

    def oracle(frames: np.ndarray, y0: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        feats = yp_ops.yprofile(
            frames, y0, threshold_electrons=threshold_electrons,
            device=dev).cpu().numpy()
        bits = chip.encode_features(feats)
        outs = sim.run(bits[None])[0]
        score = np.asarray(chip.synth.decode_outputs(outs), np.int64)
        return score, score <= chip.score_threshold_raw

    return oracle


def batch_arrival_times(cfg: ReplayConfig) -> np.ndarray:
    """Seconds-from-start send time of each batch (all 0 when unpaced)."""
    n = cfg.n_batches
    if cfg.rate_hz <= 0:
        return np.zeros(n)
    rng = np.random.default_rng(cfg.seed)
    batch_rate = cfg.rate_hz / cfg.events_per_batch
    if cfg.pattern == "poisson":
        return np.cumsum(rng.exponential(1.0 / batch_rate, n))
    # square wave: rate toggles hi/lo every half period (mean = rate_hz)
    hi = batch_rate * cfg.burst_factor
    lo = batch_rate / cfg.burst_factor
    half = cfg.square_period_s / 2.0
    t, out = 0.0, []
    for _ in range(n):
        r = hi if int(t / half) % 2 == 0 else lo
        t += 1.0 / r
        out.append(t)
    return np.asarray(out)


class _TriggerCollector:
    """Client-side receive state: decoded triggers by orig_seq (with the
    receive timestamp — the e2e latency endpoint), the ack, byte count."""

    def __init__(self, clock):
        self._clock = clock
        self.decoder = P.StreamDecoder()
        self.triggers: Dict[int, Tuple[P.Message, float]] = {}
        self.ack: Optional[P.Message] = None
        self.bytes_in = 0
        self.event = asyncio.Event()

    def on_bytes(self, data: bytes) -> None:
        self.bytes_in += len(data)
        for msg in self.decoder.feed(data):
            self.on_message(msg)

    def on_message(self, msg: P.Message) -> None:
        if msg.msg_type == P.MSG_TRIGGER_BATCH:
            self.triggers[msg.orig_seq] = (msg, self._clock())
        elif msg.msg_type == P.MSG_FLUSH_ACK:
            self.ack = msg
        self.event.set()


class _UdpClient(asyncio.DatagramProtocol):
    def __init__(self, collector: _TriggerCollector):
        self._c = collector

    def datagram_received(self, data, addr):
        self._c.bytes_in += len(data)
        try:
            self._c.on_message(P.decode_datagram(data))
        except P.ProtocolError:
            pass


async def replay(host: str, port: int, source: Source, cfg: ReplayConfig,
                 oracle: Optional[Oracle] = None,
                 clock=None) -> ReplayReport:
    """Run one closed-loop replay against a live front door.

    Sends ``n_batches`` FRAME_BATCHes at the configured rate, then a
    FLUSH; awaits every TRIGGER_BATCH plus the FLUSH_ACK; verifies each
    trigger bit-exact against ``oracle`` (positions AND scores of kept
    events — an event the oracle keeps that the trigger missed is a
    mismatch, unless admission shed part of that batch, which the
    report counts as unanswered-verification instead)."""
    loop = asyncio.get_running_loop()
    clock = clock or loop.time
    coll = _TriggerCollector(clock)
    writer = None
    transport = None
    if cfg.transport == "tcp":
        reader, writer = await asyncio.open_connection(host, port)

        async def _read():
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    return
                coll.on_bytes(data)

        reader_task = asyncio.create_task(_read())

        async def send(wire: bytes):
            writer.write(wire)
            await writer.drain()
    else:
        transport, _ = await loop.create_datagram_endpoint(
            lambda: _UdpClient(coll), remote_addr=(host, port))
        reader_task = None

        async def send(wire: bytes):
            transport.sendto(wire)

    arrivals = batch_arrival_times(cfg)
    sent: Dict[int, Tuple[float, np.ndarray, np.ndarray]] = {}
    pre: Optional[List[Tuple[bytes, np.ndarray, np.ndarray]]] = None
    if cfg.pre_encode:
        pre = []
        for b in range(cfg.n_batches):
            frames, y0 = source(b)
            pre.append((P.encode_frame_batch(cfg.sensor, b, frames, y0),
                        frames, y0))
    bytes_out = 0
    t0 = clock()
    try:
        for b in range(cfg.n_batches):
            due = t0 + float(arrivals[b])
            delay = due - clock()
            if delay > 0:
                await asyncio.sleep(delay)
            if pre is not None:
                wire, frames, y0 = pre[b]
            else:
                frames, y0 = source(b)
                wire = P.encode_frame_batch(cfg.sensor, b, frames, y0)
            sent[b] = (clock(), frames, y0)
            bytes_out += len(wire)
            await send(wire)
        flush_wire = P.encode_flush(cfg.sensor, cfg.n_batches)
        bytes_out += len(flush_wire)
        await send(flush_wire)

        deadline = clock() + cfg.timeout_s
        while coll.ack is None or len(coll.triggers) < cfg.n_batches:
            remaining = deadline - clock()
            if remaining <= 0:
                break
            coll.event.clear()
            try:
                await asyncio.wait_for(coll.event.wait(), remaining)
            except asyncio.TimeoutError:
                break
        t_end = clock()
    finally:
        if writer is not None:
            writer.close()
        if reader_task is not None:
            reader_task.cancel()
        if transport is not None:
            transport.close()

    # ---- close the loop: verify + measure
    hist = LatencyHistogram()
    mismatches: List[str] = []
    n_kept = n_admitted = 0
    for bseq in sorted(coll.triggers):
        trig, t_recv = coll.triggers[bseq]
        t_send, frames, y0 = sent[bseq]
        # latency is per EVENT: every event in the batch got its
        # keep/drop decision when this trigger landed
        hist.add_many(
            np.full(trig.n_events, max(t_recv - t_send, 0.0) * 1e6))
        n_admitted += trig.n_admitted
        n_kept += len(trig.idx)
        if trig.n_events != len(frames):
            mismatches.append(
                f"batch {bseq}: trigger says {trig.n_events} events, "
                f"sent {len(frames)}")
            continue
        if oracle is None:
            continue
        if trig.n_admitted < trig.n_events:
            continue    # partially shed: positions unknowable, skip
        score, keep = oracle(frames, y0)
        want = {(int(p), int(score[p])) for p in np.nonzero(keep)[0]}
        got = {(int(p), int(s)) for p, s in zip(trig.idx, trig.scores)}
        if want != got:
            mismatches.append(
                f"batch {bseq}: kept (pos, score) set differs — "
                f"oracle-only {sorted(want - got)[:3]} "
                f"wire-only {sorted(got - want)[:3]}")

    n_events = cfg.n_batches * cfg.events_per_batch
    unanswered = cfg.n_batches - len(coll.triggers)
    span = max(t_end - t0, 1e-9)
    ack = dict(coll.ack.counters) if coll.ack is not None else {}
    verified = (oracle is not None and not mismatches and unanswered == 0
                and coll.ack is not None)
    return ReplayReport(
        n_batches=cfg.n_batches,
        n_events=n_events,
        target_ev_s=cfg.rate_hz,
        achieved_ev_s=n_events / span,
        latency=hist.summary(),
        ack=ack,
        verified=verified,
        mismatches=mismatches,
        n_triggers=len(coll.triggers),
        n_kept=n_kept,
        n_admitted=n_admitted,
        unanswered=unanswered,
        bytes_out=bytes_out,
        bytes_in=coll.bytes_in,
    )
