"""Asyncio multi-producer network front door for the readout server
(the port's copy of the JAX package's net/ingress.py).

Many sensor clients — TCP streams and UDP datagrams — feed ONE
``ReadoutServer`` through a bounded ingest queue. The data path is a
synchronous core (``feed`` / ``feed_datagram`` / ``pump``) that the thin
asyncio shell (``start`` / ``stop``) drives, so every queue/accounting
behavior is unit-testable without sockets and the event loop never does
more than move bytes.

Design points (mirroring the serving loop's own rules):

* **Bounded queue, drop-and-count.** The ingest queue is bounded in
  EVENTS (``FrontDoorConfig.queue_events``). A batch arriving at
  capacity is dropped whole and counted per client
  (``events_queue_dropped``) — ``feed`` never blocks the transport and
  the queue never grows unboundedly. Backpressure is loss + accounting,
  exactly like the server's own admission control one layer down.
* **Per-client sequence accounting.** Every client message carries a
  seq; the front door tracks gaps (presumed-lost), reorders (a gap
  later filled by a late arrival — the gap count is repaid), and
  duplicates (dropped). FLUSH participates in the same sequence, so a
  tail drop is visible as a gap when the flush arrives.
* **Dense server, sparse wire.** The front door drives the server with
  ``sparse=False`` — it needs every admitted event's (score, keep) back
  to know when a client batch is complete — and performs the sparse
  (indices, scores) reduction AT THE WIRE via
  ``protocol.encode_trigger_batch`` (byte-compatible with
  ``parallel/compression.py``'s pack). Dropped events still never cross
  the socket; the in-process hop is host RAM, not the scarce link.
* **Accounting surfaces in ``report()["net"]``** via
  ``ReadoutServer.attach_net_stats``.
* **One thread touches the server.** ``submit_frames``, ``poll`` and
  ``flush`` (every torch and CUDA call) run in ``pump`` on the event
  loop's thread; the ``offload_decode`` worker only checks CRCs and
  copies payload bytes into numpy arrays.

The accounting identity the tests pin down (per client, once drained)::

    events_in == events_admitted + events_shed
               + events_queue_dropped + events_bad_sensor
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import queue
import socket
import threading
from typing import Callable, Deque, Dict, Hashable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.net import protocol as P

# a client that falls further than this many messages behind its own
# max-seen seq stops being tracked hole-by-hole (the hole set is
# bounded; older holes become permanent seq_gaps)
_MAX_TRACKED_HOLES = 4096
# the UDP endpoint's receive buffer: a datagram that arrives at a full
# one is lost, and the usual 212,992-byte default holds three of the
# 61 KB datagrams a 7-event frames batch takes (the kernel caps the ask
# at net.core.rmem_max)
UDP_RCVBUF_BYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Knobs of the front door, validated on construction.

    queue_events: ingest queue capacity in EVENTS (not batches) — at
        capacity a whole arriving batch is dropped and counted.
    idle_sleep_s: asyncio pump's sleep when a turn moved nothing.
    offload_decode: run CRC verification + payload decode on a worker
        thread instead of the event loop (asyncio shell only; the
        synchronous ``feed``/``feed_datagram`` API is never offloaded).
        zlib and the numpy payload copy release the GIL, so the wire
        checksum work overlaps the serving loop on another core —
        decoded messages are handed back to the loop thread, so ALL
        accounting still happens single-threaded and stays exact.
    sensor_tenants: wire sensor_id -> serving-target key. ``None``
        (default) keeps the single-server identity routing: sensor_id
        IS the chip slot, bounds-checked against ``server.n_chips``.
        Set it to front a multi-tenant fleet (launch/fleet.py): each
        sensor maps onto a fleet tenant key, unmapped sensors (and
        sensors whose tenant is retired — ``has_tenant`` is consulted
        when the target offers it) count as ``events_bad_sensor``
        instead of crashing the pump.
    """

    queue_events: int = 8192
    idle_sleep_s: float = 500e-6
    offload_decode: bool = True
    sensor_tenants: Optional[Mapping[int, Hashable]] = None

    def __post_init__(self):
        if not (isinstance(self.queue_events, int)
                and self.queue_events > 0):
            raise ValueError(f"queue_events must be a positive int, got "
                             f"{self.queue_events!r}")
        if self.idle_sleep_s <= 0:
            raise ValueError(f"idle_sleep_s must be > 0, got "
                             f"{self.idle_sleep_s!r}")
        if self.sensor_tenants is not None and not isinstance(
                self.sensor_tenants, Mapping):
            raise ValueError(
                f"sensor_tenants must be a mapping (sensor_id -> tenant) "
                f"or None, got {self.sensor_tenants!r}")


class _Client:
    """Per-connection state: decoder, seq window, counters, pending
    (submitted but not yet fully scored) batches."""

    __slots__ = (
        "key", "send", "decoder", "max_seq", "holes", "pending",
        "flush_waiting", "tx_seq", "counters", "udp_errors",
        "bytes_in", "bytes_out", "triggers_out", "events_kept",
        "connected",
    )

    def __init__(self, key: str, send: Callable[[bytes], None],
                 stream: bool):
        self.key = key
        self.send = send
        self.decoder = P.StreamDecoder() if stream else None
        self.max_seq = -1            # highest seq seen from this client
        self.holes: set = set()      # seqs < max_seq never seen (gaps)
        self.pending: Dict[int, "_PendingBatch"] = {}
        self.flush_waiting: List[int] = []
        self.tx_seq = 0
        self.udp_errors = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.triggers_out = 0
        self.events_kept = 0
        self.connected = True
        self.counters = {
            "batches_in": 0, "events_in": 0, "events_admitted": 0,
            "events_shed": 0, "events_queue_dropped": 0,
            "events_bad_sensor": 0, "seq_gaps": 0, "reorders": 0,
            "duplicates": 0,
        }

    def track_seq(self, seq: int) -> bool:
        """Slide the per-client sequence window. Returns False for a
        duplicate (caller drops the message). A hole opened by a skip
        counts as a gap immediately; a late arrival that fills a hole
        repays the gap and counts as a reorder."""
        c = self.counters
        if seq > self.max_seq:
            skipped = seq - self.max_seq - 1
            if skipped:
                c["seq_gaps"] += skipped
                self.holes.update(range(self.max_seq + 1, seq))
                while len(self.holes) > _MAX_TRACKED_HOLES:
                    self.holes.remove(min(self.holes))  # permanent loss
            self.max_seq = seq
            return True
        if seq in self.holes:
            self.holes.remove(seq)
            c["seq_gaps"] -= 1      # not lost after all, just late
            c["reorders"] += 1
            return True
        c["duplicates"] += 1
        return False

    def ack_counters(self) -> Dict[str, int]:
        derr = (self.decoder.errors_total if self.decoder else 0) \
            + self.udp_errors
        rs = self.decoder.resyncs if self.decoder else 0
        out = dict(self.counters)
        out.pop("events_bad_sensor")
        out["decode_errors"] = derr
        out["resyncs"] = rs
        return out


class _PendingBatch:
    """One submitted FRAME_BATCH awaiting its scored events."""

    __slots__ = ("sensor_id", "n_events", "n_admitted", "got")

    def __init__(self, sensor_id: int, n_events: int):
        self.sensor_id = sensor_id
        self.n_events = n_events
        self.n_admitted = 0
        self.got: List[Tuple[int, int, bool]] = []   # (pos, score, keep)


class ReadoutFrontDoor:
    """The multi-producer ingest adapter in front of one ReadoutServer.

    Synchronous core API (unit tests, and what the asyncio shell calls):

    * ``client_connect(key, send)`` / ``client_disconnect(key)``
    * ``feed(key, data)`` — TCP byte stream (any chunking)
    * ``feed_datagram(key, data)`` — one UDP datagram
    * ``pump()`` — one non-blocking turn: submit queued batches, poll
      the server, route finished scores back out as TRIGGER_BATCHes
    * ``drain()`` — force everything through (blocking; end of stream)
    * ``stats()`` — the ``report()["net"]`` payload
    """

    def __init__(self, server, config: FrontDoorConfig = FrontDoorConfig()):
        if server.config.sparse:
            raise ValueError(
                "the front door needs the server dense (sparse=False): "
                "it must see every admitted event's score to complete a "
                "client batch, and performs the sparse reduction at the "
                "wire itself (protocol.encode_trigger_batch)")
        self.server = server
        self.config = config
        self._clients: Dict[str, _Client] = {}
        # (client key, decoded FRAME_BATCH) | (client key, flush seq)
        self._ingest: Deque[Tuple[str, object]] = collections.deque()
        self._ingest_events = 0
        # server seq -> (client key, client batch seq, position in batch)
        self._routes: Dict[int, Tuple[str, int, int]] = {}
        self._tcp_server = None
        self._udp_transport = None
        self._pump_task = None
        self._decode_q: Optional[queue.Queue] = None
        self._decode_thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        attach = getattr(server, "attach_net_stats", None)
        if attach is not None:
            attach(self.stats)

    # ------------------------------------------------- synchronous core
    def client_connect(self, key: str, send: Callable[[bytes], None],
                       stream: bool = True) -> None:
        if key in self._clients:
            self._clients[key].connected = True
            self._clients[key].send = send
            return
        self._clients[key] = _Client(key, send, stream)

    def client_disconnect(self, key: str) -> None:
        st = self._clients.get(key)
        if st is not None:
            st.connected = False

    def feed(self, key: str, data: bytes) -> None:
        """TCP path: decode whatever the chunk completes; malformed
        frames are counted + resynced inside the decoder, never raised —
        the transport callback cannot crash and never blocks."""
        st = self._clients[key]
        st.bytes_in += len(data)
        for msg in st.decoder.feed(data):
            self._on_message(st, msg)

    def feed_datagram(self, key: str, data: bytes) -> None:
        """UDP path: one frame per datagram; garbage counts, never raises."""
        st = self._clients.get(key)
        if st is None:
            raise KeyError(f"unknown client {key!r} (connect first)")
        st.bytes_in += len(data)
        try:
            msg = P.decode_datagram(data)
        except P.ProtocolError:
            st.udp_errors += 1
            return
        self._on_message(st, msg)

    def _on_message(self, st: _Client, msg: P.Message) -> None:
        if msg.msg_type == P.MSG_FRAME_BATCH:
            if not st.track_seq(msg.seq):
                return                            # duplicate: dropped
            st.counters["batches_in"] += 1
            st.counters["events_in"] += msg.n_events
            if self._ingest_events + msg.n_events > self.config.queue_events:
                st.counters["events_queue_dropped"] += msg.n_events
                return                            # bounded queue: drop
            self._ingest.append((st.key, msg))
            self._ingest_events += msg.n_events
        elif msg.msg_type == P.MSG_FLUSH:
            if not st.track_seq(msg.seq):
                return
            # ordered with the data: the marker rides the same queue, so
            # every batch this client sent before the flush is submitted
            # before the ack fires (markers cost no event capacity)
            self._ingest.append((st.key, int(msg.seq)))
        else:
            # a client sending server-role messages is malformed traffic
            st.udp_errors += 1

    def _submit_key(self, sensor_id: int) -> Optional[Hashable]:
        """Resolve a wire sensor_id to the serving target's submit key:
        identity (bounds-checked chip slot) against a single server, or
        the configured tenant key against a fleet. None = bad sensor."""
        m = self.config.sensor_tenants
        if m is None:
            return sensor_id if sensor_id < self.server.n_chips else None
        tenant = m.get(sensor_id)
        if tenant is None:
            return None
        has = getattr(self.server, "has_tenant", None)
        if has is not None and not has(tenant):
            return None
        return tenant

    def _submit(self, st: _Client, msg: P.Message) -> None:
        key = self._submit_key(msg.sensor_id)
        if key is None:
            st.counters["events_bad_sensor"] += msg.n_events
            return
        pb = _PendingBatch(msg.sensor_id, msg.n_events)
        seqs = self.server.submit_frames(key, msg.frames, msg.y0)
        for pos, s in enumerate(seqs):
            if s is None:
                st.counters["events_shed"] += 1
            else:
                pb.n_admitted += 1
                self._routes[s] = (st.key, msg.seq, pos)
        st.counters["events_admitted"] += pb.n_admitted
        if pb.n_admitted == 0:
            self._emit_trigger(st, msg.seq, pb)   # all shed: answer now
        else:
            st.pending[msg.seq] = pb

    def pump(self) -> int:
        """One non-blocking turn. Returns the number of ingest items +
        scored events moved (0 = idle, the asyncio loop sleeps)."""
        moved = 0
        flush_due = False
        while self._ingest:
            key, item = self._ingest.popleft()
            st = self._clients[key]
            moved += 1
            if isinstance(item, int):
                st.flush_waiting.append(item)
                flush_due = True
                continue
            self._ingest_events -= item.n_events
            self._submit(st, item)
        results = self.server.poll()
        if flush_due or any(
                c.flush_waiting for c in self._clients.values()):
            # a flush marker crossed the queue: force the server to
            # retire everything (blocking — end-of-stream semantics)
            results.extend(self.server.flush())
        moved += self._route(results)
        self._emit_acks()
        return moved

    def drain(self) -> None:
        """Force every queued batch through and answer it (blocking)."""
        while self._ingest:
            self.pump()
        self._route(self.server.flush())
        self._emit_acks()

    def _route(self, results) -> int:
        done: List[Tuple[_Client, int, _PendingBatch]] = []
        for r in results:
            route = self._routes.pop(r.seq, None)
            if route is None:
                continue        # not network traffic (in-process submit)
            key, bseq, pos = route
            st = self._clients[key]
            pb = st.pending[bseq]
            pb.got.append((pos, int(r.score_raw), bool(r.keep)))
            if len(pb.got) == pb.n_admitted:
                done.append((st, bseq, st.pending.pop(bseq)))
        for st, bseq, pb in done:
            self._emit_trigger(st, bseq, pb)
        return len(results)

    def _emit_trigger(self, st: _Client, bseq: int,
                      pb: _PendingBatch) -> None:
        kept = sorted((pos, score) for pos, score, keep in pb.got if keep)
        idx = np.fromiter((p for p, _ in kept), np.int32, len(kept))
        scores = np.fromiter((s for _, s in kept), np.int32, len(kept))
        st.events_kept += len(kept)
        wire = P.encode_trigger_batch(
            pb.sensor_id, st.tx_seq, orig_seq=bseq,
            n_events=pb.n_events, n_admitted=pb.n_admitted,
            idx=idx, scores=scores)
        st.tx_seq += 1
        self._send(st, wire)
        st.triggers_out += 1

    def _emit_acks(self) -> None:
        for st in self._clients.values():
            if not st.flush_waiting or st.pending:
                continue
            for _ in st.flush_waiting:
                wire = P.encode_flush_ack(0, st.tx_seq, st.ack_counters())
                st.tx_seq += 1
                self._send(st, wire)
            st.flush_waiting.clear()

    def _send(self, st: _Client, wire: bytes) -> None:
        st.bytes_out += len(wire)
        if st.connected:
            st.send(wire)

    # -------------------------------------------------------- accounting
    def stats(self) -> Dict[str, object]:
        per_client = {}
        tot = collections.Counter()
        for key, st in sorted(self._clients.items()):
            c = st.ack_counters()
            c["events_bad_sensor"] = st.counters["events_bad_sensor"]
            c.update(bytes_in=st.bytes_in, bytes_out=st.bytes_out,
                     triggers_out=st.triggers_out,
                     events_kept=st.events_kept,
                     pending_batches=len(st.pending),
                     connected=st.connected)
            per_client[key] = c
            for k in ("batches_in", "events_in", "events_admitted",
                      "events_shed", "events_queue_dropped",
                      "events_bad_sensor", "seq_gaps", "reorders",
                      "duplicates", "decode_errors", "resyncs",
                      "bytes_in", "bytes_out", "events_kept"):
                tot[k] += c[k]
        return {
            "attached": True,
            "n_clients": len(self._clients),
            "queue_events": self._ingest_events,
            "queue_capacity": self.config.queue_events,
            "totals": dict(tot),
            "per_client": per_client,
        }

    # ----------------------------------------------------- asyncio shell
    async def start(self, host: str = "127.0.0.1", tcp_port: int = 0,
                    udp_port: Optional[int] = 0) -> None:
        """Bind the TCP listener (always) and the UDP endpoint (unless
        ``udp_port=None``), and start the pump task. Port 0 = ephemeral;
        read back via ``tcp_port`` / ``udp_port`` properties."""
        self._loop = asyncio.get_running_loop()
        self._tcp_server = await asyncio.start_server(
            self._handle_tcp, host, tcp_port, limit=1 << 20)
        if udp_port is not None:
            self._udp_transport, _ = \
                await self._loop.create_datagram_endpoint(
                    lambda: _UdpEndpoint(self), local_addr=(host, udp_port))
            self._udp_transport.get_extra_info("socket").setsockopt(
                socket.SOL_SOCKET, socket.SO_RCVBUF, UDP_RCVBUF_BYTES)
        if self.config.offload_decode:
            self._decode_q = queue.Queue()
            self._decode_thread = threading.Thread(
                target=self._decode_worker, name="front-door-decode",
                daemon=True)
            self._decode_thread.start()
        self._pump_task = asyncio.create_task(self._pump_loop())

    async def stop(self) -> None:
        # order: stop ingest first, then drain the decode worker, then
        # let its handed-back messages land, then kill the pump
        if self._tcp_server is not None:
            self._tcp_server.close()
            await self._tcp_server.wait_closed()
            self._tcp_server = None
        if self._udp_transport is not None:
            self._udp_transport.close()
            self._udp_transport = None
        if self._decode_thread is not None:
            self._decode_q.put(None)
            self._decode_thread.join()
            self._decode_thread = None
            self._decode_q = None
            await asyncio.sleep(0)    # run the worker's last callbacks
            self.pump()
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
            self._pump_task = None

    @property
    def tcp_port(self) -> int:
        return self._tcp_server.sockets[0].getsockname()[1]

    @property
    def udp_port(self) -> int:
        return self._udp_transport.get_extra_info("sockname")[1]

    async def _pump_loop(self) -> None:
        while True:
            moved = self.pump()
            # yield even when busy so transports get to deliver bytes;
            # back off only when a turn moved nothing
            await asyncio.sleep(0 if moved else self.config.idle_sleep_s)

    def _decode_worker(self) -> None:
        """Worker thread: CRC + payload decode off the event loop. The
        queue preserves per-client byte order; decoded messages are
        handed back to the loop thread, so every counter and the ingest
        queue are still touched by ONE thread only."""
        while True:
            item = self._decode_q.get()
            if item is None:
                return
            key, data, is_stream = item
            st = self._clients.get(key)
            if st is None:
                continue
            st.bytes_in += len(data)   # only this thread writes it
            if is_stream:
                msgs = st.decoder.feed(data)
                if msgs:
                    self._loop.call_soon_threadsafe(self._deliver, st, msgs)
            else:
                try:
                    msg = P.decode_datagram(data)
                except P.ProtocolError:
                    self._loop.call_soon_threadsafe(self._udp_error, st)
                    continue
                self._loop.call_soon_threadsafe(self._deliver, st, [msg])

    def _deliver(self, st: _Client, msgs: List[P.Message]) -> None:
        for msg in msgs:
            self._on_message(st, msg)

    @staticmethod
    def _udp_error(st: _Client) -> None:
        st.udp_errors += 1

    def _rx_datagram(self, key: str, data: bytes) -> None:
        if self._decode_q is not None:
            self._decode_q.put((key, data, False))
        else:
            self.feed_datagram(key, data)

    async def _handle_tcp(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        key = f"tcp:{peer[0]}:{peer[1]}" if peer else f"tcp:{id(writer)}"
        self.client_connect(key, writer.write, stream=True)
        try:
            while True:
                data = await reader.read(1 << 20)
                if not data:
                    break
                if self._decode_q is not None:
                    self._decode_q.put((key, data, True))
                else:
                    self.feed(key, data)
        finally:
            self.client_disconnect(key)
            try:
                writer.close()
            except Exception:
                pass


class _UdpEndpoint(asyncio.DatagramProtocol):
    def __init__(self, door: ReadoutFrontDoor):
        self._door = door
        self._transport = None

    def connection_made(self, transport):
        self._transport = transport

    def datagram_received(self, data, addr):
        key = f"udp:{addr[0]}:{addr[1]}"
        if key not in self._door._clients:
            self._door.client_connect(
                key, lambda b, _a=addr: self._transport.sendto(b, _a),
                stream=False)
        self._door._rx_datagram(key, data)
