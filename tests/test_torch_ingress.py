"""The port's front door (repro_torch/net/ingress.py) over a port server
on the CPU against the JAX package's door over a JAX server.

Both doors take the same feeds through their synchronous core (no
sockets): chunked TCP bytes from two sensors, datagrams with duplicates,
gaps and late arrivals, garbage and corrupt frames on both transports, a
client sending server-role messages, a queue at capacity, a sensor id
past the server's chips, a client gone before its answer, and deadline
sheds under an injected FakeClock. Stated tolerance: exact. After every
step both doors must have sent the same bytes to every client, and at
the end their ``stats()`` and ``report()["net"]`` must be equal. A door
with ``sensor_tenants`` in front of a fleet (launch/fleet.py) is held
the same way against the JAX door in front of the JAX fleet, an unmapped
and a retired tenant's sensor among its feeds.

Both servers run on frozen clocks, so a micro-batch forms only at
``max_batch`` or a flush, at the same points in both. The JAX servers use
the host backend (the readiness probe of numpy results never waits); the
port's runs its default served path, each kernel's plain twin on the CPU.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro.net.ingress import FrontDoorConfig as JaxDoorConfig  # noqa: E402
from repro.net.ingress import ReadoutFrontDoor as JaxDoor  # noqa: E402
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig  # noqa: E402
from repro.launch.fleet import TenantFleet as JaxFleet  # noqa: E402
from repro_torch.launch.fleet import TenantFleet  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from repro_torch.net import protocol as P  # noqa: E402
from repro_torch.net.ingress import FrontDoorConfig, ReadoutFrontDoor  # noqa: E402
from tests._torch_helpers import chip_pair  # noqa: E402

EVENTS = 8


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def farm():
    """(JAX chips, port chips, {(step, sensor): (frames, y0)})."""
    pairs = [chip_pair(f) for f in ("efpga_28nm", "efpga_130nm")]
    fs = FrameStream(FrameStreamConfig(n_sensors=2, batch=EVENTS, seed=702))
    blocks = {(b, s): (fs.batch_at(b, s)["frames"], fs.batch_at(b, s)["y0"])
              for b in range(12) for s in range(2)}
    return [p[0] for p in pairs], [p[1] for p in pairs], blocks


class Twin:
    """One JAX door and one port door; every call goes to both."""

    def __init__(self, farm, door=(), **srv):
        jax_chips, port_chips, self.blocks = farm
        kw = dict(max_batch=32, max_latency_s=1e9, batch_tile=128)
        kw.update(srv)
        self.clocks = (FakeClock(), FakeClock())
        self.servers = (
            JaxServer(jax_chips, JaxConfig(backend="host", **kw),
                      clock=self.clocks[0]),
            ReadoutServer(port_chips, ServerConfig(**kw),
                          clock=self.clocks[1], device="cpu"))
        self.doors = (JaxDoor(self.servers[0], JaxDoorConfig(**dict(door))),
                      ReadoutFrontDoor(self.servers[1],
                                       FrontDoorConfig(**dict(door))))
        self.sent = ({}, {})

    def connect(self, key, stream):
        for door, sent in zip(self.doors, self.sent):
            sent.setdefault(key, [])
            door.client_connect(key, sent[key].append, stream=stream)

    def call(self, name, *args):
        for door in self.doors:
            getattr(door, name)(*args)
        self.check()

    def advance(self, dt):
        for clock in self.clocks:
            clock.advance(dt)

    def wire(self, b, sensor, seq=None, wire_sensor=None):
        fr, y0 = self.blocks[b, sensor]
        return P.encode_frame_batch(
            sensor if wire_sensor is None else wire_sensor,
            b if seq is None else seq, fr, y0)

    def check(self):
        jax_sent, port_sent = self.sent
        assert port_sent == jax_sent
        assert self.doors[1].stats() == self.doors[0].stats()

    def finish(self):
        self.call("drain")
        net = self.servers[1].report()["net"]
        assert net == self.servers[0].report()["net"]
        assert net == self.doors[1].stats() and net["attached"] is True
        for c in net["per_client"].values():
            assert c["events_in"] == (
                c["events_admitted"] + c["events_shed"]
                + c["events_queue_dropped"] + c["events_bad_sensor"])
            assert c["pending_batches"] == 0
        return net, [P.decode_datagram(w)
                     for ws in self.sent[1].values() for w in ws]


def _chunks(rng, data):
    cuts = np.sort(rng.integers(0, len(data), 12))
    return [data[a:b] for a, b in zip([0, *cuts], [*cuts, len(data)])]


def scenario_tcp_chunked(twin):
    """Two TCP sensors, their byte streams split at random offsets."""
    rng = np.random.default_rng(1)
    for s in range(2):
        twin.connect(f"tcp{s}", stream=True)
    streams = [b"".join(twin.wire(b, s) for b in range(6))
               + P.encode_flush(s, 6) for s in range(2)]
    chunks = [_chunks(rng, st) for st in streams]
    for i in range(13):
        for s in range(2):
            twin.call("feed", f"tcp{s}", chunks[s][i])
        if i % 3 == 2:
            twin.call("pump")
    twin.call("pump")


def scenario_udp_loss_and_reorder(twin):
    """Datagrams dropped, duplicated and delivered late, then FLUSH."""
    twin.connect("udp", stream=False)
    order = [0, 2, 1, 3, 3, 5, 6, 4, 8, 9, 9, 11]     # 7 and 10 lost
    for i, b in enumerate(order):
        twin.call("feed_datagram", "udp", twin.wire(b, 0))
        if i % 2:
            twin.call("pump")
    twin.call("feed_datagram", "udp", P.encode_flush(0, 12))


def scenario_garbage_on_both_transports(twin):
    """Noise, a corrupt frame, a split frame, a server-role message."""
    rng = np.random.default_rng(4)
    twin.connect("udp", stream=False)
    twin.connect("tcp", stream=True)
    twin.call("feed_datagram", "udp", rng.bytes(100))
    twin.call("feed_datagram", "udp", twin.wire(0, 0)[:-1])
    twin.call("feed_datagram", "udp", P.encode_trigger_batch(
        0, 0, orig_seq=0, n_events=1, n_admitted=1, idx=[0], scores=[1]))
    twin.call("feed_datagram", "udp", twin.wire(1, 0, seq=0))
    corrupt = bytearray(twin.wire(2, 1))
    corrupt[30] ^= 0x10
    # the noise ends on a byte that cannot begin the magic: the port's
    # decoder keeps a partial magic at a chunk's end (fault C.1 of the
    # reference, tests/test_torch_protocol.py), the JAX one drops it
    noise = rng.bytes(999) + b"\0"
    for part in (noise, bytes(corrupt), twin.wire(3, 1, seq=1)[:30]):
        twin.call("feed", "tcp", part)
    twin.call("feed", "tcp", twin.wire(3, 1, seq=1)[30:]
              + P.encode_flush(1, 2))
    twin.call("feed_datagram", "udp", P.encode_flush(0, 1))
    twin.call("pump")


def scenario_queue_at_capacity(twin):
    """10 x 8 events against a 16-event queue without a pump."""
    twin.connect("c", stream=False)
    for b in range(10):
        twin.call("feed_datagram", "c", twin.wire(b, 1))
    twin.call("feed_datagram", "c", P.encode_flush(0, 10))


def scenario_bad_sensor_and_gone_client(twin):
    """A sensor id past the server's chips; a client that disconnects
    with a batch in flight (its answer is counted, not sent)."""
    twin.connect("c", stream=False)
    twin.connect("gone", stream=False)
    twin.call("feed_datagram", "c", twin.wire(0, 0, wire_sensor=3))
    twin.call("feed_datagram", "c", twin.wire(1, 1, seq=1))
    twin.call("feed_datagram", "gone", twin.wire(2, 0, seq=0))
    twin.call("pump")
    twin.call("client_disconnect", "gone")
    twin.call("feed_datagram", "c", P.encode_flush(0, 2))


def scenario_deadline_sheds(twin):
    """A batch admitted by the idle probe waits undispatched; once the
    clock passes the deadline the two batches queued behind it are shed
    at submit and answered at once with n_admitted 0; the pump's poll
    then dispatches the late batch, and the idle server admits the
    next."""
    twin.connect("c", stream=False)
    twin.call("feed_datagram", "c", twin.wire(0, 0))
    twin.call("pump")
    twin.advance(0.1)
    for b in (1, 2):
        twin.call("feed_datagram", "c", twin.wire(b, b % 2))
    twin.call("pump")
    twin.call("feed_datagram", "c", twin.wire(3, 1))
    twin.call("pump")
    twin.call("feed_datagram", "c", P.encode_flush(0, 4))


SCENARIOS = {
    "tcp_chunked": (scenario_tcp_chunked, {}, {}),
    "udp_loss_and_reorder": (scenario_udp_loss_and_reorder, {}, {}),
    "garbage": (scenario_garbage_on_both_transports, {}, {}),
    "queue_at_capacity": (scenario_queue_at_capacity,
                          {"queue_events": 16}, {}),
    "bad_sensor_and_gone_client": (scenario_bad_sensor_and_gone_client,
                                   {}, {}),
    "deadline_sheds": (scenario_deadline_sheds, {},
                       {"deadline_us": 1_000.0, "overload_policy": "shed"}),
}

# what each scenario must show beyond the equality (totals of stats())
EXPECT = {
    "tcp_chunked": {"events_in": 96, "events_admitted": 96},
    "udp_loss_and_reorder": {"batches_in": 10, "seq_gaps": 2,
                             "reorders": 2, "duplicates": 2},
    "garbage": {"events_admitted": 16, "batches_in": 2},
    "queue_at_capacity": {"events_in": 80, "events_queue_dropped": 64},
    "bad_sensor_and_gone_client": {"events_bad_sensor": 8,
                                   "events_admitted": 16},
    "deadline_sheds": {"events_shed": 16, "events_admitted": 16},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_door_sends_the_jax_doors_bytes(farm, name):
    run, door_kw, srv_kw = SCENARIOS[name]
    twin = Twin(farm, door=door_kw, **srv_kw)
    run(twin)
    net, msgs = twin.finish()
    totals = net["totals"]
    for k, v in EXPECT[name].items():
        assert totals[k] == v, (k, totals)
    assert 0 < totals["events_kept"] <= totals["events_admitted"]
    assert any(m.msg_type == P.MSG_FLUSH_ACK for m in msgs)
    assert twin.servers[1].report()["n_in"] == totals["events_admitted"]


def test_net_report_is_detached_until_a_door_attaches(farm):
    _, port_chips, _ = farm
    server = ReadoutServer(port_chips, ServerConfig(), device="cpu")
    assert server.report()["net"] == {"attached": False}
    door = ReadoutFrontDoor(server)
    door.client_connect("c", lambda b: None)
    net = server.report()["net"]
    assert net["attached"] is True and net["n_clients"] == 1
    assert "c" in net["per_client"]
    server.attach_net_stats(None)
    assert server.report()["net"] == {"attached": False}


def test_udp_endpoint_asks_for_a_wide_receive_buffer(farm):
    """The door's UDP socket gets the receive buffer UDP_RCVBUF_BYTES
    asks for (as far as the kernel grants it to any socket), in place of
    the default that holds three 7-event datagrams."""
    import asyncio
    import socket

    from repro_torch.net import ingress

    _, port_chips, _ = farm
    door = ReadoutFrontDoor(ReadoutServer(port_chips, ServerConfig(),
                                          device="cpu"))
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    default = probe.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                     ingress.UDP_RCVBUF_BYTES)
    granted = probe.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    probe.close()

    async def go():
        await door.start()
        try:
            return door._udp_transport.get_extra_info("socket").getsockopt(
                socket.SOL_SOCKET, socket.SO_RCVBUF)
        finally:
            await door.stop()

    got = asyncio.run(go())
    assert got == granted and ingress.UDP_RCVBUF_BYTES > default


def test_front_door_refuses_a_sparse_server(farm):
    _, port_chips, _ = farm
    server = ReadoutServer(port_chips, ServerConfig(sparse=True),
                           device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        ReadoutFrontDoor(server)


def test_sensor_tenants_validates_like_jax():
    with pytest.raises(ValueError, match="sensor_tenants") as e:
        FrontDoorConfig(sensor_tenants=[("a", 1)])
    with pytest.raises(ValueError) as je:
        JaxDoorConfig(sensor_tenants=[("a", 1)])
    assert str(e.value) == str(je.value)
    cfg = FrontDoorConfig(sensor_tenants={0: "pix"})
    assert cfg.sensor_tenants == JaxDoorConfig(
        sensor_tenants={0: "pix"}).sensor_tenants


class FleetTwin(Twin):
    """The JAX door over a JAX fleet (host backend) and the port's door
    over the port's fleet (its default served path on the CPU), each
    fleet holding tenants "pix" and "neu" and the retired "old"."""

    def __init__(self, farm, sensor_tenants):
        jax_chips, port_chips, self.blocks = farm
        kw = dict(max_batch=32, max_latency_s=1e9, batch_tile=128)
        self.clocks = (FakeClock(), FakeClock())
        self.servers = (
            JaxFleet(JaxConfig(backend="host", **kw), clock=self.clocks[0],
                     bucket_slots=2),
            TenantFleet(ServerConfig(**kw), clock=self.clocks[1],
                        bucket_slots=2, device="cpu"))
        for fleet, chips in zip(self.servers, (jax_chips, port_chips)):
            for tenant, chip in (("pix", chips[0]), ("neu", chips[1]),
                                 ("old", chips[1])):
                fleet.admit(tenant, chip)
            fleet.retire("old")
        door = dict(sensor_tenants=sensor_tenants)
        self.doors = (JaxDoor(self.servers[0], JaxDoorConfig(**door)),
                      ReadoutFrontDoor(self.servers[1],
                                       FrontDoorConfig(**door)))
        self.sent = ({}, {})


def test_port_door_over_fleet_sends_the_jax_doors_bytes(farm):
    """Sensors 0 and 1 map onto tenants, sensor 2 onto nothing and
    sensor 3 onto a retired tenant: both doors send the same bytes after
    every step and end with the same stats(); the last two sensors'
    events count as events_bad_sensor and reach no fleet."""
    twin = FleetTwin(farm, {0: "pix", 1: "neu", 3: "old"})
    twin.connect("udp", stream=False)
    twin.connect("tcp", stream=True)
    for b in range(4):
        twin.call("feed_datagram", "udp", twin.wire(b, b % 2))
        twin.call("feed", "tcp", twin.wire(b + 4, 1 - b % 2, seq=2 * b))
        twin.call("feed", "tcp", twin.wire(b + 8, 0, seq=2 * b + 1,
                                           wire_sensor=2 + b % 2))
        twin.call("pump")
    twin.call("feed_datagram", "udp", P.encode_flush(0, 4))
    twin.call("feed", "tcp", P.encode_flush(1, 8))
    net, msgs = twin.finish()
    totals = net["totals"]
    assert totals["events_bad_sensor"] == 4 * EVENTS
    assert totals["events_admitted"] == 8 * EVENTS
    ledgers = [f.report()["tenants"] for f in twin.servers]
    assert ledgers[1] == ledgers[0]
    assert ledgers[1]["old"]["events_in"] == 0
    assert (ledgers[1]["pix"]["events_out"] + ledgers[1]["neu"]["events_out"]
            == 8 * EVENTS)
    assert sum(m.msg_type == P.MSG_FLUSH_ACK for m in msgs) == 2


def test_door_config_fields_and_validation_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(
        FrontDoorConfig)] == [(f.name, f.default) for f in
                              dataclasses.fields(JaxDoorConfig)])
    for bad in ({"queue_events": 0}, {"queue_events": 1.5},
                {"idle_sleep_s": 0.0}):
        with pytest.raises(ValueError):
            FrontDoorConfig(**bad)
        with pytest.raises(ValueError):
            JaxDoorConfig(**bad)
