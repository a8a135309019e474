"""The port's closed-loop replay (repro_torch/net/replay.py) against a live
front door of the port (repro_torch/net/ingress.py) on loopback, on the
CPU.

* TCP and UDP replays against the port's door over a port server
  (``device="cpu"``, the default served path's plain twins): every
  trigger verified against the port's ``host_oracle(device="cpu")``, the
  FLUSH_ACK's accounting exact, per-chip attribution in the report;
* 12 concurrent TCP clients with a 10 us thread switch interval: every
  client's bytes and events counted once (the decode worker and the
  event loop share the client state);
* exact drop accounting under tests/test_replay.py's lossy, reordering
  shim (dropped, duplicated and swapped datagrams through the
  synchronous core), every delivered batch's trigger verified;
* the replay helpers against the JAX package's: ``host_oracle`` gives
  the same (score, keep) on the same frames (its featurizer is the
  port's; no summation-order flip reaches a decision on these frames),
  the arrival schedule, the sources and the config's validation are the
  same. Stated tolerance: exact.
"""
import asyncio
import dataclasses

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.net import replay as JR  # noqa: E402
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from repro_torch.net import protocol as P  # noqa: E402
from repro_torch.net import replay as R  # noqa: E402
from repro_torch.net.ingress import FrontDoorConfig, ReadoutFrontDoor  # noqa: E402
from tests._torch_helpers import chip_pair  # noqa: E402


@pytest.fixture(scope="module")
def farm():
    """(JAX chips, port chips, the recorded two-sensor frame stream)."""
    pairs = [chip_pair(f) for f in ("efpga_28nm", "efpga_130nm")]
    stream = FrameStream(FrameStreamConfig(n_sensors=2, batch=16, seed=701))
    return [p[0] for p in pairs], [p[1] for p in pairs], stream


def _server(chips, **kw):
    """A port server on the CPU, its first pass built before the door
    opens (a datagram that arrives while the loop is busy past the
    socket's receive buffer is lost)."""
    server = ReadoutServer(chips, ServerConfig(
        max_batch=kw.pop("max_batch", 64), max_latency_s=2e-3, **kw),
        device="cpu")
    blk = FrameStream(FrameStreamConfig(n_sensors=1, batch=4)).batch_at(0, 0)
    for c in range(server.n_chips):
        server.submit_frames(c, blk["frames"], blk["y0"])
    server.flush()
    return server


async def _run_replay(door, cfgs, sources, oracles):
    await door.start()
    try:
        return await asyncio.gather(*(
            R.replay("127.0.0.1",
                     door.tcp_port if c.transport == "tcp"
                     else door.udp_port, s, c, o)
            for c, s, o in zip(cfgs, sources, oracles)))
    finally:
        await door.stop()


@pytest.mark.parametrize("transports,offload,redundancy", [
    (("tcp", "tcp"), True, "none"),
    (("tcp", "udp"), False, "none"),
    (("udp", "udp"), True, "tmr")])
def test_loopback_replay_verified_against_the_host_oracle(
        farm, transports, offload, redundancy):
    """One client a chip, concurrently. TCP is unpaced; UDP is paced
    slowly enough that the loop, busy with a pass on the CPU, reads each
    datagram before the socket's receive buffer fills."""
    _, chips, stream = farm
    server = _server(chips, redundancy=redundancy)
    n_in0 = server.report()["n_in"]
    door = ReadoutFrontDoor(server, FrontDoorConfig(offload_decode=offload))
    cfgs, sources, oracles = [], [], []
    for s, transport in enumerate(transports):
        per = P.UDP_MAX_EVENTS if transport == "udp" else 16
        cfgs.append(R.ReplayConfig(
            n_batches=6, events_per_batch=per, sensor=s,
            transport=transport, seed=s, timeout_s=15.0,
            rate_hz=100.0 if transport == "udp" else 0.0))
        sources.append(R.frame_stream_source(stream, s, per))
        oracles.append(R.host_oracle(chips[s], device="cpu"))
    reps = asyncio.run(_run_replay(door, cfgs, sources, oracles))
    net = server.report()["net"]
    assert net["n_clients"] == 2
    for cfg, rep in zip(cfgs, reps):
        n = cfg.n_batches * cfg.events_per_batch
        assert rep.verified, rep.mismatches
        assert rep.unanswered == 0 and rep.n_triggers == cfg.n_batches
        assert rep.ack["events_in"] == n == rep.ack["events_admitted"]
        assert rep.ack["events_shed"] == 0 == rep.ack["events_queue_dropped"]
        assert rep.ack["seq_gaps"] == rep.ack["reorders"] == 0
        assert rep.latency["count"] == n and rep.latency["p99_us"] > 0
        assert rep.bytes_out == cfg.n_batches * (
            P.HEADER_BYTES + 4 + n // cfg.n_batches * P.FRAME_EVENT_BYTES
        ) + P.HEADER_BYTES
        client = [c for c in net["per_client"].values()
                  if (c["bytes_in"], c["bytes_out"], c["events_kept"])
                  == (rep.bytes_out, rep.bytes_in, rep.n_kept)]
        assert len(client) == 1 and client[0]["events_in"] == n
    per_chip = server.report()["per_chip"]
    assert [c["n_in"] for c in per_chip] == [
        4 + c.n_batches * c.events_per_batch for c in cfgs]
    assert server.report()["n_in"] - n_in0 == sum(
        c.n_batches * c.events_per_batch for c in cfgs)
    assert server.report()["seu_disagreement_total"] == 0


def test_drop_accounting_exact_under_lossy_reordering_shim(farm):
    """tests/test_replay.py's seeded shim drops, duplicates and swaps
    datagrams between the client and the port door's synchronous core;
    the per-client counters equal the shim's ground truth and every
    delivered batch's trigger verifies."""
    _, chips, stream = farm
    door = ReadoutFrontDoor(_server(chips))
    rng = np.random.default_rng(11)
    n_batches, per = 20, 4
    oracle = R.host_oracle(chips[0], device="cpu")

    wires, sent = [], {}
    for b in range(n_batches):
        blk = stream.batch_at(b, 0)
        fr, y0 = blk["frames"][:per], blk["y0"][:per]
        sent[b] = (fr, y0)
        wires.append((b, P.encode_frame_batch(0, b, fr, y0)))
    while True:
        seqs = rng.permutation(np.arange(1, n_batches - 1))
        dropped = set(map(int, seqs[:4]))
        duplicated = set(map(int, seqs[4:7]))
        swapped = set(map(int, seqs[7:10]))  # seq s arrives AFTER s+1
        if (not (swapped & {s - 1 for s in swapped})
                and not ({s + 1 for s in swapped}
                         & (dropped | duplicated | swapped))):
            break
    delivery, skip_next = [], set()
    for b, w in wires:
        if b in dropped or b in skip_next:
            continue
        if b in swapped and b + 1 not in dropped:
            delivery += [wires[b + 1], (b, w)]
            skip_next.add(b + 1)
            continue
        delivery.append((b, w))
        if b in duplicated:
            delivery.append((b, w))

    out = []
    door.client_connect("shim", out.append, stream=False)
    for _b, w in delivery:
        door.feed_datagram("shim", w)
        door.pump()
    door.feed_datagram("shim", P.encode_flush(0, n_batches))
    door.drain()

    got = [P.decode_datagram(w) for w in out]
    triggers = {m.orig_seq: m for m in got
                if m.msg_type == P.MSG_TRIGGER_BATCH}
    acks = [m for m in got if m.msg_type == P.MSG_FLUSH_ACK]
    assert len(acks) == 1
    c = acks[0].counters
    delivered = n_batches - len(dropped)
    assert c["batches_in"] == delivered
    assert c["events_in"] == delivered * per == c["events_admitted"]
    assert c["seq_gaps"] == len(dropped)
    assert c["duplicates"] == len(duplicated)
    assert c["reorders"] == len(swapped)
    assert c["events_shed"] == 0 == c["events_queue_dropped"]
    assert set(triggers) == set(range(n_batches)) - dropped
    for b, trig in triggers.items():
        score, keep = oracle(*sent[b])
        want = {(int(p), int(score[p])) for p in np.nonzero(keep)[0]}
        assert {(int(p), int(s))
                for p, s in zip(trig.idx, trig.scores)} == want, b


def test_host_oracle_equals_the_jax_packages(farm):
    jax_chips, chips, stream = farm
    keeps = []
    for s in range(2):
        blks = [stream.batch_at(b, s) for b in range(4)]
        fr = np.concatenate([b["frames"] for b in blks])
        y0 = np.concatenate([b["y0"] for b in blks])
        want = JR.host_oracle(jax_chips[s])(fr, y0)
        got = R.host_oracle(chips[s], device="cpu")(fr, y0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        keeps.append(got[1])
    assert np.concatenate(keeps).any() and not np.concatenate(keeps).all()


@pytest.mark.parametrize("kw", [
    dict(rate_hz=5_000.0, pattern="poisson", n_batches=40, seed=3),
    dict(rate_hz=8_000.0, pattern="square", n_batches=40,
         square_period_s=0.01, burst_factor=3.0),
    dict(rate_hz=0.0, n_batches=5)])
def test_arrival_schedule_equals_the_jax_packages(kw):
    np.testing.assert_array_equal(
        R.batch_arrival_times(R.ReplayConfig(**kw)),
        JR.batch_arrival_times(JR.ReplayConfig(**kw)))


def test_sources_and_config_match_the_jax_packages(farm):
    _, _, stream = farm
    assert ([(f.name, f.default) for f in dataclasses.fields(R.ReplayConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JR.ReplayConfig)])
    assert ([f.name for f in dataclasses.fields(R.ReplayReport)]
            == [f.name for f in dataclasses.fields(JR.ReplayReport)])
    for bad in (dict(pattern="burst"), dict(transport="quic"),
                dict(transport="udp", events_per_batch=8),
                dict(rate_hz=-1.0), dict(burst_factor=0.5)):
        with pytest.raises(ValueError):
            R.ReplayConfig(**bad)
        with pytest.raises(ValueError):
            JR.ReplayConfig(**bad)
    with pytest.raises(ValueError):
        R.frame_stream_source(stream, 0, 17)
    blk = stream.batch_at(0, 1)
    for b in (0, 3):
        got = R.frame_stream_source(stream, 1, 5)(b)
        want = JR.frame_stream_source(stream, 1, 5)(b)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        got = R.array_source(blk["frames"], blk["y0"], 6)(b)
        want = JR.array_source(blk["frames"], blk["y0"], 6)(b)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_many_clients_under_a_short_switch_interval_keep_exact_counts(farm):
    """The decode worker and the event loop share each client's state
    (the worker decodes and counts bytes_in, the loop does the rest): 12
    concurrent TCP clients with the interpreter switching threads every
    10 us, and still every client's bytes and events are counted once
    and every trigger verifies."""
    import sys

    _, chips, stream = farm
    server = _server(chips)
    door = ReadoutFrontDoor(server)
    cfgs = [R.ReplayConfig(n_batches=4, events_per_batch=4, sensor=c % 2,
                           seed=c, timeout_s=15.0) for c in range(12)]
    sources = [R.frame_stream_source(stream, c % 2, 4) for c in range(12)]
    oracles = [R.host_oracle(chips[c % 2], device="cpu") for c in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        reps = asyncio.run(_run_replay(door, cfgs, sources, oracles))
    finally:
        sys.setswitchinterval(interval)
    assert all(r.verified for r in reps), [r.mismatches for r in reps]
    net = server.report()["net"]
    assert net["n_clients"] == 12
    assert sorted(c["bytes_in"] for c in net["per_client"].values()) == \
        sorted(r.bytes_out for r in reps)
    assert net["totals"]["events_in"] == 12 * 16 == \
        net["totals"]["events_admitted"]
    assert door._decode_thread is None
