"""The port's scrub / TMR-SEU loop against the JAX package's, on the CPU.

Two small calibrated chips (a 28 nm and a 130 nm one, trained as the JAX
package's tests/test_scrub.py trains its pair) are built identically by
both packages. The same feature stream goes through the JAX server and
the port's server (``device="cpu"``, the kernels' plain twins), with an
output-changing SEU injected into one replica frame mid-stream (found
with the numpy FabricSim oracle, as tests/test_scrub.py:_effective_flip
finds it): under steered TMR the last frame, which only steering reaches
soon, otherwise the frame round robin samples next. Stated tolerance:
exact. In both scrub modes, both layouts and both
redundancies the port must equal JAX on every served event, the
disagreement counters after every step, ``report()["scrub"]``,
``verify_frame`` before and after the heal, the readback bytes of every
replica frame and their CRC digests.

The JAX server's readiness probe is made to block on its arrays: its CPU
results become ready at a moment that depends on the host's timing, the
port's are on the host at once, and the scrub schedule follows the
drains. With the probe blocking, both servers retire every batch at the
same point of the loop.
"""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.bdt import GradientBoostedClassifier as JaxGBC  # noqa: E402
from repro.core.bitstream import table_digest as jax_digest  # noqa: E402
from repro.core.readout import ReadoutChip as JaxChip  # noqa: E402
from repro.data.smartpixel import SmartPixelConfig as JaxSPC  # noqa: E402
from repro.data.smartpixel import generate as jax_generate  # noqa: E402
from repro.data.smartpixel import train_test_split as jax_split  # noqa: E402
from repro.kernels.lut_eval import ops as jax_ops  # noqa: E402
from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch.core.bdt import GradientBoostedClassifier as PortGBC  # noqa: E402
from repro_torch.core.bitstream import table_digest  # noqa: E402
from repro_torch.core.fabric import FabricSim, packed_table_image  # noqa: E402
from repro_torch.core.readout import ReadoutChip as PortChip  # noqa: E402
from repro_torch.core.tmr import (  # noqa: E402
    inject_seu,
    replica_lut_index,
    replica_table_images,
    replicate_config,
)
from repro_torch.data.smartpixel import SmartPixelConfig as PortSPC  # noqa: E402
from repro_torch.data.smartpixel import generate as port_generate  # noqa: E402
from repro_torch.data.smartpixel import train_test_split as port_split  # noqa: E402
from repro_torch.kernels.lut_eval import ops as lut_ops  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402

N_EV = 24           # events a chip a step
N_STEPS = 4
INJECT_AT = 2


def _duo(gbc, chip_cls, spc, generate, split):
    tr, te = split(generate(spc(n_events=10_000, seed=23)))
    chips = []
    for fabric in ("efpga_28nm", "efpga_130nm"):
        clf = gbc(n_estimators=1, max_depth=3, max_leaf_nodes=5,
                  min_samples_leaf=300).fit(tr["features"], tr["label"])
        chip = chip_cls.build(clf, fabric=fabric)
        chip.calibrate(tr["features"], tr["label"], target_sig_eff=0.95)
        chips.append(chip)
    return chips, te["features"][: 2 * N_EV]


def _golden(chip, X):
    return chip.golden.decision_function_raw(chip.golden.quantize_features(X))


def _effective_flip(chip, X):
    """(lut, bit) in base coordinates whose flip changes the outputs."""
    golden, bits = _golden(chip, X), chip.encode_features(X)
    for li in range(chip.config.n_luts):
        for bi in range(16):
            outs, _ = FabricSim(inject_seu(chip.config, li, bi)).run(bits)
            if not np.array_equal(
                    chip.synth.decode_outputs(np.asarray(outs)), golden):
                return li, bi
    raise AssertionError("no effective flip found")


@pytest.fixture(scope="module")
def duo():
    """(JAX chips, port chips, X, flips): the pair trained by both
    packages, 48 test events (chip c serves X[c*24:(c+1)*24]), and per
    chip an output-changing flip in base coordinates."""
    jax_chips, X = _duo(JaxGBC, JaxChip, JaxSPC, jax_generate, jax_split)
    port_chips, X2 = _duo(PortGBC, PortChip, PortSPC, port_generate,
                          port_split)
    assert np.array_equal(X, X2)
    flips = [_effective_flip(c, X[i * N_EV:(i + 1) * N_EV])
             for i, c in enumerate(port_chips)]
    return jax_chips, port_chips, X, flips


def _blocking(server: JaxServer) -> JaxServer:
    server._result_ready = lambda x: (jax.block_until_ready(x), True)[1]
    return server


def _server(pkg, chips, **kw):
    if pkg == "jax":
        return _blocking(JaxServer(chips, JaxConfig(**kw),
                                   clock=lambda: 0.0))
    return ReadoutServer(chips, ServerConfig(**kw), clock=lambda: 0.0,
                         device="cpu")


def _scrub_run(pkg, chips, X, flips, **kw):
    """Serve N_STEPS steps of both chips' blocks (submit, flush), an SEU
    injected before step INJECT_AT: steered under TMR into the last
    replica frame (steering must find it), otherwise into the frame round
    robin samples next. Returns ({seq: (chip, score, keep)}, per-step
    disagreement counters, verify of every frame right after the inject
    and at the end, report, the server, the upset (slot, replica))."""
    server = _server(pkg, chips, max_batch=2 * N_EV, max_latency_s=1e9,
                     scrub_interval=1, pipeline_depth=1, **kw)
    R = server.n_replicas
    out, dis, verify_hit = [], [], None
    for step in range(N_STEPS):
        if step == INJECT_AT:
            if kw.get("scrub_mode", "steered") == "steered" and R > 1:
                slot, r = 1, R - 1
            else:
                slot, r = divmod(server._scrub_rr, R)
            li, bi = flips[slot]
            server.inject_seu(slot, r,
                              replica_lut_index(chips[slot].config, r, li),
                              bi)
            verify_hit = [server.verify_frame(s, q) for s in range(2)
                          for q in range(R)]
        server.submit_batch(0, X[:N_EV])
        server.submit_batch(1, X[N_EV:])
        out += server.flush()
        dis.append([c["seu_disagreements"]
                    for c in server.report()["per_chip"]])
    verify_end = [server.verify_frame(s, q) for s in range(2)
                  for q in range(R)]
    return ({r.seq: (r.chip, r.score_raw, r.keep) for r in out}, dis,
            verify_hit, verify_end, server.report(), server, (slot, r))


@pytest.fixture(scope="module", ids="-".join, params=[
    (layout, red, mode) for layout in ("bitsliced", "matmul")
    for red in ("tmr", "none") for mode in ("steered", "round_robin")])
def jax_scrub(request, duo):
    """(layout, redundancy, scrub mode) and the JAX server's run of it
    (in setup: the JAX matmul kernels run interpreted)."""
    jax_chips, _, X, flips = duo
    layout, red, mode = request.param
    return request.param, _scrub_run("jax", jax_chips, X, flips,
                                     layout=layout, redundancy=red,
                                     scrub_mode=mode)


def test_scrub_seu_loop_matches_jax(duo, jax_scrub):
    _, port_chips, X, flips = duo
    (layout, red, mode), want = jax_scrub
    got = _scrub_run("port", port_chips, X, flips, layout=layout,
                     redundancy=red, scrub_mode=mode)
    assert got[0] == want[0] and len(got[0]) == N_STEPS * 2 * N_EV
    assert got[1] == want[1]                   # counters after every step
    assert got[2] == want[2] and got[3] == want[3]
    assert got[4]["scrub"] == want[4]["scrub"]
    scrub = got[4]["scrub"]
    assert scrub["detections"] == 1 and scrub["healed_bits"] == 1
    assert scrub["steps"] == N_STEPS and all(got[3])
    R = 3 if red == "tmr" else 1
    slot, r = got[6]
    assert got[6] == want[6]
    assert got[2] == [(s, q) != (slot, r) for s in range(2)
                      for q in range(R)]
    if red == "tmr":
        # the upset replica's counter climbed, then stopped climbing
        upset = [d[slot][r] for d in got[1]]
        assert upset[INJECT_AT] > 0 and upset[-1] == upset[-2]
        assert sum(map(sum, got[1][-1])) == upset[-1]
    else:
        # the unprotected chip served wrong scores until the heal
        golden = _golden(port_chips[slot], X[slot * N_EV:(slot + 1) * N_EV])
        seqs = sorted(q for q in got[0] if got[0][q][0] == slot)
        scores = np.array([got[0][q][1] for q in seqs]).reshape(N_STEPS, -1)
        assert not np.array_equal(scores[INJECT_AT], golden)
        assert np.array_equal(scores[-1], golden)
    jax_srv, port_srv = want[5], got[5]
    for s in range(2):
        for q in range(R):
            img = port_srv.readback_frame(s, q)
            assert img.dtype == np.uint8
            np.testing.assert_array_equal(img, jax_srv.readback_frame(s, q))
            assert table_digest(img) == jax_digest(img)
            assert (port_srv._golden.digest(s, q)
                    == jax_srv._golden.digest(s, q))


@pytest.mark.parametrize("red", ["tmr", "none"])
def test_host_backend_scrub_matches_jax(duo, red):
    """The host backend verifies in place; the same loop as above."""
    jax_chips, port_chips, X, flips = duo
    kw = dict(backend="host", redundancy=red, scrub_mode="steered")
    want = _scrub_run("jax", jax_chips, X, flips, **kw)
    got = _scrub_run("port", port_chips, X, flips, **kw)
    assert got[:4] == want[:4]
    assert got[4]["scrub"] == want[4]["scrub"]
    assert got[4]["scrub"]["detections"] == 1


@pytest.mark.parametrize("layout,band", [
    ("bitsliced", None), ("matmul", None), ("matmul", False)])
@pytest.mark.parametrize("red", ["tmr", "none"])
def test_stack_readback_equals_golden_image_and_jax(duo, layout, band, red):
    """readback_replica is core.fabric.packed_table_image of each replica
    config byte for byte, equal to the JAX stack's readback, so one golden
    digest verifies both packages."""
    jax_chips, port_chips, _, _ = duo
    stack = lut_ops.pack_fabrics([c.config for c in port_chips], band=band,
                                 redundancy=red, layout=layout, device="cpu")
    jstack = jax_ops.pack_fabrics([c.config for c in jax_chips], band=band,
                                  redundancy=red, layout=layout)
    for slot, chip in enumerate(port_chips):
        imgs = replica_table_images(chip.config, stack.n_levels, stack.m_pad,
                                    stack.n_replicas)
        rb = stack.readback_chip(slot)
        assert rb.dtype == np.uint8 and rb.shape == (
            stack.n_replicas, stack.n_levels, stack.m_pad, 16)
        np.testing.assert_array_equal(rb, jstack.readback_chip(slot))
        for r in range(stack.n_replicas):
            np.testing.assert_array_equal(rb[r], imgs[r])
            assert table_digest(rb[r]) == jax_digest(
                jstack.readback_replica(slot, r))
    with pytest.raises(ValueError, match="slot"):
        stack.readback_replica(2, 0)
    with pytest.raises(ValueError, match="replica"):
        stack.readback_replica(0, stack.n_replicas)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_swap_replica_validates_like_jax(duo):
    """Replica range first, then the envelope, then the IO widths, with
    the reference's error texts."""
    from tests._torch_helpers import chip_pair

    duo_pairs = list(zip(duo[0], duo[1]))
    deep = chip_pair("efpga_28nm")      # 11 levels: outside the envelope
    wide = chip_pair("efpga_130nm")     # 112 inputs against the duo's 84

    def stacks(pairs):
        return (lut_ops.pack_fabrics([p[1].config for p in pairs],
                                     redundancy="tmr", layout="bitsliced",
                                     device="cpu"),
                jax_ops.pack_fabrics([p[0].config for p in pairs],
                                     redundancy="tmr", layout="bitsliced"))

    narrow, wider = stacks(duo_pairs), stacks([duo_pairs[0], wide])
    for word, (stack, jstack), replica, (jc, pc) in (
            ("replica", narrow, 3, duo_pairs[0]),
            ("replica", narrow, -1, duo_pairs[0]),
            ("replica", narrow, 3, deep),
            ("envelope", narrow, 1, deep),
            ("IO widths", wider, 1, wide)):
        msg = _error(lambda: stack.swap_replica(0, replica, pc.config))
        assert word in msg
        assert msg == _error(lambda: jstack.swap_replica(0, replica,
                                                         jc.config))


@pytest.mark.parametrize("layout", ["bitsliced", "matmul"])
def test_swap_replica_takes_effect_at_the_next_dispatch(duo, layout):
    """A swapped replica row is what the next scoring pass evaluates (the
    routing pass rebuilds from the stack's tensors at every launch): its
    disagreement count climbs, the voted scores stay the oracle's, and
    the old stack, still held, serves the old tables."""
    _, port_chips, X, flips = duo
    li, bi = flips[1]
    chips = port_chips
    stack = lut_ops.pack_fabrics([c.config for c in chips], redundancy="tmr",
                                 layout=layout, device="cpu")
    bits = [c.encode_features(X[i * N_EV:(i + 1) * N_EV])
            for i, c in enumerate(chips)]
    stacked = lut_ops.stack_input_bits(stack, bits)
    weight = lut_ops.decode_plan([c.config for c in chips], stack.n_outputs)
    thr = np.array([c.score_threshold_raw for c in chips], np.int32)

    def scored(st):
        s, k, d = lut_ops.fabric_eval_multi_scored(st, stacked, weight, thr)
        return np.asarray(s), np.asarray(k), np.asarray(d)

    before = scored(stack)
    bad = inject_seu(replicate_config(chips[1].config, 2),
                     replica_lut_index(chips[1].config, 2, li), bi)
    swapped = stack.swap_replica(1, 2, bad)
    after = scored(swapped)
    assert before[2].sum() == 0
    assert after[2][1, 2] > 0 and after[2][1, :2].sum() == 0
    assert after[2][0].sum() == 0
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(
        swapped.readback_replica(1, 2),
        packed_table_image(bad, stack.n_levels, stack.m_pad))
    np.testing.assert_array_equal(scored(stack)[2], before[2])
    healed = swapped.swap_replica(1, 2, replicate_config(chips[1].config, 2))
    np.testing.assert_array_equal(scored(healed)[2], before[2])


def test_scrub_heals_the_fused_frames_path(duo):
    """After an inject and after the heal the fused frontend holds the
    server's current stack: frames score as before the fault throughout,
    and the upset replica's counter stops climbing after the heal."""
    from tests._torch_helpers import frames

    _, port_chips, _, _ = duo
    fr, y0 = frames(32)
    server = ReadoutServer([port_chips[0]], ServerConfig(
        max_batch=32, max_latency_s=1e9, redundancy="tmr",
        scrub_interval=1, pipeline_depth=1), device="cpu")

    def scores():
        server.submit_frames(0, fr, y0)
        return [r.score_raw for r in sorted(server.flush(),
                                            key=lambda r: r.seq)]

    want = scores()
    server.inject_seu(0, 2, 1, 9)
    assert server._path.frontend.stack is server._path.stack
    assert not server.verify_frame(0, 2)
    for _ in range(6):
        assert scores() == want
        if server.report()["scrub"]["detections"]:
            break
    assert server.report()["scrub"]["detections"] == 1
    assert server._path.frontend.stack is server._path.stack
    assert all(server.verify_frame(0, r) for r in range(3))
    base = server.report()["per_chip"][0]["seu_disagreements"]
    assert scores() == want
    assert server.report()["per_chip"][0]["seu_disagreements"] == base


@pytest.mark.parametrize("backend", ["kernel", "host"])
def test_reconfigure_refreshes_golden_store_like_jax(duo, backend):
    """After a hot swap the slot's golden truth is the new bitstream: a
    full scrub cycle finds nothing, and a later upset heals to the new
    configuration, record for record as in the JAX server."""
    jax_chips, port_chips, X, _ = duo
    runs = []
    for pkg, chips in (("jax", jax_chips), ("port", port_chips)):
        server = _server(pkg, [chips[0]], backend=backend, max_batch=N_EV,
                         max_latency_s=1e9, redundancy="tmr",
                         scrub_interval=1, pipeline_depth=1)
        server.submit_batch(0, X[:N_EV])
        server.flush()
        server.reconfigure(0, chips[1])
        clean = server.scrub_cycle()
        server.inject_seu(0, 1, 0, 4)
        healed = server.scrub_cycle()
        server.submit_batch(0, X[N_EV:])
        out = [(r.seq, r.score_raw, r.keep) for r in server.flush()]
        runs.append((clean, healed, out, server.report()["scrub"]))
    assert runs[0] == runs[1]
    assert runs[1][0] == [] and len(runs[1][1]) == 1
    assert runs[1][1][0]["healed_bits"] == 1


@pytest.mark.parametrize("hot", [0, 4])
def test_steering_never_starves_a_frame_like_jax(duo, hot):
    """However hard steering pulls toward one frame, one full cycle of
    scrub steps samples every frame; the per-frame counts equal JAX's."""
    jax_chips, port_chips, _, _ = duo
    reps = []
    for pkg, chips in (("jax", jax_chips), ("port", port_chips)):
        server = _server(pkg, chips, backend="host", max_batch=16,
                         max_latency_s=1e9, redundancy="tmr",
                         scrub_interval=1)
        rng = np.random.default_rng(hot)
        for _ in range(6):
            server._stats[hot // 3].disagreements[hot % 3] += int(
                rng.integers(1, 50))
            server.scrub_step()
        reps.append(server.report()["scrub"])
    assert reps[0] == reps[1]
    assert reps[1]["cycles"] == 1 and min(reps[1]["per_frame_scrubs"]) >= 1


def test_scrub_runs_every_interval_dispatches():
    """interval=k: one scrub step every k dispatches, from the loop."""
    from tests._torch_helpers import chip_pair

    chip = chip_pair("efpga_130nm")[1]
    X = np.zeros((16, 14))
    server = ReadoutServer([chip], ServerConfig(
        max_batch=16, max_latency_s=1e9, redundancy="tmr",
        scrub_interval=3, pipeline_depth=1), device="cpu")
    for _ in range(7):
        server.submit_batch(0, X)
        server.flush()
    rep = server.report()["scrub"]
    assert rep["enabled"] and rep["interval"] == 3 and rep["steps"] == 2
    assert rep["cycles"] == 0 and rep["frames_scrubbed"] == 2
