"""The readout chip axis split over a device plan (launch.mesh.ReadoutMesh)
against one slab and against the JAX package, on the CPU.

A plan may name one device several times; its slabs then share it. That
is the stand-in, here, for the reference's forced host devices: a
server rebound to ``ReadoutMesh((cpu,) * k)`` runs k slabs of 4/k chips,
each with its own stack rows, encode-plan rows and staging buffers and
its own dispatch (the kernels' plain twins), and merges their results on
the host at its drain. Four chips trained identically by both packages
serve a seeded FrameStream (3 batches of 32 events a chip) on frozen
clocks. Stated tolerance: exact. Every ``ScoredEvent`` of the split
server equals the one-slab port's, and the JAX server's (``backend=
"host"``) on every event but those whose quantized features differ
between the two featurizers (summation order, test_torch_yprofile.py);
the features path equals the JAX server's on every event. The JAX side
and the one-slab runs are module fixtures, outside the 20 s budget.
"""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels.lut_eval import ops as jax_ops  # noqa: E402
from repro.launch.fleet import TenantFleet as JaxFleet  # noqa: E402
from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch.core.fabric import FabricSim  # noqa: E402
from repro_torch.core.quantize import quantize_raw  # noqa: E402
from repro_torch.core.tmr import inject_seu, replica_lut_index  # noqa: E402
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import frontend as port_fe  # noqa: E402
from repro_torch.kernels.lut_eval import ops as port_ops  # noqa: E402
from repro_torch.kernels.yprofile import ops as port_yp  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.fleet import TenantFleet  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from repro_torch.train.elastic import reshard_replicated  # noqa: E402
from tests._torch_helpers import chip_pair, jax_features  # noqa: E402

CPU = torch.device("cpu")
N_CHIPS, N_STEPS, N_EV = 4, 3, 32
# the kernel a served stack's fabric pass launches, by its layout
FABRIC = {"bitsliced": "eval_words_voted", "banded": "lut_eval_banded",
          "dense": "lut_eval"}


def plan(k: int) -> port_mesh.ReadoutMesh:
    return port_mesh.ReadoutMesh((CPU,) * k)


@functools.lru_cache(maxsize=None)
def _farm():
    """(JAX chips, port chips, a swap pair, blocks[step][sensor], JAX
    features[step][sensor] of those frames)."""
    pairs = [chip_pair(f, seed) for f, seed in (
        ("efpga_28nm", 5), ("efpga_130nm", 5), ("efpga_130nm", 6),
        ("efpga_28nm", 6))]
    fs = FrameStream(FrameStreamConfig(n_sensors=N_CHIPS, batch=N_EV,
                                       seed=11))
    blocks = [[fs.batch_at(step, s) for s in range(N_CHIPS)]
              for step in range(N_STEPS)]
    feats = [[jax_features(b["frames"], b["y0"]).astype(np.float64)
              for b in per] for per in blocks]
    return ([p[0] for p in pairs], [p[1] for p in pairs],
            chip_pair("efpga_130nm", 7), blocks, feats)


@pytest.fixture(scope="module")
def farm():
    return _farm()


def _flips(port_chips, blocks):
    """seqs of frame events whose quantized used features differ between
    the port's and the JAX featurizer, numbered as ``_serve`` submits."""
    out, seq = set(), 0
    for per in blocks:
        for s, blk in enumerate(per):
            chip = port_chips[s]
            used = list(chip.synth.used_features)
            a = port_yp.yprofile(blk["frames"], blk["y0"],
                                 device="cpu").numpy()[:, used]
            b = jax_features(blk["frames"], blk["y0"])[:, used]
            d = (quantize_raw(a, chip.golden.spec)
                 != quantize_raw(b, chip.golden.spec)).any(-1)
            out |= {seq + i for i in np.flatnonzero(d)}
            seq += len(d)
    return out


def _serve(server, blocks, feats, ingest, before=None):
    """Every step's sensor blocks (raw frames, or their JAX features
    through submit_batch), a poll after each, ``before(step)`` first
    (its results kept); then a flush. Returns ({seq: (chip, score,
    keep)}, report)."""
    out = []
    for step in range(N_STEPS):
        if before is not None:
            out += before(step) or []
        for s in range(N_CHIPS):
            if ingest == "frames":
                blk = blocks[step][s]
                server.submit_frames(s, blk["frames"], blk["y0"])
            else:
                server.submit_batch(s, feats[step][s])
            out += server.poll()
    out += server.flush()
    return {r.seq: (r.chip, r.score_raw, r.keep) for r in out}, \
        server.report()


def _cfg(cls, **kw):
    return cls(**{"max_batch": 128, "max_latency_s": 1e9, **kw})


def _port(chips, k=1, **kw):
    server = ReadoutServer(chips, _cfg(ServerConfig, **kw),
                           clock=lambda: 0.0, device="cpu")
    if k > 1:
        assert server.rebind_mesh(plan(k)) == []
    return server


@functools.lru_cache(maxsize=None)
def _jax_run(red, sparse, ingest):
    jc, _, _, blocks, feats = _farm()
    server = JaxServer(jc, _cfg(JaxConfig, backend="host", redundancy=red,
                                sparse=sparse), clock=lambda: 0.0)
    return _serve(server, blocks, feats, ingest)


CASES = [(layout, red, sparse, ingest)
         for layout in ("bitsliced", "matmul") for red in ("none", "tmr")
         for sparse in (False, True) for ingest in ("frames", "features")]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "-".join(map(str, c)))
def case(request, farm):
    """A (layout, redundancy, sparse, ingest) case, the JAX server's run
    of it and the one-slab port's."""
    layout, red, sparse, ingest = request.param
    _, pc, _, blocks, feats = farm
    one = _serve(_port(pc, layout=layout, redundancy=red, sparse=sparse),
                 blocks, feats, ingest)
    return request.param, _jax_run(red, sparse, ingest), one


@pytest.mark.parametrize("k", [2, 4])
def test_split_server_equals_one_slab_and_jax(farm, case, k):
    (layout, red, sparse, ingest), (want, jrep), (one, orep) = case
    _, pc, _, blocks, feats = farm
    server = _port(pc, k, layout=layout, redundancy=red, sparse=sparse)
    assert [s["chips"] for s in server.report()["slabs"]] == [
        [i * N_CHIPS // k, (i + 1) * N_CHIPS // k] for i in range(k)]
    got, rep = _serve(server, blocks, feats, ingest)
    # every slab dispatched on its own: the fabric pass at 4/k chips (the
    # matmul layout evaluates a row a replica)
    rows = N_CHIPS // k * (server.n_replicas if layout == "matmul" else 1)
    assert any(sig[0] == rows
               for sig in build._SIGNATURES[FABRIC[server._path.stack.layout]])
    assert got == one
    n_all = N_STEPS * N_CHIPS * N_EV
    if sparse:
        assert all(v[2] for v in got.values()) and 0 < len(got) < n_all
    else:
        assert sorted(got) == list(range(n_all))
    diff = {q for q in set(got) | set(want) if got.get(q) != want.get(q)}
    if ingest == "features":
        assert not diff
    else:
        flips = _flips(pc, blocks)
        assert diff <= flips and len(flips) <= 0.01 * n_all
    for key in ("n_in", "n_kept", "link_bytes", "seu_disagreement_total"):
        assert rep[key] == orep[key], key
    assert rep["n_in"] == jrep["n_in"] and (
        rep["link_bytes"]["on_wire"] == jrep["link_bytes"]["on_wire"])
    assert [c["n_in"] for c in rep["per_chip"]] == [
        c["n_in"] for c in jrep["per_chip"]]


def _effective_flip(chip, X):
    """(lut, bit) in base coordinates whose flip changes ``chip``'s
    outputs on ``X``."""
    bits = chip.encode_features(X)
    good = np.asarray(FabricSim(chip.config).run(bits)[0])
    for li in range(chip.config.n_luts):
        for bi in range(16):
            outs = np.asarray(FabricSim(
                inject_seu(chip.config, li, bi)).run(bits)[0])
            if (outs != good).any():
                return li, bi
    raise AssertionError("no effective flip found")


def _blocking(server):
    server._result_ready = lambda x: (jax.block_until_ready(x), True)[1]
    return server


def _upset_run(chips, feats, flip, server):
    """TMR, scrub_interval=1, a flush each step: before step 1 the last
    chip's last replica takes the upset ``flip``. Returns (events,
    disagreement counters after each step, the scrub report, every
    frame's verify at the end)."""
    R, slot = server.n_replicas, N_CHIPS - 1
    out, dis = [], []
    for step in range(N_STEPS):
        if step == 1:
            li, bi = flip
            server.inject_seu(slot, R - 1, replica_lut_index(
                chips[slot].config, R - 1, li), bi)
            assert not server.verify_frame(slot, R - 1)
        for s in range(N_CHIPS):
            server.submit_batch(s, feats[step][s])
        out += server.flush()
        dis.append([c["seu_disagreements"]
                    for c in server.report()["per_chip"]])
    return ({r.seq: (r.chip, r.score_raw, r.keep) for r in out}, dis,
            server.report()["scrub"],
            [server.verify_frame(s, q) for s in range(N_CHIPS)
             for q in range(R)])


@pytest.fixture(scope="module")
def upset(farm):
    """The flip, and the JAX server's and the one-slab port's runs of
    the upset stream in both layouts."""
    jc, pc, _, _, feats = farm
    flip = _effective_flip(pc[-1], feats[1][-1])
    kw = dict(redundancy="tmr", scrub_interval=1, pipeline_depth=1)
    jax_run = _upset_run(jc, feats, flip, _blocking(JaxServer(
        jc, _cfg(JaxConfig, backend="host", **kw), clock=lambda: 0.0)))
    ones = {layout: _upset_run(pc, feats, flip,
                               _port(pc, layout=layout, **kw))
            for layout in ("bitsliced", "matmul")}
    return flip, jax_run, ones


@pytest.mark.parametrize("layout", ["bitsliced", "matmul"])
@pytest.mark.parametrize("k", [2, 4])
def test_upset_on_the_last_slab_is_scrubbed_and_healed(farm, upset, k,
                                                       layout):
    """inject_seu on a chip of the last slab: the TMR vote masks it, the
    scrub (steered by the slab's counters) reads the frame back from
    that slab, detects it once and heals its one bit, as on one slab and
    in the JAX server."""
    _, pc, _, _, feats = farm
    flip, want, ones = upset
    server = _port(pc, k, layout=layout, redundancy="tmr",
                   scrub_interval=1, pipeline_depth=1)
    got = _upset_run(pc, feats, flip, server)
    assert got == ones[layout]
    # the JAX host backend verifies a readback at once, the kernel
    # backends a step later: the events and the end state agree
    assert got[0] == want[0] and got[3] == want[3]
    assert got[2]["detections"] == want[2]["detections"] == 1
    assert got[2]["healed_bits"] == want[2]["healed_bits"] == 1
    assert got[1][1][N_CHIPS - 1][-1] > 0 and all(got[3])


@pytest.mark.parametrize("k", [2, 4])
def test_hot_swap_and_threshold_on_the_last_slab(farm, k):
    """A hot swap of the last chip mid-stream (frames and features) on a
    split server equals the one-slab port's and the JAX server's; the
    frontend's ``set_threshold`` and ``swap_chip`` on the last chip write
    that slab's rows only, and score as the one-slab frontend does."""
    jc, pc, swap, blocks, feats = farm
    last = N_CHIPS - 1

    def swapping(server, chip):
        return lambda step: (server.reconfigure(last, chip)
                             if step == 1 else [])

    runs = []
    for k_, chips, chip in ((1, pc, swap[1]), (k, pc, swap[1])):
        server = _port(chips, k_)
        runs.append(_serve(server, blocks, feats, "features",
                           before=swapping(server, chip))[0])
    jserver = JaxServer(jc, _cfg(JaxConfig, backend="host"),
                        clock=lambda: 0.0)
    want = _serve(jserver, blocks, feats, "features",
                  before=swapping(jserver, swap[0]))[0]
    assert runs[1] == runs[0] == want

    specs = [c.frontend_spec() for c in pc]
    one = port_fe.pack_frontend([c.config for c in pc], specs,
                                layout="bitsliced", device="cpu")
    split = port_fe.pack_frontend([c.config for c in pc], specs,
                                  layout="bitsliced", device="cpu",
                                  mesh=plan(k))
    assert isinstance(split, port_fe.SlabFrontend)
    assert len(split.slabs) == k and split.n_chips == N_CHIPS
    before = [f.plan for f in split.slabs]
    thr = specs[last].threshold_raw + 3
    one, split = one.set_threshold(last, thr), split.set_threshold(last, thr)
    assert all(f.plan is p for f, p in zip(split.slabs[:-1], before))
    assert int(split.slabs[-1].plan["threshold_raw"][-1]) == thr
    one = one.swap_chip(last, swap[1].config, swap[1].frontend_spec())
    split = split.swap_chip(last, swap[1].config, swap[1].frontend_spec())
    assert all(f.plan is p for f, p in zip(split.slabs[:-1], before))
    fr = np.stack([b["frames"] for b in blocks[0]])
    y0 = np.stack([b["y0"] for b in blocks[0]])
    for a, b in zip(one.score_frames_voted(fr, y0),
                    split.score_frames_voted(fr, y0)):
        assert torch.equal(a, b)
    for a, b in zip(one.score_frames_sparse(fr, y0),
                    split.score_frames_sparse(fr, y0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("layout", ["bitsliced", "matmul"])
def test_rebind_one_two_four_one_mid_stream_loses_nothing(farm, layout,
                                                          sparse):
    """Rebinding 1 -> 2 -> 4 -> 1 slabs between the stream's steps (frames
    and features mixed in each) flushes what is pending each time and
    serves the rest on the new plan: the events equal a server that was
    never rebound. The plan of four shares no chip range with the plan
    of two, so its slabs are cut from the two-slab stack."""
    _, pc, _, blocks, feats = farm
    kw = dict(layout=layout, sparse=sparse, redundancy="tmr")

    def both(server, before=None):
        out = []
        for step in range(N_STEPS + 1):
            if before is not None:
                out += before(step)
            for s in range(N_CHIPS):
                blk = blocks[step % N_STEPS][s]
                server.submit_frames(s, blk["frames"][:8], blk["y0"][:8])
                server.submit_batch(s, feats[step % N_STEPS][s][:24])
                out += server.poll()
        out += server.flush()
        return {r.seq: (r.chip, r.score_raw, r.keep) for r in out}

    want = both(_port(pc, **kw))
    server = _port(pc, **kw)
    sizes = []

    def rebind(step):
        done = server.rebind_mesh(plan((1, 2, 4, 1)[step]))
        sizes.append(len(server.report()["slabs"]))
        assert server.queue_depth == 0
        return done

    got = both(server, rebind)
    assert sizes == [1, 2, 4, 1]
    assert got == want
    assert sorted(got) == sorted(want) and len(got) > 0
    assert isinstance(server._path.stack, port_ops.PackedFabricStack)


def test_a_plan_that_does_not_divide_the_chips_raises(farm):
    _, pc, _, _, feats = farm
    with pytest.raises(ValueError, match="3 devices does not split 4"):
        plan(3).slabs(4)
    with pytest.raises(ValueError, match="does not split"):
        plan(2).slabs(3)
    assert plan(2).slabs(4) == [(CPU, 0, 2), (CPU, 2, 2)]
    server = _port(pc)
    server.submit_batch(0, feats[0][0][:5])
    stack = server._path.stack
    with pytest.raises(ValueError, match="does not split"):
        server.rebind_mesh(plan(3))
    assert server.queue_depth == 5 and server._path.stack is stack
    with pytest.raises(ValueError, match="chips"):
        port_ops.place_stack(stack, plan(2).slabs(6))
    assert len(server.flush()) == 5


@pytest.mark.parametrize("red", ["none", "tmr"])
@pytest.mark.parametrize("k", [2, 4])
def test_split_sparse_merge_equals_one_slab_b6(farm, k, red):
    """The split stack's sparse dispatch (each slab's B6 twin, its
    indices restrided for Bp != B, offset by the slab's first chip x B,
    concatenated) equals the one-slab B6 twin's (count, idx, vals, dis)
    element for element; the dense one its (score, keep, dis). The
    slabs are views of the one-slab stack's rows (nothing copied), and
    the one-slab plan gives the stack back as it is."""
    _, pc, _, _, feats = farm
    configs = [c.config for c in pc]
    stack = port_ops.pack_fabrics(configs, redundancy=red,
                                  layout="bitsliced", device="cpu")
    split = port_ops.place_stack(stack, plan(k).slabs(N_CHIPS))
    assert port_ops.place_stack(stack, plan(1).slabs(N_CHIPS)) is stack
    joined = port_ops.place_stack(split, plan(1).slabs(N_CHIPS))
    for key in ("tables", "output_nets", "src"):
        assert torch.equal(getattr(joined, key), getattr(stack, key)), key
    R, per = stack.n_replicas, N_CHIPS // k
    for s, slab in enumerate(split.slabs):
        assert slab.tables.data_ptr() == stack.tables[s * per * R].data_ptr()
        assert slab.n_inputs_each == stack.n_inputs_each[s * per:
                                                         (s + 1) * per]
    B = 24                      # pads to Bp = 128
    bits = port_ops.stack_input_bits(split, [
        c.encode_features(feats[0][i][:B]) for i, c in enumerate(pc)])
    valid = np.ones((N_CHIPS, B), bool)
    valid[1, 20:] = False
    args = (bits, port_ops.decode_plan(configs, stack.n_outputs),
            np.array([c.score_threshold_raw for c in pc], np.int32), valid)
    want = port_ops.fabric_eval_multi_scored_sparse(stack, *args)
    got = port_ops.fabric_eval_multi_scored_sparse(split, *args)
    assert got[1].shape == (N_CHIPS * B,) and int(got[0]) > 0
    for a, b in zip(got, want):
        assert torch.equal(a.to(b.dtype), b)
    for a, b in zip(port_ops.fabric_eval_multi_scored(split, *args),
                    port_ops.fabric_eval_multi_scored(stack, *args)):
        assert torch.equal(a, b)
    assert split.readback_chip(N_CHIPS - 1).tobytes() == \
        stack.readback_chip(N_CHIPS - 1).tobytes()


def test_fleet_replans_buckets_over_four_devices_like_jax(farm,
                                                          monkeypatch):
    """A fleet over four devices (``local_devices`` gives four CPU
    entries): its first bucket serves on four slabs, a second bucket's
    grow re-plans both onto two each, and a shrink gives the survivor its
    four back. Every admit, every event and the tenants' ledgers equal
    the JAX fleet's."""
    jc, pc, _, _, feats = farm
    monkeypatch.setattr(port_mesh, "local_devices",
                        lambda device=None: [CPU] * 4)
    envs = [jax_ops.bucket_envelope(c.config) for c in jc]
    other = next(i for i in range(1, N_CHIPS) if envs[i] != envs[0])
    kw = dict(max_batch=64, max_latency_s=1e9)
    fleets = (JaxFleet(JaxConfig(backend="host", **kw), clock=lambda: 0.0,
                       bucket_slots=4),
              TenantFleet(ServerConfig(**kw), clock=lambda: 0.0,
                          bucket_slots=4, device="cpu"))
    chips = (jc, pc)
    # a re-plan flushes the moved buckets early (the JAX fleet's host
    # backend does not re-plan), so results are compared all together
    results = ([], [])

    def each(fn):
        got = [fn(f, c) for f, c in zip(fleets, chips)]
        assert got[1] == got[0]
        return got[1]

    def drain(name):
        for f, out in zip(fleets, results):
            out += [dataclasses.astuple(r) for r in getattr(f, name)()]

    def slabs():
        return [len(b["devices"]) for b in fleets[1].report()["buckets"]]

    each(lambda f, c: f.admit("a", c[0]))
    assert slabs() == [4]
    each(lambda f, c: f.submit_batch("a", feats[0][0]))
    drain("poll")
    each(lambda f, c: f.admit("b", c[other]))
    assert slabs() == [2, 2]
    for step in range(2):
        each(lambda f, c: f.submit_batch("a", feats[step][1]))
        each(lambda f, c: f.submit_batch("b", feats[step][2]))
        drain("poll")
    each(lambda f, c: f.evict("b"))
    assert each(lambda f, c: f.shrink()) == 1
    assert slabs() == [4]
    each(lambda f, c: f.submit_batch("a", feats[2][3]))
    drain("flush")
    assert sorted(results[1]) == sorted(results[0])
    assert len(results[1]) == 6 * N_EV
    want, got = fleets[0].report(), fleets[1].report()
    assert got["tenants"] == want["tenants"]
    assert got["admission_misses"] == 0


def test_miss_counts_after_a_move(farm):
    """A move is counted once: the first dispatch after a rebind to
    another plan launches at the new slabs' shapes (new signatures) at a
    batch width the server had launched, one ``shape_misses``; the next
    dispatch adds nothing, and going back to a plan served before adds
    no signature at all."""
    _, pc, _, _, feats = farm
    # 150 events a chip: a batch width no other test here launches
    server = _port(pc, max_batch=1024)
    X = [np.concatenate([feats[t][s] for t in range(N_STEPS)] * 2)[:150]
         for s in range(N_CHIPS)]

    def dispatch():
        for s in range(N_CHIPS):
            server.submit_batch(s, X[s])
        return len(server.flush())

    assert dispatch() == N_CHIPS * 150
    server.rebind_mesh(plan(2))
    before = build.miss_counts()
    dispatch()
    assert build.miss_counts()[1] > before[1]
    assert server.shape_misses == 1
    mark = build.miss_counts()
    dispatch()
    server.rebind_mesh(plan(1))
    dispatch()
    assert build.miss_counts() == mark and server.shape_misses == 1
    # a signature names its device: the same shapes on another device
    # are a new one
    sig = next(iter(build._SIGNATURES["eval_words_voted"]))
    assert sig[-1] == "cpu"


def test_reshard_replicated_places_stacks_and_frontends(farm):
    """``reshard_replicated`` gives a stack and a fused frontend the
    plan's slabs (rows already there not copied), other tensors the
    plan's first device."""
    _, pc, _, _, _ = farm
    specs = [c.frontend_spec() for c in pc]
    fe = port_fe.pack_frontend([c.config for c in pc], specs,
                               redundancy="tmr", device="cpu")
    moved = reshard_replicated({"fe": fe, "stack": fe.stack,
                                "x": torch.ones(3)}, plan(2))
    assert isinstance(moved["stack"], port_ops.SlabStack)
    assert isinstance(moved["fe"], port_fe.SlabFrontend)
    assert [f.n_chips for f in moved["fe"].slabs] == [2, 2]
    assert moved["fe"].slabs[1].plan["feat_idx"].shape[0] == 2
    assert moved["stack"].slabs[0].tables.data_ptr() == \
        fe.stack.tables.data_ptr()
    assert moved["x"].device == CPU
    back = reshard_replicated(moved["fe"], plan(1))
    for k, v in fe.plan.items():
        assert torch.equal(back.plan[k], v), k
