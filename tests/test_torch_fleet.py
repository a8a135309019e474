"""The port's multi-tenant fleet (repro_torch/launch/fleet.py) against the
JAX package's, and the geometry pool, device plans and server hooks
beneath it.

Both fleets take the same calls on the farm of tests/test_fleet.py (four
chips trained identically by both packages, two of them sharing a
geometry bucket) on frozen ``FakeClock``s: the port's on ``device="cpu"``
with its host and its kernel backend (each kernel's plain twin on the
CPU), the JAX fleet on ``backend="host"``. Stated tolerance: exact. Every
admit returns the same info, every poll and flush the same
``TenantScoredEvent``s (seq, tenant, score, keep), and every
``report()["tenants"]`` ledger is the same. Each of the reference's
fleet tests has its counterpart here; the warm-admission one counts nvcc
builds, library loads and launch signatures (kernels/build.py
``miss_counts``) in place of the jit cache size, and checks that the
stack's tensors were written in place.
"""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core.bitstream import GoldenImageStore as JaxStore  # noqa: E402
from repro.core.bitstream import GoldenSlotError as JaxSlotError  # noqa: E402
from repro.core.tmr import replica_table_images as jax_images  # noqa: E402
from repro.data.smartpixel import SmartPixelConfig as JaxSPC  # noqa: E402
from repro.data.smartpixel import generate as jax_generate  # noqa: E402
from repro.data.smartpixel import train_test_split as jax_split  # noqa: E402
from repro.kernels.lut_eval import ops as jax_ops  # noqa: E402
from repro.launch.fleet import TenantFleet as JaxFleet  # noqa: E402
from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.bitstream import (  # noqa: E402
    BitstreamError, GoldenImageStore, GoldenSlotError)
from repro_torch.core.tmr import replica_table_images  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.lut_eval import ops as port_ops  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.fleet import TenantFleet, UnknownTenantError  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from repro_torch.train.elastic import reshard_replicated  # noqa: E402
from tests._propshim import given, settings, strategies as st  # noqa: E402
from tests._torch_helpers import chip_pair, frames  # noqa: E402

# tests/test_fleet.py's farm: (depth, leaves) of its four chips
FARM = ((5, 10), (4, 8), (4, 12), (3, 5))
BACKENDS = ("host", "kernel")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@functools.lru_cache(maxsize=None)
def _get_farm():
    """(JAX chips, port chips, test features): memoized so the property
    sweep (which cannot take fixtures) shares the fixture's build."""
    pairs = [chip_pair("efpga_28nm", 5, d, lv) for d, lv in FARM]
    _, te = jax_split(jax_generate(JaxSPC(n_events=12_000, seed=5)))
    return ([p[0] for p in pairs], [p[1] for p in pairs],
            np.asarray(te["features"]))


@pytest.fixture(scope="module")
def farm():
    return _get_farm()


def _same_env_pair(chips):
    """Indices of two chips sharing a geometry bucket (else one twice),
    as the reference's test picks them."""
    envs = [jax_ops.bucket_envelope(c.config) for c in chips]
    for i in range(len(chips)):
        for j in range(i + 1, len(chips)):
            if envs[i] == envs[j]:
                return i, j
    return 1, 1


def _cfg(cls, backend, **kw):
    base = dict(max_batch=512, max_latency_s=1e9, backend=backend,
                batch_tile=128)
    base.update(kw)
    return cls(**base)


def _norm(x):
    """Results of either fleet as plain values (events as tuples)."""
    if isinstance(x, list):
        return [_norm(v) for v in x]
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    return x


class Fleets:
    """One JAX fleet (host backend) and one port fleet (``backend``, on
    the CPU); every call goes to both and must return the same."""

    def __init__(self, farm, backend, bucket_slots, **kw):
        self.jc, self.pc, self.X = farm
        self.clocks = (FakeClock(), FakeClock())
        self.jax = JaxFleet(_cfg(JaxConfig, "host", **kw),
                            clock=self.clocks[0], bucket_slots=bucket_slots)
        self.port = TenantFleet(_cfg(ServerConfig, backend, **kw),
                                clock=self.clocks[1],
                                bucket_slots=bucket_slots, device="cpu")

    def call(self, name, *args, **kw):
        """``flush`` results compare in seq order: on the kernel backend
        a new bucket re-plans the devices, and the rebind flushes the
        other buckets early (the JAX fleet's host backend skips the
        re-plan), so their events reach the ready queue in another
        order."""
        got = [_norm(getattr(f, name)(*args, **kw))
               for f in (self.jax, self.port)]
        if name == "flush":
            got = [sorted(g) for g in got]
        assert got[1] == got[0], name
        return got[1]

    def admit(self, tenant, i):
        want = self.jax.admit(tenant, self.jc[i])
        got = self.port.admit(tenant, self.pc[i])
        assert got == want, tenant
        return got

    def advance(self, dt):
        for clock in self.clocks:
            clock.advance(dt)

    def ledgers(self):
        want, got = self.jax.report(), self.port.report()
        assert got["tenants"] == want["tenants"]
        for k in ("n_buckets", "n_tenants", "n_resident", "n_evicted",
                  "events_in", "events_out", "shed", "quota_shed",
                  "evicted_while_queued"):
            assert got[k] == want[k], k
        return got


def _oracle(chip, rows):
    raw = chip.infer_raw(np.asarray(rows), backend="host")
    return raw, raw <= chip.score_threshold_raw


# ----------------------------------------------------- (a) warm admission
@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_admission_no_build_or_signature_miss_zero_incumbent_drops(
        farm, backend):
    """A new tenant admits into a warm bucket mid-stream: no nvcc build,
    no library load, no new launch signature, the stack's tensors written
    in place, and every incumbent event admitted before it delivered,
    as the JAX fleet delivers it."""
    jc, pc, X = farm
    a, b = _same_env_pair(jc)
    f = Fleets(farm, backend, bucket_slots=2)
    assert f.admit("pix", a)["cold"] is True
    seqs = f.call("submit_batch", "pix", X[:16])
    assert all(s is not None for s in seqs)
    f.call("flush")

    misses = build.miss_counts()
    srv = f.port._buckets[0].server
    ptrs = ([t.data_ptr() for t in (srv._path.stack.src,
                                    srv._path.stack.tables,
                                    srv._path.stack.output_nets)]
            if backend == "kernel" else None)
    pending = f.call("submit_batch", "pix", X[16:32])
    info = f.admit("neu", b)
    assert info["cold"] is False
    more = f.call("submit_batch", "neu", X[32:48])
    res = f.call("flush")
    assert build.miss_counts() == misses
    if backend == "kernel":
        assert ptrs == [t.data_ptr() for t in (
            srv._path.stack.src, srv._path.stack.tables,
            srv._path.stack.output_nets)]

    got = {r[0]: r for r in res}
    for seqs_, chip, rows, tenant in ((pending, pc[a], X[16:32], "pix"),
                                      (more, pc[b], X[32:48], "neu")):
        raw, keep = _oracle(chip, rows)
        for s, want_raw, want_keep in zip(seqs_, raw, keep):
            assert got[s] == (s, tenant, int(want_raw), bool(want_keep))
    assert f.ledgers()["admission_misses"] == 0


@pytest.mark.parametrize("fault", [None, "repacked"])
def test_admission_miss_is_counted_at_the_tenants_first_dispatch(
        farm, fault):
    """The admission-miss counter watches a warm admission up to the
    admitted tenant's first result. A first dispatch at a batch width the
    bucket had not launched adds signatures and is no miss; a swap that
    leaves the stack at other shapes (here: repacked to its members'
    union, not the bucket's envelope) adds one at a width the bucket had
    launched, and is counted although the swap itself launched nothing."""
    jc, pc, X = farm
    a, b = _same_env_pair(jc)
    fleet = TenantFleet(_cfg(ServerConfig, "kernel", layout="bitsliced"),
                        bucket_slots=2, device="cpu")
    fleet.admit("pix", pc[a])
    fleet.submit_batch("pix", X[:16])
    fleet.flush()
    srv = fleet._buckets[0].server
    if fault == "repacked":
        swap = srv.reconfigure

        def repack(slot, chip):
            done = swap(slot, chip)
            configs = [c.config for c in srv.chips]
            srv._path.stack = port_ops.pack_fabrics(
                configs, layout="bitsliced", device="cpu")
            srv._path.out_weight = port_ops.decode_plan(
                configs, srv._path.stack.n_outputs)
            return done
        srv.reconfigure = repack
    keys = set(srv._launch_keys)
    fleet.admit("neu", pc[b])
    assert fleet.report()["admission_misses"] == 0
    width = 16 if fault else 40                 # 40 pads to a new 64
    fleet.submit_batch("neu", X[16:16 + width])
    res = fleet.flush()
    assert len(res) == width
    assert (srv._launch_keys != keys) == (fault is None)   # a new width
    assert fleet.report()["admission_misses"] == (1 if fault else 0)
    assert srv.shape_misses == (1 if fault else 0)


def test_warm_admission_of_the_frames_path_reallocates_nothing(farm):
    """Raw frames through a bit-sliced bucket on the kernel backend: the
    warm admission reuses the bucket's fused pass (its encode plan and
    staging buffers, sized by the envelope) and adds no launch signature;
    every event equals its tenant's oracle on the port's features."""
    from repro_torch.kernels.yprofile import ops as port_yp

    jc, pc, _ = farm
    a, b = _same_env_pair(jc)
    fr, y0 = frames(64)
    fleet = TenantFleet(_cfg(ServerConfig, "kernel"), bucket_slots=2,
                        device="cpu")
    fleet.admit("pix", pc[a])
    fleet.submit_frames("pix", fr[:32], y0[:32])
    fleet.flush()
    srv = fleet._buckets[0].server
    fe = srv._path.frontend
    plan_ptrs = {k: v.data_ptr() for k, v in fe.plan.items()}
    staging = {k: [t.data_ptr() for t in v] for k, v in fe.staging.items()}
    env = fleet._buckets[0].envelope
    assert fe.plan["feat_idx"].shape[1] == srv._path.stack.n_inputs \
        == env.n_inputs
    assert fe.plan["out_weight"].shape[1] == srv._path.stack.n_outputs \
        == env.n_outputs == 31
    misses = build.miss_counts()
    seqs_a = fleet.submit_frames("pix", fr[:32], y0[:32])
    fleet.admit("neu", pc[b])
    seqs_b = fleet.submit_frames("neu", fr[32:], y0[32:])
    res = {r.seq: r for r in fleet.flush()}
    assert build.miss_counts() == misses
    assert fleet.report()["admission_misses"] == 0
    fe2 = srv._path.frontend
    assert {k: v.data_ptr() for k, v in fe2.plan.items()} == plan_ptrs
    assert {k: [t.data_ptr() for t in v]
            for k, v in fe2.staging.items()} == staging
    feats = port_yp.yprofile(fr, y0, device="cpu").numpy()
    for seqs, chip, lo, tenant in ((seqs_a, pc[a], 0, "pix"),
                                   (seqs_b, pc[b], 32, "neu")):
        raw, keep = _oracle(chip, feats[lo:lo + 32])
        for s, w_raw, w_keep in zip(seqs, raw, keep):
            r = res[s]
            assert (r.tenant, r.score_raw, r.keep) == (
                tenant, int(w_raw), bool(w_keep))


@pytest.mark.parametrize("backend", BACKENDS)
def test_cold_iff_new_envelope_and_buckets_group_by_envelope(farm, backend):
    jc, pc, X = farm
    f = Fleets(farm, backend, bucket_slots=4)
    seen = {}
    for i, chip in enumerate(pc):
        env = port_ops.bucket_envelope(chip.config)
        info = f.admit(f"t{i}", i)
        assert info["cold"] == (env not in seen)
        if env in seen:
            assert info["bucket"] == seen[env]
        seen.setdefault(env, info["bucket"])
    assert f.port.n_buckets == len(seen) == f.jax.n_buckets
    f.ledgers()


# ------------------------------------------------ LRU eviction + re-admit
@pytest.mark.parametrize("backend", BACKENDS)
def test_lru_eviction_and_transparent_readmission(farm, backend):
    jc, pc, X = farm
    a, b = _same_env_pair(jc)
    f = Fleets(farm, backend, bucket_slots=1)
    f.admit("old", a)
    f.call("submit_batch", "old", X[:4])
    f.call("flush")
    f.advance(1.0)
    info = f.admit("new", b)
    assert info["evicted"] == "old"
    assert f.call("tenant_state", "old") == "evicted"
    s = f.call("submit", "old", X[5])
    assert s is not None
    assert f.call("tenant_state", "old") == "resident"
    assert f.call("tenant_state", "new") == "evicted"
    (r,) = f.call("flush")
    raw, keep = _oracle(pc[a], X[5:6])
    assert r[1:] == ("old", int(raw[0]), bool(keep[0]))
    rep = f.ledgers()["tenants"]
    assert rep["old"]["readmissions"] == 1
    assert rep["old"]["evictions"] == 1
    assert rep["new"]["evictions"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_nondraining_evict_counts_queued_and_closes_identity(farm, backend):
    jc, pc, X = farm
    f = Fleets(farm, backend, bucket_slots=2)
    f.admit("a", 1)
    f.admit("b", 2)
    sa = f.call("submit_batch", "a", X[:8])
    sb = f.call("submit_batch", "b", X[8:12])
    f.call("evict", "a", drain=False)
    res = f.call("flush")
    assert {r[1] for r in res} <= {"b"}
    led = f.ledgers()["tenants"]
    ta, tb = led["a"], led["b"]
    assert ta["evicted_while_queued"] == len([s for s in sa if s is not None])
    assert ta["events_in"] == (ta["events_out"] + ta["shed"]
                               + ta["quota_shed"]
                               + ta["evicted_while_queued"]
                               + ta["outstanding"])
    assert tb["events_out"] == len([s for s in sb if s is not None])


@pytest.mark.parametrize("backend", BACKENDS)
def test_tenant_quota_sheds_past_outstanding_cap(farm, backend):
    jc, pc, X = farm
    f = Fleets(farm, backend, bucket_slots=2, tenant_quota_queued=4)
    f.admit("a", 1)
    seqs = f.call("submit_batch", "a", X[:10])
    assert sum(s is not None for s in seqs) == 4
    assert seqs[4:] == [None] * 6
    assert f.ledgers()["tenants"]["a"]["quota_shed"] == 6
    f.call("flush")
    seqs = f.call("submit_batch", "a", X[:2])
    assert all(s is not None for s in seqs)
    # the raw-frames path sheds past the cap too
    fr, y0 = frames(8)
    seqs = f.port.submit_frames("a", fr, y0)
    assert sum(s is not None for s in seqs) == 2 and seqs[2:] == [None] * 6


# ------------------------------------------------------ grow/shrink wiring
@pytest.mark.parametrize("backend", BACKENDS)
def test_prewarm_then_shrink(farm, backend):
    jc, pc, X = farm
    a, b = _same_env_pair(jc)
    f = Fleets(farm, backend, bucket_slots=2)
    idx = f.jax.prewarm(jc[a])
    assert f.port.prewarm(pc[a]) == idx
    assert f.port.n_buckets == f.jax.n_buckets == 1
    assert f.port.prewarm(pc[b], warmup=False) == f.jax.prewarm(
        jc[b], warmup=False) == idx
    assert f.admit("a", b)["cold"] is False
    f.call("retire", "a")
    assert f.call("shrink") == 1
    assert f.port.n_buckets == 0
    f.ledgers()


# ----------------------------------------------- named errors (bugfix)
def test_golden_store_raises_named_error_not_raw_keyerror():
    stores = (JaxStore(), GoldenImageStore())
    for i in range(4):
        msgs = []
        for store, err in zip(stores, (JaxSlotError, GoldenSlotError)):
            call = (lambda: store.digest(3, 0),
                    lambda: store.n_replicas(3),
                    lambda: store.golden_config(3),
                    lambda: store.verify(3, 0, np.zeros((1, 4, 16))))[i]
            with pytest.raises(err, match="no golden image") as e:
                call()
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    assert issubclass(GoldenSlotError, KeyError)
    assert issubclass(GoldenSlotError, BitstreamError)
    assert str(GoldenSlotError(3)) == str(JaxSlotError(3))


def test_golden_store_discard_is_terminal_and_idempotent(farm):
    jc, pc, _ = farm
    cfg = pc[1].config
    m_pad = -(-max(cfg.level_sizes, default=1) // 128) * 128
    images = replica_table_images(cfg, len(cfg.level_sizes), m_pad)
    want = jax_images(jc[1].config, len(cfg.level_sizes), m_pad)
    for g, w in zip(images, want):
        np.testing.assert_array_equal(g, w)
    store = GoldenImageStore()
    store.register("t", cfg, images)
    assert "t" in store and len(store) == 1
    assert store.golden_config("t").n_luts == cfg.n_luts
    store.discard("t")
    store.discard("t")
    assert "t" not in store and len(store) == 0
    with pytest.raises(GoldenSlotError):
        store.golden_config("t")


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_unknown_and_retired_tenants_raise_named_errors(farm, backend):
    jc, pc, X = farm
    f = Fleets(farm, backend, bucket_slots=2)
    with pytest.raises(UnknownTenantError, match="unknown tenant") as e:
        f.port.submit("ghost", X[0])
    with pytest.raises(KeyError) as je:
        f.jax.submit("ghost", X[0])
    assert str(e.value) == str(je.value)
    assert issubclass(UnknownTenantError, KeyError)
    f.admit("a", 1)
    f.call("retire", "a")
    assert f.call("has_tenant", "a") is False
    with pytest.raises(GoldenSlotError):
        f.port.submit("a", X[0])
    f.ledgers()


def test_fleet_rejects_sparse_config():
    with pytest.raises(ValueError, match="dense") as e:
        TenantFleet(ServerConfig(sparse=True), device="cpu")
    with pytest.raises(ValueError) as je:
        JaxFleet(JaxConfig(sparse=True))
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="bucket_slots"):
        TenantFleet(ServerConfig(), bucket_slots=0, device="cpu")


# ---------------------------------------- (b) eviction/re-admission sweep
@given(backend=st.sampled_from(list(BACKENDS)),
       seed=st.integers(0, 10_000), data=st.data())
@settings(max_examples=8, deadline=None)
def test_random_admit_evict_readmit_bit_exact_and_reconciled(
        backend, seed, data):
    """The reference's random admit/evict/re-admit/submit schedules, the
    same seeds on both fleets: the same events, each bit-exact against
    its tenant's host oracle, and the same ledgers, every one closing
    the accounting identity."""
    farm = _get_farm()
    jc, pc, X = farm
    rng = np.random.default_rng(seed)
    f = Fleets(farm, backend, bucket_slots=2)
    tenants = {f"t{i}": int(rng.integers(len(pc))) for i in range(5)}
    expected = {}
    for _ in range(data.draw(st.integers(10, 25))):
        f.advance(0.01)
        t = str(rng.choice(list(tenants)))
        op = rng.random()
        if op < 0.15 and f.call("has_tenant", t):
            if f.call("tenant_state", t) == "resident":
                f.call("evict", t, drain=bool(rng.integers(2)))
            continue
        if not f.call("has_tenant", t):
            f.admit(t, tenants[t])
        rows = X[rng.integers(0, len(X) - 8):][: int(rng.integers(1, 6))]
        for s, row in zip(f.call("submit_batch", t, rows), rows):
            if s is not None:
                expected[s] = (t, row)
    res = f.call("flush")
    got = {r[0]: r for r in res}
    for s, r in got.items():
        t, row = expected[s]
        raw, keep = _oracle(pc[tenants[t]], row[None])
        assert r == (s, t, int(raw[0]), bool(keep[0]))
    rep = f.ledgers()
    for t, led in rep["tenants"].items():
        assert led["outstanding"] == 0
        assert led["events_in"] == (
            led["events_out"] + led["shed"] + led["quota_shed"]
            + led["evicted_while_queued"]), (t, led)
    assert rep["events_out"] == len(res)


# -------------------------------------------------------- geometry pool
@pytest.mark.parametrize("band", [None, True, False])
def test_bucket_envelope_equals_jax(farm, band):
    jc, pc, _ = farm
    for j, p in zip(jc, pc):
        want = jax_ops.bucket_envelope(j.config, band)
        got = port_ops.bucket_envelope(p.config, band)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.admits(p.config)
    assert port_ops._next_pow2(13) == 16 and port_ops._next_pow2(1) == 1


def _stack_fields(stack):
    """A JAX stack's fields as numpy and ints (repro_torch/convert.py's
    input)."""
    return {f.name: (None if getattr(stack, f.name) is None
                     else np.asarray(getattr(stack, f.name))
                     if hasattr(getattr(stack, f.name), "shape")
                     else getattr(stack, f.name))
            for f in dataclasses.fields(stack)}


def _assert_stacks_equal(got, want_jax):
    want = convert.stack_from_numpy(_stack_fields(want_jax), device="cpu")
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if torch.is_tensor(w):
            assert g.dtype == w.dtype and torch.equal(g, w), f.name
        else:
            assert g == w, f.name


@pytest.mark.parametrize("layout", ["matmul", "bitsliced"])
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_pack_fabric_pool_equals_jax(farm, layout, redundancy):
    jc, pc, _ = farm
    want = jax_ops.pack_fabric_pool([c.config for c in jc],
                                    redundancy=redundancy, layout=layout)
    got = port_ops.pack_fabric_pool([c.config for c in pc],
                                    redundancy=redundancy, layout=layout,
                                    device="cpu")
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.members == w.members
        assert dataclasses.astuple(g.envelope) == dataclasses.astuple(
            w.envelope)
        _assert_stacks_equal(g.stack, w.stack)


@pytest.mark.parametrize("layout", ["matmul", "bitsliced"])
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_pack_fabrics_pinned_geometry_equals_jax(farm, layout, redundancy):
    """Packed against a pinned envelope (deeper, wider, banded wider than
    the members would pick): the same arrays as JAX's, a swap-in of a
    chip of another shape keeps every shape, and a config outside the
    envelope is refused with the reference's text."""
    jc, pc, _ = farm
    env = jax_ops.bucket_envelope(jc[0].config)
    env = dataclasses.replace(env, n_levels=2 * env.n_levels)
    penv = port_ops.bucket_envelope(pc[0].config)
    penv = dataclasses.replace(penv, n_levels=2 * penv.n_levels)
    kw = dict(redundancy=redundancy, layout=layout)
    want = jax_ops.pack_fabrics([jc[1].config, jc[3].config],
                                geometry=env, **kw)
    got = port_ops.pack_fabrics([pc[1].config, pc[3].config],
                                geometry=penv, device="cpu", **kw)
    _assert_stacks_equal(got, want)
    assert got.n_levels == penv.n_levels
    assert got.band_k == (penv.fanin_reach or penv.n_levels)
    _assert_stacks_equal(got.swap_chip(1, pc[0].config),
                         want.swap_chip(1, jc[0].config))
    small = dataclasses.replace(penv, n_outputs=2)
    with pytest.raises(ValueError) as e:
        port_ops.pack_fabrics([pc[0].config], geometry=small,
                              device="cpu", **kw)
    with pytest.raises(ValueError) as je:
        jax_ops.pack_fabrics([jc[0].config], geometry=dataclasses.replace(
            env, n_outputs=2), **kw)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("layout", ["matmul", "bitsliced"])
def test_in_place_swap_writes_the_stack_and_plan_it_was_given(farm, layout):
    """``FusedFrontend.swap_chip`` (the server's hot swap) writes the new
    chip's stack and encode-plan rows into the tensors it was given: the
    result equals a frontend packed from the swapped configs at the same
    pinned geometry, and the staging buffers are shared."""
    from repro_torch.core.fabric import check_stackable
    from repro_torch.kernels import frontend as port_fe

    _, pc, _ = farm
    geo = dataclasses.replace(check_stackable(
        [pc[i].config for i in (1, 2, 3)]), fanin_reach=None)

    def pack(chips):
        return port_fe.pack_frontend(
            [c.config for c in chips], [c.frontend_spec() for c in chips],
            layout=layout, geometry=geo, device="cpu")

    fe = pack([pc[1], pc[2]])
    want = pack([pc[1], pc[3]])
    ptrs = [t.data_ptr() for t in (fe.stack.tables, fe.plan["feat_idx"])]
    swapped = fe.swap_chip(1, pc[3].config, pc[3].frontend_spec())
    assert [t.data_ptr() for t in (swapped.stack.tables,
                                   swapped.plan["feat_idx"])] == ptrs
    assert swapped.staging is fe.staging
    for k in want.plan:
        assert torch.equal(swapped.plan[k], want.plan[k]), k
    for k in ("tables", "output_nets", "src", "sel"):
        a, b = getattr(swapped.stack, k), getattr(want.stack, k)
        assert (a is None and b is None) or torch.equal(a, b), k


# ------------------------------------------------------- server hooks
@pytest.mark.parametrize("backend", BACKENDS)
def test_pinned_envelope_server_and_its_refusals_match_jax(farm, backend):
    jc, pc, X = farm
    env = jax_ops.bucket_envelope(jc[1].config)
    penv = port_ops.bucket_envelope(pc[1].config)
    jsrv = JaxServer([jc[1], jc[2]], JaxConfig(backend="host", band=False),
                     envelope=env)
    psrv = ReadoutServer([pc[1], pc[2]], ServerConfig(backend=backend,
                                                      band=False),
                         envelope=penv, device="cpu")
    assert dataclasses.astuple(dataclasses.replace(psrv.geometry,
                                                   frontend=None)) == \
        dataclasses.astuple(dataclasses.replace(jsrv.geometry,
                                                frontend=None))
    if backend == "kernel":
        assert psrv._path.stack.n_levels == penv.n_levels
        # band=False is not consulted: the envelope's reach is the band
        assert psrv._path.stack.band_k == (penv.fanin_reach or penv.n_levels)
    with pytest.raises(ValueError) as je:
        JaxServer([jc[1]], JaxConfig(backend="host"),
                  envelope=dataclasses.replace(env, n_inputs=8))
    with pytest.raises(ValueError) as e:
        ReadoutServer([pc[1]], ServerConfig(backend=backend),
                      envelope=dataclasses.replace(penv, n_inputs=8),
                      device="cpu")
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cancel_queued_drops_one_chips_queue_like_jax(farm, backend):
    jc, pc, X = farm
    servers = (JaxServer(jc[:2], _cfg(JaxConfig, "host")),
               ReadoutServer(pc[:2], _cfg(ServerConfig, backend),
                             device="cpu"))
    out = []
    for srv in servers:
        srv.submit_batch(0, X[:5])
        srv.submit_batch(1, X[5:8])
        srv.submit_batch(0, X[8:10])
        n = srv.cancel_queued(0)
        res = [(r.seq, r.chip, int(r.score_raw), bool(r.keep))
               for r in srv.flush()]
        out.append((n, res, srv.cancel_queued(1)))
    assert out[1] == out[0]
    assert out[1][0] == 7 and len(out[1][1]) == 3
    with pytest.raises(ValueError, match="chip"):
        servers[1].cancel_queued(2)


def test_rebind_mesh_to_an_equal_plan_copies_nothing(farm):
    """The fleet re-plans after every grow: on one device every plan is
    equal, and rebinding flushes (returning the results) and keeps the
    stack's and the fused pass's tensors where they are. A plan of two
    slabs moves the server: the queued events are flushed first, and
    the split server serves every event exactly as the one-slab one."""
    _, pc, X = farm
    fr, y0 = frames(16)
    srv = ReadoutServer(pc[:2], _cfg(ServerConfig, "kernel"), device="cpu")
    srv.submit_frames(0, fr, y0)
    srv.flush()
    stack, plan = srv._path.stack, srv._path.frontend.plan
    srv.submit_batch(1, X[:3])
    plan_ = port_mesh.make_fleet_meshes([2], device="cpu")[0]
    assert plan_ == srv._path.mesh
    done = srv.rebind_mesh(plan_)
    assert [r.chip for r in done] == [1, 1, 1]
    assert srv._path.stack is stack and srv._path.frontend.plan is plan
    host = ReadoutServer(pc[:2], _cfg(ServerConfig, "host"), device="cpu")
    assert host.rebind_mesh(plan_) == [] and host._path.mesh is None
    moved = reshard_replicated(stack, plan_)
    assert moved.tables is stack.tables and moved.n_levels == stack.n_levels
    # a plan of two slabs: the queue is flushed, then the slabs serve
    one = ReadoutServer(pc[:2], _cfg(ServerConfig, "kernel"), device="cpu")
    want = []
    for server in (one, srv):
        server.submit_batch(1, X[:2])
    pending = srv.rebind_mesh(port_mesh.ReadoutMesh(
        (torch.device("cpu"),) * 2))
    events = lambda rs: [(r.chip, r.score_raw, r.keep)  # noqa: E731
                         for r in rs]
    assert events(pending) == events(one.flush()) and srv.queue_depth == 0
    assert [s["chips"] for s in srv.report()["slabs"]] == [[0, 1], [1, 2]]
    for server in (one, srv):
        server.submit_frames(0, fr, y0)
        server.submit_batch(1, X[3:40])
        want.append(events(server.flush()))
    assert want[1] == want[0] and len(want[0]) == 16 + 37


def test_make_fleet_meshes_slab_arithmetic(farm, monkeypatch):
    """On the CPU every bucket gets the CPU, and plans of one device
    compare equal; over four cards the reference's proportional slices
    (the largest divisor of a bucket's chips inside its slice), over two
    cards for three buckets the wrap; a server serves over every device
    its plan names."""
    cpu = torch.device("cpu")
    plans = port_mesh.make_fleet_meshes([4, 2, 1], device="cpu")
    assert [p.devices for p in plans] == [(cpu,)] * 3
    assert plans[0] == port_mesh.make_readout_mesh(4, device="cpu")
    assert port_mesh.make_fleet_meshes([], device="cpu") == []
    for bad in ([0], [2, -1]):
        with pytest.raises(ValueError, match="at least|>= 1"):
            port_mesh.make_fleet_meshes(bad, device="cpu")
    with pytest.raises(ValueError, match="n_chips"):
        port_mesh.make_readout_mesh(0, device="cpu")
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(port_mesh, "local_devices", lambda device=None:
                        cards[: 4 if device is None else 2])
    idx = lambda plans: [tuple(d.index for d in p.devices)  # noqa: E731
                         for p in plans]
    assert idx(port_mesh.make_fleet_meshes([4, 2, 2])) == [
        (0, 1), (2,), (3,)]
    assert idx(port_mesh.make_fleet_meshes([3, 1])) == [(0, 1, 2), (3,)]
    assert idx(port_mesh.make_fleet_meshes([2, 2, 2], device="two")) == [
        (0,), (1,), (0,)]
    assert port_mesh.make_readout_mesh(6).size == 3
    # a server plans over every device local_devices gives (every card
    # for device=None), here four CPU entries: four slabs, serving
    # exactly as one
    _, pc, X = farm
    one = ReadoutServer(pc, _cfg(ServerConfig, "kernel"), device="cpu",
                        mesh=port_mesh.ReadoutMesh((cpu,)))
    monkeypatch.setattr(port_mesh, "local_devices",
                        lambda device=None: [cpu] * 4)
    assert port_mesh.make_readout_mesh(4).devices == (cpu,) * 4
    split = ReadoutServer(pc, _cfg(ServerConfig, "kernel"), device="cpu")
    assert [s["chips"] for s in split.report()["slabs"]] == [
        [0, 1], [1, 2], [2, 3], [3, 4]]
    got = []
    for server in (one, split):
        for c in range(4):
            server.submit_batch(c, X[8 * c : 8 * c + 8])
        got.append([(r.seq, r.chip, r.score_raw, r.keep)
                    for r in server.flush()])
    assert got[1] == got[0] and len(got[0]) == 32
