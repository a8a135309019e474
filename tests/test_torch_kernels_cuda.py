"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (a CUDA kernel has no CPU mode). Unlike the other
``test_torch_*.py`` files this one needs no JAX, so it runs where only
the port is installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The featurizer is held to |d| <= 2e-5 |x| + 1e-6 ke (summation order, see
tests/test_torch_yprofile.py); the bit-sliced walk (in each of its three
forms, staged, split and streamed, at an envelope that takes it; its
launches' forms in a served stream's report), the
selection-matmul
fabric kernels (dense and banded, also on a synthetic 0/1 ``sel`` with
empty and several-ones columns, and at the §5 chunk shape), the BDT
kernel (its tree walk on the packed arrays, its literal path on arrays
broken out of the one-hot form: chip_smoke.synthetic_ensemble), the
sparse-egress kernel B6 (its three entries, on the walk's real words and
on chip_smoke's synthetic words, keep fractions and decode rows; each one
kernel and no memset a call, by the profiler; its look-back state across
graph replays and shape changes) and the fused frontend downstream of
identical features are exact. A served stream staged from the pinned
ring equals the host oracle, blocks whose queue runs the coalesce cuts
across ring slots score as the same events submitted one at a time, and
a ring slot is refilled only once its queued copy has landed. A TCP replay through the port's front door
over a card server verifies every trigger against the host oracle. A
server split into two and four slabs on ``cuda:0`` serves exactly as one
slab does, and as the CPU from identical features; every kernel wrapper
launched on ``cuda:1`` tensors while ``cuda:0`` is current is exact (that
case skips below two cards). The §5 check's feature encode equals its
twin and the host encode for every rounding, overflow and checked width,
in float32 and float64, NaN, +-inf and values past int64 among the rows
(the twin is held to the JAX package on the CPU,
tests/test_torch_feature_encode.py); a 65,536-row chunk through
``infer_raw`` on the card is exact in every layout with one encode
launch, and rows that numpy casts to INT64_MIN score as the host's.
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core.bdt import GradientBoostedClassifier
from repro_torch.core.readout import KernelBackend, ReadoutChip
from repro_torch.data.smartpixel import SmartPixelConfig, generate
from repro_torch.data.smartpixel import train_test_split
from repro_torch.kernels import feature_encode as fenc
from repro_torch.kernels import frontend as fe
from repro_torch.kernels.bdt_infer import bdt_infer as bdt
from repro_torch.kernels.bdt_infer import ops as bdt_ops
from repro_torch.kernels.lut_eval import bitsliced as bs
from repro_torch.kernels.lut_eval import lut_eval as le
from repro_torch.kernels.lut_eval import ops as lut_ops
from repro_torch.kernels.sparse_pack import sparse_pack as sp
from repro_torch.kernels.yprofile import ops as yp
from repro_torch.parallel import compression as cp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    """Two trained chips and real frames, once a card is known to exist."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    tr, _ = train_test_split(generate(SmartPixelConfig(n_events=12_000,
                                                       seed=5)))
    chips = []
    for fabric, depth, leaves in (("efpga_130nm", 3, 5),
                                  ("efpga_28nm", 4, 8)):
        clf = GradientBoostedClassifier(
            n_estimators=1, max_depth=depth, max_leaf_nodes=leaves,
            min_samples_leaf=200).fit(tr["features"], tr["label"])
        chips.append(ReadoutChip.build(clf, fabric=fabric))
    dd = generate(SmartPixelConfig(n_events=512, seed=9), return_frames=True)
    frames = dd["frames"].astype(np.float32).reshape(2, 256, 8, 13, 21)
    y0 = dd["features"][:, 13].astype(np.float32).reshape(2, 256)
    return chips, frames, y0


def test_yprofile_kernel_matches_plain_twin(card):
    _, frames, y0 = card
    f = torch.as_tensor(frames, device="cuda")
    z = torch.as_tensor(y0, device="cuda")
    n0 = yp.yprofile_traced.launches
    got = yp.yprofile_traced(f, z, threshold=800.0).cpu().numpy()
    want = yp.yprofile_plain(f, z, 800.0).cpu().numpy()
    assert yp.yprofile_traced.launches == n0 + 1
    assert (np.abs(got - want) <= 2e-5 * np.abs(want) + 1e-6).all()


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_bitsliced_kernel_equals_plain_twin(card, redundancy):
    chips, _, _ = card
    stack = lut_ops.pack_fabrics([c.config for c in chips],
                                 redundancy=redundancy, layout="bitsliced",
                                 device="cuda")
    bits = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, (2, 1000, stack.n_inputs)), dtype=torch.int32, device="cuda")
    seg = bs.input_words(bits, stack.n_inputs, stack.in_seg)
    tables = stack.tables.clone()
    if redundancy == "tmr":          # an upset replica: non-zero dis words
        tables[1, :, :8, ::3] = 1.0 - tables[1, :, :8, ::3]
    args = (stack.src, tables, stack.output_nets, seg, stack.n_replicas)
    n0 = bs.eval_seg_voted.launches
    got = bs.eval_seg_voted(*args)
    want = bs.eval_seg_voted_plain(*args)
    assert bs.eval_seg_voted.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_frontend_on_card_equals_cpu_from_same_features(card):
    _frontend_on_card_equals_cpu(card, "bitsliced")


def test_matmul_fused_frontend_on_card_equals_cpu(card):
    _frontend_on_card_equals_cpu(card, "matmul")


def _frontend_on_card_equals_cpu(card, layout):
    chips, frames, y0 = card
    on_card = fe.pack_frontend([c.config for c in chips],
                               [c.frontend_spec() for c in chips],
                               redundancy="tmr", layout=layout,
                               device="cuda")
    on_cpu = fe.pack_frontend([c.config for c in chips],
                              [c.frontend_spec() for c in chips],
                              redundancy="tmr", layout=layout, device="cpu")
    feats = yp.yprofile_traced(torch.as_tensor(frames, device="cuda"),
                               torch.as_tensor(y0, device="cuda"),
                               threshold=800.0)
    valid = torch.ones((2, 256), dtype=torch.bool)
    got = fe.score_features(feats, on_card.stack, on_card.plan,
                            valid.cuda())
    want = fe.score_features(feats.cpu(), on_cpu.stack, on_cpu.plan, valid)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    score, keep, dis = on_card.score_frames_voted(frames, y0)
    assert torch.equal(score.cpu(), want[0])
    assert torch.equal(keep.cpu(), want[1])


@pytest.mark.parametrize("band", [None, False])
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_lut_eval_kernels_equal_plain_twin(card, band, redundancy):
    """B3 (band=None packs these chips banded) and B2 (band=False)."""
    chips, _, _ = card
    stack = lut_ops.pack_fabrics([c.config for c in chips], band=band,
                                 redundancy=redundancy, device="cuda")
    assert stack.layout == ("banded" if band is None else "dense")
    rows = stack.tables.shape[0]
    bits = torch.as_tensor(np.random.default_rng(4).integers(
        0, 2, (rows, 300, stack.n_inputs)), device="cuda")
    ext = lut_ops._bits_ext(bits, stack.n_inputs, stack.in_seg)
    win = stack.win_base if stack.banded else None
    fn = le.lut_eval_banded_stacked if stack.banded else le.lut_eval_stacked
    n0 = fn.launches
    got = fn(ext, stack.sel, stack.tables, stack.level_base,
             *([win] if stack.banded else []), n_nets_pad=stack.n_nets_pad)
    want = le.lut_eval_plain(ext, stack.sel, stack.tables, stack.level_base,
                             win, n_nets_pad=stack.n_nets_pad)
    assert fn.launches == n0 + 1
    assert torch.equal(got, want)


def _synthetic_sel(shape, rng):
    """A 0/1 selection no packing makes: 0, 1, 2 or LIST_CAP + 1 ones per
    column at random rows (some in window rows of levels not written yet,
    or of the level's own slots)."""
    C, L, rows, M4 = shape
    sel = np.zeros(shape, np.float32)
    count = rng.choice([0, 1, 2, le.LIST_CAP + 1], size=(C, L, M4))
    at = rng.integers(0, rows, size=(C, L, M4, le.LIST_CAP + 1))
    c, l, j, p = np.nonzero(np.arange(le.LIST_CAP + 1) < count[..., None])
    sel[c, l, at[c, l, j, p], j] = 1.0
    return torch.as_tensor(sel, dtype=torch.bfloat16, device="cuda")


@pytest.mark.parametrize("band", [None, False])
def test_lut_eval_kernels_on_synthetic_sel(card, band):
    """B3/B2 on four chip rows of the envelope's shape with a synthetic
    sel and random 0/1 tables: empty and several-ones columns (past the
    column lists) equal the twin exactly."""
    chips, _, _ = card
    stack = lut_ops.pack_fabrics([c.config for c in chips], band=band,
                                 device="cuda")
    rng = np.random.default_rng(6)
    _, L, rows, M4 = stack.sel.shape
    sel = _synthetic_sel((4, L, rows, M4), rng)
    assert int((sel.float().sum(dim=2) > le.LIST_CAP).sum()) > 0
    tables = torch.as_tensor(rng.integers(0, 2, (4, L, M4 // 4, 16)),
                             dtype=torch.float32, device="cuda")
    bits = torch.as_tensor(rng.integers(0, 2, (4, 300, stack.n_inputs)),
                           device="cuda")
    ext = lut_ops._bits_ext(bits, stack.n_inputs, stack.in_seg)
    win = stack.win_base if stack.banded else None
    fn = le.lut_eval_banded_stacked if stack.banded else le.lut_eval_stacked
    got = fn(ext, sel, tables, stack.level_base,
             *([win] if stack.banded else []), n_nets_pad=stack.n_nets_pad)
    want = le.lut_eval_plain(ext, sel, tables, stack.level_base, win,
                             n_nets_pad=stack.n_nets_pad)
    assert torch.equal(got, want)


@pytest.mark.parametrize("band", [None, False])
def test_lut_eval_kernels_at_section5_chunk_shape(card, band):
    """B3/B2 at the §5 path's shape (C=1, B=65,536): exact, and faster
    than the plain twin (CUDA events; the times are printed)."""
    chips, _, _ = card
    packed = lut_ops.pack_fabric(chips[1].config, band=band, device="cuda")
    bits = torch.as_tensor(np.random.default_rng(8).integers(
        0, 2, (65_536, packed.n_inputs)), device="cuda")
    ext = lut_ops._bits_ext(bits, packed.n_inputs, packed.in_seg)[None]
    win = packed.win_base if packed.banded else None
    arrays = (ext, packed.sel[None], packed.tables[None], packed.level_base,
              win)
    got = (le.lut_eval_banded_stacked(*arrays, n_nets_pad=packed.n_nets_pad)
           if packed.banded else
           le.lut_eval_stacked(*arrays[:4], n_nets_pad=packed.n_nets_pad))
    want = le.lut_eval_plain(*arrays, n_nets_pad=packed.n_nets_pad)
    assert torch.equal(got, want)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = le.lut_tile(packed.n_nets_pad, packed.m_pad, 65_536, 1, n_sms)

    def ms(fn, n=5):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    kernel = ms(lambda: le._launch(*arrays, got, tile))
    plain = ms(lambda: le.lut_eval_plain(*arrays,
                                         n_nets_pad=packed.n_nets_pad))
    print(f"{'banded' if packed.banded else 'dense'} chunk: "
          f"kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
          f"{torch.cuda.get_device_name(0)}")
    assert kernel < plain


def test_bdt_infer_kernel_equals_plain_twin_and_golden(card):
    tr, _ = train_test_split(generate(SmartPixelConfig(n_events=12_000,
                                                       seed=5)))
    ens = GradientBoostedClassifier(n_estimators=3, max_depth=5).fit(
        tr["features"], tr["label"]).quantized()
    packed = bdt_ops.pack_ensemble(ens, 14, device="cuda")
    rng = np.random.default_rng(0)
    x = rng.integers(ens.spec.raw_min, ens.spec.raw_max, (1000, 14))
    xt = torch.as_tensor(x, dtype=torch.int32, device="cuda")
    arrays = (packed.featsel, packed.thr, packed.root_onehot, packed.left,
              packed.right, packed.value_hi, packed.value_lo)
    n0 = bdt.bdt_traverse.launches
    got = bdt.bdt_traverse(xt, *arrays, depth=packed.depth)
    want = bdt.bdt_traverse_plain(xt, *arrays, depth=packed.depth)
    assert bdt.bdt_traverse.launches == n0 + 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(bdt_ops.bdt_infer(packed, x).cpu().numpy(),
                                  ens.decision_function_raw(x))


@pytest.mark.parametrize("recipe", ("one_hot",) + chip_smoke.BDT_RECIPES)
def test_bdt_infer_kernel_off_the_one_hot_form(card, recipe):
    """B4 on a 3-tree ensemble's packed arrays (the walk) and on the
    synthetic arrays that leave the one-hot form (the literal path) or
    keep it at leaf values near +-2^27: equal to the twin, all 128
    columns."""
    tr, te = train_test_split(generate(SmartPixelConfig(n_events=12_000,
                                                        seed=5)))
    ens = GradientBoostedClassifier(n_estimators=3, max_depth=5).fit(
        tr["features"], tr["label"]).quantized()
    packed = bdt_ops.pack_ensemble(ens, 14, device="cpu")
    names = ("featsel", "thr", "root_onehot", "left", "right", "value_hi",
             "value_lo")
    arrays = {k: getattr(packed, k).numpy() for k in names}
    x = ens.quantize_features(te["features"][:700]).astype(np.int32)
    if recipe != "one_hot":
        arrays, x = chip_smoke.synthetic_ensemble(np, arrays, x, recipe)
    xt = torch.as_tensor(x, device="cuda")
    on_card = [torch.as_tensor(arrays[k], device="cuda") for k in names]
    got = bdt.bdt_traverse(xt, *on_card, depth=packed.depth)
    want = bdt.bdt_traverse_plain(xt, *on_card, depth=packed.depth)
    assert torch.equal(got, want)


@pytest.mark.parametrize("words", [16, 256])
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_bitsliced_kernel_at_served_and_wide_widths(card, redundancy,
                                                    words):
    """K2 at the served width (16 words a chip) and at 256, R=1 and R=3
    with an upset replica: equal to the twin."""
    chips, _, _ = card
    stack = lut_ops.pack_fabrics([c.config for c in chips],
                                 redundancy=redundancy, layout="bitsliced",
                                 device="cuda")
    bits = torch.as_tensor(np.random.default_rng(words).integers(
        0, 2, (2, words * 32, stack.n_inputs)), dtype=torch.int32,
        device="cuda")
    seg = bs.input_words(bits, stack.n_inputs, stack.in_seg)
    tables = stack.tables.clone()
    if redundancy == "tmr":
        tables[1, :, :8, ::3] = 1.0 - tables[1, :, :8, ::3]
    args = (stack.src, tables, stack.output_nets, seg, stack.n_replicas)
    got = bs.eval_seg_voted(*args)
    want = bs.eval_seg_voted_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[1] != 0).any()) == (redundancy == "tmr")


def _equal_b6(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def _walk_case(card, redundancy, frac):
    """K2's voted and disagreement words of the card's stack (an upset
    replica under TMR), the chips' decode rows, cuts keeping about
    ``frac`` and a valid tail that ends mid-word; and a closure that
    runs the walk again on the same inputs, so a B6 entry can follow it
    on the stream as on the serving path."""
    chips, _, _ = card
    stack = lut_ops.pack_fabrics([c.config for c in chips],
                                 redundancy=redundancy, layout="bitsliced",
                                 device="cuda")
    tables = stack.tables.clone()
    if redundancy == "tmr":
        tables[1, :, :8, ::3] = 1.0 - tables[1, :, :8, ::3]
    bits = torch.as_tensor(np.random.default_rng(9).integers(
        0, 2, (2, 512, stack.n_inputs)), dtype=torch.int32, device="cuda")
    seg = bs.input_words(bits, stack.n_inputs, stack.in_seg)

    def walk():
        return bs.eval_seg_voted(stack.src, tables, stack.output_nets, seg,
                                 stack.n_replicas)
    voted, dis = walk()
    weight = torch.as_tensor(lut_ops.decode_plan(
        [c.config for c in chips], stack.n_outputs), device="cuda")
    args = chip_smoke.b6_case(torch, np, bs, 2, 16, stack.n_replicas,
                              stack.n_outputs, "plan", frac, seed=3,
                              voted=voted, dis=dis, weight=weight)
    return args, walk


@pytest.mark.parametrize("frac", chip_smoke.B6_FRACTIONS)
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_sparse_pack_on_walk_words_equals_plain_twin(card, redundancy,
                                                     frac):
    """B6's decode entry on K2's voted and disagreement words (an upset
    replica under TMR), the chips' decode rows and a valid tail that ends
    mid-word: (count, idx, vals, dis) equal the twin's, launched alone and
    right behind the walk that makes the words."""
    args, walk = _walk_case(card, redundancy, frac)
    want = sp.decode_pack_plain(*args)
    n0 = sp.decode_pack.launches
    got = sp.decode_pack(*args)
    assert sp.decode_pack.launches == n0 + 1
    _equal_b6(got, want)
    assert bool((got[3] != 0).any()) == (redundancy == "tmr")
    _equal_b6(sp.decode_pack(*walk(), *args[2:]), want)


@pytest.mark.parametrize("frac", chip_smoke.B6_FRACTIONS)
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_decode_dense_on_walk_words_equals_plain_twin(card, redundancy,
                                                      frac):
    """B6's dense entry on the same words: (score, keep, dis) equal the
    torch chain's, launched alone and right behind the walk."""
    args, walk = _walk_case(card, redundancy, frac)
    want = sp.decode_dense_plain(*args)
    n0 = sp.decode_dense.launches
    got = sp.decode_dense(*args)
    assert sp.decode_dense.launches == n0 + 1
    _equal_b6(got, want)
    assert bool((got[2] != 0).any()) == (redundancy == "tmr")
    _equal_b6(sp.decode_dense(*walk(), *args[2:]), want)


@pytest.mark.parametrize("recipe", chip_smoke.B6_WEIGHTS + ("arbitrary",))
@pytest.mark.parametrize("words", [16, chip_smoke.B6_WORDS])
def test_decode_dense_on_synthetic_words_equals_plain_twin(card, words,
                                                           recipe):
    """B6's dense entry on random words at the served width and at
    65,536 events a chip, every decode row (and arbitrary int32 weights)
    and keep fraction."""
    for frac in chip_smoke.B6_FRACTIONS:
        args = chip_smoke.b6_case(torch, np, bs, 4, words, 3, 32, recipe,
                                  frac, seed=words, dense=True)
        _equal_b6(sp.decode_dense(*args), sp.decode_dense_plain(*args))


def _keep_words_case(C, W, seed):
    rng = np.random.default_rng(seed)
    keep = torch.as_tensor(rng.integers(-2**31, 2**31, (C, W)),
                           dtype=torch.int32, device="cuda")
    scores = torch.as_tensor(rng.integers(-2**31, 2**31, (C, W, 32)),
                             dtype=torch.int32, device="cuda")
    return keep, scores


def test_each_b6_entry_is_one_kernel_and_no_memset(card):
    """One call of each entry, after a warm-up call of each, traced by
    torch.profiler in one profiling window: three kernels on the device (the
    sparse kernel for decode-pack and keep-words, the dense one for the
    dense entry), and no memset or copy."""
    from torch.profiler import ProfilerActivity, profile

    args = chip_smoke.b6_case(torch, np, bs, 4, 16, 3, 28, "plan", 0.5,
                              seed=5)
    kw = _keep_words_case(4, 16, 6)
    calls = (lambda: sp.decode_pack(*args), lambda: sp.pack_keep_words(*kw),
             lambda: sp.decode_dense(*args))
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [("pack_kernel" in n, "dense_kernel" in n) for n in on_device] \
        == [(True, False), (True, False), (False, True)], on_device


def _b6_state_cases():
    """The three entries' inputs and plain outputs at 16 words a chip (one
    block, no shared state) and at B6_WORDS (128 blocks: the look-back,
    the SEU accumulators and the done counter)."""
    shapes = {W: chip_smoke.b6_case(torch, np, bs, 4, W, 3, 28, "plan",
                                    0.5, seed=W)
              for W in (16, chip_smoke.B6_WORDS)}
    kws = {W: _keep_words_case(4, W, W + 1) for W in shapes}
    want = {W: (sp.decode_pack_plain(*a), sp.decode_dense_plain(*a),
                sp.pack_words_plain(*kws[W])) for W, a in shapes.items()}

    def calls(W):
        return (sp.decode_pack(*shapes[W]), sp.decode_dense(*shapes[W]),
                sp.pack_keep_words(*kws[W]))
    return calls, want


def test_b6_state_survives_graph_replays_and_shape_changes(card):
    """The look-back state is zero again after every launch: 200 replays
    of a graph of the three entries at 16 and at 2,048 words a chip (each
    a programmatic dependent of the one before), every output exact after
    each replay; then 16, 2,048 and 16 words a chip in turns on one
    stream with no synchronisation between, every output exact."""
    calls, want = _b6_state_cases()
    order = (16, chip_smoke.B6_WORDS)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # the capture stream's state
        for W in order:
            calls(W)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = [calls(W) for W in order]
    for _ in range(200):
        graph.replay()
        torch.cuda.synchronize()
        for W, got in zip(order, captured):
            for g, w in zip(got, want[W]):
                _equal_b6(g, w)
    order = (16, chip_smoke.B6_WORDS, 16, chip_smoke.B6_WORDS, 16)
    runs = [calls(W) for W in order]
    torch.cuda.synchronize()
    for W, got in zip(order, runs):
        for g, w in zip(got, want[W]):
            _equal_b6(g, w)


def test_b6_launches_on_two_streams_at_once_stay_exact(card):
    """Each stream has its own look-back state: the three entries at
    2,048 words a chip launched in turns on two streams with no
    synchronisation between them, 20 rounds, every output exact."""
    calls, want = _b6_state_cases()
    W = chip_smoke.B6_WORDS
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    runs = []
    for _ in range(20):
        for st in streams:
            with torch.cuda.stream(st):
                runs.append(calls(W))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for got in runs:
        for g, w in zip(got, want[W]):
            _equal_b6(g, w)


@pytest.mark.parametrize("recipe", chip_smoke.B6_WEIGHTS)
@pytest.mark.parametrize("words", [16, chip_smoke.B6_WORDS])
def test_sparse_pack_on_synthetic_words_equals_plain_twin(card, words,
                                                          recipe):
    """B6 on random words at the served width and at 65,536 events a chip,
    for every synthetic decode row and keep fraction."""
    for frac in chip_smoke.B6_FRACTIONS:
        args = chip_smoke.b6_case(torch, np, bs, 4, words, 3, 32, recipe,
                                  frac, seed=words)
        _equal_b6(sp.decode_pack(*args), sp.decode_pack_plain(*args))


@pytest.mark.parametrize("shape", [(4, 512), (4, 8), (3, 37)])
def test_sparse_pack_keep_words_entry_equals_cpu(card, shape):
    """The event-domain pack (B6's keep-words entry) on the card equals
    the CPU twin, at every keep fraction."""
    rng = np.random.default_rng(shape[1])
    for frac in chip_smoke.B6_FRACTIONS:
        score = torch.as_tensor(rng.integers(-2**31, 2**31, shape),
                                dtype=torch.int32)
        keep = torch.as_tensor(rng.random(shape) < frac)
        n0 = sp.pack_keep_words.launches
        got = cp.sparse_trigger_pack(score.cuda(), keep.cuda())
        assert sp.pack_keep_words.launches == n0 + 1
        _equal_b6([g.cpu() for g in got], cp.sparse_trigger_pack(score, keep))


def test_sparse_frames_on_card_equal_dense_packed(card):
    """The fused sparse pass on the card (K1, K2, B6) equals the dense
    pass on the card, packed on the CPU, and keeps count on the device."""
    chips, frames, y0 = card
    on_card = fe.pack_frontend([c.config for c in chips],
                               [c.frontend_spec() for c in chips],
                               redundancy="tmr", layout="bitsliced",
                               device="cuda")
    for B in (256, 100):
        got = on_card.score_frames_sparse(frames[:, :B], y0[:, :B])
        assert got[0].is_cuda and got[0].shape == ()
        score, keep, dis = on_card.score_frames_voted(frames[:, :B],
                                                      y0[:, :B])
        want = cp.sparse_trigger_pack(score.cpu(), keep.cpu())
        _equal_b6([g.cpu() for g in got], [*want, dis.cpu()])


def _effective_flip(chip, bits):
    """(lut, bit) of ``chip``'s base encoding whose flip changes its
    outputs on ``bits`` (the numpy FabricSim oracle)."""
    from repro_torch.core.fabric import FabricSim
    from repro_torch.core.tmr import inject_seu

    good = np.asarray(FabricSim(chip.config).run(bits)[0])
    for li in range(chip.config.n_luts):
        for bi in range(16):
            outs = np.asarray(FabricSim(
                inject_seu(chip.config, li, bi)).run(bits)[0])
            if (outs != good).any():
                return li, bi, (outs != good).any(-1)
    raise AssertionError("no effective flip")


@pytest.mark.parametrize("layout", ["bitsliced", "matmul"])
def test_swap_replica_then_served_dispatch_on_card(card, layout):
    """A replica row swapped on the card is what the next scoring pass
    evaluates (K2 + B6's dense entry, or B3 + the vote): the voted scores
    and keeps are the oracle's, and the upset replica's disagreement
    count is the oracle's count of events whose outputs the flip
    changed; the same as the plain twins on the CPU."""
    from repro_torch.core.tmr import (inject_seu, replica_lut_index,
                                      replicate_config)

    chips, _, _ = card
    rng = np.random.default_rng(3)
    bits = [rng.integers(0, 2, (256, c.config.n_inputs)).astype(np.uint8)
            for c in chips]
    li, bi, changed = _effective_flip(chips[1], bits[1])
    bad = inject_seu(replicate_config(chips[1].config, 2),
                     replica_lut_index(chips[1].config, 2, li), bi)
    thr = np.array([c.score_threshold_raw for c in chips], np.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        stack = lut_ops.pack_fabrics([c.config for c in chips],
                                     redundancy="tmr", layout=layout,
                                     device=dev)
        swapped = stack.swap_replica(1, 2, bad)
        stacked = lut_ops.stack_input_bits(swapped, bits)
        weight = lut_ops.decode_plan([c.config for c in chips],
                                     swapped.n_outputs)
        runs[dev] = [t.cpu() for t in lut_ops.fabric_eval_multi_scored(
            swapped, stacked, weight, thr)]
    for g, w in zip(runs["cuda"], runs["cpu"]):
        assert torch.equal(g, w)
    score, keep, dis = (t.numpy() for t in runs["cuda"])
    for i, chip in enumerate(chips):
        from repro_torch.core.fabric import FabricSim

        want = chip.synth.decode_outputs(
            np.asarray(FabricSim(chip.config).run(bits[i])[0]))
        np.testing.assert_array_equal(score[i], want)
        np.testing.assert_array_equal(keep[i],
                                      want <= chip.score_threshold_raw)
    assert dis[0].tolist() == [0, 0, 0]
    assert dis[1].tolist() == [0, 0, int(changed.sum())]


def test_scrub_readback_resolves_without_a_stream_synchronisation(
        card, monkeypatch):
    """A steady-state TMR stream on the card with a scrub step every
    dispatch (poll only, no flush): no torch.cuda.synchronize, no
    Stream.synchronize, and no blocking event wait inside the scrub
    step; the readbacks still resolve, and a flush afterwards finds every
    frame clean."""
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    chips, frames, y0 = card
    server = ReadoutServer(chips, ServerConfig(
        max_batch=256, redundancy="tmr", scrub_interval=1), device="cuda")
    for k in range(4):                               # warm up
        server.submit_frames(k % 2, frames[k % 2], y0[k % 2])
        server.poll()
    server.flush()
    torch.cuda.synchronize()

    calls = {"synchronize": 0, "stream": 0, "event_in_scrub": 0,
             "resolved": 0}
    in_scrub = [False]
    event_sync = torch.cuda.Event.synchronize

    def count(key, fn=None):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw) if fn else None
        return wrapped

    def event_wait(self):
        if in_scrub[0]:
            calls["event_in_scrub"] += 1
        return event_sync(self)

    monkeypatch.setattr(torch.cuda, "synchronize",
                        count("synchronize", torch.cuda.synchronize))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        count("stream", torch.cuda.Stream.synchronize))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_wait)
    scrub_step, resolve = server.scrub_step, server._resolve_readback

    def scrub():
        in_scrub[0] = True
        try:
            return scrub_step()
        finally:
            in_scrub[0] = False

    def resolved(entry):
        calls["resolved"] += 1
        return resolve(entry)

    server.scrub_step, server._resolve_readback = scrub, resolved
    steps0 = server.report()["scrub"]["steps"]
    for k in range(24):
        server.submit_frames(k % 2, frames[k % 2], y0[k % 2])
        server.poll()
    rep = server.report()["scrub"]
    assert calls["synchronize"] == 0 and calls["stream"] == 0
    assert calls["event_in_scrub"] == 0
    assert rep["steps"] > steps0 and calls["resolved"] > 0
    assert len(server._scrub_pending) < 2 * server.n_replicas
    monkeypatch.undo()
    server.flush()
    assert server.report()["scrub"]["detections"] == 0
    assert all(server.verify_frame(s, r) for s in range(2) for r in range(3))


@pytest.mark.parametrize("slabs", [1, 2])
def test_dispatch_device_seconds_lie_inside_the_wall_time(card, slabs):
    """A served TMR sparse stream on the card: each slab's dispatch adds
    one ``dispatch_device`` call, whose CUDA event pair reads more than
    zero and, summed, no more than the host's wall time around the
    whole stream."""
    import time

    from repro_torch.launch.mesh import ReadoutMesh
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    chips, frames, y0 = card
    server = ReadoutServer(chips, ServerConfig(
        max_batch=512, redundancy="tmr", sparse=True, scrub_interval=4),
        device="cuda",
        mesh=ReadoutMesh((torch.device("cuda:0"),) * slabs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(8):
        for s in range(2):
            server.submit_frames(s, frames[s], y0[s])
        server.poll()
    server.flush()
    wall = time.perf_counter() - t0
    st = server.report()["stages"]
    assert st["dispatch_device"]["calls"] == 8 * slabs
    assert st["launch_fused"]["calls"] == 8
    assert st["launch_fused.h2d"]["calls"] == 8 * slabs
    assert 0.0 < st["dispatch_device"]["seconds"] <= wall


def test_served_stream_from_the_pinned_ring_equals_the_oracle(card):
    """A TMR sparse stream (bit-sliced, ``pipeline_depth`` 2, scrub every
    4 dispatches) served for 12 dispatches, three times the ring's 4
    slots, poll only until the flush: every kept event and its score are
    the host oracle's, and no fill waited on the ring (a slot comes round
    only after its batch, copies first, has drained)."""
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    chips, frames, y0 = card
    feats = [yp.yprofile(frames[i], y0[i], device="cuda").cpu().numpy()
             .astype(np.float64) for i in range(2)]
    chips = _cut_at_median(chips, feats)
    server = ReadoutServer(chips, ServerConfig(
        max_batch=256, layout="bitsliced", redundancy="tmr", sparse=True,
        scrub_interval=4, pipeline_depth=2), device="cuda")
    want, got = {}, []
    oracle = [_card_oracle(chips[c], frames[c], y0[c]) for c in range(2)]
    for k in range(12):
        c = k % 2
        for seq, score, keep in zip(
                server.submit_frames(c, frames[c], y0[c]), *oracle[c]):
            if keep:
                want[seq] = (c, int(score))
        got.extend(server.poll())
    got.extend(server.flush())
    assert {r.seq: (r.chip, r.score_raw) for r in got} == want
    assert all(r.keep for r in got) and 0 < len(want) < 12 * 256
    st = server.report()["stages"]
    assert st["launch_fused"]["calls"] == 12
    assert "stack_frames.ring_wait" not in st
    assert server._path.ring.pinned and len(server._path.ring._slots) == 4


@pytest.mark.parametrize("sparse", [False, True])
def test_blocks_cut_across_ring_slots_equal_single_events(card, sparse):
    """256-event blocks of two chips, six of them, through a TMR server
    at ``max_batch`` 200: the coalesce cuts the blocks' runs, each piece
    copied into a ring slot once. Every drained batch's ``ScoredEvent``s
    equal, bit for bit and in order, those of the same frames submitted
    one event at a time; the kept set is the host oracle's."""
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    chips, frames, y0 = card
    feats = [yp.yprofile(frames[i], y0[i], device="cuda").cpu().numpy()
             .astype(np.float64) for i in range(2)]
    chips = _cut_at_median(chips, feats)
    oracle = [_card_oracle(chips[c], frames[c], y0[c]) for c in range(2)]
    runs = []
    for per_event in (False, True):
        server = ReadoutServer(chips, ServerConfig(
            max_batch=200, redundancy="tmr", sparse=sparse,
            scrub_interval=4), device="cuda")
        batches, drain = [], server._drain_one

        def drain_one(drain=drain, batches=batches):
            got = drain()
            batches.append([(r.seq, r.chip, r.score_raw, r.keep)
                            for r in got])
            return got

        server._drain_one = drain_one
        want = {}
        for k in range(6):
            c = k % 2
            seqs = ([s for i in range(256) for s in server.submit_frames(
                c, frames[c][i:i + 1], y0[c][i:i + 1])] if per_event else
                server.submit_frames(c, frames[c], y0[c]))
            for seq, score, keep in zip(seqs, *oracle[c]):
                if keep or not sparse:
                    want[seq] = (c, int(score), bool(keep))
            server.poll()
        server.flush()
        got = {q: (c, s, k) for b in batches for q, c, s, k in b}
        assert got == want
        rep = server.report()
        assert rep["queue"]["runs"] == (6 * 256 if per_event else 6)
        assert rep["stages"]["launch_fused"]["calls"] == len(batches) > 6
        runs.append(batches)
    assert runs[0] == runs[1]


def test_ring_slot_refill_waits_for_its_queued_copy(card):
    """A one-slot ring whose copy is queued behind a long device sleep:
    refilling the slot counts one ``stack_frames.ring_wait`` call, and
    the device staging buffer holds the first fill's rows, not the
    second's."""
    import time

    from repro_torch.stages import Stages

    chips, frames, y0 = card
    front = fe.pack_frontend([c.config for c in chips],
                             [c.frontend_spec() for c in chips],
                             layout="bitsliced", device="cuda")
    front.score_frames_voted(frames, y0)    # builds and loads the kernels
    stages = Stages(time.perf_counter)
    ring = fe.StagingRing(1, pinned=True)
    rows = ring.take((256, 256), 256, stages)
    rows.frames.numpy()[:] = frames.reshape(512, 8, 13, 21)
    rows.y0.numpy()[:] = y0.reshape(512)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 28)          # ~0.1 s ahead of the copies
    front.score_frames_voted(rows, stages=stages)
    assert len(rows.events) == 1 and not rows.events[0].query()
    again = ring.take((256, 256), 256, stages)
    assert again.frames.data_ptr() == rows.frames.data_ptr()
    assert stages.calls["stack_frames.ring_wait"] == 1
    again.frames.numpy()[:] = -1.0
    again.y0.numpy()[:] = -1.0
    torch.cuda.synchronize()
    f, z, _ = front.staging[(2, 256)]
    assert torch.equal(f.cpu(), torch.as_tensor(frames))
    assert torch.equal(z.cpu(), torch.as_tensor(y0))


def test_tcp_replay_against_a_door_over_a_card_server(card):
    """The port's front door over a ServerConfig() server on the card,
    one TCP replay client a chip on loopback: every trigger verified
    against host_oracle on the card (the featurizer kernel, then numpy),
    the accounting exact, and the default served path's kernels (K1, K2,
    B6's dense entry) launched."""
    import asyncio

    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig
    from repro_torch.net import replay as R
    from repro_torch.net.ingress import ReadoutFrontDoor

    chips, frames, y0 = card
    server = ReadoutServer(chips, ServerConfig(), device="cuda")
    door = ReadoutFrontDoor(server)
    wrappers = (yp.yprofile_traced, bs.eval_seg_voted, sp.decode_dense)
    before = [fn.launches for fn in wrappers]
    cfgs = [R.ReplayConfig(n_batches=8, events_per_batch=32, sensor=c)
            for c in range(2)]

    async def go():
        await door.start()
        try:
            return await asyncio.gather(*(
                R.replay("127.0.0.1", door.tcp_port,
                         R.array_source(frames[c], y0[c], 32), cfg,
                         R.host_oracle(chips[c]))
                for c, cfg in enumerate(cfgs)))
        finally:
            await door.stop()

    for rep in asyncio.run(go()):
        assert rep.verified, rep.mismatches
        assert rep.ack["events_in"] == 256 == rep.ack["events_admitted"]
    assert server.report()["net"]["totals"]["events_in"] == 512
    assert all(fn.launches > n for fn, n in zip(wrappers, before))


def _card_oracle(chip, frames, y0):
    """(score, keep) of the numpy oracle on the featurizer kernel's
    features of the frames."""
    from repro_torch.core.fabric import FabricSim

    feats = yp.yprofile(frames, y0, device="cuda").cpu().numpy()
    outs, _ = FabricSim(chip.config).run(chip.encode_features(feats))
    score = chip.synth.decode_outputs(np.asarray(outs))
    return score, score <= chip.score_threshold_raw


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
@pytest.mark.parametrize("layout", ["bitsliced", "matmul"])
def test_fleet_on_card_equals_the_oracle(card, layout, redundancy):
    """Raw frames of three tenants through a fleet on the card, one slot
    a bucket, so that the third tenant evicts the second and the second
    comes back from its golden image: every delivered event equals its
    tenant's oracle, every ledger closes, the bucket kernels launched."""
    from repro_torch.launch.fleet import TenantFleet
    from repro_torch.launch.readout_server import ServerConfig

    chips, frames, y0 = card
    fleet = TenantFleet(ServerConfig(layout=layout, redundancy=redundancy),
                        bucket_slots=1, device="cuda")
    plan = (("a", 0, 0), ("b", 1, 1), ("c", 1, 0), ("b", 1, 1))
    want, n0 = {}, bs.eval_seg_voted.launches + sum(
        f.launches for f in (le.lut_eval_stacked, le.lut_eval_banded_stacked))
    for k, (tenant, chip, src) in enumerate(plan):
        if not fleet.has_tenant(tenant):
            fleet.admit(tenant, chips[chip])
        lo = 64 * k
        fr, z = frames[src][lo:lo + 64], y0[src][lo:lo + 64]
        score, keep = _card_oracle(chips[chip], fr, z)
        for s, sc, kp in zip(fleet.submit_frames(tenant, fr, z), score, keep):
            want[s] = (tenant, int(sc), bool(kp))
    got = {r.seq: (r.tenant, r.score_raw, r.keep) for r in fleet.flush()}
    torch.cuda.synchronize()
    assert got == want
    rep = fleet.report()
    assert rep["tenants"]["b"]["readmissions"] == 1
    for led in rep["tenants"].values():
        assert led["events_in"] == led["events_out"] and not any(
            led["seu_disagreements"])
    assert bs.eval_seg_voted.launches + sum(
        f.launches for f in (le.lut_eval_stacked,
                             le.lut_eval_banded_stacked)) > n0


def test_warm_fleet_admission_on_card_adds_no_build_or_signature(card):
    """A second tenant admits into a warm bucket on the card with the
    first one's frames pending: no nvcc build, no library load, no new
    launch signature, the stack, encode plan and copy stream kept, and
    both tenants' events exact."""
    from repro_torch.kernels import build
    from repro_torch.launch.fleet import TenantFleet
    from repro_torch.launch.readout_server import ServerConfig

    chips, frames, y0 = card
    fleet = TenantFleet(ServerConfig(), bucket_slots=2, device="cuda:0")
    fleet.admit("a", chips[1])
    fleet.submit_frames("a", frames[1][:128], y0[1][:128])
    fleet.flush()
    torch.cuda.synchronize()
    srv = fleet._buckets[0].server
    path = srv._path
    keep = (path.stack.src.data_ptr(), path.stack.tables.data_ptr(),
            path.frontend.plan["feat_idx"].data_ptr(), path.copy_streams)
    misses = build.miss_counts()
    sa = fleet.submit_frames("a", frames[1][:128], y0[1][:128])
    assert fleet.admit("b", chips[1])["cold"] is False
    sb = fleet.submit_frames("b", frames[1][128:], y0[1][128:])
    got = {r.seq: (r.score_raw, r.keep) for r in fleet.flush()}
    torch.cuda.synchronize()
    assert build.miss_counts() == misses
    assert fleet.report()["admission_misses"] == 0
    assert keep == (path.stack.src.data_ptr(), path.stack.tables.data_ptr(),
                    path.frontend.plan["feat_idx"].data_ptr(),
                    path.copy_streams)
    for seqs, lo in ((sa, 0), (sb, 128)):
        score, kp = _card_oracle(chips[1], frames[1][lo:lo + 128],
                                 y0[1][lo:lo + 128])
        assert [got[s] for s in seqs] == [
            (int(a), bool(b)) for a, b in zip(score, kp)]


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_k2_and_b6_dense_at_the_fleet_envelope(card, redundancy):
    """K2 and B6's dense entry on a stack packed to a 16-level, 31-output
    envelope (the served chips' bucket shape), W=16: both equal their
    plain twins on the same words, and on the CPU's."""
    from repro_torch.core.fabric import StackGeometry

    chips, _, _ = card
    configs = [c.config for c in chips]
    envs = [lut_ops.bucket_envelope(c) for c in configs]
    env = StackGeometry(n_levels=16, max_level_size=max(
        e.max_level_size for e in envs), n_inputs=max(
        e.n_inputs for e in envs), n_outputs=31)
    rng = np.random.default_rng(31)
    bits = rng.integers(0, 2, (2, 512, env.n_inputs))
    thr = torch.as_tensor([c.score_threshold_raw for c in chips],
                          dtype=torch.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        stack = lut_ops.pack_fabrics(configs, redundancy=redundancy,
                                     layout="bitsliced", geometry=env,
                                     device=dev)
        assert (stack.n_levels, stack.n_outputs) == (16, 31)
        b = torch.as_tensor(bits, dtype=torch.int32, device=dev)
        voted, dis = bs.eval_words_voted(
            stack.src, stack.tables, stack.output_nets, b,
            n_replicas=stack.n_replicas, n_inputs=stack.n_inputs,
            in_seg=stack.in_seg)
        weight = torch.as_tensor(lut_ops.decode_plan(configs, 31),
                                 device=dev)
        valid = torch.ones((2, 512), dtype=torch.bool, device=dev)
        dense = sp.decode_dense(voted, dis, weight, thr.to(dev), valid)
        if dev == "cuda":
            seg = bs.input_words(b, stack.n_inputs, stack.in_seg)
            plain = bs.eval_seg_voted_plain(stack.src, stack.tables,
                                            stack.output_nets, seg,
                                            stack.n_replicas)
            for x, y in zip((voted, dis), plain):
                assert torch.equal(x, y)
            for x, y in zip(dense, sp.decode_dense_plain(
                    voted, dis, weight, thr.cuda(), valid)):
                assert torch.equal(x, y)
        runs[dev] = [t.cpu() for t in (voted, dis, *dense)]
    for x, y in zip(runs["cuda"], runs["cpu"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("upset", [False, True])
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
def test_k2_at_the_deep_padded_envelope(card, redundancy, upset):
    """K2 at the deep 4-tree ensemble's fleet bucket, 32 levels x 256 LUTs
    with a 128-word input segment (fault C.3): under TMR the split walk (a
    block a replica, then the vote pass), plain the staged walk; voted and
    disagreement words bit-exact against the plain twin on synthetic stack
    arrays, with one replica's tables upset."""
    R = 3 if redundancy == "tmr" else 1
    C, L, M, in_seg, n_in, O, W = 2, 32, 256, 128, 126, 16, 16
    src, tables, outs = chip_smoke.synthetic_walk_stack(
        torch, np, C, R, L, M, in_seg, n_in, O, seed=20 + R)
    if upset and R > 1:
        tables[1, :, :16, ::3] = 1.0 - tables[1, :, :16, ::3]
    assert bs.walk_path(R, in_seg, L, M) == ("split" if R > 1 else "staged")
    rng = np.random.default_rng(R)
    bits = torch.as_tensor(rng.integers(0, 2, (C, W * 32 - 5, n_in)),
                           dtype=torch.int32, device="cuda")
    seg = bs.input_words(bits, n_in, in_seg)
    n0 = bs.eval_seg_voted.launches
    got = bs.eval_seg_voted(src, tables, outs, seg, R)
    want = bs.eval_seg_voted_plain(src, tables, outs, seg, R)
    assert bs.eval_seg_voted.launches == n0 + 1
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.equal(x, y)
    if upset and R > 1:
        assert bool((got[1] != 0).any())


# (C, L, M, in_seg, n_inputs, O) of a walk envelope: the served 4-chip
# TMR stack's, a 4-tree ensemble's on efpga_28nm_xl (28 x 512) and the
# benchmark's 5-tree ensemble's (ens5xl: 33 x 640, up to 364 input bits,
# 28 outputs)
WALK_ENVELOPES = {"served": (4, 13, 128, 256, 254, 28),
                  "ens4": (4, 28, 512, 384, 364, 28),
                  "ens5xl": (4, 33, 640, 384, 364, 28)}
WALK_FORMS = {("served", 1): "staged", ("served", 3): "staged",
              ("ens4", 1): "staged", ("ens4", 3): "split",
              ("ens5xl", 1): "streamed", ("ens5xl", 3): "streamed"}


@pytest.mark.parametrize("words", [64, 63])
@pytest.mark.parametrize("redundancy", ["none", "tmr"])
@pytest.mark.parametrize("env", sorted(WALK_ENVELOPES))
def test_k2_walk_forms_equal_the_plain_twin(card, env, redundancy, words):
    """K2 in each of its three forms, at the envelope that takes it, on
    synthetic stack arrays: voted and disagreement words bit-exact
    against the plain twin, with one replica's tables upset under TMR
    (the synthetic replicas differ anyway), at 64 words a chip and
    at 63 (not a whole number of tiles on the streamed walk)."""
    R = 3 if redundancy == "tmr" else 1
    C, L, M, in_seg, n_in, O = WALK_ENVELOPES[env]
    src, tables, outs = chip_smoke.synthetic_walk_stack(
        torch, np, C, R, L, M, in_seg, n_in, O, seed=40 + R)
    if R > 1:
        tables[1, :, :16, ::3] = 1.0 - tables[1, :, :16, ::3]
    form = bs.walk_path(R, in_seg, L, M)
    assert form == WALK_FORMS[env, R]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = bs.word_tile(R, in_seg, L, M, words, C, n_sms)
    if form == "streamed":
        assert tile == 2 and (words % tile == 0) == (words == 64)
    rng = np.random.default_rng(R + words)
    bits = torch.as_tensor(rng.integers(0, 2, (C, words * 32 - 5, n_in)),
                           dtype=torch.int32, device="cuda")
    seg = bs.input_words(bits, n_in, in_seg)
    n0 = bs.eval_seg_voted.launches
    got = bs.eval_seg_voted(src, tables, outs, seg, R)
    want = bs.eval_seg_voted_plain(src, tables, outs, seg, R)
    assert bs.eval_seg_voted.launches == n0 + 1
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.equal(x, y)
    if R > 1:
        assert bool((got[1] != 0).any())


@pytest.mark.parametrize("slabs", [1, 2])
def test_k2_walk_forms_of_a_served_stream(card, slabs):
    """A served TMR sparse stream on the card: each slab's stack takes
    the staged walk (``bitsliced.walk_path`` on its shape) at a tile of
    at least one word, its walk launches once a dispatch, and no K2
    event pair is timed."""
    from repro_torch.launch.mesh import ReadoutMesh
    from repro_torch.launch.readout_server import ReadoutServer, ServerConfig

    chips, frames, y0 = card
    server = ReadoutServer(chips, ServerConfig(
        max_batch=512, redundancy="tmr", sparse=True, scrub_interval=4),
        device="cuda",
        mesh=ReadoutMesh((torch.device("cuda:0"),) * slabs))
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for slab, _ in lut_ops.slabs_of(server._path.stack):
        shape = (slab.n_replicas, slab.in_seg, slab.n_levels, slab.m_pad)
        assert bs.walk_path(*shape) == "staged"
        assert bs.word_tile(*shape, frames.shape[1] // 32, slab.n_chips,
                            n_sms) >= 1
    n0 = bs.eval_seg_voted.launches
    for k in range(8):
        for s in range(2):
            server.submit_frames(s, frames[s], y0[s])
        server.poll()
    server.flush()
    assert bs.eval_seg_voted.launches == n0 + 8 * slabs
    st = server.report()["stages"]
    assert st["dispatch_device"]["calls"] == 8 * slabs
    assert "dispatch_device.k2" not in st


def _slab_serve(chips, frames, y0, feats, mesh, device="cuda", **kw):
    """Frames then their features, 128 events a chip each, through a
    server over ``mesh`` (None: one slab on ``device``); {seq: (chip,
    score, keep)}."""
    from repro_torch.launch.readout_server import (ReadoutServer,
                                                   ServerConfig)

    server = ReadoutServer(chips, ServerConfig(**kw), clock=lambda: 0.0,
                           device=device, mesh=mesh)
    for c in range(len(chips)):
        server.submit_frames(c, frames[c % 2][:128], y0[c % 2][:128])
        server.submit_batch(c, feats[c % 2][128:])
    out = {r.seq: (r.chip, r.score_raw, r.keep) for r in server.flush()}
    if server.config.backend == "kernel" and mesh is not None:
        assert [s["device"] for s in server.report()["slabs"]] == [
            str(d) for d in mesh.devices]
    return out


def _cut_at_median(chips, feats):
    """The chips with their cut at the median raw score of their
    features: about half the events kept (the fixture's chips are not
    calibrated)."""
    import dataclasses

    return [dataclasses.replace(c, score_threshold_raw=int(np.median(
        c.infer_raw(feats[i % 2], backend="host"))))
        for i, c in enumerate(chips)]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layout,redundancy,sparse", [
    ("bitsliced", "none", False), ("bitsliced", "tmr", False),
    ("bitsliced", "none", True), ("bitsliced", "tmr", True),
    ("matmul", "tmr", False)])
def test_slab_servers_on_card_equal_one_slab_and_cpu(card, k, layout,
                                                     redundancy, sparse):
    """Four chips split into k slabs on cuda:0 serve every event exactly
    as one slab on the card does; the features half equals the CPU's."""
    from repro_torch.launch.mesh import ReadoutMesh

    chips, frames, y0 = card
    feats = [yp.yprofile(frames[i], y0[i], device="cuda").cpu().numpy()
             .astype(np.float64) for i in range(2)]
    chips4 = _cut_at_median(list(chips) * 2, feats)
    kw = dict(layout=layout, redundancy=redundancy, sparse=sparse)
    dev = torch.device("cuda", 0)
    one = _slab_serve(chips4, frames, y0, feats, ReadoutMesh((dev,)), **kw)
    got = _slab_serve(chips4, frames, y0, feats, ReadoutMesh((dev,) * k),
                      **kw)
    assert got == one and 0 < len(got) <= 4 * 256
    assert sparse or len(got) == 4 * 256
    cpu = _slab_serve(chips4, frames, y0, feats, None, device="cpu", **kw)
    features = {q for q in cpu if q % 256 >= 128}
    assert {q: got[q] for q in features if q in got} == {
        q: cpu[q] for q in features}


def test_each_wrapper_on_a_second_card_while_the_first_is_current(card):
    """Every kernel wrapper launched on cuda:1 tensors while cuda:0 is
    the host thread's current device equals its plain twin: K1, K2 and
    B6's entries through servers on a cuda:1 plan (bit-sliced, dense and
    sparse), B2/B3 through matmul servers, B4 on its own."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the launch under the tensor's "
                    "device shows only on a card other than the current")
    from repro_torch.launch.mesh import ReadoutMesh

    chips, frames, y0 = card
    feats = [yp.yprofile(frames[i], y0[i], device="cuda:0").cpu().numpy()
             .astype(np.float64) for i in range(2)]
    chips = _cut_at_median(chips, feats)
    counters = (yp.yprofile_traced, bs.eval_seg_voted, sp.decode_pack,
                sp.decode_dense, sp.pack_keep_words, le.lut_eval_stacked,
                le.lut_eval_banded_stacked, bdt.bdt_traverse)
    n0 = [f.launches for f in counters]
    with torch.cuda.device(0):
        for layout, sparse, band in (("bitsliced", False, None),
                                     ("bitsliced", True, None),
                                     ("matmul", False, None),
                                     ("matmul", True, False)):
            kw = dict(layout=layout, sparse=sparse, band=band,
                      redundancy="tmr")
            on1 = _slab_serve(chips, frames, y0, feats,
                              ReadoutMesh((torch.device("cuda", 1),)), **kw)
            on0 = _slab_serve(chips, frames, y0, feats,
                              ReadoutMesh((torch.device("cuda", 0),)), **kw)
            cpu = _slab_serve(chips, frames, y0, feats, None, device="cpu",
                              **kw)
            assert on1 == on0 and len(on1) > 0
            assert {q: on1[q] for q in on1 if q % 256 >= 128} == {
                q: cpu[q] for q in cpu if q % 256 >= 128}
        tr, _ = train_test_split(generate(SmartPixelConfig(n_events=12_000,
                                                           seed=5)))
        ens = GradientBoostedClassifier(n_estimators=3, max_depth=5).fit(
            tr["features"], tr["label"]).quantized()
        packed = bdt_ops.pack_ensemble(ens, 14, device="cuda:1")
        x = np.random.default_rng(0).integers(ens.spec.raw_min,
                                              ens.spec.raw_max, (1000, 14))
        got = bdt_ops.bdt_infer(packed, x)
        assert got.device == torch.device("cuda", 1)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      ens.decision_function_raw(x))
        assert torch.cuda.current_device() == 0
    assert all(f.launches > n for f, n in zip(counters, n0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "spec", chip_smoke.encode_specs(),
    ids=lambda sp: f"W{sp.width}-{sp.rounding}-{sp.overflow}")
def test_feature_encode_kernel_equals_twin_and_host_encode(card, spec,
                                                           dtype):
    chip = card[0][1]
    rows = chip_smoke.encode_edge_rows(np, spec).astype(dtype)
    used = torch.as_tensor(chip.synth.used_features, dtype=torch.int32,
                           device="cuda")
    n0 = fenc.encode_rows.launches
    got = fenc.encode_rows(torch.as_tensor(rows, device="cuda"), used,
                           spec).cpu().numpy()
    assert fenc.encode_rows.launches == n0 + 1
    twin = fenc.encode_plain(torch.from_numpy(rows), used.cpu(),
                             spec).numpy()
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(
        got, chip_smoke.host_encode(np, chip, rows, spec))


@functools.lru_cache(maxsize=None)
def _s5_rows():
    """One §5 chunk of feature rows (float32, as the check's come)."""
    return generate(SmartPixelConfig(n_events=65_536, seed=13))["features"]


@pytest.mark.parametrize("layout", [{}, {"band": False},
                                    {"layout": "bitsliced"}],
                         ids=["banded", "dense", "bitsliced"])
def test_section5_chunk_on_card_is_exact_with_one_encode(card, layout):
    chip = card[0][1]
    X = _s5_rows()
    backend = KernelBackend(device="cuda", **layout)
    n0 = fenc.encode_rows.launches
    got = chip.infer_raw(X, backend=backend)
    assert got.dtype == np.int64 and got.shape == (len(X),)
    np.testing.assert_array_equal(got, chip.golden.decision_function_raw(
        chip.golden.quantize_features(X)))
    assert fenc.encode_rows.launches == n0 + 1


@pytest.mark.parametrize("value", [np.nan, -np.inf, 2.0 ** 62, 2.0 ** 63],
                         ids=["nan", "minus_inf", "at_2_62", "at_2_63"])
def test_rows_past_the_int64_cast_on_card_score_as_the_host(card, value):
    chip = card[0][1]
    X = _s5_rows()[:4096].astype(np.float64)
    for i, col in enumerate(chip.synth.used_features):
        X[7 + 11 * i, col] = value / chip.golden.spec.scale
    backend = KernelBackend(device="cuda")
    n0 = fenc.encode_rows.launches
    got = chip.infer_raw(X, backend=backend)
    with np.errstate(invalid="ignore"):
        want = chip.infer_raw(X, backend="host")
    np.testing.assert_array_equal(got, want)
    assert fenc.encode_rows.launches == n0 + 1
