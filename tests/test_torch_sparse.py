"""Sparse trigger egress and the features path: the port against JAX.

Every input is made with numpy from a seed and goes through both
packages; the tolerance is exact equality throughout:

* the word-domain tail (``bitsliced.mask_words``, ``sign_extended_planes``,
  ``keep_words``, ``lane_scores``, ``disagree_counts_words``) and
  ``ops.decode_keep_words_device`` on random words, with decode weights
  from ``decode_plan`` and synthetic rows (sign at bit 0, at bit 30, no
  negative weight), and kernel B6's plain twin against JAX's
  decode-then-pack;
* kernel B6's dense twin ``decode_dense_plain`` against JAX's
  ``unpack_words`` + ``decode_scores_device`` on random words, for every
  decode row above and arbitrary int32 weights, R = 1 and R = 3, a valid
  tail that ends mid-word and an all-invalid row;
* ``fabric_eval_multi``, ``fabric_eval_multi_scored`` and
  ``fabric_eval_multi_scored_sparse`` on a 2-chip stack, both layouts,
  plain and TMR, on a batch that is not a tile multiple (the re-stride);
* ``FusedFrontend.score_frames_sparse`` and the bit-sliced dense
  ``score_frames_voted`` (routed through B6's dense entry) from the JAX
  featurizer's own features (so the comparison is exact), at B = 128 and
  B = 100;
* the readout server with ``sparse=True`` and on the features path, on
  the served stream of test_torch_server.py: both backends, both
  layouts, plain and TMR, a micro-batch mixing frames and features, the
  report's counters and link bytes (mirroring JAX tests/test_seu.py:415,
  tests/test_bitsliced.py:213, tests/test_readout_server.py:78). Frame
  events may differ only where the two featurizers' quantized features
  differ (summation-order flips, as in test_torch_server.py).
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import frontend as jax_fe  # noqa: E402
from repro.kernels.lut_eval import bitsliced as jax_bs  # noqa: E402
from repro.kernels.lut_eval import ops as jax_ops  # noqa: E402
from repro.kernels.yprofile import ops as jax_yp  # noqa: E402
from repro.launch.mesh import make_readout_mesh  # noqa: E402
from repro.launch.readout_server import ReadoutServer as JaxServer  # noqa: E402
from repro.launch.readout_server import ServerConfig as JaxConfig  # noqa: E402
from repro.parallel import compression as jax_cp  # noqa: E402
from repro_torch.kernels import frontend as port_fe  # noqa: E402
from repro_torch.kernels.lut_eval import bitsliced as port_bs  # noqa: E402
from repro_torch.kernels.lut_eval import ops as port_ops  # noqa: E402
from repro_torch.kernels.sparse_pack import sparse_pack as port_sp  # noqa: E402
from repro_torch.kernels.yprofile import ops as port_yp  # noqa: E402
from repro_torch.launch.readout_server import ReadoutServer, ServerConfig  # noqa: E402
from tests._torch_helpers import (  # noqa: E402
    N_BATCHES,
    N_EVENTS,
    as_int32,
    chip_pair,
    drive,
    flip_seqs,
    frames,
    served_features,
    served_stream,
)

REDUNDANCIES = ("none", "tmr")
LAYOUTS = ("bitsliced", "matmul")
# decode-weight rows: decode_plan of 28/7/1 outputs, and synthetic rows
# with the sign at bit 0, at bit 30 and with no negative weight
WEIGHT_RECIPES = ("plan", "sign_bit0", "sign_bit30", "no_negative")
# the dense decode takes any int32 row, not only two's-complement ones
DENSE_RECIPES = WEIGHT_RECIPES + ("arbitrary",)


def _np(x):
    """A JAX or torch result as numpy; uint32 words as the port's int32."""
    a = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    return a.astype(np.uint32).view(np.int32) if a.dtype == np.uint32 else a


def _weights(recipe, C, O, rng):
    w = np.zeros((C, O), np.int64)
    for c in range(C):
        if recipe == "plan":
            n = (28, 7, 1)[c % 3]
            w[c, :n] = 1 << np.arange(n)
            w[c, n - 1] = -(1 << (n - 1))
        elif recipe == "sign_bit0":
            w[c, 0] = -1
            w[c, 1:] = rng.integers(0, 2, O - 1)
        elif recipe == "sign_bit30":
            w[c, :30] = 1 << np.arange(30)
            w[c, 30] = -(1 << 30)
        elif recipe == "arbitrary":
            w[c] = rng.integers(-2**31, 2**31, O)
        else:
            w[c] = rng.integers(0, 4, O)
    return w.astype(np.int32)


@pytest.fixture(scope="module", params=WEIGHT_RECIPES)
def words(request):
    """Random voted/disagreement words, decode rows, cuts and a valid mask
    with a tail that ends mid-word; and JAX's tail on them."""
    rng = np.random.default_rng(WEIGHT_RECIPES.index(request.param))
    C, W, O, R, B = 3, 4, 32, 3, 117
    voted = rng.integers(0, 2**32, (C, W, O), dtype=np.uint64).astype(
        np.uint32)
    dis = rng.integers(0, 2**32, (C, R, W), dtype=np.uint64).astype(np.uint32)
    weight = _weights(request.param, C, O, rng)
    thr = rng.integers(-2**31, 2**31, C).astype(np.int32)
    thr[0] = 0
    valid = rng.random((C, B)) < 0.9
    args = (voted, dis, weight, thr, valid)
    jax_args = [jnp.asarray(a) for a in args]
    valid_w = jax_bs.mask_words(jax_args[4])
    planes = jax_bs.sign_extended_planes(jax_args[0], jax_args[2])
    want = {
        "valid_w": valid_w, "planes": planes,
        "keep_w": jax_bs.keep_words(planes, jax_args[3], valid_w),
        "scores": jax_bs.lane_scores(planes),
        "dis": jax_bs.disagree_counts_words(jax_args[1], valid_w),
        "decode": jax_ops.decode_keep_words_device(*jax_args),
    }
    want["pack"] = jax_cp.sparse_trigger_pack_words(want["keep_w"],
                                                    want["scores"])
    want = {k: ([_np(x) for x in v] if isinstance(v, tuple) else _np(v))
            for k, v in want.items()}
    port = (torch.as_tensor(as_int32(voted)), torch.as_tensor(as_int32(dis)),
            torch.as_tensor(weight), torch.as_tensor(thr),
            torch.as_tensor(valid))
    return port, want


def test_word_tail_equals_jax(words):
    (voted, dis, weight, thr, valid), want = words
    valid_w = port_bs.mask_words(valid)
    planes = port_bs.sign_extended_planes(voted, weight)
    np.testing.assert_array_equal(_np(valid_w), want["valid_w"])
    np.testing.assert_array_equal(_np(planes), want["planes"])
    keep_w = port_bs.keep_words(planes, thr, valid_w)
    np.testing.assert_array_equal(_np(keep_w), want["keep_w"])
    np.testing.assert_array_equal(_np(port_bs.lane_scores(planes)),
                                  want["scores"])
    np.testing.assert_array_equal(
        _np(port_bs.disagree_counts_words(dis, valid_w)), want["dis"])
    for g, w in zip(port_ops.decode_keep_words_device(voted, dis, weight,
                                                      thr, valid),
                    want["decode"]):
        np.testing.assert_array_equal(_np(g), w)


def test_b6_twin_equals_jax_decode_then_pack(words):
    """kernel B6's plain twin (and its CPU wrapper) against JAX's
    decode_keep_words_device followed by sparse_trigger_pack_words."""
    args, want = words
    n0 = port_sp.decode_pack.launches
    for got in (port_sp.decode_pack_plain(*args), port_sp.decode_pack(*args)):
        for g, w in zip(got, want["pack"] + [want["decode"][2]]):
            np.testing.assert_array_equal(_np(g), w)
    assert port_sp.decode_pack.launches == n0       # no launch on the CPU


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("recipe", DENSE_RECIPES)
def test_b6_dense_twin_equals_jax_unpack_then_decode(recipe, R):
    """kernel B6's dense twin (and its CPU wrapper) against JAX's
    unpack_words + decode_scores_device: random words, a valid tail that
    ends 21 events into the last word, chip 1 with no valid event."""
    rng = np.random.default_rng(100 + 10 * R + DENSE_RECIPES.index(recipe))
    C, W, O, B = 3, 4, 32, 117
    voted = rng.integers(0, 2**32, (C, W, O), dtype=np.uint64).astype(
        np.uint32)
    dis = rng.integers(0, 2**32, (C, R, W), dtype=np.uint64).astype(np.uint32)
    weight = _weights(recipe, C, O, rng)
    thr = rng.integers(-2**31, 2**31, C).astype(np.int32)
    thr[0] = 0
    valid = rng.random((C, B)) < 0.9
    valid[1] = False
    want = jax_ops.decode_scores_device(
        jax_bs.unpack_words(jnp.asarray(voted), B),
        jax_bs.unpack_words(jnp.asarray(dis)[..., None], B)[..., 0].astype(
            bool),
        jnp.asarray(weight), jnp.asarray(thr), jnp.asarray(valid))
    args = (torch.as_tensor(as_int32(voted)), torch.as_tensor(as_int32(dis)),
            torch.as_tensor(weight), torch.as_tensor(thr),
            torch.as_tensor(valid))
    n0 = port_sp.decode_dense.launches
    for got in (port_sp.decode_dense_plain(*args),
                port_sp.decode_dense(*args)):
        for g, w, what in zip(got, want, ("score", "keep", "dis")):
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=what)
        assert got[1].dtype == torch.bool and got[2].shape == (C, R)
        assert not bool(got[1][1].any()) and not bool(got[2][1].any())
    assert port_sp.decode_dense.launches == n0      # no launch on the CPU


@pytest.mark.parametrize("B", [1, 31, 32, 70])
def test_mask_words_tails_equal_jax(B):
    mask = np.random.default_rng(B).random((2, B)) < 0.5
    np.testing.assert_array_equal(
        _np(port_bs.mask_words(torch.as_tensor(mask))),
        _np(jax_bs.mask_words(jnp.asarray(mask))))


# ----------------------------------------------------- multi-chip scoring
MULTI_B = 100            # not a batch_tile multiple: the re-stride path


@pytest.fixture(scope="module")
def multi():
    """2 chips, seeded bits/valid, and JAX's multi-chip results for both
    layouts and redundancies, in setup."""
    pairs = [chip_pair("efpga_130nm"), chip_pair("efpga_28nm")]
    rng = np.random.default_rng(21)
    per_chip = [rng.integers(0, 2, (MULTI_B - 13 * i, p[0].config.n_inputs))
                .astype(np.uint8) for i, p in enumerate(pairs)]
    valid = rng.random((2, MULTI_B)) < 0.85
    thr = np.array([p[0].score_threshold_raw for p in pairs], np.int32)
    mesh = make_readout_mesh(2)
    want = {}
    for layout in LAYOUTS:
        for red in REDUNDANCIES:
            st = jax_ops.pack_fabrics([p[0].config for p in pairs],
                                      redundancy=red, layout=layout)
            bits = jax_ops.stack_input_bits(st, per_chip)
            weight = jax_ops.decode_plan([p[0].config for p in pairs],
                                         st.n_outputs)
            args = (st, bits, weight, thr, valid)
            r = {"multi": _np(jax_ops.fabric_eval_multi(st, bits)),
                 "scored": [_np(x) for x in jax_ops.fabric_eval_multi_scored(
                     *args, mesh=mesh)]}
            if layout == "bitsliced":
                r["sparse"] = [_np(x) for x in
                               jax_ops.fabric_eval_multi_scored_sparse(
                                   *args, mesh=mesh)]
            want[layout, red] = (bits, weight, r)
    return pairs, per_chip, valid, thr, want


@pytest.mark.parametrize("red", REDUNDANCIES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fabric_eval_multi_family_equals_jax(multi, layout, red):
    pairs, per_chip, valid, thr, want = multi
    jax_bits, weight, r = want[layout, red]
    st = port_ops.pack_fabrics([p[1].config for p in pairs], redundancy=red,
                               layout=layout, device="cpu")
    bits = port_ops.stack_input_bits(st, per_chip)
    np.testing.assert_array_equal(bits, jax_bits)
    np.testing.assert_array_equal(
        port_ops.decode_plan([p[1].config for p in pairs], st.n_outputs),
        weight)
    np.testing.assert_array_equal(_np(port_ops.fabric_eval_multi(st, bits)),
                                  r["multi"])
    np.testing.assert_array_equal(
        _np(port_ops.fabric_eval_multi(st, per_chip)), r["multi"])
    args = (st, bits, weight, thr, valid)
    for g, w in zip(port_ops.fabric_eval_multi_scored(*args), r["scored"]):
        np.testing.assert_array_equal(_np(g), w)
    if layout == "matmul":
        with pytest.raises(ValueError, match="bitsliced"):
            port_ops.fabric_eval_multi_scored_sparse(*args)
        return
    got = port_ops.fabric_eval_multi_scored_sparse(*args)
    assert got[1].shape == (2 * MULTI_B,)
    for g, w, what in zip(got, r["sparse"], ("count", "idx", "vals", "dis")):
        np.testing.assert_array_equal(_np(g), w, err_msg=what)


def test_matmul_stack_has_no_sparse_form_in_either_package(multi):
    pairs, per_chip, valid, thr, want = multi
    jax_bits, weight, _ = want["matmul", "none"]
    st = jax_ops.pack_fabrics([p[0].config for p in pairs])
    with pytest.raises(ValueError, match="bitsliced"):
        jax_ops.fabric_eval_multi_scored_sparse(
            st, jax_bits, weight, thr, valid, mesh=make_readout_mesh(2))
    pst = port_ops.pack_fabrics([p[1].config for p in pairs], device="cpu")
    with pytest.raises(ValueError, match="bitsliced"):
        port_ops.fabric_eval_multi_scored_sparse(pst, jax_bits, weight, thr,
                                                 valid)


# ------------------------------------------------------ fused frontend
@pytest.fixture(scope="module")
def frontend_sparse():
    """2 chips' frames and JAX's sparse fused pass at B = 128 and 100,
    with the JAX featurizer's features of the padded frames."""
    pairs = [chip_pair("efpga_28nm"), chip_pair("efpga_130nm")]
    fr, y0 = frames(256)
    fr, y0 = fr.reshape(2, 128, 8, 13, 21), y0.reshape(2, 128)
    feats = np.array(jax_yp.yprofile_traced(
        jnp.asarray(fr), jnp.asarray(y0), threshold=800.0, batch_tile=128,
        interpret=True))
    want = {}
    for red in REDUNDANCIES:
        jf = jax_fe.pack_frontend([p[0].config for p in pairs],
                                  [p[0].frontend_spec() for p in pairs],
                                  layout="bitsliced", redundancy=red)
        for B in (128, 100):
            valid = np.ones((2, B), bool)
            valid[1, B - 9:] = False
            want[red, B] = [_np(x) for x in jf.score_frames_sparse(
                fr[:, :B], y0[:, :B], valid=valid)]
            want[red, B, "dense"] = [_np(x) for x in jf.score_frames_voted(
                fr[:, :B], y0[:, :B], valid=valid)]
    return pairs, fr, y0, feats, want


@pytest.mark.parametrize("B", [128, 100])
@pytest.mark.parametrize("red", REDUNDANCIES)
def test_score_frames_sparse_equals_jax(frontend_sparse, monkeypatch, red,
                                        B):
    """The port's sparse fused pass, its featurizer stage handed the JAX
    featurizer's features (the tile-padded rows are featurized zeros in
    both), equals JAX's bit for bit, the Bp != B re-stride included; and
    it equals the port's own dense pass, packed."""
    pairs, fr, y0, feats, want = frontend_sparse
    monkeypatch.setattr(port_yp, "yprofile_traced",
                        lambda f, z, threshold: torch.as_tensor(feats))
    pf = port_fe.pack_frontend([p[1].config for p in pairs],
                               [p[1].frontend_spec() for p in pairs],
                               layout="bitsliced", redundancy=red,
                               device="cpu")
    valid = np.ones((2, B), bool)
    valid[1, B - 9:] = False
    got = pf.score_frames_sparse(fr[:, :B], y0[:, :B], valid=valid)
    for g, w, what in zip(got, want[red, B], ("count", "idx", "vals", "dis")):
        np.testing.assert_array_equal(_np(g), w, err_msg=what)
    score, keep, dis = pf.score_frames_voted(fr[:, :B], y0[:, :B],
                                             valid=valid)
    packed = jax_cp.sparse_trigger_pack(jnp.asarray(score.numpy()),
                                        jnp.asarray(keep.numpy()))
    for g, w in zip(got, [*packed, dis]):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("B", [128, 100])
@pytest.mark.parametrize("red", REDUNDANCIES)
def test_bitsliced_dense_frames_route_through_b6_and_equal_jax(
        frontend_sparse, monkeypatch, red, B):
    """The bit-sliced dense fused pass takes the walk's words to B6's
    dense entry (once a dispatch) and, from the JAX featurizer's features,
    equals JAX's score_frames_voted bit for bit."""
    pairs, fr, y0, feats, want = frontend_sparse
    monkeypatch.setattr(port_yp, "yprofile_traced",
                        lambda f, z, threshold: torch.as_tensor(feats))
    calls = []
    dense = port_sp.decode_dense
    monkeypatch.setattr(port_sp, "decode_dense",
                        lambda *a, **k: calls.append(k) or dense(*a, **k))
    pf = port_fe.pack_frontend([p[1].config for p in pairs],
                               [p[1].frontend_spec() for p in pairs],
                               layout="bitsliced", redundancy=red,
                               device="cpu")
    valid = np.ones((2, B), bool)
    valid[1, B - 9:] = False
    got = pf.score_frames_voted(fr[:, :B], y0[:, :B], valid=valid)
    assert calls == [{}]
    for g, w, what in zip(got, want[red, B, "dense"],
                          ("score", "keep", "dis")):
        np.testing.assert_array_equal(_np(g), w, err_msg=what)


def test_score_frames_sparse_needs_the_word_layout(frontend_sparse):
    pairs, fr, y0, _, _ = frontend_sparse
    pf = port_fe.pack_frontend([p[1].config for p in pairs],
                               [p[1].frontend_spec() for p in pairs],
                               device="cpu")
    with pytest.raises(ValueError, match="bitsliced"):
        pf.score_frames_sparse(fr[:, :8], y0[:, :8])


# ------------------------------------------------------------- servers
@pytest.fixture(scope="module")
def jax_runs():
    """The JAX server on the served stream: sparse frames (kernel
    backend, bit-sliced and matmul layouts), and the features path and a
    mixed frames+features stream, dense and sparse (host backend, which
    the JAX package holds bit-identical to its kernel backend)."""
    pairs, swap, blocks = served_stream()
    feats = served_features()
    runs = {}
    for red in REDUNDANCIES:
        for layout in LAYOUTS:
            server = JaxServer([p[0] for p in pairs], JaxConfig(
                redundancy=red, layout=layout, sparse=True),
                clock=lambda: 0.0)
            runs["frames", layout, red] = drive(server, swap[0], blocks)
        for sparse in (False, True):
            cfg = JaxConfig(backend="host", redundancy=red, sparse=sparse)
            server = JaxServer([p[0] for p in pairs], cfg, clock=lambda: 0.0)
            runs["features", sparse, red] = drive(
                server, swap[0], blocks, features=feats, frames=False)
            server = JaxServer([p[0] for p in pairs], cfg, clock=lambda: 0.0)
            runs["mixed", sparse, red] = drive(server, swap[0], blocks,
                                               features=feats)
    return runs


def _port(backend="kernel", layout=None, red="none", sparse=True):
    pairs = served_stream()[0]
    return ReadoutServer([p[1] for p in pairs], ServerConfig(
        backend=backend, layout=layout, redundancy=red, sparse=sparse),
        clock=lambda: 0.0, device="cpu")


def _link_bytes(batches_kept, n_events):
    """The report's link bytes: a sparse batch adds the count word and 8
    bytes a kept event, every batch 5 bytes an event to dense."""
    wire = sum(4 + 8 * k for k in batches_kept)
    return {"on_wire": wire, "dense_equivalent": 5 * n_events,
            "wire_reduction": 5 * n_events / wire}


def _agree_up_to_flips(got, rep, want, jrep, flips):
    diff = {q for q in set(got) | set(want) if got.get(q) != want.get(q)}
    assert diff <= flips, sorted(diff - flips)[:10]
    for c, (pc, jc) in enumerate(zip(rep["per_chip"], jrep["per_chip"])):
        assert pc["n_in"] == jc["n_in"]
        assert pc["seu_disagreements"] == jc["seu_disagreements"]
        kept_diff = (sum(1 for q in diff if q in got and got[q][0] == c)
                     - sum(1 for q in diff if q in want and want[q][0] == c))
        assert pc["n_kept"] - jc["n_kept"] == kept_diff
    return diff


@pytest.mark.parametrize("red", REDUNDANCIES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sparse_frames_server_matches_jax(jax_runs, layout, red):
    """sparse=True on frames: the bit-sliced stack packs through the word
    path (K2 then B6's decode entry), the matmul one through the
    event-domain pack (B6's keep-words entry). Only kept events are
    returned; they and the counters agree with JAX's up to featurizer
    flips, and the kept set is the port's own dense run's."""
    pairs, swap, blocks = served_stream()
    server = _port(layout=layout, red=red)
    got, rep = drive(server, swap[1], blocks)
    want, jrep = jax_runs["frames", layout, red]
    assert all(keep for _, _, keep in got.values())
    diff = _agree_up_to_flips(got, rep, want, jrep,
                              flip_seqs(pairs, swap[1], blocks))
    dense, drep = drive(_port(layout=layout, red=red, sparse=False),
                        swap[1], blocks)
    assert got == {q: v for q, v in dense.items() if v[2]}
    assert [c["n_kept"] for c in rep["per_chip"]] == [
        c["n_kept"] for c in drep["per_chip"]]
    # one batch before the swap, one after it (frozen clock)
    kept = [sum(1 for q in got if q < 2 * N_EVENTS),
            sum(1 for q in got if q >= 2 * N_EVENTS)]
    assert rep["link_bytes"] == _link_bytes(kept, 2 * N_BATCHES * N_EVENTS)
    if not diff:
        assert rep["link_bytes"] == jrep["link_bytes"]
    assert "sparse_pack" in rep["stages"] or layout == "bitsliced"
    assert rep["seu_disagreement_total"] == 0


@pytest.mark.parametrize("red", REDUNDANCIES)
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("backend,layout", [
    ("kernel", "bitsliced"), ("kernel", "matmul"), ("host", None)])
def test_features_server_matches_jax(jax_runs, backend, layout, sparse, red):
    """The features path (submit_batch of host features) in every backend
    and layout, dense and sparse: every event and every counter equal the
    JAX server's exactly, link bytes included."""
    pairs, swap, blocks = served_stream()
    got, rep = drive(_port(backend, layout, red, sparse), swap[1], blocks,
                     features=served_features(), frames=False)
    want, jrep = jax_runs["features", sparse, red]
    assert got == want
    assert len(got) < 2 * N_BATCHES * N_EVENTS if sparse else len(got) == (
        2 * N_BATCHES * N_EVENTS)
    for pc, jc in zip(rep["per_chip"], jrep["per_chip"]):
        for k in ("n_in", "n_kept", "n_dispatches", "seu_disagreements"):
            assert pc[k] == jc[k], k
    assert rep["link_bytes"] == jrep["link_bytes"]
    assert {"encode_host", "launch_score"} <= set(rep["stages"])


@pytest.mark.parametrize("sparse", [False, True])
def test_mixed_frames_and_features_batch_matches_jax(jax_runs, sparse):
    """Micro-batches holding both kinds score as two passes; the events
    and counters agree with JAX's (frame events up to featurizer flips,
    feature events exactly), and sparse drains one header per pass."""
    pairs, swap, blocks = served_stream()
    server = _port("kernel", None, "tmr", sparse)
    got, rep = drive(server, swap[1], blocks, features=served_features())
    want, jrep = jax_runs["mixed", sparse, "tmr"]
    flips = flip_seqs(pairs, swap[1], blocks, with_features=True)
    diff = _agree_up_to_flips(got, rep, want, jrep, flips)
    assert rep["stages"]["launch_fused"]["calls"] == 2
    assert rep["stages"]["launch_score"]["calls"] == 2
    if sparse:
        n_kept = rep["n_kept"]
        assert rep["link_bytes"]["on_wire"] == 4 * 4 + 8 * n_kept
    if not diff:
        assert rep["link_bytes"] == jrep["link_bytes"]
