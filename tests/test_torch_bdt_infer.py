"""Node-parallel BDT inference: port vs JAX, exact.

* ``pack_ensemble`` arrays equal JAX's element for element (one tree and
  a 3-tree ensemble);
* the kernel's plain twin equals JAX's Pallas kernel (interpret mode) on
  the same arrays, all 128 output columns, and ``bdt_infer`` equals
  ``decision_function_raw``, including raw features at the edges of the
  ap_fixed<28,19> range;
* ``bdt_infer`` pads a ragged batch and adds f0 as the reference does;
* both packers' arrays are in the one-hot form the CUDA kernel's tree
  walk takes, and on arrays broken out of it (the synthetic recipes the
  card checks too) the twin still equals JAX's kernel.
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core.bdt import GradientBoostedClassifier as JaxGBC  # noqa: E402
from repro.data.smartpixel import SmartPixelConfig, generate  # noqa: E402
from repro.data.smartpixel import train_test_split  # noqa: E402
from repro.kernels.bdt_infer import ops as jax_ops  # noqa: E402
from repro.kernels.bdt_infer.bdt_infer import bdt_infer_pallas  # noqa: E402
from repro_torch.core.bdt import GradientBoostedClassifier as PortGBC  # noqa: E402
from repro_torch.core.quantize import FixedSpec  # noqa: E402
from repro_torch.kernels.bdt_infer import bdt_infer as port_bdt  # noqa: E402
from repro_torch.kernels.bdt_infer import ops as port_ops  # noqa: E402
from tests._torch_helpers import BDT_RECIPES, broken_one_hot  # noqa: E402

ENSEMBLES = {"tree": (1, 5), "ensemble3": (3, 4)}
_ARRAYS = ("featsel", "thr", "root_onehot", "left", "right", "value_hi",
           "value_lo")
N_EVENTS = 256


@pytest.fixture(scope="module")
def ensembles():
    """Per recipe: (JAX ensemble, port ensemble, JAX packed, raw features
    (test events then extreme raw values), JAX kernel output), in setup."""
    tr, te = train_test_split(generate(SmartPixelConfig(n_events=12_000,
                                                        seed=5)))
    out = {}
    for name, (n_est, depth) in ENSEMBLES.items():
        j = JaxGBC(n_estimators=n_est, max_depth=depth).fit(
            tr["features"], tr["label"]).quantized()
        p = PortGBC(n_estimators=n_est, max_depth=depth).fit(
            tr["features"], tr["label"]).quantized()
        packed = jax_ops.pack_ensemble(j, n_features=14)
        rng = np.random.default_rng(0)
        x = np.concatenate([
            j.quantize_features(te["features"][:N_EVENTS]),
            rng.integers(j.spec.raw_min, j.spec.raw_max, (N_EVENTS, 14)),
        ]).astype(np.int32)
        raw = np.asarray(bdt_infer_pallas(
            jnp.asarray(x), packed.featsel, packed.thr, packed.root_onehot,
            packed.left, packed.right, packed.value_hi, packed.value_lo,
            depth=packed.depth, interpret=True))
        out[name] = (j, p, packed, x, raw)
    return out


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_pack_ensemble_equals_jax(ensembles, name):
    _, ens, jp, _, _ = ensembles[name]
    pp = port_ops.pack_ensemble(ens, 14, device="cpu")
    for k in _ARRAYS:
        want = np.asarray(getattr(jp, k))
        got = getattr(pp, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("f0_raw", "depth", "n_features", "width"):
        assert getattr(pp, k) == getattr(jp, k), k


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_twin_equals_jax_kernel_and_golden(ensembles, name):
    jens, ens, jp, x, raw = ensembles[name]
    pp = port_ops.pack_ensemble(ens, 14, device="cpu")
    xt = torch.as_tensor(x)
    got = port_bdt.bdt_traverse(
        xt, pp.featsel, pp.thr, pp.root_onehot, pp.left, pp.right,
        pp.value_hi, pp.value_lo, depth=pp.depth)
    assert got.dtype == torch.int32 and got.shape == (len(x), 128)
    np.testing.assert_array_equal(got.numpy(), raw)
    want = jens.decision_function_raw(x)
    np.testing.assert_array_equal(port_ops.bdt_infer(pp, x).numpy(), want)
    np.testing.assert_array_equal(ens.decision_function_raw(x), want)


def test_bdt_infer_pads_ragged_batches_like_jax(ensembles):
    jens, ens, jp, x, _ = ensembles["ensemble3"]
    for n in (1, 100, 300):
        got = port_ops.bdt_infer(ens, x[:n], n_features=14, device="cpu")
        assert got.shape == (n,)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_ops.bdt_infer(jp, x[:n])))


def test_pack_ensemble_refuses_wide_specs(ensembles):
    _, ens, _, _, _ = ensembles["tree"]
    wide = PortGBC(n_estimators=1, max_depth=2).fit(
        np.random.default_rng(0).random((400, 14)),
        np.arange(400) % 2).quantized(FixedSpec(32, 16))
    with pytest.raises(ValueError, match="W <= 31"):
        port_ops.pack_ensemble(wide, 14, device="cpu")
    # 3 blocks of 128 events per SM at the §5 chunk; 8-event blocks at
    # the served batch; a block holds the literal path's 4 x P x 8 f32 or
    # the walk's node table and features, whichever is larger
    assert port_bdt.bdt_tile(128, 14, 65536, 132) == 128
    assert port_bdt.bdt_tile(128, 14, 16384, 132) == 32
    assert port_bdt.bdt_tile(128, 14, 512, 132) == 8
    assert port_bdt.smem_bytes(128, 14, 64) == 16384
    assert port_bdt.smem_bytes(128, 200, 64) == 24 * 128 + 16 + 64 * 800
    assert port_bdt.bdt_tile(1816, 14, 512) == 128
    assert port_bdt.bdt_tile(128, 1000, 512) == 32
    with pytest.raises(ValueError, match="shared memory"):
        port_bdt.bdt_tile(4096, 14, 512)


def _walk_form(arrays, n_trees):
    """The precondition of the kernel's walk (csrc/bdt_infer.cu): rows of
    left/right exactly one 1.0, featsel columns 0/1 with at most one 1,
    root 0/1 with one 1 per tree, and every child of a node in the
    segment [root_k, root_k+1) inside that segment."""
    left, right = arrays["left"], arrays["right"]
    featsel, root = arrays["featsel"], arrays["root_onehot"][0]
    for m in (left, right):
        assert set(np.unique(m)) <= {0.0, 1.0}
        assert (m.sum(axis=1) == 1).all()
    assert set(np.unique(featsel)) <= {0, 1}
    assert (featsel.sum(axis=0) <= 1).all()
    assert set(np.unique(root)) <= {0.0, 1.0}
    assert int(root.sum()) == n_trees
    seg = np.cumsum(root) - 1
    for p in np.nonzero(seg >= 0)[0]:
        for m in (left, right):
            assert seg[int(np.argmax(m[p]))] == seg[p], p


@pytest.mark.parametrize("packer", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_packed_arrays_are_in_walk_form(ensembles, name, packer):
    jens, ens, jp, _, _ = ensembles[name]
    packed = jp if packer == "jax" else port_ops.pack_ensemble(
        ens, 14, device="cpu")
    arrays = {k: np.asarray(getattr(packed, k)) for k in _ARRAYS}
    _walk_form(arrays, len(jens.trees))


@pytest.mark.parametrize("recipe", BDT_RECIPES)
@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_twin_equals_jax_kernel_off_the_one_hot_form(ensembles, name,
                                                      recipe):
    """The plain twin equals JAX's Pallas kernel (interpret mode) on
    arrays broken out of the one-hot form, all 128 columns; sums stay
    integers below 2^24, where the summation order does not matter."""
    _, _, jp, x, _ = ensembles[name]
    arrays, xs = broken_one_hot(jp, x[:96], recipe)
    if recipe != "big_leaves":
        with pytest.raises(AssertionError):
            _walk_form(arrays, len(ensembles[name][0].trees))
    want = np.asarray(bdt_infer_pallas(
        jnp.asarray(_pad_rows(xs)), *[jnp.asarray(arrays[k]) for k in _ARRAYS],
        depth=jp.depth, interpret=True))[:len(xs)]
    got = port_bdt.bdt_traverse_plain(
        torch.as_tensor(xs), *[torch.as_tensor(arrays[k]) for k in _ARRAYS],
        depth=jp.depth)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()


def _pad_rows(x, tile=256):
    """x padded with zero rows to the Pallas kernel's batch tile."""
    return np.pad(x, ((0, -len(x) % tile), (0, 0)))
