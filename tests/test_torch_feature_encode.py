"""The §5 check's device encode and decode (kernels/feature_encode.py,
``KernelBackend.encode_features`` / ``decode_outputs``) on the CPU,
held to the JAX package.

The feature encode's plain twin equals the JAX package's host encode
(``SynthResult.encode_inputs(quantize_raw(X, spec))``) bit for bit over
every rounding and overflow mode, widths 8, 28 and 40, float32 and
float64 rows, values on the grid's half steps, negative values, values
at and across ``raw_min`` and ``raw_max``, and values where numpy's
float -> int64 cast is exact near its ends or gives INT64_MIN (NaN,
+-inf, past +-2**63). ``infer_raw`` on ``KernelBackend(device="cpu")``
equals the JAX chip's ``infer_raw(X, backend="host")`` and its golden
model in every layout, on such rows too. The kernel itself is held to
the twin on the card (tests/test_torch_kernels_cuda.py).
"""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro.core.quantize import FixedSpec as JaxSpec  # noqa: E402
from repro.core.quantize import quantize_raw as jax_quantize_raw  # noqa: E402
from repro_torch.core.quantize import FixedSpec  # noqa: E402
from repro_torch.core.readout import KernelBackend  # noqa: E402
from repro_torch.data.smartpixel import (SmartPixelConfig, generate,  # noqa: E402
                                         train_test_split)
from repro_torch.kernels import feature_encode  # noqa: E402
from tests._torch_helpers import chip_pair  # noqa: E402

WIDTHS = chip_smoke.ENCODE_WIDTHS         # width -> int_bits
LAYOUTS = {"banded": {}, "dense": {"band": False},
           "bitsliced": {"layout": "bitsliced"}}


def _chips():
    """(JAX chip, port chip) of the paper's tree (depth 5, 10 leaves),
    trained identically."""
    return chip_pair("efpga_28nm", depth=5, leaves=10)


@functools.lru_cache(maxsize=None)
def _rows():
    return train_test_split(generate(SmartPixelConfig(
        n_events=8_000, seed=2024)))[1]["features"][:2048]


def _jax_encode(jax_chip, X, spec: FixedSpec) -> np.ndarray:
    """The JAX package's host encode of ``X`` under ``spec``."""
    jspec = JaxSpec(spec.width, spec.int_bits, spec.rounding, spec.overflow)
    synth = dataclasses.replace(jax_chip.synth, spec=jspec)
    with np.errstate(invalid="ignore"):
        return synth.encode_inputs(jax_quantize_raw(X, jspec))


def _jax_scores(jax_chip, X):
    """The JAX chip's host check and its golden model on ``X``, equal."""
    with np.errstate(invalid="ignore"):
        want = jax_chip.infer_raw(X, backend="host")
        golden = jax_chip.golden.decision_function_raw(
            jax_chip.golden.quantize_features(X))
    np.testing.assert_array_equal(want, golden)
    return want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("overflow", ["wrap", "sat"])
@pytest.mark.parametrize("rounding", ["trn", "rnd"])
def test_twin_equals_the_host_encode(rounding, overflow, width, dtype):
    jax_chip, port_chip = _chips()
    assert list(port_chip.synth.used_features) == list(
        jax_chip.synth.used_features)
    spec = FixedSpec(width, WIDTHS[width], rounding, overflow)
    X = chip_smoke.encode_edge_rows(np, spec).astype(dtype)
    want = _jax_encode(jax_chip, X, spec)
    used = torch.as_tensor(port_chip.synth.used_features, dtype=torch.int32)
    got = feature_encode.encode_rows(torch.from_numpy(X), used, spec)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full_like(got, 7)
    assert feature_encode.encode_rows(torch.from_numpy(X), used, spec,
                                      out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_infer_raw_on_the_kernel_backend_equals_host_and_golden(layout,
                                                                dtype):
    jax_chip, port_chip = _chips()
    X = _rows().astype(dtype)
    backend = KernelBackend(device="cpu", **LAYOUTS[layout])
    got = port_chip.infer_raw(X, backend=backend)
    assert got.dtype == np.int64 and got.shape == (len(X),)
    np.testing.assert_array_equal(got, _jax_scores(jax_chip, X))
    np.testing.assert_array_equal(got, port_chip.infer_raw(X,
                                                           backend="host"))


# x * scale put into one row's feature: a used one's or one the fabric
# does not read
CAST_CASES = {
    "nan": (np.nan, "used"),
    "inf": (np.inf, "used"),
    "minus_inf": (-np.inf, "used"),
    "at_2_62": (2.0 ** 62, "used"),
    "minus_2_62": (-(2.0 ** 62), "used"),
    "below_2_63": (2.0 ** 63 - 2.0 ** 10, "used"),
    "at_2_63": (2.0 ** 63, "used"),
    "minus_2_63": (-(2.0 ** 63), "used"),
    "past_minus_2_63": (-(2.0 ** 63) - 2.0 ** 11, "used"),
    "nan_unused": (np.nan, "unused"),
}


@pytest.mark.parametrize("case", sorted(CAST_CASES))
def test_rows_past_the_int64_cast_score_as_the_host_does(case):
    """A feature whose x * scale numpy casts to INT64_MIN (NaN, +-inf,
    past +-2**63), or casts exactly near those ends, scores on the
    kernel backend as the JAX chip's host check scores it."""
    value, column = CAST_CASES[case]
    jax_chip, port_chip = _chips()
    used = port_chip.synth.used_features
    X = _rows()[:512].astype(np.float64)
    for i, col in enumerate(used):
        if column == "unused":
            col = min(set(range(X.shape[1])) - set(used))
        X[7 + 11 * i, col] = value / port_chip.golden.spec.scale
    got = port_chip.infer_raw(X, backend=KernelBackend(device="cpu"))
    np.testing.assert_array_equal(got, _jax_scores(jax_chip, X))


def test_chunks_of_changing_length_reuse_the_bits_buffer():
    """The backend's bits buffer grows to the longest chunk and serves a
    shorter one from its head; every chunk scores as the JAX host."""
    jax_chip, port_chip = _chips()
    X = _rows()
    backend = KernelBackend(device="cpu")
    for n in (512, 2048, 300, 2048):
        got = port_chip.infer_raw(X[:n], backend=backend)
        np.testing.assert_array_equal(got, _jax_scores(jax_chip, X[:n]))
    plan = backend._check_plans.get(port_chip.config)
    assert tuple(plan.bits.shape) == (
        2048, len(port_chip.synth.used_features) * port_chip.synth.spec.width)
