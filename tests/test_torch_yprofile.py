"""The featurizer (K1's plain twin on the CPU) against the JAX package's.

Tolerance |d| <= 2e-5 |x| + 1e-6 ke. Reason: summation order. The JAX
kernel sums each bin's 168 charges as a one-hot dot over the flattened
frame; the port sums over (t, x) directly (the CUDA kernel in yet another
order). The charges carry non-integer Gaussian noise, so the f32 sums
differ in the last bits: measured up to 7.8e-6 relative. The bound
leaves 2.5x headroom in the relative term; the absolute term covers
results near zero. Features within that distance of an ap_fixed step can
quantize to the neighbouring grid point: the test counts and prints those
boundary flips for AP_FIXED_28_19.
"""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels.yprofile import ops as jax_yp  # noqa: E402
from repro_torch.core.quantize import AP_FIXED_28_19, quantize_raw  # noqa: E402
from repro_torch.kernels.yprofile import ops as port_yp  # noqa: E402
from tests._torch_helpers import frames  # noqa: E402

REL, ABS = 2e-5, 1e-6


def _stacked_inputs():
    fr, y0 = frames(512)
    return fr.reshape(2, 256, 8, 13, 21), y0.reshape(2, 256)


def _within(got, want):
    return np.abs(got - want) <= REL * np.abs(want) + ABS


def test_stacked_matches_jax_within_summation_tolerance():
    fr, y0 = _stacked_inputs()
    want = np.asarray(jax.jit(lambda f, z: jax_yp.yprofile_traced(
        f, z, threshold=800.0, batch_tile=128, interpret=True))(
            jnp.asarray(fr), jnp.asarray(y0)))
    got = port_yp.yprofile_traced(torch.as_tensor(fr), torch.as_tensor(y0),
                                  threshold=800.0).numpy()
    assert got.shape == want.shape == (2, 256, 128)
    ok = _within(got, want)
    assert ok.all(), float(np.abs(got - want).max())
    np.testing.assert_array_equal(got[..., 14:], 0.0)
    np.testing.assert_array_equal(got[..., 13], want[..., 13])   # y0 exact
    flips = int((quantize_raw(got[..., :14], AP_FIXED_28_19)
                 != quantize_raw(want[..., :14], AP_FIXED_28_19)).sum())
    print(f"yprofile: max |d| {np.abs(got - want).max():.3g} ke, "
          f"{int((got != want).sum())} of {got[..., :14].size} features "
          f"differ, {flips} AP_FIXED_28_19 boundary flips")
    assert flips <= 0.01 * got[..., :14].size


def test_single_chip_matches_jax_within_tolerance():
    fr, y0 = frames(256)
    want = np.asarray(jax_yp.yprofile(fr, y0, batch_tile=128))
    got = port_yp.yprofile(fr, y0, device="cpu").numpy()
    assert got.shape == want.shape == (256, 14)
    assert _within(got, want).all()


def test_single_chip_path_matches_stacked_row_for_row():
    fr, y0 = _stacked_inputs()
    stacked = port_yp.yprofile_traced(
        torch.as_tensor(fr), torch.as_tensor(y0), threshold=800.0).numpy()
    for c in range(2):
        np.testing.assert_array_equal(
            port_yp.yprofile(fr[c], y0[c], device="cpu").numpy(),
            stacked[c, :, :14])


def test_epilogue_clamps_thresholds_and_divides():
    """Negative bins clamp to 0, bins at or below the threshold zero, the
    rest are divided by 1000 — on hand-made frames with exact sums."""
    fr = np.zeros((1, 3, 8, 13, 21), np.float32)
    fr[0, 0, 0, 2, 0] = -50.0          # negative bin -> 0
    fr[0, 1, :, 4, 0] = 100.0          # 800: at the threshold -> 0
    fr[0, 2, :, 7, :2] = 100.0         # 1600 -> 1.6 ke
    y0 = np.array([[1.5, -2.0, 3.25]], np.float32)
    out = port_yp.yprofile_traced(torch.as_tensor(fr), torch.as_tensor(y0),
                                  threshold=800.0).numpy()[0]
    assert (out[0, :13] == 0).all() and (out[1, :13] == 0).all()
    assert out[2, 7] == np.float32(1600.0) / np.float32(1000.0)
    np.testing.assert_array_equal(out[:, 13], y0[0])

