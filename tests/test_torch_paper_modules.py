"""The paper's leftover modules in the port, each against the JAX
package's on the same inputs.

* ``core/verilog.py``: the same structural Verilog, byte for byte, for the
  netlists of every registered fabric's chip;
* ``core/power.py``: equal numbers from every function and ``sweep``;
* ``core/nn_baseline.py``: ``lut_cost`` / ``dsp_schedule`` equal;
  ``mlp_logits`` / ``mlp_proba`` on carried parameters within 1e-6
  (the logits relative and absolute: float32 sums in another order);
  ``train_mlp`` from the JAX initial parameters (the test patches the
  port's ``init_mlp``) on the same numpy minibatches, for 1 and 30 steps,
  within the tolerances stated at ``TRAIN_TOL``;
* ``core/quantize.py``'s three device helpers bit-identical to their JAX
  twins over random floats and int32s, saturation and wrap edges
  included, for AP_FIXED_28_19 and 16-bit specs;
* ``examples/torch_smartpixel_readout.py --device cpu`` in-process.
"""
import importlib.util
import pathlib

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import nn_baseline as jax_nb  # noqa: E402
from repro.core import power as jax_power  # noqa: E402
from repro.core import quantize as jax_q  # noqa: E402
from repro.core import verilog as jax_verilog  # noqa: E402
from repro_torch.core import nn_baseline as port_nb  # noqa: E402
from repro_torch.core import power as port_power  # noqa: E402
from repro_torch.core import quantize as port_q  # noqa: E402
from repro_torch.core import verilog as port_verilog  # noqa: E402
from tests._torch_helpers import FABRIC_RECIPES, chip_pair  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("fabric", sorted(FABRIC_RECIPES))
def test_to_verilog_is_byte_identical(fabric):
    jchip, pchip = chip_pair(fabric)
    for name in ("readout_module", f"chip_{fabric}"):
        got = port_verilog.to_verilog(pchip.synth.netlist, name)
        want = jax_verilog.to_verilog(jchip.synth.netlist, name)
        assert got == want
    assert got.count("LUT4 #") == pchip.config.n_luts


@pytest.mark.parametrize("node", ["130nm", "28nm"])
def test_power_model_numbers_are_equal(node):
    assert port_power.sweep(node) == jax_power.sweep(node)
    freqs = [1.0, 10.0, 74.0, 100.0, 125.0, 137.5, 250.0]
    assert port_power.sweep(node, freqs) == jax_power.sweep(node, freqs)
    for f in freqs:
        for rail in ("core", "io"):
            assert port_power.power_mw(node, f, rail) == \
                jax_power.power_mw(node, f, rail)
        assert port_power.total_power_mw(node, f) == \
            jax_power.total_power_mw(node, f)
        assert port_power.core_power_ratio(f) == jax_power.core_power_ratio(f)
        for cycles in (1, 13):
            assert port_power.energy_per_inference_nj(node, f, cycles) == \
                jax_power.energy_per_inference_nj(node, f, cycles)
    assert port_power.area_efficiency_ratio() == \
        jax_power.area_efficiency_ratio()
    assert port_power.NODES[node].equiv_logic == \
        jax_power.NODES[node].equiv_logic


SPECS = [(14, 8, 4, 1), (14, 16, 8, 1), (14, 1), (14, 32, 16, 8, 1)]


@pytest.mark.parametrize("sizes", SPECS)
def test_lut_cost_and_dsp_schedule_are_equal(sizes):
    for bits in ((8, 8, 16), (6, 10, 20)):
        kw = dict(layer_sizes=sizes, weight_bits=bits[0], act_bits=bits[1],
                  acc_bits=bits[2])
        assert port_nb.lut_cost(port_nb.MLPSpec(**kw)) == \
            jax_nb.lut_cost(jax_nb.MLPSpec(**kw))
        for n_dsp, mhz in ((4, 200.0), (1, 50.0)):
            assert port_nb.dsp_schedule(port_nb.MLPSpec(**kw), n_dsp, mhz) \
                == jax_nb.dsp_schedule(jax_nb.MLPSpec(**kw), n_dsp, mhz)


def _carried(jparams):
    return [{"w": torch.tensor(np.asarray(p["w"])),
             "b": torch.tensor(np.asarray(p["b"]))} for p in jparams]


@pytest.mark.parametrize("sizes", SPECS)
def test_mlp_logits_and_proba_on_carried_parameters(sizes):
    spec = jax_nb.MLPSpec(layer_sizes=sizes)
    jparams = jax_nb.init_mlp(jax.random.PRNGKey(3), spec)
    for p in jparams:       # nonzero biases, so they are read too
        p["b"] = p["b"] + 0.1
    model = port_nb.MLP(_carried(jparams))
    rng = np.random.default_rng(3)
    X = rng.normal(size=(257, sizes[0]))
    norm = {"mu": X.mean(0, keepdims=True), "sd": X.std(0, keepdims=True)}
    want = np.asarray(jax_nb.mlp_logits(jparams, X.astype(np.float32)))
    got = port_nb.mlp_logits(model, torch.as_tensor(X, dtype=torch.float32))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        port_nb.mlp_proba(model, norm, X), jax_nb.mlp_proba(jparams, norm, X),
        rtol=0, atol=1e-6)


def test_init_mlp_layout_and_generator():
    spec = port_nb.MLPSpec()
    a = port_nb.init_mlp(torch.Generator().manual_seed(1), spec, device="cpu")
    b = port_nb.init_mlp(torch.Generator().manual_seed(1), spec, device="cpu")
    shapes = [tuple(p["w"].shape) for p in a.layers()]
    assert shapes == [(14, 8), (8, 4), (4, 1)]
    for p, q in zip(a.layers(), b.layers()):
        assert torch.equal(p["w"], q["w"]) and not bool(p["b"].any())


# (steps, loss tolerance, parameter tolerance). One step holds the
# update's formula to float32 rounding. Over 30 steps the two sides'
# rounding (summation order of the gradients) grows where a gradient
# element is near zero: Adam's early steps move a parameter by about lr
# whatever the gradient's size (the last layer's bias, whose gradient is
# mean(sigmoid(z) - y), differs by 9e-6 after 2 steps and 7e-4 after 30,
# against a total move of 0.08).
TRAIN_TOL = [(1, 1e-6, 2e-7), (30, 5e-5, 2e-3)]


@pytest.mark.parametrize("steps,loss_tol,param_tol", TRAIN_TOL)
def test_train_mlp_from_carried_init_matches_jax(monkeypatch, steps,
                                                 loss_tol, param_tol):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(6_000, 14)) * np.linspace(0.5, 40.0, 14)
    y = (X[:, 0] + 0.05 * X[:, 5] + rng.normal(size=6_000) > 0).astype(
        np.float32)
    spec = jax_nb.MLPSpec()
    kw = dict(steps=steps, batch=512, lr=3e-3, seed=11)
    jparams, jnorm, jloss = jax_nb.train_mlp(X, y, spec, **kw)
    init = _carried(jax_nb.init_mlp(jax.random.PRNGKey(kw["seed"]), spec))
    monkeypatch.setattr(port_nb, "init_mlp",
                        lambda gen, s, device=None: port_nb.MLP(init))
    model, norm, loss = port_nb.train_mlp(X, y, port_nb.MLPSpec(), **kw,
                                          device="cpu")
    np.testing.assert_array_equal(norm["mu"], jnorm["mu"])
    np.testing.assert_array_equal(norm["sd"], jnorm["sd"])
    assert abs(loss - jloss) <= loss_tol
    for p, q in zip(model.layers(), jparams):
        for k in ("w", "b"):
            np.testing.assert_allclose(p[k].detach().numpy(),
                                       np.asarray(q[k]), rtol=0,
                                       atol=param_tol)


QSPECS = [(28, 19, "trn", "wrap"), (28, 19, "rnd", "sat"),
          (16, 8, "trn", "wrap"), (16, 8, "rnd", "sat"),
          (16, 8, "trn", "sat"), (16, 10, "rnd", "wrap")]


def _floats(spec, rng):
    """Random floats over the spec's range and well past it (wrap and
    saturation), the exact grid edges, and values half a step from them;
    within the device path's precondition |x * scale| < 2**23."""
    lim = min(2.0 ** 23, 4.0 * 2 ** (spec.width - 1)) / spec.scale
    edge = np.array([spec.raw_min, spec.raw_max, spec.raw_max + 1,
                     spec.raw_min - 1, 0, -1, 1]) / spec.scale
    half = 0.5 / spec.scale
    x = np.concatenate([rng.uniform(-lim, lim, 4_000),
                        rng.normal(size=1_000) * 3.0,
                        edge, edge + half, edge - half,
                        edge + 1e-3 * half, edge - 1e-3 * half])
    return x.astype(np.float32)


@pytest.mark.parametrize("qspec", QSPECS, ids=lambda q: "_".join(map(str, q)))
def test_quantize_device_helpers_bit_identical_to_jax(qspec):
    w, i, rnd, ovf = qspec
    jspec = jax_q.FixedSpec(width=w, int_bits=i, rounding=rnd, overflow=ovf)
    pspec = port_q.FixedSpec(width=w, int_bits=i, rounding=rnd, overflow=ovf)
    rng = np.random.default_rng(w * 100 + i)
    x = _floats(pspec, rng)
    xt = torch.as_tensor(x)
    raw = port_q.quantize_raw_device(xt, pspec)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(),
                                  np.asarray(jax_q.quantize_raw_jax(x, jspec)))
    # the host packer agrees too (value domain of the spec)
    np.testing.assert_array_equal(raw.numpy(), port_q.quantize_raw(x, pspec))
    ints = np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 3_000, dtype=np.int64),
        np.array([-2**31, 2**31 - 1, pspec.raw_min, pspec.raw_max,
                  pspec.raw_max + 1, pspec.raw_min - 1, 0, -1])
    ]).astype(np.int32)
    u = port_q.to_unsigned_bits_device(torch.as_tensor(ints), pspec)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jax_q.to_unsigned_bits_jax(ints, jspec)))
    bits = port_q.encode_offset_binary_device(xt.reshape(-1, 5), pspec)
    want = np.asarray(jax_q.encode_offset_binary_jax(x.reshape(-1, 5), jspec))
    assert bits.shape == want.shape == (len(x) // 5, 5, w)
    np.testing.assert_array_equal(bits.numpy(), want)


def test_smartpixel_example_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_smartpixel_readout",
        ROOT / "examples" / "torch_smartpixel_readout.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--events", "6000"])
    text = capsys.readouterr().out
    assert out["device"] == "cpu" and out["n"] == out["n_match"] == 6_000
    assert out["nn_lut_total"] == jax_nb.lut_cost(jax_nb.MLPSpec())[
        "lut_total"] > 6_000
    assert "NN baseline: 6024 LUTs" in text and "DONE." in text
    assert np.isfinite(out["nn_loss"])
