"""Selection-matmul fabric evaluation (dense and banded): port vs JAX.

* ``pack_fabric`` / ``pack_fabrics`` (layout="matmul", the default)
  arrays equal JAX's element for element: dense and banded, TMR on and
  off, and after ``swap_chip``; the reference's ``sel`` has exactly one
  1 in each column of a real LUT slot and none in a padded one, the fact
  the kernel's column lists rest on;
* the plain twins of the two kernels equal JAX's Pallas kernels
  (interpret mode) on the same arrays, carried across by ``convert``,
  and ``fabric_eval_ref``: the whole (C, B, N) net buffer, exactly;
* ``fabric_eval`` equals JAX's ``fabric_eval`` and ``FabricSim``;
* the matmul ``fabric_eval_bits_voted`` with an upset replica equals
  JAX's (voted bits and disagreement);
* the paper's §5 check (``verify_vs_golden`` through ``KernelBackend``)
  matches the golden BDT on every event, as in the JAX package.
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core.readout import KernelBackend as JaxKernelBackend  # noqa: E402
from repro.kernels.lut_eval import lut_eval as jax_le  # noqa: E402
from repro.kernels.lut_eval import ops as jax_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fabric import FabricSim  # noqa: E402
from repro_torch.core.readout import KernelBackend  # noqa: E402
from repro_torch.kernels.lut_eval import lut_eval as port_le  # noqa: E402
from repro_torch.kernels.lut_eval import ops as port_ops  # noqa: E402
from repro_torch.kernels.lut_eval.ref import fabric_eval_ref  # noqa: E402
from tests._torch_helpers import _train, chip_pair  # noqa: E402

FABRICS = ("efpga_130nm", "efpga_28nm")
_ARRAYS = ("tables", "output_nets", "level_base", "win_base")
_STATICS = ("n_inputs", "n_outputs", "n_inputs_each", "n_outputs_each",
            "n_nets_pad", "m_pad", "n_levels", "in_seg", "band_k",
            "n_replicas")
LAYOUTS = {None: "banded", False: "dense"}
B = 128


@pytest.fixture(scope="module")
def pairs():
    return [chip_pair(f) for f in FABRICS]


def _stacks(pairs, **kw):
    j = jax_ops.pack_fabrics([p[0].config for p in pairs], **kw)
    p = port_ops.pack_fabrics([p[1].config for p in pairs], device="cpu",
                              **kw)
    return j, p


def _assert_stack_equal(j, p):
    assert p.sel.dtype == torch.bfloat16 and p.src is None
    np.testing.assert_array_equal(p.sel.float().numpy(),
                                  np.asarray(j.sel, np.float32))
    for k in _ARRAYS:
        want = np.asarray(getattr(j, k))
        got = getattr(p, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in _STATICS:
        assert getattr(p, k) == getattr(j, k), k
    assert p.layout == j.layout


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
@pytest.mark.parametrize("band", [None, False])
def test_pack_fabrics_matmul_equals_jax(pairs, redundancy, band):
    j, p = _stacks(pairs, redundancy=redundancy, band=band)
    _assert_stack_equal(j, p)
    assert p.layout == LAYOUTS[band]


@pytest.mark.parametrize("band", [None, False])
def test_pack_fabric_equals_jax(pairs, band):
    for jc, pc in pairs:
        j = jax_ops.pack_fabric(jc.config, band=band)
        p = port_ops.pack_fabric(pc.config, band=band, device="cpu")
        np.testing.assert_array_equal(p.sel.float().numpy(),
                                      np.asarray(j.sel, np.float32))
        for k in _ARRAYS:
            np.testing.assert_array_equal(getattr(p, k).numpy(),
                                          np.asarray(getattr(j, k)))
        for k in ("n_inputs", "n_nets_pad", "m_pad", "n_levels", "in_seg",
                  "band_k"):
            assert getattr(p, k) == getattr(j, k), k
        assert p.banded == j.banded == (band is None)


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
@pytest.mark.parametrize("band", [None, False])
def test_swap_chip_rewrites_sel_rows_like_jax(pairs, redundancy, band):
    j, p = _stacks(pairs, redundancy=redundancy, band=band)
    new_j, new_p = chip_pair("efpga_130nm", seed=6)
    js = j.swap_chip(1, new_j.config)
    ps = p.swap_chip(1, new_p.config)
    _assert_stack_equal(js, ps)
    R = p.n_replicas
    for k in ("sel", "tables", "output_nets"):
        old, new = getattr(p, k), getattr(ps, k)
        assert torch.equal(old[:R], new[:R]), k       # chip 0 untouched
        assert not torch.equal(old[R:], new[R:]), k   # chip 1 rewritten


def _bits_ext(stack, rows, seed):
    bits = np.random.default_rng(seed).integers(
        0, 2, (rows, B, stack.n_inputs))
    return port_ops._bits_ext(torch.as_tensor(bits), stack.n_inputs,
                              stack.in_seg)


def _converted(pairs, band, redundancy):
    """The JAX stack and its arrays carried across by ``convert``."""
    j = jax_ops.pack_fabrics([p[0].config for p in pairs], band=band,
                             redundancy=redundancy)
    fields = {k: np.asarray(getattr(j, k)) for k in _ARRAYS}
    fields.update({k: getattr(j, k) for k in _STATICS})
    fields.update(sel=np.asarray(j.sel), src=None)
    return j, convert.stack_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
@pytest.mark.parametrize("band", [None, False])
def test_packed_sel_is_one_hot_per_column(pairs, redundancy, band):
    """What the kernel's column lists rest on, on the reference's own
    arrays: every column of a real LUT slot holds exactly one 1 (a LUT4
    has 4 inputs), a padded slot's columns hold none."""
    _, p = _converted(pairs, band, redundancy)
    C, L, _, M4 = p.sel.shape
    M, R = p.m_pad, p.n_replicas
    ones = p.sel.float().sum(dim=2).reshape(C, L, 4, M)
    assert set(torch.unique(ones).tolist()) <= {0.0, 1.0}
    assert set(torch.unique(p.sel.float()).tolist()) == {0.0, 1.0}
    for row in range(C):
        sizes = pairs[row // R][0].config.level_sizes
        real = torch.zeros((L, M), dtype=torch.bool)
        for lvl, n in enumerate(sizes):
            real[lvl, :n] = True
        want = real[:, None, :].expand(L, 4, M).float()
        assert torch.equal(ones[row], want), row


@pytest.mark.parametrize("redundancy", ["none", "tmr"])
@pytest.mark.parametrize("band", [None, False])
def test_twins_equal_jax_kernels_on_converted_arrays(pairs, redundancy,
                                                      band):
    """The JAX stack's own arrays, carried across by ``convert``, through
    the port's twin and JAX's Pallas kernel (interpret): same buffer."""
    j, p = _converted(pairs, band, redundancy)
    ext = _bits_ext(p, p.tables.shape[0], seed=7)
    e = jnp.asarray(ext.numpy())
    if p.banded:
        got = port_le.lut_eval_banded_stacked(
            ext, p.sel, p.tables, p.level_base, p.win_base,
            n_nets_pad=p.n_nets_pad)
        want = jax_le.lut_eval_pallas_banded_stacked(
            e, j.sel, j.tables, j.level_base, j.win_base,
            n_nets_pad=j.n_nets_pad, interpret=True)
    else:
        got = port_le.lut_eval_stacked(ext, p.sel, p.tables, p.level_base,
                                       n_nets_pad=p.n_nets_pad)
        want = jax_le.lut_eval_pallas_stacked(
            e, j.sel, j.tables, j.level_base, n_nets_pad=j.n_nets_pad,
            interpret=True)
    assert got.shape == (p.tables.shape[0], B, p.n_nets_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("band", [None, False])
def test_single_chip_forms_and_ref_equal_fabric_sim(pairs, band):
    for _, chip in pairs:
        packed = port_ops.pack_fabric(chip.config, band=band, device="cpu")
        bits = np.random.default_rng(3).integers(
            0, 2, (B, chip.config.n_inputs)).astype(np.uint8)
        want = np.asarray(FabricSim(chip.config).run(bits)[0])
        ref = fabric_eval_ref(packed, torch.as_tensor(bits))
        np.testing.assert_array_equal(ref.numpy(), want)
        ext = port_ops._bits_ext(torch.as_tensor(bits), packed.n_inputs,
                                 packed.in_seg)
        args = (ext, packed.sel, packed.tables, packed.level_base)
        vals = (port_le.lut_eval_banded(*args, packed.win_base,
                                        n_nets_pad=packed.n_nets_pad)
                if packed.banded else
                port_le.lut_eval(*args, n_nets_pad=packed.n_nets_pad))
        got = vals[:, packed.output_nets.long()].to(torch.uint8)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("band", [None, False])
def test_fabric_eval_equals_jax_and_fabric_sim(pairs, band):
    for jc, pc in pairs:
        bits = np.random.default_rng(8).integers(
            0, 2, (200, pc.config.n_inputs)).astype(np.uint8)
        got = port_ops.fabric_eval(pc.config, bits, band=band, device="cpu")
        assert got.dtype == torch.uint8 and got.shape[0] == 200
        want = np.asarray(jax_ops.fabric_eval(jc.config, bits, band=band))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(FabricSim(pc.config).run(bits)[0]))


def test_voted_eval_with_upset_replica_equals_jax(pairs):
    j, p = _stacks(pairs, redundancy="tmr")
    tables = p.tables.clone()
    tables[1, :, :8, ::3] = 1.0 - tables[1, :, :8, ::3]   # chip 0, replica 1
    bits = np.random.default_rng(5).integers(
        0, 2, (len(pairs), B, p.n_inputs)).astype(np.int32)
    kw = dict(n_replicas=3, n_inputs=p.n_inputs, n_nets_pad=p.n_nets_pad,
              in_seg=p.in_seg)
    voted, dis = port_ops.fabric_eval_bits_voted(
        p.sel, tables, p.level_base, p.win_base, p.output_nets,
        torch.as_tensor(bits), **kw)
    jv, jd = jax_ops.fabric_eval_bits_voted(
        j.sel, jnp.asarray(tables.numpy()), j.level_base, j.win_base,
        j.output_nets, jnp.asarray(bits), batch_tile=B, interpret=True,
        **kw)
    np.testing.assert_array_equal(voted.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(dis.numpy(), np.asarray(jd))
    assert dis[0, 1].any() and not dis[0, 0].any() and not dis[1].any()
    clean, _ = port_ops.fabric_eval_bits_voted(
        p.sel, p.tables, p.level_base, p.win_base, p.output_nets,
        torch.as_tensor(bits), **kw)
    assert torch.equal(voted, clean)       # the vote masks the upset


def test_kernel_wrappers_refuse_mismatched_arrays(pairs):
    _, p = _stacks(pairs, band=False)
    ext = _bits_ext(p, p.tables.shape[0], seed=1)
    with pytest.raises(ValueError, match="rows"):
        port_le.lut_eval_stacked(ext, p.sel[:, :, :-128], p.tables,
                                 p.level_base, n_nets_pad=p.n_nets_pad)
    with pytest.raises(ValueError, match="tables"):
        port_le.lut_eval_stacked(ext, p.sel, p.tables[:, :-1], p.level_base,
                                 n_nets_pad=p.n_nets_pad)
    # net buffer + staging, and two stages of tables, lists and counts
    assert port_le.smem_bytes(1920, 128, 16) == (
        (1920 + 128) * 16 + 2 * 128 * (16 + 4 * port_le.LIST_CAP + 4)) * 4
    assert port_le.lut_tile(1920, 128, 512, 12, 132) == 16
    assert port_le.lut_tile(1920, 128, 65536, 1, 132) == 16
    assert port_le.lut_tile(1024, 128, 65536, 1, 132) == 32
    # too few events for every SM at any tile: the smallest that fits
    assert port_le.lut_tile(1920, 128, 64, 1, 132) == 4
    with pytest.raises(ValueError, match="shared memory"):
        port_le.lut_tile(20000, 128, 512)


@pytest.fixture(scope="module")
def section5():
    """The paper's chip recipe (examples/smartpixel_readout.py: 1 tree of
    depth 5, 10 leaves, efpga_28nm) on a smaller sample, both packages,
    and JAX's §5 result on 2,048 test events, in setup."""
    from repro.core.bdt import GradientBoostedClassifier as JaxGBC
    from repro.core.quantize import FixedSpec as JaxSpec
    from repro.core.readout import ReadoutChip as JaxChip
    from repro.data.smartpixel import SmartPixelConfig as JaxSPC
    from repro.data.smartpixel import generate as jax_generate
    from repro.data.smartpixel import train_test_split as jax_split
    from repro_torch.core.bdt import GradientBoostedClassifier as PortGBC
    from repro_torch.core.quantize import FixedSpec as PortSpec
    from repro_torch.core.readout import ReadoutChip as PortChip
    from repro_torch.data.smartpixel import SmartPixelConfig as PortSPC
    from repro_torch.data.smartpixel import generate as port_generate
    from repro_torch.data.smartpixel import train_test_split as port_split

    jax_chip = _train(JaxGBC, JaxChip, JaxSpec, JaxSPC, jax_generate,
                      jax_split, "efpga_28nm", 5, 10, 1, None, 2024)
    port_chip = _train(PortGBC, PortChip, PortSpec, PortSPC, port_generate,
                       port_split, "efpga_28nm", 5, 10, 1, None, 2024)
    _, te = port_split(port_generate(PortSPC(n_events=8_000, seed=2024)))
    X = te["features"][:2048]
    jax_v = jax_chip.verify_vs_golden(X, backend=JaxKernelBackend())
    return jax_chip, port_chip, X, jax_v


@pytest.mark.parametrize("band", [None, False])
def test_section5_verify_vs_golden_matches_every_event(section5, band):
    jax_chip, port_chip, X, jax_v = section5
    assert port_chip.bitstream == jax_chip.bitstream
    backend = KernelBackend(band=band, device="cpu")
    v = port_chip.verify_vs_golden(X, backend=backend)
    assert v == jax_v == {"n": 2048.0, "n_match": 2048.0, "accuracy": 1.0}
    packed = backend._packed.get(port_chip.config)
    assert packed.banded == (band is None)
    got = port_chip.infer_raw(X, backend=backend)
    np.testing.assert_array_equal(got, jax_chip.infer_raw(X, backend="host"))
