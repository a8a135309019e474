"""The port's copies of the numpy modules agree with the JAX package's.

For the same seeds, on every registered fabric: the trained quantized
ensemble, the synthesized netlist, the placed ``FabricConfig`` arrays and
the bitstream BYTES are identical; so are the data generator, the frame
stream, the TMR replica encodings and the host oracles' outputs.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.core import fabric as jax_fabric  # noqa: E402
from repro.core import tmr as jax_tmr  # noqa: E402
from repro.data.pipeline import FrameStream as JaxStream  # noqa: E402
from repro.data.pipeline import FrameStreamConfig as JaxStreamCfg  # noqa: E402
from repro_torch.core import bitstream as port_bitstream  # noqa: E402
from repro_torch.core import fabric as port_fabric  # noqa: E402
from repro_torch.core import tmr as port_tmr  # noqa: E402
from repro_torch.data.pipeline import FrameStream as PortStream  # noqa: E402
from repro_torch.data.pipeline import FrameStreamConfig as PortStreamCfg  # noqa: E402
from tests._torch_helpers import FABRIC_RECIPES, chip_pair, frames  # noqa: E402


def assert_same(a, b, path="obj"):
    """Structural equality across the two packages' (distinct) classes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)
        assert a.dtype == np.asarray(b).dtype, path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, (path, a, b)


def test_fabric_registries_match():
    assert sorted(jax_fabric.FABRICS) == sorted(port_fabric.FABRICS)
    for name, spec in jax_fabric.FABRICS.items():
        assert_same(spec, port_fabric.FABRICS[name], name)


@pytest.mark.parametrize("fabric", sorted(FABRIC_RECIPES))
def test_trained_chip_identical(fabric):
    """Ensemble, netlist, placed config and bitstream bytes are identical."""
    j, p = chip_pair(fabric)
    assert j.bitstream == p.bitstream
    assert_same(j.golden, p.golden, "golden")
    assert_same(j.synth.netlist, p.synth.netlist, "netlist")
    assert_same(j.config, p.config, "config")
    assert j.score_threshold_raw == p.score_threshold_raw
    assert_same(p.config, port_bitstream.decode(p.bitstream), "decode")


@pytest.mark.parametrize("fabric", sorted(FABRIC_RECIPES))
def test_host_oracles_and_replicas_identical(fabric):
    """encode_features, FabricSim, BitslicedSim and the TMR replica
    encodings give identical results in both packages."""
    j, p = chip_pair(fabric)
    fr, y0 = frames(96)
    rng = np.random.default_rng(1)
    X = rng.normal(2.0, 3.0, (96, 14)).astype(np.float32)
    bits = j.encode_features(X)
    np.testing.assert_array_equal(bits, p.encode_features(X))
    want, _ = jax_fabric.FabricSim(j.config).run(bits)
    got, _ = port_fabric.FabricSim(p.config).run(bits)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        port_fabric.BitslicedSim(p.config).run(bits), got)
    for r in range(port_tmr.N_REPLICAS):
        assert_same(jax_tmr.replicate_config(j.config, r),
                    port_tmr.replicate_config(p.config, r), f"replica{r}")


def test_frame_stream_identical():
    js = JaxStream(JaxStreamCfg(n_sensors=2, batch=64))
    ps = PortStream(PortStreamCfg(n_sensors=2, batch=64))
    for step, sensor in ((0, 0), (3, 1)):
        assert_same(js.batch_at(step, sensor), ps.batch_at(step, sensor),
                    f"block{step},{sensor}")
