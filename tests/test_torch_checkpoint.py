"""The port's checkpoints (src/repro_torch/train/checkpoint.py) and the
training half of train/elastic.py and launch/mesh.py, on the CPU.

* The JAX package's checkpoint suite (tests/test_checkpoint.py) on the
  port: round trip, retention, integrity, shape mismatch and a missing
  key, a crash mid-write, placement on restore;
* interchange: a train state (TINY's params and AdamW or Adafactor state
  after one step) written by the JAX package restores in the port, and
  the port's in the JAX package, every leaf bit-equal (float32 and int32)
  and with the same keys;
* a bf16 leaf is refused with its key, and nothing is written;
* ``gather_to_host`` / ``reshard_params`` / ``reshard_opt_state`` on a
  plan of one device; a readout plan of several devices is refused
  (sharded state goes on a ``DeviceMesh``: tests/test_torch_distributed.py),
  and ``make_host_mesh`` over more than one device without a process
  group of that many ranks raises ``MeshUnavailableError``.
"""
import json
import os

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.launch.train import TINY as JAX_TINY  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshUnavailableError, ReadoutMesh, make_host_mesh)
from repro_torch.launch.train import TINY  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.checkpoint import (  # noqa: E402
    CheckpointError, CheckpointManager)
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402

CPU = torch.device("cpu")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.normal(0, 1, (8, 4)),
                                     dtype=torch.float32),
                   "b": torch.tensor(rng.normal(0, 1, (4,)),
                                     dtype=torch.float32)},
        "opt": {"m": {"w": torch.zeros((8, 4)), "b": torch.zeros((4,))},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a, b):
    ka, kb = dict(T.items(a)), dict(T.items(b))
    assert ka.keys() == kb.keys()
    for k in ka:
        x, y = (np.asarray(v.numpy() if torch.is_tensor(v) else v)
                for v in (ka[k], kb[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x.reshape(-1).view(np.uint8),
                              y.reshape(-1).view(np.uint8)), k


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(10, tree)
    step, got = mgr.restore(_tree(1))
    assert step == 10
    _equal(got, tree)
    assert all(x.device == CPU for x in T.leaves(got))
    manifest = json.load(open(tmp_path / "step_00000010" / "MANIFEST.json"))
    assert manifest["keys"] == sorted(["params/w", "params/b", "opt/m/w",
                                       "opt/m/b", "opt/step"])


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (5, 10, 15, 20):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 20
    assert mgr.all_steps() == [15, 20]  # keep=2 garbage-collects the rest
    step, got = mgr.restore(_tree(), step=15)
    assert step == 15
    _equal(got, _tree(15))


def test_integrity_check_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree())
    path = os.path.join(str(tmp_path), "step_00000003", "arrays.npz")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(CheckpointError, match="integrity"):
        mgr.restore(_tree())


def test_shape_mismatch_and_missing_key_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((9, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad)
    more = _tree()
    more["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(more)
    with pytest.raises(CheckpointError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree())


def test_crash_mid_write_keeps_previous(tmp_path):
    """A stale .tmp dir must not break restore of the previous good step."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree(1))
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    with open(os.path.join(str(tmp_path), "step_00000002.tmp",
                           "arrays.npz"), "wb") as f:
        f.write(b"partial")
    assert mgr.latest_step() == 1
    step, _ = mgr.restore(_tree())
    assert step == 1
    mgr.save(2, _tree(2))
    assert mgr.latest_step() == 2


def test_restore_places_leaves(tmp_path):
    """On ``device`` when given; else where the template's leaf is; a numpy
    template leaf with ``device`` given."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, _tree())
    np_template = T.map_leaves(lambda x: x.numpy(), _tree())
    step, got = mgr.restore(np_template, device="cpu")
    assert step == 4 and all(torch.is_tensor(x) and x.device == CPU
                             for x in T.leaves(got))
    _equal(got, _tree())


def test_bf16_leaf_is_refused_by_name(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    tree["params"]["w"] = tree["params"]["w"].to(torch.bfloat16)
    with pytest.raises(CheckpointError, match="params/w"):
        mgr.save(1, tree)
    assert mgr.all_steps() == [] and os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def train_states():
    """{optimizer: (JAX train state as numpy, the port's, carried)}: TINY's
    params and the optimizer's state after one JAX update."""
    jp = jax_registry.init_params(JAX_TINY, jax.random.PRNGKey(0))
    out = {}
    for name in ("adamw", "adafactor"):
        cfg = jopt.OptimizerConfig(name=name, warmup_steps=0)
        init, upd = jopt.make_optimizer(cfg)
        g = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jp)
        p1, s1, _ = upd(g, init(jp), jp)
        jstate = jax.tree.map(np.asarray, {"params": p1, "opt": s1})
        pstate = {
            "params": convert.lm_params_from_numpy(TINY, jstate["params"],
                                                   device="cpu"),
            "opt": convert.opt_state_from_numpy(
                TINY, OptimizerConfig(name=name), jstate["opt"],
                device="cpu")}
        out[name] = jstate, pstate
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, train_states, name):
    jstate, pstate = train_states[name]
    JaxManager(str(tmp_path)).save(5, jstate)
    template = T.map_leaves(torch.zeros_like, pstate)
    step, got = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 5
    _equal(got, jstate)
    assert got["opt"]["step"].dtype == torch.int32


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_port_checkpoint_restores_in_jax(tmp_path, train_states, name):
    jstate, pstate = train_states[name]
    CheckpointManager(str(tmp_path)).save(6, pstate)
    template = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), jstate)
    step, got = JaxManager(str(tmp_path)).restore(template)
    assert step == 6
    _equal(jax.tree.map(np.asarray, got), jstate)
    manifest = json.load(open(tmp_path / "step_00000006" / "MANIFEST.json"))
    assert manifest["keys"] == sorted(
        k for k, _ in T.items(jax.tree.map(np.asarray, jstate)))


def test_gather_and_reshard_on_one_device(train_states):
    _, pstate = train_states["adamw"]
    host = elastic.gather_to_host(pstate)
    assert all(isinstance(x, np.ndarray) for x in T.leaves(host))
    mesh = make_host_mesh(1, 1, device="cpu")
    assert mesh == ReadoutMesh((CPU,))
    params = elastic.reshard_params(TINY, mesh, host["params"])
    opt = elastic.reshard_opt_state(TINY, mesh, host["opt"], params)
    _equal({"params": params, "opt": opt}, pstate)
    with pytest.raises(ValueError, match="bfloat16"):
        elastic.gather_to_host({"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_plans_over_several_devices_name_a18():
    two = ReadoutMesh((CPU, CPU))
    with pytest.raises(ValueError, match="DeviceMesh"):
        elastic.reshard_params(TINY, two, {"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="DeviceMesh"):
        elastic.reshard_opt_state(TINY, two, {}, {})
    for data, model in ((2, 1), (1, 4)):
        with pytest.raises(MeshUnavailableError, match="ranks"):
            make_host_mesh(data, model, device="cpu")
    with pytest.raises(ValueError):
        make_host_mesh(0, 1, device="cpu")
