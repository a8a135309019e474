"""The port's sharding rules, dry-run config fix-ups and input stand-ins
against the JAX package's.

* for every arch, on the reference test's single- and multi-pod fake
  meshes, ``param_specs``, ``grad_specs``, ``opt_state_specs`` (AdamW and
  Adafactor), ``batch_specs``, ``cache_specs`` and ``decode_tokens_spec``
  equal ``repro.parallel.sharding``'s entry for entry, JAX's
  ``PartitionSpec`` turned into a tuple;
* ``launch.dryrun._adjust_cfg`` gives the same config for every arch x
  shape x mesh;
* ``launch.specs`` builds fake tensors of ``jax.eval_shape``'s shapes and
  dtypes;
* ``parse_collectives`` reads the reference test's HLO snippet to the same
  stats, and ``placements`` turns specs into DTensor placements.

The JAX side of every comparison is built once in a module fixture.
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.launch import dryrun as jax_dryrun  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JOpt  # noqa: E402
from repro.train.train_step import make_opt_init as jax_opt_init  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.parallel import hlo_analysis  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import make_opt_init  # noqa: E402

ARCHS = sorted(JAX_ARCHS)


class _FakeMesh:
    """The reference test's duck-typed mesh: a shape dict and axis names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"single": _FakeMesh({"data": 16, "model": 16}),
          "multi": _FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _flat_jax(tree):
    """{"/"-joined path: spec as a tuple (or a shape-dtype pair)}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(v) if isinstance(v, JP) else v)
            for path, v in leaves}


def _flat_port(tree):
    return dict(T.items(tree))


def _jax_specs(arch, mesh):
    cfg = jax_arch(arch)
    params = JS.params_sds(cfg)
    pspecs = jshd.param_specs(cfg, mesh, params)
    out = {"params": _flat_jax(pspecs),
           "grads": _flat_jax(jshd.grad_specs(cfg, mesh, params))}
    for opt in ("adamw", "adafactor"):
        opt_shape = jax.eval_shape(jax_opt_init(cfg, JOpt(name=opt)), params)
        out[opt] = _flat_jax(jshd.opt_state_specs(cfg, mesh, opt_shape,
                                                  pspecs))
    for shape in cfg.shapes():
        out["batch", shape.name] = _flat_jax(
            jshd.batch_specs(cfg, mesh, shape))
        if shape.kind == "decode":
            out["cache", shape.name] = _flat_jax(jshd.cache_specs(
                cfg, mesh, shape, JS.cache_sds(cfg, shape)))
            out["tokens", shape.name] = tuple(
                jshd.decode_tokens_spec(cfg, mesh, shape))
    return out


def _port_specs(arch, mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():   # one mode for the params and the opt state
        return _port_specs_in_mode(arch, mesh)


def _port_specs_in_mode(arch, mesh):
    cfg = get_arch(arch)
    params = S.params_sds(cfg)
    pspecs = shd.param_specs(cfg, mesh, params)
    out = {"params": _flat_port(pspecs),
           "grads": _flat_port(shd.grad_specs(cfg, mesh, params))}
    for opt in ("adamw", "adafactor"):
        opt_shape = make_opt_init(cfg, OptimizerConfig(name=opt))(params)
        out[opt] = _flat_port(shd.opt_state_specs(cfg, mesh, opt_shape,
                                                  pspecs))
    for shape in cfg.shapes():
        out["batch", shape.name] = _flat_port(
            shd.batch_specs(cfg, mesh, shape))
        if shape.kind == "decode":
            out["cache", shape.name] = _flat_port(shd.cache_specs(
                cfg, mesh, shape, S.cache_specs_sds(cfg, shape)))
            out["tokens", shape.name] = shd.decode_tokens_spec(cfg, mesh,
                                                               shape)
    return out


@pytest.fixture(scope="module")
def specs():
    return {(arch, m): (_jax_specs(arch, mesh), _port_specs(arch, mesh))
            for arch in ARCHS for m, mesh in MESHES.items()}


CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m}" for a, m in CASES]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_param_specs_match_jax(specs, arch, mesh):
    want, got = specs[arch, mesh]
    assert got["params"] == want["params"]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_grad_specs_match_jax(specs, arch, mesh):
    want, got = specs[arch, mesh]
    assert got["grads"] == want["grads"]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_opt_state_specs_match_jax(specs, arch, mesh, opt):
    want, got = specs[arch, mesh]
    assert got[opt] == want[opt]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_batch_specs_match_jax(specs, arch, mesh):
    want, got = specs[arch, mesh]
    keys = [k for k in want if k[0] == "batch"]
    assert keys and {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_cache_and_decode_token_specs_match_jax(specs, arch, mesh):
    """Cache leaves (the port's Python-int ``pos`` as the reference's
    int32 scalar: P()) and the decode tokens' spec, every decode shape."""
    want, got = specs[arch, mesh]
    keys = [k for k in want if k[0] in ("cache", "tokens")]
    assert keys and {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("arch", ARCHS)
def test_adjust_cfg_matches_jax(arch):
    for mesh in MESHES.values():
        for shape in get_arch(arch).shapes():
            want = dataclasses.asdict(jax_dryrun._adjust_cfg(
                jax_arch(arch), shape, mesh))
            got = dataclasses.asdict(dryrun._adjust_cfg(
                get_arch(arch), shape, mesh))
            assert got == want, (arch, shape.name)


def _shape_dtypes_jax(tree):
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat_jax(tree).items()}


def _shape_dtypes_port(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in T.items(tree) if hasattr(v, "shape")}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_stand_ins_match_eval_shape(arch):
    """params, batch, cache (tensor leaves; ``pos`` is an int32 scalar in
    JAX, a Python int in the port) and decode tokens, every shape."""
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    assert (_shape_dtypes_port(S.params_sds(cfg))
            == _shape_dtypes_jax(JS.params_sds(jcfg)))
    for shape in cfg.shapes():
        if shape.kind == "decode":
            want = _shape_dtypes_jax(JS.cache_sds(jcfg, shape))
            assert want.pop("pos") == ((), "int32")
            port = S.cache_specs_sds(cfg, shape)
            assert port["pos"] == 0
            assert _shape_dtypes_port(port) == want
            assert (_shape_dtypes_port({"t": S.decode_tokens_sds(cfg, shape)})
                    == _shape_dtypes_jax({"t": JS.decode_tokens_sds(
                        jcfg, shape)}))
        else:
            assert (_shape_dtypes_port(S.batch_specs_sds(cfg, shape))
                    == _shape_dtypes_jax(JS.batch_specs_sds(jcfg, shape)))
    ins = S.input_specs(cfg, SHAPES["train_4k"])
    assert set(ins) == {"params", "batch"}


HLO = """
  %ar = f32[1024]{0} all-reduce(%x), channel_id=1, replica_groups=[2,4]<=[8], to_apply=%sum
  %ag.1 = bf16[16,512]{1,0} all-gather(%y), channel_id=2, replica_groups=[4,2]<=[8], dimensions={0}
  %rs = f32[128]{0} reduce-scatter(%z), channel_id=3, replica_groups=[1,8]<=[8], to_apply=%sum
  %cp = s8[64]{0} collective-permute(%w), channel_id=4, source_target_pairs={{0,1}}
"""


def test_parse_collectives_matches_jax():
    from repro.parallel.hlo_analysis import parse_collectives as jax_parse

    want, got = jax_parse(HLO, 8), hlo_analysis.parse_collectives(HLO, 8)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.count == 4
    assert got.by_op["all-reduce"] == pytest.approx(2 * 4096 * 3 / 4)


def test_placements_follow_the_spec():
    """Shard(d) on each mesh dim that shards tensor dim d, in the spec's
    tuple order; a tuple out of the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("pod", "data", "model")

    assert shd.placements(M, shd.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(M, shd.P()) == (Replicate(),) * 3
    assert shd.placements(M, shd.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.placements(M, shd.P(("data", "pod")))
    assert np.prod([MESHES["multi"].shape[a] for a in ("pod", "data")]) == 32
