"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

* every ``repro_torch`` module imports in a subprocess where ``jax*`` and
  ``repro``/``repro.*`` imports are blocked, and none of them got loaded;
* no source line of the port (or of chip_smoke.py, the port's benches
  and its examples) imports them;
* without CUDA, every entry point that is not handed ``device="cpu"``
  raises the named DeviceUnavailableError instead of running on the CPU.
"""
import ctypes
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.device import DeviceUnavailableError, resolve_device  # noqa: E402
from tests._torch_helpers import chip_pair  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top == "jax" or top == "jaxlib" or top == "repro":
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
print(" ".join(names))
assert not bad, bad
"""

# modules the blocked import must reach, the sparse-egress, network and
# fleet slices' among them (a package that failed to import would drop
# out of the walk)
REQUIRED_MODULES = ("repro_torch.parallel.compression",
                    "repro_torch.kernels.sparse_pack.sparse_pack",
                    "repro_torch.kernels.lut_eval.ops",
                    "repro_torch.launch.readout_server",
                    "repro_torch.net.protocol",
                    "repro_torch.net.ingress",
                    "repro_torch.net.replay",
                    "repro_torch.launch.fleet",
                    "repro_torch.launch.mesh",
                    "repro_torch.train.elastic",
                    "repro_torch.core.verilog",
                    "repro_torch.core.power",
                    "repro_torch.core.nn_baseline",
                    "repro_torch.configs",
                    "repro_torch.configs.base",
                    "repro_torch.configs.gemma_7b",
                    "repro_torch.configs.starcoder2_7b",
                    "repro_torch.configs.internvl2_76b",
                    "repro_torch.models.layers",
                    "repro_torch.models.dense",
                    "repro_torch.models.registry",
                    "repro_torch.launch.serve",
                    "repro_torch.launch.train",
                    "repro_torch.models.moe",
                    "repro_torch.models.ssm",
                    "repro_torch.models.hybrid",
                    "repro_torch.models.encdec",
                    "repro_torch.data.pipeline",
                    "repro_torch.train.tree",
                    "repro_torch.train.optimizer",
                    "repro_torch.train.train_step",
                    "repro_torch.train.checkpoint",
                    "repro_torch.parallel.sharding",
                    "repro_torch.parallel.hlo_analysis",
                    "repro_torch.parallel.transport",
                    "repro_torch.launch.specs",
                    "repro_torch.launch.dryrun")


def test_port_imports_with_jax_and_repro_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts, names = proc.stdout.splitlines()
    n_modules, bad = counts.split(maxsplit=1)
    assert int(n_modules) >= 25 and bad.strip() == "[]", proc.stdout
    assert set(REQUIRED_MODULES) <= set(names.split()), names


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|repro)\b(?!_torch))", re.M)


def test_no_source_line_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "benchmarks").glob("torch_*.py")) + sorted(
        (ROOT / "examples").glob("torch_*.py"))
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert len(files) > 20 and not hits, hits


def _entry_points():
    from repro_torch.convert import plan_from_numpy
    from repro_torch.core.readout import HostBackend, KernelBackend
    from repro_torch.kernels.bdt_infer.ops import bdt_infer, pack_ensemble
    from repro_torch.kernels.frontend import pack_frontend
    from repro_torch.kernels.lut_eval.ops import (
        fabric_eval, fabric_eval_multi, pack_fabric, pack_fabric_pool,
        pack_fabrics)
    from repro_torch.kernels.yprofile.ops import yprofile
    from repro_torch.launch.fleet import TenantFleet
    from repro_torch.launch.mesh import make_fleet_meshes, make_readout_mesh
    from repro_torch.launch.readout_server import ReadoutServer
    from repro_torch.net.replay import host_oracle
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core.nn_baseline import MLPSpec, init_mlp, train_mlp
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.train import TINY
    from repro_torch.configs import smoke_config
    from repro_torch.models import dense, encdec, hybrid, moe, registry, ssm

    frames = np.zeros((2, 8, 13, 21), np.float32)
    y0 = np.zeros(2, np.float32)
    return {
        "resolve_device": lambda: resolve_device(),
        "yprofile": lambda: yprofile(frames, y0),
        "pack_fabrics": lambda: pack_fabrics([_config()]),
        "pack_frontend": lambda: pack_frontend([_config()], [_spec()]),
        "ReadoutServer": lambda: ReadoutServer([_chip()]),
        "KernelBackend.score_bits": lambda: KernelBackend().score_bits(
            _config(), np.zeros((2, _config().n_inputs), np.uint8)),
        "HostBackend.score_frames": lambda: HostBackend().score_frames(
            _chip(), frames, y0),
        "convert.plan_from_numpy": lambda: plan_from_numpy({}),
        "pack_fabric": lambda: pack_fabric(_config()),
        "fabric_eval": lambda: fabric_eval(
            _config(), np.zeros((2, _config().n_inputs), np.uint8)),
        "pack_ensemble": lambda: pack_ensemble(_chip().golden, 14),
        "bdt_infer": lambda: bdt_infer(_chip().golden,
                                       np.zeros((2, 14), np.int32),
                                       n_features=14),
        "fabric_eval_multi": lambda: fabric_eval_multi(
            [_config()], np.zeros((1, 2, _config().n_inputs), np.uint8)),
        "net.replay.host_oracle": lambda: host_oracle(_chip()),
        "TenantFleet": lambda: TenantFleet(),
        "pack_fabric_pool": lambda: pack_fabric_pool([_config()]),
        "make_readout_mesh": lambda: make_readout_mesh(1),
        "make_fleet_meshes": lambda: make_fleet_meshes([1]),
        "nn_baseline.train_mlp": lambda: train_mlp(
            np.zeros((4, 14)), np.zeros(4), steps=1, batch=2),
        "nn_baseline.init_mlp": lambda: init_mlp(torch.Generator(),
                                                 MLPSpec()),
        "example.torch_smartpixel_readout": lambda: _run_example(
            "torch_smartpixel_readout", ["--events", "100"]),
        "launch.serve.main": lambda: serve.main(
            ["--batch", "1", "--prompt-len", "1", "--gen", "1"]),
        "launch.serve.build": lambda: serve.build(TINY, 0, None),
        "launch.serve.generate": lambda: serve.generate(
            TINY, {}, batch=1, prompt_len=1, gen=1),
        "models.dense.init_cache": lambda: dense.init_cache(TINY, 1, 2),
        "convert.lm_params_from_numpy": lambda: lm_params_from_numpy(
            TINY, {}),
        "models.moe.init_cache": lambda: moe.init_cache(
            smoke_config("deepseek-moe-16b"), 1, 2),
        "models.ssm.init_cache": lambda: ssm.init_cache(
            smoke_config("mamba2-130m"), 1, 2),
        "models.hybrid.init_cache": lambda: hybrid.init_cache(
            smoke_config("zamba2-1.2b"), 1, 2),
        "models.encdec.init_cache": lambda: encdec.init_cache(
            smoke_config("whisper-tiny"), 1, 2),
        "registry.init_cache": lambda: registry.init_cache(
            smoke_config("grok-1-314b"), 1, 2),
        "launch.serve.main.smoke_ssm": lambda: serve.main(
            ["--preset", "smoke", "--arch", "mamba2-130m", "--batch", "1",
             "--prompt-len", "1", "--gen", "1"]),
        "example.torch_quickstart": lambda: _run_example(
            "torch_quickstart", ["--events", "100"]),
        "example.torch_serve_lm": lambda: _run_example(
            "torch_serve_lm", ["--gen", "1"]),
        "launch.train.main": lambda: train.main(["--steps", "1"]),
        "make_host_mesh": lambda: make_host_mesh(),
        "CheckpointManager.restore": _restore_onto_default_device,
        "example.torch_train_lm": lambda: _run_example(
            "torch_train_lm", ["--steps", "1"]),
        "make_production_mesh": lambda: make_production_mesh(),
        "make_host_mesh.sharded": lambda: make_host_mesh(2, 1),
    }


def _restore_onto_default_device():
    """A checkpoint restored into a template of numpy leaves (no device of
    their own) goes to the default device."""
    import tempfile

    from repro_torch.train.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"w": np.zeros(3, np.float32)})
        return mgr.restore({"w": np.zeros(3, np.float32)})


def _run_example(name, argv):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def _chip():
    return chip_pair("efpga_130nm")[1]


def _config():
    return _chip().config


def _spec():
    return _chip().frontend_spec()


@pytest.mark.parametrize("name", [
    "resolve_device", "yprofile", "pack_fabrics", "pack_frontend",
    "ReadoutServer", "KernelBackend.score_bits", "HostBackend.score_frames",
    "convert.plan_from_numpy", "pack_fabric", "fabric_eval", "pack_ensemble",
    "bdt_infer", "fabric_eval_multi", "net.replay.host_oracle",
    "TenantFleet", "pack_fabric_pool", "make_readout_mesh",
    "make_fleet_meshes", "nn_baseline.train_mlp", "nn_baseline.init_mlp",
    "example.torch_smartpixel_readout", "launch.serve.main",
    "launch.serve.build", "launch.serve.generate",
    "models.dense.init_cache", "convert.lm_params_from_numpy",
    "models.moe.init_cache", "models.ssm.init_cache",
    "models.hybrid.init_cache", "models.encdec.init_cache",
    "registry.init_cache", "launch.serve.main.smoke_ssm",
    "example.torch_quickstart", "example.torch_serve_lm",
    "launch.train.main", "make_host_mesh", "CheckpointManager.restore",
    "example.torch_train_lm", "make_production_mesh",
    "make_host_mesh.sharded"])
def test_entry_point_without_cuda_raises_named_error(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(DeviceUnavailableError):
        _entry_points()[name]()


def test_explicit_cpu_is_accepted():
    assert resolve_device("cpu") == torch.device("cpu")


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def test_ctypes_prototypes_match_the_cuda_sources():
    """The argument types the wrappers bind (build.PROTOTYPES) follow each
    launch function's C signature in csrc/, one for one (the sources
    cannot be compiled here, so this is checked on the text)."""
    from repro_torch.kernels import build

    for src, functions in build.PROTOTYPES.items():
        text = (build.CSRC / f"{src}.cu").read_text()
        for fn, argtypes in functions.items():
            m = re.search(rf"int {fn}\(([^)]*)\)", text)
            assert m, (src, fn)
            params = [re.sub(r"\s*\w+$", "", p.strip())
                      for p in m.group(1).split(",")]
            assert [_C_TYPES[p] for p in params] == list(argtypes), (
                src, fn, params)
