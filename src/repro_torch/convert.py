"""Carry packed weights across from the JAX package: numpy in, tensors out.

A caller turns every array field of a JAX ``PackedFabricStack`` and of a
``FusedFrontend.plan`` into numpy (``np.asarray``) and hands them over as
plain dicts together with the stack's static ints; this module builds the
port's stack and plan from them on a given device. It imports nothing of
the JAX package: the dicts are the whole interface.

A matmul stack carries ``sel`` and a bit-sliced one ``src``; the other is
None. ``np.asarray`` of a JAX bf16 array is an ``ml_dtypes`` bfloat16
array, which torch does not take, so ``sel`` goes through float32 (exact
for its 0/1 entries) to torch.bfloat16.

The LM scaffold's parameters carry the same way: ``lm_params_from_numpy``
takes the JAX param pytree with every leaf as numpy (nested dicts) and
returns the port's, leaf for leaf; bf16 leaves go through float32 (exact)
to torch.bfloat16. Each floating leaf must have the dtype the reference
gives it: the config's param_dtype, or float32 for the leaves the
reference keeps in float32 (``layers.F32_LEAVES``: the MoE router, the
SSM's ``A_log``, ``D_skip`` and ``dt_bias``). ``opt_state_from_numpy``
carries an optimizer state the same way (AdamW's or Adafactor's), so a
test can start both packages' train steps from one state.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.frontend import _PLAN_KEYS
from repro_torch.kernels.lut_eval.ops import PackedFabricStack

_STACK_ARRAYS = {"tables": torch.float32, "level_base": torch.int32,
                 "output_nets": torch.int32, "win_base": torch.int32}
_STACK_STATICS = ("n_inputs", "n_outputs", "n_nets_pad", "m_pad",
                  "n_levels", "in_seg", "band_k", "n_replicas")


def stack_from_numpy(fields: Mapping[str, object], device=None
                     ) -> PackedFabricStack:
    """{array field: np.ndarray, static field: int | tuple} -> the port's
    PackedFabricStack on ``device`` (default: CUDA)."""
    sel, src = fields.get("sel"), fields.get("src")
    if (sel is None) == (src is None):
        raise ValueError("stack fields must carry exactly one of 'sel' "
                         "(matmul layout) and 'src' (bit-sliced layout)")
    dev = resolve_device(device)
    arrays = {k: torch.as_tensor(np.array(fields[k]), dtype=dt, device=dev)
              for k, dt in _STACK_ARRAYS.items()}
    if sel is not None:
        arrays["sel"] = torch.as_tensor(
            np.asarray(sel, np.float32)).to(dev, torch.bfloat16)
    else:
        arrays["src"] = torch.as_tensor(np.array(src), dtype=torch.int32,
                                        device=dev)
    statics = {k: int(fields[k]) for k in _STACK_STATICS}
    return PackedFabricStack(
        **arrays, **statics,
        n_inputs_each=tuple(int(v) for v in fields["n_inputs_each"]),
        n_outputs_each=tuple(int(v) for v in fields["n_outputs_each"]),
    )


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":          # ml_dtypes: exact via float32
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            device, torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def lm_params_from_numpy(cfg, tree: Mapping[str, object], device=None
                         ) -> Dict[str, object]:
    """{name: np.ndarray | subtree} (a JAX LM param pytree, leaves through
    ``np.asarray``) -> the same tree of tensors on ``device`` (default:
    CUDA), dtypes kept. Every floating leaf must have the dtype the models
    give it: ``cfg``'s param_dtype, or float32 for a leaf named in
    ``layers.F32_LEAVES``."""
    from repro_torch.models.layers import F32_LEAVES, dtype_of

    dev = resolve_device(device)

    def walk(node, path, name):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{path}/{k}", k) for k, v in node.items()}
        t = _leaf(np.asarray(node), dev)
        want = torch.float32 if name in F32_LEAVES else dtype_of(cfg)
        if t.is_floating_point() and t.dtype != want:
            raise ValueError(f"leaf {path} is {t.dtype}, the models make it "
                             f"{want}")
        return t
    return walk(tree, "", "")


def plan_from_numpy(plan: Mapping[str, np.ndarray], device=None
                    ) -> Dict[str, torch.Tensor]:
    """{plan key: (C, ...) np.ndarray} -> the fused frontend's encode plan
    as device tensors (dtypes kept: int32 indices/weights, f32 scales)."""
    dev = resolve_device(device)
    missing = set(_PLAN_KEYS) - set(plan)
    if missing:
        raise ValueError(f"plan lacks {sorted(missing)}")
    return {k: torch.as_tensor(np.array(plan[k]), device=dev)
            for k in _PLAN_KEYS}


def opt_state_from_numpy(cfg, opt_cfg, tree: Mapping[str, object],
                         device=None) -> Dict[str, object]:
    """The JAX package's optimizer state (``make_opt_init`` /
    ``train_step``'s, leaves through ``np.asarray``) -> the port's, leaf
    for leaf on ``device`` (default: CUDA), keys and dtypes kept: AdamW
    {"m", "v": param trees in ``opt_cfg.moment_dtype``, "step": int32},
    Adafactor {"v": a {"vr", "vc"} or {"v"} float32 dict a param leaf,
    "step": int32}. Any other key or dtype raises ValueError."""
    dev = resolve_device(device)
    want = {"adamw": {"m", "v", "step"},
            "adafactor": {"v", "step"}}.get(opt_cfg.name)
    if want is None or set(tree) != want:
        raise ValueError(f"a {opt_cfg.name} state has the keys "
                         f"{sorted(want or ())}, got {sorted(tree)}")
    moment = (opt_cfg.moment_dtype if opt_cfg.name == "adamw"
              else "float32")

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype.name != moment:
            raise ValueError(f"leaf {path} is {a.dtype}, the optimizer "
                             f"keeps {moment}")
        return _leaf(a, dev)

    step = np.asarray(tree["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise ValueError(f"step is {step.dtype}{step.shape}, want a scalar "
                         "int32")
    out = {k: walk(v, k) for k, v in tree.items() if k != "step"}
    out["step"] = torch.tensor(step, device=dev)
    return out
