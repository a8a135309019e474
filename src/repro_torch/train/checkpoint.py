"""Fault-tolerant checkpointing: atomic writes, integrity hashes, retention
(the port of the JAX package's train/checkpoint.py, the same files).

Layout (one directory per step):

    <dir>/step_00000120/
        arrays.npz          flattened pytree ("/"-joined paths -> arrays)
        MANIFEST.json       {step, keys, sha256, extra}
    <dir>/LATEST            text file: "step_00000120"

Guarantees:
  * atomicity — arrays + manifest are written into step_XXXXXXXX.tmp and
    os.replace()'d into place; a crash mid-write never corrupts LATEST;
  * integrity — sha256 over the npz payload is verified on restore;
  * interchange — the files are the reference's: a checkpoint written by
    the JAX package restores here and the reverse, f32 and int32 leaves
    bit for bit.

Leaves are saved through ``.cpu().numpy()`` (numpy arrays and Python
numbers as they are). torch's bfloat16 has no numpy dtype, so a bf16 leaf
raises ``CheckpointError`` naming its key instead of being cast; the
trainer makes none (float32 params and moments). A DTensor leaf is saved
whole (gathered: every rank calls ``save``, see launch/train.py).
``restore(template, step=None, device=None, shardings=None)`` checks
every key and shape against the template and puts each leaf on
``device``, or where the template's leaf is (a template leaf that is not
a tensor: the default device, CUDA); with ``shardings`` (a tree of
``parallel.sharding.NamedSharding`` matching the template, the elastic
reshard path) each leaf is placed as a DTensor under its sharding.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train import tree as T

PyTree = Any


class CheckpointError(RuntimeError):
    pass


def _as_numpy(key: str, leaf) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise CheckpointError(
                f"leaf {key!r} is bfloat16, which numpy cannot hold: "
                "checkpoint float32 state")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {key: _as_numpy(key, leaf) for key, leaf in T.items(tree)}


def _unflatten_like(template: PyTree, flat: Dict[str, np.ndarray],
                    device) -> PyTree:
    keys, values = [], []
    for key, leaf in T.items(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} "
                             f"vs model {tuple(np.shape(leaf))}")
        dev = (resolve_device(device) if device is not None
               else leaf.device if torch.is_tensor(leaf)
               else resolve_device(None))
        keys.append(key)
        # a copy into torch's own (aligned) memory: the CPU's matrix
        # products round by the alignment of their operands, so a
        # resumed run would drift from an uninterrupted one in numpy's
        values.append(torch.tensor(arr, device=dev))
    if not isinstance(template, dict):
        return values[0]
    return T.unflatten(keys, values)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None
             ) -> str:
        flat = _flatten(tree)
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "sha256": _sha256(npz_path),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.isdir(os.path.join(self.dir, name)):
                return int(m.group(1))
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: Optional[int] = None,
                device=None, shardings: Optional[PyTree] = None
                ) -> Tuple[int, PyTree]:
        """(step, the checkpoint in the structure of ``template``), each
        leaf on ``device`` or, by default, where the template's leaf is
        (CUDA for a template leaf that is not a tensor); with
        ``shardings``, each leaf a DTensor under its ``NamedSharding``
        (every rank reads the same files and takes its own shards)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        npz_path = os.path.join(d, "arrays.npz")
        if _sha256(npz_path) != manifest["sha256"]:
            raise CheckpointError(f"integrity failure (sha256) in {d}")
        with np.load(npz_path) as z:
            flat = {k: z[k] for k in z.files}
        if shardings is None:
            return step, _unflatten_like(template, flat, device)
        from repro_torch.parallel.sharding import distribute

        host = _unflatten_like(template, flat, torch.device("cpu"))
        return step, T.map_leaves(
            lambda x, sh: distribute(
                x.to(torch.device(sh.mesh.device_type)), sh,
                src_data_rank=None), host, shardings)
