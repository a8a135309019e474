"""Packing + entry point of the BDT inference kernel (torch port).

``pack_ensemble`` lays every tree of a QuantizedEnsemble into one padded
node axis (block-diagonal traversal, see bdt_infer.py) on a torch device
(default: CUDA); ``bdt_infer`` runs raw fixed-point features through the
ensemble and returns exact int32 raw scores, equal to
QuantizedEnsemble.decision_function_raw.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bdt import LEAF, QuantizedEnsemble
from repro_torch.device import resolve_device
from repro_torch.kernels.bdt_infer.bdt_infer import bdt_traverse


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class PackedEnsemble:
    featsel: torch.Tensor      # (F, P) int32
    thr: torch.Tensor          # (1, P) int32
    root_onehot: torch.Tensor  # (1, P) f32
    left: torch.Tensor         # (P, P) f32
    right: torch.Tensor        # (P, P) f32
    value_hi: torch.Tensor     # (P, 128) f32
    value_lo: torch.Tensor     # (P, 128) f32
    f0_raw: int
    depth: int
    n_features: int
    width: int

    @property
    def device(self) -> torch.device:
        return self.featsel.device


def pack_ensemble(ens: QuantizedEnsemble, n_features: int, *,
                  device=None) -> PackedEnsemble:
    """One padded node axis for all trees, on ``device`` (default: CUDA).
    Raw values must fit int32 (W <= 31)."""
    if ens.spec.width > 31:
        raise ValueError("kernel path needs raw values in int32 (W <= 31)")
    dev = resolve_device(device)
    sizes = [t.n_nodes for t in ens.trees]
    P = _round_up(sum(sizes), 128)
    depth = max(t.depth() for t in ens.trees)

    featsel = np.zeros((n_features, P), np.int32)
    thr = np.full((1, P), np.iinfo(np.int32).max, np.int32)
    root = np.zeros((1, P), np.float32)
    left = np.zeros((P, P), np.float32)
    right = np.zeros((P, P), np.float32)
    value = np.zeros(P, np.int64)

    off = 0
    for t in ens.trees:
        root[0, off] = 1.0
        for i in range(t.n_nodes):
            p = off + i
            f = int(t.feature[i])
            if f == LEAF:
                left[p, p] = 1.0   # self-loop
                right[p, p] = 1.0
                value[p] = int(t.value_raw[i])
            else:
                featsel[f, p] = 1
                thr[0, p] = int(t.threshold_raw[i])
                left[p, off + int(t.children_left[i])] = 1.0
                right[p, off + int(t.children_right[i])] = 1.0
        off += t.n_nodes
    for p in range(off, P):  # padding slots absorb
        left[p, p] = 1.0
        right[p, p] = 1.0

    vhi = np.zeros((P, 128), np.float32)
    vlo = np.zeros((P, 128), np.float32)
    vhi[:, 0] = (value >> 14).astype(np.float32)
    vlo[:, 0] = (value & 0x3FFF).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return PackedEnsemble(
        featsel=t(featsel), thr=t(thr), root_onehot=t(root), left=t(left),
        right=t(right), value_hi=t(vhi), value_lo=t(vlo),
        f0_raw=int(ens.f0_raw), depth=int(depth),
        n_features=int(n_features), width=int(ens.spec.width),
    )


def bdt_infer(
    packed_or_ens,
    x_raw,
    n_features: int | None = None,
    batch_tile: int = 256,
    *,
    device=None,
) -> torch.Tensor:
    """(B, F) int32 raw features -> (B,) exact int32 raw scores on the
    packed ensemble's device. The batch is padded to a ``batch_tile``
    multiple, as the reference pads it; the score is column 0 plus f0 in
    wrapping int32. ``device`` places a raw ensemble when it is packed
    here."""
    packed = (
        packed_or_ens
        if isinstance(packed_or_ens, PackedEnsemble)
        else pack_ensemble(packed_or_ens, n_features, device=device)
    )
    x = torch.as_tensor(np.asarray(x_raw, np.int32), device=packed.device)
    B = x.shape[0]
    Bp = _round_up(max(B, 1), batch_tile)
    if Bp != B:
        x = torch.nn.functional.pad(x, (0, 0, 0, Bp - B))
    out = bdt_traverse(
        x, packed.featsel, packed.thr, packed.root_onehot, packed.left,
        packed.right, packed.value_hi, packed.value_lo, depth=packed.depth)
    return out[:B, 0] + torch.tensor(packed.f0_raw, dtype=torch.int32,
                                     device=packed.device)
