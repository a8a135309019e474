"""Plain oracle for the selection-matmul fabric kernels (torch port).

Operates on the same packed arrays as the kernels (ops.pack_fabric), one
chip, with the reference's math written out level by level; FabricSim
(numpy, core/fabric.py) is the second, independently written oracle.

  V : (B, N) net values as f32 0/1, N = padded net count
  per level l:
    ins = V_l @ S_l          S_l: (rows, 4*M) one-hot selection -> (B, 4*M)
    idx = sum_k 2^k ins[:, k*M:(k+1)*M]                          (B, M)
    out = one_hot(idx, 16) . T_l        T_l: (M, 16)             (B, M)
    V[:, base_l : base_l + M] = out

where V_l is the whole buffer for a dense PackedFabric, or [input segment
| K-level window at win_base[l]] for a banded one.
"""
from __future__ import annotations

import torch


def fabric_eval_ref(packed, bits: torch.Tensor) -> torch.Tensor:
    """bits: (B, n_inputs) 0/1 -> (B, n_outputs) uint8 on a matmul-layout
    ``PackedFabric`` (dense or banded)."""
    B = bits.shape[0]
    M = packed.m_pad
    band_m = packed.sel.shape[1] - packed.in_seg
    v = torch.zeros((B, packed.n_nets_pad), dtype=torch.float32,
                    device=bits.device)
    v[:, 1] = 1.0                                            # const1
    v[:, 2 : 2 + packed.n_inputs] = bits.to(torch.float32)
    k16 = torch.arange(16, dtype=torch.int32, device=bits.device)
    for l in range(packed.n_levels):
        sel = packed.sel[l].to(torch.float32)                # (rows, 4*M)
        if packed.banded:
            w = int(packed.win_base[l])
            v_l = torch.cat([v[:, : packed.in_seg], v[:, w : w + band_m]],
                            dim=1)
        else:
            v_l = v
        ins = (v_l @ sel).reshape(B, 4, M)
        idx = (ins[:, 0] + 2.0 * ins[:, 1] + 4.0 * ins[:, 2]
               + 8.0 * ins[:, 3]).to(torch.int32)            # (B, M)
        onehot = (idx[..., None] == k16).to(torch.float32)   # (B, M, 16)
        out = torch.sum(onehot * packed.tables[l][None], dim=-1)
        base = int(packed.level_base[l])
        v[:, base : base + M] = out
    return v[:, packed.output_nets.long()].to(torch.uint8)
