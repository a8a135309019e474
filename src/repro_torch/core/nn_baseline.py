"""The paper's NN baseline (§5): a small fully-connected net that DOESN'T fit.

"An initial attempt was to design a simple Neural Network with two or three
fully connected layers. Despite utilizing a few nodes per layer, this
shallow NN required over 6,000 LUTs, significantly exceeding the capacity of
the 28nm eFPGA ASIC."

We reproduce both halves of that finding:

  * a trainable MLP (the accuracy side — it *is* a competent classifier;
    the problem is resources, not learning);
  * an hls4ml-style LUT cost estimator for a fully-unrolled fixed-point
    implementation (the resource side — lands >6,000 LUTs for 2–3 layers of
    "a few nodes", >> 448 available).

Cost model (fully parallel, II=1, no DSPs — matching the paper's statement
that the BDT needs no DSP/BRAM while the NN would):
  - W_w x W_x multiplier ≈ W_w*W_x/2 LUT4s (Booth/array synthesis estimate)
  - adder tree per neuron: (fan_in-1) adds x acc_width/2 LUT4s
  - ReLU: acc_width/2 LUT4s (sign mux); bias add: acc_width/2

The port (PyTorch): the MLP is an ``nn.Module`` with the reference's
weight layout, trained by the reference's loop on the card by default.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    layer_sizes: Tuple[int, ...] = (14, 8, 4, 1)  # "a few nodes per layer"
    weight_bits: int = 8
    act_bits: int = 8
    acc_bits: int = 16


def lut_cost(spec: MLPSpec) -> Dict[str, int]:
    """hls4ml-style fully-unrolled LUT estimate."""
    mults = 0
    adders = 0
    relus = 0
    for fan_in, n_out in zip(spec.layer_sizes[:-1], spec.layer_sizes[1:]):
        mults += fan_in * n_out
        adders += max(fan_in - 1, 0) * n_out + n_out  # tree + bias
        relus += n_out
    lut_mult = mults * (spec.weight_bits * spec.act_bits) // 2
    lut_add = adders * spec.acc_bits // 2
    lut_relu = relus * spec.acc_bits // 2
    total = lut_mult + lut_add + lut_relu
    return {
        "multipliers": mults,
        "lut_mult": lut_mult,
        "lut_add": lut_add,
        "lut_relu": lut_relu,
        "lut_total": total,
    }


def dsp_schedule(spec: MLPSpec, n_dsp: int = 4, clock_mhz: float = 200.0) -> Dict[str, float]:
    """Time-multiplexed DSP mapping (the alternative to LUT multipliers).

    The 28nm fabric has 4 DSP slices (8x8 MAC). Scheduling the NN's MACs
    over them: cycles = ceil(total_MACs / n_dsp); at the 200 MHz P&R clock
    the latency blows through the 25 ns bunch-crossing budget by >10x —
    the quantitative second half of the paper's "NN does not fit" finding
    (resources AND latency).
    """
    macs = 0
    for fan_in, n_out in zip(spec.layer_sizes[:-1], spec.layer_sizes[1:]):
        macs += fan_in * n_out
    cycles = -(-macs // n_dsp)
    ns = cycles / clock_mhz * 1e3
    return {"macs": macs, "cycles": float(cycles), "latency_ns": ns,
            "meets_25ns": ns < 25.0}


class MLP(nn.Module):
    """The fully connected net: ReLU between layers, one logit out. Layer
    i's weight ``w[i]`` is stored (n_in, n_out) and applied as ``x @ w``,
    as the reference's ``{"w", "b"}`` list is."""

    def __init__(self, layers: Sequence[Dict[str, torch.Tensor]]):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(p["w"]) for p in layers])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in layers])

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        """The parameters as the reference's list of {"w", "b"}."""
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_logits(self.layers(), x)


def init_mlp(generator: torch.Generator, spec: MLPSpec,
             device=None) -> MLP:
    """He-normal weights drawn from ``generator`` (a CPU generator, so the
    draw does not depend on the device), zero biases."""
    dev = resolve_device(device)
    layers = []
    for n_in, n_out in zip(spec.layer_sizes[:-1], spec.layer_sizes[1:]):
        w = torch.randn((n_in, n_out), generator=generator,
                        dtype=torch.float32) * (2.0 / n_in) ** 0.5
        layers.append({"w": w.to(dev),
                       "b": torch.zeros((n_out,), dtype=torch.float32,
                                        device=dev)})
    return MLP(layers)


def mlp_logits(params: Union[MLP, Sequence[Dict[str, torch.Tensor]]],
               x: torch.Tensor) -> torch.Tensor:
    layers = params.layers() if isinstance(params, MLP) else params
    h = x
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if i + 1 < len(layers):
            h = torch.relu(h)
    return h[..., 0]


def train_mlp(
    X: np.ndarray,
    y: np.ndarray,
    spec: MLPSpec = MLPSpec(),
    steps: int = 300,
    batch: int = 4096,
    lr: float = 3e-3,
    seed: int = 0,
    device=None,
):
    """Plain Adam training loop, the reference's: the same normalisation,
    the same numpy minibatch draws (``rng.integers``), the same loss and
    Adam update (torch.optim.Adam adds ``eps`` after the square root, as
    the reference does). Runs on ``device`` (default: CUDA). Returns
    (MLP, {"mu", "sd"}, the last step's loss)."""
    dev = resolve_device(device)
    mu = X.mean(0, keepdims=True)
    sd = X.std(0, keepdims=True) + 1e-6
    Xn = ((X - mu) / sd).astype(np.float32)
    model = init_mlp(torch.Generator().manual_seed(seed), spec, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.default_rng(seed)
    loss = None
    for _ in range(steps):
        idx = rng.integers(0, len(Xn), batch)
        xb = torch.as_tensor(Xn[idx], device=dev)
        yb = torch.as_tensor(y[idx].astype(np.float32), device=dev)
        z = model(xb)
        loss = torch.mean(torch.clamp(z, min=0) - z * yb
                          + torch.log1p(torch.exp(-torch.abs(z))))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    norm = {"mu": mu, "sd": sd}
    return model, norm, float(loss.detach())


def mlp_proba(params, norm, X: np.ndarray) -> np.ndarray:
    """Sigmoid of the logits on ``X`` (numpy in, numpy out), on the
    parameters' device."""
    layers = params.layers() if isinstance(params, MLP) else params
    dev = layers[0]["w"].device
    Xn = (X - norm["mu"]) / norm["sd"]
    with torch.no_grad():
        z = mlp_logits(layers, torch.as_tensor(
            np.asarray(Xn, np.float32), device=dev))
        return torch.sigmoid(z).cpu().numpy()
