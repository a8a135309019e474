"""The LM training driver's presets (the port of the JAX package's
launch/train.py).

Only ``TINY`` is here for now: the serving driver (launch/serve.py)
takes it as its default preset. The trainer itself (the sharded train
loop, checkpointing, resume, the step watchdog) follows in the training
slice (ROADMAP A.17).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

TINY = ArchConfig(
    name="tiny-lm",
    family="dense",
    source="(reduced in-repo preset)",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=1024,
    vocab=512,
    head_dim=32,
    mlp="swiglu",
    norm="rmsnorm",
    param_dtype="float32",
    optimizer="adamw",
    remat="none",
    loss_chunk=128,
)
