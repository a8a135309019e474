"""phi3-medium-14b — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    source="[arXiv:2404.14219; unverified]",
    n_layers=40,
    d_model=5_120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17_920,
    vocab=100_352,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    optimizer="adamw",
    num_microbatches=8,
    act_shard="seq",
    skip_shapes=("long_500k",),
)
