"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]. Sub-quadratic family: long_500k runs."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="[arXiv:2411.15242; hf]",
    n_layers=38,          # Mamba2 layers
    d_model=2_048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8_192,           # shared block MLP
    vocab=32_000,
    head_dim=64,
    mlp="gelu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    shared_attn_every=6,  # one weight-shared attn+MLP block every 6 layers
    param_dtype="bfloat16",
    optimizer="adamw",
    num_microbatches=1,
    attn_chunk=128,
    prefill_microbatches=2,
    skip_shapes=(),
)
