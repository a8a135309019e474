"""starcoder2-7b — GQA + RoPE code model [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    source="[arXiv:2402.19173; hf]",
    n_layers=32,
    d_model=4_608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab=49_152,
    head_dim=128,
    mlp="gelu",          # starcoder2 uses a plain GELU MLP
    norm="layernorm",
    rope_theta=100_000.0,
    param_dtype="bfloat16",
    optimizer="adamw",
    num_microbatches=8,
    act_shard="seq",
    skip_shapes=("long_500k",),
)
