"""gemma-7b — GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    source="[arXiv:2403.08295; hf]",
    n_layers=28,
    d_model=3_072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24_576,
    vocab=256_000,
    head_dim=256,        # 16 heads x 256 != d_model — explicit head_dim
    mlp="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    optimizer="adamw",
    num_microbatches=4,
    act_shard="seq",
    kv_cache_dtype="int8",
    skip_shapes=("long_500k",),
)
