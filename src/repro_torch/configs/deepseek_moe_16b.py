"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="[arXiv:2401.06066; hf]",
    n_layers=28,
    d_model=2_048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1_408,           # per-expert hidden (fine-grained experts)
    vocab=102_400,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1_408,
    capacity_factor=1.25,
    moe_group_size=1_024,
    param_dtype="bfloat16",
    optimizer="adamw",
    num_microbatches=8,
    act_shard="seq",
    kv_cache_dtype="int8",
    skip_shapes=("long_500k",),
)
