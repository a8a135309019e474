"""grok-1-314b — 8 experts top-2 MoE [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    source="[hf:xai-org/grok-1; unverified]",
    n_layers=64,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    head_dim=128,
    mlp="gelu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    expert_d_ff=32_768,
    capacity_factor=1.25,
    moe_group_size=512,
    expert_slices=2,   # 8 experts x 2 F-slices = 16 virtual experts (EP=16)
    param_dtype="bfloat16",
    optimizer="adafactor",
    fsdp=True,
    num_microbatches=8,
    act_shard="seq",
    attn_chunk=256,
    prefill_microbatches=8,
    kv_cache_dtype="int8",
    skip_shapes=("long_500k",),
)
