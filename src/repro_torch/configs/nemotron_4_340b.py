"""nemotron-4-340b — GQA, squared-ReLU MLP [arXiv:2402.16819; unverified].

The largest assigned dense model: full 2D sharding (TP over "model" +
FSDP/ZeRO-3 over "data") and a factored optimizer are required to fit
16 GB/chip — see DESIGN.md §5 and the dry-run memory analysis.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    source="[arXiv:2402.16819; unverified]",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab=256_000,
    head_dim=192,
    mlp="relu2",         # squared ReLU
    norm="layernorm",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    optimizer="adafactor",
    fsdp=True,
    num_microbatches=8,
    act_shard="seq",
    attn_chunk=256,
    grad_accum_dtype="bfloat16",
    prefill_microbatches=8,
    kv_cache_dtype="int8",
    skip_shapes=("long_500k",),
)
