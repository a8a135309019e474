"""internvl2-76b — InternViT + InternLM2 VLM backbone [arXiv:2404.16821; unverified].

Per the assignment, [vlm] entries specify the transformer BACKBONE only; the
modality frontend (InternViT patch embedder) is a STUB — input_specs()
provides precomputed patch/text embeddings of shape (batch, seq, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    source="[arXiv:2404.16821; unverified]",
    n_layers=80,
    d_model=8_192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=128_256,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    embeds_in=True,
    param_dtype="bfloat16",
    optimizer="adafactor",
    fsdp=True,
    num_microbatches=8,
    act_shard="seq",
    skip_shapes=("long_500k",),  # full attention — sub-quadratic required
)
