"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: 24 Mamba2 layers, d_model=768, d_state=128. Runs long_500k
(constant-size recurrent state — the sub-quadratic family).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    n_layers=24,
    d_model=768,
    n_heads=1,       # attention-free; kept for schema completeness
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    norm="rmsnorm",
    param_dtype="bfloat16",
    optimizer="adamw",
    num_microbatches=1,
    skip_shapes=(),
)
