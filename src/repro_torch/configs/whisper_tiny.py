"""whisper-tiny — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

Per the assignment, the audio frontend is a stub: input_specs() provides
precomputed log-mel frame embeddings (batch, enc_len, d_model). Enc-dec has
a decoder, so decode shapes run; long_500k is skipped (full attention).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    source="[arXiv:2212.04356; unverified]",
    n_layers=4,           # decoder layers
    n_enc_layers=4,
    enc_len=1_500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1_536,
    vocab=51_865,
    head_dim=64,
    mlp="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    optimizer="adamw",
    num_microbatches=1,
    skip_shapes=("long_500k",),
)
