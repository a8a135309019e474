"""Architecture / run configuration schema.

One ``ArchConfig`` per assigned architecture lives in configs/<id>.py; the
registry in configs/__init__.py resolves ``--arch <id>`` strings. Shape
presets (train_4k / prefill_32k / decode_32k / long_500k) are defined here
because they are shared across the LM family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned input-shape set (same for all 10 LM-family archs).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Smoke-test shape (reduced, CPU-runnable).
SMOKE_SHAPE = ShapeSpec("smoke", 64, 2, "train")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec | vlm
    source: str            # provenance note "[arXiv:...; tier]"

    # transformer backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    mlp: str = "swiglu"                     # swiglu | geglu | relu2 | gelu
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0                    # per-expert hidden size
    capacity_factor: float = 1.25
    moe_group_size: int = 1_024             # dispatch group length (tokens)

    # SSM (Mamba2 / SSD)
    expert_slices: int = 1                  # split each expert into s F-slices
    # (exact for elementwise MLPs: y = sum_s act(x@W1_s)@W2_s). Lets a
    # few-big-expert model (grok: E=8) present E*s virtual experts that
    # divide the 16-way model axis -> clean expert-parallel sharding.
    moe_token_axes: Tuple[str, ...] = ()    # shard MoE token-groups over
    # these mesh axes (few-expert models where E < model-axis: groups use
    # ALL devices while expert weights FSDP-gather per layer)

    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style shared attention blocks)
    shared_attn_every: int = 0              # apply shared block every N layers

    # enc-dec (whisper-style); frontend is a stub per the assignment
    n_enc_layers: int = 0
    enc_len: int = 1_500

    # vlm: inputs are precomputed patch/text embeddings (stub frontend)
    embeds_in: bool = False

    # numerics / memory policy
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"                # adamw | adafactor
    remat: str = "full"                     # full | dots | none
    num_microbatches: int = 1               # grad-accumulation steps
    fsdp: bool = False                      # shard params over the data axis too
    pure_fsdp: bool = False                 # ZeRO-3/FSDP over ALL axes, no TP
    # (beyond-paper §Perf lever: for <=16B models at large token batches,
    # FSDP param-gathers move ~3x params/step vs Megatron-SP's ~8x
    # activations/step — see EXPERIMENTS.md §Perf starcoder2 hillclimb)
    # activation sharding of the residual stream between blocks:
    #   "none" — replicated over "model" (baseline for small/mid archs)
    #   "seq"  — sequence dim sharded over "model" (Megatron-style sequence
    #            parallelism; required for the >=70B archs to fit HBM)
    act_shard: str = "none"
    act_dp_axes: Tuple[str, ...] = ("data",)  # batch-dim mesh axes for acts
    loss_chunk: int = 1_024                 # chunked-xent sequence chunk
    attn_chunk: int = 512                   # flash-style query-chunked attention
    grad_accum_dtype: str = "float32"       # microbatch grad accumulator dtype
    prefill_microbatches: int = 1           # sequential prefill waves (serving)
    decode_unroll: bool = False             # unroll decode layer loop (aliasing)
    # KV-cache storage dtype for decode. "int8" stores absmax-quantized
    # entries + per-(layer,batch,pos) bf16 scales — the paper's at-source
    # quantization idea applied to decode memory (2x vs bf16; needed where
    # XLA's while-loop double-buffering would not fit 32k caches in HBM).
    kv_cache_dtype: str = "bfloat16"

    # which assigned shapes apply (long_500k only for sub-quadratic archs)
    skip_shapes: Tuple[str, ...] = ()

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def shapes(self):
        out = []
        for s in SHAPES.values():
            if s.name in self.skip_shapes:
                continue
            out.append(s)
        return out

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.resolved_head_dim()
        attn = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) + (
            self.n_heads * hd) * D
        mlp_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        if self.family == "moe":
            mlp = self.n_experts * mlp_mult * D * self.expert_d_ff
            mlp += self.n_shared_experts * mlp_mult * D * self.expert_d_ff
            mlp += D * self.n_experts  # router
        elif self.family in ("ssm",):
            mlp = 0
        else:
            mlp = mlp_mult * D * F
        if self.family == "ssm":
            d_in = self.ssm_expand * D
            per_layer = D * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim)
            per_layer += d_in * D  # out proj
            layers = L * per_layer
        elif self.family == "hybrid":
            d_in = self.ssm_expand * D
            ssm_per = D * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * D
            n_shared_apps = 1  # weights shared
            layers = L * ssm_per + n_shared_apps * (attn + 3 * D * F)
        elif self.family == "encdec":
            # enc self-attn+mlp, dec self+cross+mlp
            layers = self.n_enc_layers * (attn + mlp) + L * (2 * attn + mlp)
        else:
            layers = L * (attn + mlp)
        emb = V * D * (1 if self.tie_embeddings else 2)
        return layers + emb

    def active_param_count(self) -> int:
        """Activated params per token (MoE uses top_k + shared)."""
        if self.family != "moe":
            return self.param_count()
        D, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim()
        attn = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) + (
            self.n_heads * hd) * D
        mlp_mult = 3
        act_mlp = (self.top_k + self.n_shared_experts) * mlp_mult * D * self.expert_d_ff
        emb = self.vocab * D * 2
        return L * (attn + act_mlp + D * self.n_experts) + emb
