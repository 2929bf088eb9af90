"""Architecture config schema for the assigned model pool (a copy of the
reference package's `configs/base.py`; the port runs every config of
`registry.py`).

One frozen dataclass covers all six families (dense / moe / ssm / hybrid /
audio / vlm); family-specific fields default to "off". Every concrete config in
this package cites its source model card / paper in its docstring, and provides
a `smoke()` reduced variant (<=2 layers, d_model<=512, <=4 experts) used by the
per-arch CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2/V3 Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // num_heads

    # attention flavor
    qkv_bias: bool = False               # qwen1.5
    qk_norm: bool = False                # qwen3
    rope_theta: float = 10_000.0
    sliding_window: int | None = None    # local/sliding-window attention width
    # per-layer block pattern, cycled: entries in {"attn", "local", "rglru", "ssd"}
    block_pattern: tuple[str, ...] = ("attn",)

    # FFN / MoE
    act: str = "silu"                    # "silu" (gated), "gelu" (plain)
    num_experts: int = 0                 # routed experts (0 = dense FFN)
    experts_per_token: int = 0
    num_shared_experts: int = 0          # deepseek-v3: 1
    router_aux_coef: float = 0.01
    # >1 = group-limited routing: tokens are routed within groups aligned to
    # the data-parallel shards (DeepSeek-V3's node-limited routing).
    # 1 = global expert-choice (paper-faithful baseline).
    moe_groups: int = 1
    # mesh axis carrying the expert dim: "model" (baseline TP-style),
    # or "both" = (data, model) — one expert per chip, all-to-all dispatch
    expert_axis: str = "model"
    # manual dispatch/combine interior on a model mesh (models/moe_shardmap.py)
    moe_shardmap: bool = False

    # MLA (deepseek)
    mla: MLAConfig | None = None

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # RG-LRU (recurrentgemma)
    lru_width: int | None = None

    # encoder-decoder (whisper): decoder reuses the fields above
    encoder_layers: int = 0
    num_audio_frames: int = 0            # encoder input length (stub frontend)

    # vlm (phi-3-vision): stub patch embeddings prepended to the token stream
    num_patches: int = 0

    # deepseek multi-token prediction
    mtp_depth: int = 0

    # numerics / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # route training/prefill self-attention through the flash-attention
    # kernel (models.attention.FlashAttention: fused forward, blockwise
    # recompute backward). Off by default: the blockwise path is the
    # reference everywhere else.
    use_flash: bool = False
    # decode support for the 500k shape (sub-quadratic archs + sliding-window dense)
    long_context_ok: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, "GQA group size must divide"
        if self.num_experts:
            assert self.experts_per_token >= 1

    # ---- derived ----
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def param_count(self) -> int:
        """Analytic total parameter count N (for the 6ND roofline term)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.head_dim
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        for layer in range(L):
            kind = self.block_kind(layer)
            if kind in ("attn", "local"):
                if self.mla is not None:
                    m = self.mla
                    q_in = m.q_lora_rank if m.q_lora_rank else d
                    total += d * m.q_lora_rank if m.q_lora_rank else 0
                    total += q_in * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    total += self.num_heads * m.v_head_dim * d
                else:
                    total += d * self.num_heads * hd  # Q
                    total += 2 * d * self.num_kv_heads * hd  # K, V
                    total += self.num_heads * hd * d  # O
            elif kind == "ssd":
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                # split projections: [z,x] wide + [B,C] / dt narrow
                total += d * (2 * d_in + 2 * self.ssm_state + nheads)
                total += (d_in + 2 * self.ssm_state) * self.ssm_conv
                total += d_in * d  # out proj
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * d + 3 * w  # in/gate proj, out proj, lru params
            # FFN
            if self.is_moe:
                e_ff = self.d_ff
                n_e = self.num_experts + self.num_shared_experts
                total += n_e * 3 * d * e_ff  # gated: w_in, w_gate, w_out
                total += d * self.num_experts  # router
            elif kind in ("attn", "local", "rglru"):
                mult = 3 if self.act == "silu" else 2
                total += mult * d * self.d_ff
            total += 2 * d  # norms
        # encoder (whisper): plain attn + gelu mlp
        for _ in range(self.encoder_layers):
            total += 4 * d * self.num_heads * hd + 2 * d * self.d_ff + 2 * d
        if self.is_encoder_decoder:  # decoder cross-attention
            total += L * 4 * d * self.num_heads * hd
        if self.mtp_depth:
            total += self.mtp_depth * (12 * d * d + 3 * d * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        e_ff = self.d_ff
        all_routed = self.num_layers * self.num_experts * 3 * self.d_model * e_ff
        active_routed = self.num_layers * self.experts_per_token * 3 * self.d_model * e_ff
        return int(full - all_routed + active_routed)
