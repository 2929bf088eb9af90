"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA attention
(kv latent 512, rope 64), MoE: 1 shared + 256 routed top-8 (expert d_ff=2048),
MTP depth 1, vocab=129280. [arXiv:2412.19437]"""
from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,      # MLA replaces GQA; kept for schema uniformity
    head_dim=192,          # qk_nope (128) + qk_rope (64)
    d_ff=2048,             # per-expert width
    vocab_size=129280,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
    rope_theta=10_000.0,
    act="silu",
)
