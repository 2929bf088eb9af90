"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064,
QKV bias. [hf:Qwen/Qwen1.5-0.5B family card, 32B scale point]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
)
