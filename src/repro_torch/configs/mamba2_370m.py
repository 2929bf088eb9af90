"""mamba2-370m [ssm] — 48L d_model=1024, attention-free SSD blocks,
ssm_state=128, vocab=50280. [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,        # unused (attention-free); kept for schema uniformity
    num_kv_heads=16,
    d_ff=0,              # SSD blocks are mixer-only
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    long_context_ok=True,  # constant-size recurrent state -> 500k decode
)
