"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP ViT-L/14 vision tower. The vision
tower is STUBBED per the assignment carve-out: input_specs provide 576
precomputed patch embeddings (dim 1024) which a learned projector maps to
d_model. [hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    act="silu",
    num_patches=576,
)
