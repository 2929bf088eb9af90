"""whisper-tiny [audio] — enc-dec, 4L decoder (+4L encoder) d_model=384 6H
d_ff=1536 vocab=51865. Conv/mel frontend is STUBBED per the assignment
carve-out: input_specs provide precomputed frame embeddings (1500, 384).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    encoder_layers=4,
    num_audio_frames=1500,
)
