"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k context. [hf:mistralai/Mistral-Nemo-Base-2407]

long_500k: the base model is full-attention; to qualify a dense arch for the
500k decode shape (per the assignment's sliding-window clause) the launcher
serves the `long_variant()` below — identical weights, sliding-window(8192)
attention masks and a ring-buffer KV cache. Recorded in DESIGN.md §4.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    act="silu",
    sliding_window=8192,     # used only by the long-context serving variant
    long_context_ok=True,    # via long_variant()
)


def long_variant() -> ArchConfig:
    return dataclasses.replace(CONFIG, block_pattern=("local",))
