"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288,
RG-LRU + local attention in a 2:1 pattern (two recurrent blocks per local-
attention block), window 2048, vocab=256000. [arXiv:2402.19427]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    sliding_window=2048,
    lru_width=4096,
    act="gelu",
    long_context_ok=True,  # O(1) recurrent state + bounded local window
)
