"""Architecture registry: `--arch <id>` resolution + reduced smoke variants.

Smoke variants obey the assignment bounds: <=2 layers (hybrids use one full
3-block pattern), d_model<=512, <=4 experts; float32 on CPU.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.configs import (  # noqa: F401  (import side table below)
    dbrx_132b,
    deepseek_v3_671b,
    mamba2_370m,
    mistral_nemo_12b,
    phi3_vision_4_2b,
    qwen1_5_32b,
    qwen3_0_6b,
    recurrentgemma_9b,
    starcoder2_3b,
    whisper_tiny,
)

_MODULES = {
    "qwen1.5-32b": qwen1_5_32b,
    "dbrx-132b": dbrx_132b,
    "mamba2-370m": mamba2_370m,
    "qwen3-0.6b": qwen3_0_6b,
    "whisper-tiny": whisper_tiny,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
    "starcoder2-3b": starcoder2_3b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mistral-nemo-12b": mistral_nemo_12b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return _MODULES[arch_id].CONFIG


def long_context_config(arch_id: str) -> ArchConfig:
    """Config actually served for long_500k (mistral-nemo swaps in SWA)."""
    cfg = get_config(arch_id)
    if arch_id == "mistral-nemo-12b":
        return mistral_nemo_12b.long_variant()
    assert cfg.long_context_ok, f"{arch_id} does not support long_500k"
    return cfg


def smoke_config(arch_id: str) -> ArchConfig:
    cfg = get_config(arch_id)
    plen = len(cfg.block_pattern)
    layers = plen if plen > 1 else 2
    updates: dict = dict(
        num_layers=layers,
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.is_moe:
        updates.update(num_experts=4, experts_per_token=2)
    if cfg.mla is not None:
        updates.update(
            mla=MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32,
            ),
            head_dim=48,
        )
    if cfg.block_pattern != ("attn",):
        # keep block kinds; shrink windows/states
        updates.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=16)
        if cfg.sliding_window:
            updates["sliding_window"] = 16
        if cfg.lru_width:
            updates["lru_width"] = 256
    if cfg.encoder_layers:
        updates.update(encoder_layers=2, num_audio_frames=24)
    if cfg.num_patches:
        updates["num_patches"] = 8
    return dataclasses.replace(cfg, **updates)
