"""Dense feed-forward block (port of the dense half of `repro/models/ffn.py`;
the Mixture-of-Experts block is not ported)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import activation, dense_init


def init_ffn(cfg: ArchConfig, gen: torch.Generator, dtype, lead: tuple = ()) -> dict:
    """Gated (SwiGLU-family, act "silu") or plain FFN params; `lead` =
    (layers,) stacks that many blocks."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {
            "w_gate": dense_init(gen, d, f, lead=lead, dtype=dtype),
            "w_in": dense_init(gen, d, f, lead=lead, dtype=dtype),
            "w_out": dense_init(gen, f, d, lead=lead, dtype=dtype),
        }
    return {
        "w_in": dense_init(gen, d, f, lead=lead, dtype=dtype),
        "b_in": torch.zeros((*lead, f), dtype=dtype, device=gen.device),
        "w_out": dense_init(gen, f, d, lead=lead, dtype=dtype),
        "b_out": torch.zeros((*lead, d), dtype=dtype, device=gen.device),
    }


def ffn_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    if "w_gate" in p:
        return (act(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    return act(x @ p["w_in"] + p["b_in"]) @ p["w_out"] + p["b_out"]
