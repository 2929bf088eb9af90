"""RG-LRU recurrent blocks, RecurrentGemma / Griffin (arXiv:2402.19427)
(port of `repro/models/rglru.py`).

The recurrence, diagonal and per channel:
    r_t = sigmoid(W_r x_t),  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)            c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run the linear recurrence as a log-depth doubling
scan over T (`_lru_scan`): ceil(log2 T) passes of whole-tensor products,
where the reference runs `jax.lax.associative_scan`; autograd
differentiates it as it stands.  Decode is the recurrence itself, one
token at a time, in constant time (`rglru_block_decode`).

The residual block is Griffin's recurrent block: in-projections to an x
branch and a GeLU gate branch, a temporal conv1d of width 4 on the x
branch, the RG-LRU, and the gated out-projection.  Its `lambda` leaf is
f32 whatever the model's dtype; the recurrence runs in f32 and its state
`h` is cached in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import activation, dense_init

_C = 8.0


def _lru_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t from h_{-1} = 0; a, u (B, T, W).

    Pass k composes each position with the one 2^k before it,
    (A, U)_t <- (A_{t-d} A_t, A_t U_{t-d} + U_t) for t >= d, the
    reference's combine; after the passes U_t = h_t."""
    T, d = a.shape[1], 1
    while d < T:
        u = torch.cat([u[:, :d], a[:, d:] * u[:, :-d] + u[:, d:]], dim=1)
        if 2 * d < T:  # the last pass needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return u


def init_rglru_block(cfg: ArchConfig, gen: torch.Generator, dtype, lead: tuple = ()) -> dict:
    """The block's params (the reference's leaves); `lead` = (layers,)
    stacks that many blocks.  `lambda` is f32, drawn in (0.3, 0.8) so that
    a lies in (0.9, 0.999) at r = 0.5."""
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    return {
        "w_x": dense_init(gen, d, w, lead=lead, dtype=dtype),
        "w_gate": dense_init(gen, d, w, lead=lead, dtype=dtype),
        "conv_w": (torch.randn((*lead, 4, w), generator=gen, device=dev) * 0.2).to(dtype),
        "conv_b": torch.zeros((*lead, w), dtype=dtype, device=dev),
        "w_r": dense_init(gen, w, w, lead=lead, dtype=dtype),
        "w_i": dense_init(gen, w, w, lead=lead, dtype=dtype),
        "lambda": torch.rand((*lead, w), generator=gen, device=dev) * 0.5 + 0.3,
        "w_out": dense_init(gen, w, d, lead=lead, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,T,W), w (K,W).  The products are summed
    in x's dtype, in the reference's order (a Python `sum` from 0)."""
    K, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + T, :] * w[i] for i in range(K)) + b


def _gates(p: dict, xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xb (..., W) -> (a, sqrt(1 - a^2) * i * xb), both f32.  The square
    root is taken in f64 and rounded to f32 (CPU torch's f32 sqrt is not
    correctly rounded)."""
    r = torch.sigmoid(xb @ p["w_r"]).float()
    i = torch.sigmoid(xb @ p["w_i"]).float()
    a = torch.exp(-_C * F.softplus(p["lambda"]) * r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12).double()).float()
    return a, beta * i * xb.float()


def rglru_block_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,T,d) -> (B,T,d).  Training / prefill path."""
    gate = activation("gelu")(x @ p["w_gate"])
    xb = _causal_conv(x @ p["w_x"], p["conv_w"], p["conv_b"])
    a, u = _gates(p, xb)
    h = _lru_scan(a, u).to(x.dtype)
    return (h * gate) @ p["w_out"]


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """The last K - 1 = 3 conv inputs, in the model's dtype, and the f32
    state.  No `len`: the recurrence needs no position."""
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict
                       ) -> tuple[torch.Tensor, dict]:
    """x (B,1,d) against the block's cache -> (y (B,1,d), new cache), in
    constant time per token; the cache passed in is not written.  The conv
    contracts the history with an einsum, as the reference's decode does."""
    gate = activation("gelu")(x[:, 0] @ p["w_gate"])
    xb = x[:, 0] @ p["w_x"]
    hist = torch.cat([cache["conv"], xb[:, None, :]], dim=1)  # (B,4,W)
    xb = torch.einsum("bkw,kw->bw", hist, p["conv_w"]) + p["conv_b"]
    a, u = _gates(p, xb)
    h = a * cache["h"] + u
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y[:, None, :], {"conv": hist[:, 1:], "h": h}
