"""Plain torch oracles for the QSGD wire format (port of `repro/kernels/ref.py`).

QSGD (Alistarh et al., 2017) stochastic quantization, per block of a leaf:
given a block v (size B) with L2 norm n and s levels, entry i is encoded as
sign(v_i) * q_i with p_i = |v_i| / n * s and q_i = floor(p_i + u_i), u_i a
uniform dither, and decoded as sign * q_i / s * n.

The packed wire format (what crosses a channel):
  * code c = sign(v)*q + s in [0, 2s]: b = ceil(log2(2s+1)) bits per entry;
  * bit-plane packing: with W = block/32 words per plane, word j*W + w of a
    block row holds bit j of the 32 codes {k*W + w : k in 0..31}, code
    k*W+w's bit at bit position k;
  * one f32 norm per block travels beside the payload.

32-bit words on the CPU: torch has no `>>` for uint32 and `>>` on int32
sign-extends, so the arithmetic here runs in int64 masked to 32 bits.
Payload words are stored as int32 tensors holding the uint32 bit pattern
(compare with ``.numpy().view(np.uint32)``); codes are int64.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def qsgd_code_bits(s: int) -> int:
    """Bits per packed QSGD entry: codes live in [0, 2s], sign included."""
    return max(1, math.ceil(math.log2(2 * s + 1)))


def u32_to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def i32_to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix_keyed(x: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """The two keyed murmur3-fmix32 rounds of the reference's `_cheap_uniform`."""
    x = x ^ k0
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16) ^ k1
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def cheap_uniform_ref(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Dither of `n` entries for each of S keys: keys (S, 2) int32 or int64
    key words -> (S, n) f32 on the 16-bit grid {k / 65536}.  Entry 2i and
    2i+1 are the low and high halves of hashed word i."""
    kw = keys.to(torch.int64) & MASK32
    nw = (n + 1) // 2
    idx = torch.arange(nw, dtype=torch.int64, device=keys.device)
    x = _fmix_keyed(idx[None, :], kw[:, :1], kw[:, 1:])
    halves = torch.stack([x & 0xFFFF, x >> 16], dim=2).reshape(keys.shape[0], 2 * nw)[:, :n]
    return halves.to(torch.float32) * (1.0 / 65536.0)


def qsgd_quantize_blocks_ref(v: torch.Tensor, u: torch.Tensor, s: int):
    """v, u: (n_blocks, block) f32, u in [0, 1). Returns (q int8 signed in
    [-s, s], norms f32 (n_blocks,))."""
    assert v.ndim == 2 and v.shape == u.shape
    # torch's f32 sqrt on the CPU is not correctly rounded; the f64 sqrt of
    # an f32 value rounded back to f32 is, as XLA's and the kernel's are
    norms = torch.sqrt(torch.sum(v * v, dim=1).double()).float()
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    p = torch.abs(v) / safe[:, None] * s
    q = torch.clamp(torch.floor(p + u), 0, s)
    q = torch.where(norms[:, None] > 0, q, torch.zeros_like(q))
    return (torch.sign(v) * q).to(torch.int8), norms


def _scale(norms: torch.Tensor, s: int) -> torch.Tensor:
    """norm / s per block, correctly rounded.  A tensor divisor, because
    torch on the card divides by a Python scalar as a multiply by its
    reciprocal, which rounds differently."""
    return norms[:, None] / torch.full_like(norms[:, None], s)


def qsgd_dequantize_blocks_ref(q: torch.Tensor, norms: torch.Tensor, s: int) -> torch.Tensor:
    return q.to(torch.float32) * _scale(norms, s)


def qsgd_quantize_codes_ref(v: torch.Tensor, u: torch.Tensor, s: int):
    """Sign-folded codes: (n_blocks, block) f32 -> (codes int64 in [0, 2s],
    norms f32).  Zero-norm blocks emit the all-`s` (all-zero-valued) row."""
    q, norms = qsgd_quantize_blocks_ref(v, u, s)
    return q.to(torch.int64) + s, norms


def qsgd_dequantize_codes_ref(codes: torch.Tensor, norms: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of the sign-folded map: c -> (c - s) * norm / s."""
    return (codes - s).to(torch.float32) * _scale(norms, s)


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Bit-plane pack (naive double loop — the layout's definition).
    codes (n_blocks, block) int64 -> payload (n_blocks, bits*block/32) int32."""
    nb, block = codes.shape
    assert block % 32 == 0, block
    w_per_plane = block // 32
    c = codes.reshape(nb, 32, w_per_plane)
    planes = []
    for j in range(bits):
        word = torch.zeros((nb, w_per_plane), dtype=torch.int64, device=codes.device)
        for k in range(32):
            word = word | (((c[:, k, :] >> j) & 1) << k)
        planes.append(word)
    return u32_to_i32(torch.cat(planes, dim=1))


def unpack_codes_ref(payload: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact inverse of `pack_codes_ref`: (n_blocks, bits*W) -> (n_blocks, 32*W)."""
    nb, total = payload.shape
    assert total % bits == 0, (total, bits)
    w_per_plane = total // bits
    words = i32_to_u32(payload)
    c = torch.zeros((nb, 32, w_per_plane), dtype=torch.int64, device=payload.device)
    for j in range(bits):
        word = words[:, j * w_per_plane : (j + 1) * w_per_plane]
        for k in range(32):
            c[:, k, :] |= ((word >> k) & 1) << j
    return c.reshape(nb, 32 * w_per_plane)


def signsgd_quantize_codes_ref(v: torch.Tensor):
    """1-bit sign-SGD codes with per-block norm scaling over the last axis:
    code 1 = non-negative (-0.0 included), scale = mean |v| of the block,
    zeros of the padding included.  Returns (codes int64 in {0, 1}, scales
    f32).  The block's sum is divided by a tensor (see `_scale`)."""
    total = torch.abs(v).sum(dim=-1)
    scales = total / torch.full_like(total, v.shape[-1])
    return (v >= 0).to(torch.int64), scales.to(torch.float32)


def signsgd_dequantize_codes_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Decode ±scale; all-zero blocks (scale 0) decode to exact zeros."""
    sign = codes.to(torch.float32) * 2.0 - 1.0
    return sign * scales[..., None]


def weighted_aggregate_ref(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Eq. (5) inner aggregation oracle: grads (n_clients, d), weights
    (n_clients,) -> (d,) gamma-weighted sum."""
    return torch.einsum("n,nd->d", weights, grads)
