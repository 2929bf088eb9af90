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

`normal_ref` at the end is the plain version of `csrc/prng.cu`'s weight
draw: `jax.random.normal` bit for bit, what `init_params` runs on the CPU.

32-bit words on the CPU: torch has no `>>` for uint32 and `>>` on int32
sign-extends, so the arithmetic here runs in int64 masked to 32 bits.
Payload words are stored as int32 tensors holding the uint32 bit pattern
(compare with ``.numpy().view(np.uint32)``); codes are int64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import prng

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


# ---------------------------------------------------------------------------
# jax.random.normal, bit for bit (the plain version of csrc/prng.cu)
# ---------------------------------------------------------------------------

_NORMAL_CHUNK = 1 << 15  # entries a pass on the CPU (see `normal_ref`)
# XLA's f32 `log1p` (Cephes' rational form below |x| = sqrt(2) - 1, else the
# log of 1 + x by Cephes' `logf`, whose constants `core/prng.py` holds) and
# f32 `erf_inv` (Giles' polynomials, w < 5 and w >= 5), as f32-exact floats
(_LOG1P_NUM, _LOG1P_DEN, _ERFINV_LT5, _ERFINV_GE5) = (tuple(
    float(np.float32(c)) for c in cs) for cs in ((
        4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
        2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
        2.0039553499201281259648e1), (
        1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
        3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1), (
        2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
        -0.00125372503, -0.00417768164, 0.246640727, 1.50140941), (
        -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
        -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)))
_LOG_P = tuple(float(c) for c in prng._LOG_P)
_LOG_Q1, _LOG_Q2 = float(prng._LOG_Q1), float(prng._LOG_Q2)
_SQRT2, _LOG_LOW = float(np.float32(np.sqrt(2))), float(np.float32(0.707106781186547524))
_LOG1P_LARGE = float(np.float32(0.41421356237309504880))
_U_LO = float(np.nextafter(np.float32(-1), np.float32(0)))


class _Fma:
    """XLA's f32 fused multiply-adds as an f64 product and sum: the f32
    product is exact in f64, and the f64 sum is rounded to f32.
    That rounds twice, and differs from one rounding where the f64 sum
    lies exactly halfway between two f32 values and was itself inexact;
    `scripts/torch_fma_halfway.py` counts such sums in these polynomials.
    Work tensors are allocated once per chunk: a fresh large tensor per
    operation costs more than the operation on this path."""

    def __init__(self, n: int, device):
        self.a, self.s = (torch.empty(n, dtype=torch.float64, device=device) for _ in range(2))

    def __call__(self, a: torch.Tensor, b, c, out: torch.Tensor) -> torch.Tensor:
        """out = fma(a, b, c) in f32: a an f32 tensor, b an f64 tensor (an
        f32 tensor's f64 copy) or an f32-exact Python float, c an f32
        tensor or an f32-exact Python float."""
        torch.mul(self.a.copy_(a), b, out=self.s).add_(c)
        return out.copy_(self.s)


def _log_ref(fma: _Fma, v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log of positive normal `v` (Cephes' `logf`)."""
    m, e = torch.frexp(v)
    low = (m < _LOG_LOW).float()
    x = (m - 1.0) + m * low
    e = e.float() - low
    x2 = x * x
    x3 = x2 * x
    p, x64, x3_64 = _LOG_P, x.double(), x3.double()
    y, y1, y2 = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    fma(fma(x, p[0], p[1], y), x64, p[2], y)
    fma(fma(x, p[3], p[4], y1), x64, p[5], y1)
    fma(fma(x, p[6], p[7], y2), x64, p[8], y2)
    fma(fma(y, x3_64, y1, y), x3_64, y2, y)
    fma(y, x3_64, e * _LOG_Q1, y)
    # an FMA whose product is exact in f32 (x2 / 2, and e times Q2's 9 bits)
    # rounds as the f32 sum of that product does
    x = (x2 * -0.5 + x) + y
    return e * _LOG_Q2 + x


def _log1p_ref(fma: _Fma, x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p of `x` in (-1, 0]: Cephes' rational form where |x| <
    sqrt(2) - 1, else the log of 1 + x, each computed on its own entries."""
    large = (x <= -_LOG1P_LARGE).nonzero().squeeze(1)
    out = _log1p_small(fma, x)
    if len(large):
        xl = x[large]
        out[large] = _log_ref(_Fma(len(large), x.device), xl + 1.0)
    return out


def _log1p_small(fma: _Fma, x: torch.Tensor) -> torch.Tensor:
    x64 = x.double()
    num, den = torch.empty_like(x), torch.empty_like(x)
    fma(x, _LOG1P_NUM[0], _LOG1P_NUM[1], num)
    torch.add(x, _LOG1P_DEN[1], out=den)  # the leading 1 of the denominator
    for cn, cd in zip(_LOG1P_NUM[2:], _LOG1P_DEN[2:]):
        fma(num, x64, cn, num)
        fma(den, x64, cd, den)
    x2 = x * x
    return x + (x2 * -0.5 + (x * x2) * (num / den))


def _erf_inv_ref(fma: _Fma, x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv of `x` in (-1, 1): Giles' polynomial in w - 2.5
    where w = -log(1 - x^2) < 5, else (about 1 entry in 300) in sqrt(w) - 3,
    with the f64 sqrt rounded to f32, which is the correctly rounded one."""
    w = _log1p_ref(fma, x * -x).neg_()
    tail = (w >= 5.0).nonzero().squeeze(1)
    p = _erf_inv_poly(fma, w - 2.5, _ERFINV_LT5)
    if len(tail):
        wt = torch.sqrt(w[tail].double()).float() - 3.0
        p[tail] = _erf_inv_poly(_Fma(len(tail), x.device), wt, _ERFINV_GE5)
    return p * x


def _erf_inv_poly(fma: _Fma, w: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    p, w64 = torch.empty_like(w), w.double()
    fma(w, coeffs[0], coeffs[1], p)
    for c in coeffs[2:]:
        fma(p, w64, c, p)
    return p


def _threefry_bits(k0: int, k1: int, start: int, n: int, device="cpu") -> torch.Tensor:
    """Random bits of `jax.random` (partitionable threefry2x32) for flat
    indices [start, start + n): the 20-round hash of each 64-bit index
    (high word, low word), the two output words xor'ed.  int64 tensors
    holding 32-bit words, updated in place; x0 is masked only where it is
    read as a word (it only ever grows by sums, so its low word is right)."""
    ks = (k0, k1, k0 ^ k1 ^ int(prng._PARITY))
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    x0 = (idx >> 32).add_(ks[0])
    x1 = idx.bitwise_and_(MASK32).add_(ks[1]).bitwise_and_(MASK32)
    y = torch.empty_like(x1)
    for i in range(5):
        for r in prng._ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=y)
            torch.bitwise_right_shift(y, 32, out=x1)
            x1.bitwise_or_(y).bitwise_xor_(x0).bitwise_and_(MASK32)  # rotl(x1, r) ^ x0
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK32)
    return x0.bitwise_xor_(x1).bitwise_and_(MASK32)


def _normal_chunk(k0: int, k1: int, start: int, n: int, device) -> torch.Tensor:
    bits = _threefry_bits(k0, k1, start, n, device)
    floats = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(torch.int32) \
        .view(torch.float32) - 1.0
    u = torch.clamp_min(floats * 2.0 + _U_LO, _U_LO)  # floats * f32(1 - lo) + lo: f32(1 - lo) = 2
    return _erf_inv_ref(_Fma(n, device), u) * _SQRT2


def normal_ref(key, offset: int, n: int, scale: float, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Entries [offset, offset + n) of `jax.random.normal(key, shape,
    float32)` over any shape (its flat index), times the f32 `scale`, then
    rounded to `dtype` (f32, or bf16 to nearest even): an (n,) tensor.
    `key` is the two uint32 key words.

    On the CPU (what `init_params` runs there) in chunks of `_NORMAL_CHUNK`
    entries, no more than one of torch's parallel grains: each of a chunk's
    few hundred operations runs on the calling thread and waits on no other
    core.  Split over the cores, every operation would wait for all of
    them, and under a parallel test run (six processes on eight cores) that
    wait made the draw three hundred times slower.  On the card (only to
    compare with the kernel) in chunks of 2^24."""
    k0, k1 = (int(k) & MASK32 for k in key)
    scale = float(np.float32(scale))
    out = torch.empty(n, dtype=dtype, device=device)
    chunk = _NORMAL_CHUNK if out.device.type == "cpu" else 1 << 24
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        out[lo:lo + m] = (_normal_chunk(k0, k1, offset + lo, m, out.device) * scale).to(dtype)
    return out
