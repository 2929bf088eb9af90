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
sign-extends, so the QSGD arithmetic here runs in int64 masked to 32 bits;
`normal_ref` carries its threefry words as numpy uint32 on the CPU and as
int32 with masked right shifts on a device.
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


class _Host:
    """The plain draw's array operations on the CPU: numpy, whose element-wise
    operations all run on the calling thread (torch's CPU operations split
    over its thread pool, and under a parallel test run each split waits on
    every core), with the words as uint32."""
    f32, f64, words_dtype = np.float32, np.float64, np.uint32
    lshift, frexp, sqrt, maximum = np.left_shift, np.frexp, np.sqrt, np.maximum
    nonzero = staticmethod(np.flatnonzero)

    @staticmethod
    def counters(start: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        idx = np.arange(start, start + n, dtype=np.uint64)
        return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)

    @staticmethod
    def word(k: int) -> np.uint32:
        return np.uint32(k)

    @staticmethod
    def shr(x: np.ndarray, r: int) -> None:
        x >>= r

    @staticmethod
    def cast(x: np.ndarray, dtype) -> np.ndarray:
        return x.astype(dtype)

    @staticmethod
    def empty(n: int, dtype) -> np.ndarray:
        return np.empty(n, dtype)


class _Device:
    """The same operations in torch on a device (the card), the words as
    int32: adds wrap, and a right shift is masked to be logical."""
    f32, f64, words_dtype = torch.float32, torch.float64, torch.int32
    lshift, frexp, sqrt, maximum = (torch.bitwise_left_shift, torch.frexp, torch.sqrt,
                                    torch.clamp_min)

    def __init__(self, device):
        self.device = device

    def counters(self, start: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        idx = torch.arange(start, start + n, dtype=torch.int64, device=self.device)
        return (idx >> 32).to(torch.int32), idx.to(torch.int32)

    @staticmethod
    def word(k: int) -> int:
        return k - (1 << 32) if k >> 31 else k

    @staticmethod
    def shr(x: torch.Tensor, r: int) -> None:
        x >>= r
        x &= (1 << (32 - r)) - 1

    @staticmethod
    def nonzero(mask: torch.Tensor) -> torch.Tensor:
        return mask.nonzero().squeeze(1)

    @staticmethod
    def cast(x: torch.Tensor, dtype) -> torch.Tensor:
        return x.to(dtype)

    def empty(self, n: int, dtype) -> torch.Tensor:
        return torch.empty(n, dtype=dtype, device=self.device)


class _Fma:
    """XLA's f32 fused multiply-adds as an f64 product and sum: the f32
    product is exact in f64, and the f64 sum is rounded to f32.
    That rounds twice, and differs from one rounding where the f64 sum
    lies exactly halfway between two f32 values and was itself inexact;
    `scripts/torch_fma_halfway.py` counts such sums in these polynomials.
    The f64 work array is allocated once per chunk."""

    def __init__(self, xp, n: int):
        self.s = xp.empty(n, xp.f64)

    def __call__(self, a, b, c, out):
        """out = fma(a, b, c) in f32: a an f32 array, b an f64 array (an f32
        array's f64 copy) or an f32-exact Python float, c an f32 array or
        an f32-exact Python float."""
        s = self.s
        s[...] = a
        s *= b
        s += c
        out[...] = s
        return out


def _log_ref(xp, fma: _Fma, v):
    """XLA's f32 log of positive normal `v` (Cephes' `logf`)."""
    m, e = xp.frexp(v)
    low = xp.cast(m < _LOG_LOW, xp.f32)
    x = (m - 1.0) + m * low
    e = xp.cast(e, xp.f32) - low
    x2 = x * x
    x3 = x2 * x
    p, x64, x3_64 = _LOG_P, xp.cast(x, xp.f64), xp.cast(x3, xp.f64)
    y, y1, y2 = (xp.empty(len(x), xp.f32) for _ in range(3))
    fma(fma(x, p[0], p[1], y), x64, p[2], y)
    fma(fma(x, p[3], p[4], y1), x64, p[5], y1)
    fma(fma(x, p[6], p[7], y2), x64, p[8], y2)
    fma(fma(y, x3_64, y1, y), x3_64, y2, y)
    fma(y, x3_64, e * _LOG_Q1, y)
    # an FMA whose product is exact in f32 (x2 / 2, and e times Q2's 9 bits)
    # rounds as the f32 sum of that product does
    x = (x2 * -0.5 + x) + y
    return e * _LOG_Q2 + x


def _log1p_ref(xp, fma: _Fma, x):
    """XLA's f32 log1p of `x` in (-1, 0]: Cephes' rational form where |x| <
    sqrt(2) - 1, else the log of 1 + x, each computed on its own entries."""
    large = xp.nonzero(x <= -_LOG1P_LARGE)
    out = _log1p_small(xp, fma, x)
    if len(large):
        out[large] = _log_ref(xp, _Fma(xp, len(large)), x[large] + 1.0)
    return out


def _log1p_small(xp, fma: _Fma, x):
    x64 = xp.cast(x, xp.f64)
    num = fma(x, _LOG1P_NUM[0], _LOG1P_NUM[1], xp.empty(len(x), xp.f32))
    den = x + _LOG1P_DEN[1]  # the leading 1 of the denominator
    for cn, cd in zip(_LOG1P_NUM[2:], _LOG1P_DEN[2:]):
        fma(num, x64, cn, num)
        fma(den, x64, cd, den)
    x2 = x * x
    return x + (x2 * -0.5 + (x * x2) * (num / den))


def _erf_inv_ref(xp, fma: _Fma, x):
    """XLA's f32 erf_inv of `x` in (-1, 1): Giles' polynomial in w - 2.5
    where w = -log(1 - x^2) < 5, else (about 1 entry in 300) in sqrt(w) - 3,
    with the f64 sqrt rounded to f32, which is the correctly rounded one."""
    w = -_log1p_ref(xp, fma, x * -x)
    tail = xp.nonzero(w >= 5.0)
    p = _erf_inv_poly(xp, fma, w - 2.5, _ERFINV_LT5)
    if len(tail):
        wt = xp.cast(xp.sqrt(xp.cast(w[tail], xp.f64)), xp.f32) - 3.0
        p[tail] = _erf_inv_poly(xp, _Fma(xp, len(tail)), wt, _ERFINV_GE5)
    return p * x


def _erf_inv_poly(xp, fma: _Fma, w, coeffs: tuple):
    p, w64 = xp.empty(len(w), xp.f32), xp.cast(w, xp.f64)
    fma(w, coeffs[0], coeffs[1], p)
    for c in coeffs[2:]:
        fma(p, w64, c, p)
    return p


def _threefry_bits(xp, k0: int, k1: int, start: int, n: int):
    """Random bits of `jax.random` (partitionable threefry2x32) for flat
    indices [start, start + n): the 20-round hash of each 64-bit index
    (high word, low word), the two output words xor'ed.  32-bit words
    updated in place."""
    ks = (k0, k1, k0 ^ k1 ^ int(prng._PARITY))
    x0, x1 = xp.counters(start, n)
    x0 += xp.word(ks[0])
    x1 += xp.word(ks[1])
    y = xp.empty(n, xp.words_dtype)
    for i in range(5):
        for r in prng._ROTATIONS[i % 2]:
            x0 += x1
            xp.lshift(x1, r, out=y)
            xp.shr(x1, 32 - r)
            x1 |= y
            x1 ^= x0  # rotl(x1, r) ^ x0
        x0 += xp.word(ks[(i + 1) % 3])
        x1 += xp.word((ks[(i + 2) % 3] + i + 1) & MASK32)
    x0 ^= x1
    return x0


def _normal_chunk(xp, k0: int, k1: int, start: int, n: int):
    bits = _threefry_bits(xp, k0, k1, start, n)
    xp.shr(bits, 9)
    bits |= 0x3F800000
    floats = bits.view(xp.f32) - 1.0
    u = xp.maximum(floats * 2.0 + _U_LO, _U_LO)  # floats * f32(1 - lo) + lo: f32(1 - lo) = 2
    return _erf_inv_ref(xp, _Fma(xp, n), u) * _SQRT2


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns, rounded to nearest even (torch's rounding of
    finite values)."""
    b = v.view(np.uint32)
    return ((b + (((b >> 16) & 1) + 0x7FFF)) >> 16).astype(np.uint16)


def normal_ref(key, offset: int, n: int, scale: float, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Entries [offset, offset + n) of `jax.random.normal(key, shape,
    float32)` over any shape (its flat index), times the f32 `scale`, then
    rounded to `dtype` (f32, or bf16 to nearest even): an (n,) tensor.
    `key` is the two uint32 key words.

    On the CPU (what `init_params` runs there) in numpy, chunks of
    `_NORMAL_CHUNK` entries, every operation on the calling thread whatever
    torch's thread count; on a device (the card, only to compare with the
    kernel) in torch, chunks of 2^24."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    k0, k1 = (int(k) & MASK32 for k in key)
    scale = float(np.float32(scale))
    if torch.device(device).type != "cpu":
        xp, out = _Device(device), torch.empty(n, dtype=dtype, device=device)
        for lo in range(0, n, 1 << 24):
            m = min(1 << 24, n - lo)
            out[lo:lo + m] = (_normal_chunk(xp, k0, k1, offset + lo, m) * scale).to(dtype)
        return out
    f32 = dtype == torch.float32
    out = np.empty(n, np.float32 if f32 else np.uint16)
    for lo in range(0, n, _NORMAL_CHUNK):
        m = min(_NORMAL_CHUNK, n - lo)
        v = _normal_chunk(_Host, k0, k1, offset + lo, m) * np.float32(scale)
        out[lo:lo + m] = v if f32 else _bf16_bits(v)
    return torch.from_numpy(out) if f32 else torch.from_numpy(out.view(np.int16)).view(dtype)
