"""Deterministic key layer: threefry2x32 on raw ``uint32[2]`` key words.

The reference package keys every stochastic message with `jax.random`
(threefry2x32, in its partitionable form): `PRNGKey(seed)`, `split(key, n)`,
`fold_in(key, data)` and the engine's `split_chain`.  A QSGD message's dither
is a function of those key words, so the port reproduces them bit for bit.
Keys are a few words per message, so this stays host-side numpy.

Partitionable threefry: `split(key, n)[i]` and `fold_in(key, i)` are both
the threefry2x32 hash of the 64-bit counter ``i`` (high word, low word)
under `key`.  `threefry2x32` broadcasts arrays of keys against arrays of
counters, so `message_leaf_keys` derives every sender's per-leaf keys of a
whole round, or of a whole staged chunk of rounds, in one vectorized pass.
The reference derives those keys inside its jitted round (`fold_in` per
sender, `split` per leaf); the port derives them on the host when a round
is staged, and the round reads them as one int32 device tensor, so a
captured CUDA graph replays it without a host-derived value.  Only the
sequential key chain (`split_chain`) is walked once per run.

`normal` is `jax.random.normal` in float32, bit for bit as XLA's CPU
backend computes it: the classifiers draw their initial weights with it, so
a seed gives the reference's weights.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block cipher of (x0, x1) under `key`: key
    words (..., 2), broadcast against the counters' shape."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """Key words of `jax.random.PRNGKey(seed)` for a 32-bit seed."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: (n, 2) uint32 key words."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a non-negative 32-bit `data`."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def fold_in_each(keys: np.ndarray, data: np.ndarray) -> np.ndarray:
    """`fold_in(keys[...], data[..., s])` for every s: keys (..., 2), data
    (..., S) non-negative 32-bit ints -> (..., S, 2) uint32."""
    data = np.asarray(data, np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(np.asarray(keys, np.uint32)[..., None, :],
                              np.zeros(data.shape, np.uint32), data)
    return np.stack([b0, b1], axis=-1)


def split_each(keys: np.ndarray, n: int) -> np.ndarray:
    """`split(key, n)` of every key: (..., 2) -> (..., n, 2) uint32."""
    counters = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(np.asarray(keys, np.uint32)[..., None, :],
                              np.zeros_like(counters), counters)
    return np.stack([b0, b1], axis=-1)


def message_leaf_keys(keys: np.ndarray, slots: np.ndarray, n_leaves: int) -> np.ndarray:
    """The per-leaf keys of every sender of a per-message channel.

    keys (..., 2) are per-group key words; slots (..., S) the senders' slot
    ids, with the same leading axes.  Sender s of a group is keyed
    `fold_in(key, slots[s])` and its leaf l `split(that, n_leaves)[l]`, as
    the reference's round and its QSGD channel do.  Returns (..., S,
    n_leaves, 2) uint32."""
    return split_each(fold_in_each(keys, slots), n_leaves)


def split_chain(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """n sequential ``key, sub = split(key)`` draws, as the reference engine's
    `split_chain`.  Returns (advanced key, subs (n, 2))."""
    subs = np.zeros((n, 2), np.uint32)
    for i in range(n):
        key, subs[i] = split(key)
    return key, subs


# XLA's f32 `log1p` (Cephes' rational form below |x| = sqrt(2) - 1, else the
# log of 1 + x by Cephes' `logf`) and f32 `erf_inv` (Giles' polynomials, w < 5
# and w >= 5), with the fused multiply-adds that XLA's CPU backend emits.
_LOG1P_NUM = tuple(np.float32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(np.float32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def _fma(a, b, c) -> np.ndarray:
    """f32 a*b + c rounded once: the f32 product is exact in f64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _log(v: np.ndarray) -> np.ndarray:
    """XLA's f32 log of positive normal `v`."""
    m, e = np.frexp(v)
    m, e = m.astype(np.float32), e.astype(np.float32)
    low = m < np.float32(0.707106781186547524)
    x = (m - np.float32(1)) + np.where(low, m, np.float32(0))
    e = e - low.astype(np.float32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    x = _fma(np.float32(-0.5), x2, x) + y
    return _fma(_LOG_Q2, e, x)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's f32 log1p of `x` in (-1, 0]."""
    out = np.empty_like(x)
    large = np.abs(x) >= np.float32(0.41421356237309504880)
    out[large] = _log(np.float32(1) + x[large])
    x = x[~large]
    x2 = x * x
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num, den = _fma(num, x, cn), _fma(den, x, cd)
    out[~large] = x + _fma(np.float32(-0.5), x2, (x * x2) * (num / den))
    return out


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erf_inv of `x` in (-1, 1)."""
    w = -_log1p(x * -x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, c_lt, c_ge))
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`: partitionable random bits
    (threefry of each entry's 64-bit flat index, the two words xor'ed), a
    uniform in (-1, 1) from their top 23 bits, then sqrt(2) erf_inv."""
    shape = tuple(int(d) for d in shape)
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                              idx.astype(np.uint32))
    bits = b0 ^ b1
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, floats * (np.float32(1) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erf_inv(u)).reshape(shape)
