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
backend computes it, drawn on the host by `kernels/ref.py::normal_ref`:
the classifiers draw their initial weights with it, so a seed gives the
reference's weights.  The LMs draw theirs through `kernels/normal.py`, by
a CUDA kernel on the card and by the same `normal_ref` on the CPU.
`uniform`, `linspace` and `log` give the reference's few other drawn or
computed leaves (RG-LRU's `lambda`, SSD's `A_log`).
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


# XLA's f32 `log` (Cephes' `logf`), with the fused multiply-adds that XLA's
# CPU backend emits (`kernels/ref.py` holds the rest of `jax.random.normal`).
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)


def _fma(a, b, c) -> np.ndarray:
    """f32 a*b + c rounded once: the f32 product is exact in f64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def log(v: np.ndarray) -> np.ndarray:
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


def _bits(key: np.ndarray, n: int) -> np.ndarray:
    """The random bits of `jax.random` for flat indices 0..n-1: threefry of
    each 64-bit index (high word, low word), the two words xor'ed."""
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                              idx.astype(np.uint32))
    return b0 ^ b1


def _unit(bits: np.ndarray) -> np.ndarray:
    """Floats in [0, 1) from the top 23 bits."""
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


def uniform(key: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: floats *
    (max - min) + min in f32, fused as XLA's CPU backend fuses it, then
    max(min, .)."""
    shape = tuple(int(d) for d in shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = _unit(_bits(key, int(np.prod(shape))))
    return np.maximum(lo, _fma(floats, hi - lo, lo)).reshape(shape)


def linspace(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` in float32 as XLA's CPU backend
    computes it for up to 352 entries (held for start 1, stop 16, the
    only call): it folds the division by num - 1 into a product by its
    f32 reciprocal r, then start * (1 - i r) + (stop r) i with the last
    product fused; the last entry is `stop`."""
    start, stop = np.float32(start), np.float32(stop)
    if num < 2:
        return np.full(num, start, np.float32)
    i = np.arange(num - 1, dtype=np.float32)
    r = np.float32(1) / np.float32(num - 1)
    head = _fma(i, stop * r, start * (np.float32(1) - i * r))
    return np.append(head, stop).astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`, drawn on the host by
    `kernels/ref.py::normal_ref`."""
    from repro_torch.kernels.ref import normal_ref

    shape = tuple(int(d) for d in shape)
    return normal_ref(key, 0, int(np.prod(shape)), 1.0).numpy().reshape(shape)
