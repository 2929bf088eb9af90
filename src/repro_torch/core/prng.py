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
