"""Deterministic key layer: threefry2x32 on raw ``uint32[2]`` key words.

The reference package keys every stochastic message with `jax.random`
(threefry2x32, in its partitionable form): `PRNGKey(seed)`, `split(key, n)`,
`fold_in(key, data)` and the engine's `split_chain`.  A QSGD message's dither
is a function of those key words, so the port reproduces them bit for bit.
Keys are a few words per message, so this stays host-side numpy.

Partitionable threefry: `split(key, n)[i]` and `fold_in(key, i)` are both
the threefry2x32 hash of the 64-bit counter ``i`` (high word, low word)
under `key`.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block cipher of (x0, x1) under `key`."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
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


def split_chain(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """n sequential ``key, sub = split(key)`` draws, as the reference engine's
    `split_chain`.  Returns (advanced key, subs (n, 2))."""
    subs = np.zeros((n, 2), np.uint32)
    for i in range(n):
        key, subs[i] = split(key)
    return key, subs
