"""Leaf and tree QSGD wrappers around the kernels (port of `repro/kernels/ops.py`).

The dense-code API (`qsgd_quantize`, `qsgd_dequantize`, `qsgd_roundtrip`)
pads a whole array to tiles of 8 blocks, as the reference does, and keys
its dither with one key over the flat padded index.  The packed wire
(`qsgd_encode`/`decode(_tree)`, `qsgd_compress_tree`) pads each leaf to
whole blocks, derives the per-leaf keys and maps over a message's leaves.
`kernels/qsgd.py` only sees dense tiles.  A leaf on the card goes through
the Hopper kernels and a leaf on the CPU through their plain versions, as
the reference routes to its Pallas kernels on a TPU and to the jnp oracle
elsewhere.

Keys are raw uint32 key words (numpy, see `core/prng.py`).  Where the
reference vmaps a message function over a stacked uplink, these functions
take the sender axis directly: a key array of shape (..., 2) gives every
leaf the leading axes ``...``, one message per key, and all senders of a
leaf are encoded by one kernel launch.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.prng import split
from repro_torch.kernels.qsgd import (
    qsgd_dequantize_blocks,
    qsgd_quantize_blocks,
    qsgd_quantize_pack,
    qsgd_unpack_dequantize,
)
from repro_torch.kernels.ref import cheap_uniform_ref
from repro_torch.utils import tree_flatten, tree_unflatten

Tree = Any
DEFAULT_BLOCK = 1024
ROWS_PER_TILE = 8  # the reference pads the dense-code API to tiles of 8 blocks


def _cheap_uniform(key: np.ndarray, shape: tuple) -> torch.Tensor:
    """Stochastic-rounding dither of the reference, bit for bit: a keyed
    murmur3-fmix32 counter hash, two 16-bit samples per 32-bit word, on the
    grid {k / 65536}.  Depends only on (key, position)."""
    n = math.prod(shape)
    return cheap_uniform_ref(_key_tensor(key[None], "cpu"), n).reshape(shape)


def _key_tensor(keys: np.ndarray, device) -> torch.Tensor:
    """(S, 2) uint32 key words -> int32 tensor of the same bits on `device`."""
    words = np.array(keys, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def _pad_to_blocks(v: torch.Tensor, block: int, rows_per_tile: int):
    """Flatten to f32 and zero-pad to whole tiles: ((rows, block), n)."""
    n = v.numel()
    per_tile = block * rows_per_tile
    flat = v.reshape(-1).to(torch.float32)
    if n % per_tile:
        padded = torch.zeros((-(-n // per_tile) * per_tile,), dtype=torch.float32,
                             device=v.device)
        padded[:n] = flat
        flat = padded
    return flat.reshape(-1, block).contiguous(), n


def qsgd_quantize(v: torch.Tensor, key: np.ndarray, *, s: int = 16, block: int = DEFAULT_BLOCK):
    """Quantize an arbitrary-shape array under one key (uint32 words (2,)).
    Returns (q int8 (rows, block), norms f32 (rows,), original size); the
    rows include the padding to whole tiles of 8 blocks."""
    blocks, n = _pad_to_blocks(v, block, ROWS_PER_TILE)
    q, norms = qsgd_quantize_blocks(blocks, _key_tensor(np.asarray(key), v.device), s)
    return q, norms, n


def qsgd_dequantize(q: torch.Tensor, norms: torch.Tensor, *, s: int = 16, shape: tuple = (),
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Dense codes back to an f32 array of `shape` (the padding cut off)."""
    del block  # implied by q's rows
    flat = qsgd_dequantize_blocks(q, norms, s).reshape(-1)
    n = math.prod(shape) if shape else flat.numel()
    return flat[:n].reshape(shape)


def qsgd_roundtrip(v: torch.Tensor, key: np.ndarray, *, s: int = 16,
                   block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """quantize -> dequantize (the lossy channel a message traverses)."""
    q, norms, _ = qsgd_quantize(v, key, s=s, block=block)
    return qsgd_dequantize(q, norms, s=s, shape=tuple(v.shape), block=block)


def _leaf_blocks(n: int, block: int) -> int:
    return max(1, math.ceil(n / block))


def qsgd_encode(v: torch.Tensor, keys: np.ndarray, *, s: int = 16,
                block: int = DEFAULT_BLOCK) -> dict:
    """Encode one leaf of every message to its wire form.

    keys (..., 2): one key per message; v has the leading axes ``...``.
    Returns {'payload': int32 (..., nb, bits*block/32), 'norms': f32 (..., nb)}
    with nb = ceil(entries per message / block) blocks per leaf."""
    lead = keys.shape[:-1]
    senders = math.prod(lead)
    flat = v.reshape(senders, -1).to(torch.float32)
    n = flat.shape[1]
    nb = _leaf_blocks(n, block)
    if n != nb * block:
        padded = torch.zeros((senders, nb * block), dtype=torch.float32, device=v.device)
        padded[:, :n] = flat
        flat = padded
    blocks = flat.reshape(senders, nb, block).contiguous()
    payload, norms = qsgd_quantize_pack(blocks, _key_tensor(keys.reshape(-1, 2), v.device), s)
    return {"payload": payload.reshape(*lead, nb, -1), "norms": norms.reshape(*lead, nb)}


def qsgd_decode(wire: dict, *, s: int = 16, shape: tuple = (),
                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Receiver side: unpack + dequantize a wire dict back to an f32 leaf of
    `shape` (the leading message axes included)."""
    payload, norms = wire["payload"], wire["norms"]
    lead = payload.shape[:-2]
    senders = math.prod(lead)
    rows = qsgd_unpack_dequantize(payload.reshape(-1, payload.shape[-1]).contiguous(),
                                  norms.reshape(-1).contiguous(), s, block)
    n = math.prod(shape) // senders
    return rows.reshape(senders, -1)[:, :n].reshape(shape)


def _leaf_keys(keys: np.ndarray, n_leaves: int) -> np.ndarray:
    """Per-leaf keys `split(key, n_leaves)` of every message key:
    (..., 2) -> (n_leaves, ..., 2)."""
    flat = keys.reshape(-1, 2)
    per = np.stack([split(k, n_leaves) for k in flat], axis=1)  # (L, S, 2)
    return per.reshape((n_leaves,) + keys.shape)


def qsgd_encode_tree(tree: Tree, keys: np.ndarray, *, s: int = 16,
                     block: int = DEFAULT_BLOCK) -> list:
    """Encode every leaf of the messages; wire dicts in leaf order."""
    leaves, _ = tree_flatten(tree)
    leaf_keys = _leaf_keys(np.asarray(keys, np.uint32), len(leaves))
    return [qsgd_encode(leaf, k, s=s, block=block) for leaf, k in zip(leaves, leaf_keys)]


def qsgd_decode_tree(wires: list, like: Tree, *, s: int = 16,
                     block: int = DEFAULT_BLOCK) -> Tree:
    """Decode wire dicts (leaf order) back into the structure/dtypes of `like`."""
    leaves, treedef = tree_flatten(like)
    out = [qsgd_decode(w, s=s, shape=tuple(leaf.shape), block=block).to(leaf.dtype)
           for w, leaf in zip(wires, leaves)]
    return tree_unflatten(treedef, out)


def qsgd_compress_tree(tree: Tree, keys: np.ndarray, *, s: int = 16,
                       block: int = DEFAULT_BLOCK) -> Tree:
    """The QSGD channel roundtrip: encode to the packed wire, decode at the
    receiver; leaf-wise with per-leaf keys."""
    return qsgd_decode_tree(qsgd_encode_tree(tree, keys, s=s, block=block), tree,
                            s=s, block=block)
