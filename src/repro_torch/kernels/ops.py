"""Leaf and tree QSGD wrappers around the kernels (port of `repro/kernels/ops.py`).

The dense-code API (`qsgd_quantize`, `qsgd_dequantize`, `qsgd_roundtrip`)
pads a whole array to tiles of 8 blocks, as the reference does, and keys
its dither with one key over the flat padded index.  The packed wire
(`qsgd_encode`/`decode(_tree)`, `qsgd_compress_tree`) pads each leaf to
whole blocks, derives the per-leaf keys and maps over a message's leaves.
Sign-SGD (`signsgd_encode`/`decode`/`compress_tree`) packs one sign bit per
entry with a mean-|v| scale per block, and Top-K (`topk_sparsify(_tree)`)
keeps a message's largest-magnitude entries; the reference computes both in
plain jnp, and so do these in plain torch on either device.
`kernels/qsgd.py` only sees dense tiles.  A leaf on the card goes through
the Hopper kernels and a leaf on the CPU through their plain versions, as
the reference routes to its Pallas kernels on a TPU and to the jnp oracle
elsewhere.

Keys are raw uint32 key words (numpy, see `core/prng.py`).  Where the
reference vmaps a message function over a stacked uplink, these functions
take the sender axis directly: a key array of shape (..., 2) gives every
leaf the leading axes ``...``, one message per key, and all senders of a
leaf are encoded by one kernel launch.  The tree functions also take the
keys already split per leaf, as an int32 tensor (..., leaves, 2) of the
same bits on the message's device (`prng.message_leaf_keys`): then nothing
is derived or copied from the host, which is what a captured CUDA graph
needs.  The key-free Sign-SGD and Top-K ops take the leading message axes
as ``lead`` instead.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.prng import split_each
from repro_torch.kernels.qsgd import (
    _pack_words,
    _unpack_words,
    qsgd_dequantize_blocks,
    qsgd_quantize_blocks,
    qsgd_quantize_pack,
    qsgd_unpack_dequantize,
)
from repro_torch.kernels.ref import (
    cheap_uniform_ref,
    signsgd_dequantize_codes_ref,
    signsgd_quantize_codes_ref,
)
from repro_torch.utils import named_scope, tree_flatten, tree_unflatten

Tree = Any
DEFAULT_BLOCK = 1024
ROWS_PER_TILE = 8  # the reference pads the dense-code API to tiles of 8 blocks


def _cheap_uniform(key: np.ndarray, shape: tuple) -> torch.Tensor:
    """Stochastic-rounding dither of the reference, bit for bit: a keyed
    murmur3-fmix32 counter hash, two 16-bit samples per 32-bit word, on the
    grid {k / 65536}.  Depends only on (key, position)."""
    n = math.prod(shape)
    return cheap_uniform_ref(_key_tensor(key[None], "cpu"), n).reshape(shape)


def key_words(keys: np.ndarray, device) -> torch.Tensor:
    """uint32 key words -> an int32 tensor of the same bits on `device`."""
    words = np.array(keys, dtype=np.uint32).view(np.int32)  # a writable copy
    return torch.from_numpy(words).to(device)


def _key_tensor(keys, device) -> torch.Tensor:
    """(S, 2) key words as an int32 tensor on `device`: uint32 numpy words
    are moved there, an int32 tensor already there is passed on
    (contiguous)."""
    if not isinstance(keys, torch.Tensor):
        return key_words(keys, device)
    if keys.dtype != torch.int32 or keys.device != torch.device(device):
        raise ValueError(f"device keys must be int32 on {device}, got {keys.dtype} on "
                         f"{keys.device}")
    return keys.contiguous()


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


def _message_blocks(v: torch.Tensor, lead: tuple, block: int) -> torch.Tensor:
    """Each message's part of one leaf as f32 blocks, the tail block
    zero-padded: (senders, nb, block) with nb = ceil(entries / block)."""
    senders = math.prod(lead)
    flat = v.reshape(senders, -1).to(torch.float32)
    n = flat.shape[1]
    nb = _leaf_blocks(n, block)
    if n != nb * block:
        padded = torch.zeros((senders, nb * block), dtype=torch.float32, device=v.device)
        padded[:, :n] = flat
        flat = padded
    return flat.reshape(senders, nb, block).contiguous()


def qsgd_encode(v: torch.Tensor, keys, *, s: int = 16,
                block: int = DEFAULT_BLOCK) -> dict:
    """Encode one leaf of every message to its wire form.

    keys (..., 2): one key per message (uint32 numpy, or an int32 tensor on
    v's device); v has the leading axes ``...``.  Returns {'payload': int32
    (..., nb, bits*block/32), 'norms': f32 (..., nb)} with nb = ceil(entries
    per message / block) blocks per leaf."""
    with named_scope('qsgd_encode'):
        lead = tuple(keys.shape[:-1])
        blocks = _message_blocks(v, lead, block)
        nb = blocks.shape[1]
        payload, norms = qsgd_quantize_pack(blocks, _key_tensor(keys.reshape(-1, 2), v.device), s)
        return {"payload": payload.reshape(*lead, nb, -1), "norms": norms.reshape(*lead, nb)}


def qsgd_decode(wire: dict, *, s: int = 16, shape: tuple = (),
                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Receiver side: unpack + dequantize a wire dict back to an f32 leaf of
    `shape` (the leading message axes included)."""
    with named_scope('qsgd_decode'):
        payload, norms = wire["payload"], wire["norms"]
        lead = payload.shape[:-2]
        senders = math.prod(lead)
        rows = qsgd_unpack_dequantize(payload.reshape(-1, payload.shape[-1]).contiguous(),
                                      norms.reshape(-1).contiguous(), s, block)
        n = math.prod(shape) // senders
        return rows.reshape(senders, -1)[:, :n].reshape(shape)


def qsgd_encode_tree(tree: Tree, keys, *, s: int = 16,
                     block: int = DEFAULT_BLOCK) -> list:
    """Encode every leaf of the messages; wire dicts in leaf order.  `keys`
    are the message keys (..., 2) as uint32 numpy, split per leaf here, or
    the per-leaf keys (..., leaves, 2) as an int32 tensor on the leaves'
    device."""
    leaves, _ = tree_flatten(tree)
    if not isinstance(keys, torch.Tensor):
        keys = split_each(keys, len(leaves))
    elif keys.shape[-2] != len(leaves):
        raise ValueError(f"device keys carry {keys.shape[-2]} leaves, the tree {len(leaves)}")
    return [qsgd_encode(leaf, keys[..., i, :], s=s, block=block)
            for i, leaf in enumerate(leaves)]


def qsgd_decode_tree(wires: list, like: Tree, *, s: int = 16,
                     block: int = DEFAULT_BLOCK) -> Tree:
    """Decode wire dicts (leaf order) back into the structure/dtypes of `like`."""
    leaves, treedef = tree_flatten(like)
    out = [qsgd_decode(w, s=s, shape=tuple(leaf.shape), block=block).to(leaf.dtype)
           for w, leaf in zip(wires, leaves)]
    return tree_unflatten(treedef, out)


def qsgd_compress_tree(tree: Tree, keys, *, s: int = 16,
                       block: int = DEFAULT_BLOCK) -> Tree:
    """The QSGD channel roundtrip: encode to the packed wire, decode at the
    receiver; leaf-wise with per-leaf keys."""
    return qsgd_decode_tree(qsgd_encode_tree(tree, keys, s=s, block=block), tree,
                            s=s, block=block)


# -- sign-SGD (1-bit) ---------------------------------------------------------


def signsgd_encode(v: torch.Tensor, *, block: int = DEFAULT_BLOCK, lead: tuple = ()) -> dict:
    """1-bit sign codes + per-block mean-|v| scale of one leaf of every
    message (v has the leading message axes `lead`), all senders in one
    pass.  Deterministic (no key).  Returns {'payload': int32 (..., nb,
    block/32), 'norms': f32 (..., nb)}."""
    with named_scope('signsgd_encode'):
        blocks = _message_blocks(v, tuple(lead), block)
        senders, nb, _ = blocks.shape
        codes, scales = signsgd_quantize_codes_ref(blocks)
        payload = _pack_words(codes.reshape(senders * nb, block), 1)
        return {"payload": payload.reshape(*lead, nb, -1), "norms": scales.reshape(*lead, nb)}


def signsgd_decode(wire: dict, *, shape: tuple = (), block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """±scale per entry back to an f32 leaf of `shape` (the leading message
    axes included); the padding is cut off."""
    with named_scope('signsgd_decode'):
        payload, norms = wire["payload"], wire["norms"]
        senders = math.prod(payload.shape[:-2])
        codes = _unpack_words(payload.reshape(-1, payload.shape[-1]), 1)
        rows = signsgd_dequantize_codes_ref(codes, norms.reshape(-1))
        n = math.prod(shape) // senders
        return rows.reshape(senders, -1)[:, :n].reshape(shape)


def signsgd_compress_tree(tree: Tree, *, block: int = DEFAULT_BLOCK, lead: tuple = ()) -> Tree:
    """Sign-SGD channel roundtrip, leaf-wise.  The tail block's zero padding
    decodes to +scale but is cut off; an all-zero leaf (a padded sender's
    delta) has scale 0 everywhere and decodes to exact zeros."""
    leaves, treedef = tree_flatten(tree)
    out = [signsgd_decode(signsgd_encode(leaf, block=block, lead=lead), shape=tuple(leaf.shape),
                          block=block).to(leaf.dtype)
           for leaf in leaves]
    return tree_unflatten(treedef, out)


# -- Top-K sparsification -------------------------------------------------------


def topk_sparsify(v: torch.Tensor, *, k: int, lead: tuple = ()) -> torch.Tensor:
    """Keep the k largest-magnitude entries of each message of v (leading
    message axes `lead`), zero the rest.  Among equal magnitudes the lower
    index wins, as in `jax.lax.top_k`: a stable descending sort of |v|, then
    its first k positions."""
    senders = math.prod(lead)
    flat = v.reshape(senders, -1)
    k = min(k, flat.shape[1])
    order = torch.sort(torch.abs(flat), dim=1, descending=True, stable=True).indices
    mask = torch.zeros_like(flat).scatter_(1, order[:, :k], 1.0)
    return (flat * mask).reshape(v.shape)


def topk_sparsify_tree(tree: Tree, *, fraction: float, lead: tuple = ()) -> Tree:
    """Whole-message Top-K: keep the ceil(fraction * d) largest-magnitude
    entries over ALL leaves of each message (the leaves concatenated in
    leaf order as one d-vector)."""
    leaves, treedef = tree_flatten(tree)
    senders = math.prod(lead)
    flat = torch.cat([leaf.reshape(senders, -1).to(torch.float32) for leaf in leaves], dim=1)
    sparse = topk_sparsify(flat, k=max(1, math.ceil(fraction * flat.shape[1])), lead=(senders,))
    out, off = [], 0
    for leaf in leaves:
        size = leaf.numel() // senders
        out.append(sparse[:, off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return tree_unflatten(treedef, out)
