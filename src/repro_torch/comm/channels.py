"""Lossy uplink channels (port of `repro/comm/channels.py`).

A channel owns both sides of a message's cost model: `compress(tree, keys)`,
the lossy transform a message traverses, and `message_bits(num_params)`,
what the `CommLedger` records.  The wire channels (QSGD, Sign-SGD, and the
dense channel) also expose the split halves, `encode` (sender: per-leaf
payload + sidecar) and `decode` (receiver), and `wire_bits(leaf_sizes)`,
the exact multi-leaf payload size; `compress` is `decode ∘ encode`.

`stochastic` says whether the channel consumes keys (the driver advances
its key chain only for those); `per_message` says each sender's message of
a stacked uplink is transformed independently (the engine keys sender i
with `fold_in(sub, i)`).  A per-message channel reads the leading message
axes of its input from ``keys`` (..., 2); QSGD also takes the keys already
split per leaf, as an int32 device tensor (..., leaves, 2), and the
key-free Sign-SGD and Top-K take the axes as ``lead``.  No keys and no
``lead`` means one message.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import torch

from repro_torch.comm.bits import (
    dense_message_bits,
    dtype_bits,
    packed_wire_bits,
    qsgd_code_bits,
    qsgd_message_bits,
    signsgd_message_bits,
    topk_message_bits,
)
from repro_torch.kernels.ops import (
    DEFAULT_BLOCK,
    qsgd_compress_tree,
    qsgd_decode_tree,
    qsgd_encode_tree,
    signsgd_compress_tree,
    signsgd_decode,
    signsgd_encode,
    topk_sparsify_tree,
)
from repro_torch.kernels.qsgd import MAX_BLOCK, MAX_LEVELS
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten

Tree = Any


def _lead(keys: np.ndarray | None, lead: tuple | None) -> tuple:
    """The leading message axes: `lead` where given, else those a key array
    (..., 2) gives a message tree."""
    if lead is not None:
        return tuple(lead)
    return () if keys is None else tuple(np.shape(keys)[:-1])


@dataclasses.dataclass(frozen=True)
class DenseChannel:
    """Uncompressed float transport.

    With ``wire_dtype=None`` the transform is the identity, priced at
    `bits_per_param` per entry.  With a ``wire_dtype`` (e.g. "bfloat16")
    `compress` round-trips every leaf through that dtype, `encode`/`decode`
    expose the payload, and `bits_per_param` becomes the dtype's width, so
    the ledger prices what travels."""

    bits_per_param: int = 32
    wire_dtype: str | None = None
    stochastic: bool = dataclasses.field(default=False, init=False)
    per_message: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        if self.wire_dtype is not None:
            object.__setattr__(self, "bits_per_param", dtype_bits(self.wire_dtype))

    def compress(self, tree: Tree, keys: np.ndarray | None = None) -> Tree:
        if self.wire_dtype is None:
            return tree
        wire = getattr(torch, self.wire_dtype)
        return tree_map(lambda a: a.to(wire).to(a.dtype), tree)

    def encode(self, tree: Tree, keys: np.ndarray | None = None) -> list:
        wire = getattr(torch, self.wire_dtype or "float32")
        return [{"payload": leaf.to(wire)} for leaf in tree_flatten(tree)[0]]

    def decode(self, wires: list, like: Tree) -> Tree:
        leaves, treedef = tree_flatten(like)
        return tree_unflatten(treedef, [w["payload"].to(leaf.dtype)
                                        for w, leaf in zip(wires, leaves)])

    def message_bits(self, num_params: int) -> int:
        return dense_message_bits(num_params, self.bits_per_param)

    def wire_bits(self, leaf_sizes) -> int:
        return sum(n * self.bits_per_param for n in leaf_sizes)


@dataclasses.dataclass(frozen=True)
class QSGDChannel:
    """QSGD stochastic quantization (Alistarh et al., 2017) on the packed
    wire: per leaf, ceil(log2(2s+1))-bit sign-folded codes in uint32 words
    plus one f32 norm per block (the Hopper kernels on the card, plain torch
    on the CPU).  `keys` has shape (..., 2): one message per key, and every
    leaf of the tree carries the leading axes ``...``."""

    levels: int = 16
    block: int = DEFAULT_BLOCK
    stochastic: bool = dataclasses.field(default=True, init=False)
    per_message: bool = dataclasses.field(default=True, init=False)

    def __post_init__(self):
        if not 1 <= self.levels <= MAX_LEVELS:
            raise ValueError(f"QSGD levels must be in [1, {MAX_LEVELS}], got {self.levels}")
        if self.block % 32 or not 32 <= self.block <= MAX_BLOCK:
            raise ValueError(f"QSGD block must be a multiple of 32 up to {MAX_BLOCK}")

    def encode(self, tree: Tree, keys) -> list:
        return qsgd_encode_tree(tree, keys, s=self.levels, block=self.block)

    def decode(self, wires: list, like: Tree) -> Tree:
        return qsgd_decode_tree(wires, like, s=self.levels, block=self.block)

    def compress(self, tree: Tree, keys) -> Tree:
        return qsgd_compress_tree(tree, keys, s=self.levels, block=self.block)

    def message_bits(self, num_params: int) -> int:
        return qsgd_message_bits(num_params, self.levels, self.block)

    def wire_bits(self, leaf_sizes) -> int:
        return packed_wire_bits(leaf_sizes, qsgd_code_bits(self.levels), self.block)


@dataclasses.dataclass(frozen=True)
class SignSGDChannel:
    """1-bit sign-SGD with per-block norm scaling (Bernstein et al., 2018):
    each entry travels as its sign bit, decoded as ±(mean |v| of its block).
    Deterministic and per-message; 32 entries per payload word and an f32
    scale per block."""

    block: int = DEFAULT_BLOCK
    stochastic: bool = dataclasses.field(default=False, init=False)
    per_message: bool = dataclasses.field(default=True, init=False)

    def encode(self, tree: Tree, keys: np.ndarray | None = None, *,
               lead: tuple | None = None) -> list:
        return [signsgd_encode(leaf, block=self.block, lead=_lead(keys, lead))
                for leaf in tree_flatten(tree)[0]]

    def decode(self, wires: list, like: Tree) -> Tree:
        leaves, treedef = tree_flatten(like)
        return tree_unflatten(treedef, [
            signsgd_decode(w, shape=tuple(leaf.shape), block=self.block).to(leaf.dtype)
            for w, leaf in zip(wires, leaves)])

    def compress(self, tree: Tree, keys: np.ndarray | None = None, *,
                 lead: tuple | None = None) -> Tree:
        return signsgd_compress_tree(tree, block=self.block, lead=_lead(keys, lead))

    def message_bits(self, num_params: int) -> int:
        return signsgd_message_bits(num_params, self.block)

    def wire_bits(self, leaf_sizes) -> int:
        return packed_wire_bits(leaf_sizes, 1, self.block)


@dataclasses.dataclass(frozen=True)
class TopKChannel:
    """Deterministic magnitude Top-K sparsification: keeps the
    ceil(fraction * d) largest-magnitude entries of the whole message (all
    leaves as one d-vector), encoded as k (index, value) pairs of
    ceil(log2(d)) + bits_per_param bits each, so `message_bits` is exact.
    Per-message: each sender's delta is selected on its own."""

    fraction: float = 0.01
    bits_per_param: int = 32
    stochastic: bool = dataclasses.field(default=False, init=False)
    per_message: bool = dataclasses.field(default=True, init=False)

    def compress(self, tree: Tree, keys: np.ndarray | None = None, *,
                 lead: tuple | None = None) -> Tree:
        return topk_sparsify_tree(tree, fraction=self.fraction, lead=_lead(keys, lead))

    def message_bits(self, num_params: int) -> int:
        return topk_message_bits(num_params, self.fraction, self.bits_per_param)


Channel = DenseChannel | QSGDChannel | SignSGDChannel | TopKChannel


def channel_wire_bits(channel: Channel, num_params: int, leaf_sizes=None) -> int:
    """The exact per-message bits a driver puts in the ledger: wire channels
    price the real multi-leaf payload where leaf sizes are given; anything
    else (Top-K) the flat `message_bits` formula."""
    if leaf_sizes is not None and hasattr(channel, "wire_bits"):
        return channel.wire_bits(tuple(leaf_sizes))
    return channel.message_bits(num_params)


def make_channel(qsgd_levels: int | None, bits_per_param: int = 32) -> Channel:
    """The (qsgd_levels, bits_per_param) config pair as a Channel."""
    if qsgd_levels is None:
        return DenseChannel(bits_per_param)
    return QSGDChannel(qsgd_levels)


def low_bit_channel(bits: int) -> Channel:
    """The low-bit channel family by wire width: 8/4/2-bit packed QSGD
    (s = 127 / 7 / 1, the largest s whose sign-folded code fits) or the
    1-bit sign-SGD channel."""
    try:
        return {8: QSGDChannel(127), 4: QSGDChannel(7), 2: QSGDChannel(1),
                1: SignSGDChannel()}[bits]
    except KeyError:
        raise ValueError(f"no {bits}-bit channel (choose 1, 2, 4, or 8)") from None
