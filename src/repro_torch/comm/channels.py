"""Lossy uplink channels (port of `repro/comm/channels.py`: dense and QSGD).

A channel owns both sides of a message's cost model: `compress(tree, key)`,
the lossy transform a message traverses, and `message_bits(num_params)`,
what the `CommLedger` records.  `QSGDChannel` also exposes the split halves,
`encode` (sender: per-leaf packed payload + norm sidecar) and `decode`
(receiver), and `wire_bits(leaf_sizes)`, the exact multi-leaf payload size;
`compress` is `decode ∘ encode`.

`stochastic` says whether the channel consumes keys (the driver advances
its key chain only for those); `per_message` says each sender's message of
a stacked uplink is encoded independently with its own key (the engine
keys sender i with `fold_in(sub, i)`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.comm.bits import (
    dense_message_bits,
    packed_wire_bits,
    qsgd_code_bits,
    qsgd_message_bits,
)
from repro_torch.kernels.ops import (
    DEFAULT_BLOCK,
    qsgd_compress_tree,
    qsgd_decode_tree,
    qsgd_encode_tree,
)
from repro_torch.kernels.qsgd import MAX_BLOCK, MAX_LEVELS

Tree = Any


@dataclasses.dataclass(frozen=True)
class DenseChannel:
    """Uncompressed f32 transport: the identity, `bits_per_param` per entry."""

    bits_per_param: int = 32
    stochastic: bool = dataclasses.field(default=False, init=False)
    per_message: bool = dataclasses.field(default=False, init=False)

    def compress(self, tree: Tree, key: np.ndarray | None = None) -> Tree:
        return tree

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

    def encode(self, tree: Tree, keys: np.ndarray) -> list:
        return qsgd_encode_tree(tree, keys, s=self.levels, block=self.block)

    def decode(self, wires: list, like: Tree) -> Tree:
        return qsgd_decode_tree(wires, like, s=self.levels, block=self.block)

    def compress(self, tree: Tree, keys: np.ndarray) -> Tree:
        return qsgd_compress_tree(tree, keys, s=self.levels, block=self.block)

    def message_bits(self, num_params: int) -> int:
        return qsgd_message_bits(num_params, self.levels, self.block)

    def wire_bits(self, leaf_sizes) -> int:
        return packed_wire_bits(leaf_sizes, qsgd_code_bits(self.levels), self.block)


Channel = DenseChannel | QSGDChannel


def channel_wire_bits(channel: Channel, num_params: int, leaf_sizes=None) -> int:
    """The exact per-message bits a driver puts in the ledger: the real
    multi-leaf payload where leaf sizes are given, else the flat formula."""
    if leaf_sizes is not None:
        return channel.wire_bits(tuple(leaf_sizes))
    return channel.message_bits(num_params)


def make_channel(qsgd_levels: int | None, bits_per_param: int = 32) -> Channel:
    """The (qsgd_levels, bits_per_param) config pair as a Channel."""
    if qsgd_levels is None:
        return DenseChannel(bits_per_param)
    return QSGDChannel(qsgd_levels)
