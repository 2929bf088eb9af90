"""The mixed-precision policy of the round engine and the drivers' channel
rules (port of `repro/core/precision.py`).

One frozen dataclass names the three dtypes a federated round touches:

  * ``compute`` — the dtype clients train in: forward and backward, local
    optimizer steps and the raw deltas.  Client-held optimizer state is
    seeded from the compute-cast params, so it lives at this width too.
  * ``master`` — the dtype of the params the ES holds and of the delta
    accumulator: client deltas are cast up before the gamma-weighted
    aggregate, so rounding happens once per message, not once per add.
  * ``wire`` — the dtype a dense uplink or broadcast travels in: the
    drivers build `DenseChannel(wire_dtype=...)` from it and price the
    ledger off that channel, and a model broadcast at its width.

`compute_cast` and `master_cast` are the identity when the policy is None:
they return the tree itself and add no operation, so the ``precision=None``
round is exactly the computation without a policy.  Grad mode (the
paper-literal Eq. (5) path) ignores the policy; the drivers' grad-mode gate
excludes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.bits import dtype_bits
from repro_torch.comm.channels import Channel, DenseChannel, make_channel
from repro_torch.utils import tree_map

Tree = Any

# the dtype names a policy accepts; each has a wire width in
# `comm.bits.dtype_bits` (tests/test_torch_precision.py holds the two in sync)
_SUPPORTED = ("float32", "bfloat16", "float16", "float8_e4m3fn")


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy: compute / master / wire dtype names."""

    compute: str = "bfloat16"
    master: str = "float32"
    wire: str = "bfloat16"

    def __post_init__(self):
        for field in ("compute", "master", "wire"):
            dt = getattr(self, field)
            if dt not in _SUPPORTED:
                raise ValueError(f"Precision.{field}={dt!r} not in {_SUPPORTED}")


def cast_floats(tree: Tree, dtype: str | torch.dtype) -> Tree:
    """Cast every floating leaf of `tree` to `dtype`; integer leaves are left
    alone.  A host-side float array (a round's step sizes) becomes the f64
    array of the values `dtype` holds, so a step taken with it uses the
    rounded step size, as the reference's cast of its lr array does."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def cast(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.to(dt) if leaf.is_floating_point() else leaf
        if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
            return torch.from_numpy(np.ascontiguousarray(leaf)).to(dt).double().numpy()
        return leaf

    return tree_map(cast, tree)


def compute_cast(tree: Tree, precision: Precision | None) -> Tree:
    """Params, batch and step sizes cast to the compute dtype; `tree` itself
    when there is no policy."""
    return tree if precision is None else cast_floats(tree, precision.compute)


def master_cast(tree: Tree, precision: Precision | None) -> Tree:
    """Deltas cast up to the master dtype before accumulation; `tree` itself
    when there is no policy."""
    return tree if precision is None else cast_floats(tree, precision.master)


def dense_wire_channel(precision: Precision) -> DenseChannel:
    """The `DenseChannel` of a policy's wire dtype: a dense uplink travels,
    and is priced, at ``precision.wire`` width."""
    return DenseChannel(wire_dtype=precision.wire)


def resolve_channel(precision: Precision | None, channel: Channel | None = None,
                    qsgd_levels: int | None = None, bits_per_param: int = 32) -> Channel:
    """The drivers' uplink channel: an explicit `channel` wins; then a
    quantized config (`qsgd_levels`, whose codes are narrower than any float
    wire); then a policy's wire dtype; else the f32 dense channel at
    `bits_per_param`."""
    if channel is not None:
        return channel
    if qsgd_levels is None and precision is not None:
        return dense_wire_channel(precision)
    return make_channel(qsgd_levels, bits_per_param)


def downlink_bits_per_param(precision: Precision | None, bits_per_param: int = 32) -> int:
    """Width of a dense model broadcast (ES->client, ES->ES, ES<->PS): the
    policy's wire dtype under a policy (the ES ships the compute-dtype
    model), else `bits_per_param`."""
    return dtype_bits(precision.wire) if precision is not None else bits_per_param
