"""Client-held local optimizers (port of `repro/optim/local.py`: `PlainSGD` only).

A local optimizer's state stays on the client and never traverses a
channel.  `PlainSGD` is the paper's Eq. (5) step and stateless; the engine
applies it to the stacked parameters of all clients of a cluster at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.utils import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class PlainSGD:
    """Stateless ``w <- w - lr * g``."""

    def init(self, params: Tree) -> Tree:
        return ()

    def step(self, params, state, grads, lr):
        return tree_map(lambda w, g: w - lr * g, params, grads), state
