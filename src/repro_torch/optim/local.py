"""Client-held local optimizers (port of `repro/optim/local.py`).

A local optimizer's state stays on the client and never traverses a
channel: uplinks carry model deltas only.  `PlainSGD` is the paper's Eq. (5)
step and stateless.  The engine applies a step to the stacked parameters of
all clients it trains at once, with the state stacked the same way
(`RoundEngine.init_opt_state`), so every step here works on a leading
client axis as on one client.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step
from repro_torch.optim.sgd import SGDConfig, sgd_init, sgd_step
from repro_torch.utils import tree_map

Tree = Any


@runtime_checkable
class LocalOpt(Protocol):
    """Per-client local optimizer: state init and one step."""

    def init(self, params: Tree) -> Tree:
        """Fresh optimizer state (an empty tree if stateless)."""
        ...

    def step(self, params: Tree, state: Tree, grads: Tree, lr) -> tuple[Tree, Tree]:
        """One local update: -> (new params, new state)."""
        ...


@dataclasses.dataclass(frozen=True)
class PlainSGD:
    """Stateless ``w <- w - lr * g``."""

    def init(self, params: Tree) -> Tree:
        return ()

    def step(self, params, state, grads, lr):
        return tree_map(lambda w, g: w - lr * g, params, grads), state


@dataclasses.dataclass(frozen=True)
class MomentumSGD:
    """SGD with (optionally Nesterov) momentum, state = one velocity tree."""

    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

    def _config(self) -> SGDConfig:
        return SGDConfig(self.momentum, self.weight_decay, self.nesterov)

    def init(self, params: Tree) -> Tree:
        return sgd_init(params, self._config())

    def step(self, params, state, grads, lr):
        return sgd_step(params, grads, state, lr, self._config())


@dataclasses.dataclass(frozen=True)
class AdamWOpt:
    """Client-held AdamW (first/second moments + step count stay local)."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def _config(self) -> AdamWConfig:
        return AdamWConfig(self.b1, self.b2, self.eps, self.weight_decay)

    def init(self, params: Tree) -> Tree:
        return adamw_init(params)

    def step(self, params, state, grads, lr):
        return adamw_step(params, grads, state, lr, self._config())
