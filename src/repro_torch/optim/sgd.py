"""SGD, optionally with (Nesterov) momentum and weight decay, over parameter
trees (port of `repro/optim/sgd.py`).

Every operation is elementwise, so a step works alike on one client's
params and on a stack of clients' params with a leading client axis."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False


def sgd_init(params: Tree, config: SGDConfig = SGDConfig()) -> Tree:
    if config.momentum == 0.0:
        return ()
    return tree_map(torch.zeros_like, params)


def _held(x: float, like: torch.Tensor) -> float:
    """`x` rounded to `like`'s dtype, as the reference's constants are when
    they meet an array of that dtype (f32 arithmetic rounds it alike)."""
    return float(torch.tensor(x, dtype=like.dtype))


def sgd_step(params: Tree, grads: Tree, opt_state: Tree, lr,
             config: SGDConfig = SGDConfig()) -> tuple[Tree, Tree]:
    if config.weight_decay:
        grads = tree_map(lambda g, p: g + _held(config.weight_decay, p) * p, grads, params)
    if config.momentum == 0.0:
        return tree_map(lambda p, g: p - lr * g, params, grads), opt_state
    new_state = tree_map(lambda m, g: _held(config.momentum, m) * m + g, opt_state, grads)
    if config.nesterov:
        update = tree_map(lambda m, g: _held(config.momentum, m) * m + g, new_state, grads)
    else:
        update = new_state
    return tree_map(lambda p, u: p - lr * u, params, update), new_state
