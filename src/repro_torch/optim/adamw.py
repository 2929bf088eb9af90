"""AdamW over parameter trees (port of `repro/optim/adamw.py`).

The step count is a tensor: () for one client, or the leading client axes
when the engine steps a stack of clients at once; the bias corrections are
broadcast over each leaf's trailing axes.  ``b ** count`` is taken in f64
from b's f32 value and rounded to f32 (equal to XLA's f32 power on the CPU
at every count tried), and the bias corrections divide by tensors: torch on
the card divides by a Python scalar as a multiply by its reciprocal."""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_map

Tree = Any
PyTree = Tree  # the reference's name


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def adamw_init(params: Tree) -> dict:
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _correction(b: float, count: torch.Tensor) -> torch.Tensor:
    """1 - b ** count in f32, b taken at its f32 value."""
    # a fill, not a copy from the host: a captured CUDA graph records it
    base = torch.full((), float(np.float32(b)), dtype=torch.float64, device=count.device)
    return 1 - torch.pow(base, count.to(torch.float64)).to(torch.float32)


def adamw_step(params: Tree, grads: Tree, state: dict, lr,
               config: AdamWConfig = AdamWConfig()) -> tuple[Tree, dict]:
    count = state["count"] + 1
    mu = tree_map(lambda m, g: config.b1 * m + (1 - config.b1) * g, state["mu"], grads)
    nu = tree_map(lambda v, g: config.b2 * v + (1 - config.b2) * g * g, state["nu"], grads)
    c1, c2 = _correction(config.b1, count), _correction(config.b2, count)

    def upd(p, m, v):
        lead = c1.shape + (1,) * (p.ndim - c1.ndim)
        mhat = m / c1.reshape(lead)
        vhat = v / c2.reshape(lead)
        return p - lr * (mhat / (torch.sqrt(vhat) + config.eps) + config.weight_decay * p)

    return tree_map(upd, params, mu, nu), {"mu": mu, "nu": nu, "count": count}
