"""Local-update oracles (port of `repro/core/oracles.py`).

  * `local_opt_steps(model, opt)` — E local optimizer steps for a stack of
    clients (leading client axis on params and batch leaves), each client
    from its own params, through `torch.func.vmap` over the client axis.
  * `grad_phase(model)` — the Eq. (5) literal: K joint steps of
    ``w <- w - eta_k * sum_n gamma_n grad_n(w, xi_{n,k})``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.func import grad_and_value, vmap

from repro_torch.utils import tree_map

Tree = Any


def local_opt_steps(model, opt):
    """E local steps per client: params leaves (n, ...), batch leaves
    (n, E, B, ...), lrs (E,) floats.

    Returns ``run(params, opt_state, batch, lrs) -> (params, opt_state,
    per-client mean losses (n,))``."""
    per_client = vmap(grad_and_value(model.loss), in_dims=(0, 0))

    def run(params, opt_state, batch, lrs):
        losses = []
        for e, lr in enumerate(lrs):
            grads, loss = per_client(params, tree_map(lambda a: a[:, e], batch))
            params, opt_state = opt.step(params, opt_state, grads, float(lr))
            losses.append(loss)
        return params, opt_state, torch.stack(losses, dim=1).mean(dim=1)

    return run


def grad_phase(model):
    """Eq. (5) literal: batch leaves (K, n, B, ...); gammas (n,); lrs (K,).
    Returns (params, per-step gamma-weighted losses (K,))."""
    per_client = vmap(grad_and_value(model.loss), in_dims=(None, 0))

    def phase(params, batch, gammas, lrs):
        losses = []
        for k, lr in enumerate(lrs):
            grads, loss = per_client(params, tree_map(lambda a: a[k], batch))
            agg = tree_map(lambda g: torch.tensordot(gammas, g, dims=1), grads)
            params = tree_map(lambda w, g: w - float(lr) * g, params, agg)
            losses.append(torch.dot(gammas, loss))
        return params, torch.stack(losses)

    return phase
