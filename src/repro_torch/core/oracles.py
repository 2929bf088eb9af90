"""Local-update oracles (port of `repro/core/oracles.py`).

  * `local_opt_steps(model, opt)` — E local optimizer steps for a stack of
    clients (leading client axis on params and batch leaves), each client
    from its own params, through `torch.func.vmap` over the client axis.
  * `grad_phase(model, microbatch)` — the Eq. (5) literal: K joint steps
    of ``w <- w - eta_k * sum_n gamma_n grad_n(w, xi_{n,k})``, with at most
    `microbatch` clients' forward and backward passes live at once.

Step sizes may be a device tensor: a step multiplies by its 0-dim entry,
which rounds as the Python float of the same value does, and reads nothing
back to the host (a captured CUDA graph replays it).

The classifier-signature wrappers `local_sgd`, `multi_client_local_sgd`
and `cluster_sgd` keep the reference's historical ``(params, xs, ys,
lrs)`` calling convention, for its seed-style loops and benchmarks.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.func import vmap

from repro_torch.models.fed import as_fed_model
from repro_torch.optim.local import PlainSGD
from repro_torch.utils import grad_and_value, tree_leaves, tree_map

Tree = Any
PyTree = Tree  # the reference's name


def _steps(lrs) -> list:
    """The step sizes one by one: 0-dim entries of a tensor, or floats."""
    if isinstance(lrs, torch.Tensor):
        return list(lrs.unbind(0))
    return [float(lr) for lr in lrs]


def local_opt_steps(model, opt):
    """E local steps per client: params leaves (n, ...), batch leaves
    (n, E, B, ...), lrs (E,): a tensor (each step reads its 0-dim entry, so
    no host value enters the step) or host floats.

    Returns ``run(params, opt_state, batch, lrs) -> (params, opt_state,
    per-client mean losses (n,))``."""
    per_client = vmap(grad_and_value(model.loss), in_dims=(0, 0))

    def run(params, opt_state, batch, lrs):
        losses = []
        for e, lr in enumerate(_steps(lrs)):
            grads, loss = per_client(params, tree_map(lambda a: a[:, e], batch))
            params, opt_state = opt.step(params, opt_state, grads, lr)
            losses.append(loss)
        return params, opt_state, torch.stack(losses, dim=1).mean(dim=1)

    return run


def grad_phase(model, microbatch: int | None = None, gather=None):
    """Eq. (5) literal: batch leaves (K, n, B, ...); gammas (n,); lrs (K,).
    Returns (params, per-step gamma-weighted losses (K,)).

    `gather((grads, losses)) -> (grads, losses)` widens each step's
    per-client stacks before the aggregate: on a federation mesh the batch
    holds this rank's clients and `gather` returns every client's, so the
    tensordot runs over the full width `gammas` has
    (`repro_torch.sharding.fed.Split.gather`).

    `microbatch` bounds how many clients' forward and backward passes are
    live at once: each step runs ceil(n / microbatch) groups of the vmap,
    the tail group padded with client-0 replicas that are sliced off.  The
    full per-step gradient stack (n, ...) still feeds the same tensordot,
    so only the activations drop from n clients' to `microbatch` clients'."""
    grad_fn = vmap(grad_and_value(model.loss), in_dims=(None, 0))

    if microbatch is None:
        per_client = grad_fn
    else:
        mb = int(microbatch)
        if mb < 1:
            raise ValueError(f"microbatch must be >= 1, got {mb}")

        def per_client(p, b_k):
            n = tree_leaves(b_k)[0].shape[0]
            pad = (-n) % mb
            if pad:
                b_k = tree_map(lambda a: torch.cat([a, a[:1].expand((pad,) + a.shape[1:])]),
                               b_k)
            outs = [grad_fn(p, tree_map(lambda a, g=g: a[g:g + mb], b_k))
                    for g in range(0, n + pad, mb)]
            grads = tree_map(lambda *gs: torch.cat(gs)[:n], *[g for g, _ in outs])
            return grads, torch.cat([loss for _, loss in outs])[:n]

    def phase(params, batch, gammas, lrs):
        losses = []
        for k, lr in enumerate(_steps(lrs)):
            grads, loss = per_client(params, tree_map(lambda a: a[k], batch))
            if gather is not None:
                grads, loss = gather((grads, loss))
            agg = tree_map(lambda g: torch.tensordot(gammas, g, dims=1), grads)
            params = tree_map(lambda w, g: w - lr * g, params, agg)
            losses.append(torch.dot(gammas, loss))
        return params, torch.stack(losses)

    return phase


# --------------------------------------------------------------------------
# classifier-signature oracles
# --------------------------------------------------------------------------


@functools.cache
def multi_client_local_sgd(model):
    """E plain local SGD steps for each of n clients from the same params:
    xs (n, E, B, ...), ys (n, E, B), lrs (E,).  Returns (params with a
    leading client axis, per-client mean losses (n,))."""
    run = local_opt_steps(as_fed_model(model), PlainSGD())

    def fn(params, xs, ys, lrs):
        n = xs.shape[0]
        stacked = tree_map(lambda a: a.expand(n, *a.shape), params)
        p, _, losses = run(stacked, (), {"x": xs, "y": ys}, lrs)
        return p, losses

    return fn


@functools.cache
def local_sgd(model):
    """E plain local SGD steps for ONE client: xs (E, B, ...), ys (E, B),
    lrs (E,).  Returns (params, mean loss)."""
    many = multi_client_local_sgd(model)

    def fn(params, xs, ys, lrs):
        p, losses = many(params, xs[None], ys[None], lrs)
        return tree_map(lambda a: a[0], p), losses[0]

    return fn


@functools.cache
def cluster_sgd(model):
    """One Eq. (5) in-cluster phase: xs (K, n, B, ...), ys (K, n, B),
    gammas (n,), lrs (K,).  Returns (params, mean loss over steps)."""
    phase = grad_phase(as_fed_model(model))

    def fn(params, xs, ys, gammas, lrs):
        p, losses = phase(params, {"x": xs, "y": ys}, gammas, lrs)
        return p, torch.mean(losses)

    return fn
