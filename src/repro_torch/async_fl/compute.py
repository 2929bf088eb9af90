"""The async drivers' two computations: local updates and weighted folds
(port of `repro/async_fl/compute.py`).

The synchronous engine runs dispatch -> local train -> fold as one round;
the async event loop has to split them, because the updates a fold
consumes were computed at different times on different model versions.
Both halves are the engine's own building blocks: the client step is
`oracles.local_opt_steps` from the same broadcast model, the uplink is
`engine.compress_uplinks` with one key per sender, and the fold is the
`torch.tensordot` over the update axis that `RoundEngine._cluster_step`
aggregates with.  So a full-quorum, zero-staleness async fold computes
the synchronous J = 1 round with the same operations at the same shapes,
bit for bit on the CPU and on the card (cuBLAS orders a sum by its
length, so a fold of another shape could differ in the last place).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channels import Channel
from repro_torch.core.engine import compress_uplinks
from repro_torch.core.oracles import local_opt_steps
from repro_torch.utils import named_scope, tree_add, tree_leaves, tree_map

Tree = Any


@functools.cache
def client_updates_fn(model, channel: Channel, opt):
    """(params, opt_state (n, ...), batch (n, E, B, ...), lrs (E,), sub) ->
    (deltas (n, ...), new_opt (n, ...), losses (n,)).

    Each of the n clients runs E local optimizer steps from the same
    broadcast params (the engine's delta-mode interaction with J = 1); the
    uploaded deltas go through the channel with per-sender
    `fold_in(sub, slot)` keys (`compress_uplinks`), so on the card a QSGD
    uplink launches B1 and B2 once per leaf for the whole cohort."""
    local = local_opt_steps(model, opt)

    def fn(params, opt_state, batch, lrs, sub):
        n = tree_leaves(batch)[0].shape[0]
        base = tree_map(lambda a: a.expand((n,) + a.shape), params)
        with named_scope("local_train"):
            new_params, new_opt, losses = local(base, opt_state, batch, lrs)
        with named_scope("uplink"):
            deltas = compress_uplinks(channel, tree_map(torch.sub, new_params, base), sub)
        return deltas, new_opt, losses

    return fn


@functools.cache
def fold_fn(model):
    """(params, deltas (j, ...), weights (j,)) -> params + sum_i w_i d_i, with
    the engine's aggregation op; the async drivers pass staleness-discounted
    weights instead of the synchronous gammas."""
    del model  # cache key only: a fold depends on the params alone

    def fn(params, deltas, weights):
        return tree_add(params, tree_map(
            lambda d: torch.tensordot(weights.to(d.dtype), d, dims=1), deltas))

    return fn


def stack_updates(deltas: list[Tree]) -> Tree:
    """Per-update delta trees stacked along a new leading fold axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *deltas)


def no_subs() -> np.ndarray:
    """Placeholder key words of a dispatch whose channel takes none."""
    return np.zeros((2,), np.uint32)
