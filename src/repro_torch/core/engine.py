"""The cluster-round engine (port of `repro/core/engine.py`, Fed-CHS's rounds).

* `grad_round` — Eq. (5) literal: every in-cluster iteration uploads a
  gradient and the ES applies the gamma-weighted step (E=1, dense, plain
  SGD).
* `cluster_round` — delta mode: clients run E local optimizer steps,
  upload channel-compressed model deltas, the ES adds the gamma-weighted
  aggregate; repeated over the J = K/E interactions of a round.

The reference fuses a round into one jitted scan; here a round is a Python
loop over steps and interactions, with the client axis carried by
`torch.func.vmap` and each QSGD uplink leaf encoded and decoded by one
kernel launch for all senders.  Not ported yet: the masked round
(participation), client microbatching, mixed precision, telemetry taps, the
3-tier multi-cluster round and the whole-run scan executor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channels import Channel, DenseChannel
from repro_torch.core.ledger import CommLedger
from repro_torch.core.oracles import grad_phase, local_opt_steps
from repro_torch.core.prng import fold_in
from repro_torch.models.fed import as_fed_model
from repro_torch.optim.local import PlainSGD
from repro_torch.utils import tree_add, tree_leaves, tree_map

Tree = Any


def compress_uplinks(channel: Channel, deltas: Tree, sub: np.ndarray | None) -> Tree:
    """Compress a stacked uplink (leading sender axis on every leaf).

    Per-message channels key sender i with `fold_in(sub, i)`, as the
    reference does, so a sender's key does not depend on how many senders
    the uplink carries.  Dense transforms the stack directly."""
    if channel.per_message:
        n = tree_leaves(deltas)[0].shape[0]
        keys = np.stack([fold_in(sub, i) for i in range(n)])
        return channel.compress(deltas, keys)
    return channel.compress(deltas, sub)


@dataclasses.dataclass(frozen=True)
class RoundEngine:
    """Per-run facade over the round functions.  `channel` compresses
    client -> ES uplinks; `local_opt` is the client-held optimizer (the
    default `PlainSGD` is the Eq. (5) step)."""

    model: Any
    channel: Channel = DenseChannel()
    local_opt: Any = None

    def __post_init__(self):
        object.__setattr__(self, "model", as_fed_model(self.model))
        if self.local_opt is None:
            object.__setattr__(self, "local_opt", PlainSGD())

    def init_opt_state(self, params: Tree, *lead: int) -> Tree:
        """Fresh per-client optimizer state with leading axes `lead`."""
        state = self.local_opt.init(params)
        for n in reversed(lead):
            state = tree_map(lambda leaf, n=n: leaf.expand((n,) + leaf.shape).clone(), state)
        return state

    def grad_round(self, params, batch, gammas, lrs):
        """batch leaves (K, n, B, ...), gammas (n,) tensor, lrs (K,).
        Returns (params, per-step gamma-weighted losses (K,))."""
        return grad_phase(self.model)(params, batch, gammas, lrs)

    def cluster_round(self, params, batch, gammas, lrs, subs=None, opt_state=None):
        """One delta-mode round.  batch leaves (J, n, E, B, ...), gammas (n,)
        tensor, lrs (J, E), subs (J, 2) key words (stochastic channels).
        Returns (params, opt_state, per-interaction mean losses (J,))."""
        first = tree_leaves(batch)[0]
        J, n = first.shape[:2]
        if opt_state is None:
            opt_state = self.init_opt_state(params, n)
        local = local_opt_steps(self.model, self.local_opt)
        losses = []
        for j in range(J):
            stacked = tree_map(lambda a: a.expand((n,) + a.shape), params)
            new_p, opt_state, client_losses = local(
                stacked, opt_state, tree_map(lambda a: a[j], batch), lrs[j])
            raw = tree_map(lambda a, base: a - base[None], new_p, params)
            deltas = compress_uplinks(self.channel, raw, None if subs is None else subs[j])
            agg = tree_map(lambda d: torch.tensordot(gammas, d, dims=1), deltas)
            params = tree_add(params, agg)
            losses.append(client_losses.mean())
        return params, opt_state, torch.stack(losses)

    def end_round(self, ledger: CommLedger, round_idx: int) -> None:
        """Uniform end-of-round bookkeeping: snapshot the ledger."""
        ledger.snapshot(round_idx)
