"""The round engine shared by the four algorithms (port of `repro/core/engine.py`).

* `grad_round` — Eq. (5) literal: every in-cluster iteration uploads a
  gradient and the ES applies the gamma-weighted step (E=1, dense, plain
  SGD).
* `cluster_round` — delta mode: clients run E local optimizer steps,
  upload channel-compressed model deltas, the ES adds the gamma-weighted
  aggregate; repeated over the J = K/E interactions of a round.  An
  optional participation mask zeroes the dropped clients' deltas before
  compression and freezes their optimizer state.
* `multi_cluster_round` — the Hier-Local-QSGD round: the delta-mode
  interaction for all M clusters at once over a padded (M, n_max) client
  grid (padded slots carry zero gamma, their deltas are zeroed before
  compression and their optimizer state is frozen), then the ES->PS hop:
  each ES's compressed cluster delta, the PS's weighted aggregate.

The reference fuses a round into one jitted scan (with a vmap over
clusters); here a round is a Python loop over steps and interactions, with
the client axis carried by `torch.func.vmap`.  The multi-cluster round
flattens its client grid into that one axis, so each QSGD uplink leaf is
encoded and decoded by one kernel launch for all M * n_max senders, and
the ES hop by one launch per leaf for all M.  Not ported yet:
client microbatching, mixed precision, telemetry taps and the whole-run
scan executor.
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
    the uplink carries.  `sub` may also hold one key per group of equally
    many consecutive senders (G, 2), the clusters of a flattened client
    grid: sender i of group g is keyed `fold_in(sub[g], i)`.  A key-free
    channel (Sign-SGD, Top-K) gets one blank key per sender, which gives it
    the sender axis.  Dense transforms the stack directly."""
    if channel.per_message:
        n = tree_leaves(deltas)[0].shape[0]
        if channel.stochastic:
            groups = np.reshape(sub, (-1, 2))
            keys = np.stack([fold_in(g, i) for g in groups for i in range(n // len(groups))])
        else:
            keys = np.zeros((n, 2), np.uint32)
        return channel.compress(deltas, keys)
    return channel.compress(deltas, sub)


def _freeze_masked(mask: torch.Tensor, new_state: Tree, old_state: Tree) -> Tree:
    """Keep masked-out clients' optimizer state as it entered: slots with
    mask == 0 (leading axis) take the old state, the others the new."""
    return tree_map(
        lambda ns, os: torch.where(mask.reshape((-1,) + (1,) * (ns.ndim - 1)) > 0, ns, os),
        new_state, old_state)


@dataclasses.dataclass(frozen=True)
class RoundEngine:
    """Per-run facade over the round functions.  `channel` compresses
    client -> ES uplinks; `es_channel` (3-tier HFL only) compresses ES -> PS
    uplinks and defaults to `channel`; `local_opt` is the client-held
    optimizer (the default `PlainSGD` is the Eq. (5) step)."""

    model: Any
    channel: Channel = DenseChannel()
    es_channel: Channel | None = None
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

    def cluster_round(self, params, batch, gammas, lrs, subs=None, opt_state=None,
                      mask=None):
        """One delta-mode round.  batch leaves (J, n, E, B, ...), gammas (n,)
        tensor, lrs (J, E), subs (J, 2) key words (stochastic channels).
        `mask` (n,) is the optional per-client participation mask: masked-out
        clients upload a zero delta (zeroed before compression, keyed by
        their slot all the same), keep their optimizer state frozen and
        leave the loss average; `gammas` must already be renormalized over
        the participants.  With `mask=None` the round is the unmasked
        computation.  Returns (params, opt_state, per-interaction mean
        losses (J,))."""
        first = tree_leaves(batch)[0]
        J, n = first.shape[:2]
        if opt_state is None:
            opt_state = self.init_opt_state(params, n)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=first.device)
        local = local_opt_steps(self.model, self.local_opt)
        losses = []
        for j in range(J):
            stacked = tree_map(lambda a: a.expand((n,) + a.shape), params)
            new_p, new_state, client_losses = local(
                stacked, opt_state, tree_map(lambda a: a[j], batch), lrs[j])
            if mask is None:
                opt_state = new_state
                raw = tree_map(lambda a, base: a - base[None], new_p, params)
            else:
                opt_state = _freeze_masked(mask, new_state, opt_state)
                raw = tree_map(
                    lambda a, base: (a - base[None])
                    * mask.to(a.dtype).reshape((-1,) + (1,) * (a.ndim - 1)),
                    new_p, params)
            deltas = compress_uplinks(self.channel, raw, None if subs is None else subs[j])
            agg = tree_map(lambda d: torch.tensordot(gammas, d, dims=1), deltas)
            params = tree_add(params, agg)
            if mask is None:
                losses.append(client_losses.mean())
            else:
                losses.append((client_losses * mask).sum() / torch.clamp(mask.sum(), min=1.0))
        return params, opt_state, torch.stack(losses)

    def multi_cluster_round(self, params, batch, gammas, mask, es_weights, lrs,
                            subs=None, es_subs=None, opt_state=None):
        """One 3-tier HFL global round for all M clusters.

        batch leaves (J, M, n_max, E, B, ...); gammas, mask (M, n_max) and
        es_weights (M,) tensors; lrs (J, E); subs (J, M, 2) and es_subs
        (M, 2) key words (stochastic channels); opt_state leaves (M, n_max,
        ...).  Client slot i of cluster m is keyed `fold_in(subs[j, m], i)`;
        ES m is keyed `es_subs[m]` itself.  Returns (params, opt_state,
        per-(interaction, cluster) losses (J, M))."""
        first = tree_leaves(batch)[0]
        J, M, n_max = first.shape[:3]
        if opt_state is None:
            opt_state = self.init_opt_state(params, M, n_max)
        S = M * n_max
        grid = lambda a: a.reshape((S,) + a.shape[2:])  # (M, n_max, ...) -> (S, ...)
        state = tree_map(grid, opt_state)
        flat_mask = mask.reshape(S)
        local = local_opt_steps(self.model, self.local_opt)
        cparams = tree_map(lambda a: a.expand((M,) + a.shape), params)
        losses = []
        for j in range(J):
            base = tree_map(lambda a: grid(a[:, None].expand((M, n_max) + a.shape[1:])),
                            cparams)
            new_p, new_state, client_losses = local(
                base, state, tree_map(lambda a: grid(a[j]), batch), lrs[j])
            state = _freeze_masked(flat_mask, new_state, state)
            raw = tree_map(
                lambda a, b: (a - b) * flat_mask.reshape((-1,) + (1,) * (a.ndim - 1)),
                new_p, base)
            deltas = compress_uplinks(self.channel, raw, None if subs is None else subs[j])
            agg = tree_map(lambda d: torch.einsum(
                "mn,mn...->m...", gammas, d.reshape((M, n_max) + d.shape[1:])), deltas)
            cparams = tree_add(cparams, agg)
            client_losses = client_losses.reshape(M, n_max)
            losses.append((client_losses * mask).sum(dim=1)
                          / torch.clamp(mask.sum(dim=1), min=1.0))

        # ES -> PS: each ES's compressed cluster delta, keyed es_subs[m] itself
        es_channel = self.es_channel or self.channel
        raw_es = tree_map(lambda c, p: c - p[None], cparams, params)
        keys = es_subs if es_channel.stochastic else np.zeros((M, 2), np.uint32)
        es_deltas = es_channel.compress(raw_es, keys)
        agg = tree_map(lambda d: torch.tensordot(es_weights, d, dims=1), es_deltas)
        params = tree_add(params, agg)
        state = tree_map(lambda a: a.reshape((M, n_max) + a.shape[1:]), state)
        return params, state, torch.stack(losses)

    def end_round(self, ledger: CommLedger, round_idx: int) -> None:
        """Uniform end-of-round bookkeeping: snapshot the ledger."""
        ledger.snapshot(round_idx)
