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
the ES hop by one launch per leaf for all M.

Two knobs of `RoundEngine` take a round from MLP clients to 0.6B-param LM
clients on one card:

* `client_microbatch = mb` trains the clients of an interaction in groups
  of mb (the tail group padded with slot-0 replicas that carry zero gamma
  and a zero mask) and adds each group's gamma-weighted deltas into one
  master-dtype accumulator, so mb client replicas are live at once, not n.
  Each sender keeps the key of its global slot, so its QSGD message does
  not depend on the group width.  The multi-cluster round takes slots
  [g*mb, (g+1)*mb) of every cluster per group: M * mb senders per launch.
  Only the order of the aggregate's sum changes (exact at mb >= n).
* `precision` (`core/precision.py`): clients compute in
  `precision.compute` (params, batch and step sizes cast once per
  interaction; raw deltas at that width), deltas are cast up to
  `precision.master` before the aggregate, and the params the ES holds,
  the ES->PS hop included, stay in the master dtype.  Grad mode ignores it.

Both default to None, which is the computation without them.  Not ported
yet: telemetry taps and the whole-run scan executor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channels import Channel, DenseChannel
from repro_torch.core.ledger import CommLedger
from repro_torch.core.oracles import grad_phase, local_opt_steps
from repro_torch.core.precision import Precision, cast_floats, compute_cast, master_cast
from repro_torch.core.prng import fold_in
from repro_torch.models.fed import as_fed_model
from repro_torch.optim.local import AdamWOpt, PlainSGD
from repro_torch.utils import tree_add, tree_leaves, tree_map

Tree = Any


def compress_uplinks(channel: Channel, deltas: Tree, sub: np.ndarray | None,
                     slots: np.ndarray | None = None) -> Tree:
    """Compress a stacked uplink (leading sender axis on every leaf).

    Per-message channels key each sender with `fold_in(sub, slot)`, as the
    reference does, so a sender's key does not depend on how many senders
    the uplink carries.  `sub` may also hold one key per group of equally
    many consecutive senders (G, 2), the clusters of a flattened client
    grid.  `slots` gives each sender's slot id, (G, senders per group) or
    (senders,) with one key; by default sender i of a group is slot i.  The
    microbatched rounds pass the global slots of a client group, so client
    i's message is keyed alike whatever the group width.  A key-free
    channel (Sign-SGD, Top-K) gets one blank key per sender, which gives it
    the sender axis.  Dense transforms the stack directly."""
    if channel.per_message:
        n = tree_leaves(deltas)[0].shape[0]
        if channel.stochastic:
            groups = np.reshape(sub, (-1, 2))
            if slots is None:
                slots = np.tile(np.arange(n // len(groups)), (len(groups), 1))
            slots = np.reshape(slots, (len(groups), -1))
            keys = np.stack([fold_in(g, int(i)) for g, row in zip(groups, slots) for i in row])
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


def _pad_slots(tree: Tree, axis: int, pad: int) -> Tree:
    """Append `pad` replicas of slot 0 along `axis` of every leaf."""
    def rep(a):
        first = a.narrow(axis, 0, 1)
        return torch.cat([a, first.expand(a.shape[:axis] + (pad,) + a.shape[axis + 1:])], axis)

    return tree_map(rep, tree) if pad else tree


def _cat(parts, dim: int) -> torch.Tensor:
    """Concatenate the groups' parts (one group: that part itself, uncopied)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _zero_pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Append `pad` zeros along the last axis."""
    return torch.cat([t, t.new_zeros(t.shape[:-1] + (pad,))], -1) if pad else t


@dataclasses.dataclass(frozen=True)
class RoundEngine:
    """Per-run facade over the round functions.  `channel` compresses
    client -> ES uplinks; `es_channel` (3-tier HFL only) compresses ES -> PS
    uplinks and defaults to `channel`; `local_opt` is the client-held
    optimizer (the default `PlainSGD` is the Eq. (5) step).

    `client_microbatch` bounds how many client replicas train at once
    (None: all clients of the round in one vmap).  `precision` is the
    mixed-precision policy (`core/precision.py`); grad mode ignores it.
    `AdamWOpt` under a policy raises TypeError, as the reference's round
    does: its compute-dtype moments divided by f32 bias corrections come
    back f32, which its scan carry refuses."""

    model: Any
    channel: Channel = DenseChannel()
    es_channel: Channel | None = None
    local_opt: Any = None
    client_microbatch: int | None = None
    precision: Precision | None = None

    def __post_init__(self):
        object.__setattr__(self, "model", as_fed_model(self.model))
        if self.local_opt is None:
            object.__setattr__(self, "local_opt", PlainSGD())
        if self.client_microbatch is not None and self.client_microbatch < 1:
            raise ValueError(f"client_microbatch must be >= 1, got {self.client_microbatch}")
        if self.precision is not None and isinstance(self.local_opt, AdamWOpt):
            raise TypeError(
                "AdamWOpt under a Precision policy: its compute-dtype moments come back "
                "in the master dtype, and the reference's round refuses the promoted "
                "carry with a TypeError; use MomentumSGD or PlainSGD, or no policy")

    def init_opt_state(self, params: Tree, *lead: int) -> Tree:
        """Fresh per-client optimizer state with leading axes `lead`.  Under
        a policy it is seeded from the compute-dtype params, so client-held
        state lives at compute width."""
        if self.precision is not None:
            params = cast_floats(params, self.precision.compute)
        state = self.local_opt.init(params)
        for n in reversed(lead):
            state = tree_map(lambda leaf, n=n: leaf.expand((n,) + leaf.shape).clone(), state)
        return state

    def grad_round(self, params, batch, gammas, lrs):
        """batch leaves (K, n, B, ...), gammas (n,) tensor, lrs (K,).
        Returns (params, per-step gamma-weighted losses (K,))."""
        return grad_phase(self.model, self.client_microbatch)(params, batch, gammas, lrs)

    def _train_group(self, local, base, state, batch, lrs, mask, sub, slots=None):
        """One group of senders: E local steps from `base` (compute dtype,
        leading sender axis), raw deltas zeroed where `mask` is 0 (None: no
        mask), compressed and cast up to master.  Masked slots keep their
        optimizer state.  Returns (deltas, state, losses (senders,))."""
        new_p, new_state, losses = local(base, state, batch, lrs)
        if mask is None:
            raw = tree_map(torch.sub, new_p, base)
        else:
            new_state = _freeze_masked(mask, new_state, state)
            raw = tree_map(
                lambda a, b: (a - b) * mask.to(a.dtype).reshape((-1,) + (1,) * (a.ndim - 1)),
                new_p, base)
        deltas = compress_uplinks(self.channel, raw, sub, slots)
        return master_cast(deltas, self.precision), new_state, losses

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
        lrs = compute_cast(np.asarray(lrs), self.precision)
        local = local_opt_steps(self.model, self.local_opt)
        losses = []
        for j in range(J):
            params, opt_state, client_losses = self._cluster_step(
                local, params, opt_state, tree_map(lambda a: a[j], batch), gammas, mask,
                lrs[j], None if subs is None else subs[j])
            if mask is None:
                losses.append(client_losses.mean())
            else:
                losses.append((client_losses * mask).sum() / torch.clamp(mask.sum(), min=1.0))
        return params, opt_state, torch.stack(losses)

    def _cluster_step(self, local, params, state, batch, gammas, mask, lrs, sub):
        """One interaction of one cluster: params and batch cast to the
        compute dtype, then the clients in groups of `client_microbatch`
        (all n in one group without it), each group's gamma-weighted deltas
        summed into the update, which is added to the master-dtype params.
        The tail group is padded with slot-0 replicas that carry zero gamma
        and a zero mask.  Returns (params, state, per-client losses (n,))."""
        n = gammas.shape[0]
        mb = self.client_microbatch or n
        pad = (-n) % mb
        if pad:
            mask = torch.ones_like(gammas) if mask is None else mask
            gammas, mask = _zero_pad(gammas, pad), _zero_pad(mask, pad)
            batch, state = _pad_slots(batch, 0, pad), _pad_slots(state, 0, pad)
        p_c = compute_cast(params, self.precision)
        batch = compute_cast(batch, self.precision)
        base = tree_map(lambda a: a.expand((mb,) + a.shape), p_c)
        acc, states, losses = None, [], []
        for g in range(0, n + pad, mb):
            group = lambda a, g=g: a[g:g + mb]  # noqa: E731
            deltas, s_g, l_g = self._train_group(
                local, base, tree_map(group, state), tree_map(group, batch), lrs,
                None if mask is None else group(mask), sub, np.arange(g, g + mb))
            agg = tree_map(lambda d: torch.tensordot(group(gammas).to(d.dtype), d, dims=1), deltas)
            acc = agg if acc is None else tree_add(acc, agg)
            states.append(s_g)
            losses.append(l_g)
        state = tree_map(lambda *parts: _cat(parts, 0)[:n], *states)
        return tree_add(params, acc), state, _cat(losses, 0)[:n]

    def multi_cluster_round(self, params, batch, gammas, mask, es_weights, lrs,
                            subs=None, es_subs=None, opt_state=None):
        """One 3-tier HFL global round for all M clusters.

        batch leaves (J, M, n_max, E, B, ...); gammas, mask (M, n_max) and
        es_weights (M,) tensors; lrs (J, E); subs (J, M, 2) and es_subs
        (M, 2) key words (stochastic channels); opt_state leaves (M, n_max,
        ...).  Client slot i of cluster m is keyed `fold_in(subs[j, m], i)`;
        ES m is keyed `es_subs[m]` itself.  With `client_microbatch = mb`
        the interaction trains slots [g*mb, (g+1)*mb) of every cluster at
        once, M * mb senders per group.  Returns (params, opt_state,
        per-(interaction, cluster) losses (J, M))."""
        first = tree_leaves(batch)[0]
        J, M, n_max = first.shape[:3]
        if opt_state is None:
            opt_state = self.init_opt_state(params, M, n_max)
        mb = self.client_microbatch or n_max
        pad = (-n_max) % mb
        width = n_max + pad
        gammas_p, mask_p = _zero_pad(gammas, pad), _zero_pad(mask, pad)
        batch = _pad_slots(batch, 2, pad)
        state = _pad_slots(opt_state, 1, pad)
        lrs = compute_cast(np.asarray(lrs), self.precision)
        local = local_opt_steps(self.model, self.local_opt)
        cparams = tree_map(lambda a: a.expand((M,) + a.shape), params)
        losses = []
        for j in range(J):
            cp_c = compute_cast(cparams, self.precision)
            b_j = compute_cast(tree_map(lambda a: a[j], batch), self.precision)
            base = tree_map(
                lambda a: a[:, None].expand((M, mb) + a.shape[1:]).reshape((M * mb,) + a.shape[1:]),
                cp_c)
            acc, states, client_losses = None, [], []
            for g in range(0, width, mb):
                cols = lambda a, g=g: a[:, g:g + mb]  # noqa: E731
                grid = lambda a: a.reshape((M * mb,) + a.shape[2:])  # noqa: E731
                deltas, s_g, l_g = self._train_group(
                    local, base, tree_map(lambda a: grid(cols(a)), state),
                    tree_map(lambda a: grid(cols(a)), b_j), lrs[j], grid(cols(mask_p)),
                    None if subs is None else subs[j],
                    np.tile(np.arange(g, g + mb), (M, 1)))
                gam = cols(gammas_p)
                agg = tree_map(lambda d: torch.einsum(
                    "mn,mn...->m...", gam.to(d.dtype), d.reshape((M, mb) + d.shape[1:])), deltas)
                acc = agg if acc is None else tree_add(acc, agg)
                states.append(tree_map(lambda a: a.reshape((M, mb) + a.shape[1:]), s_g))
                client_losses.append(l_g.reshape(M, mb))
            cparams = tree_add(cparams, acc)
            state = tree_map(lambda *parts: _cat(parts, 1), *states)
            client_losses = _cat(client_losses, 1)[:, :n_max]
            losses.append((client_losses * mask).sum(dim=1)
                          / torch.clamp(mask.sum(dim=1), min=1.0))

        # ES -> PS: each ES's compressed cluster delta, keyed es_subs[m]
        # itself, in the master dtype
        es_channel = self.es_channel or self.channel
        raw_es = tree_map(lambda c, p: c - p[None], cparams, params)
        keys = es_subs if es_channel.stochastic else np.zeros((M, 2), np.uint32)
        es_deltas = es_channel.compress(raw_es, keys)
        agg = tree_map(lambda d: torch.tensordot(es_weights, d, dims=1), es_deltas)
        params = tree_add(params, agg)
        state = tree_map(lambda a: a[:, :n_max], state)
        return params, state, torch.stack(losses)

    def end_round(self, ledger: CommLedger, round_idx: int) -> None:
        """Uniform end-of-round bookkeeping: snapshot the ledger."""
        ledger.snapshot(round_idx)
