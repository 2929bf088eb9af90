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

Both default to None, which is the computation without them.

A round takes its per-round inputs as device tensors: gammas, the
participation mask, the step sizes and, for a stochastic per-message
channel, every sender's per-leaf key words as one int32 tensor (derived on
the host by `prng.message_leaf_keys`, see `uplink_keys`).  Numpy inputs
(the key words of the reference's `split_chain`, a numpy mask or step
sizes) are still taken and moved to the device once per round.  A round
then reads no host value, so the whole-run executor below can capture it
in a CUDA graph.

The whole-run executor (`ScanPlan`, `run_scan`, `run_scan_sweep`) is the
counterpart of the reference's `lax.scan` over rounds: the driver
precomputes the run's schedule on the host, stages its per-round inputs a
chunk of rounds at a time, and a scan body advances the carry one round.
On the CPU a chunk runs its rounds eagerly; on the card the first trained
round runs eagerly on a side stream, one round of the body is captured in a
`torch.cuda.CUDAGraph`, and every later round is a replay (see
`_GraphRounds`).  A plan rewritten for a federation mesh
(`repro_torch.sharding.fed.shard_plan`) runs the same bodies with the
mesh's splits (`RoundEngine.client_split`, `cluster_split`), through its
own chunk and per-rank put (`ScanPlan.chunk_fn`, `xs_put`), eagerly on any
device (`_ChunkRounds`): its all-gathers pass through the host.

Telemetry (`repro_torch.obs`): `taps=True` on a round returns its tele dict
as one more output, a snapshot of the round's last interaction, as in the
reference; the scan bodies take `taps` too, and a plan's `obs` makes the
executor stack each chunk's tele and hand it to `obs.record_stacked`.
Taps read the round's tensors and write none, so a tapped round's params
equal the untapped round's bit for bit.  `taps=False` is the untapped
computation, unchanged.  Taps under `client_microbatch` raise, as the
reference's assert does: the tapped interaction reads every client's raw
delta at once.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channels import Channel, DenseChannel
from repro_torch.core.ledger import CommLedger
from repro_torch.core.oracles import grad_phase, local_opt_steps
from repro_torch.core.precision import Precision, cast_floats, compute_cast, master_cast
from repro_torch.core.prng import message_leaf_keys, split_each
from repro_torch.core.prng import split_chain  # noqa: F401  (the reference engine's name)
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.ops import key_words
from repro_torch.models.fed import as_fed_model
from repro_torch.obs.taps import delta_taps, grad_taps, stack_taps, tree_client_norms
from repro_torch.obs.trace import maybe_span
from repro_torch.optim.local import AdamWOpt, PlainSGD
from repro_torch.utils import (named_scope, tree_add, tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)

Tree = Any
PyTree = Tree  # the reference's name
Batch = Any  # a tree of tensors sharing leading axes
_log = logging.getLogger(__name__)


def dummy_subs(*lead: int) -> np.ndarray:
    """Placeholder key words (*lead, 2) for channels that take none (never
    consumed): zeros of `async_fl.compute.no_subs`'s dtype."""
    return np.zeros(tuple(lead) + (2,), np.uint32)


def uplink_keys(subs: np.ndarray, width: int, n_leaves: int) -> np.ndarray:
    """Every sender's per-leaf keys of per-message uplinks keyed by `subs`
    (..., 2): slot i of `width` is keyed `fold_in(sub, i)` and split per
    leaf.  Returns (..., width, n_leaves, 2) uint32."""
    subs = np.asarray(subs, np.uint32)
    slots = np.broadcast_to(np.arange(width, dtype=np.uint32), subs.shape[:-1] + (width,))
    return message_leaf_keys(subs, slots, n_leaves)


def compress_uplinks(channel: Channel, deltas: Tree, sub, slots: np.ndarray | None = None) -> Tree:
    """Compress a stacked uplink (leading sender axis on every leaf).

    Per-message channels key each sender with `fold_in(sub, slot)`, as the
    reference does, so a sender's key does not depend on how many senders
    the uplink carries.  `sub` may also hold one key per group of equally
    many consecutive senders (G, 2), the clusters of a flattened client
    grid.  `slots` gives each sender's slot id, (G, senders per group) or
    (senders,) with one key; by default sender i of a group is slot i.  The
    microbatched rounds pass the global slots of a client group, so client
    i's message is keyed alike whatever the group width.  `sub` may instead
    be the senders' per-leaf keys already derived, an int32 tensor
    (senders, leaves, 2) on the deltas' device (`uplink_keys`); then
    `slots` is not read.  A key-free channel (Sign-SGD, Top-K) gets the
    sender axis as its `lead`.  Dense transforms the stack directly."""
    if not channel.per_message:
        return channel.compress(deltas, sub)
    leaves = tree_leaves(deltas)
    n = leaves[0].shape[0]
    if not channel.stochastic:
        return channel.compress(deltas, lead=(n,))
    if not isinstance(sub, torch.Tensor):
        groups = np.reshape(np.asarray(sub, np.uint32), (-1, 2))
        if slots is None:
            slots = np.tile(np.arange(n // len(groups)), (len(groups), 1))
        slots = np.reshape(slots, (len(groups), -1))
        keys = message_leaf_keys(groups, slots, len(leaves)).reshape(n, len(leaves), 2)
        sub = key_words(keys, leaves[0].device)
    return channel.compress(deltas, sub)


def _as_device(x, device, dtype=torch.float32) -> torch.Tensor:
    """A round input as a tensor on `device`: a tensor passes unchanged, a
    host array is moved once."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


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


def _same_dtypes(old: Tree, new: Tree) -> None:
    """A round hands the client-held optimizer state back in the dtypes it
    took, as the reference's scan carry must; a state the round promotes
    (made in a policy's compute dtype, stepped in the master dtype) raises
    the TypeError the reference's scan raises."""
    for a, b in zip(tree_leaves(old), tree_leaves(new)):
        if a.dtype != b.dtype:
            raise TypeError(
                "scan body function carry input and carry output must have equal types: "
                f"an optimizer state leaf of {a.dtype} comes back as {b.dtype} (a federation "
                "mesh runs the round without the Precision policy's compute casts, as the "
                "reference's sharded bodies do)")


class _Whole:
    """The slot axis of a round on one device: every sender trains here and
    every reduction sees the stack as it is (the split of a federation mesh
    is `repro_torch.sharding.fed.Split`)."""

    def window(self, a, dim=0):
        return a

    def true(self, a, dim=0):
        return a

    def gather(self, tree, dim=0):
        return tree


_WHOLE = _Whole()


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
    back f32, which its scan carry refuses.

    `client_split` and `cluster_split` lay a round's client and cluster
    axes over a federation mesh (`repro_torch.sharding.fed.Split`): the
    round takes gammas, mask and ES weights whole, trains this rank's
    window of the senders (batch, optimizer rows and keys come windowed),
    and gathers every rank's compressed deltas and losses, cut to the true
    width, before each reduction.  None is the whole axis on one device."""

    model: Any
    channel: Channel = DenseChannel()
    es_channel: Channel | None = None
    local_opt: Any = None
    client_microbatch: int | None = None
    precision: Precision | None = None
    client_split: Any = None
    cluster_split: Any = None

    def __post_init__(self):
        object.__setattr__(self, "model", as_fed_model(self.model))
        if self.local_opt is None:
            object.__setattr__(self, "local_opt", PlainSGD())
        if self.client_microbatch is not None and self.client_microbatch < 1:
            raise ValueError(f"client_microbatch must be >= 1, got {self.client_microbatch}")
        if self.client_microbatch is not None and (self.client_split or self.cluster_split):
            raise ValueError("client_microbatch is unsupported on a federation mesh")
        if self.precision is not None and isinstance(self.local_opt, AdamWOpt):
            raise TypeError(
                "AdamWOpt under a Precision policy: its compute-dtype moments come back "
                "in the master dtype, and the reference's round refuses the promoted "
                "carry with a TypeError; use MomentumSGD or PlainSGD, or no policy")

    @property
    def _clients(self):
        return self.client_split or _WHOLE

    @property
    def _clusters(self):
        return self.cluster_split or _WHOLE

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

    def key_width(self, n: int) -> int:
        """The slots a round of n senders per group keys: n padded to whole
        client groups of `client_microbatch`."""
        mb = self.client_microbatch or n
        return n + (-n) % mb

    def step_sizes(self, lrs, device) -> torch.Tensor:
        """A round's step sizes as a tensor on `device` in the compute dtype
        (a tensor is taken as it is).  A step with the rounded value equals
        one with the Python float of it, as the reference's cast of its lr
        array does."""
        if isinstance(lrs, torch.Tensor):
            return lrs
        lrs = torch.as_tensor(np.asarray(lrs, np.float32), device=device)
        return compute_cast(lrs, self.precision)

    def _uplink_keys(self, subs, width: int, n_leaves: int, device):
        """The round's uplink keys as a device tensor (..., width, leaves,
        2): derived from key words (..., 2) on the host, or already so."""
        if subs is None or isinstance(subs, torch.Tensor):
            return subs
        if not (self.channel.stochastic and self.channel.per_message):
            return None
        return key_words(uplink_keys(subs, width, n_leaves), device)

    def _no_microbatch_taps(self) -> None:
        if self.client_microbatch is not None:
            raise ValueError("telemetry taps are unsupported with client_microbatch")

    def grad_round(self, params, batch, gammas, lrs, *, taps=False):
        """batch leaves (K, n, B, ...), gammas (n,), lrs (K,).
        Returns (params, per-step gamma-weighted losses (K,)); with `taps`
        also the grad-mode tele dict."""
        device = tree_leaves(batch)[0].device
        gammas = self._clients.true(_as_device(gammas, device))
        gather = None if self.client_split is None else self.client_split.gather
        with named_scope("local_train"):
            new_params, losses = grad_phase(self.model, self.client_microbatch, gather)(
                params, batch, gammas, _as_device(lrs, device))
        if taps:
            return new_params, losses, grad_taps(params, new_params, gammas)
        return new_params, losses

    def _train_group(self, local, base, state, batch, lrs, mask, keys, keep_raw=False):
        """One group of senders: E local steps from `base` (compute dtype,
        leading sender axis), raw deltas zeroed where `mask` is 0 (None: no
        mask), compressed under the senders' per-leaf `keys` and cast up to
        master.  Masked slots keep their optimizer state.  Returns (deltas,
        state, losses (senders,), the raw deltas if `keep_raw` else None)."""
        with named_scope("local_train"):
            new_p, new_state, losses = local(base, state, batch, lrs)
        _same_dtypes(state, new_state)
        if mask is None:
            raw = tree_map(torch.sub, new_p, base)
        else:
            new_state = _freeze_masked(mask, new_state, state)
            raw = tree_map(
                lambda a, b: (a - b) * mask.to(a.dtype).reshape((-1,) + (1,) * (a.ndim - 1)),
                new_p, base)
        with named_scope("uplink"):
            deltas = compress_uplinks(self.channel, raw, keys)
        return master_cast(deltas, self.precision), new_state, losses, raw if keep_raw else None

    def cluster_round(self, params, batch, gammas, lrs, subs=None, opt_state=None,
                      mask=None, *, taps=False):
        """One delta-mode round.  batch leaves (J, n, E, B, ...), gammas (n,),
        lrs (J, E); subs, for a stochastic channel, the (J, 2) key words of
        the interactions or their senders' per-leaf keys as an int32 device
        tensor (J, key_width(n), leaves, 2) (`uplink_keys`).
        `mask` (n,) is the optional per-client participation mask: masked-out
        clients upload a zero delta (zeroed before compression, keyed by
        their slot all the same), keep their optimizer state frozen and
        leave the loss average; `gammas` must already be renormalized over
        the participants.  With `mask=None` the round is the unmasked
        computation.  On a `client_split` the batch, `subs` and `opt_state`
        hold this rank's window of the n slots, gammas and mask all of
        them.  Returns (params, opt_state, per-interaction mean losses
        (J,)); with `taps` also the tele dict of the last interaction."""
        if taps:
            self._no_microbatch_taps()
        first = tree_leaves(batch)[0]
        J, n = first.shape[:2]  # the senders trained here
        device = first.device
        if opt_state is None:
            opt_state = self.init_opt_state(params, n)
        split = self._clients
        gammas = split.true(_as_device(gammas, device))
        mask_here = None
        if mask is not None:
            mask = _as_device(mask, device)
            mask_here, mask = split.window(mask), split.true(mask)
        lrs = self.step_sizes(lrs, device)
        keys = self._uplink_keys(subs, self.key_width(n), len(tree_leaves(params)), device)
        local = local_opt_steps(self.model, self.local_opt)
        losses = []
        for j in range(J):
            params, opt_state, client_losses, tele = self._cluster_step(
                local, params, opt_state, tree_map(lambda a: a[j], batch), gammas, mask_here,
                lrs[j], None if keys is None else keys[j], tap=taps and j == J - 1)
            if mask is None:
                losses.append(client_losses.mean())
            else:
                losses.append((client_losses * mask).sum() / torch.clamp(mask.sum(), min=1.0))
        if taps:
            return params, opt_state, torch.stack(losses), tele
        return params, opt_state, torch.stack(losses)

    def _cluster_step(self, local, params, state, batch, gammas, mask, lrs, keys, tap=False):
        """One interaction of one cluster: params and batch cast to the
        compute dtype, then the clients in groups of `client_microbatch`
        (all n in one group without it), each group's gamma-weighted deltas
        summed into the update, which is added to the master-dtype params.
        The tail group is padded with slot-0 replicas that carry zero gamma
        and a zero mask.  `keys` (key_width(n), leaves, 2): slot i's keys.
        `gammas` (n,) are every sender's; batch, state, mask and keys hold
        the senders trained here (on a `client_split`, this rank's window,
        one group whose deltas and losses the split gathers to all n).
        Returns (params, state, per-client losses (n,), the interaction's
        tele dict if `tap` (one group only) else None)."""
        n = gammas.shape[0]
        n_here = tree_leaves(batch)[0].shape[0]
        mb = self.client_microbatch or n_here
        pad = (-n_here) % mb
        if pad:
            mask = torch.ones_like(gammas) if mask is None else mask
            gammas, mask = _zero_pad(gammas, pad), _zero_pad(mask, pad)
            batch, state = _pad_slots(batch, 0, pad), _pad_slots(state, 0, pad)
        p_c = compute_cast(params, self.precision)
        batch = compute_cast(batch, self.precision)
        base = tree_map(lambda a: a.expand((mb,) + a.shape), p_c)
        acc, states, losses = None, [], []
        for g in range(0, n_here + pad, mb):
            group = lambda a, g=g: a[g:g + mb]  # noqa: E731
            deltas, s_g, l_g, raw = self._train_group(
                local, base, tree_map(group, state), tree_map(group, batch), lrs,
                None if mask is None else group(mask), None if keys is None else group(keys),
                keep_raw=tap)
            # the gammas of the senders in hand: the group's, or every
            # rank's once the split has gathered them
            with named_scope("intra_agg"):
                deltas, l_g = self._clients.gather((deltas, l_g))
                gam = gammas.narrow(0, g, l_g.shape[0])
                agg = tree_map(lambda d: torch.tensordot(gam.to(d.dtype), d, dims=1), deltas)
                acc = agg if acc is None else tree_add(acc, agg)
            states.append(s_g)
            losses.append(l_g)
        state = tree_map(lambda *parts: _cat(parts, 0)[:n_here], *states)
        new_params = tree_add(params, acc)
        tele = None
        if tap:
            tele = delta_taps(raw, tree_map(torch.sub, new_params, params), gammas, mask)
        return new_params, state, _cat(losses, 0)[:n], tele

    def multi_cluster_round(self, params, batch, gammas, mask, es_weights, lrs,
                            subs=None, es_subs=None, opt_state=None, *, taps=False):
        """One 3-tier HFL global round for all M clusters.

        batch leaves (J, M, n_max, E, B, ...); gammas, mask (M, n_max) and
        es_weights (M,); lrs (J, E); for stochastic channels subs (J, M, 2)
        and es_subs (M, 2) key words, or as device tensors the derived
        per-leaf keys: subs (J, M, key_width(n_max), leaves, 2) and es_subs
        (M, leaves, 2); opt_state leaves (M, n_max, ...).  Client slot i of
        cluster m is keyed `fold_in(subs[j, m], i)`; ES m is keyed
        `es_subs[m]` itself.  With `client_microbatch = mb` the interaction
        trains slots [g*mb, (g+1)*mb) of every cluster at once, M * mb
        senders per group.  Returns (params, opt_state, per-(interaction,
        cluster) losses (J, M)); with `taps` also the per-cluster (M,) tele
        dict of the last interaction, plus "es_comp_err" of the ES->PS hop.

        On a `cluster_split` and `client_split` the batch, keys and
        opt_state hold this rank's window of the (M, n_max) grid, gammas,
        mask and es_weights all of it; the in-cluster aggregate gathers over
        the client split, the ES->PS hop and the losses over the cluster
        split."""
        if taps:
            self._no_microbatch_taps()
        first = tree_leaves(batch)[0]
        J, M, n_max = first.shape[:3]  # the clusters and client slots trained here
        device = first.device
        n_leaves = len(tree_leaves(params))
        if opt_state is None:
            opt_state = self.init_opt_state(params, M, n_max)
        clusters, clients = self._clusters, self._clients
        es_weights = clusters.true(_as_device(es_weights, device))
        gammas = clusters.window(_as_device(gammas, device))
        mask = clusters.window(_as_device(mask, device))
        mask_here = clients.window(mask, 1)
        gammas, mask = clients.true(gammas, 1), clients.true(mask, 1)
        n_all = gammas.shape[1]
        mb = self.client_microbatch or n_max
        pad = (-n_max) % mb
        width = n_max + pad
        keys = self._uplink_keys(subs, width, n_leaves, device)
        gammas_p, mask_p = _zero_pad(gammas, pad), _zero_pad(mask_here, pad)
        batch = _pad_slots(batch, 2, pad)
        state = _pad_slots(opt_state, 1, pad)
        lrs = self.step_sizes(lrs, device)
        local = local_opt_steps(self.model, self.local_opt)
        cparams = tree_map(lambda a: a.expand((M,) + a.shape), params)
        losses, tele = [], None
        for j in range(J):
            tap = taps and j == J - 1
            cp_c = compute_cast(cparams, self.precision)
            b_j = compute_cast(tree_map(lambda a: a[j], batch), self.precision)
            base = tree_map(
                lambda a: a[:, None].expand((M, mb) + a.shape[1:]).reshape((M * mb,) + a.shape[1:]),
                cp_c)
            acc, states, client_losses = None, [], []
            for g in range(0, width, mb):
                cols = lambda a, g=g: a[:, g:g + mb]  # noqa: E731
                grid = lambda a: a.reshape((M * mb,) + a.shape[2:])  # noqa: E731
                deltas, s_g, l_g, raw = self._train_group(
                    local, base, tree_map(lambda a: grid(cols(a)), state),
                    tree_map(lambda a: grid(cols(a)), b_j), lrs[j], grid(cols(mask_p)),
                    None if keys is None else grid(cols(keys[j])), keep_raw=tap)
                with named_scope("intra_agg"):
                    deltas, l_g = clients.gather(
                        (tree_map(lambda d: d.reshape((M, mb) + d.shape[1:]), deltas),
                         l_g.reshape(M, mb)), 1)
                    gam = gammas_p.narrow(1, g, l_g.shape[1])  # as in `_cluster_step`
                    agg = tree_map(lambda d: torch.einsum("mn,mn...->m...", gam.to(d.dtype), d),
                                   deltas)
                    acc = agg if acc is None else tree_add(acc, agg)
                states.append(tree_map(lambda a: a.reshape((M, mb) + a.shape[1:]), s_g))
                client_losses.append(l_g)
            if tap:  # one group: raw leaves (M * n_max, ...)
                new_cp = tree_add(cparams, acc)
                raw = tree_map(lambda a: a.reshape((M, n_max) + a.shape[1:]), raw)
                applied = tree_map(torch.sub, new_cp, cparams)
                tele = stack_taps([
                    delta_taps(tree_map(lambda a, m=m: a[m], raw),
                               tree_map(lambda a, m=m: a[m], applied), gammas[m], mask[m])
                    for m in range(M)])
                del raw, applied
                cparams = new_cp
            else:
                cparams = tree_add(cparams, acc)
            state = tree_map(lambda *parts: _cat(parts, 1), *states)
            client_losses = _cat(client_losses, 1)[:, :n_all]
            losses.append((client_losses * mask).sum(dim=1)
                          / torch.clamp(mask.sum(dim=1), min=1.0))

        # ES -> PS: each ES's compressed cluster delta, keyed es_subs[m]
        # itself, in the master dtype
        es_channel = self.es_channel or self.channel
        raw_es = tree_map(lambda c, p: c - p[None], cparams, params)
        es_keys = None
        if es_channel.stochastic:
            es_keys = (es_subs if isinstance(es_subs, torch.Tensor)
                       else key_words(split_each(es_subs, n_leaves), device))
        es_deltas = compress_uplinks(es_channel, raw_es, es_keys)
        agg = tree_map(lambda d: torch.tensordot(es_weights, d, dims=1), clusters.gather(es_deltas))
        params = tree_add(params, agg)
        state = tree_map(lambda a: a[:, :n_max], state)
        losses = clusters.gather(torch.stack(losses), 1)
        if taps:
            tele["es_comp_err"] = tree_client_norms(tree_map(torch.sub, es_deltas, raw_es))
            return params, state, losses, tele
        return params, state, losses

    def end_round(self, ledger: CommLedger, round_idx: int) -> None:
        """Uniform end-of-round bookkeeping: snapshot the ledger."""
        ledger.snapshot(round_idx)


# --------------------------------------------------------------------------
# whole-run execution: chunks of staged rounds, a captured round on the card
# --------------------------------------------------------------------------
#
# The looped drivers pay per-round host costs: staging a round's batches,
# deriving its keys, copying them to the card, and dispatching every
# operation of the round from Python.  A scanned run moves the schedule to
# the host before the run (visit order, participation masks, key words) and
# stages a chunk of rounds at once; the chunk goes to the card in one copy.
# On the card one round of the body is captured in a CUDA graph and every
# later round replays it: the round's inputs are copied device to device
# into the graph's static inputs, and the replay updates the carry (params,
# optimizer states) in place.  Between eval points the host enqueues copies
# and replays only, and reads nothing back.  Communication accounting is
# deferred to `CommLedger.materialize` after the run.
#
# Rounds in which nothing trains (an all-dark cluster, a zero-reporter
# FedAvg round, a pass-through walk visit) are skipped: the run goes over
# the trained rounds only, so they consume neither data draws nor keys,
# exactly as in the looped drivers.  The bodies call the same `RoundEngine`
# rounds the looped drivers call, so a scanned run's params equal the
# looped run's bit for bit.


@functools.cache
def scan_grad_body(model, microbatch: int | None = None, taps: bool = False,
                   client_split=None):
    """Whole-run body, Eq. (5) grad mode.  carry: params.  x: {"batch":
    (K, n_max, B, ...), "gammas": (n_max,), "lrs": (K,)} (padded client
    slots carry zero gamma; the step sizes are staged per round so a
    decaying schedule can follow the global round, e.g. WRWGD's walk).
    Returns the per-step gamma-weighted losses (K,); with `taps` the
    outputs are (losses, tele).  The splits of every body are
    `RoundEngine`'s (a federation mesh's, `sharding.fed.shard_plan`)."""
    engine = RoundEngine(model, client_microbatch=microbatch, client_split=client_split)

    def body(params, x, consts):
        del consts
        params, *ys = engine.grad_round(params, x["batch"], x["gammas"], x["lrs"], taps=taps)
        return params, tuple(ys) if taps else ys[0]

    return body


@functools.cache
def scan_delta_body(model, channel: Channel, opt, microbatch: int | None = None,
                    precision: Precision | None = None, taps: bool = False,
                    client_split=None):
    """Whole-run body, delta mode over one fixed client set (FedAvg).
    carry: (params, opt_state (n, ...)).  x: {"batch": (J, n, E, B, ...),
    "gammas"/"mask": (n,), "keys": (J, key_width(n), leaves, 2) int32 (a
    stochastic channel)}.  consts: {"lrs": (J, E)}.  Returns per-interaction
    masked mean losses (J,); with `taps` the outputs are (losses, tele)."""
    engine = RoundEngine(model, channel, local_opt=opt, client_microbatch=microbatch,
                         precision=precision, client_split=client_split)
    if taps:
        engine._no_microbatch_taps()

    def body(carry, x, consts):
        params, opt_state = carry
        params, opt_state, *ys = engine.cluster_round(
            params, x["batch"], x["gammas"], consts["lrs"], x.get("keys"), opt_state,
            mask=x["mask"], taps=taps)
        return (params, opt_state), tuple(ys) if taps else ys[0]

    return body


@functools.cache
def scan_cluster_delta_body(model, channel: Channel, opt, microbatch: int | None = None,
                            precision: Precision | None = None, taps: bool = False,
                            client_split=None):
    """Whole-run body, delta mode with a per-round active cluster (Fed-CHS).
    carry: (params, opt_states (M, n_max, ...)): the active cluster's rows
    are gathered with `index_select` and written back with `index_copy_` at
    the staged device index x["m"], so the round never reads the cluster id
    on the host.  x adds "m": () int32 to the `scan_delta_body` inputs (all
    padded to n_max).  With `taps` the outputs are (losses, tele)."""
    engine = RoundEngine(model, channel, local_opt=opt, client_microbatch=microbatch,
                         precision=precision, client_split=client_split)
    if taps:
        engine._no_microbatch_taps()

    def body(carry, x, consts):
        params, opt_all = carry
        m = x["m"].reshape(1).long()
        s_m = tree_map(lambda leaf: leaf.index_select(0, m)[0], opt_all)
        params, new_s, *ys = engine.cluster_round(
            params, x["batch"], x["gammas"], consts["lrs"], x.get("keys"), s_m,
            mask=x["mask"], taps=taps)
        for leaf, ns in zip(tree_leaves(opt_all), tree_leaves(new_s)):
            leaf.index_copy_(0, m, ns[None])
        return (params, opt_all), tuple(ys) if taps else ys[0]

    return body


@functools.cache
def scan_multi_body(model, channel: Channel, es_channel: Channel, opt,
                    microbatch: int | None = None, precision: Precision | None = None,
                    taps: bool = False, client_split=None, cluster_split=None):
    """Whole-run body, 3-tier HFL global rounds (Hier-Local-QSGD).
    carry: (params, opt_state (M, n_max, ...)).  x: {"batch": (J, M, n_max,
    E, B, ...), "gammas"/"mask": (M, n_max), "es_weights": (M,), "keys":
    (J, M, key_width(n_max), leaves, 2), "es_keys": (M, leaves, 2)}.
    Returns losses (J, M); with `taps` the outputs are (losses, tele), tele
    leaves (M,)."""
    engine = RoundEngine(model, channel, es_channel, local_opt=opt,
                         client_microbatch=microbatch, precision=precision,
                         client_split=client_split, cluster_split=cluster_split)
    if taps:
        engine._no_microbatch_taps()

    def body(carry, x, consts):
        params, opt_state = carry
        params, opt_state, *ys = engine.multi_cluster_round(
            params, x["batch"], x["gammas"], x["mask"], x["es_weights"], consts["lrs"],
            x.get("keys"), x.get("es_keys"), opt_state, taps=taps)
        return (params, opt_state), tuple(ys) if taps else ys[0]

    return body


@functools.cache
def _lanes_body(body):
    """A sweep's round: `body` on every seed's lane in turn (carry: a tuple
    of lane carries; x leaves (lanes, ...)).  Losses stacked (lanes, ...)."""

    def run(carry, x, consts):
        outs = [body(c, tree_map(lambda a, i=i: a[i], x), consts) for i, c in enumerate(carry)]
        return tuple(o[0] for o in outs), torch.stack([o[1] for o in outs])

    return run


def eval_rounds(rounds: int, eval_every: int) -> list[int]:
    """The rounds every driver logs at: t % eval_every == 0, plus the final
    round — the exact looped-driver cadence."""
    ev = [t for t in range(rounds) if t % eval_every == 0]
    if rounds - 1 not in ev:
        ev.append(rounds - 1)
    return ev


@dataclasses.dataclass
class ScanPlan:
    """A precomputed whole-run schedule for `run_scan`.

    `trained` marks the rounds that actually train (all of them under full
    participation); the run goes over those only.  `stage(idxs)` returns the
    per-round inputs stacked (numpy leaves, leading axis len(idxs)) for the
    given ascending *global* round indices: the only host work left in the
    loop.  `carry` (tensors on the run's device) is advanced in place.

    `obs` is the run's `RunTelemetry` (or None): the executor opens its
    "stage" and "scan_chunk" spans, and when its taps are on, `body` must be
    the tapped variant (outputs (losses, tele)); the plan builders pair
    them.

    `chunk_fn(carry, xs, consts) -> (carry, losses)` runs a chunk of
    rounds on inputs that `xs_put(staged)` has put on the device, and
    returns the last round's losses: a plan that sets them runs them,
    eagerly, in place of the executor over `body`.  The federation mesh
    (`repro_torch.sharding.fed.shard_plan`) installs its sharded chunk and
    its per-rank put here, so `run_scan` never branches on sharding."""

    body: Any                 # a scan_*_body: (carry, x, consts) -> (carry, losses)
    carry: Any
    consts: Any
    stage: Any                # (np.ndarray of round idxs) -> xs tree
    trained: Any              # (rounds,) bool numpy array
    rounds: int
    eval_every: int
    chunk_rounds: int = 32
    obs: Any = None           # repro_torch.obs.RunTelemetry | None
    chunk_fn: Any = None      # (carry, xs, consts) -> (carry, losses), or None
    xs_put: Any = None        # staged xs -> device xs for `chunk_fn`


def run_scan(plan: ScanPlan, record) -> Any:
    """Execute a whole run as chunks of its trained rounds.

    Chunks are cut at eval rounds (and at `chunk_rounds` to bound the
    staged inputs), so between eval points the only host<->device traffic
    is each chunk's one copy of its staged inputs.  `record(t, carry,
    losses, t_l)` fires at every eval round t with the carry after round t,
    the last trained round's on-device losses (None if nothing trained yet),
    and that round's global index t_l.  Returns the final carry.

    On the card one capture serves every chunk length, and the graph and
    its memory pool are freed when the run returns or raises."""
    assert plan.chunk_rounds >= 1
    return _run_chunks(plan.body, plan.carry, plan.stage, plan, record)


def run_scan_sweep(plans: list[ScanPlan], record, *, mesh=None) -> Any:
    """Run several same-config, different-seed `ScanPlan`s as one run whose
    round advances every seed's lane in turn (one captured graph, one
    replay per round for all seeds).  All plans must share body, consts and
    trained schedule; each lane computes exactly its solo run, bit for bit.
    `record(t, carry, losses, t_l)` sees the tuple of lane carries and
    losses stacked (lanes, ...).  Returns the final tuple of lane carries.

    `mesh` (a `launch.mesh.FederationMesh`) splits the seed lanes over its
    ranks: each rank runs one contiguous block of them with the executor
    it would use alone, and at every eval round the blocks' carries and
    losses are all-gathered in seed order, so `record` and the return see
    every lane on every rank.  A sweep whose lanes the mesh does not divide
    logs the reference's warning and runs unsharded."""
    p0 = plans[0]
    assert p0.obs is None, "telemetry is unsupported in sweeps"
    assert all(p.body is p0.body for p in plans), "sweep plans must share a body"
    assert all(np.array_equal(np.asarray(p.trained), np.asarray(p0.trained)) for p in plans), \
        "sweep plans must share the trained-round schedule (full participation)"
    assert p0.chunk_fn is None, \
        "mesh-sharded plans (sharding.fed.shard_plan) cannot be swept: the client axes " \
        "are already mapped to ranks; shard the seed axis with run_scan_sweep(mesh=...)"
    if mesh is not None and len(plans) % mesh.size != 0:
        _log.warning("sweep of %d seeds does not divide mesh of %d devices — running "
                     "unsharded", len(plans), mesh.size)
        mesh = None
    if mesh is not None and mesh.size > 1:
        per = len(plans) // mesh.size
        lo = mesh.rank * per
        mine = plans[lo:lo + per]
        gather = mesh.gather_lanes

        def record_gathered(t, carry, losses, t_l):
            record(t, gather(carry), None if losses is None else gather(losses, stacked=True), t_l)

        return gather(_run_lanes(mine, record_gathered))
    return _run_lanes(plans, record)


def _run_lanes(plans: list[ScanPlan], record) -> Any:
    carry = tuple(p.carry for p in plans)

    def stage(idxs):
        return tree_map(lambda *ls: np.stack(ls, axis=1), *[p.stage(idxs) for p in plans])

    return _run_chunks(_lanes_body(plans[0].body), carry, stage, plans[0], record)


def _run_chunks(body, carry, stage, plan: ScanPlan, record) -> Any:
    """The chunked loop behind `run_scan`/`run_scan_sweep`: segment the
    trained rounds at eval boundaries (capped at `chunk_rounds`), stage and
    run each chunk, keep the last trained round's losses, hand a tapped
    chunk's stacked tele to `plan.obs`, and fire `record` at every eval
    round."""
    obs = plan.obs
    tapped = obs is not None and obs.taps
    device = tree_leaves(carry)[0].device
    if plan.chunk_fn is not None:
        rounds = _ChunkRounds(plan.chunk_fn, plan.xs_put, carry, plan.consts)
    else:
        rounds = (_GraphRounds if device.type == "cuda" else _EagerRounds)(
            body, carry, plan.consts, device, tapped)
    trained_idx = np.flatnonzero(np.asarray(plan.trained))
    last_losses, last_t, pos = None, None, 0
    try:
        for t_e in eval_rounds(plan.rounds, plan.eval_every):
            n_t = int(np.searchsorted(trained_idx, t_e, side="right"))
            while pos < n_t:
                take = min(plan.chunk_rounds, n_t - pos)
                idxs = trained_idx[pos:pos + take]
                with maybe_span(obs, "stage"):
                    xs = stage(idxs)
                with maybe_span(obs, "scan_chunk"):
                    last_losses = rounds.run(xs)
                    if tapped:
                        # by default the recorder keeps the device tensors
                        # (no wait on the card here); obs.sync_chunks copies
                        # them now, inside the span
                        obs.record_stacked(idxs.tolist(), rounds.tele)
                last_t = int(idxs[-1])
                pos += take
            record(t_e, rounds.carry, last_losses, last_t)
        return rounds.carry
    finally:
        rounds.close()


_ALIGN = 256  # byte alignment of every input inside a staged round


class _Layout:
    """How one round's staged inputs lie in one byte row: every leaf at an
    offset aligned to `_ALIGN`.  A chunk is a (rounds, row bytes) array, so
    it moves to the card in one copy and each round's inputs in another."""

    def __init__(self, xs):
        leaves, self.treedef = tree_flatten(xs)
        self.specs, off = [], 0
        for a in leaves:
            a = _device_view(a)
            nbytes = a[0].nbytes
            self.specs.append((off, nbytes, a.shape[1:], a.dtype,
                               torch.from_numpy(a[:0]).dtype))
            off += -(-nbytes // _ALIGN) * _ALIGN
        self.row_bytes = max(off, _ALIGN)

    def pack(self, xs) -> np.ndarray:
        leaves, _ = tree_flatten(xs)
        rows = len(leaves[0])
        packed = np.empty((rows, self.row_bytes), np.uint8)
        for a, (off, nbytes, shape, dtype, _) in zip(leaves, self.specs):
            a = _device_view(a)
            if a.shape[1:] != shape or a.dtype != dtype:
                raise ValueError(f"staged input {a.dtype}{a.shape[1:]} differs from the "
                                 f"first chunk's {dtype}{shape}")
            packed[:, off:off + nbytes] = np.ascontiguousarray(a).reshape(rows, -1).view(np.uint8)
        return packed

    def views(self, row: torch.Tensor):
        """One round's inputs as views into its byte row."""
        out = [row[off:off + nbytes].view(tdtype).reshape(shape)
               for off, nbytes, shape, _, tdtype in self.specs]
        return tree_unflatten(self.treedef, out)


def _device_view(a: np.ndarray) -> np.ndarray:
    """uint32 key words travel as int32 of the same bits (torch has no
    general uint32)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assign(carry, new) -> None:
    """Write a round's new carry into the carry's tensors in place."""
    old, fresh = tree_leaves(carry), tree_leaves(new)
    if len(old) != len(fresh):
        raise ValueError("a scan body changed the structure of its carry")
    for o, f in zip(old, fresh):
        if f is not o:
            o.copy_(f)


def _stack_tele(teles: list[dict]) -> dict:
    """Per-round tele dicts stacked along a leading round axis."""
    return {k: torch.stack([t[k] for t in teles]) for k in teles[0]}


class _EagerRounds:
    """The CPU's executor: every round of a chunk runs eagerly on views of
    the chunk's staged rows.  `run(xs)` returns the last round's losses; a
    `tapped` body's outputs are (losses, tele), and the chunk's tele,
    stacked per round, is left in `tele`."""

    def __init__(self, body, carry, consts, device, tapped=False):
        self.body, self.carry, self.consts, self.device = body, carry, consts, device
        self.tapped = tapped
        self.layout = self.tele = None

    def run(self, xs):
        if self.layout is None:
            self.layout = _Layout(xs)
        rows = torch.from_numpy(self.layout.pack(xs)).to(self.device)
        teles = []
        for c in range(len(rows)):
            new, ys = self.body(self.carry, self.layout.views(rows[c]), self.consts)
            _assign(self.carry, new)
            losses = ys
            if self.tapped:
                losses, tele = ys
                teles.append(tele)
        self.tele = _stack_tele(teles) if self.tapped else None
        return losses

    def close(self) -> None:
        _set_stats("eager")


class _ChunkRounds:
    """A plan's own chunk (`ScanPlan.chunk_fn`), run eagerly on the plan's
    device: each chunk's staged inputs go through `xs_put`, then
    `chunk_fn` advances the carry over the chunk's rounds.  The federation
    mesh runs here: its rounds all-gather over the host (gloo), which a
    CUDA graph cannot capture."""

    def __init__(self, chunk_fn, xs_put, carry, consts):
        self.chunk_fn, self.xs_put, self.carry, self.consts = chunk_fn, xs_put, carry, consts
        self.tele = None

    def run(self, xs):
        new, losses = self.chunk_fn(self.carry, self.xs_put(xs), self.consts)
        _assign(self.carry, new)
        return losses

    def close(self) -> None:
        _set_stats("chunk_fn")


# graphs held by scans that are running (a finished scan leaves none), and
# the stats of the last scan that ran: "executor" ("graph", "eager" or
# "chunk_fn", the plan's own chunk) and, on the card, the warm-up, capture
# and replays of `_GraphRounds.stats`
LIVE_GRAPHS: list = []
LAST_STATS: dict = {}
_SIDE_STREAMS: dict = {}


def _set_stats(executor: str, **stats) -> None:
    LAST_STATS.clear()
    LAST_STATS.update({"executor": executor, "warmup_s": 0.0, "capture_s": 0.0, "replays": 0,
                       **stats})


def _side_stream(device) -> torch.cuda.Stream:
    """One warm-up and capture stream per card for every run: cuBLAS keeps a
    workspace per stream it has seen, so a new stream per run would add
    one per run."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _GraphRounds:
    """The card's executor: one captured round, replayed.

    The run's first trained round runs eagerly, as the warm-up capture
    needs (cuBLAS handles, kernel libraries, the allocator's blocks), and is
    a real round of the run; it runs on the current stream, so it reuses the
    blocks the allocator caches there.  The capture stream, a side stream,
    gets its per-stream library state (the cuBLAS workspace) from a small
    product run on it first.  Then one round of the body is captured in a
    `torch.cuda.CUDAGraph` on that stream: its inputs are views into one
    static byte row, and it ends by copying the new carry into the carry's
    own tensors.  Each chunk's staged rows go to the card in one
    non-blocking copy from pinned memory (the caching host allocator hands
    a pinned block out again only after the copy that read it has
    finished), and each round is one device-to-device copy into the static
    row and a replay, under `set_sync_debug_mode("error")`: no host sync
    between eval points.  A replay does not call the kernel wrappers, so
    the counts of the launches the capture holds are added to
    `build.LAUNCHES` per replay.  Capture or replay errors raise; nothing
    falls back to eager rounds.  `stats` holds the host seconds of the
    warm-up round and of the capture, and the number of replays.

    A `tapped` body's captured tele tensors are static too: the next replay
    overwrites them.  So each chunk gets its own device buffer of tele rows,
    and after every replay the static tele is copied device to device into
    that replay's row (the eager warm-up round's tele into its row too),
    left in `tele`; a recorder that keeps the buffer lazily reads every
    round's own tele."""

    def __init__(self, body, carry, consts, device, tapped=False):
        self.body, self.carry, self.consts, self.device = body, carry, consts, device
        self.tapped = tapped
        self.layout = self.tele = None
        self.graph = self.static = self.static_losses = self.static_tele = None
        self.warm = False
        self.launches: dict[str, int] = {}
        self.stream = _side_stream(device)
        self.stats = {"warmup_s": 0.0, "capture_s": 0.0, "replays": 0}

    def run(self, xs):
        if self.layout is None:
            self.layout = _Layout(xs)
        host = torch.from_numpy(self.layout.pack(xs)).pin_memory()
        rows = host.to(self.device, non_blocking=True)
        start, losses, warm_tele = 0, None, None
        if not self.warm:
            t0 = time.perf_counter()
            new, losses = self.body(self.carry, self.layout.views(rows[0]), self.consts)
            if self.tapped:
                losses, warm_tele = losses
            _assign(self.carry, new)
            torch.cuda.synchronize(self.device)  # once a run, before the capture
            self.stats["warmup_s"] = time.perf_counter() - t0
            self.warm, start = True, 1
        if start < len(rows) and self.graph is None:
            self._capture()
        tele = None
        if self.tapped:
            like = warm_tele if warm_tele is not None else self.static_tele
            tele = {k: torch.empty((len(rows),) + v.shape, dtype=v.dtype, device=self.device)
                    for k, v in like.items()}
            if warm_tele is not None:
                for k, v in warm_tele.items():
                    tele[k][0].copy_(v)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for c in range(start, len(rows)):
                self.static.copy_(rows[c])
                self.graph.replay()
                if tele is not None:
                    for k, v in self.static_tele.items():
                        tele[k][c].copy_(v)
                for name, n in self.launches.items():
                    LAUNCHES[name] += n
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        self.stats["replays"] += len(rows) - start
        self.tele = tele
        return losses if start == len(rows) else self.static_losses.clone()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # the side stream's cuBLAS workspace
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.ones((8, 8), dtype=dtype, device=self.device)
                torch.mm(a, a)
        torch.cuda.synchronize(self.device)
        self.static = torch.zeros((self.layout.row_bytes,), dtype=torch.uint8,
                                  device=self.device)
        x = self.layout.views(self.static)
        graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        try:
            with torch.cuda.graph(graph, stream=side):
                new, losses = self.body(self.carry, x, self.consts)
                _assign(self.carry, new)
            if self.tapped:
                losses, self.static_tele = losses
        finally:
            captured = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)  # nothing launched while capturing
        self.launches = {k: n for k, n in captured.items() if n}
        self.graph, self.static_losses = graph, losses
        LIVE_GRAPHS.append(graph)
        self.stats["capture_s"] = time.perf_counter() - t0

    def close(self) -> None:
        """Free the graph, its memory pool and the static inputs.  A run
        that captured nothing (one trained round) leaves the allocator's
        cache as eager rounds do."""
        _set_stats("graph", **self.stats)
        if self.graph is not None:
            LIVE_GRAPHS.remove(self.graph)
            self.graph.reset()
            self.graph = self.static = self.static_losses = self.static_tele = None
            torch.cuda.empty_cache()  # the pool's blocks go back to the card
