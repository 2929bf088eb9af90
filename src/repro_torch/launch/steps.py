"""Step builders for the launchers (port of the non-mesh half of
`repro/launch/steps.py`).

* ``make_train_round`` — one Fed-CHS round over C chains (one active-model
  copy per cluster), each chain's params stacked on a leading axis: every
  chain takes one SGD step on its cluster's batch, then the sequential
  ES -> ES pass rolls the chains by one (`variant="fedchs"`), or the
  star-shaped chain mean replaces it (`variant="hfl"`, the conventional
  HFL baseline).
* ``make_prefill_step`` — the forward over a whole prompt, next-token logits.
* ``make_decode_step`` — one new token against the caches.

The reference's ahead-of-time lowering for a production mesh
(`LoweringSpec`, `build_lowering`, `lower_spec`, `abstract_*`,
`apply_optimizations`) is XLA's; it is not ported, and waits for a model
mesh (`make_production_mesh`, `named_shardings`).
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_leaves, tree_map


def make_train_round(cfg: ArchConfig, *, variant: str = "fedchs", remat: bool = True):
    """(stacked_params (C, ...), batch {tokens (C, B, T), ...}, lr) ->
    (new stacked params, mean loss over the chains)."""
    if variant not in ("fedchs", "hfl"):
        raise ValueError(variant)

    def chain_loss(params, batch):
        return tf.loss_fn(cfg, params, batch, remat=remat)

    def round_fn(stacked_params, batch, lr: float):
        C = tree_leaves(stacked_params)[0].shape[0]
        if C == 1:
            # one chain: no vmap; the pass and the star mean are identities
            grads, loss = grad_and_value(chain_loss)(
                tree_map(lambda x: x[0], stacked_params), tree_map(lambda x: x[0], batch))
            return tf.sgd_update(stacked_params, tree_map(lambda g: g[None], grads), lr), loss
        grads, losses = vmap(grad_and_value(chain_loss))(stacked_params, batch)
        new = tf.sgd_update(stacked_params, grads, lr)
        if variant == "fedchs":
            # sequential ES -> ES pass: chain c moves to cluster (c + 1) % C
            passed = tree_map(lambda x: torch.roll(x, 1, dims=0), new)
        else:
            # star aggregation at the PS: the chain mean, broadcast back
            passed = tree_map(lambda x: x.mean(dim=0, keepdim=True).expand_as(x).clone(), new)
        return passed, losses.mean()

    return round_fn


def make_prefill_step(cfg: ArchConfig, *, last_only: bool = False):
    """(params, batch) -> next-token logits (B, V).  `last_only` slices the
    hidden state before the LM head instead of computing (B, T, V) logits
    and slicing after."""

    def prefill_fn(params, batch):
        logits, _ = tf.forward(cfg, params, batch, last_only=last_only)
        return logits[:, -1]

    return prefill_fn


def make_decode_step(cfg: ArchConfig):
    """(params, caches, token (B, 1)) -> (logits (B, V), new caches)."""

    def decode_fn(params, caches, token):
        return tf.decode_step(cfg, params, caches, token)

    return decode_fn
