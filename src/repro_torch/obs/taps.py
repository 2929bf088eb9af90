"""Telemetry taps: training-health reductions over a round's tensors (port
of `repro/obs/taps.py`).

The taps run inside the round (and inside a captured CUDA graph on the
card), so they read tensors the round already holds and never write into
one: no in-place op, no tensor the parameter or optimizer path reads later.
A tapped round's training outputs are therefore bit-equal to the untapped
round's.

Every tap returns a dict of f32 scalars (or (M,) per-cluster vectors in
multi-cluster mode) with keys

  update_norm — mean per-client L2 norm of the local update Δ_n
  drift       — client-drift dispersion, mean_n ‖Δ_n − Δ̄‖, where Δ̄ is the
                round's applied per-unit-weight aggregate A / Σγ
  comp_err    — L2 error the uplink channel puts into the applied
                aggregate, ‖A − Σ_n γ_n Δ_n‖ (a float residual for a dense
                channel)
  mass        — the number of clients whose aggregation weight is nonzero
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils import tree_leaves

Tree = Any


def tree_sq_norms(tree: Tree) -> torch.Tensor:
    """Per-client squared L2 norms: leaves have a leading client axis N."""
    return sum(torch.sum(torch.reshape(x.float() ** 2, (x.shape[0], -1)), dim=1)
               for x in tree_leaves(tree))


def tree_client_norms(tree: Tree) -> torch.Tensor:
    """Per-client L2 norms over a stacked update tree -> (N,)."""
    return torch.sqrt(tree_sq_norms(tree))


def _flat_clients(tree: Tree) -> list[torch.Tensor]:
    """Leaves as f32 (n, d_leaf) matrices (leading client axis kept)."""
    return [torch.reshape(x.float(), (x.shape[0], -1)) for x in tree_leaves(tree)]


def delta_taps(raw: Tree, applied: Tree, gammas: torch.Tensor,
               mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Taps of a delta-mode interaction: the raw per-client deltas Δ_n
    (leading client axis), the interaction's applied update A = new_params −
    params (param-shaped), and the aggregation weights γ_n (zero for
    non-participants).  `mask` (n,) leaves padded and dropped slots out of
    the means; their deltas are exact zeros already.

    The reference's formulas: drift through the expansion
    ‖Δ_n − A/Σγ‖² = ‖Δ_n‖² − 2⟨Δ_n, A⟩/Σγ + ‖A‖²/Σγ², with the inner products
    as `nd,d->n` contractions (no centred copy of the deltas); comp_err as
    ‖A − R‖ with R = Σγ_n Δ_n, two d-sized vectors.  Masked slots get
    meaningless drift values (clamped at 0) but carry weight 0."""
    flat = _flat_clients(raw)
    sq = sum(torch.sum(m * m, dim=1) for m in flat)
    if mask is None:
        mask = torch.ones_like(sq)
    mask = mask.to(sq.dtype)
    w = mask / torch.clamp(torch.sum(mask), min=1.0)
    g = gammas.to(torch.float32)
    raw_agg = [torch.einsum("n,nd->d", g, m) for m in flat]
    agg_flat = [torch.reshape(a.float(), (-1,)) for a in tree_leaves(applied)]
    ip_agg = sum(torch.einsum("nd,d->n", m, a) for m, a in zip(flat, agg_flat))
    agg_sq = sum(torch.dot(a, a) for a in agg_flat)
    denom = torch.clamp(torch.sum(g), min=torch.finfo(torch.float32).tiny)
    drift_sq = torch.clamp(sq - 2.0 * ip_agg / denom + agg_sq / (denom * denom), min=0.0)
    err_sq = sum(torch.sum((a - r) ** 2) for a, r in zip(agg_flat, raw_agg))
    return {
        "update_norm": torch.sum(torch.sqrt(sq) * w),
        "drift": torch.sum(torch.sqrt(drift_sq) * w),
        "comp_err": torch.sqrt(err_sq),
        "mass": torch.sum((g > 0).to(torch.float32)),
    }


def grad_taps(params: Tree, new_params: Tree, gammas: torch.Tensor) -> dict[str, torch.Tensor]:
    """Taps of a grad-mode round (one SGD step per iteration, dense wire):
    the update is the whole round's parameter motion; there is no
    per-client delta and no channel, so drift and comp_err are zero."""
    norm = torch.sqrt(sum(torch.sum((b.float() - a.float()) ** 2)
                          for a, b in zip(tree_leaves(params), tree_leaves(new_params))))
    zero = torch.zeros((), dtype=torch.float32, device=norm.device)
    return {
        "update_norm": norm,
        "drift": zero,
        "comp_err": zero.clone(),
        "mass": torch.sum((gammas > 0).to(torch.float32)),
    }


def stack_taps(per_cluster: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Per-cluster tap dicts stacked into (M,) vectors."""
    return {k: torch.stack([t[k] for t in per_cluster]) for k in per_cluster[0]}
