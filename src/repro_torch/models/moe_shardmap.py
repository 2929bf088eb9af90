"""The MoE interior on a model mesh with its collectives written out (port
of `repro/models/moe_shardmap.py`, which is a `jax.shard_map`).

Left to DTensor's sharding propagation, the expert-choice combine (a
scatter-add into every token) is not provably local, so it would gather
the whole activation over the mesh.  Written per rank, the layout is
explicit:

  * tokens stay on their `"data"` shard end to end: the gathers and the
    combine are local ops on the shard's (n_loc, d) block;
  * each `"model"` shard owns E / n_model experts and runs expert choice
    over its local tokens (shard-granular group-limited routing, the
    approximation `moe_groups` makes, at G = n_data instead of G = B);
  * the load-balance mean is summed over `"data"`; the (n_loc, d) partial
    outputs and the (n_loc,) gate mass are summed over `"model"`: the only
    collectives of the forward.

`moe_routed_shardmap` runs the interior through DTensor's `local_map` on
the mesh's `DeviceMesh` (each rank gets its local blocks), its
collectives functional all-reduces over the mesh's groups.  Their
backward is written out too (`common.Sum`, `common.SumGrad`): a sum over ranks passes
its cotangent through unchanged, and an input that every rank of an axis
holds whole gets its gradient summed over that axis, once, so the
gradients are the one-device run's.  The combine adds one expert at a
time, in expert order, as `ffn.moe_forward` does: a colliding float
scatter-add races on the card.

Semantics are the reference's: at mesh (1, 1) global expert choice
(`ffn.moe_forward`), at (n_data, n_model) group-limited expert choice with
one batch-row group per data shard when each shard holds one row.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (ContiguousGrad, Gather, ScaleGrad, Sum, SumGrad,
                                      SumScatter, activation)
from repro_torch.models.ffn import _expert_mlp, top_k


def shardmap_supported(cfg: ArchConfig, mesh, batch: int) -> bool:
    """The routed-expert interior needs a (data, model) mesh and divisible
    shards."""
    if mesh is None or "data" not in mesh.axis_names or "model" not in mesh.axis_names:
        return False
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    return cfg.num_experts > 0 and cfg.num_experts % n_model == 0 and batch % n_data == 0


def _interior(cfg: ArchConfig, xb, router, w_gate, w_in, w_out, *, groups, n_data: int,
              n_model: int, m_idx: int, d_idx: int = 0, capacity_factor: float,
              global_choice: bool = False):
    """One rank's routed experts: xb (B_loc, T, d) its tokens, w_* (E_loc,
    ...) its experts, `groups` the ("data", "model") process groups (None
    on one rank).  With `global_choice` the experts choose among every
    data shard's tokens (expert choice with one group, G = 1): the scores
    of this shard's experts and the tokens are gathered over data, this
    rank (index `d_idx` along data) runs its block of each expert's C
    slots (blocks differ by at most one slot where C does not divide over
    data), and the combine is summed over data onto each shard's own rows."""
    B_loc, T, d = xb.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    E_loc = w_gate.shape[0]
    n_loc = B_loc * T
    act = activation(cfg.act)
    data, model = groups
    xf = xb.reshape(n_loc, d)
    if model is not None:
        # inputs held whole along an axis whose ranks use them on their own
        # part: tokens over model (each shard its experts), the router over
        # both, the experts over data (each shard its tokens)
        xf = SumGrad.apply(xf, model)
        router = SumGrad.apply(router, model)
    if data is not None:
        router = SumGrad.apply(router, data)
        w_gate, w_in, w_out = (SumGrad.apply(w, data) for w in (w_gate, w_in, w_out))
    logits = xf.float() @ router.float()
    probs = torch.sigmoid(logits) if E > 32 else torch.softmax(logits, dim=-1)

    # load-balance aux: the global mean prob per expert (summed over data);
    # every model shard computes it, so its gradient counts once
    psum = (probs if model is None else ScaleGrad.apply(probs, 1.0 / n_model)).sum(dim=0)
    me = (psum if data is None else Sum.apply(psum, data)) / (n_loc * n_data)
    aux = E * torch.sum(me * me)

    # expert choice: this shard's E_loc experts pick their top-C tokens
    scores = probs[:, m_idx * E_loc:(m_idx + 1) * E_loc]  # (n_loc, E_loc)
    if global_choice and data is not None:
        scores, xf = Gather.apply(scores, data), Gather.apply(xf, data)
    n = xf.shape[0]
    cap = max(1, int(n * k * capacity_factor) // E)
    g, idx = top_k(scores.T, cap)  # (E_loc, C)
    # global choice: this data shard runs its block of each expert's C
    # slots, and the combine is summed over data onto the tokens' shards
    share = n != n_loc
    if share:
        lo, hi = d_idx * cap // n_data, (d_idx + 1) * cap // n_data
        g, idx = g[:, lo:hi], idx[:, lo:hi]
    c = idx.shape[1]
    xe = torch.stack([torch.gather(xf, 0, idx[e, :, None].expand(c, d))
                      for e in range(E_loc)])  # (E_loc, c, d)
    p = {"w_gate": w_gate, "w_in": w_in, "w_out": w_out}
    ye = _expert_mlp(act, xe[None], p, "gec", "gec")[0] * g[..., None].to(xb.dtype)
    y = torch.zeros((n, d), dtype=xb.dtype, device=xb.device)
    mass = torch.zeros((n,), dtype=torch.float32, device=xb.device)
    for e in range(E_loc):  # expert-major, as ffn.moe_forward's combine
        y = y.scatter_add(0, idx[e, :, None].expand(c, d), ye[e])
        mass = mass.scatter_add(0, idx[e], g[e])
    if share:  # every data shard's slots, summed onto the tokens' shards
        y, mass = SumScatter.apply(y, data), SumScatter.apply(mass, data)
    if model is not None:  # the row sum over model
        y, mass = Sum.apply(y, model), Sum.apply(mass, model)
    y = y / torch.clamp(mass, min=1e-9)[:, None].to(xb.dtype)
    return y.reshape(B_loc, T, d), aux


def moe_routed_shardmap(cfg: ArchConfig, p: dict, x, mesh, *, capacity_factor: float = 1.0):
    """Routed experts only: x (B, T, d) -> (y (B, T, d), aux scalar).  The
    caller (`ffn.moe_forward`) adds the shared experts and scales aux by
    `router_aux_coef`.  On a 1-rank mesh (plain tensors) the interior runs
    whole; otherwise `x` and `p` are DTensors on `mesh.device_mesh`."""
    if mesh.device_mesh is None:
        return _interior(cfg, x, p["router"], p["w_gate"], p["w_in"], p["w_out"],
                         groups=(None, None), n_data=1, n_model=1, m_idx=0,
                         capacity_factor=capacity_factor)
    return _on_mesh(cfg, p, x, mesh.device_mesh, data_split=True, global_choice=False,
                    capacity_factor=capacity_factor)


def global_supported(cfg: ArchConfig, x) -> bool:
    """`moe_routed_global` serves `x`: a DTensor on a mesh with "data" and
    "model" axes, split over "data" on its batch or whole, whose experts
    divide "model"."""
    dm = getattr(x, "device_mesh", None)
    if dm is None or not {"data", "model"} <= set(dm.mesh_dim_names or ()):
        return False
    data = x.placements[dm.mesh_dim_names.index("data")]
    return (cfg.num_experts % dm.size(dm.mesh_dim_names.index("model")) == 0
            and (data.is_replicate() or data.is_shard(0))
            and not any(p.is_partial() for p in x.placements))


def moe_routed_global(cfg: ArchConfig, p: dict, x, *, capacity_factor: float = 1.0):
    """Expert choice with one group (G = 1, the reference's default) on a
    model mesh: every expert picks its top-C tokens among the whole batch,
    as on one device.  Experts are split over "model" (the reference's
    `param_pspecs`); each rank gathers its experts' scores and the tokens
    over "data", runs its experts on its data shard's block of the slots
    they chose (the reference's GSPMD program runs every slot on every
    data shard), and the combine is summed over "data" onto the tokens'
    shards and over "model".  The tokens come in
    whole over "model" and go out so.  Routed experts only, as
    `moe_routed_shardmap`."""
    data = x.placements[x.device_mesh.mesh_dim_names.index("data")]
    return _on_mesh(cfg, p, x, x.device_mesh, data_split=data.is_shard(0), global_choice=True,
                    capacity_factor=capacity_factor)


def _on_mesh(cfg: ArchConfig, p: dict, x, dm, *, data_split: bool, global_choice: bool,
             capacity_factor: float):
    """The interior through `local_map` on `dm`: tokens split over "data"
    when `data_split` (else whole), whole over "model"; experts split over
    "model"; the router whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(dm.mesh_dim_names)

    def on(axis, placement):
        # `placement` on `axis`, every other mesh axis replicated
        return tuple(placement if a == axis else Replicate() for a in names)

    rep = on(None, None)
    n_data, n_model = dm.size(names.index("data")), dm.size(names.index("model"))
    groups = (dm.get_group("data") if data_split else None, dm.get_group("model"))
    m_idx, d_idx = dm.get_local_rank("model"), dm.get_local_rank("data")
    x_pl = on("data", Shard(0)) if data_split else rep
    args = (x, p["router"], p["w_gate"], p["w_in"], p["w_out"])
    args = tuple(a if isinstance(a, DTensor) else DTensor.from_local(a, dm, rep, run_check=False)
                 for a in args)
    fn = local_map(
        lambda *a: _interior(cfg, *(ContiguousGrad.apply(t) for t in a), groups=groups,
                             n_data=n_data if data_split else 1, n_model=n_model, m_idx=m_idx,
                             d_idx=d_idx, capacity_factor=capacity_factor,
                             global_choice=global_choice),
        out_placements=(x_pl, rep),
        in_placements=(x_pl, rep, on("model", Shard(0)), on("model", Shard(0)),
                       on("model", Shard(0))),
        device_mesh=dm, redistribute_inputs=True)
    return fn(*args)
