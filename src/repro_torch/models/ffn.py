"""Feed-forward blocks: gated dense FFN and Mixture-of-Experts (port of
`repro/models/ffn.py`).

MoE dispatch follows the reference: `method="expert_choice"` (the default)
lets each expert take its top-C tokens, C = max(1, floor(n * k * cf) // E),
which keeps every shape static; `method="dense_topk"` is exact token-choice
top-k (every expert runs on every token, then a mask).  Router math is f32
(`router` is an f32 leaf whatever the model's dtype), softmax scores for 32
experts or fewer and sigmoid scores above; the Switch-style load-balance
loss comes back beside the output, times `router_aux_coef`.

Ties and order, for the card:
  * top-k picks the lower index first on equal scores, as `jax.lax.top_k`
    does: a stable descending sort, then the first k.
  * The combine adds one expert at a time, in expert order 0..E-1, in the
    activations' dtype, as the reference's expert-major `y.at[idx].add`.
    Within one expert the top-C token indices are distinct, so no add
    collides, and the gather's backward (one gather per expert, each
    scattering distinct rows) collides neither: no float atomics race, and
    the result repeats bit for bit on the card.
  * Everything is out of place and shaped from static sizes, so it runs
    under `torch.func.vmap` over clients and inside a captured CUDA graph.

With `cfg.moe_shardmap` and a (data, model) model mesh published in
`sharding.ctx` (the dry run's `--opt`), expert choice runs the
manual-collective interior of `models/moe_shardmap.py` and adds the shared
experts and the aux coefficient here, as the reference does; with no such
mesh it falls through to the plain path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import activation, dense_init, normal_leaf, split_keys


def init_ffn(cfg: ArchConfig, key: np.ndarray, dtype, device) -> dict:
    """Gated (SwiGLU-family, act "silu") or plain FFN params under key
    words `key` (*lead, 2), as the reference draws them: `lead` = (layers,)
    stacks that many blocks."""
    d, f = cfg.d_model, cfg.d_ff
    k1, k2, k3 = split_keys(key, 3)
    lead = k1.shape[:-1]
    if cfg.act == "silu":
        return {
            "w_gate": dense_init(k1, d, f, dtype=dtype, device=device),
            "w_in": dense_init(k2, d, f, dtype=dtype, device=device),
            "w_out": dense_init(k3, f, d, dtype=dtype, device=device),
        }
    return {
        "w_in": dense_init(k1, d, f, dtype=dtype, device=device),
        "b_in": torch.zeros((*lead, f), dtype=dtype, device=device),
        "w_out": dense_init(k2, f, d, dtype=dtype, device=device),
        "b_out": torch.zeros((*lead, d), dtype=dtype, device=device),
    }


def ffn_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    if "w_gate" in p:
        return (act(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    return act(x @ p["w_in"] + p["b_in"]) @ p["w_out"] + p["b_out"]


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def _constrain(t: torch.Tensor, *axes) -> torch.Tensor:
    """`t` laid out as the spec `axes` says (a mesh axis name or None per
    dim, the reference's `with_sharding_constraint(t, P(*axes))`): on a
    DTensor, a redistribution over its mesh, an axis that the mesh does not
    have left whole; a plain tensor (no mesh) passes through."""
    if not hasattr(t, "device_mesh"):
        return t
    from torch.distributed.tensor import Replicate, Shard

    pl = [Shard(axes.index(name)) if name in axes else Replicate()
          for name in t.device_mesh.mesh_dim_names]
    return t.redistribute(t.device_mesh, pl) if pl != list(t.placements) else t


def init_moe(cfg: ArchConfig, key: np.ndarray, dtype, device) -> dict:
    """MoE params under key words `key` (*lead, 2), as the reference draws
    them: `router` (d, E) in f32 whatever `dtype`; experts `w_gate`, `w_in`
    (E, d, f) and `w_out` (E, f, d), scaled by 1/sqrt(d) and 1/sqrt(f)
    computed in f32 (not `dense_init`'s f64 scale) and drawn one expert
    matrix at a time; `shared` (a gated FFN of width f *
    num_shared_experts) when the config has shared experts.  `lead` =
    (layers,) stacks that many blocks."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    k_r, k_g, k_i, k_o, k_s = split_keys(key, 5)
    scale_in, scale_out = (np.float32(1) / np.sqrt(np.float32(n)) for n in (d, f))
    p = {
        "router": dense_init(k_r, d, E, dtype=torch.float32, device=device),
        "w_gate": normal_leaf(k_g, (E, d, f), scale_in, dtype, device),
        "w_in": normal_leaf(k_i, (E, d, f), scale_in, dtype, device),
        "w_out": normal_leaf(k_o, (E, f, d), scale_out, dtype, device),
    }
    if cfg.num_shared_experts:
        ks = split_keys(k_s, 3)
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(ks[0], d, fs, dtype=dtype, device=device),
            "w_in": dense_init(ks[1], d, fs, dtype=dtype, device=device),
            "w_out": dense_init(ks[2], fs, d, dtype=dtype, device=device),
        }
    return p


def _router_probs(cfg: ArchConfig, p: dict, x_flat: torch.Tensor) -> torch.Tensor:
    """x_flat (N, d) -> probs (N, E) in f32: softmax for 32 experts or
    fewer, sigmoid above (DeepSeek-V3's scores)."""
    logits = x_flat.float() @ p["router"].float()
    if cfg.num_experts > 32:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def _load_balance_loss(probs: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style: E * sum_e (mean prob_e)^2, the soft-assignment form."""
    me = probs.mean(dim=0)
    return E * torch.sum(me * me)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, the lower
    index first among equal values (`jax.lax.top_k`'s order)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, order), order


def _expert_mlp(act, xe: torch.Tensor, p: dict, rows: str, out: str) -> torch.Tensor:
    """The gated expert MLPs; `rows` and `out` are the einsum labels of the
    input and output rows: ("gec", "gec") for expert-major rows (G, E, C, d),
    ("n", "ne") for every expert on every token."""
    h = torch.einsum(f"{rows}d,edf->{out}f", xe, p["w_gate"])
    u = torch.einsum(f"{rows}d,edf->{out}f", xe, p["w_in"])
    return torch.einsum(f"{out}f,efd->{out}d", act(h) * u, p["w_out"])


def moe_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, *, method: str = "expert_choice",
                capacity_factor: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y (B, T, d), aux_loss scalar f32)."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    act = activation(cfg.act)
    # groups are the batch rows when routing is group-limited (and every
    # expert can fill its capacity within a row), else one global group
    G = B if (cfg.moe_groups > 1 and T * k >= E) else 1
    routed = None
    if method == "expert_choice" and (cfg.moe_shardmap or G == 1):
        from repro_torch.models import moe_shardmap as msm
        from repro_torch.sharding.ctx import current_mesh

        mesh = current_mesh()
        if cfg.moe_shardmap and mesh is not None and msm.shardmap_supported(cfg, mesh, B):
            routed = msm.moe_routed_shardmap(cfg, p, x, mesh, capacity_factor=capacity_factor)
        elif G == 1 and msm.global_supported(cfg, x):
            routed = msm.moe_routed_global(cfg, p, x, capacity_factor=capacity_factor)
    if routed is not None:
        y, aux = routed
        aux = aux * cfg.router_aux_coef
        if cfg.num_shared_experts:
            sp = p["shared"]
            xf = x.reshape(B * T, d)
            y = (y.reshape(B * T, d)
                 + (act(xf @ sp["w_gate"]) * (xf @ sp["w_in"])) @ sp["w_out"]
                 ).reshape(B, T, d)
        return y, aux
    N = B * T
    xf = x.reshape(N, d)
    probs = _router_probs(cfg, p, xf)  # (N, E) f32
    aux = _load_balance_loss(probs, E) * cfg.router_aux_coef

    if method == "dense_topk":
        topv, topi = top_k(probs, k)
        gates = torch.zeros_like(probs).scatter(1, topi, topv)
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
        y_e = _expert_mlp(act, xf, p, "n", "ne")  # (N, E, d)
        y = torch.einsum("ne,ned->nd", gates.to(x.dtype), y_e)
    elif method == "expert_choice":
        n = N // G
        cap = max(1, int(n * k * capacity_factor) // E)
        xg = xf.reshape(G, n, d)
        g, idx = top_k(probs.reshape(G, n, E).transpose(1, 2), cap)  # (G, E, C)
        # one gather per expert: each backward scatters C distinct rows
        xe = torch.stack([torch.gather(xg, 1, idx[:, e, :, None].expand(G, cap, d))
                          for e in range(E)], dim=1)  # (G, E, C, d)
        ye = _expert_mlp(act, xe, p, "gec", "gec") * g[..., None].to(x.dtype)
        if G > 1:
            # the expert outputs back on their tokens' home shards before the
            # combine, as the reference pins them: no gather of the whole
            # activation over "data", no all-reduce of a partial combine
            ye, idx = _constrain(ye, "data", None, None, None), _constrain(idx, "data", None, None)
        y = torch.zeros_like(xg)  # laid out as the tokens on a model mesh
        mass = torch.zeros_like(xg[..., 0], dtype=torch.float32)
        for e in range(E):  # expert-major, as the reference's scatter-add
            y = y.scatter_add(1, idx[:, e, :, None].expand(G, cap, d), ye[:, e])
            mass = mass.scatter_add(1, idx[:, e], g[:, e])
        y = (y / torch.clamp(mass, min=1e-9)[..., None].to(x.dtype)).reshape(N, d)
    else:
        raise ValueError(method)

    if cfg.num_shared_experts:
        sp = p["shared"]
        y = y + (act(xf @ sp["w_gate"]) * (xf @ sp["w_in"])) @ sp["w_out"]
    return y.reshape(B, T, d), aux
