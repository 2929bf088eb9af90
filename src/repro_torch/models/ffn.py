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

import math

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import activation, dense_init


def init_ffn(cfg: ArchConfig, gen: torch.Generator, dtype, lead: tuple = ()) -> dict:
    """Gated (SwiGLU-family, act "silu") or plain FFN params; `lead` =
    (layers,) stacks that many blocks."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {
            "w_gate": dense_init(gen, d, f, lead=lead, dtype=dtype),
            "w_in": dense_init(gen, d, f, lead=lead, dtype=dtype),
            "w_out": dense_init(gen, f, d, lead=lead, dtype=dtype),
        }
    return {
        "w_in": dense_init(gen, d, f, lead=lead, dtype=dtype),
        "b_in": torch.zeros((*lead, f), dtype=dtype, device=gen.device),
        "w_out": dense_init(gen, f, d, lead=lead, dtype=dtype),
        "b_out": torch.zeros((*lead, d), dtype=dtype, device=gen.device),
    }


def ffn_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    if "w_gate" in p:
        return (act(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    return act(x @ p["w_in"] + p["b_in"]) @ p["w_out"] + p["b_out"]


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def _expert_weights(gen: torch.Generator, lead: tuple, E: int, n_in: int, n_out: int,
                    dtype) -> torch.Tensor:
    """(*lead, E, n_in, n_out) normal weights times 1/sqrt(n_in), drawn in f32
    one (n_in, n_out) matrix at a time, so a full-width stack never has an
    f32 copy on the device.  Built under `FakeTensorMode` (the dry run's
    `abstract_params`), the stack holds no data and nothing is drawn."""
    w = torch.empty((*lead, E, n_in, n_out), dtype=dtype, device=gen.device)
    if is_fake(w):
        return w
    for mat in w.view(-1, n_in, n_out):
        mat.copy_(torch.randn((n_in, n_out), generator=gen, device=gen.device,
                              dtype=torch.float32) * (1.0 / math.sqrt(n_in)))
    return w


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype, lead: tuple = ()) -> dict:
    """MoE params: `router` (d, E) in f32 whatever `dtype`; experts `w_gate`,
    `w_in` (E, d, f) and `w_out` (E, f, d); `shared` (a gated FFN of width
    f * num_shared_experts) when the config has shared experts.  `lead` =
    (layers,) stacks that many blocks."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, d, E, lead=lead, dtype=torch.float32),
        "w_gate": _expert_weights(gen, lead, E, d, f, dtype),
        "w_in": _expert_weights(gen, lead, E, d, f, dtype),
        "w_out": _expert_weights(gen, lead, E, f, d, dtype),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, d, fs, lead=lead, dtype=dtype),
            "w_in": dense_init(gen, d, fs, lead=lead, dtype=dtype),
            "w_out": dense_init(gen, fs, d, lead=lead, dtype=dtype),
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
    if method == "expert_choice" and cfg.moe_shardmap:
        from repro_torch.models import moe_shardmap as msm
        from repro_torch.sharding.ctx import current_mesh

        mesh = current_mesh()
        if mesh is not None and msm.shardmap_supported(cfg, mesh, B):
            y, aux = msm.moe_routed_shardmap(cfg, p, x, mesh, capacity_factor=capacity_factor)
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
        # groups are the batch rows when routing is group-limited (and every
        # expert can fill its capacity within a row), else one global group
        G = B if (cfg.moe_groups > 1 and T * k >= E) else 1
        n = N // G
        cap = max(1, int(n * k * capacity_factor) // E)
        xg = xf.reshape(G, n, d)
        g, idx = top_k(probs.reshape(G, n, E).transpose(1, 2), cap)  # (G, E, C)
        # one gather per expert: each backward scatters C distinct rows
        xe = torch.stack([torch.gather(xg, 1, idx[:, e, :, None].expand(G, cap, d))
                          for e in range(E)], dim=1)  # (G, E, C, d)
        ye = _expert_mlp(act, xe, p, "gec", "gec") * g[..., None].to(x.dtype)
        y = torch.zeros((G, n, d), dtype=x.dtype, device=x.device)
        mass = torch.zeros((G, n), dtype=torch.float32, device=x.device)
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
