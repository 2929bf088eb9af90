"""Shared neural building blocks (port of `repro/models/common.py`).

Plain functions over tensors in the reference's layouts: dense weights
(in, out), activations (..., T, H, D).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import prng
from repro_torch.kernels.normal import normal_fill


def normal_leaf(keys: np.ndarray, shape: tuple, scale: float, dtype, device) -> torch.Tensor:
    """`jax.random.normal(key, shape) * scale` cast to `dtype`, for each key
    of `keys` (*lead, 2) (uint32 key words): a (*lead, *shape) tensor on
    `device`, one repetition of a stacked leaf per key.  Drawn by
    `kernels/normal.py` one trailing matrix at a time (at its offset in its
    repetition's draw), so an expert stack is drawn expert by expert."""
    keys = np.asarray(keys, np.uint32)
    lead = keys.shape[:-1]
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    mat = int(np.prod(shape[-2:]))
    if is_fake(out):  # the dry run's abstract params: nothing to draw
        return out
    for idx in np.ndindex(*lead):
        for j, piece in enumerate(out[idx].view(-1, mat) if mat else ()):
            normal_fill(piece, keys[idx], scale, offset=j * mat)
    return out


def dense_init(key: np.ndarray, n_in: int, n_out: int, *, scale: float | None = None,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The reference's `dense_init` under key words `key` (*lead, 2): normal
    weights (*lead, n_in, n_out) times `scale`, by default 1/sqrt(n_in) in
    f64 rounded to f32 (the reference multiplies its f32 draw by that numpy
    scalar).  A matrix with no rows (an FFN of width 0) is empty, as the
    reference's is."""
    if scale is None:
        scale = 1.0 / math.sqrt(n_in) if n_in else math.inf
    return normal_leaf(key, (n_in, n_out), scale, dtype, device)


def split_keys(key: np.ndarray, n: int) -> list[np.ndarray]:
    """`jax.random.split(key, n)` of every key of `key` (*lead, 2): n key
    arrays (*lead, 2)."""
    ks = prng.split_each(key, n)
    return [ks[..., i, :] for i in range(n)]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (the population variance), cast
    back to x's dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., T) int -> cos, sin of shape (..., T, head_dim//2)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D); cos/sin: (..., T, D/2). Rotate-half convention."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# collectives with their backward written out, for per-rank code on a model
# mesh (`local_map` interiors)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """`t` reduced over the ranks of `group` (a functional collective)."""
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(t, op, group)
    return out.wait() if hasattr(out, "wait") else out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `t` of `group` concatenated along dim 0 in rank order."""
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    out = gather(t.contiguous(), 0, group)
    return out.wait() if hasattr(out, "wait") else out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the ranks of `group`, this rank's block of dim 0."""
    import torch.distributed._functional_collectives as funcol

    scatter = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor
    out = scatter(t.contiguous(), "sum", 0, group)
    return out.wait() if hasattr(out, "wait") else out


class Sum(torch.autograd.Function):
    """Sum over the ranks of `group`; the cotangent, which every rank holds
    whole, passes through."""

    @staticmethod
    def forward(t, group):
        return all_reduce(t, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class Gather(torch.autograd.Function):
    """The ranks' `t` of `group` concatenated along dim 0 in rank order;
    the cotangent, of which each rank holds a part, is summed over the
    group and each rank gets back its own rows (a reduce-scatter)."""

    @staticmethod
    def forward(t, group):
        return all_gather(t, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter(ct, ctx.group), None


class SumScatter(torch.autograd.Function):
    """`t` summed over the ranks of `group`, each rank keeping its own block
    of rows (dim 0 in rank order; a reduce-scatter); the cotangent blocks
    are gathered back (`Gather`'s transpose)."""

    @staticmethod
    def forward(t, group):
        return reduce_scatter(t, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return all_gather(ct, ctx.group), None


class SumGrad(torch.autograd.Function):
    """Identity; the gradient is summed over the ranks of `group`, for an
    input every rank of the group holds whole but uses on its own part."""

    @staticmethod
    def forward(t, group):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct.contiguous(), ctx.group), None


class ScaleGrad(torch.autograd.Function):
    """Identity; the gradient times `s`."""

    @staticmethod
    def forward(t, s):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.s = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.s, None


class ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient comes back contiguous.  A `local_map`'s
    inputs take it: DTensor lays a local gradient out by its global
    (contiguous) strides and views it so, which a permuted local gradient
    (an einsum's) would not allow."""

    @staticmethod
    def forward(t):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return ct.contiguous()


class LayoutGrad(torch.autograd.Function):
    """Identity on a DTensor whose gradient comes back in the input's
    layout.  A tensor-parallel block's input is whole over "model", and
    the gradients that its column-parallel products send back to it are
    partial sums: left so, every product of the backward that meets one
    gathers its weight whole and repeats the whole product on each rank.
    Megatron's f operator, which the reference's GSPMD layouts also
    reach: one all-reduce of the block input's gradient."""

    @staticmethod
    def forward(t):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.placements = inputs[0].device_mesh, tuple(inputs[0].placements)

    @staticmethod
    def backward(ctx, ct):
        if tuple(ct.placements) != ctx.placements:
            ct = ct.redistribute(ctx.mesh, ctx.placements)
        return ct


def layout_grad(t: torch.Tensor) -> torch.Tensor:
    """`LayoutGrad` on a DTensor; a plain tensor passes through."""
    return LayoutGrad.apply(t) if hasattr(t, "device_mesh") else t


class Silu(torch.autograd.Function):
    """`F.silu` whose backward is the one autograd takes under grad mode
    (`infinitely_differentiable_silu_backward`: g * s * (1 + x * (1 - s)),
    s = sigmoid(x)) whatever the mode, so the port's gradients do not
    depend on whether the backward builds a graph: `utils.grad_and_value`
    builds none and takes the bits `torch.func.grad_and_value` took."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return F.silu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * s * (1 + x * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    return Silu.apply(x)


def activation(name: str):
    if name == "silu":
        return silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if name == "relu":
        return F.relu
    raise ValueError(name)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       z_loss: float = 0.0) -> torch.Tensor:
    """logits (B, T, V) any float dtype; labels (B, T) int. Mean NLL in f32,
    plus `z_loss` times the mean squared log-partition."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
