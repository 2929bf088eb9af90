"""Shared neural building blocks (port of `repro/models/common.py`).

Plain functions over tensors in the reference's layouts: dense weights
(in, out), activations (..., T, H, D).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, n_in: int, n_out: int, *, scale: float | None = None,
               lead: tuple = (), dtype=torch.float32) -> torch.Tensor:
    """Normal weights of shape (*lead, n_in, n_out) times `scale` (default
    1/sqrt(n_in)), drawn in f32 on the generator's device.  A matrix with
    no rows (an FFN of width 0) is empty, as the reference's is."""
    if scale is None:
        scale = 1.0 / math.sqrt(n_in) if n_in else math.inf
    w = torch.randn((*lead, n_in, n_out), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


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


def activation(name: str):
    if name == "silu":
        return F.silu
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
