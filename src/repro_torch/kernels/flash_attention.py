"""Flash attention forward: the Hopper kernel's wrapper and its plain version.

`flash_attention` takes tensors on the card to the hand-written CUDA kernel
in `repro_torch/csrc/flash_attention.cu` and tensors on the CPU to
`flash_attention_plain`, the Pallas kernel's function written in torch
(dense masked scores, the same order of operations).  A CUDA tensor never
falls back to the plain version: the wrapper launches the kernel or raises.
The kernel is built at first use and counted in `build.LAUNCHES`.

Differentiation and vmap are `models.attention.FlashAttention`'s job: this
module is the forward only, as the reference's kernel is.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import LAUNCHES, library

NEG_INF = -1e30
HEAD_DIMS = tuple(range(32, 257, 32))  # the kernel's head dims
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _load() -> ctypes.CDLL:
    lib = library("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = ([ptr] * 4 + [i32] * 7 + [i64] * 12
                                        + [i32, i32, ctypes.c_float, ptr])
    lib.flash_attention_fwd.restype = i32
    return lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None) -> torch.Tensor:
    """The Pallas kernel's function in plain torch: q cast to f32 then
    scaled, masked dense scores with the finite NEG_INF, softmax in f32,
    (p @ v) / max(l, 1e-30) in q's dtype."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float() * (1.0 / math.sqrt(hd))
    kf = k.float().repeat_interleave(g, dim=2)  # query head h reads kv head h // g
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", qf, kf)
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741 — flash-attention's row-sum name
    out = torch.einsum("bhts,bshd->bthd", p, vf) / torch.clamp(l, min=1e-30).transpose(1, 2)
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,T,H,hd) and k, v (B,S,Hkv,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k and v must share one dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _rows_aligned(x: torch.Tensor) -> bool:
    """The kernel copies rows of the head dim in 16-byte pieces: the head dim
    must be contiguous and every row must start on 16 bytes."""
    size = x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in x.stride()[:3]))


def _aligned_copy(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy: its base is the allocator's (aligned) and its
    strides are multiples of hd, so its rows start on 16 bytes."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B,T,H,hd); k, v (B,S,Hkv,hd) -> (B,T,H,hd) in q's dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must be on one CUDA device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {hd}")
    if B * H >= 2**31 or T >= 65535 * 64:
        raise ValueError(f"too large for one launch: B*H={B * H}, T={T}")
    q, k, v = (x if _rows_aligned(x) else _aligned_copy(x) for x in (q, k, v))
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    err = _load().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        B, H, Hkv, T, S, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), window or 0, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
