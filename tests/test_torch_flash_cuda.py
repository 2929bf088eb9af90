"""The port's flash-attention kernel on the card against its plain version.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_flash_cuda.py``.
Without a CUDA device every case skips.  Tolerances are the reference's
kernel tests': atol 3e-5 in f32 (the kernel sums in another order) and
2e-2 in bf16 (outputs rounded to bf16).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    _rows_aligned,
    flash_attention,
    flash_attention_plain,
)

torch.set_num_threads(1)


def qkv(seed, B, T, S, H, Hkv, hd, dtype):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).cuda()
            for shape in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("T,S", [(128, 128), (64, 256), (200, 200), (50, 77), (80, 70)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (16, 8)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain_version(T, S, H, Hkv, hd, dtype):
    q, k, v = qkv(T * S + H + hd, 2, T, S, H, Hkv, hd, dtype)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    for causal, window in ((True, None), (True, 16), (True, 64), (False, None), (False, 16)):
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        assert out.dtype == dtype and out.shape == q.shape
        np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                                   atol=tol, rtol=0)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_reads_strided_inputs(dtype):
    """q, k, v as views into one fused projection, as a layout might give."""
    B, T, H, Hkv, hd = 2, 96, 8, 2, 64
    g = torch.Generator().manual_seed(0)
    fused = torch.randn((B, T, (H + 2 * Hkv) * hd), generator=g).to(dtype).cuda()
    q = fused[..., :H * hd].reshape(B, T, H, hd)
    k = fused[..., H * hd:(H + Hkv) * hd].reshape(B, T, Hkv, hd)
    v = fused[..., (H + Hkv) * hd:].reshape(B, T, Hkv, hd)
    assert not q.is_contiguous() and _rows_aligned(q)
    out = flash_attention(q, k, v)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=0)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_copies_misaligned_views(dtype):
    """Views one element past an aligned base: the kernel's 16-byte row
    copies cannot read them, so the wrapper hands it aligned copies."""
    B, T, S, H, Hkv, hd = 2, 70, 90, 4, 2, 96
    g = torch.Generator().manual_seed(1)
    views = []
    for shape in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)):
        n = math.prod(shape)
        flat = torch.randn(n + 1, generator=g).to(dtype).cuda()
        views.append(flat[1:].view(shape))
    q, k, v = views
    assert not any(_rows_aligned(x) for x in views)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    for causal, window in ((True, None), (False, 16)):
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                                   atol=tol, rtol=0)
