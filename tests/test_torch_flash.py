"""The port's flash attention against the reference package, on the CPU.

* The plain version (`kernels.flash_attention.flash_attention_plain`, what a
  CPU tensor runs and what the CUDA kernel is held to on the card) against
  the reference's Pallas `flash_attention`, run in interpret mode as
  `tests/test_kernels_flash.py` runs it, over that file's sweep of shapes,
  windows, dtypes and ragged edges, at its tolerances: atol 3e-5 in f32
  (the two sum the scores in other orders) and 2e-2 in bf16 (the output is
  rounded to bf16).
* `blockwise_attention` against the reference's, the backward's path.
* The differentiable op (`models.attention.FlashAttention`) composed as the
  engine composes it, `vmap(grad_and_value(loss))`, against the same loss
  through `blockwise_attention`: values and grads within 1e-5.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models.attention import blockwise_attention as jax_blockwise_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.models.attention import FlashAttention, blockwise_attention

torch.set_num_threads(1)


def qkv(seed, B, T, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32))


def both(arrays, dtype=np.float32):
    """The same inputs as jax arrays and torch tensors of `dtype`."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == np.float32 else \
        (jnp.bfloat16, torch.bfloat16)
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


CASES = ([dict(T=T, S=S, H=H, Hkv=Hkv, B=2, hd=32, window=None, dtype=np.float32)
          for T, S in [(128, 128), (64, 256), (200, 200)] for H, Hkv in [(4, 4), (8, 2)]]
         + [dict(T=192, S=192, H=2, Hkv=2, B=1, hd=32, window=w, dtype=np.float32)
            for w in (16, 64)]
         + [dict(T=64, S=64, H=2, Hkv=2, B=1, hd=64, window=None, dtype=dt)
            for dt in (np.float32, "bfloat16")]
         + [dict(T=50, S=77, H=2, Hkv=2, B=1, hd=32, window=None, dtype=np.float32)])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "T{T}-S{S}-H{H}-{Hkv}-hd{hd}-w{window}-{d}"
                         .format(d=np.dtype(c["dtype"]).name if c["dtype"] != "bfloat16"
                                 else "bf16", **c))
def test_plain_flash_matches_reference_kernel(case):
    c = case
    (jq, jk, jv), (q, k, v) = both(qkv(c["T"] + c["S"] + c["H"], c["B"], c["T"], c["S"],
                                       c["H"], c["Hkv"], c["hd"]), c["dtype"])
    want = jax_flash_attention(jq, jk, jv, causal=True, window=c["window"], block_q=64)
    got = flash_attention(q, k, v, causal=True, window=c["window"])  # CPU: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 3e-5 if c["dtype"] == np.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("window", [None, 16])
def test_plain_flash_matches_reference_kernel_not_causal(window):
    """The kernel's non-causal mask (every key visible, or only the window
    behind each query, keys ahead of it included), at ragged T and S."""
    (jq, jk, jv), (q, k, v) = both(qkv(7, 2, 50, 77, 4, 2, 32))
    want = jax_flash_attention(jq, jk, jv, causal=False, window=window, block_q=64)
    got = flash_attention(q, k, v, causal=False, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_blockwise_matches_reference(window):
    (jq, jk, jv), (q, k, v) = both(qkv(3, 2, 80, 80, 4, 2, 32))
    want = jax_blockwise_attention(jq, jk, jv, causal=True, window=window, kv_block=32)
    got = blockwise_attention(q, k, v, causal=True, window=window, kv_block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_plain_version_is_what_the_wrapper_runs_on_cpu():
    _, (q, k, v) = both(qkv(5, 1, 40, 40, 4, 2, 16))
    assert torch.equal(flash_attention(q, k, v, window=8),
                       flash_attention_plain(q, k, v, window=8))


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("params_batched", [True, False])
def test_op_under_vmap_grad_matches_blockwise(window, params_batched):
    """The engine's composition: clients on a vmapped axis (params batched
    in delta mode, shared in grad mode), grad_and_value of a loss."""
    rng = np.random.default_rng(11)
    n, B, T, d, H, Hkv, hd = 3, 2, 24, 16, 4, 2, 8
    w = {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.3)
         for name, shape in [("wq", (d, H * hd)), ("wk", (d, Hkv * hd)), ("wv", (d, Hkv * hd))]}
    if params_batched:
        w = {name: t.expand(n, *t.shape) + 0.01 * torch.arange(n)[:, None, None]
             for name, t in w.items()}
    x = torch.from_numpy(rng.standard_normal((n, B, T, d)).astype(np.float32))

    def loss(attend):
        def f(p, xb):
            q = (xb @ p["wq"]).reshape(B, T, H, hd)
            k = (xb @ p["wk"]).reshape(B, T, Hkv, hd)
            v = (xb @ p["wv"]).reshape(B, T, Hkv, hd)
            return torch.mean(attend(q, k, v) ** 2)
        return f

    in_dims = (0 if params_batched else None, 0)
    flash = loss(lambda q, k, v: FlashAttention.apply(q, k, v, True, window))
    block = loss(lambda q, k, v: blockwise_attention(q, k, v, causal=True, window=window))
    g_f, l_f = vmap(grad_and_value(flash), in_dims=in_dims)(w, x)
    g_b, l_b = vmap(grad_and_value(block), in_dims=in_dims)(w, x)
    assert l_f.shape == (n,)
    np.testing.assert_allclose(l_f.numpy(), l_b.numpy(), rtol=1e-5, atol=0)
    for name in w:
        np.testing.assert_allclose(g_f[name].numpy(), g_b[name].numpy(), rtol=1e-5, atol=1e-7)


def test_wrapper_rejects_bad_inputs():
    _, (q, k, v) = both(qkv(1, 1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.double(), v.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alignment_check_finds_views_the_kernel_cannot_copy(dtype):
    """The kernel copies rows in 16-byte pieces: the wrapper must copy a view
    whose base or strides break that, and only such a view."""
    from repro_torch.kernels.flash_attention import _aligned_copy, _rows_aligned

    B, T, H, hd = 2, 5, 3, 32
    n = B * T * H * hd
    flat = torch.arange(2 * n, dtype=torch.float32).to(dtype)
    base = flat[:n].view(B, T, H, hd)
    assert _rows_aligned(base)
    fused = flat.view(B, T, 2 * H * hd)[..., :H * hd].reshape(B, T, H, hd)
    assert not fused.is_contiguous() and _rows_aligned(fused)
    shifted = flat[1:n + 1].view(B, T, H, hd)
    assert not _rows_aligned(shifted)
    odd = flat[:B * T * (H * hd + 1)].view(B, T, H * hd + 1)[..., 1:].reshape(B, T, H, hd)
    assert not _rows_aligned(odd)
    for x in (shifted, odd):
        y = _aligned_copy(x)
        assert _rows_aligned(y) and torch.equal(y, x)
