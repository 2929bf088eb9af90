"""The MoE block and the serving path on the card.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_serve_cuda.py``.
Without a CUDA device every case skips.

* The MoE combine (one scatter-add per expert, in expert order) and the
  gather's backward (one gather per expert) collide on no index, so
  `moe_forward` and its grads repeat bit for bit on the card, in f32 and
  bf16, global and group-limited, and under the engine's vmap over
  clients.
* Teacher-forced `decode_step` on the card against the same steps on the
  CPU (smoke dbrx-132b, f32, `dense_topk`) at the f32 rule of the CPU
  tests (rtol 1e-4, atol 1e-5).
* `serve_loop` on the card: solo equal to batched, exactly `max_new`
  tokens a request (smoke qwen3-0.6b).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.registry import smoke_config
from repro_torch.core import prng
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.launch.serve import serve_loop
from repro_torch.models import ffn
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device, tree_leaves, tree_map

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU")


def moe_inputs(dtype, groups):
    cfg = dataclasses.replace(smoke_config("dbrx-132b"), moe_groups=groups)
    device = resolve_device("cuda")
    p = ffn.init_moe(cfg, prng.PRNGKey(0), dtype, device)
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator(device).manual_seed(1),
                    device=device).to(dtype)
    return cfg, p, x


def moe_loss(cfg, p, x):
    y, aux = ffn.moe_forward(cfg, p, x)
    return (y.float() ** 2).mean() + aux


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 4], ids=["G1", "GB"])
def test_moe_forward_and_grads_repeat_bit_for_bit(dtype, groups):
    cfg, p, x = moe_inputs(dtype, groups)
    runs = [grad_and_value(lambda p, x: moe_loss(cfg, p, x), argnums=(0, 1))(p, x)
            for _ in range(2)]
    (ga, la), (gb, lb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ga), tree_leaves(gb)))


@needs_card
def test_vmapped_moe_grads_repeat_bit_for_bit():
    cfg, p, x = moe_inputs(torch.bfloat16, 1)
    xs = torch.stack([x, x.flip(1)])
    fn = vmap(grad_and_value(lambda p, x: moe_loss(cfg, p, x)), in_dims=(None, 0))
    (ga, la), (gb, lb) = fn(p, xs), fn(p, xs)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ga), tree_leaves(gb)))


@needs_card
def test_decode_steps_on_the_card_match_the_cpu():
    cfg = smoke_config("dbrx-132b")
    params = tf.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(synthetic_lm_batch(cfg.vocab_size, 2, 8, seed=0)["tokens"])
    out = {}
    for device in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(device), params)
        caches, logits = tf.init_caches(cfg, 2, 8, device=device), []
        for t in range(8):
            lg, caches = tf.decode_step(cfg, p, caches, toks[:, t:t + 1].to(device),
                                        moe_method="dense_topk")
            logits.append(lg.cpu())
        out[device] = torch.stack(logits, 1), tree_map(lambda t: t.cpu(), caches)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@needs_card
def test_serve_loop_on_the_card_batched_equals_solo():
    cfg = smoke_config("qwen3-0.6b")
    params = tf.init_params(cfg, 0, resolve_device("cuda"))
    batched, _ = serve_loop(cfg, params, requests=6, slots=4, prompt_len=6, max_new=8)
    solo, _ = serve_loop(cfg, params, requests=6, slots=1, prompt_len=6, max_new=8)
    assert batched == solo
    assert all(len(v) == 8 for v in solo.values()) and np.all(
        [0 <= t < cfg.vocab_size for v in solo.values() for t in v])
