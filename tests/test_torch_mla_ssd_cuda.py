"""MLA, multi-token prediction and SSD blocks on the card.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_mla_ssd_cuda.py``.
Without a CUDA device every case skips.

* Smoke deepseek-v3-671b (MLA, MTP, MoE) and mamba2-370m (SSD), f32 and
  bf16: a `make_train_step` step and a run of `decode_step`s repeat bit
  for bit on the card (the MoE combine collides on no index; the SSD
  chunk loop and the MLA products are deterministic).
* Teacher-forced `decode_step` on the card against the same steps on the
  CPU at the f32 rule of the CPU tests (rtol 1e-4, atol 1e-5).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device, tree_leaves, tree_map

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU")

ARCHS = ["deepseek-v3-671b", "mamba2-370m"]


def setup(arch, dtype, device):
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    params = tf.init_params(cfg, 0, resolve_device(device))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in synthetic_lm_batch(cfg.vocab_size, 2, 40, seed=0).items()}
    return cfg, params, batch


def decode_run(cfg, params, tokens):
    caches, logits = tf.init_caches(cfg, tokens.shape[0], tokens.shape[1],
                                    device=tokens.device), []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, caches = tf.decode_step(cfg, params, caches, tokens[:, t:t + 1],
                                        moe_method="dense_topk")
            logits.append(lg)
    return torch.stack(logits, 1), caches


@needs_card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_repeats_bit_for_bit(arch, dtype):
    cfg, params, batch = setup(arch, dtype, "cuda")
    step = tf.make_train_step(cfg)
    (pa, la), (pb, lb) = step(params, batch, 0.3), step(params, batch, 0.3)
    assert torch.equal(la, lb) and bool(torch.isfinite(la))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb)))


@needs_card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_repeat_bit_for_bit(arch, dtype):
    cfg, params, batch = setup(arch, dtype, "cuda")
    (la, ca), (lb, cb) = (decode_run(cfg, params, batch["tokens"][:, :12]) for _ in range(2))
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ca), tree_leaves(cb)))


@needs_card
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_on_the_card_match_the_cpu(arch):
    cfg, params, batch = setup(arch, "float32", "cpu")
    tokens = batch["tokens"][:, :12]
    cpu_logits, cpu_caches = decode_run(cfg, params, tokens)
    card = tree_map(lambda t: t.cuda(), params)
    logits, caches = decode_run(cfg, card, tokens.cuda())
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(caches), tree_leaves(cpu_caches)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
