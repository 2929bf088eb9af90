"""RG-LRU blocks, the encoder and patch embeddings on the card.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_rglru_encdec_cuda.py``.
Without a CUDA device every case skips.

* Smoke recurrentgemma-9b and whisper-tiny (its cross caches filled from
  frames), f32 and bf16: a run of `decode_step`s past recurrentgemma's
  window of 16 repeats bit for bit on the card, and equals the same steps
  on the CPU at the f32 rule of the CPU tests (rtol 1e-4, atol 1e-5).
* The flash kernel against its plain version at the new paths' head
  layouts: recurrentgemma's MQA local attention (H 16, Hkv 1, hd 256,
  window 2048 at T = 2112, where the window takes effect), phi-3-vision's
  (H = Hkv = 32, hd 96) and whisper's (H = Hkv = 6, hd 64), at the tolerances
  of `tests/test_torch_flash_cuda.py` (atol 3e-5 in f32, 2e-2 in bf16).
* Smoke recurrentgemma under Fed-CHS QSGD(16), flash on: the scanned run
  (a captured CUDA graph replayed per round) equal to the looped run bit
  for bit, ledgers equal, and both launching B1, B2 and B5 as often.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device, tree_leaves, tree_map

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU")

ARCHS = ["recurrentgemma-9b", "whisper-tiny"]


def setup(arch, dtype, device):
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    params = tf.init_params(cfg, 0, resolve_device(device))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in synthetic_lm_batch(cfg.vocab_size, 2, 40, seed=0).items()}
    if cfg.is_encoder_decoder:
        g = torch.Generator().manual_seed(1)
        batch["frames"] = torch.randn((2, cfg.num_audio_frames, cfg.d_model),
                                      generator=g).to(device)
    return cfg, params, batch


def decode_run(cfg, params, batch, T=24):
    tokens = batch["tokens"][:, :T]
    caches = tf.init_caches(cfg, tokens.shape[0], T, enc_len=cfg.num_audio_frames,
                            device=tokens.device)
    logits = []
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            caches = tf._fill_cross_caches(cfg, params, batch, caches)
        for t in range(T):
            lg, caches = tf.decode_step(cfg, params, caches, tokens[:, t:t + 1])
            logits.append(lg)
    return torch.stack(logits, 1), caches


@needs_card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_repeat_bit_for_bit(arch, dtype):
    cfg, params, batch = setup(arch, dtype, "cuda")
    (la, ca), (lb, cb) = (decode_run(cfg, params, batch) for _ in range(2))
    assert torch.equal(la, lb) and bool(torch.isfinite(la).all())
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ca), tree_leaves(cb)))


@needs_card
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_on_the_card_match_the_cpu(arch):
    cfg, params, batch = setup(arch, "float32", "cpu")
    cpu_logits, cpu_caches = decode_run(cfg, params, batch)
    logits, caches = decode_run(cfg, tree_map(lambda t: t.cuda(), params),
                                {k: v.cuda() for k, v in batch.items()})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(caches), tree_leaves(cpu_caches)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@needs_card
@pytest.mark.parametrize("B,T,H,Hkv,hd,window", [
    (1, 2112, 16, 1, 256, 2048),  # recurrentgemma-9b's local blocks, past the window
    (2, 704, 32, 32, 96, None),   # phi-3-vision-4.2b: 576 patches + 128 tokens
    (4, 128, 6, 6, 64, None),     # whisper-tiny's decoder self-attention
], ids=["recurrentgemma", "phi-3-vision", "whisper"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_matches_plain_at_the_new_shapes(B, T, H, Hkv, hd, window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator().manual_seed(T + H)
    q, k, v = (torch.randn(s, generator=g).to(dtype).cuda()
               for s in ((B, T, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=3e-5 if dtype == torch.float32 else 2e-2, rtol=0)


@needs_card
def test_fed_chs_on_rglru_scans_as_it_loops():
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.sources import TokenSource
    from repro_torch.kernels import build
    from repro_torch.models.fed import LMFedModel

    cfg = smoke_config("recurrentgemma-9b")
    source = TokenSource(cfg.vocab_size, num_clients=4, batch_size=2, seq_len=64, topics=4,
                         seed=0)
    task = FLTask.from_source(LMFedModel(cfg, flash=True), source, [[0, 2], [1, 3]], seed=0)
    config = FedCHSConfig(rounds=2, local_steps=4, local_epochs=2, eval_every=1,
                          channel=QSGDChannel(16), seed=0, schedule=lambda k: 0.3)
    runs = []
    for scan in (True, False):
        build.reset_launches()
        res = run_fed_chs(task, dataclasses.replace(config, scan_rounds=scan))
        runs.append((res, dict(build.LAUNCHES)))
    (scanned, n_scanned), (looped, n_looped) = runs
    assert n_scanned == n_looped and n_scanned["qsgd_quantize_pack"] > 0
    assert n_scanned["flash_attention"] > 0
    assert scanned.ledger.events == looped.ledger.events
    assert scanned.test_acc == looped.test_acc
    for a, b in zip(tree_leaves(scanned.final_params), tree_leaves(looped.final_params)):
        assert torch.equal(a, b)
