"""Serve a small LM with batched requests in the PyTorch port: prefill, then
token-by-token greedy decode through the caches (GQA caches, ring buffers
for sliding-window layers).  The torch counterpart of
`examples/serve_decode.py`.

  PYTHONPATH=src python examples/torch_serve_decode.py --arch qwen3-0.6b --tokens 32
  PYTHONPATH=src python examples/torch_serve_decode.py --arch dbrx-132b --device cpu

The arch resolves to its reduced smoke variant.  Runs on the CUDA card
unless `--device cpu`; on the card it also prints the peak memory.  The
weights are the reference example's (`init_params` from seed 0), and so are
an encoder-decoder's stub audio frames (`jax.random.normal(PRNGKey(1),
...) * 0.1`, drawn by `kernels/normal.py`).  The reference example draws no
patch embeddings for a VLM (its decode never reads them); this one draws
them the same way from PRNGKey(2) and prefills over them.  `main(argv)`
returns the generated tokens, one list per request.
"""
import argparse
import time

import torch

from repro_torch.configs.registry import ARCH_IDS, smoke_config
from repro_torch.core import prng
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.kernels.normal import normal_fill
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_inputs(shape: tuple, seed: int, device) -> torch.Tensor:
    """`jax.random.normal(PRNGKey(seed), shape) * 0.1` in f32."""
    return normal_fill(torch.empty(shape, device=device), prng.PRNGKey(seed), 0.1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4, help="concurrent requests")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32, help="tokens to generate")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    params = tf.init_params(cfg, 0, device)
    B = args.batch
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             synthetic_lm_batch(cfg.vocab_size, B, args.prompt_len, seed=0).items()}
    # the stub frontends' outputs: audio frames for an encoder-decoder (the
    # prefill pins their encoder K/V in the caches), patch embeddings for a VLM
    if cfg.is_encoder_decoder:
        batch["frames"] = stub_inputs((B, cfg.num_audio_frames, cfg.d_model), 1, device)
    if cfg.num_patches:
        batch["patches"] = stub_inputs((B, cfg.num_patches, tf.PATCH_DIM), 2, device)

    with torch.no_grad():
        # prefill: the forward over the prompt, and the caches filled by
        # teacher-forced decode of it, with room for the generated tokens
        t0 = time.perf_counter()
        logits, caches = tf.prefill(cfg, params, batch,
                                    capacity=args.prompt_len + args.tokens)
        sync(device)
        prefill_s = time.perf_counter() - t0

        # greedy decode
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            logits, caches = tf.decode_step(cfg, params, caches, tok)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        sync(device)
        decode_s = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu()

    print(f"arch={cfg.name} (reduced) | {B} requests | prompt {args.prompt_len} | "
          f"generated {args.tokens} | on {device}")
    print(f"prefill: {prefill_s:.2f}s   decode: {decode_s:.2f}s "
          f"({B * (args.tokens - 1) / max(decode_s, 1e-9):.1f} tok/s)")
    if device.type == "cuda":
        print(f"peak memory allocated on {torch.cuda.get_device_name(device)}: "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    for b in range(min(B, 2)):
        print(f"request {b}: {gen[b][:16].tolist()} ...")
    return gen.tolist()


if __name__ == "__main__":
    main()
