"""Serve a small LM with batched requests in the PyTorch port: prefill, then
token-by-token greedy decode through the caches (GQA caches, ring buffers
for sliding-window layers).  The torch counterpart of
`examples/serve_decode.py`.

  PYTHONPATH=src python examples/torch_serve_decode.py --arch qwen3-0.6b --tokens 32
  PYTHONPATH=src python examples/torch_serve_decode.py --arch dbrx-132b --device cpu

The arch resolves to its reduced smoke variant.  Runs on the CUDA card
unless `--device cpu`; on the card it also prints the peak memory.
"""
import argparse
import time

import torch

from repro_torch.configs.registry import ARCH_IDS, smoke_config
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4, help="concurrent requests")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32, help="tokens to generate")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    params = tf.init_params(cfg, 0, device)
    B = args.batch
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             synthetic_lm_batch(cfg.vocab_size, B, args.prompt_len, seed=0).items()}
    # the stub frontends' outputs: audio frames for an encoder-decoder (the
    # prefill pins their encoder K/V in the caches), patch embeddings for a VLM
    gen = torch.Generator().manual_seed(1)
    if cfg.is_encoder_decoder:
        batch["frames"] = (torch.randn((B, cfg.num_audio_frames, cfg.d_model), generator=gen)
                           * 0.1).to(device)
    if cfg.num_patches:
        batch["patches"] = (torch.randn((B, cfg.num_patches, tf.PATCH_DIM), generator=gen)
                            * 0.1).to(device)

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


if __name__ == "__main__":
    main()
