"""Training launcher (port of `repro/launch/train.py`).

* ``--execute``: a multi-round Fed-CHS training loop at the arch's smoke
  scale: per-cluster non-IID Markov token streams, the paper's eta_k
  schedule, sequential chain passing (`launch.steps.make_train_round`),
  and with ``--ckpt`` a round-resumable checkpoint.  On the card unless
  ``--device cpu``.

* without it: lower the Fed-CHS round (``--shape train_4k``) for the
  production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``, a chain a
  pod) inside a fake world of that many ranks, as the dry run does
  (`launch.dryrun`; ``--opt`` its perf config), and print its per-device
  bytes and FLOPs from the counted trace.  No card needed.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --execute --rounds 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --multi-pod --opt
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="fedchs", choices=["fedchs", "hfl"])
    ap.add_argument("--shape", default="train_4k", choices=["train_4k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="lower with the beyond-paper perf config "
                         "(launch.steps.apply_optimizations)")
    ap.add_argument("--execute", action="store_true",
                    help="run a real reduced-scale training loop")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--chains", type=int, default=2, help="clusters (execute mode)")
    ap.add_argument("--batch", type=int, default=4, help="per-chain batch (execute mode)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--K", type=int, default=20, help="paper's within-cluster steps")
    ap.add_argument("--ckpt", default=None,
                    help="execute: checkpoint dir (resumes if one exists)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.execute:
        _execute(args)
    else:
        _lower(args)


def _lower(args) -> None:
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import (MULTI_POD_CHIPS, POD_CHIPS, fake_world,
                                         make_production_mesh)
    from repro_torch.launch.steps import build_lowering, lower_spec
    from repro_torch.roofline.analysis import analyze_trace

    cfg = get_config(args.arch)
    with fake_world(MULTI_POD_CHIPS if args.multi_pod else POD_CHIPS):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device="cpu")
        spec = build_lowering(cfg, args.shape, mesh, variant=args.variant, optimized=args.opt)
        t0 = time.time()
        rec = analyze_trace(lower_spec(spec, mesh))
    mem = rec["memory"]
    print(f"{spec.name} on {'2x16x16' if args.multi_pod else '16x16'} mesh: "
          f"lowered in {time.time() - t0:.1f}s")
    print("  bytes/device (argument+output+temp): "
          f"{(mem['argument_bytes'] + mem['output_bytes'] + mem['temp_bytes']) / 2**30:.2f} GiB")
    print(f"  dot flops/device: {rec['dot_flops_per_device']:.3e}")
    print("  (roofline terms: python -m repro_torch.launch.dryrun --arch ...)")


def _execute(args) -> None:
    from repro_torch.checkpoint.io import load_pytree, save_pytree
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.tokens import MarkovTokens
    from repro_torch.launch.steps import make_train_round
    from repro_torch.models import transformer as tf
    from repro_torch.optim.schedules import paper_sqrt_schedule

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    print(f"{args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model}) "
          f"-> {cfg.param_count() / 1e6:.1f}M params, variant={args.variant}, on {device}")

    params = tf.init_params(cfg, 0, device)
    C = args.chains
    stacked = tree_map(lambda x: torch.stack([x] * C), params)

    # per-cluster non-IID corpora: disjoint Markov topic mixtures; the rng
    # is derived from (cluster, round), so a resumed run replays the stream
    gens = [MarkovTokens(cfg.vocab_size, topics=4, seed=100 + c) for c in range(C)]

    def batch_for(t: int) -> dict:
        toks = np.stack([g.sample(np.random.default_rng((c + 1) * 100003 + t), args.batch,
                                  args.seq + 1) for c, g in enumerate(gens)])
        batch = {"tokens": torch.from_numpy(toks[:, :, :-1].copy()).to(device),
                 "labels": torch.from_numpy(toks[:, :, 1:].copy()).to(device)}
        # the stub frontends' inputs, zeros as in the reference
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros((C, args.batch, cfg.num_audio_frames, cfg.d_model),
                                          device=device)
        if cfg.num_patches:
            batch["patches"] = torch.zeros((C, args.batch, cfg.num_patches, tf.PATCH_DIM),
                                           device=device)
        return batch

    t_start = 0
    pfile = mfile = None
    if args.ckpt:
        pfile = os.path.join(args.ckpt, "params.npz")
        mfile = os.path.join(args.ckpt, "meta.npz")
        if os.path.exists(pfile) and os.path.exists(mfile):
            stacked = load_pytree(pfile, stacked)
            with np.load(mfile) as meta:
                t_start = int(meta["round"]) + 1
            print(f"resumed from {args.ckpt} at round {t_start}")

    round_fn = make_train_round(cfg, variant=args.variant, remat=False)
    lr = float(np.float32(args.lr * paper_sqrt_schedule(K=args.K, half=False)(0) * args.K))
    t0 = time.time()
    for t in range(t_start, args.rounds):
        stacked, loss = round_fn(stacked, batch_for(t), lr)
        if t % max(args.rounds // 10, 1) == 0 or t == args.rounds - 1:
            print(f"round {t:4d}  loss {float(loss):.4f}", flush=True)
        if args.ckpt and (t % args.ckpt_every == 0 or t == args.rounds - 1):
            save_pytree(pfile, stacked)
            np.savez(mfile, round=np.int64(t))
    print(f"done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
