"""Training launcher (port of `repro/launch/train.py`).

* ``--execute``: a multi-round Fed-CHS training loop at the arch's smoke
  scale: per-cluster non-IID Markov token streams, the paper's eta_k
  schedule, sequential chain passing (`launch.steps.make_train_round`),
  and with ``--ckpt`` a round-resumable checkpoint.  On the card unless
  ``--device cpu``.

* without it: the reference lowers the Fed-CHS round for a production mesh.
  That needs a model mesh (`make_production_mesh` in `launch/mesh.py`,
  `named_shardings` in `sharding/specs.py`), which the port does not build
  yet, so this mode exits non-zero and says so.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --execute --rounds 50
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="fedchs", choices=["fedchs", "hfl"])
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
    if not args.execute:
        sys.exit(f"lowering {args.arch} for a production mesh is not ported "
                 "(it needs the model mesh of launch/mesh.py and sharding/specs.py); "
                 "run with --execute")
    _execute(args)


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
