"""Federated transformer-LM pretraining with Fed-CHS, trained by the PyTorch
port: the counterpart of `examples/train_lm_fedchs.py`, with its flags and
defaults.

An `LMFedModel` + `TokenSource` task (non-IID topic-skewed token streams,
every draw keyed by (seed, client, draw index)) runs through the same
`run_fed_chs` as the classifier experiments: compressed uplinks, the bit
ledger, and a netsim replay of the run under the default edge network.

  PYTHONPATH=src python examples/torch_train_lm_fedchs.py --config qwen3_0_6b \\
      --client-microbatch 1

`--config <arch-id>` swaps the hand-rolled dims for a registry
architecture and turns on the memory-lean configuration: bf16 compute, f32
master params, the bf16 dense wire (`Precision()`), remat, flash attention,
and whatever `--client-microbatch` is passed; one round of 2 clients in 2
clusters at batch 1 x seq 128.  Every knob stays overridable.  Beside the
reference's flags: `--flash` (flash-attention kernel; default on with
`--config`), `--device` (the CUDA card unless `--device cpu`).  Prints the
card's peak allocated memory (`torch.cuda.max_memory_allocated`) where the
reference prints its process's peak RSS.  Without `--config` the defaults
are a few-minute toy run; on the CPU, e.g.:

  PYTHONPATH=src python examples/torch_train_lm_fedchs.py --device cpu \\
      --d-model 32 --layers 2 --vocab 64 --seq 16 --batch 2 --rounds 6 \\
      --eval-every 2 --target-ppl 70
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import time

import torch

from repro_torch.comm.channels import DenseChannel, QSGDChannel, TopKChannel
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.precision import Precision, resolve_channel
from repro_torch.core.simulation import FLTask
from repro_torch.data.sources import TokenSource
from repro_torch.models.fed import LMFedModel
from repro_torch.netsim import NetworkModel, simulate_run, time_to_accuracy
from repro_torch.optim.local import AdamWOpt
from repro_torch.utils import resolve_device


def _resolve_arch(name: str):
    """Registry id lookup, tolerant of -/_/. spelling (qwen3_0_6b works).
    The params are f32: under the policy they are the master copy."""
    key = re.sub(r"[^a-z0-9]", "", name.lower())
    for arch_id in ARCH_IDS:
        if re.sub(r"[^a-z0-9]", "", arch_id) == key:
            return arch_id, dataclasses.replace(get_config(arch_id), dtype="float32")
    raise SystemExit(f"unknown --config {name!r}; choose from {ARCH_IDS}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, metavar="ARCH",
                    help="registry architecture id (e.g. qwen3_0_6b); overrides "
                         "--d-model/--layers/--vocab and turns on the memory-lean "
                         "defaults (bf16 compute, f32 master, remat, flash, 1 round of "
                         "2 clients)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=None, help="per-client batch")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--local-steps", type=int, default=None, help="K in-cluster steps/round")
    ap.add_argument("--local-epochs", type=int, default=None, help="E steps per upload")
    ap.add_argument("--client-microbatch", type=int, default=None,
                    help="clients trained at once (None = all); 1 is the memory-lean "
                         "setting")
    ap.add_argument("--mixed-precision", action=argparse.BooleanOptionalAction, default=None,
                    help="bf16 compute / f32 master / bf16 dense wire (default: on with "
                         "--config, off otherwise)")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                    help="recompute each block in the backward pass (default: on with "
                         "--config, off otherwise)")
    ap.add_argument("--flash", action=argparse.BooleanOptionalAction, default=None,
                    help="self-attention through the flash-attention kernel (default: on "
                         "with --config, off otherwise)")
    ap.add_argument("--qsgd", type=int, default=None,
                    help="QSGD levels for the client->ES uplink (0 = dense; default 16, "
                         "or 0 with --config where the bf16 dense wire takes over)")
    ap.add_argument("--topk", type=float, default=0.0,
                    help="Top-K uplink fraction (overrides --qsgd when > 0)")
    ap.add_argument("--adamw", action="store_true",
                    help="client-held AdamW instead of plain SGD (no mixed precision)")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--target-ppl", type=float, default=40.0,
                    help="perplexity threshold for the time-to-loss replay")
    ap.add_argument("--device", default=None,
                    help="the CUDA card unless 'cpu' (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    lean = args.config is not None
    # config mode: one round at LM scale; toy mode: a few-minute run
    rounds = args.rounds if args.rounds is not None else (1 if lean else 40)
    local_steps = args.local_steps if args.local_steps is not None else (2 if lean else 4)
    local_epochs = args.local_epochs if args.local_epochs is not None else (1 if lean else 2)
    batch = args.batch if args.batch is not None else (1 if lean else 4)
    clients = args.clients if args.clients is not None else (2 if lean else 4)
    eval_every = args.eval_every if args.eval_every is not None else (1 if lean else 5)
    qsgd = args.qsgd if args.qsgd is not None else (0 if lean else 16)
    mixed = args.mixed_precision if args.mixed_precision is not None else lean
    remat = args.remat if args.remat is not None else lean
    flash = args.flash if args.flash is not None else lean

    if lean:
        arch_id, cfg = _resolve_arch(args.config)
        print(f"arch {arch_id}: {cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size}")
    else:
        cfg = ArchConfig(
            name="fedchs-lm", family="dense", num_layers=args.layers, d_model=args.d_model,
            num_heads=max(args.d_model // 64, 1), num_kv_heads=max(args.d_model // 128, 1),
            d_ff=4 * args.d_model, vocab_size=args.vocab, dtype="float32",
        )
    model = LMFedModel(cfg, remat=remat, flash=flash)
    source = TokenSource(cfg.vocab_size, clients, batch, args.seq, topics=args.clusters * 2,
                         seed=0)
    members = [[i for i in range(clients) if i % args.clusters == m]
               for m in range(args.clusters)]
    task = FLTask.from_source(model, source, members, seed=0, device=device)
    precision = Precision() if mixed else None
    print(f"model: {cfg.num_layers}L d={cfg.d_model} -> {task.num_params() / 1e6:.1f}M params, "
          f"{clients} clients / {args.clusters} ES clusters on {device}"
          + (f", microbatch={args.client_microbatch}" if args.client_microbatch else "")
          + (", bf16 compute / f32 master" if mixed else "")
          + (", remat" if remat else "") + (", flash" if flash else ""))

    if args.topk > 0:
        channel = TopKChannel(fraction=args.topk)
    elif qsgd > 0:
        channel = QSGDChannel(qsgd)
    elif precision is None:
        channel = DenseChannel()
    else:
        channel = None  # FedCHSConfig resolves the bf16 dense wire
    config = FedCHSConfig(
        rounds=rounds, local_steps=local_steps, local_epochs=local_epochs,
        eval_every=eval_every, channel=channel, seed=0, precision=precision,
        client_microbatch=args.client_microbatch,
        local_opt=AdamWOpt(weight_decay=0.0) if args.adamw else None,
        schedule=lambda k: args.lr,
    )

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_fed_chs(task, config)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, ppl, loss in zip(res.rounds, res.test_acc, res.train_loss):
        print(f"round {r:4d}  train loss {loss:.4f}  held-out ppl {ppl:8.2f}")
    print(f"done in {wall:.1f}s - uniform vocab ppl would be {cfg.vocab_size}")
    if on_card:
        print(f"peak memory allocated on {torch.cuda.get_device_name(device)}: "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

    mb = res.ledger.total_megabytes()
    resolved = resolve_channel(precision, channel)
    wire = getattr(resolved, "wire_dtype", None)
    ch_name = resolved.__class__.__name__ + (f"[{wire}]" if wire else "")
    print(f"\ncommunication: {mb:,.1f} MB total ({ch_name} uplink)")
    for hop, bits in res.ledger.breakdown().items():
        print(f"  {hop:15s} {bits / 8 / 1e6:10.1f} MB")

    timeline = simulate_run(task, res, NetworkModel(), local_steps=local_steps)
    tta = time_to_accuracy(res, timeline, args.target_ppl)
    print(f"\nnetsim replay (default edge network): one pass of this run takes "
          f"{timeline.makespan:,.1f}s of simulated wall-clock")
    if tta is None:
        print(f"never reached ppl <= {args.target_ppl}; best {res.best_acc():.2f} "
              "(raise --rounds or --lr)")
    else:
        print(f"time to ppl <= {args.target_ppl}: {tta:,.1f}s simulated")
    return res


if __name__ == "__main__":
    main()
