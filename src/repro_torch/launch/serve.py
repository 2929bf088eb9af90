"""Serving launcher (port of `repro/launch/serve.py`).

Modes:

* ``--execute``: a continuous-batching serving loop at the arch's smoke
  scale: a request queue, fixed batch slots, per-slot prefill
  (teacher-forced cache fill), greedy decode, and slot recycling when a
  request finishes.  On the card unless ``--device cpu``.

* ``--federation``: the async federation service, event-driven Fed-CHS
  (`repro_torch.async_fl.run_async_fed_chs`) with continuous crash-safe
  checkpoints; ``--resume`` continues a killed run bit for bit.  Its last
  stdout line is a JSON summary.

* neither: lower the decode step (``--shape``) for the production mesh
  (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) inside a fake world of
  that many ranks, as the dry run does (`launch.dryrun`), and print its
  per-device bytes and FLOPs from the counted trace.  No card needed.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --execute --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve --federation --rounds 8 --checkpoint ck
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --shape decode_32k
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device, tree_leaves, tree_map


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="model architecture (required except --federation)")
    ap.add_argument("--execute", action="store_true")
    ap.add_argument("--shape", default="decode_32k", choices=["decode_32k", "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--requests", type=int, default=8, help="execute: total requests")
    ap.add_argument("--slots", type=int, default=4, help="execute: concurrent batch slots")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--federation", action="store_true",
                    help="run the async federation service (repro_torch.async_fl) "
                         "with continuous checkpointing instead of serving")
    ap.add_argument("--checkpoint", default=None,
                    help="federation: run-state path prefix (continuous save)")
    ap.add_argument("--resume", action="store_true",
                    help="federation: resume from --checkpoint if present")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--clusters", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--quorum-frac", type=float, default=1.0)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--churn-p", type=float, default=1.0,
                    help="federation: per-(client, activation) availability")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-after-activation", type=int, default=None,
                    help=argparse.SUPPRESS)  # crash test: os._exit after the
    #   checkpoint at this activation lands, a hard kill mid-run
    args = ap.parse_args(argv)
    if args.federation:
        _federation(args)
    elif args.arch is None:
        ap.error("--arch is required unless --federation")
    elif args.execute:
        _execute(args)
    else:
        _lower(args)


def _lower(args) -> None:
    from repro_torch.configs.registry import get_config, long_context_config
    from repro_torch.launch.mesh import (MULTI_POD_CHIPS, POD_CHIPS, fake_world,
                                         make_production_mesh)
    from repro_torch.launch.steps import build_lowering, lower_spec
    from repro_torch.roofline.analysis import analyze_trace

    cfg = (long_context_config(args.arch) if args.shape == "long_500k"
           else get_config(args.arch))
    with fake_world(MULTI_POD_CHIPS if args.multi_pod else POD_CHIPS):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device="cpu")
        spec = build_lowering(cfg, args.shape, mesh)
        t0 = time.time()
        rec = analyze_trace(lower_spec(spec, mesh))
    mem = rec["memory"]
    print(f"{spec.name} on {'2x16x16' if args.multi_pod else '16x16'} mesh: "
          f"lowered in {time.time() - t0:.1f}s")
    print("  bytes/device (argument+output+temp): "
          f"{(mem['argument_bytes'] + mem['output_bytes'] + mem['temp_bytes']) / 2**30:.2f} GiB")


def _federation(args) -> None:
    """Async federation as a service: event-driven Fed-CHS with continuous
    crash-safe checkpointing.  Kill the process at any point; relaunching
    with --resume continues bit-identically to an uninterrupted run (the
    hidden --kill-after-activation switch dies right after a checkpoint
    lands)."""
    from repro_torch.async_fl import AsyncFedCHSConfig, run_async_fed_chs
    from repro_torch.core.simulation import FLTask
    from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
    from repro_torch.models.classifier import make_classifier
    from repro_torch.part import AlwaysOn, BernoulliTrace

    ds = make_dataset("mnist", train_size=2000, test_size=400, seed=args.seed)
    clients = dirichlet_partition(ds.train_y, args.clients, 0.6, seed=args.seed)
    clusters = assign_clusters(args.clients, args.clusters, seed=args.seed)
    model = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    task = FLTask(model, ds, clients, clusters, batch_size=16, seed=args.seed,
                  device=args.device)

    on_checkpoint = None
    if args.kill_after_activation is not None:
        def on_checkpoint(a: int) -> None:
            if a >= args.kill_after_activation:
                print(f"killed after activation {a}", flush=True)
                os._exit(1)  # hard kill: no atexit, no flushes, a real crash

    trace = (AlwaysOn() if args.churn_p >= 1.0
             else BernoulliTrace(p=args.churn_p, seed=args.seed + 17))
    config = AsyncFedCHSConfig(
        rounds=args.rounds, local_steps=args.local_steps,
        initial_cluster=0, quorum_frac=args.quorum_frac,
        deadline_s=args.deadline_s, trace=trace, eval_every=5,
        seed=args.seed, checkpoint=args.checkpoint, resume=args.resume,
        on_checkpoint=on_checkpoint,
    )
    t0 = time.time()
    res = run_async_fed_chs(task, config)
    print(json.dumps({
        "algo": res.name,
        "rounds": res.rounds,
        "test_acc": res.test_acc,
        "sim_times": res.sim_times,
        "total_bits": int(res.ledger.total_bits()),
        "staleness": {str(k): v for k, v in res.ledger.staleness_histogram().items()},
        "wall_s": round(time.time() - t0, 2),
    }))


def _splice_slot(base: dict, donor: dict, s: int) -> dict:
    """Caches equal to `base` everywhere except batch slot `s`, taken from
    `donor`.  Tail block caches carry the batch on axis 0; the stacked
    superblock caches on axis 1."""

    def at(axis: int):
        def f(b, d):
            idx = (slice(None),) * axis + (s,)
            out = b.clone()
            out[idx] = d[idx]
            return out

        return f

    return {"super": [tree_map(at(1), b, d) for b, d in zip(base["super"], donor["super"])],
            "tail": [tree_map(at(0), b, d) for b, d in zip(base["tail"], donor["tail"])]}


def serve_loop(cfg, params: dict, *, requests: int, slots: int, prompt_len: int,
               max_new: int) -> tuple[dict[int, list[int]], int]:
    """Continuous-batching greedy decode on the params' device; returns
    ({request: tokens}, batched decode steps).

    Each request yields exactly `max_new` tokens: the prefill's
    last-position argmax plus `max_new - 1` batched decode steps.

    Admission prefills ONE slot through the batch-wide decode step, then
    splices: the slot is first reset from a fresh cache (a recycled slot's
    `len` restarts at position 0), the prompt is teacher-forced through the
    batch step, and only slot `s`'s cache rows are kept; every other slot's
    cache is restored from the snapshot taken before admission, so a
    request decodes the same tokens alone or beside others (with a dense
    FFN; expert-choice MoE routing depends on the whole batch by design).

    As in the reference, the prompts are tokens only: an encoder-decoder's
    cross caches (over `cfg.num_audio_frames` frames) stay zero, so it
    decodes against zero encoder states, and a VLM decodes without patches.
    """
    device = tree_leaves(params)[0].device
    S = slots
    enc_len = cfg.num_audio_frames if cfg.is_encoder_decoder else 0
    fresh = tf.init_caches(cfg, S, prompt_len + max_new, enc_len=enc_len, device=device)
    caches = fresh

    def step(tok: np.ndarray):
        return tf.decode_step(cfg, params, caches, torch.from_numpy(tok).to(device))

    pending = list(range(requests))
    prompts = {r: synthetic_lm_batch(cfg.vocab_size, 1, prompt_len, seed=r)["tokens"][0]
               for r in pending}
    slot_req = [-1] * S  # request id in each slot, -1 when idle
    slot_gen = [0] * S   # tokens decoded in each slot
    cur_tok = np.zeros((S, 1), np.int32)
    done: dict[int, list[int]] = {}
    steps = 0

    def admit(s: int) -> None:
        """Prefill the next request into slot s by teacher-forced ingestion."""
        nonlocal caches
        r = pending.pop(0)
        slot_req[s], slot_gen[s] = r, 0
        snapshot = caches
        caches = _splice_slot(caches, fresh, s)  # the slot restarts at position 0
        for t in range(prompt_len):
            tok = cur_tok.copy()
            tok[s, 0] = prompts[r][t]
            logits, caches = step(tok)
        caches = _splice_slot(snapshot, caches, s)  # the others: pre-admission state
        cur_tok[s, 0] = int(torch.argmax(logits[s]))
        done[r] = [int(cur_tok[s, 0])]

    with torch.no_grad():
        while pending or any(r >= 0 for r in slot_req):
            for s in range(S):
                if slot_req[s] < 0 and pending:
                    admit(s)
            logits, caches = step(cur_tok)
            steps += 1
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            for s in range(S):
                r = slot_req[s]
                if r < 0:
                    continue
                slot_gen[s] += 1
                done[r].append(int(nxt[s]))
                cur_tok[s, 0] = nxt[s]
                if slot_gen[s] >= max_new - 1:
                    slot_req[s] = -1  # retire; the slot is re-admitted next iteration
    return done, steps


def _execute(args) -> None:
    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(args.arch)
    params = tf.init_params(cfg, 0, resolve_device(args.device))
    t0 = time.time()
    done, steps = serve_loop(cfg, params, requests=args.requests, slots=args.slots,
                             prompt_len=args.prompt_len, max_new=args.max_new)
    dt = time.time() - t0
    total = sum(len(v) for v in done.values())
    print(f"arch={cfg.name} (reduced) | {args.requests} requests over {args.slots} slots | "
          f"{total} tokens in {dt:.1f}s ({total / max(dt, 1e-9):.1f} tok/s, "
          f"{steps} batched decode steps)")
    for r in list(done)[:2]:
        print(f"request {r}: {done[r][:12]} ...")


if __name__ == "__main__":
    main()
