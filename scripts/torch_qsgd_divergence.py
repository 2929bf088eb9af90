#!/usr/bin/env python3
"""Where a QSGD(16) Fed-CHS run on one device first leaves the same run on
the CPU's plain path.

    PYTHONPATH=src python scripts/torch_qsgd_divergence.py            # the card
    PYTHONPATH=src python scripts/torch_qsgd_divergence.py --device cpu --nudge
    PYTHONPATH=src python scripts/torch_qsgd_divergence.py --lm dbrx-132b --rounds 1
    PYTHONPATH=src python scripts/torch_qsgd_divergence.py --lm dbrx-132b --rounds 1 \
        --nudge --ref-device cuda                                     # the card's twin

The run is `chip_smoke.py` phase 3a's MLP cross-check (20 clients in 4
clusters, K = 10, E = 5, the drivers' default step), looped; with `--lm
ARCH`, the smoke LM run of its phases 3k-c to 3m-c (`chip_smoke.lm_task`,
FED_LM_SOURCE, FED_LM_K, FED_LM_E, FED_LM_LR), which also prints how many
expert choices a forward pass of the initial weights makes otherwise on
each client's first batch.  It prints, after each round, the gap between
the two runs' params over the second run's update p_T - p_0; then, for
every quantize-pack call of the longest run in order (round, interaction,
leaf; with `--lm` only those where something differs, then the totals),
how far the two inputs are apart (largest entry, relative to the second
run's largest), how many norms and codes differ, and how many of the
first device's own norms and codes the plain version gives otherwise on
its input.  `--nudge` scales the first run's initial weights by 1 +
2^-23, about an ulp, which is how far apart a run and itself are taken to
be (`--nudge K`: 1 + K 2^-23); the second run is on `--ref-device` (the
CPU if unset).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

import repro_torch.kernels.ops as ops
from repro_torch.comm.channels import QSGDChannel
from repro_torch.configs.registry import smoke_config
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import assign_clusters, dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels.qsgd import qsgd_quantize_pack_plain
from repro_torch.kernels.ref import qsgd_code_bits, unpack_codes_ref
from repro_torch.models import ffn
from repro_torch.models.classifier import make_classifier
from repro_torch.utils import resolve_device, tree_leaves, tree_map

ULP = 2.0**-23


def flat(params) -> torch.Tensor:
    return torch.cat([t.reshape(-1).double().cpu() for t in tree_leaves(params)])


def recorded_run(task: FLTask, config: FedCHSConfig):
    """The run's result and, per quantize-pack call, (input, keys, payload,
    norms, levels) on the CPU."""
    calls, launch = [], ops.qsgd_quantize_pack

    def record(v, keys, s):
        payload, norms = launch(v, keys, s)
        calls.append(tuple(t.detach().cpu() for t in (v, keys, payload, norms)) + (s,))
        return payload, norms

    ops.qsgd_quantize_pack = record
    try:
        return run_fed_chs(task, config), calls
    finally:
        ops.qsgd_quantize_pack = launch


def codes(payload: torch.Tensor, s: int) -> torch.Tensor:
    return unpack_codes_ref(payload.reshape(-1, payload.shape[-1]), qsgd_code_bits(s))


def expert_choices(task: FLTask, params) -> list[torch.Tensor]:
    """The (expert, slot) token picks of every MoE layer in a forward pass
    of `params` over each client's first batch, on the CPU."""
    picks, top_k = [], ffn.top_k

    def record(x, k):
        v, i = top_k(x, k)
        picks.append(i.detach().cpu())
        return v, i

    src = task.source
    drawn = list(src.draw_counts)
    src.reset(0)
    batches = [src.next_batch(c) for c in range(src.num_clients)]
    src.fast_forward(drawn)
    ffn.top_k = record
    try:
        with torch.no_grad():
            for b in batches:
                task.fed_model.loss(params, {k: torch.from_numpy(v).to(task.device)
                                             for k, v in b.items()})
    finally:
        ffn.top_k = top_k
    return picks


def lm_tasks(arch: str, device, ref_device, nudge: float):
    """3k-c's smoke LM task on `device` (weights nudged if asked) and on
    `ref_device`."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    cfg = smoke_config(arch)
    first = cs.lm_task(cfg, device=device, scale=1 + nudge * ULP, **cs.FED_LM_SOURCE)
    second = cs.lm_task(cfg, device=ref_device, **cs.FED_LM_SOURCE)

    def config(rounds):
        return FedCHSConfig(rounds=rounds, local_steps=cs.FED_LM_K, local_epochs=cs.FED_LM_E,
                            eval_every=1, channel=QSGDChannel(16), seed=0, scan_rounds=False,
                            schedule=lambda k: cs.FED_LM_LR)
    return first, second, config


def mlp_tasks(device, ref_device, nudge: float):
    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    data = (ds, dirichlet_partition(ds.train_y, 20, 0.6, seed=0), assign_clusters(20, 4, seed=0))
    mlp = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    first = mlp
    if nudge:
        first = dataclasses.replace(mlp, init=lambda seed=0, device=None: tree_map(
            lambda t: t * (1 + nudge * ULP), mlp.init(seed, device)))

    def config(rounds):
        return FedCHSConfig(rounds=rounds, local_steps=10, local_epochs=5, eval_every=2,
                            channel=QSGDChannel(16), scan_rounds=False)
    return (FLTask(first, *data, batch_size=32, seed=0, device=device),
            FLTask(mlp, *data, batch_size=32, seed=0, device=ref_device), config)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the first run's device (the card if unset)")
    ap.add_argument("--ref-device", default="cpu", help="the second run's device")
    ap.add_argument("--lm", default=None, help="a smoke LM (3k-c: dbrx-132b) for the MLP")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--nudge", type=float, nargs="?", const=1.0, default=0.0,
                    help="scale the first run's initial weights by 1 + NUDGE 2^-23 (1 if "
                         "given without a value)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.lm:
        first, second, config = lm_tasks(args.lm, args.device, args.ref_device, args.nudge)
        got = expert_choices(first, first.init_params())
        want = expert_choices(second, second.init_params())
        moved = [sum(int((~torch.isin(x, y)).sum()) for x, y in zip(
            a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]))) for a, b in zip(got, want)]
        print(f"{args.lm}: the initial weights' forward pass over every client's first batch: "
              f"{sum(moved)} of {sum(b.numel() for b in want)} expert picks go to other "
              f"tokens, by layer call {moved}")
    else:
        first, second, config = mlp_tasks(args.device, args.ref_device, args.nudge)
    p0 = flat(second.init_params())
    for rounds in range(1, args.rounds + 1):
        run, calls = recorded_run(first, config(rounds))
        ref, ref_calls = recorded_run(second, config(rounds))
        a, b = flat(run.final_params), flat(ref.final_params)
        print(f"after round {rounds}: params gap {float((a - b).norm() / (b - p0).norm()):.3g} "
              f"of the update p_T - p_0")
    n_codes = n_diff = n_norms = 0
    for i, ((v, keys, payload, norms, s), (rv, _, rpayload, rnorms, _)) in enumerate(
            zip(calls, ref_calls)):
        own_payload, own_norms = qsgd_quantize_pack_plain(v, keys, s)
        gap = float((v - rv).abs().max() / rv.abs().max().clamp(min=1e-30))
        c, d = codes(payload, s), int((codes(payload, s) != codes(rpayload, s)).sum())
        n_codes, n_diff, n_norms = n_codes + c.numel(), n_diff + d, n_norms + int(
            (norms != rnorms).sum())
        if args.lm and not d and gap == 0:
            continue
        print(f"  call {i} {tuple(v.shape)}: inputs apart by {gap:.3g} of the largest entry; "
              f"against the second run {int((norms != rnorms).sum())} norms and {d} codes "
              f"differ; the plain version on this input: {int((norms != own_norms).sum())} "
              f"norms and {int((codes(payload, s) != codes(own_payload, s)).sum())} codes "
              f"differ")
    print(f"{len(calls)} quantize-pack calls: {n_diff} of {n_codes} codes and {n_norms} norms "
          f"differ from the second run's")


if __name__ == "__main__":
    main()
