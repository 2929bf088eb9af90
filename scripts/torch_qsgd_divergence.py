#!/usr/bin/env python3
"""Where a QSGD(16) Fed-CHS run on one device first leaves the same run on
the CPU's plain path.

    PYTHONPATH=src python scripts/torch_qsgd_divergence.py            # the card
    PYTHONPATH=src python scripts/torch_qsgd_divergence.py --device cpu --nudge

The run is `chip_smoke.py` phase 3a's MLP cross-check (20 clients in 4
clusters, K = 10, E = 5, the drivers' default step), looped.  It prints,
after each round, the gap between the two runs' params over the CPU run's
update p_T - p_0; then, for every quantize-pack call of the longest run in
order (round, interaction, leaf), how far the two inputs are apart (largest
entry, relative to the CPU's largest), how many norms and payload words
differ, and how many of the device's own norms and payload words the plain
version gives otherwise on the device's input.  `--nudge` scales the first
run's initial weights by 1 + 2^-23, about an ulp, which is how far apart a
run on the CPU and itself are taken to be.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

import repro_torch.kernels.ops as ops
from repro_torch.comm.channels import QSGDChannel
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import assign_clusters, dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels.qsgd import qsgd_quantize_pack_plain
from repro_torch.models.classifier import make_classifier
from repro_torch.utils import tree_leaves, tree_map


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the first run's device (the card if unset)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--nudge", action="store_true",
                    help="scale the first run's initial weights by 1 + 2^-23")
    args = ap.parse_args(argv)

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    data = (ds, dirichlet_partition(ds.train_y, 20, 0.6, seed=0), assign_clusters(20, 4, seed=0))
    mlp = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    first = mlp
    if args.nudge:
        first = dataclasses.replace(mlp, init=lambda seed=0, device=None: tree_map(
            lambda t: t * (1 + 2**-23), mlp.init(seed, device)))
    p0 = flat(FLTask(mlp, *data, batch_size=32, seed=0, device="cpu").init_params())
    for rounds in range(1, args.rounds + 1):
        config = FedCHSConfig(rounds=rounds, local_steps=10, local_epochs=5, eval_every=2,
                              channel=QSGDChannel(16), scan_rounds=False)
        run, calls = recorded_run(
            FLTask(first, *data, batch_size=32, seed=0, device=args.device), config)
        ref, ref_calls = recorded_run(
            FLTask(mlp, *data, batch_size=32, seed=0, device="cpu"), config)
        a, b = flat(run.final_params), flat(ref.final_params)
        print(f"after round {rounds}: params gap {float((a - b).norm() / (b - p0).norm()):.3g} "
              f"of the update p_T - p_0")
    for i, ((v, keys, payload, norms, s), (rv, _, rpayload, rnorms, _)) in enumerate(
            zip(calls, ref_calls)):
        own_payload, own_norms = qsgd_quantize_pack_plain(v, keys, s)
        gap = float((v - rv).abs().max() / rv.abs().max().clamp(min=1e-30))
        print(f"  call {i} {tuple(v.shape)}: inputs apart by {gap:.3g} of the largest entry; "
              f"against the CPU run {int((norms != rnorms).sum())} norms and "
              f"{int((payload != rpayload).sum())} payload words differ; the plain version "
              f"on this input: {int((norms != own_norms).sum())} norms and "
              f"{int((payload != own_payload).sum())} payload words differ")


if __name__ == "__main__":
    main()
