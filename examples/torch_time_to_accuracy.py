"""Time to accuracy of the four algorithms, trained by the PyTorch port.

Trains Fed-CHS, Hier-Local-QSGD, FedAvg and WRWGD once each at the paper's
Appendix-A scale (LeNet-MNIST, 100 clients in 10 clusters, Dirichlet 0.6,
batch 32, K = 20 local steps, E = 5 per upload for the two hierarchical
algorithms, QSGD(16) uplinks where the paper compresses), then replays each
run's message ledger through the port's network simulator under the four
network scenarios of `benchmarks/fig_time_to_acc.py`.  Prints, per
algorithm, the rounds, bits and simulated seconds to each test accuracy Γ,
and its training time on the device.  Rounds to Γ are read at the eval
rounds, so `--eval-every 1` reads them exactly.

  PYTHONPATH=src python examples/torch_time_to_accuracy.py [--rounds 200] [--gamma 0.8 0.9]

Runs on the CUDA card; `--device cpu --model mlp --clients 20 --clusters 5
--train-size 4000 --rounds 4` is a quick check on the CPU.  `--out` writes
every number as JSON.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.baselines import (
    FedAvgConfig,
    HierLocalQSGDConfig,
    WRWGDConfig,
    run_fedavg,
    run_hier_local_qsgd,
    run_wrwgd,
)
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import assign_clusters, dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.models.classifier import make_classifier
from repro_torch.netsim import edge_cloud_network, simulate_run, time_to_accuracy

# the network scenarios of benchmarks/fig_time_to_acc.py (seeded, deterministic)
SCENARIOS = {
    "edge_cloud": lambda: edge_cloud_network(seed=0),
    "wan_starved": lambda: edge_cloud_network(seed=0, wan_mbps=2.0, wan_latency_ms=80.0),
    "compute_bound": lambda: edge_cloud_network(seed=0, wireless_mbps=1e4, backhaul_mbps=1e5,
                                                wan_mbps=1e4, wan_latency_ms=1.0,
                                                flops_per_second=5e8),
    "straggler": lambda: edge_cloud_network(seed=0, heterogeneity=0.4, straggler_frac=0.3,
                                            straggler_slowdown=16.0, jitter=0.1),
}
K, E = 20, 5  # paper B.1: K = 20 local iterations, 5 per upload


def arms(rounds: int, eval_every: int):
    return {
        "fed_chs": (run_fed_chs, FedCHSConfig(rounds=rounds, local_steps=K, local_epochs=E,
                                              eval_every=eval_every, qsgd_levels=16)),
        "hier_local_qsgd": (run_hier_local_qsgd, HierLocalQSGDConfig(
            rounds=rounds, local_steps=K, local_epochs=E, eval_every=eval_every,
            qsgd_levels=16)),
        "fedavg": (run_fedavg, FedAvgConfig(rounds=rounds, local_steps=K,
                                            eval_every=eval_every)),
        "wrwgd": (run_wrwgd, WRWGDConfig(rounds=rounds, local_steps=K, eval_every=eval_every)),
    }


def train(task: FLTask, run, config, cuda: bool) -> tuple:
    """(result, seconds, peak device GB) of one run, ended by a synchronize."""
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(task, config)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return res, secs, torch.cuda.max_memory_allocated() / 1e9 if cuda else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200, help="rounds per algorithm (paper: 200)")
    ap.add_argument("--gamma", type=float, nargs="+", default=[0.80],
                    help="target test accuracies Γ")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--model", default="lenet", choices=["lenet", "mlp"])
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--clusters", type=int, default=10)
    ap.add_argument("--train-size", type=int, default=60_000)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = ap.parse_args()

    ds = make_dataset("mnist", train_size=args.train_size, test_size=10_000, seed=0)
    clients = dirichlet_partition(ds.train_y, args.clients, 0.6, seed=0)
    clusters = assign_clusters(args.clients, args.clusters, seed=0)
    model = make_classifier(args.model, "mnist", ds.spec.image_shape, 10)
    task = FLTask(model, ds, clients, clusters, batch_size=32, seed=0, device=args.device)
    cuda = task.device.type == "cuda"
    device = torch.cuda.get_device_name(task.device) if cuda else "cpu"
    print(f"{args.model}-MNIST, Dirichlet(0.6), {args.clients} clients, {args.clusters} ES, "
          f"K={K}, E={E}, {task.num_params()} params, {args.rounds} rounds each, on {device}")

    out = {"device": device, "rounds": args.rounds, "eval_every": args.eval_every, "arms": {}}
    for name, (run, config) in arms(args.rounds, args.eval_every).items():
        res, secs, peak = train(task, run, config, cuda)
        timelines = {scen: simulate_run(task, res, make_net(), local_steps=K)
                     for scen, make_net in SCENARIOS.items()}
        row = {"s_per_round": secs / args.rounds, "train_s": secs, "peak_gb": peak,
               "final_acc": res.final_acc(), "best_acc": res.best_acc(),
               "total_bits": res.ledger.total_bits(),
               "makespan_s": {scen: tl.makespan for scen, tl in timelines.items()},
               "acc_trace": list(zip(res.rounds, res.test_acc)), "to_gamma": {}}
        for gamma in args.gamma:
            row["to_gamma"][str(gamma)] = {
                "rounds": res.rounds_to_accuracy(gamma), "bits": res.bits_to_accuracy(gamma),
                "seconds": {scen: time_to_accuracy(res, tl, gamma)
                            for scen, tl in timelines.items()}}
        out["arms"][name] = row
        peak_s = "" if peak is None else f", peak {peak:.2f} GB"
        print(f"{name:16s} {row['s_per_round']:.3f} s/round{peak_s}; final acc "
              f"{row['final_acc']:.4f} (best {row['best_acc']:.4f})", flush=True)

    def fmt(v, spec=".2f"):
        return f"{v:>16{spec}}" if v is not None else f"{'-':>16s}"

    names = list(out["arms"])
    for gamma in args.gamma:
        to = {n: out["arms"][n]["to_gamma"][str(gamma)] for n in names}
        print(f"\nTo Γ = {gamma}: rounds, megabits, and simulated seconds per network "
              "('-' = not reached)")
        print(f"{'':16s} " + " ".join(f"{n:>16s}" for n in names))
        print(f"{'rounds':16s} " + " ".join(fmt(to[n]["rounds"], "d") for n in names))
        print(f"{'megabits':16s} " + " ".join(
            fmt(None if to[n]["bits"] is None else to[n]["bits"] / 1e6) for n in names))
        for scen in SCENARIOS:
            print(f"{scen:16s} " + " ".join(fmt(to[n]["seconds"][scen]) for n in names))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
