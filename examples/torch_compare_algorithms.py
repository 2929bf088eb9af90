"""Fed-CHS vs the paper's three baselines on one non-IID task, in the PyTorch
port: accuracy AND communication cost side-by-side (the paper's Table 1 +
Fig. 2 in miniature), plus a Fed-CHS arm over the Top-K sparsifying
channel.  The torch twin of `examples/compare_algorithms.py`, with the same
calls from `repro_torch`.

  PYTHONPATH=src python examples/torch_compare_algorithms.py [--lam 0.3]
  PYTHONPATH=src python examples/torch_compare_algorithms.py --device cpu

Runs on the CUDA card unless `--device cpu`.  `--rounds-div n` divides
every arm's rounds and evaluation interval by n (a quick run).
"""
import argparse

from repro_torch.comm import TopKChannel
from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs
from repro_torch.core.baselines import (
    FedAvgConfig, HierLocalQSGDConfig, WRWGDConfig,
    run_fedavg, run_hier_local_qsgd, run_wrwgd,
)
from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
from repro_torch.models.classifier import make_classifier


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lam", type=float, default=0.3, help="Dirichlet concentration")
    ap.add_argument("--dataset", default="mnist", choices=["mnist", "cifar10", "cifar100"])
    ap.add_argument("--model", default="mlp", choices=["mlp", "lenet"])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds-div", type=int, default=1)
    args = ap.parse_args(argv)

    def r(n):  # rounds and eval intervals, cut by --rounds-div
        return max(1, n // args.rounds_div)

    ds = make_dataset(args.dataset, train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, args.lam, seed=0)
    clusters = assign_clusters(20, 5, seed=0)
    model = make_classifier(args.model, args.dataset, ds.spec.image_shape, ds.spec.num_classes)
    task = FLTask(model, ds, clients, clusters, batch_size=32, seed=0, device=args.device)

    runs = {
        "Fed-CHS": run_fed_chs(task, FedCHSConfig(rounds=r(24), local_steps=10,
                                                  eval_every=r(6))),
        "FedAvg": run_fedavg(task, FedAvgConfig(rounds=r(6), local_steps=10, eval_every=r(2))),
        "WRWGD": run_wrwgd(task, WRWGDConfig(rounds=r(48), local_steps=10, eval_every=r(12))),
        "Hier-Local-QSGD": run_hier_local_qsgd(
            task, HierLocalQSGDConfig(rounds=r(4), local_steps=10, local_epochs=5,
                                      eval_every=r(1))
        ),
        "Fed-CHS (Top-5%)": run_fed_chs(
            task, FedCHSConfig(rounds=r(24), local_steps=10, local_epochs=5, eval_every=r(6),
                               channel=TopKChannel(0.05))
        ),
    }
    print(f"\n{args.dataset}/{args.model}, Dirichlet({args.lam}) — 20 clients, 5 ES")
    print(f"{'algorithm':18s} {'final_acc':>9s} {'total_MB':>9s} {'PS traffic MB':>14s}")
    rows = {}
    for name, res in runs.items():
        ps = (res.ledger.bits["es_to_ps"] + res.ledger.bits["ps_to_es"]
              + res.ledger.bits["client_to_ps"] + res.ledger.bits["ps_to_client"]) / 8 / 1e6
        print(f"{name:18s} {res.final_acc():9.4f} {res.ledger.total_megabytes():9.1f} "
              f"{ps:14.1f}")
        rows[name] = {"test_acc": list(res.test_acc), "total_mb": res.ledger.total_megabytes(),
                      "ps_mb": ps, "bits": dict(res.ledger.bits),
                      "messages": dict(res.ledger.messages)}
    return rows


if __name__ == "__main__":
    main()
