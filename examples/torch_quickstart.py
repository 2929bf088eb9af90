"""Quickstart in the PyTorch port: train a model with Fed-CHS on a non-IID
synthetic MNIST.  The torch twin of `examples/quickstart.py`, with the same
imports from `repro_torch`.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --rounds 10

Runs on the CUDA card unless `--device cpu`.
"""
import argparse

from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs
from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
from repro_torch.models.classifier import make_classifier


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    # 1. data: 20 clients with Dirichlet(0.6) label skew, 4 ES clusters
    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, num_clients=20, alpha=0.6, seed=0)
    clusters = assign_clusters(num_clients=20, num_clusters=4, seed=0)

    # 2. model: the paper's MLP
    model = make_classifier("mlp", "mnist", ds.spec.image_shape, num_classes=10)

    # 3. run Fed-CHS (Algorithm 1): sequential cluster-by-cluster training,
    #    no parameter server, 2-step next-cluster rule over a sparse ES graph
    task = FLTask(model, ds, clients, clusters, batch_size=32, seed=0, device=args.device)
    cfg = FedCHSConfig(rounds=args.rounds, local_steps=10, topology="random_sparse",
                       eval_every=5)
    result = run_fed_chs(task, cfg)

    print(f"accuracy trace : {[round(a, 3) for a in result.test_acc]}")
    print(f"final accuracy : {result.final_acc():.4f}")
    print(f"total comm     : {result.ledger.total_megabytes():.1f} MB")
    print(f"per-hop bits   : { {k: f'{v/8/1e6:.1f} MB' for k, v in result.ledger.breakdown().items()} }")
    print("note           : zero client<->PS and ES<->PS traffic — no PS exists.")


if __name__ == "__main__":
    main()
