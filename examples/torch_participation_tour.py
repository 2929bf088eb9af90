"""Guided tour of the participation subsystem in the PyTorch port
(`repro_torch.part`).  The torch twin of `examples/participation_tour.py`,
with the same calls from `repro_torch`.

Runs Fed-CHS three ways on the same non-IID task and fixed seed:
  1. full participation (the bit-identical default path),
  2. bursty Gilbert-Elliott churn with an availability-aware sampler,
  3. the same churn with the availability-aware scheduler, so the 2-step
     rule itself routes around dark clusters;
then replays (2) through netsim with a per-interaction reporting deadline:
stragglers get dropped (bits saved), the aggregator waits (time wasted).

  PYTHONPATH=src python examples/torch_participation_tour.py
  PYTHONPATH=src python examples/torch_participation_tour.py --device cpu

Runs on the CUDA card unless `--device cpu`.  `--rounds-div n` divides the
rounds and the evaluation interval by n (a quick run).
"""
from __future__ import annotations

import argparse

from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs
from repro_torch.core.ledger import dense_message_bits
from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
from repro_torch.models.classifier import make_classifier
from repro_torch.netsim import edge_cloud_network, sgd_step_flops, simulate_run
from repro_torch.part import AvailabilityAware, GilbertElliottTrace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds-div", type=int, default=1)
    args = ap.parse_args(argv)

    ds = make_dataset("mnist", train_size=3000, test_size=800, seed=0)
    clients = dirichlet_partition(ds.train_y, 15, 0.6, seed=0)
    clusters = assign_clusters(15, 5, seed=0)
    model = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    task = FLTask(model, ds, clients, clusters, batch_size=32, seed=0, device=args.device)

    T, K, E = max(1, 30 // args.rounds_div), 8, 2
    every = max(1, 5 // args.rounds_div)
    trace = GilbertElliottTrace(p_fail=0.25, p_recover=0.35, seed=5)
    sampler = AvailabilityAware(trace)
    print(f"Gilbert-Elliott churn: steady-state up fraction "
          f"{trace.steady_state_up():.2f}, mean outage "
          f"{1 / trace.p_recover:.1f} rounds\n")

    arms = {
        "full participation": FedCHSConfig(rounds=T, local_steps=K,
                                           local_epochs=E, eval_every=every, seed=0),
        "churn": FedCHSConfig(rounds=T, local_steps=K, local_epochs=E,
                              eval_every=every, seed=0, sampler=sampler),
        "churn + availability scheduler": FedCHSConfig(
            rounds=T, local_steps=K, local_epochs=E, eval_every=every, seed=0,
            sampler=sampler, availability_scheduler=True),
    }
    results, rows = {}, {}
    for name, cfg in arms.items():
        res = run_fed_chs(task, cfg)
        results[name] = res
        up = res.ledger.round_bits("client_to_es")
        dark = len([t for t in range(T) if up.get(t, 0) == 0])
        print(f"{name:32s} final acc {res.final_acc():.3f}  "
              f"uplink {res.ledger.bits['client_to_es'] / 8e6:7.1f} MB  "
              f"pass-through rounds {dark}")
        rows[name] = {"test_acc": list(res.test_acc), "uplink_mb":
                      res.ledger.bits["client_to_es"] / 8e6, "pass_through": dark,
                      "bits": dict(res.ledger.bits), "messages": dict(res.ledger.messages)}

    # the deadline replay: same churn run, straggler-heavy edge network
    net = edge_cloud_network(seed=2, heterogeneity=0.3, straggler_frac=0.25,
                             straggler_slowdown=16.0)
    d, q = task.num_params(), dense_message_bits(task.num_params())
    nominal = net.nominal_chain_s("wireless", q,
                                  E * sgd_step_flops(d, task.batch_size))
    churn = results["churn"]
    no_dl = simulate_run(task, churn, net, local_steps=K)
    with_dl = simulate_run(task, churn, net, local_steps=K,
                           deadline_s=3.0 * nominal)
    n_dropped = sum(len(s) for s in with_dl.dropped.values())
    print("\nnetsim replay of the churn run (straggler edge):")
    print(f"  no deadline:   makespan {no_dl.makespan:8.1f} s")
    print(f"  3x-nominal deadline: makespan {with_dl.makespan:8.1f} s, "
          f"{n_dropped} client-rounds dropped, "
          f"{with_dl.dropped_bits / 8e6:.1f} MB of uplink saved")
    print("\nDropouts saved bits AND time here because the dropped chains were"
          "\n16x stragglers; the aggregator still waited out each deadline.")
    rows["netsim"] = {"makespan": no_dl.makespan, "deadline_makespan": with_dl.makespan,
                      "dropped": n_dropped, "dropped_mb": with_dl.dropped_bits / 8e6}
    return rows


if __name__ == "__main__":
    main()
