"""Tour of repro_torch.netsim: from a bit ledger to wall-clock
time-to-accuracy, in the PyTorch port.  The torch twin of
`examples/netsim_tour.py`, with the same calls from `repro_torch`.

  PYTHONPATH=src python examples/torch_netsim_tour.py
  PYTHONPATH=src python examples/torch_netsim_tour.py --device cpu

The paper's §3.2 overhead model counts bits per hop — network-independent by
construction.  netsim adds the physical layer: link models per hop class,
per-node compute speeds, and a deterministic event-driven simulator that
replays a training run's recorded message stream into timestamps.  One
training run can be re-timed under any number of networks, including
time-varying IoV/LEO topologies and a latency-aware variant of the paper's
2-step scheduler.

Runs on the CUDA card unless `--device cpu`.  `--rounds-div n` divides the
rounds by n (a quick run).
"""
import argparse

from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs
from repro_torch.core.baselines import FedAvgConfig, run_fedavg
from repro_torch.core.dynamics import make_dynamic
from repro_torch.core.ledger import dense_message_bits
from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
from repro_torch.models.classifier import make_classifier
from repro_torch.netsim import edge_cloud_network, simulate_run, time_to_accuracy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds-div", type=int, default=1)
    args = ap.parse_args(argv)
    R20, R8 = max(1, 20 // args.rounds_div), max(1, 8 // args.rounds_div)
    rows: dict = {}

    # -- 1. a small non-IID task and two recorded training runs ------------
    ds = make_dataset("mnist", train_size=3000, test_size=600, seed=0)
    clients = dirichlet_partition(ds.train_y, num_clients=20, alpha=0.6, seed=0)
    clusters = assign_clusters(num_clients=20, num_clusters=4, seed=0)
    model = make_classifier("mlp", "mnist", ds.spec.image_shape, num_classes=10)
    task = FLTask(model, ds, clients, clusters, batch_size=32, seed=0, device=args.device)

    K = 10
    chs = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1))
    avg = run_fedavg(task, FedAvgConfig(rounds=R8, local_steps=K, eval_every=1))
    print(f"recorded {len(chs.ledger.events)} Fed-CHS messages, "
          f"{len(avg.ledger.events)} FedAvg messages")
    rows["runs"] = {"fed_chs_messages": len(chs.ledger.events),
                    "fedavg_messages": len(avg.ledger.events),
                    "fed_chs_acc": list(chs.test_acc), "fedavg_acc": list(avg.test_acc)}

    # -- 2. replay both runs through two very different networks -----------
    nets = {
        "edge_cloud (paper's sketch)": edge_cloud_network(seed=0),
        "wan_starved (PS 50x slower)": edge_cloud_network(seed=0, wan_mbps=2.0,
                                                          wan_latency_ms=80.0),
    }
    gamma = 0.9

    def fmt(t):  # time_to_accuracy returns None when gamma was never reached
        return "never" if t is None else f"{t:.1f}s"

    for name, net in nets.items():
        t_chs = time_to_accuracy(chs, simulate_run(task, chs, net, local_steps=K), gamma)
        t_avg = time_to_accuracy(avg, simulate_run(task, avg, net, local_steps=K), gamma)
        print(f"{name}: time-to-{gamma:.0%}  fed_chs={fmt(t_chs)}  fedavg={fmt(t_avg)}")
        rows[name] = {"fed_chs_t": t_chs, "fedavg_t": t_avg}
    print("-> same bits, different clocks: the winner is a property of the "
          "network, which bit counting alone cannot see.")

    # -- 3. stragglers hurt the parallel round more than the serial one ----
    strag = edge_cloud_network(seed=0, straggler_frac=0.1, heterogeneity=0.3,
                               straggler_slowdown=16.0)
    tl_chs = simulate_run(task, chs, strag, local_steps=K)
    tl_avg = simulate_run(task, avg, strag, local_steps=K)
    chs_rounds = [tl_chs.round_duration(t) for t in sorted(tl_chs.round_end)]
    avg_rounds = [tl_avg.round_duration(t) for t in sorted(tl_avg.round_end)]
    print(f"straggler net: fed_chs rounds {min(chs_rounds):.2f}-{max(chs_rounds):.2f}s "
          "(straggler-free clusters stay fast), fedavg rounds "
          f"{min(avg_rounds):.2f}-{max(avg_rounds):.2f}s (every round waits for "
          "the slowest of ALL clients)")
    rows["stragglers"] = {"fed_chs_rounds": chs_rounds, "fedavg_rounds": avg_rounds}

    # -- 4. time-varying links: a flaky IoV backhaul costs time, not bits --
    dyn = make_dynamic("iov", task.num_clusters, seed=1)
    iov = edge_cloud_network(seed=0, backhaul_mbps=20.0, dynamics=dyn)
    clean = edge_cloud_network(seed=0, backhaul_mbps=20.0)
    chs_dyn = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1,
                                             dynamic="iov", topology_seed=1))
    tl = simulate_run(task, chs_dyn, iov, local_steps=K)
    flat = simulate_run(task, chs_dyn, clean, local_steps=K)
    print(f"IoV fading (20 Mbps RSU backhaul): makespan {tl.makespan:.1f}s vs "
          f"{flat.makespan:.1f}s on clean links — identical ledger "
          f"({chs_dyn.ledger.total_megabytes():.0f} MB): flaky links cost "
          "time, not bits")
    rows["iov"] = {"makespan": tl.makespan, "clean_makespan": flat.makespan,
                   "total_mb": chs_dyn.ledger.total_megabytes(),
                   "acc": list(chs_dyn.test_acc)}

    # -- 5. the latency-aware 2-step scheduler routes around slow links ----
    # a full ES mesh leaves the least-traversed rule with frequent ties; the
    # paper breaks them by dataset size, the latency-aware variant by link
    # delay — on a backhaul with 1-10x per-pair spread that choice shows up
    # directly in the serial chain's wall-clock
    q = dense_message_bits(task.num_params())
    spread_net = edge_cloud_network(seed=0, backhaul_mbps=20.0, backhaul_spread=9.0)
    base = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1,
                                          topology="full"))
    lat = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1,
                                         topology="full",
                                         link_delay=spread_net.link_delay_fn(q)))
    t_base = simulate_run(task, base, spread_net, local_steps=K).makespan
    t_aware = simulate_run(task, lat, spread_net, local_steps=K).makespan
    print("heterogeneous backhaul (1-10x per-link delay, full mesh): 2-step "
          f"rule {t_base:.1f}s vs latency-aware tie-break {t_aware:.1f}s "
          f"(final acc {base.final_acc():.3f} vs {lat.final_acc():.3f})")
    rows["latency_aware"] = {"makespan": t_base, "aware_makespan": t_aware,
                             "acc": list(base.test_acc), "aware_acc": list(lat.test_acc)}
    return rows


if __name__ == "__main__":
    main()
