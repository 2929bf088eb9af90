"""The port's network/time simulator (`repro_torch.netsim`) against the
reference's, and its protocol timing contract.

Parity: one port run per algorithm (under churn where the algorithm takes a
sampler) is replayed through both packages' netsim, under the four
network scenarios of `benchmarks/fig_time_to_acc.py`, an IoV-dynamic
network, and a deadline.  Both are pure numpy over the same events, so the
job DAGs, `Timeline`s and `time_to_accuracy` are held equal, not close.
Fed-CHS with `link_delay` (the latency-aware 2-step rule) holds its ledger
and visit order exactly against the reference's looped driver.

The behaviour tests of the reference's `tests/test_netsim.py` are ported
below against the port alone: the serial chain, the parallel max, the
two-level barrier, deadlines, pass-through hops, and the bits-winner /
time-winner split.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.netsim as jnet
import repro_torch.netsim as tnet
from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core.dynamics import iov_gilbert as jax_iov_gilbert
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro_torch.core.baselines import (
    FedAvgConfig,
    HierLocalQSGDConfig,
    WRWGDConfig,
    run_fedavg,
    run_hier_local_qsgd,
    run_wrwgd,
)
from repro_torch.core.dynamics import iov_gilbert
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.ledger import CommLedger, dense_message_bits
from repro_torch.core.scheduler import LatencyAwareScheduler
from repro_torch.core.simulation import FLTask, RunResult
from repro_torch.core.topology import make_topology
from repro_torch.models.classifier import make_classifier
from repro_torch.netsim import (
    Job,
    edge_cloud_network,
    sgd_step_flops,
    simulate,
    simulate_run,
    time_to_accuracy,
    timeline_for,
)
from repro_torch.part import AvailabilityAware, BernoulliTrace, GilbertElliottTrace, UniformK
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

# the scenarios of benchmarks/fig_time_to_acc.py, built from either package
SCENARIOS = {
    "edge_cloud": lambda N: N.edge_cloud_network(seed=0),
    "wan_starved": lambda N: N.edge_cloud_network(seed=0, wan_mbps=2.0, wan_latency_ms=80.0),
    "compute_bound": lambda N: N.edge_cloud_network(
        seed=0, wireless_mbps=1e4, backhaul_mbps=1e5, wan_mbps=1e4, wan_latency_ms=1.0,
        flops_per_second=5e8),
    "straggler": lambda N: N.edge_cloud_network(
        seed=0, heterogeneity=0.4, straggler_frac=0.3, straggler_slowdown=16.0, jitter=0.1),
    "iov_dynamic": lambda N: N.edge_cloud_network(
        seed=2, jitter=0.2, dynamics=(iov_gilbert if N is tnet else jax_iov_gilbert)(
            5, p_drop=0.6, seed=1)),
}


@pytest.fixture(scope="module")
def task():
    """15 clients in 5 clusters, the port's own MLP."""
    from repro_torch.data.partition import assign_clusters as t_assign
    from repro_torch.data.partition import dirichlet_partition as t_partition
    from repro_torch.data.synthetic import make_dataset as t_dataset

    ds = t_dataset("mnist", train_size=1500, test_size=300, seed=0)
    clients = t_partition(ds.train_y, 15, 0.6, seed=0)
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    return FLTask(clf, ds, clients, t_assign(15, 5, seed=0), batch_size=16, seed=0,
                  device="cpu")


K = 4


@pytest.fixture(scope="module")
def runs(task):
    """One port run per algorithm, each with a sampler where it takes one."""
    ge = AvailabilityAware(GilbertElliottTrace(p_fail=0.3, p_recover=0.4, seed=5))
    return {
        "fed_chs": run_fed_chs(task, FedCHSConfig(
            rounds=8, local_steps=K, local_epochs=2, eval_every=2, seed=2, qsgd_levels=16,
            sampler=ge)),
        "fed_chs_grad": run_fed_chs(task, FedCHSConfig(rounds=4, local_steps=K,
                                                       eval_every=1)),
        "fedavg": run_fedavg(task, FedAvgConfig(rounds=3, local_steps=K, eval_every=1,
                                                sampler=UniformK(k=8, seed=1))),
        "hier_local_qsgd": run_hier_local_qsgd(task, HierLocalQSGDConfig(
            rounds=3, local_steps=K, local_epochs=2, eval_every=1,
            sampler=AvailabilityAware(BernoulliTrace(p=0.5, seed=3)))),
        "wrwgd": run_wrwgd(task, WRWGDConfig(rounds=10, local_steps=K, eval_every=2,
                                             sampler=AvailabilityAware(BernoulliTrace(0.5)))),
    }


def assert_timelines_equal(tl, jtl):
    assert dict(tl.job_times) == dict(jtl.job_times)
    assert tl.round_end == jtl.round_end
    assert tl.makespan == jtl.makespan
    assert tl.dropped == jtl.dropped
    assert tl.dropped_bits == jtl.dropped_bits


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("algo", ["fed_chs", "fed_chs_grad", "fedavg", "hier_local_qsgd",
                                  "wrwgd"])
def test_replay_matches_reference(task, runs, algo, scenario):
    res = runs[algo]
    tl = tnet.simulate_run(task, res, SCENARIOS[scenario](tnet), local_steps=K)
    jtl = jnet.simulate_run(task, res, SCENARIOS[scenario](jnet), local_steps=K)
    assert_timelines_equal(tl, jtl)
    jobs = tnet.build_jobs(res, SCENARIOS[scenario](tnet), local_steps=K,
                           batch_size=task.batch_size, num_params=task.num_params())
    jjobs = jnet.build_jobs(res, SCENARIOS[scenario](jnet), local_steps=K,
                            batch_size=task.batch_size, num_params=task.num_params())
    assert [dataclasses.astuple(j) for j in jobs] == [dataclasses.astuple(j) for j in jjobs]
    for gamma in (0.0, 0.3, res.best_acc(), 1.01):
        assert tnet.time_to_accuracy(res, tl, gamma) == jnet.time_to_accuracy(res, jtl, gamma)
    assert tl.round_duration(0) == jtl.round_duration(0)


@pytest.mark.parametrize("algo", ["fed_chs", "fedavg", "hier_local_qsgd"])
def test_deadline_replay_matches_reference(task, runs, algo):
    res = runs[algo]
    steps, link = {"fed_chs": (2, "wireless"), "fedavg": (K, "wan"),
                   "hier_local_qsgd": (2, "wireless")}[algo]
    q = dense_message_bits(task.num_params())
    flops = steps * sgd_step_flops(task.num_params(), task.batch_size)
    net, jnet_ = SCENARIOS["straggler"](tnet), SCENARIOS["straggler"](jnet)
    deadline = 3.0 * net.nominal_chain_s(link, q, flops)
    assert deadline == 3.0 * jnet_.nominal_chain_s(link, q, flops)
    _, tl = tnet.replay_run(res, net, local_steps=K, batch_size=task.batch_size,
                            num_params=task.num_params(), deadline_s=deadline)
    _, jtl = jnet.replay_run(res, jnet_, local_steps=K, batch_size=task.batch_size,
                             num_params=task.num_params(), deadline_s=deadline)
    assert_timelines_equal(tl, jtl)
    assert any(tl.dropped.values())
    assert tl.drop_counts() == jtl.drop_counts()
    gamma = res.best_acc()
    assert tnet.time_to_accuracy(res, tl, gamma) == jnet.time_to_accuracy(res, jtl, gamma)


def test_link_and_compute_models_match_reference():
    kw = dict(seed=7, heterogeneity=0.4, straggler_frac=0.5, straggler_slowdown=8.0,
              jitter=0.2, backhaul_spread=1.0)
    net, jn = tnet.edge_cloud_network(**kw), jnet.edge_cloud_network(**kw)
    nodes = [f"client:{i}" for i in range(30)] + [f"es:{m}" for m in range(6)] + ["ps"]
    for node in nodes:
        assert net.node_speed(node) == jn.node_speed(node)
        assert net.is_straggler(node) == jn.is_straggler(node)
        assert net.compute_time(node, 3e9, 4) == jn.compute_time(node, 3e9, 4)
    for hop, a, b in [("client_to_es", "client:3", "es:1"), ("es_to_es", "es:0", "es:4"),
                      ("client_to_ps", "client:9", "ps"), ("ps_to_es", "ps", "es:2"),
                      ("client_to_client", "client:1", "client:7")]:
        for t in range(5):
            assert net.transfer_time(hop, a, b, 1e6, t) == jn.transfer_time(hop, a, b, 1e6, t)
    for a in range(6):
        for b in range(6):
            assert net.backhaul_delay(a, b, 1e6) == jn.backhaul_delay(a, b, 1e6)
    assert tnet.sgd_step_flops(199210, 32) == jnet.sgd_step_flops(199210, 32)


# --------------------------------------------------------------------------
# Fed-CHS with link_delay, against the reference's looped driver
# --------------------------------------------------------------------------


def test_latency_aware_fed_chs_matches_reference():
    ds = make_dataset("mnist", train_size=1500, test_size=300, seed=0)
    clients = dirichlet_partition(ds.train_y, 15, 0.6, seed=0)
    clusters = assign_clusters(15, 5, seed=0)
    jclf = jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    jtask = JaxFLTask(jclf, ds, clients, clusters, batch_size=16, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=16, seed=0, device="cpu")
    q = dense_message_bits(task.num_params())
    kw = dict(rounds=10, local_steps=2, eval_every=5, seed=0, topology="full",
              schedule=lambda k: 0.05)
    jres = jax_run_fed_chs(jtask, JaxFedCHSConfig(
        scan_rounds=False, link_delay=jnet.edge_cloud_network(
            seed=0, backhaul_spread=1.0).link_delay_fn(q), **kw))
    res = run_fed_chs(task, FedCHSConfig(
        link_delay=tnet.edge_cloud_network(seed=0, backhaul_spread=1.0).link_delay_fn(q),
        **kw))
    assert res.ledger.events == jres.ledger.events
    assert res.ledger.history == jres.ledger.history
    np.testing.assert_allclose(
        np.concatenate([a.numpy().ravel() for a in tree_leaves(res.final_params)]),
        np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jres.final_params)]),
        atol=1e-6, rtol=0)
    # the latency-aware rule chose differently from the paper's plain rule
    plain = run_fed_chs(task, FedCHSConfig(**kw))
    hops = [e.receiver for e in res.ledger.events if e.hop == "es_to_es"]
    assert hops != [e.receiver for e in plain.ledger.events if e.hop == "es_to_es"]


# --------------------------------------------------------------------------
# behaviour (ported from tests/test_netsim.py), the port alone
# --------------------------------------------------------------------------


def test_simulator_resolves_deps_and_resource_contention():
    tl = simulate([
        Job(0, "compute", 2.0, "a"),
        Job(1, "compute", 3.0, "a"),
        Job(2, "transfer", 1.0, "a->b", (0, 1)),
        Job(3, "compute", 5.0, "b"),
    ])
    assert tl.job_times[0] == (0.0, 2.0)
    assert tl.job_times[1] == (2.0, 5.0)
    assert tl.job_times[2] == (5.0, 6.0)
    assert tl.job_times[3] == (0.0, 5.0)
    assert tl.makespan == 6.0


def test_simulator_is_deterministic():
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(200):
        n_deps = int(rng.integers(0, 3)) if i else 0
        deps = tuple(int(d) for d in rng.integers(0, i, size=n_deps))
        jobs.append(Job(i, "compute", float(rng.random()), f"r{int(rng.integers(6))}", deps))
    a, b = simulate(jobs), simulate(jobs)
    assert a.job_times == b.job_times and a.makespan == b.makespan


def test_timeline_time_until():
    tl = simulate([Job(0, "compute", 1.0, "a", (), 0), Job(1, "compute", 1.0, "a", (0,), 2)])
    assert tl.time_until(0) == 1.0
    assert tl.time_until(1) == 2.0
    assert tl.time_until(99) == tl.makespan


def test_network_model_determinism_and_straggler_effects():
    kw = dict(seed=7, heterogeneity=0.4, straggler_frac=0.5, straggler_slowdown=8.0, jitter=0.2)
    net, net2 = edge_cloud_network(**kw), edge_cloud_network(**kw)
    nodes = [f"client:{i}" for i in range(20)]
    for node in nodes:
        assert net.node_speed(node) == net2.node_speed(node)
        assert net.is_straggler(node) == net2.is_straggler(node)
    strag = next(n for n in nodes if net.is_straggler(n))
    fast = next(n for n in nodes if not net.is_straggler(n))
    assert net.transfer_time("client_to_es", strag, "es:0", 1e6, 0) > \
           net.transfer_time("client_to_es", fast, "es:0", 1e6, 0)


def test_dynamic_topology_degrades_flaky_backhaul():
    dyn = iov_gilbert(6, p_drop=0.6, seed=2)
    net = edge_cloud_network(seed=0, dynamics=dyn)
    base = net.backhaul.base_time(1e6)
    t = next(t for t in range(50) if dyn.dropped(t))
    a, b = sorted(next(iter(dyn.dropped(t))))
    assert net.transfer_time("es_to_es", f"es:{a}", f"es:{b}", 1e6, t) > base
    intact = next(e for e in [(m, m + 1) for m in range(5)]
                  if e not in dyn.dropped(t) and e[1] in dyn(t).neighbors(e[0]))
    assert net.transfer_time("es_to_es", f"es:{intact[0]}", f"es:{intact[1]}", 1e6, t) \
           == pytest.approx(base)


def test_fed_chs_round_time_is_the_serial_chain(task, runs):
    res, T = runs["fed_chs_grad"], 4
    net = edge_cloud_network(seed=0)
    tl = simulate_run(task, res, net, local_steps=K)
    d = task.num_params()
    q = dense_message_bits(d)
    t_comp = sgd_step_flops(d, task.batch_size) / net.compute.flops_per_second
    per_round = K * (2 * net.wireless.base_time(q) + t_comp) + net.backhaul.base_time(q)
    for t in range(T):
        assert tl.round_duration(t) == pytest.approx(per_round, rel=1e-9)
    assert tl.makespan == pytest.approx(T * per_round, rel=1e-9)


def test_fedavg_round_time_is_max_over_parallel_clients(task):
    res = run_fedavg(task, FedAvgConfig(rounds=2, local_steps=K, eval_every=10, seed=0))
    net = edge_cloud_network(seed=1, heterogeneity=0.5)
    tl = simulate_run(task, res, net, local_steps=K)
    d = task.num_params()
    q = dense_message_bits(d)
    flops = K * sgd_step_flops(d, task.batch_size)
    per_round = max(
        net.transfer_time("ps_to_client", "ps", f"client:{i}", q)
        + net.compute_time(f"client:{i}", flops)
        + net.transfer_time("client_to_ps", f"client:{i}", "ps", q)
        for i in range(task.num_clients))
    for t in range(2):
        assert tl.round_duration(t) == pytest.approx(per_round, rel=1e-9)


def test_hier_round_time_honors_two_level_barriers(task):
    E = 2
    res = run_hier_local_qsgd(task, HierLocalQSGDConfig(
        rounds=1, local_steps=K, local_epochs=E, eval_every=10, qsgd_levels=None, seed=0))
    net = edge_cloud_network(seed=0)
    tl = simulate_run(task, res, net, local_steps=K)
    d = task.num_params()
    q = dense_message_bits(d)
    t_edge = net.wireless.base_time(q) * 2 + \
        E * sgd_step_flops(d, task.batch_size) / net.compute.flops_per_second
    per_round = (K // E) * t_edge + 2 * net.wan.base_time(q)
    assert tl.round_duration(0) == pytest.approx(per_round, rel=1e-9)


def test_shared_ingress_scales_star_round_with_fan_in(task):
    res = run_fedavg(task, FedAvgConfig(rounds=1, local_steps=2, eval_every=10))
    shared = edge_cloud_network(seed=0)
    shared.shared_ingress = True
    t_ded = simulate_run(task, res, edge_cloud_network(seed=0), local_steps=2).makespan
    t_shared = simulate_run(task, res, shared, local_steps=2).makespan
    q = dense_message_bits(task.num_params())
    extra = (task.num_clients - 1) * (q / shared.wan.bandwidth_bps)
    assert t_shared > t_ded
    assert t_shared == pytest.approx(t_ded + extra, rel=1e-9)


def _nominal_chain_s(net, task, steps, link_class="wan"):
    q = dense_message_bits(task.num_params())
    return net.nominal_chain_s(link_class, q,
                               steps * sgd_step_flops(task.num_params(), task.batch_size))


def test_deadline_converts_stragglers_into_dropouts(task):
    T = 2
    res = run_fedavg(task, FedAvgConfig(rounds=T, local_steps=2, eval_every=10, seed=0))
    net = edge_cloud_network(seed=1, straggler_frac=0.3, straggler_slowdown=32.0)
    stragglers = {f"client:{i}" for i in range(task.num_clients)
                  if net.is_straggler(f"client:{i}")}
    assert stragglers and len(stragglers) < task.num_clients
    deadline = 2.0 * _nominal_chain_s(net, task, 2)
    plain = simulate_run(task, res, net, local_steps=2)
    tl = simulate_run(task, res, net, local_steps=2, deadline_s=deadline)
    assert tl.dropped == {t: frozenset(stragglers) for t in range(T)}
    assert tl.dropped_bits == len(stragglers) * T * dense_message_bits(task.num_params())
    for t in range(T):
        assert tl.round_duration(t) == pytest.approx(deadline)
    assert tl.makespan == pytest.approx(T * deadline) and tl.makespan < plain.makespan
    net_dl = edge_cloud_network(seed=1, straggler_frac=0.3, straggler_slowdown=32.0,
                                deadline_s=deadline)
    tl2 = simulate_run(task, res, net_dl, local_steps=2)
    assert tl2.dropped == tl.dropped and tl2.makespan == tl.makespan


def test_deadline_bounds_multi_phase_rounds(task):
    E = 2
    res = run_fed_chs(task, FedCHSConfig(rounds=3, local_steps=K, local_epochs=E,
                                         eval_every=10, seed=0))
    net = edge_cloud_network(seed=1, straggler_frac=0.3, straggler_slowdown=64.0)
    deadline = 2.0 * _nominal_chain_s(net, task, E, link_class="wireless")
    tl = simulate_run(task, res, net, local_steps=K, deadline_s=deadline)
    assert any(tl.dropped.values())
    hop = net.backhaul.base_time(dense_message_bits(task.num_params()))
    for t, dropped in tl.dropped.items():
        if dropped:
            assert tl.round_duration(t) == pytest.approx((K // E) * deadline + hop)


def test_deadline_dropout_replay_is_deterministic(task):
    def cfg():
        return FedCHSConfig(rounds=6, local_steps=4, local_epochs=2, eval_every=10, seed=2,
                            sampler=AvailabilityAware(
                                GilbertElliottTrace(p_fail=0.3, p_recover=0.4, seed=5)))

    a, b = run_fed_chs(task, cfg()), run_fed_chs(task, cfg())
    assert a.ledger.events == b.ledger.events
    net = edge_cloud_network(seed=4, heterogeneity=0.3, straggler_frac=0.3,
                             straggler_slowdown=12.0, jitter=0.1)
    deadline = 3.0 * _nominal_chain_s(net, task, 2, link_class="wireless")
    tls = [simulate_run(task, r, net, local_steps=4, deadline_s=deadline) for r in (a, b, a)]
    for tl in tls[1:]:
        assert_timelines_equal(tl, tls[0])
    assert any(tls[0].dropped.values())


class _Blackout:
    def participants(self, round_idx, clients):
        return [] if round_idx == 2 else list(clients)


def test_fed_chs_pass_through_round_replays_as_a_bare_hop(task):
    cfg = FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, eval_every=10, seed=0,
                       sampler=_Blackout())
    a, b = run_fed_chs(task, cfg), run_fed_chs(task, cfg)
    assert a.ledger.events == b.ledger.events
    net = edge_cloud_network(seed=0)
    tla, tlb = simulate_run(task, a, net, local_steps=4), simulate_run(task, b, net, local_steps=4)
    assert tla.job_times == tlb.job_times and tla.makespan == tlb.makespan
    q = dense_message_bits(task.num_params())
    assert tla.round_duration(2) == pytest.approx(net.backhaul.base_time(q))
    assert tla.round_duration(2) < tla.round_duration(1) / 10


def _fabricated_pair(d=1000):
    q = dense_message_bits(d)
    chs = CommLedger()
    for t in range(9):
        for i in (0, 1):
            chs.record("es_to_client", q, round=t, phase=0, sender="es:0",
                       receiver=f"client:{i}")
            chs.record("client_to_es", q, round=t, phase=0, sender=f"client:{i}",
                       receiver="es:0")
        chs.record("es_to_es", q, round=t, phase=1, sender="es:0", receiver="es:1")
        chs.snapshot(t)
    fed_chs = RunResult("fed_chs", list(range(9)), [0.5] * 8 + [0.9], [0.0] * 9, chs, None)
    avg = CommLedger()
    for t in range(3):
        for i in range(8):
            avg.record("ps_to_client", q, round=t, phase=0, sender="ps",
                       receiver=f"client:{i}")
            avg.record("client_to_ps", q, round=t, phase=0, sender=f"client:{i}",
                       receiver="ps")
        avg.snapshot(t)
    fedavg = RunResult("fedavg", list(range(3)), [0.5, 0.5, 0.9], [0.0] * 3, avg, None)
    return d, fed_chs, fedavg


def test_bits_winner_and_time_winner_can_differ():
    d, fed_chs, fedavg = _fabricated_pair()
    assert fed_chs.bits_to_accuracy(0.9) < fedavg.bits_to_accuracy(0.9)

    def t2a(res, net):
        tl = timeline_for(res, net, local_steps=1, batch_size=32, num_params=d)
        return time_to_accuracy(res, tl, 0.9)

    compute_bound = edge_cloud_network(seed=0, wireless_mbps=1e5, backhaul_mbps=1e5,
                                       wan_mbps=1e5, wan_latency_ms=0.0, flops_per_second=1e6)
    assert t2a(fedavg, compute_bound) < t2a(fed_chs, compute_bound)
    wan_starved = edge_cloud_network(seed=0, wireless_mbps=1000.0, backhaul_mbps=1000.0,
                                     wan_mbps=0.05, flops_per_second=1e12)
    assert t2a(fed_chs, wan_starved) < t2a(fedavg, wan_starved)


def test_latency_aware_scheduler_breaks_ties_by_link_delay():
    delays = {(0, 1): 5.0, (0, 2): 1.0, (0, 3): 3.0, (1, 2): 2.0, (1, 3): 9.0, (2, 3): 4.0}
    sched = LatencyAwareScheduler(make_topology("full", 4), [10, 20, 30, 40],
                                  lambda a, b: delays[(min(a, b), max(a, b))], initial=0)
    assert [sched.advance() for _ in range(3)] == [2, 1, 3]


def test_latency_aware_scheduler_via_fed_chs_config(task):
    q = dense_message_bits(task.num_params())
    cfg = FedCHSConfig(rounds=6, local_steps=2, eval_every=10, seed=0,
                       link_delay=edge_cloud_network(seed=0, backhaul_spread=1.0)
                       .link_delay_fn(q))
    a, b = run_fed_chs(task, cfg), run_fed_chs(task, cfg)
    assert a.ledger.events == b.ledger.events
    assert a.ledger.messages["es_to_es"] == 6
    assert a.ledger.bits["es_to_ps"] == 0


def test_time_to_accuracy_example_runs_on_the_cpu(tmp_path):
    """`examples/torch_time_to_accuracy.py` end to end at a tiny size: all
    four arms, and for each Γ either every network's seconds or none."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "tta.json"
    subprocess.run(
        [sys.executable, str(root / "examples" / "torch_time_to_accuracy.py"), "--device", "cpu",
         "--model", "mlp", "--clients", "10", "--clusters", "5", "--train-size", "1000",
         "--rounds", "2", "--eval-every", "1", "--gamma", "0.2", "1.01", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=str(root / "src")), check=True, timeout=600,
        capture_output=True)
    arms = json.loads(out.read_text())["arms"]
    assert set(arms) == {"fed_chs", "hier_local_qsgd", "fedavg", "wrwgd"}
    for row in arms.values():
        never = row["to_gamma"]["1.01"]
        assert never["rounds"] is None and never["bits"] is None
        assert set(never["seconds"].values()) == {None}
        low = row["to_gamma"]["0.2"]
        reached = low["rounds"] is not None
        for scen, secs in low["seconds"].items():
            assert (secs is not None) == reached
            assert secs is None or 0 < secs <= row["makespan_s"][scen]
