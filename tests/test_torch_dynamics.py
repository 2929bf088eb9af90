"""The port's dynamic ES topologies (`repro_torch.core.dynamics`) and
Fed-CHS on them, against the reference.

The LEO and IoV graphs are held exactly: every edge set and every IoV
drop set for rounds 0..50.  Whole Fed-CHS runs on a dynamic graph hold
their ledgers and visit order exactly, and the visit order equals the
scheduler's own replay, `precompute(dynamic=...)`; params are held at
atol 1e-6 (dense) as in `tests/test_torch_fed_chs.py`.  The behaviour
tests of the reference's `tests/test_dynamics.py` are ported below
against the port alone.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core import dynamics as jdyn
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro_torch.core import dynamics as tdyn
from repro_torch.core.dynamics import iov_gilbert, leo_constellation, make_dynamic
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.scheduler import FedCHSScheduler
from repro_torch.core.simulation import FLTask
from repro_torch.core.topology import make_topology
from repro_torch.models.classifier import make_classifier
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ROUNDS = range(51)


def edges(topo):
    return {(a, b) for a in range(topo.num_nodes) for b in topo.neighbors(a) if a < b}


@pytest.mark.parametrize("n,window,period", [(5, 1, 1), (8, 2, 1), (10, 2, 3), (11, 3, 2)])
def test_leo_edge_sets_match_reference(n, window, period):
    got = leo_constellation(n, window=window, period=period)
    want = jdyn.leo_constellation(n, window=window, period=period)
    for t in ROUNDS:
        assert edges(got(t)) == edges(want(t))
        assert got(t).adjacency == want(t).adjacency


@pytest.mark.parametrize("n,p,seed", [(4, 0.3, 0), (8, 0.5, 4), (10, 0.3, 1), (13, 0.9, 7)])
def test_iov_edge_and_drop_sets_match_reference(n, p, seed):
    got, want = iov_gilbert(n, p_drop=p, seed=seed), jdyn.iov_gilbert(n, p_drop=p, seed=seed)
    for t in ROUNDS:
        assert edges(got(t)) == edges(want(t))
        assert got.dropped(t) == want.dropped(t)


@pytest.mark.parametrize("kind", ["leo", "iov"])
@pytest.mark.parametrize("n", [5, 10])
def test_make_dynamic_matches_reference(kind, n):
    got, want = make_dynamic(kind, n, seed=3), jdyn.make_dynamic(kind, n, seed=3)
    for t in ROUNDS:
        assert got(t).adjacency == want(t).adjacency
    with pytest.raises(ValueError):
        tdyn.make_dynamic("mesh", n)


# --------------------------------------------------------------------------
# Fed-CHS on a dynamic graph, against the reference's looped driver
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tasks():
    """15 clients in 5 clusters; the same data, partition and initial
    weights on both sides."""
    ds = make_dataset("mnist", train_size=1500, test_size=300, seed=0)
    clients = dirichlet_partition(ds.train_y, 15, 0.6, seed=0)
    clusters = assign_clusters(15, 5, seed=0)
    jclf = jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    jtask = JaxFLTask(jclf, ds, clients, clusters, batch_size=16, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=16, seed=0, device="cpu")
    return jtask, task, p0


def visits(res):
    hops = [e for e in res.ledger.events if e.hop == "es_to_es"]
    return [int(hops[0].sender.split(":")[1])] + [int(e.receiver.split(":")[1]) for e in hops]


@pytest.mark.parametrize("kind,kw", [
    ("iov", dict()), ("leo", dict()), ("iov", dict(local_epochs=2, topology_seed=3)),
], ids=["iov_grad", "leo_grad", "iov_delta"])
def test_fed_chs_on_dynamic_graph_matches_reference(tasks, kind, kw):
    jtask, task, _ = tasks
    kw = dict(rounds=12, local_steps=4, eval_every=4, dynamic=kind,
              schedule=lambda k: 0.05, **kw)
    jres = jax_run_fed_chs(jtask, JaxFedCHSConfig(scan_rounds=False, **kw))
    res = run_fed_chs(task, FedCHSConfig(**kw))
    assert res.ledger.events == jres.ledger.events
    assert res.ledger.history == jres.ledger.history
    np.testing.assert_allclose(
        np.concatenate([a.numpy().ravel() for a in tree_leaves(res.final_params)]),
        np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jres.final_params)]),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-5)
    # the visit order is the scheduler's own replay of the dynamic graph
    dyn = make_dynamic(kind, task.num_clusters, seed=kw.get("topology_seed", 0))
    m0 = visits(res)[0]
    sched = FedCHSScheduler(dyn(0), task.cluster_sizes, initial=m0)
    assert visits(res) == list(sched.precompute(13, dynamic=dyn))


# --------------------------------------------------------------------------
# behaviour (ported from tests/test_dynamics.py), the port alone
# --------------------------------------------------------------------------


def test_leo_graphs_valid_connected_and_rotating():
    for n in (5, 9, 16):
        dyn = leo_constellation(n, window=2, period=1)
        for t in range(0, 101, 7):
            g = dyn(t)
            g.validate()
            assert g.is_connected()
            assert dyn(t).adjacency == dyn(t + n).adjacency


def test_iov_stays_connected_after_repair_many_seeds_and_rounds():
    for seed in range(6):
        for n, p in [(4, 0.5), (9, 0.7), (13, 0.9)]:
            dyn = iov_gilbert(n, p_drop=p, seed=seed)
            for t in range(25):
                g = dyn(t)
                g.validate()
                assert g.is_connected(), (seed, n, p, t)


def test_iov_dropped_set_is_replayable_and_consistent():
    dyn = iov_gilbert(8, p_drop=0.5, seed=4)
    base = {(m, m + 1) for m in range(7)} | {(m, m + 2) for m in range(6)}
    for t in range(20):
        dropped = dyn.dropped(t)
        assert dropped == iov_gilbert(8, p_drop=0.5, seed=4).dropped(t)
        assert dropped <= base
        for a, b in base - dropped:
            assert b in dyn(t).neighbors(a)


def test_leo_rotation_invariants():
    for n, window, period in [(6, 2, 1), (9, 2, 3), (11, 3, 2)]:
        dyn = leo_constellation(n, window=window, period=period)
        for t in range(2 * n):
            g = dyn(t)
            degs = {g.degree(m) for m in range(n)}
            assert len(degs) == 1 and 2 <= degs.pop() <= 2 * window
            for m in range(n):
                rotated = tuple(sorted((v + 1) % n for v in g.neighbors(m)))
                assert rotated == g.neighbors((m + 1) % n)
        assert dyn(0).adjacency == dyn(n * period).adjacency
        assert dyn(0).adjacency != dyn(period).adjacency


def test_set_topology_determinism_across_swaps():
    n = 8
    dyn = make_dynamic("iov", n, seed=5)
    sizes = list(range(10, 10 + n))
    a = FedCHSScheduler(dyn(0), sizes, initial=2)
    b = FedCHSScheduler(dyn(0), sizes, initial=2)
    walk_a, walk_b = [], []
    for t in range(60):
        a.set_topology(dyn(t))
        b.set_topology(dyn(t))
        walk_a.append(a.advance())
        walk_b.append(b.advance())
    assert walk_a == walk_b
    assert np.array_equal(a.state.visit_counts, b.state.visit_counts)
    before = a.peek()
    a.set_topology(make_topology("ring", n))
    a.set_topology(dyn(59))
    assert a.peek() == before


@pytest.mark.parametrize("kind", ["leo", "iov"])
def test_scheduler_no_starvation_under_dynamics(kind):
    n = 8
    dyn = make_dynamic(kind, n, seed=1)
    sched = FedCHSScheduler(dyn(0), list(range(10, 10 + n)), initial=0)
    T = 40 * n
    for t in range(T):
        sched.set_topology(dyn(t))
        sched.advance()
    assert sched.state.visit_counts.min() >= T // (10 * n)


def test_fed_chs_converges_on_dynamic_topology(tasks):
    """Fed-CHS trains through a rotating LEO constellation: one ES->ES hop
    a round, no PS traffic, the accuracy climbing well above chance."""
    task = tasks[1]
    res = run_fed_chs(task, FedCHSConfig(rounds=16, local_steps=10, eval_every=8,
                                         dynamic="leo", seed=0))
    assert res.final_acc() > 0.5, res.test_acc
    assert res.ledger.messages["es_to_es"] == 16
    assert res.ledger.bits["es_to_ps"] == 0 and res.ledger.bits["client_to_ps"] == 0
