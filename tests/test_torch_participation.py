"""The port's participation subsystem (`repro_torch.part`), its masked
engine round, and the four drivers under churn, against the reference.

Integer results are held exactly: every trace's availability, every
sampler's participant sets, the masks, and whole runs' ledgers (totals,
snapshots, every `CommEvent`), visit orders and per-client data draws.
Float results follow `tests/test_torch_fed_chs.py`: dense runs at atol
1e-6, runs through QSGD at 3% relative L2.  The reference runs its looped
drivers (`scan_rounds=False`); the port runs its default, the whole-run
executor, which tests/test_torch_scan.py holds to the port's looped drivers
bit for bit.

The behaviour tests of the reference's `tests/test_participation.py` are
ported below against the port alone: pass-through rounds, skipped rounds,
dark clusters and the availability-aware rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.part as jpart
import repro_torch.part as tpart
from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core import baselines as jb
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro.optim import local as jlocal
from repro_torch.comm.channels import DenseChannel, QSGDChannel, channel_wire_bits
from repro_torch.core import baselines as tb
from repro_torch.core import fed_chs as tfed_chs
from repro_torch.core.engine import RoundEngine
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.scheduler import AvailabilityAwareScheduler
from repro_torch.core.simulation import FLTask
from repro_torch.core.topology import make_topology
from repro_torch.models.classifier import make_classifier
from repro_torch.optim import local as tlocal
from repro_torch.part import (
    AlwaysOn,
    AvailabilityAware,
    BernoulliTrace,
    FullParticipation,
    GilbertElliottTrace,
    UniformK,
    is_full_participation,
    participation_mask,
)
from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)


CLUSTERS = assign_clusters(15, 5, seed=0)


@pytest.fixture(scope="module")
def tasks():
    """15 clients in 5 clusters; the same data, partition and initial
    weights on both sides."""
    ds = make_dataset("mnist", train_size=1500, test_size=300, seed=0)
    clients = dirichlet_partition(ds.train_y, 15, 0.6, seed=0)
    clusters = CLUSTERS
    jclf = jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    jtask = JaxFLTask(jclf, ds, clients, clusters, batch_size=16, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=16, seed=0, device="cpu")
    return jtask, task, p0


def flat(leaves):
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


def assert_runs_match(jtask, task, jres, res, tol):
    """Ledgers, eval rounds and data draws exact; params and traces at
    `tol` ("dense": atol 1e-6, "lossy": 3% relative L2)."""
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits)
    assert dict(tl.messages) == dict(jl.messages)
    assert tl.history == jl.history
    assert tl.events == jl.events
    assert res.rounds == jres.rounds
    assert task.source.draw_counts == list(jtask.source.draw_counts)
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    if tol == "lossy":
        assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.test_acc, jres.test_acc,
                               atol=0.02 if tol == "lossy" else 2 / 300)
    np.testing.assert_allclose(res.train_loss, jres.train_loss,
                               rtol=0.05 if tol == "lossy" else 1e-5)
    # nan only before the first trained round
    assert np.isfinite(res.train_loss[-1])


class Blackout:
    """Everyone is down in the `dark` rounds; everyone is up otherwise.
    Duck-typed, so the same object drives both packages."""

    def __init__(self, dark):
        self.dark = set(dark)

    def participants(self, round_idx, clients):
        return [] if round_idx in self.dark else list(clients)


def both(sampler):
    """(reference, port) samplers: `sampler(P)` builds one from a package's
    `part` module; a duck-typed sampler object drives both sides as it is."""
    if hasattr(sampler, "participants"):
        return sampler, sampler
    return sampler(jpart), sampler(tpart)


class ClusterDark:
    """The clients of `members` are always down; everyone else is up."""

    def __init__(self, members):
        self.members = set(members)

    def participants(self, round_idx, clients):
        return [c for c in clients if c not in self.members]


# --------------------------------------------------------------------------
# traces and samplers, held exactly against the reference
# --------------------------------------------------------------------------

TRACES = [
    ("always_on", lambda P: P.AlwaysOn()),
    ("bernoulli", lambda P: P.BernoulliTrace(p=0.7, seed=3)),
    ("gilbert_elliott", lambda P: P.GilbertElliottTrace(p_fail=0.25, p_recover=0.35, seed=5)),
    ("gilbert_elliott_off", lambda P: P.GilbertElliottTrace(0.3, 0.2, seed=1, start_on=False)),
]


@pytest.mark.parametrize("make", [t[1] for t in TRACES], ids=[t[0] for t in TRACES])
def test_trace_availability_matches_reference(make):
    jt, tt = make(jpart), make(tpart)
    grid = [(c, t) for c in range(20) for t in range(60)]
    assert [tt.available(c, t) for c, t in grid] == [jt.available(c, t) for c, t in grid]
    # asked in another order, a fresh copy answers the same
    fresh = make(tpart)
    assert [fresh.available(c, t) for c, t in reversed(grid)][::-1] == \
           [jt.available(c, t) for c, t in grid]


SAMPLERS = [
    ("full", lambda P: P.FullParticipation()),
    ("aware_bernoulli", lambda P: P.AvailabilityAware(P.BernoulliTrace(p=0.6, seed=2))),
    ("aware_ge", lambda P: P.AvailabilityAware(P.GilbertElliottTrace(0.25, 0.35, seed=5))),
    ("uniform_k", lambda P: P.UniformK(k=3, seed=4)),
    ("uniform_k_trace", lambda P: P.UniformK(k=2, seed=1, trace=P.BernoulliTrace(0.7, 9))),
]


@pytest.mark.parametrize("make", [s[1] for s in SAMPLERS], ids=[s[0] for s in SAMPLERS])
def test_sampler_participants_match_reference(make):
    js, ts = make(jpart), make(tpart)
    candidate_sets = [list(range(10)), [3, 7, 11, 12], [5], [], list(range(20, 35))]
    for clients in candidate_sets:
        for t in range(40):
            assert ts.participants(t, clients) == js.participants(t, clients)
    assert tpart.is_full_participation(ts) == jpart.is_full_participation(js)
    members = list(range(10))
    parts = tpart.schedule_participants(ts, 12, members)
    assert parts == jpart.schedule_participants(js, 12, members)
    np.testing.assert_array_equal(tpart.stack_masks(members, parts, width=13),
                                  jpart.stack_masks(members, parts, width=13))


def test_participation_mask_matches_reference():
    for members, part in [([10, 11, 12, 13], [11, 13]), ([1, 2], []), ([4], [4])]:
        got = tpart.participation_mask(members, part)
        want = jpart.participation_mask(members, part)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tpart.is_full_participation(None) and jpart.is_full_participation(None)


# --------------------------------------------------------------------------
# the masked engine round
# --------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [None, 16])
def test_masked_cluster_round_matches_reference(tasks, levels):
    """One masked delta round with a momentum client, from a warm optimizer
    state: params, losses and the frozen state against the reference."""
    jtask, task, p0 = tasks
    m, K, E = 0, 4, 2
    members = task.cluster_members[m]
    n = len(members)
    assert n >= 3
    pmask = np.zeros(n, np.float32)
    pmask[[0, 2]] = 1.0
    w = task.cluster_weights(m) * pmask
    gammas = (w / w.sum()).astype(np.float32)
    lrs = np.full((K // E, E), 0.05, np.float32)
    subs = None if levels is None else np.arange(2 * K // E, dtype=np.uint32).reshape(-1, 2)
    jtask.reset_loaders(0)
    task.reset_loaders(0)
    jbatch, batch = jtask.sample_round_batches(m, K, E), task.sample_round_batches(m, K, E)
    from repro.comm.channels import make_channel as jmake
    from repro_torch.comm.channels import make_channel as tmake

    jengine = JaxRoundEngine(jtask.model, jmake(levels), local_opt=jlocal.MomentumSGD(0.9))
    engine = RoundEngine(task.model, tmake(levels), local_opt=tlocal.MomentumSGD(0.9))
    # a warm optimizer state, the same random draw on both sides
    rng = np.random.default_rng(0)
    jzeros = jengine.init_opt_state(jax.tree.map(jnp.asarray, p0), n)
    state = [rng.normal(size=a.shape).astype(np.float32) for a in jax.tree.leaves(jzeros)]
    jstate0 = jax.tree.unflatten(jax.tree.structure(jzeros), [jnp.asarray(a) for a in state])
    _, treedef = tree_flatten(engine.init_opt_state(params_from_jax(p0, "cpu"), n))
    tstate0 = tree_unflatten(treedef, [torch.from_numpy(a.copy()) for a in state])
    jp, jstate, jl = jengine.cluster_round(
        jax.tree.map(jnp.asarray, p0), jbatch, jnp.asarray(gammas), jnp.asarray(lrs),
        None if subs is None else jnp.asarray(subs), jstate0, mask=pmask)
    tp, tstate, tl = engine.cluster_round(
        params_from_jax(p0, "cpu"), batch, torch.from_numpy(gammas), lrs, subs, tstate0,
        mask=pmask)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    got, want = flat(tree_leaves(tp)), flat(jax.tree.leaves(jp))
    if levels:
        assert (np.abs(got - want) > 1e-6).mean() <= 5e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for s0, j, t in zip(state, jax.tree.leaves(jstate), tree_leaves(tstate)):
        for i in np.flatnonzero(pmask == 0):  # dropped slots keep their state
            np.testing.assert_array_equal(t[i].numpy(), s0[i])
        if not levels:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_unmasked_round_is_the_all_ones_mask_round(tasks):
    """mask=None and an all-ones mask compute the same round, bit for bit."""
    _, task, p0 = tasks
    m, K, E = 1, 4, 2
    n = len(task.cluster_members[m])
    gammas = torch.from_numpy(task.cluster_weights(m))
    lrs = np.full((K // E, E), 0.05, np.float32)
    task.reset_loaders(0)
    batch = task.sample_round_batches(m, K, E)
    engine = RoundEngine(task.model, QSGDChannel(16))
    subs = np.arange(2 * K // E, dtype=np.uint32).reshape(-1, 2)
    a, _, la = engine.cluster_round(params_from_jax(p0, "cpu"), batch, gammas, lrs, subs)
    b, _, lb = engine.cluster_round(params_from_jax(p0, "cpu"), batch, gammas, lrs, subs,
                                    mask=np.ones(n, np.float32))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(la, lb)


def _warm_engine_state(task, local_opt=None, channel=None):
    engine = RoundEngine(task.model, channel or DenseChannel(), local_opt=local_opt)
    task.reset_loaders(0)
    n = len(task.cluster_members[0])
    params = task.init_params()
    gammas = torch.from_numpy(task.cluster_weights(0))
    lrs = np.full((2, 2), 0.05, np.float32)
    batch = task.sample_round_batches(0, 4, 2)
    opt0 = engine.init_opt_state(params, n)
    # one full round so the optimizer state is nonzero before masking
    params, opt1, _ = engine.cluster_round(params, batch, gammas, lrs, None, opt0)
    return engine, params, opt1, gammas, lrs, n


def test_masked_round_freezes_dropped_opt_state(tasks):
    task = tasks[1]
    engine, params, opt1, gammas, lrs, n = _warm_engine_state(
        task, local_opt=tlocal.MomentumSGD())
    mask = np.zeros(n, np.float32)
    mask[[0, 2]] = 1.0
    w = gammas.numpy() * mask
    batch = task.sample_round_batches(0, 4, 2)
    _, opt2, _ = engine.cluster_round(params, batch, torch.from_numpy(w / w.sum()), lrs, None,
                                      opt1, mask=mask)
    for before, after in zip(tree_leaves(opt1), tree_leaves(opt2)):
        for i in range(n):
            if mask[i]:
                assert not torch.equal(after[i], before[i])
            else:
                assert torch.equal(after[i], before[i])


def test_all_zero_mask_is_a_no_op_on_params(tasks):
    task = tasks[1]
    engine, params, opt1, gammas, lrs, n = _warm_engine_state(task)
    batch = task.sample_round_batches(0, 4, 2)
    new_params, _, losses = engine.cluster_round(
        params, batch, torch.zeros_like(gammas), lrs, None, opt1, mask=np.zeros(n, np.float32))
    for a, b in zip(tree_leaves(params), tree_leaves(new_params)):
        assert torch.equal(a, b)
    assert not losses.any()


# --------------------------------------------------------------------------
# whole runs under churn, against the reference's looped drivers
# --------------------------------------------------------------------------


def run_pair(tasks, jrun, trun, jcls, tcls, sampler, local_opt=None, **kw):
    """The reference's looped driver and the port's on the same config;
    `local_opt` names an optimizer class of both packages' `optim.local`."""
    jtask, task, _ = tasks
    js, ts = both(sampler)
    jkw, tkw = dict(kw), dict(kw)
    if local_opt is not None:
        jkw["local_opt"] = getattr(jlocal, local_opt[0])(*local_opt[1:])
        tkw["local_opt"] = getattr(tlocal, local_opt[0])(*local_opt[1:])
    jres = jrun(jtask, jcls(scan_rounds=False, sampler=js, **jkw))
    tcfg = tcls(sampler=ts, **tkw)
    res = trun(task, tcfg)
    lossy = getattr(tcfg, "qsgd_levels", None) is not None
    assert_runs_match(jtask, task, jres, res, "lossy" if lossy else "dense")
    return res, ts


BERNOULLI = lambda P: P.AvailabilityAware(P.BernoulliTrace(p=0.6, seed=3))  # noqa: E731
GILBERT = lambda P: P.AvailabilityAware(P.GilbertElliottTrace(0.25, 0.35, seed=5))  # noqa: E731
FED_CHS = [
    ("uniform_k", lambda P: P.UniformK(k=2, seed=1), dict(local_epochs=2)),
    ("bernoulli_e1", BERNOULLI, dict(local_epochs=1)),
    ("gilbert_qsgd", GILBERT, dict(local_epochs=2, qsgd_levels=16)),
    ("gilbert_scheduler_momentum", GILBERT,
     dict(local_epochs=2, availability_scheduler=True, local_opt=("MomentumSGD", 0.9),
          schedule=lambda k: 0.02)),
    ("blackout_qsgd", Blackout({1, 2}), dict(local_epochs=2, qsgd_levels=16)),
    ("full_participation", lambda P: P.FullParticipation(), dict(schedule=lambda k: 0.05)),
]


@pytest.mark.parametrize("sampler,kw", [c[1:] for c in FED_CHS], ids=[c[0] for c in FED_CHS])
def test_fed_chs_under_churn_matches_reference(tasks, sampler, kw):
    res, ts = run_pair(tasks, jax_run_fed_chs, run_fed_chs, JaxFedCHSConfig, FedCHSConfig,
                       sampler, rounds=5, local_steps=4, eval_every=2, **kw)
    # each round's uplink senders are exactly the active cluster's participants
    J = 4 // kw.get("local_epochs", 1)
    for t, events in res.ledger.round_events().items():
        (hop,) = [e for e in events if e.hop == "es_to_es"]
        members = tasks[1].cluster_members[int(hop.sender.split(":")[1])]
        ups = [e.sender for e in events if e.hop == "client_to_es"]
        assert sorted(ups) == sorted(J * [f"client:{i}" for i in ts.participants(t, members)])


FEDAVG = [
    ("uniform_k", lambda P: P.UniformK(k=6, seed=2), dict()),
    ("bernoulli_qsgd_momentum", lambda P: P.AvailabilityAware(P.BernoulliTrace(0.6, seed=1)),
     dict(qsgd_levels=16, local_opt=("MomentumSGD", 0.5))),
    ("blackout", Blackout({1}), dict()),
]


@pytest.mark.parametrize("sampler,kw", [c[1:] for c in FEDAVG], ids=[c[0] for c in FEDAVG])
def test_fedavg_under_churn_matches_reference(tasks, sampler, kw):
    run_pair(tasks, jb.run_fedavg, tb.run_fedavg, jb.FedAvgConfig, tb.FedAvgConfig, sampler,
             rounds=3, local_steps=3, eval_every=1, schedule=lambda k: 0.05, **kw)


WRWGD = [
    ("bernoulli", lambda P: P.AvailabilityAware(P.BernoulliTrace(p=0.5, seed=4))),
    ("gilbert_elliott", lambda P: P.AvailabilityAware(P.GilbertElliottTrace(0.4, 0.3, seed=2))),
    ("uniform_k", lambda P: P.UniformK(k=1, seed=0, trace=P.BernoulliTrace(0.6, seed=8))),
]


@pytest.mark.parametrize("sampler", [c[1] for c in WRWGD], ids=[c[0] for c in WRWGD])
def test_wrwgd_under_churn_matches_reference(tasks, sampler):
    res, ts = run_pair(tasks, jb.run_wrwgd, tb.run_wrwgd, jb.WRWGDConfig, tb.WRWGDConfig,
                       sampler, rounds=14, local_steps=3, eval_every=4,
                       schedule=lambda t: 0.05 / np.sqrt(t + 1))
    hops = [(e.sender, e.receiver) for e in res.ledger.events]
    assert len(hops) == 14 and all(a[1] == b[0] for a, b in zip(hops, hops[1:]))
    # a visit trains (K draws) only where its client is up that round
    up = [bool(ts.participants(t, [int(a.split(":")[1])])) for t, (a, _) in enumerate(hops)]
    assert sum(tasks[1].source.draw_counts) == 3 * sum(up)


HIER = [
    ("bernoulli", BERNOULLI, dict(qsgd_levels=None)),
    ("uniform_k_qsgd", lambda P: P.UniformK(k=2, seed=5), dict()),
    ("cluster_dark_momentum", ClusterDark(CLUSTERS[1]),
     dict(qsgd_levels=None, local_opt=("MomentumSGD", 0.9))),
    ("blackout_qsgd", Blackout({0}), dict(rounds=3)),
]


@pytest.mark.parametrize("sampler,kw", [c[1:] for c in HIER], ids=[c[0] for c in HIER])
def test_hier_local_qsgd_under_churn_matches_reference(tasks, sampler, kw):
    res, _ = run_pair(tasks, jb.run_hier_local_qsgd, tb.run_hier_local_qsgd,
                      jb.HierLocalQSGDConfig, tb.HierLocalQSGDConfig, sampler,
                      **{"rounds": 2, "local_steps": 4, "local_epochs": 2, "eval_every": 1, **kw})
    assert res.ledger.messages["ps_to_es"] == 5 * len(
        {e.round for e in res.ledger.events if e.hop == "ps_to_es"})


# --------------------------------------------------------------------------
# behaviour (ported from tests/test_participation.py), the port alone
# --------------------------------------------------------------------------


def test_bernoulli_trace_is_deterministic_and_rate_correct():
    a, b = BernoulliTrace(p=0.7, seed=3), BernoulliTrace(p=0.7, seed=3)
    draws = [a.available(c, t) for c in range(10) for t in range(50)]
    assert draws == [b.available(c, t) for c in range(10) for t in range(50)]
    assert 0.6 < np.mean(draws) < 0.8
    c = BernoulliTrace(p=0.7, seed=4)
    assert draws != [c.available(cl, t) for cl in range(10) for t in range(50)]


def test_gilbert_elliott_is_query_order_independent():
    fwd = GilbertElliottTrace(p_fail=0.2, p_recover=0.3, seed=1)
    bwd = GilbertElliottTrace(p_fail=0.2, p_recover=0.3, seed=1)
    rounds = list(range(40))
    assert [fwd.available(2, t) for t in rounds] == \
           [bwd.available(2, t) for t in reversed(rounds)][::-1]


def test_gilbert_elliott_produces_bursts_not_blips():
    tr = GilbertElliottTrace(p_fail=0.3, p_recover=0.25, seed=0)
    T = 400
    states = [tr.available(0, t) for t in range(T)]
    down = states.count(False)
    spells = sum(1 for t in range(1, T) if not states[t] and states[t - 1])
    assert down > 0.2 * T and spells < down
    assert abs(states.count(True) / T - tr.steady_state_up()) < 0.15


def test_sampler_contracts():
    clients = [3, 1, 4, 1, 5, 9, 2, 6]
    assert FullParticipation().participants(0, clients) == clients
    assert is_full_participation(None) and is_full_participation(FullParticipation())
    assert not is_full_participation(AvailabilityAware(AlwaysOn()))
    assert AvailabilityAware(AlwaysOn()).participants(7, clients) == clients
    uk = UniformK(k=3, seed=0)
    picks = uk.participants(5, list(range(10)))
    assert picks == uk.participants(5, list(range(10)))
    assert len(set(picks)) == 3 and set(picks) <= set(range(10))
    assert uk.participants(6, list(range(10))) != picks or \
           uk.participants(7, list(range(10))) != picks
    assert uk.participants(0, [1, 2]) == [1, 2]
    tr = BernoulliTrace(p=0.5, seed=2)
    uk_tr = UniformK(k=4, seed=0, trace=tr)
    for t in range(20):
        picked = uk_tr.participants(t, list(range(12)))
        assert all(tr.available(c, t) for c in picked) and len(picked) <= 4


def test_uniform_k_draws_independently_per_candidate_set():
    uk = UniformK(k=3, seed=0)
    assert any(uk.participants(t, list(range(7)))
               != [c - 10 for c in uk.participants(t, list(range(10, 17)))]
               for t in range(10))


def test_participation_mask():
    np.testing.assert_array_equal(participation_mask([10, 11, 12, 13], [11, 13]),
                                  np.array([0.0, 1.0, 0.0, 1.0], np.float32))


def test_availability_scheduler_skips_dead_clusters():
    sched = AvailabilityAwareScheduler(make_topology("full", 4), [10, 40, 20, 30],
                                       lambda m, r: m != 1, initial=0)
    order = [sched.advance() for _ in range(8)]
    assert set(order) == {0, 2, 3}


def test_availability_scheduler_falls_back_when_all_dead():
    sched = AvailabilityAwareScheduler(make_topology("ring", 3), [10, 20, 30],
                                       lambda m, r: False, initial=0)
    assert sched.advance() in (1, 2)


def test_availability_scheduler_probes_next_round():
    seen = []

    def reachable(m, r):
        seen.append(r)
        return True

    AvailabilityAwareScheduler(make_topology("full", 3), [1, 2, 3], reachable,
                               initial=0).advance()
    assert set(seen) == {1}


def test_fed_chs_pass_through_round_forwards_model_and_spends_nothing(tasks, monkeypatch):
    """A dark round: only the ES->ES hop, no data draw, no key, params
    bit-equal to the round before.  The looped driver splits J keys per
    trained round; the scanned one (the default) draws the same keys in one
    chain over the trained rounds, J x 3, none for the dark round."""
    task = tasks[1]
    calls = []
    real = tfed_chs.split_chain
    monkeypatch.setattr(tfed_chs, "split_chain",
                        lambda key, n: calls.append(n) or real(key, n))
    cfg = FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, eval_every=1, seed=0,
                       qsgd_levels=16, sampler=Blackout({1}))
    looped = run_fed_chs(task, dataclasses.replace(cfg, scan_rounds=False))
    assert calls == [2, 2, 2]  # one split of J = 2 keys per trained round
    calls.clear()
    res = run_fed_chs(task, cfg)
    assert calls == [2 * 3]  # one chain over the 3 trained rounds
    assert res.ledger.events == looped.ledger.events
    evs = res.ledger.round_events()
    assert {e.hop for e in evs[1]} == {"es_to_es"}
    assert res.ledger.round_bits("client_to_es").get(1, 0) == 0
    visited = [int(e.sender.split(":")[1]) for e in res.ledger.events if e.hop == "es_to_es"]
    trained = [m for t, m in enumerate(visited) if t != 1]
    want = {i: 0 for i in range(task.num_clients)}
    for m in trained:
        for i in task.cluster_members[m]:
            want[i] += 4
    assert task.source.draw_counts == [want[i] for i in range(task.num_clients)]
    assert len(res.test_acc) == 4 and res.test_acc[1] == res.test_acc[0]


def test_fed_chs_partial_round_drops_exactly_the_absent(tasks):
    task = tasks[1]
    sampler = AvailabilityAware(BernoulliTrace(p=0.5, seed=11))
    res = run_fed_chs(task, FedCHSConfig(rounds=5, local_steps=4, local_epochs=2,
                                         eval_every=10, seed=1, initial_cluster=0,
                                         sampler=sampler))
    expect = {f"client:{i}" for i in sampler.participants(0, task.cluster_members[0])}
    assert res.ledger.round_senders(0, "client_to_es") == expect


def test_fed_chs_availability_scheduler_avoids_dark_clusters(tasks):
    task = tasks[1]
    dark = 2
    res = run_fed_chs(task, FedCHSConfig(
        rounds=8, local_steps=2, local_epochs=1, eval_every=10, seed=0, initial_cluster=0,
        topology="full", sampler=ClusterDark(task.cluster_members[dark]),
        availability_scheduler=True))
    hops = {x for e in res.ledger.events if e.hop == "es_to_es" for x in (e.sender, e.receiver)}
    assert f"es:{dark}" not in hops
    assert all(res.ledger.round_bits("client_to_es")[t] > 0 for t in range(8))


def test_fedavg_empty_round_is_skipped(tasks):
    task = tasks[1]
    res = tb.run_fedavg(task, tb.FedAvgConfig(rounds=3, local_steps=2, eval_every=1, seed=0,
                                              sampler=Blackout({1})))
    assert 1 not in {e.round for e in res.ledger.events}
    assert res.ledger.messages["client_to_ps"] == 2 * task.num_clients
    assert [r for r, _ in res.ledger.history] == [0, 1, 2]


def test_hier_dark_cluster_is_pass_through(tasks):
    task = tasks[1]
    dark = 1
    res = tb.run_hier_local_qsgd(task, tb.HierLocalQSGDConfig(
        rounds=2, local_steps=4, local_epochs=2, qsgd_levels=None, eval_every=1, seed=0,
        sampler=ClusterDark(task.cluster_members[dark])))
    ups = {e.sender for e in res.ledger.events if e.hop == "es_to_ps"}
    downs = {e.receiver for e in res.ledger.events if e.hop == "ps_to_es"}
    assert f"es:{dark}" not in ups and f"es:{dark}" in downs
    client_ups = {e.sender for e in res.ledger.events if e.hop == "client_to_es"}
    assert not client_ups & {f"client:{i}" for i in task.cluster_members[dark]}
    assert res.ledger.messages["ps_to_es"] == 2 * task.num_clusters


def test_hier_dark_cluster_keeps_trajectory_of_reweighted_rest(tasks):
    task = tasks[1]
    res = tb.run_hier_local_qsgd(task, tb.HierLocalQSGDConfig(
        rounds=1, local_steps=2, local_epochs=2, qsgd_levels=None, eval_every=1, seed=3,
        sampler=ClusterDark(task.cluster_members[0])))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(res.final_params), tree_leaves(task.init_params())))


def test_stochastic_channel_churn_is_reproducible(tasks):
    task = tasks[1]

    def cfg():
        return FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, eval_every=2, seed=2,
                            channel=QSGDChannel(8), sampler=AvailabilityAware(
                                GilbertElliottTrace(p_fail=0.3, p_recover=0.4, seed=6)))

    a, b = run_fed_chs(task, cfg()), run_fed_chs(task, cfg())
    assert a.ledger.events == b.ledger.events
    assert a.test_acc == b.test_acc and a.train_loss == b.train_loss


def test_channel_message_bits_unchanged_by_masking(tasks):
    task = tasks[1]
    res = run_fed_chs(task, FedCHSConfig(rounds=3, local_steps=4, local_epochs=2,
                                         eval_every=10, seed=0, qsgd_levels=16,
                                         sampler=AvailabilityAware(BernoulliTrace(0.6, 0))))
    q = channel_wire_bits(QSGDChannel(16), task.num_params(), task.param_leaf_sizes())
    ups = [e for e in res.ledger.events if e.hop == "client_to_es"]
    assert ups and all(e.n_bits == q for e in ups)
