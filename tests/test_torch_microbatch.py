"""Client microbatching (`RoundEngine(client_microbatch=...)` and the
drivers' `client_microbatch`) in the port against the reference package, at
``precision=None``.

The clusters are uneven (9, 6 and 5 clients), so groups of 2 or 4 leave a
padded tail group: padded slots carry zero gamma and a zero mask, train on
slot-0 replicas, and are sliced off.

  * Grad mode: the microbatched round against the reference's at the port's
    grad-mode tolerance (atol 1e-6), and against the port's own vmapped
    round at the same tolerance; it is not held to bit identity, which the
    reference itself fails (`test_microbatch_grad_mode_bit_parity`).
  * Delta mode: at mb = n the group is the whole cluster and the round is
    bit-equal to the vmapped one; at mb < n only the order of the
    aggregate's sum changes, held at the reference's own atol 3e-6 on params
    and state and 1e-6 on losses (`tests/test_engine_parity.py`).
  * Keys: each sender of a group is keyed by its global slot, so QSGD
    payloads are exact against the reference's for the same deltas, whatever
    the group width.
  * Whole runs of the four drivers: ledgers, events and visit order exact;
    params by the rules of `tests/test_torch_baselines.py` (dense atol 1e-6,
    lossy channels 3% relative L2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import part as jpart
from repro.comm import channels as jch
from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import baselines as jb
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.core.engine import compress_uplinks as jax_compress_uplinks
from repro.core.engine import split_chain as jax_split_chain
from repro.data import dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro.optim import local as jlocal
from repro_torch import part as tpart
from repro_torch.comm import channels as tch
from repro_torch.core import baselines as tb
from repro_torch.core.engine import RoundEngine, compress_uplinks
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.prng import PRNGKey, fold_in, split_chain
from repro_torch.core.simulation import FLTask
from repro_torch.models.classifier import make_classifier
from repro_torch.optim import local as tlocal
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tasks():
    """The same data, partition, uneven clusters and initial weights on both
    sides."""
    ds = make_dataset("mnist", train_size=2000, test_size=500, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    perm = np.random.default_rng(3).permutation(20).tolist()
    clusters = [sorted(perm[:9]), sorted(perm[9:15]), sorted(perm[15:])]
    jclf = jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    jtask = JaxFLTask(jclf, ds, clients, clusters, batch_size=16, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=16, seed=0, device="cpu")
    return jtask, task, p0


def flat(leaves):
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


def jparams(p0):
    return jax.tree.map(jnp.asarray, p0)


def width(mb, n):
    return n if mb == "n" else mb


# --------------------------------------------------------------------------
# grad mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mb", [1, 2, 3, "n"])
def test_microbatched_grad_round_matches_reference(tasks, mb):
    jtask, task, p0 = tasks
    m, K = 0, 4
    n = len(task.cluster_members[m])
    mb = width(mb, n)
    jtask.reset_loaders(0)
    task.reset_loaders(0)
    jbatch, batch = jtask.sample_cluster_batches(m, K), task.sample_cluster_batches(m, K)
    gammas = task.cluster_weights(m)
    lrs = np.linspace(0.2, 0.05, K).astype(np.float32)
    jp, jl = JaxRoundEngine(jtask.model, client_microbatch=mb).grad_round(
        jparams(p0), jbatch, jnp.asarray(gammas), jnp.asarray(lrs))
    params = params_from_jax(p0, "cpu")
    tp, tl = RoundEngine(task.model, client_microbatch=mb).grad_round(
        params, batch, torch.from_numpy(gammas), lrs)
    vp, vl = RoundEngine(task.model).grad_round(params, batch, torch.from_numpy(gammas), lrs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(flat(tree_leaves(tp)), flat(jax.tree.leaves(jp)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tl.numpy(), vl.numpy(), rtol=1e-6)
    np.testing.assert_allclose(flat(tree_leaves(tp)), flat(tree_leaves(vp)), atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# delta mode, one cluster
# --------------------------------------------------------------------------

CHANNELS = {"dense": "DenseChannel", "qsgd8": "QSGDChannel", "sign": "SignSGDChannel"}


def channel_pair(kind):
    args = (8,) if kind == "qsgd8" else ()
    return getattr(jch, CHANNELS[kind])(*args), getattr(tch, CHANNELS[kind])(*args)


def delta_round_inputs(jtask, task, m, K, E, seed=7):
    jtask.reset_loaders(0)
    task.reset_loaders(0)
    jbatch, batch = jtask.sample_round_batches(m, K, E), task.sample_round_batches(m, K, E)
    _, jsubs = jax_split_chain(jax.random.PRNGKey(seed), K // E)
    _, subs = split_chain(PRNGKey(seed), K // E)
    return jbatch, batch, jsubs, subs


def assert_one_round_close(got, want, lossy):
    """Dense: atol 1e-6.  A channel that rounds: at most 0.5% of params off
    by more than 1e-6 (`tests/test_torch_fed_chs.py`)."""
    got, want = flat(tree_leaves(got)), flat(jax.tree.leaves(want))
    if lossy:
        assert (np.abs(got - want) > 1e-6).mean() <= 5e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mb", [1, 2, "n"])
@pytest.mark.parametrize("kind", sorted(CHANNELS))
def test_microbatched_delta_round_matches_vmapped_and_reference(tasks, kind, mb):
    """{Dense, QSGD(8), Sign-SGD} x MomentumSGD on the 9-client cluster."""
    jtask, task, p0 = tasks
    m, K, E = 0, 6, 2
    n = len(task.cluster_members[m])
    mb = width(mb, n)
    jc, tc = channel_pair(kind)
    jbatch, batch, jsubs, subs = delta_round_inputs(jtask, task, m, K, E)
    gammas = task.cluster_weights(m)
    lrs = np.full((K // E, E), 0.05, np.float32)
    params = params_from_jax(p0, "cpu")

    vmapped = RoundEngine(task.model, tc, local_opt=tlocal.MomentumSGD())
    opt0 = vmapped.init_opt_state(params, n)
    vp, vs, vl = vmapped.cluster_round(params, batch, torch.from_numpy(gammas), lrs, subs, opt0)
    engine = RoundEngine(task.model, tc, local_opt=tlocal.MomentumSGD(), client_microbatch=mb)
    tp, ts, tl = engine.cluster_round(params, batch, torch.from_numpy(gammas), lrs, subs, opt0)
    if mb == n:  # one group: the accumulator adds exactly once
        for a, b in zip(tree_leaves(tp) + tree_leaves(ts) + [tl],
                        tree_leaves(vp) + tree_leaves(vs) + [vl]):
            assert torch.equal(a, b)
    else:
        for a, b in zip(tree_leaves(tp) + tree_leaves(ts), tree_leaves(vp) + tree_leaves(vs)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=3e-6)
        np.testing.assert_allclose(tl.numpy(), vl.numpy(), rtol=0, atol=1e-6)

    jengine = JaxRoundEngine(jtask.model, jc, local_opt=jlocal.MomentumSGD(),
                             client_microbatch=mb)
    jp, js, jl = jengine.cluster_round(jparams(p0), jbatch, jnp.asarray(gammas),
                                       jnp.asarray(lrs), jsubs,
                                       jengine.init_opt_state(jparams(p0), n))
    assert_one_round_close(tp, jp, kind != "dense")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("mb", [1, 2, 4])
def test_group_keys_are_global_slots(mb):
    """QSGD(8) payloads of a 9-sender uplink sent in groups of mb, each
    group keyed by its global slots: exact against the whole uplink sent at
    once and against the reference's `compress_uplinks(slots=...)`, the
    padded tail slots encoding zeros."""
    rng = np.random.default_rng(4)
    n = 9
    pad = (-n) % mb
    deltas = {"w": (rng.integers(-64, 65, (n + pad, 3, 700)) * 2.0**-8).astype(np.float32),
              "b": (rng.integers(-64, 65, (n + pad, 50)) * 2.0**-8).astype(np.float32)}
    for leaf in deltas.values():
        leaf[n:] = 0
    sub = np.asarray(jax.random.PRNGKey(21))
    channel = tch.QSGDChannel(8)
    whole = channel.encode({k: torch.from_numpy(v[:n]) for k, v in deltas.items()},
                           np.stack([fold_in(sub, i) for i in range(n)]))
    jchannel = jch.QSGDChannel(8)
    for g in range(0, n + pad, mb):
        slots = np.arange(g, g + mb)
        group = {k: torch.from_numpy(v[g:g + mb]) for k, v in deltas.items()}
        jgroup = {k: jnp.asarray(v[g:g + mb]) for k, v in deltas.items()}
        wires = channel.encode(group, np.stack([fold_in(sub, int(i)) for i in slots]))
        jwires = jax.vmap(lambda d, i: jchannel.encode(d, jax.random.fold_in(jnp.asarray(sub), i)))(
            jgroup, jnp.asarray(slots))
        real = min(mb, n - g)
        for w, jw, full in zip(wires, jwires, whole):
            for name in ("payload", "norms"):  # payload words as uint32, as the reference's
                np.testing.assert_array_equal(w[name].numpy().view(np.asarray(jw[name]).dtype),
                                              np.asarray(jw[name]))
                np.testing.assert_array_equal(w[name][:real].numpy(),
                                              full[name][g:g + real].numpy())
            assert not w["norms"][real:].any()
        got = compress_uplinks(channel, group, sub, slots)
        want = jax_compress_uplinks(jchannel, jgroup, jnp.asarray(sub), jnp.asarray(slots))
        for k in deltas:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("mb", [2, 4])
def test_masked_microbatched_round_matches_reference(tasks, mb):
    """The masked round (clients 1, 4 and 8 dropped) in groups of mb:
    dropped slots upload zeros, keep their optimizer state, leave the loss."""
    jtask, task, p0 = tasks
    m, K, E = 0, 4, 2
    n = len(task.cluster_members[m])
    jbatch, batch, jsubs, subs = delta_round_inputs(jtask, task, m, K, E, seed=3)
    mask = np.ones(n, np.float32)
    mask[[1, 4, 8]] = 0
    w = task.cluster_weights(m) * mask
    gammas = (w / w.sum()).astype(np.float32)
    lrs = np.full((K // E, E), 0.05, np.float32)
    jc, tc = channel_pair("qsgd8")
    jengine = JaxRoundEngine(jtask.model, jc, local_opt=jlocal.MomentumSGD(),
                             client_microbatch=mb)
    jp, js, jl = jengine.cluster_round(jparams(p0), jbatch, jnp.asarray(gammas), jnp.asarray(lrs),
                                       jsubs, jengine.init_opt_state(jparams(p0), n),
                                       mask=jnp.asarray(mask))
    params = params_from_jax(p0, "cpu")
    engine = RoundEngine(task.model, tc, local_opt=tlocal.MomentumSGD(), client_microbatch=mb)
    tp, ts, tl = engine.cluster_round(params, batch, torch.from_numpy(gammas), lrs, subs,
                                      mask=mask)
    vp, vs, vl = RoundEngine(task.model, tc, local_opt=tlocal.MomentumSGD()).cluster_round(
        params, batch, torch.from_numpy(gammas), lrs, subs, mask=mask)
    assert_one_round_close(tp, jp, True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), vl.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(tree_leaves(tp) + tree_leaves(ts), tree_leaves(vp) + tree_leaves(vs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=3e-6)
    for s in tree_leaves(ts):  # dropped clients' momentum stays at its zero start
        assert not s[[1, 4, 8]].any() and s[0].abs().sum() > 0


# --------------------------------------------------------------------------
# the 3-tier round on the ragged (3, 9) grid
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mb", [2, 4, 9])
@pytest.mark.parametrize("levels", [None, 16], ids=["dense", "qsgd16"])
def test_microbatched_multi_cluster_round(tasks, levels, mb):
    """Slots [g*mb, (g+1)*mb) of every cluster train together: against the
    reference's microbatched round (dense atol 1e-6, QSGD by the one-round
    rule) and the port's own unbatched round (atol 3e-6; bit-equal at
    mb = n_max)."""
    jtask, task, p0 = tasks
    K, E = 4, 2
    J, M = K // E, 3
    jtask.reset_loaders(0)
    task.reset_loaders(0)
    jbatch, batch = jtask.sample_all_cluster_batches(K, E), task.sample_all_cluster_batches(K, E)
    (jg, jm), (tg, tm) = jtask.padded_cluster_weights(), task.padded_cluster_weights()
    sizes = np.array(task.cluster_sizes, np.float32)
    es_w = sizes / sizes.sum()
    lrs = np.full((J, E), 0.05, np.float32)
    subs = es_subs = jsubs = jes_subs = None
    if levels:
        key, flat_subs = split_chain(PRNGKey(11), J * M)
        _, es_subs = split_chain(key, M)
        subs = flat_subs.reshape(J, M, 2)
        jkey, jflat = jax_split_chain(jax.random.PRNGKey(11), J * M)
        _, jes_subs = jax_split_chain(jkey, M)
        jsubs = jflat.reshape(J, M, 2)
    jc = jch.make_channel(levels)
    jengine = JaxRoundEngine(jtask.model, jc, local_opt=jlocal.MomentumSGD(0.9),
                             client_microbatch=mb)
    jstate = jengine.init_opt_state(jparams(p0), M, 9)
    jp, jstate, jl = jengine.multi_cluster_round(
        jparams(p0), jbatch, jg, jm, jnp.asarray(es_w), jnp.asarray(lrs), jsubs, jes_subs,
        jstate)
    params = params_from_jax(p0, "cpu")
    out = {}
    for width_ in (mb, None):
        engine = RoundEngine(task.model, tch.make_channel(levels),
                             local_opt=tlocal.MomentumSGD(0.9), client_microbatch=width_)
        out[width_] = engine.multi_cluster_round(params, batch, tg, tm, torch.from_numpy(es_w),
                                                 lrs, subs, es_subs)
    (tp, ts, tl), (vp, vs, vl) = out[mb], out[None]
    assert tuple(tl.shape) == (J, M)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert_one_round_close(tp, jp, levels is not None)
    for a, b in zip(tree_leaves(tp) + tree_leaves(ts) + [tl],
                    tree_leaves(vp) + tree_leaves(vs) + [vl]):
        if mb == 9:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=3e-6)
    for j, t in zip(jax.tree.leaves(jstate), tree_leaves(ts)):
        assert tuple(t.shape) == tuple(j.shape) == (M, 9) + tuple(t.shape[2:])
        assert not t[1, 6:].any() and not t[2, 5:].any() and t[0].abs().sum() > 0
        if not levels:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_client_microbatch_must_be_positive(tasks):
    with pytest.raises(ValueError, match="client_microbatch"):
        RoundEngine(tasks[1].model, client_microbatch=0)


# --------------------------------------------------------------------------
# whole runs of the four drivers
# --------------------------------------------------------------------------


def torch_config(jcfg, tcfg_cls):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg_cls)
          if hasattr(jcfg, f.name)}
    for name in ("channel", "es_channel"):
        if kw.get(name) is not None:
            jc = kw[name]
            fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.init}
            kw[name] = getattr(tch, type(jc).__name__)(**fields)
    if kw.get("local_opt") is not None:
        jopt = kw["local_opt"]
        kw["local_opt"] = getattr(tlocal, type(jopt).__name__)(**dataclasses.asdict(jopt))
    if kw.get("sampler") is not None:
        trace = kw["sampler"].trace  # AvailabilityAware(BernoulliTrace(...))
        kw["sampler"] = tpart.AvailabilityAware(tpart.BernoulliTrace(trace.p, trace.seed))
    return tcfg_cls(**kw)


def assert_runs_match(jres, res, lossy):
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits) and dict(tl.messages) == dict(jl.messages)
    assert tl.breakdown() == jl.breakdown()
    assert tl.history == jl.history and tl.events == jl.events
    assert res.rounds == jres.rounds
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    if lossy:
        assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=0.02 if lossy else 2 / 500)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=0.05 if lossy else 1e-5)


# step sizes where the runs train stably (`tests/test_torch_baselines.py`).
# The grad-mode run starts in cluster 2, where one fc2 pre-activation of one
# sample sits 2e-7 from 0 at the first step and lands on the other side of
# the ReLU in the two packages, with or without microbatching (ROADMAP
# Queue C): it is held to the lossy rule against the reference, and to
# atol 1e-6 against the port's own unbatched run below
GRAD_RUN = JaxFedCHSConfig(rounds=3, local_steps=4, eval_every=1, client_microbatch=2,
                           schedule=lambda k: 0.05)
RUNS = [
    ("fed_chs_grad", jax_run_fed_chs, run_fed_chs, FedCHSConfig, GRAD_RUN, True),
    ("fed_chs_qsgd", jax_run_fed_chs, run_fed_chs, FedCHSConfig,
     JaxFedCHSConfig(rounds=3, local_steps=4, local_epochs=2, eval_every=1, qsgd_levels=16,
                     local_opt=jlocal.MomentumSGD(0.9), client_microbatch=4,
                     schedule=lambda k: 0.05), True),
    ("fed_chs_churn", jax_run_fed_chs, run_fed_chs, FedCHSConfig,
     JaxFedCHSConfig(rounds=3, local_steps=4, local_epochs=2, eval_every=1, qsgd_levels=16,
                     sampler=jpart.AvailabilityAware(jpart.BernoulliTrace(0.6, seed=2)),
                     client_microbatch=2), True),
    ("fedavg", jb.run_fedavg, tb.run_fedavg, tb.FedAvgConfig,
     jb.FedAvgConfig(rounds=2, local_steps=3, eval_every=1, client_microbatch=3,
                     schedule=lambda k: 0.05, scan_rounds=False), False),
    ("hier_local_qsgd", jb.run_hier_local_qsgd, tb.run_hier_local_qsgd, tb.HierLocalQSGDConfig,
     jb.HierLocalQSGDConfig(rounds=2, local_steps=4, local_epochs=2, eval_every=1,
                            local_opt=jlocal.MomentumSGD(0.9), client_microbatch=2,
                            scan_rounds=False), True),
    ("wrwgd", jb.run_wrwgd, tb.run_wrwgd, tb.WRWGDConfig,
     jb.WRWGDConfig(rounds=8, local_steps=3, eval_every=4, client_microbatch=1,
                    schedule=lambda t: 0.05 / np.sqrt(t + 1), scan_rounds=False), False),
]


@pytest.mark.parametrize("jrun,trun,tcls,jcfg,lossy", [r[1:] for r in RUNS],
                         ids=[r[0] for r in RUNS])
def test_microbatched_runs_match_reference(tasks, jrun, trun, tcls, jcfg, lossy):
    jtask, task, _ = tasks
    jres, res = jrun(jtask, jcfg), trun(task, torch_config(jcfg, tcls))
    assert_runs_match(jres, res, lossy)
    assert np.isfinite(res.train_loss).all()


def test_microbatched_grad_run_equals_the_unbatched_run(tasks):
    _, task, _ = tasks
    runs = [run_fed_chs(task, dataclasses.replace(torch_config(GRAD_RUN, FedCHSConfig),
                                                  client_microbatch=mb)) for mb in (2, None)]
    assert runs[0].ledger.events == runs[1].ledger.events
    np.testing.assert_allclose(flat(tree_leaves(runs[0].final_params)),
                               flat(tree_leaves(runs[1].final_params)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(runs[0].train_loss, runs[1].train_loss, rtol=1e-6)
