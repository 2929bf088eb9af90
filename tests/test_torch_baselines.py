"""The port's baselines (FedAvg, WRWGD, Hier-Local-QSGD), its multi-cluster
round, its FLTask staging helpers, and Fed-CHS over the new channels and
optimizers, against the reference package.

The clusters are uneven (9, 6 and 5 clients), so the 3-tier round pads its
client grid: padded slots must carry zero weight, encode to zero and keep
their optimizer state frozen.

Integer results are held exactly: staged batches, ledgers (totals, per-hop
breakdown, snapshots, every `CommEvent`), WRWGD's visit order.  Float
results follow the rules of `tests/test_torch_fed_chs.py`: dense runs at
atol 1e-6 (torch and XLA sum in other orders, nothing amplifies it); runs
through a lossy channel that rounds (QSGD, Sign-SGD, Top-K) flip a code, a
sign or a selection where that noise crosses a boundary, and later rounds
train from the moved model, so one round is held to at most 0.5% of params
off by more than 1e-6 and a whole run to 3% relative L2.  AdamW divides
each first moment by the root of the second, so where a gradient is near
zero (near eps) a last-place difference becomes a visible step: its dense
runs are held to 1e-4 of the update p_T - p_0 in L2 (the rule
`chip_smoke.py` holds grad-mode runs to), where they read about 1e-5; a
missing bias correction reads far above.  The reference
runs its looped drivers (`scan_rounds=False`, what the port ports), and
once its default scanned executor, which it pins to the looped one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import channels as jch
from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core import baselines as jb
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.core.engine import split_chain as jax_split_chain
from repro.data import dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro.optim import local as jlocal
from repro_torch.comm import channels as tch
from repro_torch.core import baselines as tb
from repro_torch.core.engine import RoundEngine
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.prng import PRNGKey, split_chain
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


def torch_opt(jopt):
    """The port's optimizer of the same class and fields."""
    if jopt is None:
        return None
    return getattr(tlocal, type(jopt).__name__)(**dataclasses.asdict(jopt))


def torch_channel(jc):
    if jc is None:
        return None
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.init}
    return getattr(tch, type(jc).__name__)(**fields)


def assert_ledgers_equal(jres, res):
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits)
    assert dict(tl.messages) == dict(jl.messages)
    assert tl.breakdown() == jl.breakdown()
    assert tl.history == jl.history
    assert tl.events == jl.events
    assert res.rounds == jres.rounds


def assert_params_close(got, want, tol, p0):
    """tol: "dense" (atol 1e-6), "adam" (1e-4 of the update), "lossy" (3%)."""
    got, want = flat(tree_leaves(got)), flat(jax.tree.leaves(want))
    gap = np.linalg.norm(got - want)
    if tol == "lossy":
        assert gap <= 0.03 * np.linalg.norm(want)
    elif tol == "adam":
        assert gap <= 1e-4 * np.linalg.norm(want - flat(jax.tree.leaves(p0)))
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def assert_runs_match(jres, res, tol, p0):
    lossy = tol == "lossy"
    assert_ledgers_equal(jres, res)
    assert_params_close(res.final_params, jres.final_params, tol, p0)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=0.02 if lossy else 2 / 500)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=0.05 if lossy else 1e-5)
    assert np.isfinite(res.train_loss).all()


# --------------------------------------------------------------------------
# staging helpers
# --------------------------------------------------------------------------


def test_fltask_staging_matches_reference(tasks):
    jtask, task, _ = tasks
    jtask.reset_loaders(0)
    task.reset_loaders(0)
    jb_, tb_ = jtask.sample_all_cluster_batches(4, 2), task.sample_all_cluster_batches(4, 2)
    for k in ("x", "y"):
        assert tuple(tb_[k].shape[:4]) == (2, 3, 9, 2)
        np.testing.assert_array_equal(tb_[k].numpy(), np.asarray(jb_[k]))
    # a padded slot replicates its cluster's first member
    np.testing.assert_array_equal(tb_["x"][:, 2, 5].numpy(), tb_["x"][:, 2, 0].numpy())
    jc, tc = jtask.sample_client_batches(3, 5), task.sample_client_batches(3, 5)
    for k in ("x", "y"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    # padded slots drew nothing: the streams still agree afterwards
    jn, tn = jtask.sample_round_batches(1, 2, 1), task.sample_round_batches(1, 2, 1)
    np.testing.assert_array_equal(tn["x"].numpy(), np.asarray(jn["x"]))
    (jg, jm), (tg, tm) = jtask.padded_cluster_weights(), task.padded_cluster_weights()
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(task.global_weights(), jtask.global_weights())


def test_run_result_metrics_match_reference(tasks):
    from repro.core.simulation import RunResult as JaxRunResult

    from repro_torch.core.ledger import CommLedger
    from repro_torch.core.simulation import RunResult

    jtask, task, _ = tasks
    res = run_fed_chs(task, FedCHSConfig(rounds=3, local_steps=2, eval_every=1))
    jres = JaxRunResult(res.name, res.rounds, res.test_acc, res.train_loss, res.ledger,
                        res.final_params)
    for gamma in (0.0, res.test_acc[1], 2.0):
        assert res.rounds_to_accuracy(gamma) == jres.rounds_to_accuracy(gamma)
        assert res.bits_to_accuracy(gamma) == jres.bits_to_accuracy(gamma)
    assert res.best_acc() == jres.best_acc() == max(res.test_acc)
    ppl = RunResult("lm", [0, 1], [9.0, 7.5], [1.0, 0.9], CommLedger(), {}, metric_mode="min")
    assert ppl.best_acc() == 7.5 and ppl.rounds_to_accuracy(8.0) == 1
    empty = RunResult("lm", [], [], [], CommLedger(), {}, metric_mode="min")
    assert empty.best_acc() == empty.final_acc() == float("inf")


# --------------------------------------------------------------------------
# the 3-tier round
# --------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [None, 16])
def test_multi_cluster_round_matches_reference(tasks, levels):
    """One Hier-Local-QSGD round with MomentumSGD on the uneven clusters:
    dense at atol 1e-6; QSGD(16) on both hops by the one-round rule."""
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
    jc = jch.make_channel(levels)
    jopt = jlocal.MomentumSGD(0.9)
    subs = es_subs = jsubs = jes_subs = None
    if levels:
        key, flat_subs = split_chain(PRNGKey(11), J * M)
        _, es_subs = split_chain(key, M)
        subs = flat_subs.reshape(J, M, 2)
        jkey, jflat = jax_split_chain(jax.random.PRNGKey(11), J * M)
        _, jes_subs = jax_split_chain(jkey, M)
        jsubs = jflat.reshape(J, M, 2)
        np.testing.assert_array_equal(subs, np.asarray(jsubs))
        np.testing.assert_array_equal(es_subs, np.asarray(jes_subs))
    jengine = JaxRoundEngine(jtask.model, jc, local_opt=jopt)
    jstate = jengine.init_opt_state(jax.tree.map(jnp.asarray, p0), M, 9)
    jp, jstate, jl = jengine.multi_cluster_round(
        jax.tree.map(jnp.asarray, p0), jbatch, jg, jm, jnp.asarray(es_w), jnp.asarray(lrs),
        jsubs, jes_subs, jstate)
    engine = RoundEngine(task.model, torch_channel(jc), local_opt=torch_opt(jopt))
    tp, tstate, tl = engine.multi_cluster_round(
        params_from_jax(p0, "cpu"), batch, tg, tm, torch.from_numpy(es_w), lrs, subs, es_subs)
    assert tuple(tl.shape) == (J, M)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    got, want = flat(tree_leaves(tp)), flat(jax.tree.leaves(jp))
    if levels:
        assert (np.abs(got - want) > 1e-6).mean() <= 5e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # momentum: padded slots (cluster 1 from slot 6, cluster 2 from slot 5) stay zero
    for j, t in zip(jax.tree.leaves(jstate), tree_leaves(tstate)):
        assert tuple(t.shape) == tuple(j.shape)
        assert not t[1, 6:].any() and not t[2, 5:].any() and t[0].abs().sum() > 0
        if not levels:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------


def run_pair(tasks, jrun, trun, jcfg, tcfg_cls):
    jtask, task, _ = tasks
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg_cls)
          if hasattr(jcfg, f.name)}
    for name in ("channel", "es_channel"):
        if name in kw:
            kw[name] = torch_channel(kw[name])
    if "local_opt" in kw:
        kw["local_opt"] = torch_opt(kw["local_opt"])
    return jrun(jtask, jcfg), trun(task, tcfg_cls(**kw))


# step sizes where the runs train stably: the default schedule's eta_0 = 1/K
# is 0.33 at K = 3, where this MLP's loss leaves 10 and float-order noise
# grows without bound in either package
FEDAVG = [
    ("dense", dict(schedule=lambda k: 0.05), "dense"),
    ("qsgd_momentum", dict(qsgd_levels=16, local_opt=jlocal.MomentumSGD(0.5)), "lossy"),
    ("adamw", dict(local_opt=jlocal.AdamWOpt(), schedule=lambda k: 0.002), "adam"),
]


@pytest.mark.parametrize("kw,tol", [c[1:] for c in FEDAVG], ids=[c[0] for c in FEDAVG])
def test_fedavg_run_matches_reference(tasks, kw, tol):
    cfg = jb.FedAvgConfig(rounds=3, local_steps=3, eval_every=2, scan_rounds=False, **kw)
    jres, res = run_pair(tasks, jb.run_fedavg, tb.run_fedavg, cfg, tb.FedAvgConfig)
    assert_runs_match(jres, res, tol, tasks[2])
    assert res.ledger.messages["client_to_ps"] == 3 * 20


@pytest.mark.parametrize("scan_rounds", [False, True], ids=["looped", "scanned"])
def test_wrwgd_run_matches_reference(tasks, scan_rounds):
    cfg = jb.WRWGDConfig(rounds=12, local_steps=3, eval_every=4, scan_rounds=scan_rounds,
                         schedule=lambda t: 0.05 / np.sqrt(t + 1))
    jres, res = run_pair(tasks, jb.run_wrwgd, tb.run_wrwgd, cfg, tb.WRWGDConfig)
    assert_runs_match(jres, res, "dense", tasks[2])
    visits = [(e.sender, e.receiver) for e in res.ledger.events]
    assert visits == [(e.sender, e.receiver) for e in jres.ledger.events]
    assert len(visits) == 12 and all(a[1] == b[0] for a, b in zip(visits, visits[1:]))


HIER = [
    ("qsgd_momentum", dict(local_opt=jlocal.MomentumSGD(0.9)), "lossy", False),
    ("dense", dict(qsgd_levels=None), "dense", False),
    ("qsgd_then_sign", dict(es_channel=jch.SignSGDChannel(), rounds=1), "lossy", False),
    ("qsgd_scanned", dict(rounds=1), "lossy", True),
]


@pytest.mark.parametrize("kw,tol,scanned", [c[1:] for c in HIER], ids=[c[0] for c in HIER])
def test_hier_local_qsgd_run_matches_reference(tasks, kw, tol, scanned):
    kw = {"rounds": 2, **kw}
    cfg = jb.HierLocalQSGDConfig(local_steps=4, local_epochs=2, eval_every=1,
                                 scan_rounds=scanned, **kw)
    jres, res = run_pair(tasks, jb.run_hier_local_qsgd, tb.run_hier_local_qsgd, cfg,
                         tb.HierLocalQSGDConfig)
    assert_runs_match(jres, res, tol, tasks[2])
    led, leaf_sizes = res.ledger, tasks[1].param_leaf_sizes()
    es_channel = torch_channel(cfg.es_channel) or tch.make_channel(cfg.qsgd_levels)
    R = cfg.rounds
    assert led.messages["es_to_ps"] == led.messages["ps_to_es"] == R * 3
    assert led.bits["es_to_ps"] == R * 3 * tch.channel_wire_bits(es_channel, 0, leaf_sizes)
    assert led.messages["client_to_es"] == R * 2 * 20


def test_hier_local_qsgd_aggregate_ledger_without_events(tasks):
    cfg = jb.HierLocalQSGDConfig(rounds=1, local_steps=2, local_epochs=2, eval_every=1,
                                 qsgd_levels=None, scan_rounds=False, track_events=False)
    jres, res = run_pair(tasks, jb.run_hier_local_qsgd, tb.run_hier_local_qsgd, cfg,
                         tb.HierLocalQSGDConfig)
    assert_runs_match(jres, res, "dense", tasks[2])
    assert res.ledger.events == []


FED_CHS = [
    ("topk", dict(channel=jch.TopKChannel(0.05), local_epochs=2), "lossy"),
    ("signsgd", dict(channel=jch.low_bit_channel(1), local_epochs=2), "lossy"),
    ("qsgd_4bit", dict(channel=jch.low_bit_channel(4), local_epochs=2), "lossy"),
    ("bf16_wire", dict(channel=jch.DenseChannel(wire_dtype="bfloat16")), "lossy"),
    ("adamw", dict(local_opt=jlocal.AdamWOpt(), schedule=lambda k: 0.002), "adam"),
    ("momentum", dict(local_opt=jlocal.MomentumSGD(0.9, nesterov=True), local_epochs=2,
                      schedule=lambda k: 0.01), "dense"),
]


@pytest.mark.parametrize("kw,tol", [c[1:] for c in FED_CHS], ids=[c[0] for c in FED_CHS])
def test_fed_chs_channels_and_optimizers_match_reference(tasks, kw, tol):
    cfg = JaxFedCHSConfig(rounds=2, local_steps=4, eval_every=1, **kw)
    jres, res = run_pair(tasks, jax_run_fed_chs, run_fed_chs, cfg, FedCHSConfig)
    assert_runs_match(jres, res, tol, tasks[2])


# --------------------------------------------------------------------------
# config surface
# --------------------------------------------------------------------------


def test_baseline_configs_keep_the_reference_fields_and_defaults():
    for jcls, tcls in ((jb.FedAvgConfig, tb.FedAvgConfig), (jb.WRWGDConfig, tb.WRWGDConfig),
                       (jb.HierLocalQSGDConfig, tb.HierLocalQSGDConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        assert jf == tf, tcls.__name__
