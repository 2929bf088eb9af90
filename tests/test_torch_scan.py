"""The port's whole-run executor (`ScanPlan`, `run_scan`, the four drivers'
scan plans, bulk staging, `run_sweep`) on the CPU, against the port's own
looped drivers and against the reference's scanned executor.

* Scanned against looped, in the port: params bit for bit, the eval metric
  equal, the ledger (bits, messages, events, history) equal, losses within
  atol 1e-5, over the reference's own parity cases
  (`tests/test_engine_parity.py`).  Under `Precision()` the reported loss
  is a bf16 value, and the masked average the scanned body takes of it
  rounds once more than the looped driver's unmasked mean: there losses
  are held at rtol 2^-7 (one bf16 ulp); params stay bit-equal.
* Scanned against the reference's scanned run (both at the default
  `scan_rounds=True`): ledger and visit order exact, params at the
  tolerances of `tests/test_torch_baselines.py`.
* Staging: each plan's `stage(idxs)` equals the reference plan's entry by
  entry, and the per-leaf device keys equal the keys the reference derives
  in its round (`fold_in` per sender, `split` per leaf).
* `eval_rounds`, bulk reads, `fast_forward` and `chunk_rounds` against the
  reference's contracts; `run_sweep` lanes bit-equal to their solo runs and
  within the reference's sweep tolerances of its lanes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.part as jpart
import repro_torch.part as tpart
from repro.comm import channels as jch
from repro.core import FLTask as JaxFLTask
from repro.core import engine as jengine
from repro.core import fed_chs as jfed
from repro.core.baselines import fedavg as jfedavg
from repro.core.baselines import hier_local_qsgd as jhier
from repro.core.baselines import wrwgd as jwrwgd
from repro.core.sweep import run_sweep as jax_run_sweep
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.data import sources as jsources
from repro.models.classifier import make_classifier as jax_make_classifier
from repro.optim import local as jlocal
from repro_torch.comm import channels as tch
from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine as tengine
from repro_torch.core import fed_chs as tfed
from repro_torch.core import prng
from repro_torch.core.baselines import fedavg as tfedavg
from repro_torch.core.baselines import hier_local_qsgd as thier
from repro_torch.core.baselines import wrwgd as twrwgd
from repro_torch.core.precision import Precision
from repro_torch.core.simulation import FLTask
from repro_torch.core.sweep import run_sweep
from repro_torch.data import sources as tsources
from repro_torch.data.sources import TokenSource
from repro_torch.models.classifier import make_classifier
from repro_torch.models.fed import LMFedModel
from repro_torch.optim import local as tlocal
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)


def task_pair(n_clients, clusters, train, test, batch, seed):
    """The same data, partition, clusters and initial weights on both sides."""
    ds = make_dataset("mnist", train_size=train, test_size=test, seed=seed)
    clients = dirichlet_partition(ds.train_y, n_clients, 0.6, seed=seed)
    jclf = jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    jtask = JaxFLTask(jclf, ds, clients, clusters, batch_size=batch, seed=seed)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=batch, seed=seed, device="cpu")
    return jtask, task


@pytest.fixture(scope="module")
def pair():
    """The reference's `small_task`: 20 clients in 4 clusters."""
    return task_pair(20, assign_clusters(20, 4, seed=0), 3000, 600, 32, 0)


@pytest.fixture(scope="module")
def ragged():
    """Clusters of 3, 2 and 2 clients: padded slots on the scanned path."""
    return task_pair(7, [[0, 1, 2], [3, 4], [5, 6]], 1200, 300, 16, 1)


TOY = dict(name="toy-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
           num_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")


@pytest.fixture(scope="module")
def toy_lm():
    model = LMFedModel(ArchConfig(**TOY), flash=True, remat=True)
    source = TokenSource(64, num_clients=4, batch_size=2, seq_len=16, topics=4, seed=0)
    return None, FLTask.from_source(model, source, [[0, 1], [2, 3]], seed=0, device="cpu")


def flat(leaves):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in leaves])


def assert_scan_matches_loop(run, task, cfg, loss_rtol=0.0):
    a = run(task, dataclasses.replace(cfg, scan_rounds=True))
    b = run(task, dataclasses.replace(cfg, scan_rounds=False))
    assert a.rounds == b.rounds
    assert a.test_acc == b.test_acc
    if loss_rtol:
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=loss_rtol)
    else:
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=1e-5, rtol=0)
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params)):
        assert torch.equal(x, y)
    assert a.ledger.bits == b.ledger.bits
    assert a.ledger.messages == b.ledger.messages
    assert a.ledger.events == b.ledger.events
    assert a.ledger.history == b.ledger.history
    return a


def samplers(part):
    """The reference's parity-test samplers, built from either package."""
    return {"uniformk": part.UniformK(k=2, seed=5),
            "churn": part.AvailabilityAware(part.BernoulliTrace(p=0.4, seed=9)),
            "dark": part.AvailabilityAware(part.BernoulliTrace(p=0.15, seed=3))}


S = samplers(tpart)
CHS = tfed.FedCHSConfig
BASE = dict(rounds=4, local_steps=4, local_epochs=2, eval_every=1, seed=0)
CHURN_BASE = dict(rounds=8, local_steps=4, local_epochs=2, eval_every=3, seed=2)
# (id, run, config, task fixture, loss rtol: 0 = atol 1e-5)
SCAN_CASES = [
    ("fed_chs_grad", tfed.run_fed_chs,
     CHS(rounds=6, local_steps=6, eval_every=2, seed=3, chunk_rounds=2), "pair", 0),
    ("fed_chs_dense", tfed.run_fed_chs, CHS(**BASE), "pair", 0),
    ("fed_chs_qsgd16", tfed.run_fed_chs, CHS(**BASE, qsgd_levels=16), "pair", 0),
    ("fed_chs_topk", tfed.run_fed_chs, CHS(**BASE, channel=tch.TopKChannel(0.1)), "pair", 0),
    ("fed_chs_uniformk", tfed.run_fed_chs, CHS(**CHURN_BASE, sampler=S["uniformk"]), "pair", 0),
    ("fed_chs_churn", tfed.run_fed_chs, CHS(**CHURN_BASE, sampler=S["churn"]), "pair", 0),
    ("fed_chs_dark_qsgd8", tfed.run_fed_chs,
     CHS(**CHURN_BASE, sampler=S["dark"], qsgd_levels=8), "pair", 0),
    ("fed_chs_availability_scheduler", tfed.run_fed_chs,
     CHS(**CHURN_BASE, sampler=S["churn"], availability_scheduler=True), "pair", 0),
    ("fed_chs_iov", tfed.run_fed_chs,
     CHS(rounds=6, local_steps=6, eval_every=2, seed=1, dynamic="iov"), "pair", 0),
    ("fed_chs_iov_qsgd16", tfed.run_fed_chs,
     CHS(rounds=4, local_steps=4, local_epochs=2, eval_every=2, dynamic="iov",
         qsgd_levels=16), "pair", 0),
    ("fed_chs_leo", tfed.run_fed_chs,
     CHS(rounds=6, local_steps=6, eval_every=2, seed=1, dynamic="leo"), "pair", 0),
    ("fed_chs_leo_qsgd16", tfed.run_fed_chs,
     CHS(rounds=4, local_steps=4, local_epochs=2, eval_every=2, dynamic="leo",
         qsgd_levels=16), "pair", 0),
    ("fedavg_qsgd8", tfedavg.run_fedavg,
     tfedavg.FedAvgConfig(rounds=3, local_steps=5, qsgd_levels=8, eval_every=1, seed=2),
     "pair", 0),
    ("fedavg_topk", tfedavg.run_fedavg,
     tfedavg.FedAvgConfig(rounds=3, local_steps=5, eval_every=1, channel=tch.TopKChannel(0.05)),
     "pair", 0),
    ("fedavg_dark", tfedavg.run_fedavg,
     tfedavg.FedAvgConfig(rounds=8, local_steps=3, eval_every=3, seed=2, sampler=S["dark"]),
     "pair", 0),
    ("wrwgd", twrwgd.run_wrwgd, twrwgd.WRWGDConfig(rounds=8, local_steps=5, eval_every=3, seed=4),
     "pair", 0),
    ("wrwgd_dark", twrwgd.run_wrwgd,
     twrwgd.WRWGDConfig(rounds=10, local_steps=4, eval_every=3, seed=4, sampler=S["dark"],
                        chunk_rounds=3), "pair", 0),
    ("hier_qsgd16", thier.run_hier_local_qsgd,
     thier.HierLocalQSGDConfig(rounds=2, local_steps=4, local_epochs=2, qsgd_levels=16,
                               eval_every=1), "pair", 0),
    ("hier_churn", thier.run_hier_local_qsgd,
     thier.HierLocalQSGDConfig(rounds=6, local_steps=4, local_epochs=2, qsgd_levels=16,
                               eval_every=2, seed=2, sampler=S["churn"], chunk_rounds=2),
     "pair", 0),
    ("hier_topk_es_channel", thier.run_hier_local_qsgd,
     thier.HierLocalQSGDConfig(rounds=3, local_steps=4, local_epochs=2, qsgd_levels=16,
                               es_channel=tch.TopKChannel(0.1), eval_every=1, seed=1),
     "pair", 0),
    ("ragged_dense", tfed.run_fed_chs,
     CHS(rounds=5, local_steps=6, local_epochs=3, eval_every=2, seed=1), "ragged", 0),
    ("ragged_topk", tfed.run_fed_chs, CHS(**BASE, channel=tch.TopKChannel(0.1)), "ragged", 0),
    ("ragged_qsgd16", tfed.run_fed_chs, CHS(**dict(BASE, seed=2), qsgd_levels=16), "ragged", 0),
    ("ragged_signsgd", tfed.run_fed_chs,
     CHS(rounds=3, local_steps=4, local_epochs=2, channel=tch.SignSGDChannel(), eval_every=1,
         seed=3), "ragged", 0),
    ("ragged_precision_microbatch", tfed.run_fed_chs,
     CHS(**BASE, precision=Precision(), client_microbatch=2, qsgd_levels=16,
         local_opt=tlocal.MomentumSGD(0.9)), "ragged", 2.0**-7),
    ("hier_precision_microbatch", thier.run_hier_local_qsgd,
     thier.HierLocalQSGDConfig(rounds=2, local_steps=4, local_epochs=2, eval_every=1,
                               precision=Precision(), client_microbatch=2), "ragged", 2.0**-7),
    ("fedavg_microbatch_adamw", tfedavg.run_fedavg,
     tfedavg.FedAvgConfig(rounds=2, local_steps=3, eval_every=1, client_microbatch=3,
                          local_opt=tlocal.AdamWOpt(), schedule=lambda k: 0.002), "ragged", 0),
    ("toy_lm_remat_qsgd16", tfed.run_fed_chs,
     CHS(rounds=3, local_steps=4, local_epochs=2, eval_every=1, qsgd_levels=16,
         schedule=lambda k: 0.3), "toy_lm", 0),
    ("toy_lm_lean", tfed.run_fed_chs,
     CHS(rounds=3, local_steps=4, local_epochs=2, eval_every=1, precision=Precision(),
         client_microbatch=1, schedule=lambda k: 0.3), "toy_lm", 2.0**-7),
]


@pytest.mark.parametrize("run,cfg,fixture,loss_rtol", [c[1:] for c in SCAN_CASES],
                         ids=[c[0] for c in SCAN_CASES])
def test_scanned_run_equals_looped_run(request, run, cfg, fixture, loss_rtol):
    task = request.getfixturevalue(fixture)[1]
    res = assert_scan_matches_loop(run, task, cfg, loss_rtol)
    assert np.isfinite(res.test_acc).all()


# --------------------------------------------------------------------------
# the port's scanned runs against the reference's scanned runs
# --------------------------------------------------------------------------


def to_torch(value):
    """The port's channel, optimizer or sampler of a reference one."""
    if isinstance(value, (jch.DenseChannel, jch.QSGDChannel, jch.SignSGDChannel,
                          jch.TopKChannel)):
        fields = {f.name: getattr(value, f.name) for f in dataclasses.fields(value) if f.init}
        return getattr(tch, type(value).__name__)(**fields)
    if isinstance(value, (jlocal.PlainSGD, jlocal.MomentumSGD, jlocal.AdamWOpt)):
        return getattr(tlocal, type(value).__name__)(**dataclasses.asdict(value))
    for name, ref in REF_SAMPLERS.items():
        if value is ref:
            return S[name]
    return value


REF_SAMPLERS = samplers(jpart)


def port_config(jcfg, tcls):
    return tcls(**{f.name: to_torch(getattr(jcfg, f.name)) for f in dataclasses.fields(tcls)
                   if hasattr(jcfg, f.name)})


# (id, reference run, port run, reference config, port config class, tolerance)
REF_CASES = [
    ("fed_chs_grad", jfed.run_fed_chs, tfed.run_fed_chs,
     jfed.FedCHSConfig(rounds=6, local_steps=10, eval_every=2, seed=3, chunk_rounds=4),
     tfed.FedCHSConfig, "dense"),
    ("fed_chs_qsgd16", jfed.run_fed_chs, tfed.run_fed_chs,
     jfed.FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, eval_every=2, qsgd_levels=16),
     tfed.FedCHSConfig, "lossy"),
    ("fed_chs_churn", jfed.run_fed_chs, tfed.run_fed_chs,
     jfed.FedCHSConfig(rounds=8, local_steps=4, local_epochs=2, eval_every=3, seed=2,
                       sampler=REF_SAMPLERS["churn"], availability_scheduler=True),
     tfed.FedCHSConfig, "dense"),
    ("fedavg_qsgd_momentum", jfedavg.run_fedavg, tfedavg.run_fedavg,
     jfedavg.FedAvgConfig(rounds=3, local_steps=3, eval_every=2, qsgd_levels=16,
                          local_opt=jlocal.MomentumSGD(0.5)),
     tfedavg.FedAvgConfig, "lossy"),
    ("wrwgd", jwrwgd.run_wrwgd, twrwgd.run_wrwgd,
     jwrwgd.WRWGDConfig(rounds=12, local_steps=3, eval_every=4,
                        schedule=lambda t: 0.05 / np.sqrt(t + 1)),
     twrwgd.WRWGDConfig, "dense"),
    ("hier_qsgd16", jhier.run_hier_local_qsgd, thier.run_hier_local_qsgd,
     jhier.HierLocalQSGDConfig(rounds=2, local_steps=4, local_epochs=2, eval_every=1,
                               qsgd_levels=16),
     thier.HierLocalQSGDConfig, "lossy"),
]


def assert_matches_reference(jres, res, tol):
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits) and dict(tl.messages) == dict(jl.messages)
    assert tl.history == jl.history and tl.events == jl.events  # the visit order too
    assert res.rounds == jres.rounds
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    if tol == "lossy":  # codes flip where float-order noise crosses a level
        assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want)
        np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=0.02)
        np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=0.05)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=2 / 600)
        np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-5)


@pytest.mark.parametrize("jrun,trun,jcfg,tcls,tol", [c[1:] for c in REF_CASES],
                         ids=[c[0] for c in REF_CASES])
def test_scanned_run_matches_reference_scanned_run(pair, jrun, trun, jcfg, tcls, tol):
    jtask, task = pair
    assert jcfg.scan_rounds
    jres = jrun(jtask, jcfg)
    res = trun(task, port_config(jcfg, tcls))
    assert_matches_reference(jres, res, tol)


# --------------------------------------------------------------------------
# staging: plans stage what the reference's plans stage
# --------------------------------------------------------------------------


def reference_keys(subs, width, n_leaves):
    """`fold_in(sub, slot)` then `split(., n_leaves)`, as the reference's
    round and QSGD channel derive them in its graph: (..., width, L, 2)."""
    flat_subs = np.asarray(subs).reshape(-1, 2)
    out = np.stack([np.stack([np.asarray(jax.random.split(
        jax.random.fold_in(jax.numpy.asarray(s), i), n_leaves)) for i in range(width)])
        for s in flat_subs])
    return out.reshape(np.shape(subs)[:-1] + (width, n_leaves, 2))


STAGE_CASES = [
    ("fed_chs_microbatch_churn", jfed._fed_chs_scan_plan, tfed._fed_chs_scan_plan,
     jfed.FedCHSConfig(rounds=10, local_steps=4, local_epochs=2, qsgd_levels=16,
                       client_microbatch=2, sampler=REF_SAMPLERS["churn"]),
     tfed.FedCHSConfig, "ragged"),
    ("fed_chs_grad", jfed._fed_chs_scan_plan, tfed._fed_chs_scan_plan,
     jfed.FedCHSConfig(rounds=5, local_steps=3), tfed.FedCHSConfig, "ragged"),
    ("fedavg_qsgd", jfedavg._fedavg_scan_plan, tfedavg._fedavg_scan_plan,
     jfedavg.FedAvgConfig(rounds=4, local_steps=2, qsgd_levels=16), tfedavg.FedAvgConfig,
     "ragged"),
    ("wrwgd", jwrwgd._wrwgd_scan_plan, twrwgd._wrwgd_scan_plan,
     jwrwgd.WRWGDConfig(rounds=6, local_steps=2), twrwgd.WRWGDConfig, "ragged"),
    ("hier_qsgd_both_hops", jhier._hier_scan_plan, thier._hier_scan_plan,
     jhier.HierLocalQSGDConfig(rounds=4, local_steps=4, local_epochs=2, qsgd_levels=16,
                               client_microbatch=2), thier.HierLocalQSGDConfig, "ragged"),
]


@pytest.mark.parametrize("jplan,tplan,jcfg,tcls,fixture", [c[1:] for c in STAGE_CASES],
                         ids=[c[0] for c in STAGE_CASES])
def test_stage_equals_reference_stage(request, jplan, tplan, jcfg, tcls, fixture):
    jtask, task = request.getfixturevalue(fixture)
    jp = jplan(jtask, jtask.source, jcfg)[0]
    tp = tplan(task, task.source, port_config(jcfg, tcls))[0]
    np.testing.assert_array_equal(tp.trained, np.asarray(jp.trained))
    idxs = np.flatnonzero(tp.trained)
    n_leaves = len(task.param_leaf_sizes())
    assert len(idxs) >= 3
    for chunk in (idxs[:2], idxs[2:5]):
        want, got = jp.stage(chunk), tp.stage(chunk)
        for name, value in want.items():
            if name == "batch":
                for k in value:
                    np.testing.assert_array_equal(got["batch"][k], np.asarray(value[k]))
            else:
                np.testing.assert_array_equal(got[name], np.asarray(value), err_msg=name)
        if "keys" in got:  # every sender's per-leaf keys, as the reference derives them
            width = got["keys"].shape[-3]
            engine = tengine.RoundEngine(task.model, client_microbatch=jcfg.client_microbatch)
            assert width == engine.key_width(got["mask"].shape[-1])
            np.testing.assert_array_equal(got["keys"],
                                          reference_keys(want["subs"], width, n_leaves))
        if "es_keys" in got:
            np.testing.assert_array_equal(got["es_keys"], np.stack([
                np.asarray(jax.random.split(jax.numpy.asarray(s), n_leaves))
                for s in np.asarray(want["es_subs"]).reshape(-1, 2)]).reshape(
                    got["es_keys"].shape))


@pytest.mark.parametrize("n_keys,n", [(1, 1), (3, 5), (7, 16)])
def test_key_derivation_matches_jax_random(n_keys, n):
    _, keys = prng.split_chain(prng.PRNGKey(11), n_keys)
    data = np.arange(n, dtype=np.uint32)[None].repeat(n_keys, 0) * 7 + 3
    got = prng.fold_in_each(keys, data)
    for k in range(n_keys):
        for i in range(n):
            want = jax.random.fold_in(jax.numpy.asarray(keys[k]), int(data[k, i]))
            np.testing.assert_array_equal(got[k, i], np.asarray(want))
        np.testing.assert_array_equal(prng.split_each(keys, n)[k],
                                      np.asarray(jax.random.split(jax.numpy.asarray(keys[k]), n)))


# --------------------------------------------------------------------------
# the smaller contracts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rounds,eval_every", [(1, 1), (5, 2), (10, 3), (200, 10),
                                               (7, 100), (8, 4)])
def test_eval_rounds_match_reference(rounds, eval_every):
    assert tengine.eval_rounds(rounds, eval_every) == jengine.eval_rounds(rounds, eval_every)


def test_bulk_reads_match_reference_and_sequential_draws(pair):
    jtask, task = pair
    jsrc, src = jtask.source, task.source
    jsrc.reset(5)
    src.reset(5)
    seq = [src.next_batch(3) for _ in range(6)]
    want = jsources.bulk_batches(jsrc, 3, 6)
    src.reset(5)
    bulk = tsources.bulk_batches(src, 3, 6)
    for k in ("x", "y"):
        np.testing.assert_array_equal(bulk[k], np.asarray(want[k]))
        np.testing.assert_array_equal(bulk[k], np.stack([b[k] for b in seq]))
    # the stream position after a bulk read equals six sequential reads
    assert src.draw_counts[3] == jsrc.draw_counts[3] == 6
    np.testing.assert_array_equal(src.next_batch(3)["x"], jsrc.next_batch(3)["x"])


def test_bulk_batches_generic_fallback():
    class Minimal:
        batch_size = 2
        num_clients = 1
        client_sizes = np.ones(1)

        def __init__(self):
            self.n = 0

        def reset(self, seed):
            self.n = 0

        def next_batch(self, client):
            self.n += 1
            return {"x": np.full((2, 3), self.n)}

        def eval_data(self):
            return None

    got, want = tsources.bulk_batches(Minimal(), 0, 3), jsources.bulk_batches(Minimal(), 0, 3)
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
    np.testing.assert_array_equal(got["x"][:, 0, 0], [1, 2, 3])
    assert isinstance(Minimal(), tsources.DataSource)


def test_fast_forward_matches_reference(pair):
    jtask, task = pair
    counts = [i % 4 for i in range(task.num_clients)]
    jtask.source.reset(2)
    task.source.reset(2)
    jtask.source.fast_forward(counts)
    task.source.fast_forward(counts)
    assert task.source.draw_counts == counts
    for c in (0, 3, 7):
        np.testing.assert_array_equal(task.source.next_batch(c)["x"],
                                      jtask.source.next_batch(c)["x"])
    with pytest.raises(AssertionError):
        task.source.fast_forward([0] * task.num_clients)  # no rewinding


def test_chunk_rounds_change_nothing(pair):
    task = pair[1]
    base = tfed.FedCHSConfig(rounds=7, local_steps=4, local_epochs=2, qsgd_levels=8,
                             eval_every=3, seed=1)
    ref = tfed.run_fed_chs(task, dataclasses.replace(base, chunk_rounds=1))
    for chunk in (2, 3, 64):
        res = tfed.run_fed_chs(task, dataclasses.replace(base, chunk_rounds=chunk))
        assert res.test_acc == ref.test_acc and res.train_loss == ref.train_loss
        for a, b in zip(tree_leaves(res.final_params), tree_leaves(ref.final_params)):
            assert torch.equal(a, b)
        assert res.ledger.events == ref.ledger.events


# --------------------------------------------------------------------------
# run_sweep
# --------------------------------------------------------------------------

SWEEP_CASES = [
    ("fed_chs_grad", tfed.run_fed_chs, tfed.FedCHSConfig(rounds=5, local_steps=4, eval_every=2),
     (0, 3, 7)),
    ("fed_chs_qsgd16", tfed.run_fed_chs,
     tfed.FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, qsgd_levels=16, eval_every=2),
     (0, 5)),
    ("wrwgd", twrwgd.run_wrwgd, twrwgd.WRWGDConfig(rounds=6, local_steps=4, eval_every=2),
     (0, 9)),
    ("fedavg", tfedavg.run_fedavg, tfedavg.FedAvgConfig(rounds=3, local_steps=4, eval_every=1),
     (0, 5)),
    ("hier_qsgd16", thier.run_hier_local_qsgd,
     thier.HierLocalQSGDConfig(rounds=2, local_steps=4, local_epochs=2, qsgd_levels=16,
                               eval_every=1), (0, 4)),
]


@pytest.mark.parametrize("run,cfg,seeds", [c[1:] for c in SWEEP_CASES],
                         ids=[c[0] for c in SWEEP_CASES])
def test_sweep_lanes_equal_solo_runs(pair, run, cfg, seeds):
    """Every lane is its solo scanned run, bit for bit, in every mode."""
    task = pair[1]
    swept = run_sweep(task, cfg, seeds)
    for s, res in zip(seeds, swept):
        solo = run(task, dataclasses.replace(cfg, seed=s))
        assert res.name == solo.name and res.rounds == solo.rounds
        assert res.test_acc == solo.test_acc and res.train_loss == solo.train_loss
        for a, b in zip(tree_leaves(res.final_params), tree_leaves(solo.final_params)):
            assert torch.equal(a, b)
        assert res.ledger.bits == solo.ledger.bits and res.ledger.events == solo.ledger.events


# the reference's sweep tolerances (tests/test_run_scan.py): delta-mode lanes
# within atol 1e-5 of params and 0.02 of accuracy; grad-mode lanes, which it
# holds bit for bit, at the looped parity tolerance across the packages
REF_SWEEPS = [
    ("fed_chs_grad", jfed.FedCHSConfig(rounds=5, local_steps=10, eval_every=2),
     tfed.FedCHSConfig, (0, 3, 7), 1e-6, 2 / 600),
    ("fedavg", jfedavg.FedAvgConfig(rounds=3, local_steps=4, eval_every=1),
     tfedavg.FedAvgConfig, (0, 5), 1e-5, 0.02),
]


@pytest.mark.parametrize("jcfg,tcls,seeds,atol,acc_atol", [c[1:] for c in REF_SWEEPS],
                         ids=[c[0] for c in REF_SWEEPS])
def test_sweep_lanes_match_reference_sweep(pair, jcfg, tcls, seeds, atol, acc_atol):
    jtask, task = pair
    jswept = jax_run_sweep(jtask, jcfg, seeds)
    swept = run_sweep(task, port_config(jcfg, tcls), seeds)
    for jres, res in zip(jswept, swept):
        assert res.rounds == jres.rounds
        assert res.ledger.bits == jres.ledger.bits and res.ledger.events == jres.ledger.events
        np.testing.assert_allclose(flat(tree_leaves(res.final_params)),
                                   flat(jax.tree.leaves(jres.final_params)), atol=atol, rtol=0)
        np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=acc_atol)


def test_sweep_guards_raise(pair):
    task = pair[1]
    with pytest.raises(AssertionError):
        run_sweep(task, tfed.FedCHSConfig(rounds=3, local_steps=4, local_epochs=2,
                                          sampler=S["churn"]), (0, 1))
    with pytest.raises(AssertionError):
        run_sweep(task, tfed.FedCHSConfig(rounds=3, local_steps=4, scan_rounds=False), (0, 1))
    with pytest.raises(AssertionError, match="run_sweep shards the seed axis"):
        run_sweep(task, tfed.FedCHSConfig(rounds=3, local_steps=4, mesh=object()), (0, 1))


def test_sweep_leaves_task_source_untouched(pair):
    task = pair[1]
    task.reset_loaders(123)
    before = task.source.next_batch(0)
    task.reset_loaders(123)
    run_sweep(task, tfed.FedCHSConfig(rounds=3, local_steps=4, eval_every=2), (0, 1))
    after = task.source.next_batch(0)
    np.testing.assert_array_equal(before["x"], after["x"])
