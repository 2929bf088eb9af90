"""The port's Fed-CHS rounds and whole runs against the reference package.

Integer results are held exactly: the ledger (totals, per-hop breakdown,
snapshots, event stream) and the ES visit order.

Float results: both sides compute in f32 but sum in other orders (XLA's
dot against torch's), so a gradient differs in the last places.
  * Grad mode has no rounding step that amplifies that noise: params are
    held at atol 1e-6 after a round and after a whole run.
  * A QSGD uplink rounds every entry to a level: where the noise puts
    |v|/norm*s + u on the other side of an integer, a code flips and the
    entry moves by norm/s, and later rounds train from the moved model.
    One round from identical inputs flips few codes: at most 0.5% of the
    params move by more than 1e-6.  Over a whole run the trajectories stay
    close but apart: params within 3% in relative L2 norm.
The accuracy trace is held within 2% of the test set (grad mode: 2 test
samples), the loss trace at rtol 1e-5 in grad mode and 5% with QSGD.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.channels import QSGDChannel as JaxQSGDChannel
from repro.core import FedCHSConfig as JaxConfig
from repro.core import FLTask as JaxFLTask
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.core.engine import split_chain as jax_split_chain
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro_torch.comm.channels import QSGDChannel
from repro_torch.core.engine import RoundEngine
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.prng import PRNGKey, split_chain
from repro_torch.core.simulation import FLTask
from repro_torch.models.classifier import make_classifier
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tasks():
    """The same data, partition, clusters and initial weights on both sides."""
    ds = make_dataset("mnist", train_size=2000, test_size=500, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = assign_clusters(20, 4, seed=0)
    jclf = jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    jtask = JaxFLTask(jclf, ds, clients, clusters, batch_size=32, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=32, seed=0, device="cpu")
    return jtask, task, p0


def flat(tree_leaves_list):
    return np.concatenate([np.asarray(a).ravel() for a in tree_leaves_list])


def assert_ledgers_equal(jres, res):
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits)
    assert dict(tl.messages) == dict(jl.messages)
    assert tl.breakdown() == jl.breakdown()
    assert tl.history == jl.history
    assert tl.events == jl.events
    visits = [e.receiver for e in tl.events if e.hop == "es_to_es"]
    assert visits == [e.receiver for e in jl.events if e.hop == "es_to_es"]
    assert len(visits) == len(tl.history) > 0  # one ES->ES hop per round


def round_inputs(jtask, task, m, K, E=None):
    jtask.reset_loaders(0)
    task.reset_loaders(0)
    if E is None:
        return jtask.sample_cluster_batches(m, K), task.sample_cluster_batches(m, K)
    return jtask.sample_round_batches(m, K, E), task.sample_round_batches(m, K, E)


def test_grad_round_matches_reference(tasks):
    jtask, task, p0 = tasks
    K, m = 5, 1
    jbatch, batch = round_inputs(jtask, task, m, K)
    gammas = task.cluster_weights(m)
    lrs = np.linspace(0.2, 0.05, K).astype(np.float32)
    jparams, jlosses = JaxRoundEngine(jtask.model).grad_round(
        jax.tree.map(jnp.asarray, p0), jbatch, jnp.asarray(gammas), jnp.asarray(lrs))
    params, losses = RoundEngine(task.model).grad_round(
        params_from_jax(p0, "cpu"), batch, torch.from_numpy(gammas), lrs)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_allclose(flat(tree_leaves(params)), flat(jax.tree.leaves(jparams)),
                               atol=1e-6, rtol=0)


def test_qsgd_cluster_round_matches_reference(tasks):
    jtask, task, p0 = tasks
    K, E, m = 10, 5, 2
    jbatch, batch = round_inputs(jtask, task, m, K, E)
    gammas = task.cluster_weights(m)
    lrs = np.full((K // E, E), 0.05, np.float32)
    _, jsubs = jax_split_chain(jax.random.PRNGKey(7), K // E)
    _, subs = split_chain(PRNGKey(7), K // E)
    np.testing.assert_array_equal(subs, np.asarray(jsubs))
    jparams, _, jlosses = JaxRoundEngine(jtask.model, JaxQSGDChannel(16)).cluster_round(
        jax.tree.map(jnp.asarray, p0), jbatch, jnp.asarray(gammas), jnp.asarray(lrs), jsubs)
    params, _, losses = RoundEngine(task.model, QSGDChannel(16)).cluster_round(
        params_from_jax(p0, "cpu"), batch, torch.from_numpy(gammas), lrs, subs)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    diff = np.abs(flat(tree_leaves(params)) - flat(jax.tree.leaves(jparams)))
    assert (diff > 1e-6).mean() <= 5e-3, (diff > 1e-6).mean()


def run_both(tasks, **kw):
    jtask, task, _ = tasks
    jkw = {k: (JaxQSGDChannel(v.levels) if k == "channel" else v) for k, v in kw.items()}
    return jax_run_fed_chs(jtask, JaxConfig(**jkw)), run_fed_chs(task, FedCHSConfig(**kw))


def test_quickstart_run_matches_reference(tasks):
    """examples/quickstart.py's config (grad mode) at 6 rounds."""
    jres, res = run_both(tasks, rounds=6, local_steps=10, topology="random_sparse",
                         eval_every=2)
    assert_ledgers_equal(jres, res)
    assert res.rounds == jres.rounds
    np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=2 / 500)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-5)
    np.testing.assert_allclose(flat(tree_leaves(res.final_params)),
                               flat(jax.tree.leaves(jres.final_params)), atol=1e-6, rtol=0)


def test_qsgd_delta_run_matches_reference(tasks):
    """The compression arm: E=5 local steps per upload, QSGD(16) uplinks."""
    jres, res = run_both(tasks, rounds=4, local_steps=10, local_epochs=5, eval_every=2,
                         channel=QSGDChannel(16))
    assert_ledgers_equal(jres, res)
    up = res.ledger.bits["client_to_es"] // res.ledger.messages["client_to_es"]
    assert up == QSGDChannel(16).wire_bits(tasks[1].param_leaf_sizes())
    assert res.rounds == jres.rounds
    np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=0.02)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=0.05)
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want)


# ids as the cases had them when the list also held the fields ported since
# (obs, checkpoint, checkpoint_every and resume run now: tests/test_torch_obs.py,
# tests/test_torch_checkpoint.py)
@pytest.mark.parametrize("field,value", [("mesh", object())], ids=["mesh-value6"])
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        FedCHSConfig(**{field: value})


@pytest.mark.parametrize("kw", [dict(scan_rounds=False), dict(scan_rounds=True, chunk_rounds=1)],
                         ids=["looped", "chunked"])
def test_scan_fields_are_accepted_and_run_the_looped_driver(tasks, kw):
    """`FedCHSConfig(scan_rounds=False)`, as `benchmarks/engine_speedup.py`
    passes it, constructs and runs the looped driver; `scan_rounds=True`
    with `chunk_rounds=1` runs the whole-run executor one round a chunk.
    Either equals the reference's run of the same setting (the port's two
    executors are held to each other bit for bit in
    tests/test_torch_scan.py)."""
    jres, res = run_both(tasks, rounds=2, local_steps=4, eval_every=1, **kw)
    assert_ledgers_equal(jres, res)
    np.testing.assert_allclose(flat(tree_leaves(res.final_params)),
                               flat(jax.tree.leaves(jres.final_params)), atol=1e-6, rtol=0)


def test_fed_chs_config_keeps_the_reference_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(FedCHSConfig)}
    assert tf == jf
