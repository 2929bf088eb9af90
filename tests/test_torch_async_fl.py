"""The port's async federation drivers (`repro_torch.async_fl`) against the
reference's `repro.async_fl`, on the CPU.

* The buffer, staleness-discount, fire-time and arrival units, against the
  reference's on the same inputs.
* Each async driver against the reference on the same task and config:
  ledger (events and snapshots), staleness histogram, `sim_times` and eval
  rounds exact; params within 3% relative L2, the tolerance of the lossy
  QSGD runs (`tests/test_torch_fed_chs.py`): these runs carry QSGD(16)
  uplinks, whose codes flip where float-order noise crosses a level.
* The sync anchor: AlwaysOn, quorum 1.0 and no deadline make async
  Fed-CHS the synchronous `run_fed_chs(local_epochs=K)` bit for bit.
* Determinism; an in-process kill and resume, and a kill of a whole
  process (`os._exit` from `on_checkpoint`) and a resume in a fresh one,
  each bit-equal to the uninterrupted run; the `on_checkpoint` hook;
  `sim_time_to_accuracy`.
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

import repro.async_fl as ja
import repro.netsim.links as jlinks
import repro.part as jpart
from repro.core import FLTask as JaxFLTask
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
import repro_torch.async_fl as ta
import repro_torch.netsim.links as tlinks
import repro_torch.part as tpart
from repro_torch.async_fl.fed_chs import own_storage
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.simulation import FLTask
from repro_torch.models.classifier import make_classifier
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
# a torch subprocess runs on one thread, as this process does: the test
# command runs several workers on the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def pair():
    """The reference's `small_task`, the same data and weights on both sides."""
    ds = make_dataset("mnist", train_size=3000, test_size=600, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = assign_clusters(20, 4, seed=0)
    jtask = JaxFLTask(jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds,
                      clients, clusters, batch_size=32, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=32, seed=0, device="cpu")
    return jtask, task


def flat(leaves):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in leaves])


def assert_same_run(a, b):
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params)):
        assert torch.equal(x, y)
    assert a.test_acc == b.test_acc and a.rounds == b.rounds
    assert a.train_loss == b.train_loss
    assert a.sim_times == b.sim_times
    assert a.ledger.bits == b.ledger.bits and a.ledger.events == b.ledger.events
    assert a.ledger.staleness_histogram() == b.ledger.staleness_histogram()


# --------------------------------------------------------------------------
# units
# --------------------------------------------------------------------------


def test_staleness_weight():
    assert ta.staleness_weight(0.5, 0, 0.7) == 0.5  # tau = 0: no discount
    assert ta.staleness_weight(1.0, 3, 0.5) == pytest.approx(0.5)
    assert ta.staleness_weight(1.0, 1, 0.0) == 1.0  # alpha = 0: undiscounted FedBuff
    for g, tau, alpha in ((0.3, 2, 0.5), (0.125, 7, 1.3)):
        assert ta.staleness_weight(g, tau, alpha) == ja.staleness_weight(g, tau, alpha)


def _u(mod, client, version, arrival):
    return mod.Update(client=client, cluster=0, version=version, arrival=arrival,
                      gamma=1.0, delta=None)


@pytest.mark.parametrize("mod", [ta, ja], ids=["port", "reference"])
def test_buffer_take_is_totally_ordered(mod):
    buf = mod.StalenessBuffer(max_staleness=None)
    for u in [_u(mod, 3, 2, 5.0), _u(mod, 1, 1, 9.0), _u(mod, 2, 1, 9.0), _u(mod, 0, 1, 2.0)]:
        buf.add(u)
    out = buf.take()
    assert [(u.version, u.arrival, u.client) for u in out] == [
        (1, 2.0, 0), (1, 9.0, 1), (1, 9.0, 2), (2, 5.0, 3)]
    assert len(buf) == 0


def test_buffer_eviction_and_take_arrived():
    buf = ta.StalenessBuffer(max_staleness=2)
    buf.add(_u(ta, 0, 0, 1.0))
    buf.add(_u(ta, 1, 3, 1.0))
    evicted = buf.evict_stale(current_version=4)  # tau = 4 > 2 for version 0
    assert [u.client for u in evicted] == [0]
    assert buf.dropped == 1 and [u.client for u in buf.updates] == [1]
    buf = ta.StalenessBuffer()
    buf.add(_u(ta, 0, 0, 1.0))
    buf.add(_u(ta, 1, 0, 5.0))
    assert [u.client for u in buf.take_arrived(now=2.0)] == [0]
    assert [u.client for u in buf.updates] == [1]


def test_fire_time_quorum_and_deadline():
    def d(client, arrival):
        return ta.Dispatch(client=client, cluster=0, version=0, start=0.0, arrival=arrival)

    ds = [d(0, 1.0), d(1, 2.0), d(2, 10.0)]
    assert ta.fire_time(ds, quorum_frac=1.0, deadline_s=None, start=0.0) == 10.0
    assert ta.fire_time(ds, quorum_frac=0.5, deadline_s=None, start=0.0) == 2.0
    assert ta.fire_time(ds, quorum_frac=1.0, deadline_s=4.0, start=0.0) == 4.0
    assert ta.fire_time([], quorum_frac=1.0, deadline_s=3.0, start=7.0) == 10.0
    assert ta.fire_time([], quorum_frac=1.0, deadline_s=None, start=7.0) == 7.0


def test_dispatch_and_arrivals_match_reference():
    kw = dict(server="es:1", cluster=1, members=[2, 5, 7, 11, 13], start=1.5,
              down_bits=10**6, up_bits=2 * 10**5, num_params=25_000, batch_size=32,
              local_steps=5)
    net = dict(seed=3, heterogeneity=0.5, straggler_frac=0.3, straggler_slowdown=8.0)
    sizes = []
    for version in range(6):
        got = ta.dispatch_cohort(tlinks.edge_cloud_network(**net),
                                 tpart.BernoulliTrace(0.6, seed=2), version=version, **kw)
        want = ja.dispatch_cohort(jlinks.edge_cloud_network(**net),
                                  jpart.BernoulliTrace(0.6, seed=2), version=version, **kw)
        assert [dataclasses.astuple(x) for x in got] == [dataclasses.astuple(x) for x in want]
        sizes.append(len(got))
        for q, dl in ((0.6, None), (1.0, 0.5)):
            assert (ta.fire_time(got, quorum_frac=q, deadline_s=dl, start=1.5)
                    == ja.fire_time(want, quorum_frac=q, deadline_s=dl, start=1.5))
    assert min(sizes) < 5  # the trace put someone to sleep


def test_buffered_update_owns_its_storage():
    cohort = {"w": torch.randn(10, 6)}
    u = ta.Update(client=3, cluster=0, version=0, arrival=1.0, gamma=0.1,
                  delta={"w": cohort["w"][3]})
    owned = own_storage(u)
    assert torch.equal(owned.delta["w"], cohort["w"][3])
    assert owned.delta["w"].untyped_storage().nbytes() == 6 * 4
    assert u.delta["w"].untyped_storage().nbytes() == 60 * 4


# --------------------------------------------------------------------------
# the drivers against the reference
# --------------------------------------------------------------------------


def churn_kw(part, links, **over):
    kw = dict(rounds=10, local_steps=4, eval_every=2, initial_cluster=0, quorum_frac=0.6,
              deadline_s=2.0, staleness_alpha=0.5, max_staleness=3, qsgd_levels=16,
              trace=part.BernoulliTrace(p=0.7, seed=3),
              network=links.edge_cloud_network(straggler_frac=0.25, straggler_slowdown=6.0,
                                               heterogeneity=0.5, seed=1))
    kw.update(over)
    return kw


def ps_kw(part, links, **over):
    kw = dict(rounds=8, local_steps=4, quorum_k=4, eval_every=2, qsgd_levels=16,
              trace=part.BernoulliTrace(p=0.8, seed=3),
              network=links.edge_cloud_network(straggler_frac=0.25, seed=1))
    kw.update(over)
    return kw


ARMS = {
    "fed_chs": (ta.run_async_fed_chs, ta.AsyncFedCHSConfig, ja.run_async_fed_chs,
                ja.AsyncFedCHSConfig, churn_kw),
    "fedavg": (ta.run_async_fedavg, ta.AsyncPSConfig, ja.run_async_fedavg, ja.AsyncPSConfig,
               ps_kw),
    "hier": (ta.run_async_hier, ta.AsyncPSConfig, ja.run_async_hier, ja.AsyncPSConfig,
             ps_kw),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_async_driver_matches_reference(pair, arm):
    jtask, task = pair
    run, cfg, jrun, jcfg, kw = ARMS[arm]
    res = run(task, cfg(**kw(tpart, tlinks)))
    jres = jrun(jtask, jcfg(**kw(jpart, jlinks)))
    assert res.ledger.events == jres.ledger.events
    assert res.ledger.history == jres.ledger.history
    assert res.ledger.staleness_histogram() == jres.ledger.staleness_histogram()
    assert sum(res.ledger.staleness_histogram().values()) > 0
    assert res.sim_times == jres.sim_times and res.rounds == jres.rounds
    assert all(b >= a for a, b in zip(res.sim_times, res.sim_times[1:]))
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=0.02)
    assert all(np.isfinite(res.train_loss))


@pytest.mark.parametrize("arm", list(ARMS))
def test_async_driver_is_deterministic(pair, arm):
    task = pair[1]
    run, cfg, _, _, kw = ARMS[arm]
    a = run(task, cfg(**kw(tpart, tlinks, rounds=5)))
    b = run(task, cfg(**kw(tpart, tlinks, rounds=5)))
    assert_same_run(a, b)


@pytest.mark.parametrize("levels", [None, 16], ids=["dense", "qsgd16"])
def test_async_fed_chs_matches_sync_at_full_quorum(pair, levels):
    """AlwaysOn, quorum 1.0, no deadline: every activation folds its full
    cohort at staleness 0, so the run is the synchronous J = 1 run."""
    task = pair[1]
    R, K = 6, 4
    ra = ta.run_async_fed_chs(task, ta.AsyncFedCHSConfig(
        rounds=R, local_steps=K, eval_every=2, initial_cluster=0, quorum_frac=1.0,
        deadline_s=None, renormalize=False, qsgd_levels=levels))
    rs = run_fed_chs(task, FedCHSConfig(rounds=R, local_steps=K, local_epochs=K, eval_every=2,
                                        initial_cluster=0, qsgd_levels=levels))
    for x, y in zip(tree_leaves(ra.final_params), tree_leaves(rs.final_params)):
        assert torch.equal(x, y)
    assert ra.test_acc == rs.test_acc and ra.train_loss == rs.train_loss
    assert ra.ledger.bits["client_to_es"] == rs.ledger.bits["client_to_es"]
    assert ra.sim_times is not None and len(ra.sim_times) == len(ra.test_acc)
    assert all(b > a for a, b in zip(ra.sim_times, ra.sim_times[1:]))
    assert rs.sim_times is None


class _Killed(Exception):
    pass


def test_async_kill_and_resume_in_process(pair, tmp_path):
    """Killed by an exception right after the save at activation 5, then
    resumed: params, metrics, sim clock, bits and staleness histogram equal
    the uninterrupted run's."""
    task = pair[1]
    full = ta.run_async_fed_chs(task, ta.AsyncFedCHSConfig(**churn_kw(tpart, tlinks)))
    ck = str(tmp_path / "state")

    def kill(a):
        if a == 5:
            raise _Killed

    with pytest.raises(_Killed):
        ta.run_async_fed_chs(task, ta.AsyncFedCHSConfig(
            **churn_kw(tpart, tlinks), checkpoint=ck, on_checkpoint=kill))
    with open(ck + ".meta.json") as f:
        meta = json.load(f)
    assert meta["activation"] == 5 and meta["pending"]  # late updates were buffered
    resumed = ta.run_async_fed_chs(task, ta.AsyncFedCHSConfig(
        **churn_kw(tpart, tlinks), checkpoint=ck, resume=True))
    assert_same_run(full, resumed)


def test_async_checkpoint_hook_fires(pair, tmp_path):
    seen = []
    ta.run_async_fed_chs(pair[1], ta.AsyncFedCHSConfig(
        **churn_kw(tpart, tlinks, rounds=4), checkpoint=str(tmp_path / "s"),
        checkpoint_every=2, on_checkpoint=seen.append))
    assert seen == [2, 4]


def test_sim_time_to_accuracy(pair):
    res = ta.run_async_fed_chs(pair[1], ta.AsyncFedCHSConfig(
        rounds=6, local_steps=4, eval_every=2, initial_cluster=0))
    gamma = res.test_acc[-1]
    t = res.sim_time_to_accuracy(gamma)
    assert t is not None and t in res.sim_times
    assert res.sim_time_to_accuracy(2.0) is None  # unreachable target


# a run of the port alone (no jax), for the kill across processes: argv is
# (checkpoint prefix, "full" | "kill" | "resume")
_SERVICE = r"""
import hashlib, json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch.async_fl import AsyncFedCHSConfig, run_async_fed_chs
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import assign_clusters, dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.models.classifier import make_classifier
from repro_torch.netsim.links import edge_cloud_network
from repro_torch.part import BernoulliTrace
from repro_torch.utils import tree_leaves

ck, mode = sys.argv[1], sys.argv[2]
ds = make_dataset("mnist", train_size=1200, test_size=300, seed=0)
task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds,
              dirichlet_partition(ds.train_y, 8, 0.6, seed=0), assign_clusters(8, 2, seed=0),
              batch_size=16, seed=0, device="cpu")

def kill(a):
    if a == 3:
        os._exit(1)  # no cleanup: the hard kill the atomic writes are for

cfg = AsyncFedCHSConfig(
    rounds=6, local_steps=2, eval_every=1, quorum_frac=0.6, deadline_s=2.0, qsgd_levels=16,
    trace=BernoulliTrace(p=0.75, seed=0), seed=0,
    network=edge_cloud_network(seed=0, heterogeneity=0.5, straggler_frac=0.25),
    checkpoint=None if mode == "full" else ck, resume=mode == "resume",
    on_checkpoint=kill if mode == "kill" else None)
res = run_async_fed_chs(task, cfg)
h = hashlib.sha256()
for t in tree_leaves(res.final_params):
    h.update(t.numpy().tobytes())
print(json.dumps({"params": h.hexdigest(), "test_acc": res.test_acc, "rounds": res.rounds,
                  "sim_times": res.sim_times, "bits": res.ledger.total_bits(),
                  "staleness": {str(k): v for k, v in
                                res.ledger.staleness_histogram().items()}}))
"""


def _service(ck, mode):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD)
    p = subprocess.run([sys.executable, "-c", _SERVICE, ck, mode], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    return p


def test_kill_across_processes_and_resume(tmp_path):
    """A process killed (`os._exit(1)`) right after the checkpoint of
    activation 3, and a fresh process resuming from it, finish as the
    uninterrupted run does: params hash, metrics, clock, bits, staleness."""
    ck = str(tmp_path / "ck")
    full = _service(ck, "full")
    assert full.returncode == 0, full.stderr
    killed = _service(ck, "kill")
    assert killed.returncode == 1 and killed.stdout == ""
    with open(ck + ".meta.json") as f:
        assert json.load(f)["activation"] == 3
    resumed = _service(ck, "resume")
    assert resumed.returncode == 0, resumed.stderr
    a = json.loads(full.stdout.strip().splitlines()[-1])
    b = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert a == b
    assert len(a["sim_times"]) == 6 and sum(a["staleness"].values()) > 0
