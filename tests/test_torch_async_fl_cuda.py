"""The async drivers and resumed runs on the card.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_async_fl_cuda.py``.
Without a CUDA device every case skips.

* The sync anchor: async Fed-CHS with AlwaysOn clients, quorum 1.0 and no
  deadline equals the synchronous `run_fed_chs(local_epochs=K)` bit for
  bit on the card, with QSGD(16) uplinks through the Hopper kernels: the
  fold aggregates with the engine's own `torch.tensordot` at the same
  shapes.
* An async run killed after an activation's checkpoint and resumed equals
  the uninterrupted run bit for bit; so does a looped Fed-CHS run resumed
  from its checkpoint against the uninterrupted scanned run.
"""
import dataclasses

import pytest
import torch

from repro_torch.async_fl import AsyncFedCHSConfig, AsyncPSConfig, run_async_fed_chs
from repro_torch.async_fl import run_async_fedavg, run_async_hier
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import assign_clusters, dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import build
from repro_torch.models.classifier import make_classifier
from repro_torch.netsim.links import edge_cloud_network
from repro_torch.part import BernoulliTrace
from repro_torch.utils import tree_leaves

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU with nvcc")


@pytest.fixture(scope="module")
def task():
    ds = make_dataset("mnist", train_size=3000, test_size=600, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    return FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds, clients,
                  assign_clusters(20, 4, seed=0), batch_size=32, seed=0)


def assert_same_run(a, b):
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params)):
        assert torch.equal(x, y)
    assert a.test_acc == b.test_acc and a.rounds == b.rounds
    assert a.sim_times == b.sim_times
    assert a.ledger.bits == b.ledger.bits and a.ledger.events == b.ledger.events
    assert a.ledger.staleness_histogram() == b.ledger.staleness_histogram()


@needs_card
def test_sync_anchor_on_the_card(task):
    R, K = 4, 4
    build.reset_launches()
    ra = run_async_fed_chs(task, AsyncFedCHSConfig(
        rounds=R, local_steps=K, eval_every=2, initial_cluster=0, qsgd_levels=16))
    n_async = dict(build.LAUNCHES)
    build.reset_launches()
    rs = run_fed_chs(task, FedCHSConfig(rounds=R, local_steps=K, local_epochs=K, eval_every=2,
                                        initial_cluster=0, qsgd_levels=16))
    for x, y in zip(tree_leaves(ra.final_params), tree_leaves(rs.final_params)):
        assert torch.equal(x, y)
    assert ra.test_acc == rs.test_acc
    L = len(tree_leaves(ra.final_params))
    assert n_async["qsgd_quantize_pack"] == n_async["qsgd_unpack_dequantize"] == R * L
    assert build.LAUNCHES["qsgd_quantize_pack"] == R * L


def churn(**over):
    kw = dict(rounds=8, local_steps=4, eval_every=2, initial_cluster=0, quorum_frac=0.6,
              deadline_s=2.0, max_staleness=3, qsgd_levels=16,
              trace=BernoulliTrace(p=0.7, seed=3),
              network=edge_cloud_network(straggler_frac=0.25, straggler_slowdown=6.0,
                                         heterogeneity=0.5, seed=1))
    kw.update(over)
    return AsyncFedCHSConfig(**kw)


class _Killed(Exception):
    pass


@needs_card
def test_async_resume_on_the_card(task, tmp_path):
    full = run_async_fed_chs(task, churn())
    ck = str(tmp_path / "a")

    def kill(a):
        if a == 4:
            raise _Killed

    with pytest.raises(_Killed):
        run_async_fed_chs(task, churn(checkpoint=ck, on_checkpoint=kill))
    assert_same_run(full, run_async_fed_chs(task, churn(checkpoint=ck, resume=True)))


@needs_card
def test_sync_resume_on_the_card(task, tmp_path):
    kw = dict(rounds=6, local_steps=4, local_epochs=2, eval_every=2, initial_cluster=0,
              qsgd_levels=16)
    base = run_fed_chs(task, FedCHSConfig(**kw))
    ck = str(tmp_path / "s")
    run_fed_chs(task, FedCHSConfig(**{**kw, "rounds": 3}, checkpoint=ck))
    resumed = run_fed_chs(task, FedCHSConfig(**kw, checkpoint=ck, resume=True))
    for x, y in zip(tree_leaves(base.final_params), tree_leaves(resumed.final_params)):
        assert torch.equal(x, y) and x.device.type == "cuda"
    assert base.ledger.events == resumed.ledger.events and base.test_acc == resumed.test_acc


@needs_card
@pytest.mark.parametrize("run", [run_async_fedavg, run_async_hier])
def test_async_ps_drivers_repeat_on_the_card(task, run):
    cfg = AsyncPSConfig(rounds=5, local_steps=4, quorum_k=4, eval_every=2, qsgd_levels=16,
                        trace=BernoulliTrace(p=0.8, seed=3),
                        network=edge_cloud_network(straggler_frac=0.25, seed=1))
    a, b = run(task, cfg), run(task, dataclasses.replace(cfg))
    assert_same_run(a, b)
    assert sum(a.ledger.staleness_histogram().values()) > 0
