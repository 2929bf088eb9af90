"""The whole-run executor on the card: a captured round replayed.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_scan_cuda.py``.
Without a CUDA device every case skips.

* A scanned run (one captured CUDA graph, replayed per round) equals the
  same plan run by the eager executor on the card bit for bit, with the
  same kernel launch counts, on ragged clusters; on clusters of equal
  size it also equals the looped driver bit for bit.  A ragged Fed-CHS
  cluster's scanned round sums its deltas over the padded n_max slots
  (exact zeros in the padding) where the looped round sums over its n
  clients, and cuBLAS orders the sum by its length: there the two
  executors are held at 1e-6 (an H100 read 6e-8 after 5 rounds).
* A chunk of replays under `torch.cuda.set_sync_debug_mode("error")`
  raises nothing: no host sync between eval points.
* A scanned run holds no graph and no graph pool after it returns.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.baselines import (
    FedAvgConfig,
    HierLocalQSGDConfig,
    WRWGDConfig,
    run_fedavg,
    run_hier_local_qsgd,
    run_wrwgd,
)
from repro_torch.core.fed_chs import FedCHSConfig, _fed_chs_scan_plan, run_fed_chs
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import build
from repro_torch.models.classifier import make_classifier
from repro_torch.optim.local import MomentumSGD
from repro_torch.utils import tree_leaves

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU with nvcc")


def make_task(clusters):
    ds = make_dataset("mnist", train_size=2000, test_size=500, seed=0)
    clients = dirichlet_partition(ds.train_y, 7, 0.6, seed=0)
    return FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds, clients,
                  clusters, batch_size=16, seed=0)


@pytest.fixture(scope="module")
def task():
    """Ragged clusters: padded slots on the scanned path."""
    return make_task([[0, 1, 2], [3, 4], [5, 6]])


@pytest.fixture(scope="module")
def even_task():
    return make_task([[0, 1], [2, 3], [4, 5]])


def run_counted(run, task, cfg):
    build.reset_launches()
    res = run(task, cfg)
    torch.cuda.synchronize()
    return res, dict(build.LAUNCHES)


def assert_same_run(a, b, atol=0.0):
    assert a.rounds == b.rounds
    if atol == 0.0:
        assert a.test_acc == b.test_acc
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params)):
        torch.testing.assert_close(x, y, atol=atol, rtol=0)
    assert a.ledger.events == b.ledger.events and a.ledger.history == b.ledger.history
    np.testing.assert_allclose(a.train_loss, b.train_loss, atol=1e-5, rtol=0)


CASES = [
    (run_fed_chs, FedCHSConfig(rounds=5, local_steps=4, local_epochs=2, qsgd_levels=16,
                               eval_every=2, chunk_rounds=2)),
    (run_fed_chs, FedCHSConfig(rounds=4, local_steps=4, eval_every=2)),
    (run_fedavg, FedAvgConfig(rounds=3, local_steps=3, qsgd_levels=8, eval_every=1,
                              local_opt=MomentumSGD(0.5))),
    (run_wrwgd, WRWGDConfig(rounds=6, local_steps=3, eval_every=2)),
    (run_hier_local_qsgd, HierLocalQSGDConfig(rounds=3, local_steps=4, local_epochs=2,
                                              qsgd_levels=16, eval_every=1)),
]


@needs_card
@pytest.mark.parametrize("run,cfg", CASES, ids=["fed_chs_qsgd", "fed_chs_grad", "fedavg",
                                                 "wrwgd", "hier"])
def test_graph_replay_equals_eager_and_looped(task, even_task, monkeypatch, run, cfg):
    graphed, n_graphed = run_counted(run, task, cfg)
    assert engine.LIVE_GRAPHS == []
    looped, n_looped = run_counted(run, task, dataclasses.replace(cfg, scan_rounds=False))
    assert_same_run(graphed, looped, atol=1e-6 if run is run_fed_chs else 0.0)
    assert n_graphed == n_looped
    even, n_even = run_counted(run, even_task, cfg)
    even_looped, n_even_looped = run_counted(run, even_task,
                                             dataclasses.replace(cfg, scan_rounds=False))
    assert_same_run(even, even_looped)
    assert n_even == n_even_looped
    monkeypatch.setattr(engine, "_GraphRounds", engine._EagerRounds)
    eager, n_eager = run_counted(run, task, cfg)
    assert_same_run(graphed, eager)
    assert n_graphed == n_eager


@needs_card
def test_a_chunk_of_replays_syncs_nothing(task):
    cfg = FedCHSConfig(rounds=9, local_steps=4, local_epochs=2, qsgd_levels=16,
                       eval_every=100, chunk_rounds=4)
    plan, _, _ = _fed_chs_scan_plan(task, task.source, cfg)
    rounds = engine._GraphRounds(plan.body, plan.carry, plan.consts, torch.device("cuda"))
    try:
        rounds.run(plan.stage(np.arange(0, 4)))  # warm-up, capture, 3 replays
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = rounds.run(plan.stage(np.arange(4, 8)))  # stage, one copy, 4 replays
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        assert bool(torch.isfinite(losses).all())
    finally:
        rounds.close()
    assert engine.LIVE_GRAPHS == []


@needs_card
def test_a_scanned_run_frees_its_graph_pool(task):
    cfg = FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, qsgd_levels=16, eval_every=1)
    run_fed_chs(task, cfg)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    plan, params_of, _ = _fed_chs_scan_plan(task, task.source, cfg)
    during = []

    def record(t, carry, losses, t_l):
        during.append((len(engine.LIVE_GRAPHS), torch.cuda.memory_reserved()))

    carry = engine.run_scan(plan, record)
    torch.cuda.synchronize()
    assert [n for n, _ in during] == [0, 1, 1, 1]  # captured after the first round
    assert engine.LIVE_GRAPHS == []
    after = torch.cuda.memory_reserved()
    carry_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(carry))
    # the run keeps its carry; the graph's pool went back to the device
    assert after <= before + carry_bytes + 8 * 2**20
    assert after < max(r for _, r in during)
