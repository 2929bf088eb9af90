"""The port's telemetry (`repro_torch.obs`) against the reference's
`repro.obs`, on the CPU.

* Tapped runs equal untapped runs bit for bit (params, eval trace, ledger)
  for all four drivers, scanned and looped: the taps read the round's
  tensors and write none.
* The tele of a run equals the reference's tele of the same run: `mass`
  exactly, the other taps at rtol 1e-5 (both packages sum in f32 in other
  orders), `drift` at 1e-4: it reads the applied update A = new_params -
  params, a difference whose entries carry ulp(params), and the two runs'
  params are up to an ulp apart (measured up to 1.9e-5).  A dense
  channel's `comp_err` is a float residual in both, held under 1e-6 of |p|.
  Dense runs at a small step, so the trajectories stay together; a QSGD
  run's first round is held the same way.
* The span tracer, `RunTelemetry`'s rows, JSONL, summary and lazy chunk
  records, the merged Chrome trace against the reference's on the same
  ledger and netsim replay, and the validator's rejections.
* Taps under `client_microbatch` raise, and `run_sweep` rejects telemetry.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.netsim as jnet
import repro.obs as jobs
from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core import baselines as jb
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro.obs import taps as jtaps
import repro_torch.netsim as tnet
from repro_torch.core import baselines as tb
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.ledger import CommLedger
from repro_torch.core.simulation import FLTask, RunResult
from repro_torch.core.sweep import run_sweep
from repro_torch.models.classifier import make_classifier
from repro_torch.obs import (
    RunTelemetry,
    SpanTracer,
    build_chrome_trace,
    maybe_span,
    validate_chrome_trace,
    write_metrics_jsonl,
)
from repro_torch.obs import taps
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)


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


# (id, port run, config, reference run, reference config)
DRIVERS = [
    ("fed_chs_qsgd", run_fed_chs, FedCHSConfig, jax_run_fed_chs, JaxFedCHSConfig,
     dict(rounds=3, local_steps=4, local_epochs=2, eval_every=1, qsgd_levels=16)),
    ("fed_chs_grad", run_fed_chs, FedCHSConfig, jax_run_fed_chs, JaxFedCHSConfig,
     dict(rounds=3, local_steps=4, eval_every=1)),
    ("fedavg", tb.run_fedavg, tb.FedAvgConfig, jb.run_fedavg, jb.FedAvgConfig,
     dict(rounds=2, local_steps=3, eval_every=1, qsgd_levels=16)),
    ("wrwgd", tb.run_wrwgd, tb.WRWGDConfig, jb.run_wrwgd, jb.WRWGDConfig,
     dict(rounds=6, local_steps=3, eval_every=2)),
    ("hier", tb.run_hier_local_qsgd, tb.HierLocalQSGDConfig, jb.run_hier_local_qsgd,
     jb.HierLocalQSGDConfig, dict(rounds=2, local_steps=4, local_epochs=2, eval_every=1)),
]


@pytest.mark.parametrize("scan_rounds", [True, False], ids=["scanned", "looped"])
@pytest.mark.parametrize("run,cfg,kw", [(c[1], c[2], c[5]) for c in DRIVERS],
                         ids=[c[0] for c in DRIVERS])
def test_tapped_run_equals_untapped_run(pair, run, cfg, kw, scan_rounds):
    task = pair[1]
    plain = run(task, cfg(scan_rounds=scan_rounds, **kw))
    obs = RunTelemetry()
    tapped = run(task, cfg(scan_rounds=scan_rounds, obs=obs, **kw))
    for a, b in zip(tree_leaves(plain.final_params), tree_leaves(tapped.final_params)):
        assert torch.equal(a, b)
    assert plain.test_acc == tapped.test_acc and plain.rounds == tapped.rounds
    assert plain.ledger.events == tapped.ledger.events
    assert plain.ledger.history == tapped.ledger.history
    assert tapped.telemetry is obs and plain.telemetry is None
    trained = len(obs.rounds)
    assert trained == kw["rounds"] and obs.rounds == list(range(kw["rounds"]))
    assert set(obs.metrics) >= {"update_norm", "drift", "comp_err", "mass"}
    assert all(np.all(np.isfinite(v)) for vs in obs.metrics.values() for v in vs)
    spans = obs.summary()["spans"]
    assert "eval" in spans
    assert ("scan_chunk" in spans) == scan_rounds and ("round" in spans) != scan_rounds


@pytest.mark.parametrize("run,cfg,kw", [(c[1], c[2], c[5]) for c in DRIVERS],
                         ids=[c[0] for c in DRIVERS])
def test_scanned_tele_equals_looped_tele(pair, run, cfg, kw):
    task = pair[1]
    a, b = RunTelemetry(), RunTelemetry()
    run(task, cfg(scan_rounds=True, obs=a, chunk_rounds=1, **kw))
    run(task, cfg(scan_rounds=False, obs=b, **kw))
    assert a.rounds == b.rounds
    for k in b.metrics:
        np.testing.assert_allclose(np.asarray(a.metrics[k]), np.asarray(b.metrics[k]),
                                   rtol=1e-6, atol=0)


# dense runs (grad mode for the walk): the trajectories stay within float
# order of each other, so every round's tele is comparable
TELE_CASES = [
    ("fed_chs", run_fed_chs, FedCHSConfig, jax_run_fed_chs, JaxFedCHSConfig,
     dict(rounds=3, local_steps=4, local_epochs=2, eval_every=1, schedule=lambda k: 0.05)),
    ("fed_chs_grad", run_fed_chs, FedCHSConfig, jax_run_fed_chs, JaxFedCHSConfig,
     dict(rounds=3, local_steps=4, eval_every=1, scan_rounds=False,
          schedule=lambda k: 0.05)),
    ("fedavg", tb.run_fedavg, tb.FedAvgConfig, jb.run_fedavg, jb.FedAvgConfig,
     dict(rounds=2, local_steps=3, eval_every=1, schedule=lambda k: 0.05)),
    ("wrwgd", tb.run_wrwgd, tb.WRWGDConfig, jb.run_wrwgd, jb.WRWGDConfig,
     dict(rounds=6, local_steps=3, eval_every=2, scan_rounds=False)),
    ("hier", tb.run_hier_local_qsgd, tb.HierLocalQSGDConfig, jb.run_hier_local_qsgd,
     jb.HierLocalQSGDConfig,
     dict(rounds=2, local_steps=4, local_epochs=2, eval_every=1, qsgd_levels=None)),
]


# drift reads A = new_params - params, whose entries carry ulp(params): the
# runs' params one ulp apart move it by up to 1.9e-5 here (ROADMAP Queue C)
DRIFT_RTOL = 1e-4


def assert_tele_matches(tele, jtele, p_norm, rounds=None):
    assert tele.rounds[:rounds] == jtele.rounds[:rounds]
    assert set(tele.metrics) == set(jtele.metrics)
    for k in jtele.metrics:
        got = np.asarray(tele.metrics[k][:rounds], np.float64)
        want = np.asarray(jtele.metrics[k][:rounds], np.float64)
        if k == "mass":
            np.testing.assert_array_equal(got, want)
        elif k.endswith("comp_err") and np.all(want < 1e-6 * p_norm):
            assert np.all(got < 1e-6 * p_norm), (k, got)  # a dense channel's residual
        else:
            np.testing.assert_allclose(got, want, rtol=DRIFT_RTOL if k == "drift" else 1e-5,
                                       atol=0, err_msg=k)


@pytest.mark.parametrize("run,cfg,jrun,jcfg,kw", [c[1:] for c in TELE_CASES],
                         ids=[c[0] for c in TELE_CASES])
def test_tele_matches_reference(pair, run, cfg, jrun, jcfg, kw):
    jtask, task = pair
    tele, jtele = RunTelemetry(), jobs.RunTelemetry()
    res = run(task, cfg(obs=tele, **kw))
    jrun(jtask, jcfg(obs=jtele, **kw))
    assert_tele_matches(tele, jtele, np.linalg.norm(flat(tree_leaves(res.final_params))))
    assert tele.rounds == list(range(kw["rounds"]))


def test_qsgd_first_round_tele_matches_reference(pair):
    """A QSGD(16) round from identical inputs: codes are the reference's
    (both packages draw the same dither), so the first round's tele agrees."""
    jtask, task = pair
    kw = dict(rounds=1, local_steps=4, local_epochs=2, eval_every=1, qsgd_levels=16)
    tele, jtele = RunTelemetry(), jobs.RunTelemetry()
    res = run_fed_chs(task, FedCHSConfig(obs=tele, **kw))
    jax_run_fed_chs(jtask, JaxFedCHSConfig(obs=jtele, **kw))
    assert tele.metrics["comp_err"][0] > 0
    assert_tele_matches(tele, jtele, np.linalg.norm(flat(tree_leaves(res.final_params))))


def test_taps_match_reference_taps_on_random_inputs():
    rng = np.random.default_rng(0)
    raw = {"w": rng.normal(size=(5, 3, 4)).astype(np.float32),
           "b": rng.normal(size=(5, 4)).astype(np.float32)}
    applied = {"w": rng.normal(size=(3, 4)).astype(np.float32),
               "b": rng.normal(size=(4,)).astype(np.float32)}
    gammas = np.asarray([0.3, 0.0, 0.2, 0.5, 0.0], np.float32)
    mask = np.asarray([1, 0, 1, 1, 0], np.float32)
    to_t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    to_j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    for m in (None, mask):
        got = taps.delta_taps(to_t(raw), to_t(applied), torch.from_numpy(gammas),
                              None if m is None else torch.from_numpy(m))
        want = jtaps.delta_taps(to_j(raw), to_j(applied), jnp.asarray(gammas),
                                None if m is None else jnp.asarray(m))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    got = taps.grad_taps(to_t(applied), to_t({k: v[0] for k, v in raw.items()}),
                         torch.from_numpy(gammas))
    want = jtaps.grad_taps(to_j(applied), to_j({k: v[0] for k, v in raw.items()}),
                           jnp.asarray(gammas))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(taps.tree_client_norms(to_t(raw)).numpy(),
                               np.asarray(jtaps.tree_client_norms(to_j(raw))), rtol=1e-6)


def test_taps_are_read_only():
    """No tap writes into its inputs (the params/optimizer path reads them
    after the tap)."""
    raw = {"w": torch.randn(4, 6), "b": torch.randn(4, 2).to(torch.bfloat16)}
    applied = {"w": torch.randn(6), "b": torch.randn(2)}
    gammas, mask = torch.tensor([0.5, 0.5, 0.0, 0.0]), torch.tensor([1.0, 1.0, 0.0, 1.0])
    before = [t.clone() for t in tree_leaves((raw, applied, gammas, mask))]
    taps.delta_taps(raw, applied, gammas, mask)
    taps.grad_taps(applied, raw, gammas)
    for a, b in zip(before, tree_leaves((raw, applied, gammas, mask))):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# tracer, carrier, export
# --------------------------------------------------------------------------


def test_span_tracer_nesting_and_wall():
    tr = SpanTracer()
    with tr.span("outer"):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            pass
    assert [(k, n) for k, n, _ in tr.events] == [
        ("B", "outer"), ("B", "inner"), ("E", "inner"),
        ("B", "inner"), ("E", "inner"), ("E", "outer")]
    ts = [t for _, _, t in tr.events]
    assert ts == sorted(ts) and ts[0] == 0.0
    assert tr.wall("outer") >= tr.wall("inner") >= 0.0
    with maybe_span(None, "nothing"):
        pass


def test_profiler_passthrough_names_spans_in_a_torch_profile():
    obs = RunTelemetry(profiler=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("round"):
            with obs.span("eval"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"round", "eval"} <= names


def test_run_telemetry_rows_and_jsonl(tmp_path):
    obs = RunTelemetry()
    obs.record_round(0, {"update_norm": torch.tensor(1.5), "mass": torch.tensor(3.0)})
    obs.record_stacked([1, 2], {"update_norm": torch.tensor([2.0, 2.5]),
                                "mass": torch.tensor([3.0, 2.0])})
    rows = obs.metrics_rows()
    assert [r["round"] for r in rows] == [0, 1, 2]
    assert rows[1]["update_norm"] == 2.0
    path = tmp_path / "m.jsonl"
    assert write_metrics_jsonl(obs, path) == 3
    back = [json.loads(line) for line in path.read_text().splitlines()]
    assert back == rows
    s = obs.summary()
    assert s["rounds"] == 3 and s["metrics"]["mass"]["max"] == 3.0
    jo = jobs.RunTelemetry()
    jo.record_round(0, {"update_norm": jnp.float32(1.5), "mass": jnp.float32(3)})
    jo.record_stacked([1, 2], {"update_norm": jnp.asarray([2.0, 2.5]),
                               "mass": jnp.asarray([3.0, 2.0])})
    assert jo.metrics_rows() == rows and jo.summary()["metrics"] == s["metrics"]


def test_record_stacked_is_lazy_unless_sync_chunks():
    lazy, eager = RunTelemetry(), RunTelemetry(sync_chunks=True)
    for obs in (lazy, eager):
        obs.record_stacked([0, 1], {"mass": torch.tensor([1.0, 2.0]),
                                    "update_norm": torch.tensor([[1.0, 2.0], [3.0, 4.0]])})
    assert len(lazy._pending) == 1 and not lazy._rounds
    assert not eager._pending and eager._rounds == [0, 1]
    assert lazy.rounds == [0, 1] and not lazy._pending
    np.testing.assert_array_equal(lazy.metrics["update_norm"][1], [3.0, 4.0])
    assert lazy.metrics_rows() == eager.metrics_rows()


def test_chunking_does_not_change_tele(pair):
    task = pair[1]
    kw = dict(rounds=4, local_steps=4, local_epochs=2, eval_every=3, qsgd_levels=16)
    a, b = RunTelemetry(), RunTelemetry()
    run_fed_chs(task, FedCHSConfig(obs=a, chunk_rounds=1, **kw))
    run_fed_chs(task, FedCHSConfig(obs=b, chunk_rounds=32, **kw))
    assert a.metrics_rows() == b.metrics_rows()


def test_validate_catches_malformed_traces():
    for validate in (validate_chrome_trace, jobs.validate_chrome_trace):
        assert validate({}) == ["traceEvents missing or not a list"]
        mismatched = {"traceEvents": [
            {"ph": "B", "pid": 1, "tid": "t", "name": "a", "ts": 1.0},
            {"ph": "E", "pid": 1, "tid": "t", "name": "b", "ts": 2.0}]}
        assert any("closes" in p for p in validate(mismatched))
        unclosed = {"traceEvents": [{"ph": "B", "pid": 1, "tid": "t", "name": "a", "ts": 1.0}]}
        assert any("unclosed" in p for p in validate(unclosed))
        backwards = {"traceEvents": [
            {"ph": "i", "pid": 2, "tid": "h", "name": "x", "ts": 5.0},
            {"ph": "i", "pid": 2, "tid": "h", "name": "y", "ts": 1.0}]}
        assert any("<" in p for p in validate(backwards))
        bad_ts = {"traceEvents": [{"ph": "i", "pid": 2, "tid": "h", "name": "x", "ts": -1}]}
        assert any("bad ts" in p for p in validate(bad_ts))
        ok = {"traceEvents": [
            {"ph": "i", "pid": 2, "tid": "h", "cat": "comm", "name": "x", "ts": 1.0}]}
        assert validate(ok, expected_comm_events=2)  # count mismatch
        assert validate(ok, expected_comm_events=1) == []


def comparable(trace, pids=(2, 3)):
    return [e for e in trace["traceEvents"] if e.get("pid") in pids]


@pytest.mark.parametrize("deadline", [False, True], ids=["replay", "deadline"])
def test_chrome_trace_matches_reference(pair, deadline):
    """One port run's ledger replayed by each package's netsim: the comm
    and netsim tracks of the merged traces are equal event for event."""
    task = pair[1]
    obs = RunTelemetry()
    cfg = FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, eval_every=2, obs=obs)
    res = run_fed_chs(task, cfg)
    kw = dict(local_steps=cfg.local_steps, batch_size=task.batch_size,
              num_params=task.num_params())
    if deadline:
        kw["deadline_s"] = 0.5
    jobs_t, tl = tnet.replay_run(res, tnet.edge_cloud_network(seed=0, straggler_frac=0.3), **kw)
    jobs_j, jtl = jnet.replay_run(res, jnet.edge_cloud_network(seed=0, straggler_frac=0.3),
                                  **kw)
    trace = build_chrome_trace(obs, res.ledger, jobs_t, tl)
    jtrace = jobs.build_chrome_trace(None, res.ledger, jobs_j, jtl)
    assert validate_chrome_trace(trace, expected_comm_events=len(res.ledger.events)) == []
    assert comparable(trace) == comparable(jtrace)
    assert trace["otherData"] == jtrace["otherData"]
    assert sum(e.get("ph") == "X" for e in trace["traceEvents"]) == len(jobs_t)
    assert {e["pid"] for e in trace["traceEvents"]} == {1, 2, 3}
    host = [e["name"] for e in trace["traceEvents"] if e.get("pid") == 1 and e["ph"] == "B"]
    assert {"precompute", "stage", "scan_chunk", "eval", "materialize"} <= set(host)
    if deadline:
        assert any(e["name"].startswith("dropped:") for e in trace["traceEvents"])


def test_trace_without_replay_uses_stream_order_clock(pair):
    task = pair[1]
    obs = RunTelemetry(taps=False)
    res = run_fed_chs(task, FedCHSConfig(rounds=2, local_steps=4, local_epochs=2,
                                         eval_every=1, seed=1, obs=obs, scan_rounds=False))
    trace = build_chrome_trace(obs, res.ledger)
    assert validate_chrome_trace(trace, expected_comm_events=len(res.ledger.events)) == []
    assert comparable(trace) == comparable(jobs.build_chrome_trace(None, res.ledger))
    assert not obs.metrics  # taps=False: spans only, no tele
    assert obs.summary()["spans"]["round"] > 0


def test_empty_run_result_reads_worst_and_sim_time_is_none():
    for mode, worst in (("max", 0.0), ("min", float("inf"))):
        r = RunResult("x", [], [], [], CommLedger(), None, metric_mode=mode)
        assert r.best_acc() == worst and r.final_acc() == worst
        assert r.telemetry is None and r.sim_times is None
        assert r.sim_time_to_accuracy(0.5) is None


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("run,cfg,kw", [
    (run_fed_chs, FedCHSConfig, dict(local_epochs=2, scan_rounds=True)),
    (run_fed_chs, FedCHSConfig, dict(local_epochs=2, scan_rounds=False)),
    (tb.run_fedavg, tb.FedAvgConfig, dict(scan_rounds=False)),
    (tb.run_hier_local_qsgd, tb.HierLocalQSGDConfig, dict(local_epochs=2, scan_rounds=True)),
], ids=["fed_chs_scanned", "fed_chs_looped", "fedavg_looped", "hier_scanned"])
def test_taps_with_client_microbatch_raise(pair, run, cfg, kw):
    with pytest.raises(ValueError, match="client_microbatch"):
        run(pair[1], cfg(rounds=1, local_steps=2, eval_every=1, client_microbatch=2,
                         obs=RunTelemetry(), **kw))


def test_spans_only_run_with_client_microbatch(pair):
    """Without taps a microbatched run traces its spans as usual."""
    obs = RunTelemetry(taps=False)
    run_fed_chs(pair[1], FedCHSConfig(rounds=1, local_steps=2, local_epochs=2, eval_every=1,
                                      client_microbatch=2, obs=obs))
    assert "scan_chunk" in obs.summary()["spans"] and not obs.metrics


def test_sweep_rejects_telemetry(pair):
    cfg = FedCHSConfig(rounds=2, local_steps=2, eval_every=1, obs=RunTelemetry())
    with pytest.raises(AssertionError, match="telemetry"):
        run_sweep(pair[1], cfg, (0, 1))
