"""The port's federation mesh (`repro_torch.sharding`, `launch.mesh`) on the
CPU: four `gloo` ranks, spawned once for the module, run every mesh case
of the reference's `tests/test_sharding_fed.py` on a (2, 2) mesh and hand
their results back; the main process holds them

* against the port's single-device run of the same config, bit for bit:
  params, `test_acc`, `ledger.total_bits()` and `ledger.history` (and the
  ledger's bits and events); train-loss log scalars exact in grad mode,
  within rtol 1e-6 in the delta modes.  This holds where local training
  does not depend on how many clients one vmap carries: every MLP task on
  the CPU.  A small LeNet is held at 1e-6 of its update beside its own
  1-ulp control (a vmapped convolution is not lane-count invariant on the
  CPU), with its ledger exact;
* against the reference's single-device run, at the tolerances of
  `tests/test_torch_fed_chs.py` and `tests/test_torch_baselines.py`
  (dense: params atol 1e-6, loss rtol 1e-5; QSGD: params within 3% of
  their norm, loss rtol 0.05, accuracy 0.02), ledgers exact;

and checks the structure: each rank copies 1/size of a staged chunk's
batch bytes, the ambient mesh is adopted and a mesh of other axes is not,
telemetry and `client_microbatch` with a mesh are refused, `Precision` on
a mesh runs the master-dtype round (and a promoted optimizer state raises)
as the reference's sharded bodies do, the seed-lane sweep is bit-equal to
solo runs, and the rank-free paths (a 1-rank mesh, the fallback with its
warning, `run_sweep` refusing a `config.mesh`).  `fed_engine_pspecs`,
`param_pspecs`, `batch_pspec` and `cache_pspecs` equal the reference's
`PartitionSpec`s as tuples on the configs of `tests/test_sharding_dryrun.py`,
but for one deliberate difference: MLA's `k_rope` cache takes `c_kv`'s
sequence split (the port's MLA decode scores each rank's share of the
positions against both).

The ranks import this module, so it imports jax and the reference lazily,
inside the tests that compare against them.
"""
import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

from repro_torch.core.baselines.fedavg import FedAvgConfig, _fedavg_scan_plan, run_fedavg
from repro_torch.core.baselines.hier_local_qsgd import HierLocalQSGDConfig, run_hier_local_qsgd
from repro_torch.core.baselines.wrwgd import WRWGDConfig, run_wrwgd
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.precision import Precision, resolve_channel
from repro_torch.core.simulation import FLTask
from repro_torch.core.sweep import run_sweep
from repro_torch.data import Dataset, assign_clusters, dirichlet_partition, make_dataset
from repro_torch.data.synthetic import DatasetSpec
from repro_torch.launch.mesh import make_federation_mesh, spawn_ranks
from repro_torch.models.classifier import Classifier, make_classifier
from repro_torch.optim.local import MomentumSGD
from repro_torch.sharding.ctx import model_mesh
from repro_torch.sharding.fed import resolve_mesh
from repro_torch.sharding.specs import FED_AXES
from repro_torch.utils import tree_leaves

torch.set_num_threads(1)

RUNS = {"fed_chs": (run_fed_chs, FedCHSConfig), "fedavg": (run_fedavg, FedAvgConfig),
        "wrwgd": (run_wrwgd, WRWGDConfig), "hier": (run_hier_local_qsgd, HierLocalQSGDConfig)}


# --------------------------------------------------------------------------
# tasks: numpy data and weights, so the ranks need no jax
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tiny_arrays():
    """The reference's `tiny_task` data (16 -> 32 -> 4 MLP, 400 images of
    4 x 4, 20 clients) and He-normal weights drawn with numpy."""
    rng = np.random.default_rng(0)
    train_y = rng.integers(0, 4, 400).astype(np.int32)
    test_y = rng.integers(0, 4, 80).astype(np.int32)
    protos = rng.normal(size=(4, 4, 4, 1)).astype(np.float32)
    train_x = (protos[train_y] + 0.3 * rng.normal(size=(400, 4, 4, 1))).astype(np.float32)
    test_x = (protos[test_y] + 0.3 * rng.normal(size=(80, 4, 4, 1))).astype(np.float32)
    w = np.random.default_rng(1)
    weights = {"fc1": {"w": (w.normal(size=(16, 32)) * np.sqrt(2 / 16)).astype(np.float32),
                       "b": np.zeros(32, np.float32)},
               "out": {"w": (w.normal(size=(32, 4)) * np.sqrt(2 / 32)).astype(np.float32),
                       "b": np.zeros(4, np.float32)}}
    return train_x, train_y, test_x, test_y, weights


def tiny_clusters(ragged: bool):
    train_y = tiny_arrays()[1]
    clients = dirichlet_partition(train_y, 20, 0.6, seed=0)
    if ragged:  # 7/5/4/4: padded client slots on every rank
        clusters = [list(range(0, 7)), list(range(7, 12)), list(range(12, 16)),
                    list(range(16, 20))]
    else:
        clusters = assign_clusters(20, 4, seed=0)
    return clients, clusters


def _tiny_apply(p, x):
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
    return x @ p["out"]["w"] + p["out"]["b"]


def tiny_task(ragged: bool = False, device="cpu") -> FLTask:
    train_x, train_y, test_x, test_y, weights = tiny_arrays()
    ds = Dataset(DatasetSpec("tiny", (4, 4, 1), 4, 400, 80), train_x, train_y, test_x, test_y)

    def init(seed=0, device=None):
        return {k: {n: torch.from_numpy(a.copy()).to(device) for n, a in v.items()}
                for k, v in weights.items()}

    clients, clusters = tiny_clusters(ragged)
    return FLTask(Classifier("tiny-mlp", init, _tiny_apply, 4), ds, clients, clusters,
                  batch_size=8, seed=0, device=device)


def mnist_task(device="cpu") -> FLTask:
    """The reference's MNIST-MLP scale cell: 784 -> 200 -> 200 -> 10."""
    ds = make_dataset("mnist", train_size=600, test_size=150, seed=0)
    clients = dirichlet_partition(ds.train_y, 8, 0.6, seed=0)
    model = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    return FLTask(model, ds, clients, [[0, 1, 2], [3, 4, 5], [6, 7]], batch_size=8, seed=0,
                  device=device)


def lenet_task(device="cpu", ulp: bool = False) -> FLTask:
    """A narrow LeNet (width 1/8) on 8 MNIST clients; `ulp` nudges every
    weight one float32 ulp up (the control)."""
    ds = make_dataset("mnist", train_size=400, test_size=100, seed=0)
    clients = dirichlet_partition(ds.train_y, 8, 0.6, seed=0)
    model = make_classifier("lenet", "mnist", ds.spec.image_shape, 10, width_scale=0.125)
    if ulp:
        init0 = model.init

        def init(seed=0, device=None):
            p = init0(seed, device)
            return {k: {n: torch.nextafter(a, torch.full_like(a, np.inf)) for n, a in v.items()}
                    for k, v in p.items()}

        model = dataclasses.replace(model, init=init)
    return FLTask(model, ds, clients, [[0, 1, 2, 3], [4, 5, 6, 7]], batch_size=8, seed=0,
                  device=device)


TASKS = {"tiny": lambda: tiny_task(), "ragged": lambda: tiny_task(True),
         "mnist": mnist_task, "lenet": lenet_task}

# (id, driver, config fields, task, exact loss, reference tolerance)
CHS = dict(rounds=6, local_steps=4, local_epochs=2, eval_every=3, seed=0)
AVG = dict(rounds=4, local_steps=4, eval_every=2, seed=0)
HIER = dict(rounds=4, local_steps=4, local_epochs=2, eval_every=2, seed=0)
CASES = [
    ("fed_chs_grad", "fed_chs", dict(rounds=6, eval_every=3, seed=0), "tiny", True, "dense"),
    ("fed_chs_dense", "fed_chs", CHS, "tiny", False, "dense"),
    ("fed_chs_qsgd16", "fed_chs", dict(CHS, qsgd_levels=16), "tiny", False, "lossy"),
    ("fedavg_dense", "fedavg", AVG, "tiny", False, "dense"),
    ("fedavg_qsgd16", "fedavg", dict(AVG, qsgd_levels=16), "tiny", False, "lossy"),
    ("wrwgd_data_size", "wrwgd", dict(rounds=6, local_steps=4, eval_every=3, seed=0), "tiny",
     True, "dense"),
    ("wrwgd_uniform", "wrwgd", dict(rounds=6, local_steps=4, eval_every=3, seed=2,
                                    weighting="uniform"), "tiny", True, "dense"),
    ("hier_dense", "hier", dict(HIER, qsgd_levels=None), "tiny", False, "dense"),
    ("hier_qsgd16", "hier", dict(HIER, qsgd_levels=16), "tiny", False, "lossy"),
    ("ragged_fed_chs_qsgd16", "fed_chs", dict(rounds=4, local_steps=4, local_epochs=2,
                                              qsgd_levels=16, eval_every=2, seed=1),
     "ragged", False, "lossy"),
    ("ragged_hier_qsgd16", "hier", dict(rounds=2, local_steps=4, local_epochs=2,
                                        qsgd_levels=16, eval_every=1, seed=1),
     "ragged", False, "lossy"),
    ("fedavg_momentum", "fedavg", dict(AVG, local_opt=MomentumSGD(0.9)), "tiny", False, "dense"),
    ("hier_momentum_qsgd16", "hier", dict(HIER, qsgd_levels=16, local_opt=MomentumSGD(0.9)),
     "tiny", False, "lossy"),
]
EXACT = {c[0]: c for c in CASES}
MNIST = ("fedavg", dict(rounds=3, local_steps=3, eval_every=1, seed=0))
LENET = ("fed_chs", dict(rounds=3, local_steps=4, local_epochs=2, qsgd_levels=16,
                         eval_every=1, seed=0, schedule=lambda k: 0.05))
PREC = dict(rounds=3, local_steps=2, eval_every=1, seed=0, precision=Precision())
SWEEP = FedAvgConfig(rounds=3, local_steps=4, eval_every=1)
SWEEP_CHS = FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, qsgd_levels=16, eval_every=2)


def summary(res) -> dict:
    """What a rank hands back of a run: numpy params, logs, the ledger."""
    led = res.ledger
    return {"params": [a.detach().cpu().numpy() for a in tree_leaves(res.final_params)],
            "rounds": list(res.rounds), "test_acc": list(res.test_acc),
            "train_loss": list(res.train_loss), "total_bits": led.total_bits(),
            "history": led.history, "bits": dict(led.bits), "messages": dict(led.messages),
            "events": list(led.events)}


def _run(driver, fields, task, mesh=None):
    run, cls = RUNS[driver]
    return run(task, cls(**fields, mesh=mesh))


def _raises(fn) -> str | None:
    """The exception type a call raises, by name (None: it returned)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the name is the result)
        return type(e).__name__
    return None


def rank_cases(rank: int) -> dict:
    """Every mesh case, on one rank of the (2, 2) mesh."""
    from repro_torch.core import engine
    from repro_torch.obs import RunTelemetry

    mesh = make_federation_mesh(2, 2, device="cpu")
    assert mesh.size == 4 and mesh.axis_names == FED_AXES and mesh.rank == rank
    tasks = {k: make() for k, make in TASKS.items()}
    out = {"coord": mesh.coord, "cases": {}, "executors": set()}
    for name, driver, fields, task, _, _ in CASES:
        out["cases"][name] = summary(_run(driver, fields, tasks[task], mesh))
        out["executors"].add(engine.LAST_STATS["executor"])
    out["mnist"] = summary(_run(*MNIST, tasks["mnist"], mesh))
    out["lenet"] = summary(_run(*LENET, tasks["lenet"], mesh))
    out["precision_fedavg"] = summary(_run("fedavg", PREC, tasks["tiny"], mesh))
    out["precision_fed_chs_qsgd16"] = summary(
        _run("fed_chs", dict(PREC, local_steps=4, local_epochs=2, qsgd_levels=16),
             tasks["tiny"], mesh))
    out["precision_momentum"] = _raises(lambda: _run(
        "fedavg", dict(PREC, local_opt=MomentumSGD(0.9)), tasks["tiny"], mesh))

    # the ambient mesh, and the mesh of other axes that is not adopted
    with model_mesh(mesh):
        out["ambient_resolves"] = resolve_mesh(None) is mesh
        out["ambient"] = summary(run_fedavg(tasks["tiny"], FedAvgConfig(**AVG)))
    out["refusals"] = {
        "telemetry": _raises(lambda: run_fedavg(tasks["tiny"], FedAvgConfig(
            rounds=2, local_steps=2, eval_every=1, mesh=mesh, obs=RunTelemetry()))),
        "client_microbatch": _raises(lambda: run_fed_chs(tasks["tiny"], FedCHSConfig(
            rounds=2, local_steps=2, local_epochs=2, mesh=mesh, client_microbatch=2))),
    }
    out["looped_ignores_mesh"] = summary(run_fed_chs(tasks["tiny"], FedCHSConfig(
        **CHS, scan_rounds=False, mesh=mesh)))

    # staged bytes: each rank copies 1/size of an unsharded chunk's batch
    task = tasks["tiny"]
    plan, _, _ = _fedavg_scan_plan(task, task.source, FedAvgConfig(**AVG))
    idxs = np.flatnonzero(plan.trained)
    whole = sum(a.nbytes for a in tree_leaves(plan.stage(idxs)["batch"]))
    plan, _, _ = _fedavg_scan_plan(task, task.source, FedAvgConfig(**AVG, mesh=mesh))
    mine = plan.xs_put(plan.stage(idxs))["batch"]
    out["staged"] = (whole, sum(a.numel() * a.element_size() for a in tree_leaves(mine)))

    # seed lanes over the ranks: 4 seeds split, 3 seeds run unsharded
    out["sweep"] = [summary(r) for r in run_sweep(task, SWEEP, range(4), mesh=mesh)]
    out["sweep_chs"] = [summary(r) for r in run_sweep(task, SWEEP_CHS, (0, 5, 6, 9), mesh=mesh)]
    logging.captureWarnings(True)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("repro_torch.core.engine").addHandler(handler)
    out["sweep3"] = [summary(r) for r in run_sweep(task, SWEEP, range(3), mesh=mesh)]
    out["sweep3_warned"] = any("does not divide" in r.getMessage() for r in records)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, from one spawn."""
    return spawn_ranks(rank_cases, 4, threads=1, tmp_dir=str(tmp_path_factory.mktemp("mesh")))


@functools.lru_cache(maxsize=None)
def solo(driver, fields_key, task_name):
    """The port's single-device run (cached per config)."""
    fields = dict(fields_key)
    return summary(_run(driver, fields, TASKS[task_name]()))


def _key(fields):
    return tuple(sorted(fields.items(), key=lambda kv: kv[0]))


def assert_bit_equal(got: dict, want: dict, exact_loss: bool) -> None:
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_array_equal(a, b)
    assert got["rounds"] == want["rounds"] and got["test_acc"] == want["test_acc"]
    if exact_loss:
        assert got["train_loss"] == want["train_loss"]
    else:
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-6, atol=0)
    assert got["total_bits"] == want["total_bits"] and got["history"] == want["history"]
    assert got["bits"] == want["bits"] and got["events"] == want["events"]


# --------------------------------------------------------------------------
# mesh runs against the port's single-device runs
# --------------------------------------------------------------------------


def test_ranks_hold_replicated_results(ranks):
    """Every rank ends with the same params, logs and ledger; the coords are
    the row-major grid; every mesh run took the plan's own chunk."""
    assert [r["coord"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        for name in r["cases"]:
            assert_bit_equal(r["cases"][name], ranks[0]["cases"][name], exact_loss=True)
    assert ranks[0]["executors"] == {"chunk_fn"}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mesh_run_bit_equal_to_single_device(ranks, name):
    _, driver, fields, task, exact_loss, _ = EXACT[name]
    assert_bit_equal(ranks[0]["cases"][name], solo(driver, _key(fields), task), exact_loss)


def test_mnist_mlp_scale_parity(ranks):
    """The reference's MNIST-MLP cell at its tolerance (params rtol 1e-5,
    atol 1e-7; losses rtol 1e-4; ledger exact)."""
    got, want = ranks[0]["mnist"], solo(MNIST[0], _key(MNIST[1]), "mnist")
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4, atol=0)
    assert got["total_bits"] == want["total_bits"] and got["history"] == want["history"]


def _gap(a: dict, b: dict) -> float:
    return float(max(np.max(np.abs(x.astype(np.float64) - y)) for x, y in
                     zip(a["params"], b["params"])))


def test_lenet_mesh_run_within_its_control(ranks):
    """LeNet: the vmapped convolution is not lane-count invariant on the
    CPU.  The mesh run's params stay within 1e-6 of the update's size of
    the single-device run's and within the gap a 1-ulp nudge of the
    initial weights opens (the CPU read 2.98e-8 against 1.79e-7, the
    update 0.0767); the ledger is exact."""
    got = ranks[0]["lenet"]
    want = solo(LENET[0], _key(LENET[1]), "lenet")
    control = summary(_run(*LENET, lenet_task(ulp=True)))
    p0 = [a.numpy() for a in tree_leaves(lenet_task().init_params())]
    update = float(max(np.max(np.abs(w.astype(np.float64) - p)) for w, p in
                       zip(want["params"], p0)))
    gap = _gap(got, want)
    assert gap <= 1e-6 * update and gap <= _gap(control, want), \
        (gap, _gap(control, want), update)
    assert got["total_bits"] == want["total_bits"] and got["history"] == want["history"]
    assert got["events"] == want["events"]


def test_precision_on_a_mesh_runs_the_master_dtype_round(ranks):
    """The reference's sharded bodies take no compute casts: under a
    `Precision` a mesh run trains in the master dtype with the policy's
    channel and prices the ledger as the policy does; a momentum state made
    in the compute dtype and promoted by the round raises TypeError."""
    task = tiny_task()
    for name, driver, fields in [
            ("precision_fedavg", "fedavg", PREC),
            ("precision_fed_chs_qsgd16", "fed_chs",
             dict(PREC, local_steps=4, local_epochs=2, qsgd_levels=16))]:
        got = ranks[0][name]
        plain = dict(fields, precision=None,
                     channel=resolve_channel(Precision(), None, fields.get("qsgd_levels"), 32))
        plain.pop("qsgd_levels", None)
        want = summary(_run(driver, plain, task))
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.float32
        priced = summary(_run(driver, fields, task))
        assert got["total_bits"] == priced["total_bits"] and got["history"] == priced["history"]
    assert ranks[0]["precision_momentum"] == "TypeError"


def test_ambient_mesh_adopted_and_refusals(ranks):
    r = ranks[0]
    assert r["ambient_resolves"]
    assert_bit_equal(r["ambient"], solo("fedavg", _key(AVG), "tiny"), exact_loss=False)
    assert r["refusals"] == {"telemetry": "AssertionError",
                             "client_microbatch": "AssertionError"}
    # the looped driver ignores the mesh: it is the looped run
    looped = summary(run_fed_chs(tiny_task(), FedCHSConfig(**CHS, scan_rounds=False)))
    assert_bit_equal(r["looped_ignores_mesh"], looped, exact_loss=True)


def test_each_rank_stages_a_quarter_of_the_batch(ranks):
    for r in ranks:
        whole, mine = r["staged"]
        assert whole == 4 * mine


def test_sweep_lanes_over_ranks_equal_solo_runs(ranks):
    """4 seeds over 4 ranks (one lane each), FedAvg and Fed-CHS QSGD(16),
    and 3 seeds (not divisible: the warning, unsharded): every lane is its
    solo run, bit for bit, on every rank."""
    for r in ranks:
        for key, cfg, seeds in [("sweep", SWEEP, range(4)), ("sweep_chs", SWEEP_CHS, (0, 5, 6, 9)),
                                ("sweep3", SWEEP, range(3))]:
            for s, lane in zip(seeds, r[key]):
                run = run_fedavg if isinstance(cfg, FedAvgConfig) else run_fed_chs
                want = summary(run(tiny_task(), dataclasses.replace(cfg, seed=s)))
                assert_bit_equal(lane, want, exact_loss=True)
        assert r["sweep3_warned"]


# --------------------------------------------------------------------------
# the rank-free paths
# --------------------------------------------------------------------------


def test_run_sweep_rejects_config_mesh():
    cfg = FedAvgConfig(rounds=2, local_steps=2, eval_every=1, mesh=object())
    with pytest.raises(AssertionError, match="run_sweep shards the seed axis"):
        run_sweep(tiny_task(), cfg, range(2))


def test_single_device_federation_mesh_is_inert():
    m = make_federation_mesh(1, 1, device="cpu")
    assert m.axis_names == FED_AXES and m.size == 1 and resolve_mesh(m) is None
    cfg = FedAvgConfig(rounds=2, local_steps=2, eval_every=1, seed=0)
    r0 = summary(run_fedavg(tiny_task(), cfg))
    r1 = summary(run_fedavg(tiny_task(), dataclasses.replace(cfg, mesh=m)))
    assert_bit_equal(r1, r0, exact_loss=True)


def test_federation_mesh_falls_back_with_warning(caplog):
    with caplog.at_level("WARNING", logger="repro_torch.launch.mesh"):
        m = make_federation_mesh(2, 4, device="cpu")
    assert m.size == 1 and m.device == torch.device("cpu")
    assert any("falling back to a single-device mesh" in r.message for r in caplog.records)
    assert resolve_mesh(m) is None


def test_mesh_of_other_axes_is_not_adopted():
    class ModelMesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}
        size = 4

    assert resolve_mesh(None) is None
    with model_mesh(ModelMesh()):
        assert resolve_mesh(None) is None
    with pytest.raises(AssertionError, match="federation mesh must have axes"):
        resolve_mesh(ModelMesh())


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------


def _jax_tiny_task(ragged: bool):
    import jax.numpy as jnp
    from repro.core.simulation import FLTask as JaxFLTask
    from repro.data.synthetic import Dataset as JaxDataset
    from repro.data.synthetic import DatasetSpec as JaxDatasetSpec
    from repro.models.classifier import Classifier as JaxClassifier

    train_x, train_y, test_x, test_y, weights = tiny_arrays()
    ds = JaxDataset(JaxDatasetSpec("tiny", (4, 4, 1), 4, 400, 80), train_x, train_y, test_x,
                    test_y)
    p0 = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in weights.items()}

    def apply(p, x):
        import jax

        x = x.reshape(x.shape[0], -1)
        x = jax.nn.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
        return x @ p["out"]["w"] + p["out"]["b"]

    clients, clusters = tiny_clusters(ragged)
    return JaxFLTask(JaxClassifier("tiny-mlp", lambda key: p0, apply, 4), ds, clients, clusters,
                     batch_size=8, seed=0)


def _jax_config(driver, fields):
    from repro.core import FedCHSConfig as JChs
    from repro.core.baselines import FedAvgConfig as JAvg
    from repro.core.baselines import HierLocalQSGDConfig as JHier
    from repro.core.baselines import WRWGDConfig as JWalk
    from repro.optim import local as jlocal

    fields = dict(fields)
    if fields.get("local_opt") is not None:
        opt = fields["local_opt"]
        fields["local_opt"] = getattr(jlocal, type(opt).__name__)(**dataclasses.asdict(opt))
    return {"fed_chs": JChs, "fedavg": JAvg, "wrwgd": JWalk, "hier": JHier}[driver](**fields)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mesh_run_matches_reference_single_device(ranks, name):
    import jax

    from repro.core import run_fed_chs as j_chs
    from repro.core.baselines import run_fedavg as j_avg
    from repro.core.baselines import run_hier_local_qsgd as j_hier
    from repro.core.baselines import run_wrwgd as j_walk

    _, driver, fields, task, _, tol = EXACT[name]
    run = {"fed_chs": j_chs, "fedavg": j_avg, "wrwgd": j_walk, "hier": j_hier}[driver]
    jres = run(_jax_tiny_task(task == "ragged"), _jax_config(driver, fields))
    got = ranks[0]["cases"][name]
    assert got["rounds"] == jres.rounds
    assert got["bits"] == dict(jres.ledger.bits) and got["events"] == list(jres.ledger.events)
    assert got["history"] == jres.ledger.history
    flat_got = np.concatenate([a.ravel() for a in got["params"]]).astype(np.float64)
    flat_want = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(
        jres.final_params)]).astype(np.float64)
    if tol == "lossy":
        assert np.linalg.norm(flat_got - flat_want) <= 0.03 * np.linalg.norm(flat_want)
        np.testing.assert_allclose(got["test_acc"], jres.test_acc, atol=0.02)
        np.testing.assert_allclose(got["train_loss"], jres.train_loss, rtol=0.05)
    else:
        np.testing.assert_allclose(flat_got, flat_want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["test_acc"], jres.test_acc, atol=2 / 500)
        np.testing.assert_allclose(got["train_loss"], jres.train_loss, rtol=1e-5)


def test_fed_engine_pspecs_match_reference():
    from repro.sharding import specs as jspecs

    from repro_torch.sharding import specs

    for kind in ("grad", "delta", "cluster_delta", "multi"):
        got, want = specs.fed_engine_pspecs(kind), jspecs.fed_engine_pspecs(kind)
        assert got.keys() == want.keys()
        for part in ("carry", "ys"):
            g, w = got[part], want[part]
            if isinstance(w, tuple) and not isinstance(w, jspecs.P):
                assert [tuple(x) for x in g] == [tuple(x) for x in w]
            else:
                assert tuple(g) == tuple(w)
        assert {k: tuple(v) for k, v in got["xs"].items()} == \
            {k: tuple(v) for k, v in want["xs"].items()}
    with pytest.raises(ValueError):
        specs.fed_engine_pspecs("nope")


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _spec_paths(tree, is_leaf, path=()):
    """{path: spec} of a nested dict/list tree of specs."""
    if is_leaf(tree):
        return {path: tuple(tree)}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_spec_paths(v, is_leaf, path + (k,)))
    return out


@pytest.mark.parametrize("arch,mesh", [
    ("qwen3-0.6b", None), ("dbrx-132b", None), ("whisper-tiny", {"data": 16, "model": 16}),
    ("qwen3-0.6b", {"pod": 2, "data": 16, "model": 16}),
])
def test_param_pspecs_match_reference(arch, mesh):
    import jax
    from jax.sharding import PartitionSpec as JP
    from repro.configs.registry import smoke_config as jsmoke
    from repro.models import transformer as jtf
    from repro.sharding.specs import param_pspecs as jparam_pspecs

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.specs import PartitionSpec, param_pspecs

    jcfg = jsmoke(arch)
    if arch == "whisper-tiny":
        jcfg = dataclasses.replace(jcfg, vocab_size=51865)
    cfg = dataclasses.replace(smoke_config(arch), vocab_size=jcfg.vocab_size)
    fake = None if mesh is None else _FakeMesh(mesh)
    jparams = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    want = jparam_pspecs(jparams, num_experts=jcfg.num_experts, mesh=fake)
    got = param_pspecs(tf.init_params(cfg, 0, "cpu"), num_experts=cfg.num_experts, mesh=fake)
    assert _spec_paths(got, lambda x: isinstance(x, PartitionSpec)) == \
        _spec_paths(want, lambda x: isinstance(x, JP))


@pytest.mark.parametrize("batch", [256, 2, 1])
def test_batch_pspec_matches_reference(batch):
    from repro.sharding.specs import batch_pspec as jbatch_pspec

    from repro_torch.sharding.specs import batch_pspec

    fake = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    for rank in (1, 2, 3):
        assert tuple(batch_pspec(batch, fake, rank)) == tuple(jbatch_pspec(batch, fake, rank))


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mamba2-370m", "deepseek-v3-671b"])
def test_cache_pspecs_match_reference(arch):
    import jax
    from jax.sharding import PartitionSpec as JP
    from repro.configs.registry import smoke_config as jsmoke
    from repro.models import transformer as jtf
    from repro.sharding.specs import cache_pspecs as jcache_pspecs

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.specs import PartitionSpec, cache_pspecs

    fake = _FakeMesh({"data": 16, "model": 16})
    want = jcache_pspecs(jax.eval_shape(lambda: jtf.init_caches(jsmoke(arch), 128, 256)), 128,
                         fake)
    got = cache_pspecs(tf.init_caches(smoke_config(arch), 128, 256, device="cpu"), 128, fake)
    want = _spec_paths(want, lambda x: isinstance(x, JP))
    for path in [p for p in want if p[-1] == "k_rope"]:  # the deliberate difference
        want[path] = want[path[:-1] + ("c_kv",)]
    assert _spec_paths(got, lambda x: isinstance(x, PartitionSpec)) == want
