"""The port's checkpoints (`repro_torch.checkpoint`) against the reference's
`repro.checkpoint`, on the CPU.

* Round trips are bit-exact, bf16 and f16 leaves beside f32 ones; every
  leaf comes back in its `like` leaf's dtype and container.
* The structure, treedef, shape and missing-leaf errors name the leaf; a
  run state without its meta sidecar is no checkpoint.
* The stored treedef is `str(jax.tree.structure(...))` of the same tree,
  and a file either package writes loads in the other.
* The looped Fed-CHS driver, killed after round k and resumed, equals the
  uninterrupted scanned run bit for bit (f32 QSGD, and under `Precision()`
  with `MomentumSGD()` and `client_microbatch=2`: bf16 momentum beside
  f32 params); a run state the reference's looped driver saved resumes in
  the port and the reverse, each reaching the other package's own
  uninterrupted run within the run-parity tolerance (3% relative L2 of
  params for a lossy QSGD run, as `tests/test_torch_fed_chs.py` holds),
  with the ledger exact.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro_torch.checkpoint import (
    load_fl_state,
    load_pytree,
    load_run_state,
    run_state_exists,
    save_fl_state,
    save_pytree,
    save_run_state,
)
from repro_torch.checkpoint.io import treedef_str
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.precision import Precision
from repro_torch.core.simulation import FLTask
from repro_torch.models.classifier import make_classifier
from repro_torch.optim.local import MomentumSGD
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
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


def mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g)},
        "opt": {"0": (), "2": [torch.randn(3, 4, generator=g).to(torch.bfloat16),
                              torch.randn(2, generator=g).to(torch.float16)]},
        "key": np.asarray([7, 4294967295], np.uint32),
        "count": torch.tensor(3, dtype=torch.int32),
        "none": None,
        "tup": (torch.zeros(1),),
    }


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None:  # the port's tree helpers visit None as a leaf
            assert y is None
        elif isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype
            assert torch.equal(x.view(torch.uint8) if x.dtype.itemsize == 1 else x, y)
        else:
            assert isinstance(y, np.ndarray) and x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_round_trip_is_bit_exact_with_bf16_beside_f32(tmp_path):
    tree = mixed_tree()
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    back = load_pytree(path, tree)
    assert_trees_equal(tree, back)
    assert back["none"] is None and back["opt"]["0"] == () and isinstance(back["tup"], tuple)
    # the bit pattern is what is on disk: a bf16 leaf is half the bytes of f32
    with np.load(path) as data:
        assert data["opt/2/0"].dtype == np.uint16 and data["params/w"].dtype == np.float32


def test_a_leaf_loads_into_the_like_dtype(tmp_path):
    """A bf16 leaf read into an f32 `like` is cast from its true values."""
    bf = torch.randn(5).to(torch.bfloat16)
    path = str(tmp_path / "c.npz")
    save_pytree(path, {"x": bf})
    back = load_pytree(path, {"x": torch.zeros(5)})["x"]
    assert back.dtype == torch.float32 and torch.equal(back, bf.float())


@pytest.mark.parametrize("case", ["structure", "treedef", "shape", "missing"])
def test_load_errors_name_the_leaf(tmp_path, case):
    tree = {"a": torch.zeros(2, 3), "b": [torch.zeros(4)]}
    path = str(tmp_path / "e.npz")
    save_pytree(path, tree)
    if case == "structure":
        with pytest.raises(ValueError, match="leaf order"):
            load_pytree(path, {"a": torch.zeros(2, 3), "c": [torch.zeros(4)]})
    elif case == "treedef":  # same leaf paths, another container
        with pytest.raises(ValueError, match="treedef mismatch"):
            load_pytree(path, {"a": torch.zeros(2, 3), "b": (torch.zeros(4),)})
    elif case == "shape":
        with pytest.raises(ValueError, match="'b/0' has shape"):
            load_pytree(path, {"a": torch.zeros(2, 3), "b": [torch.zeros(5)]})
    else:  # a file without the meta record (a plain npz) missing a leaf
        np.savez(path, a=np.zeros((2, 3), np.float32))
        with pytest.raises(KeyError, match="no leaf 'b/0'"):
            load_pytree(path, tree)


def test_no_meta_sidecar_means_no_checkpoint(tmp_path):
    path = str(tmp_path / "run")
    tree = {"p": torch.ones(3)}
    save_run_state(path, tree, {"round": 2})
    assert run_state_exists(path)
    arrays, meta = load_run_state(path, tree)
    assert meta == {"round": 2} and torch.equal(arrays["p"], tree["p"])
    os.remove(path + ".meta.json")  # a save killed after the arrays, before the meta
    assert not run_state_exists(path)
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        load_run_state(path, tree)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def as_jax(tree):
    """The same structure with numpy leaves, as the reference holds them."""
    if isinstance(tree, dict):
        return {k: as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_jax(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return np.asarray(tree.float())
    return tree


@pytest.mark.parametrize("tree", [
    mixed_tree(), {"params": {}, "l": []}, (), None, [torch.ones(1)], (torch.ones(1), None),
    {"10": torch.ones(1), "2": [(), (torch.ones(1), torch.ones(1))]},
], ids=["mixed", "empty_containers", "empty_tuple", "none", "list", "tuple_none",
        "key_order"])
def test_treedef_string_is_jax_notation(tree):
    assert treedef_str(tree) == str(jax.tree.structure(as_jax(tree)))


def test_reference_file_loads_in_the_port_and_back(tmp_path):
    tree = mixed_tree()
    jtree = jax.tree.map(jnp.asarray, as_jax(tree))
    jtree["opt"]["2"] = [jnp.asarray(tree["opt"]["2"][0].float().numpy(), jnp.bfloat16),
                         jnp.asarray(tree["opt"]["2"][1].float().numpy(), jnp.float16)]
    jtree["count"] = jnp.asarray(3, jnp.int32)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jio.save_pytree(ref_path, jtree)
    assert_trees_equal(tree, load_pytree(ref_path, tree))
    save_pytree(port_path, tree)
    back = jio.load_pytree(port_path, jtree)
    for x, y in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float64), np.asarray(y, np.float64))


def test_fl_state_round_trip(tmp_path):
    params = {"w": torch.randn(3, 2)}
    path = str(tmp_path / "fl")
    save_fl_state(path, params, round_idx=5, visit_counts=np.asarray([1, 2, 0]), current=1)
    back, r, counts, cur = load_fl_state(path, params)
    assert torch.equal(back["w"], params["w"]) and (r, cur) == (5, 1)
    np.testing.assert_array_equal(counts, [1, 2, 0])
    jback = jio.load_fl_state(path, {"w": jnp.zeros((3, 2))})
    np.testing.assert_array_equal(np.asarray(jback[0]["w"]), params["w"].numpy())


# --------------------------------------------------------------------------
# whole runs: kill and resume
# --------------------------------------------------------------------------


def assert_same_run(a, b, same_losses=True):
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params)):
        assert torch.equal(x, y)
    assert a.test_acc == b.test_acc and a.rounds == b.rounds
    if same_losses:
        assert a.train_loss == b.train_loss
    assert a.ledger.bits == b.ledger.bits and a.ledger.events == b.ledger.events
    assert a.ledger.history == b.ledger.history


RESUME = [
    ("f32_qsgd", dict(rounds=6, local_steps=4, local_epochs=2, eval_every=2,
                      initial_cluster=0, qsgd_levels=8), 3),
    ("bf16_momentum_microbatch", dict(rounds=6, local_steps=4, local_epochs=2, eval_every=2,
                                      initial_cluster=0, precision=Precision(),
                                      client_microbatch=2, local_opt=MomentumSGD()), 3),
]


@pytest.mark.parametrize("kw,cut", [c[1:] for c in RESUME], ids=[c[0] for c in RESUME])
def test_looped_resume_equals_uninterrupted_scanned_run(pair, tmp_path, kw, cut):
    """Checkpointing takes the looped driver; a run killed after round `cut`
    (its shortened leg ends on the eval cadence) and resumed equals the
    uninterrupted scanned run."""
    task = pair[1]
    base = run_fed_chs(task, FedCHSConfig(**kw))  # scanned, the default
    looped = run_fed_chs(task, FedCHSConfig(**kw, scan_rounds=False))
    ck = str(tmp_path / "sync")
    run_fed_chs(task, FedCHSConfig(**{**kw, "rounds": cut}, checkpoint=ck))
    resumed = run_fed_chs(task, FedCHSConfig(**kw, checkpoint=ck, resume=True))
    # the scanned run's bf16 losses round once more than the looped run's
    # (tests/test_torch_scan.py): the losses are held to the looped run's
    assert_same_run(base, resumed, same_losses="precision" not in kw)
    assert_same_run(looped, resumed)
    if "precision" in kw:  # bf16 momentum leaves beside f32 params on disk
        with np.load(ck + ".arrays.npz") as data:
            assert data["opt/0/fc1/w"].dtype == np.uint16
            assert data["params/fc1/w"].dtype == np.float32


def test_resume_without_a_checkpoint_runs_from_scratch(pair, tmp_path):
    task = pair[1]
    kw = dict(rounds=2, local_steps=2, local_epochs=2, eval_every=1, qsgd_levels=8)
    a = run_fed_chs(task, FedCHSConfig(**kw, scan_rounds=False))
    b = run_fed_chs(task, FedCHSConfig(**kw, checkpoint=str(tmp_path / "none"), resume=True))
    assert_same_run(a, b)
    assert run_state_exists(str(tmp_path / "none"))


KW = dict(rounds=6, local_steps=4, local_epochs=2, eval_every=2, initial_cluster=0,
          qsgd_levels=8)


def flat_params(res):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree.leaves(jax.tree.map(np.asarray, res.final_params))]
                          if not isinstance(tree_leaves(res.final_params)[0], torch.Tensor)
                          else [t.double().numpy().ravel() for t in tree_leaves(res.final_params)])


def assert_close_run(res, jres):
    """Ledger exact; params and accuracy at the run-parity tolerance."""
    assert res.ledger.events == jres.ledger.events
    assert res.ledger.history == jres.ledger.history and res.rounds == jres.rounds
    got, want = flat_params(res), flat_params(jres)
    assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=0.02)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_run_state_resumes_across_packages(pair, tmp_path, writer):
    """A run state one package's looped Fed-CHS saved at round 3 resumes in
    the other package to round 6, within the run-parity tolerance of the
    reference's own uninterrupted run."""
    jtask, task = pair
    ck = str(tmp_path / "x")
    full = jax_run_fed_chs(jtask, JaxFedCHSConfig(**KW, scan_rounds=False))
    if writer == "reference":
        jax_run_fed_chs(jtask, JaxFedCHSConfig(**{**KW, "rounds": 3}, checkpoint=ck))
        resumed = run_fed_chs(task, FedCHSConfig(**KW, checkpoint=ck, resume=True))
    else:
        run_fed_chs(task, FedCHSConfig(**{**KW, "rounds": 3}, checkpoint=ck))
        resumed = jax_run_fed_chs(jtask, JaxFedCHSConfig(**KW, checkpoint=ck, resume=True))
    assert_close_run(resumed, full)
