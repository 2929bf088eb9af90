"""The port's package namespaces carry the reference's public names.

* Every name in the `__all__` of `repro.core`, `repro.models`,
  `repro.optim`, `repro.comm` and `repro.data` imports from the port's
  package of the same name (none of those lists holds a mesh-only name, and
  jax's own `cached_jit` is in none of them).
* `import repro_torch.comm`, `import repro_torch.kernels.ops` and the
  reference quickstart's `from ...core import FedCHSConfig, FLTask,
  run_fed_chs` each work first, in a fresh interpreter, in either order
  (the lazy exports of `repro_torch.core` break the import cycle
  kernels.ops -> core.prng -> core -> engine -> comm.channels).
* The ported helpers against the reference, on the MLP with the
  reference's weights carried over: `local_sgd`, `multi_client_local_sgd`,
  `cluster_sgd` at the f32 tolerance of `tests/test_torch_classifier.py`
  (rtol 1e-5, atol 2e-5), `evaluate` exactly (an accuracy over 200
  images), `Classifier.accuracy` and `loss_and_grad`,
  `cross_entropy_loss(z_loss=)` at rtol 1e-6, and the tree helpers of
  `repro/utils.py` (`split_like` word for word).
* `examples/torch_quickstart.py` runs on the CPU.
"""
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as jutils
from repro.core import cluster_sgd as jax_cluster_sgd
from repro.core import evaluate as jax_evaluate
from repro.core import local_sgd as jax_local_sgd
from repro.core import multi_client_local_sgd as jax_multi_client_local_sgd
from repro.data import make_dataset as jax_make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro.models.common import cross_entropy_loss as jax_cross_entropy_loss
from repro_torch import utils
from repro_torch.core import cluster_sgd, evaluate, local_sgd, multi_client_local_sgd
from repro_torch.data import make_dataset
from repro_torch.models import FedModel, LMFedModel
from repro_torch.models.classifier import make_classifier
from repro_torch.models.common import cross_entropy_loss
from repro_torch.optim import AdamWOpt, LocalOpt, MomentumSGD, PlainSGD
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ["core", "models", "optim", "comm", "data"]
RTOL, ATOL = 1e-5, 2e-5


@pytest.mark.parametrize("package", PACKAGES)
def test_every_reference_name_imports_from_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = [name for name in ref.__all__ if not hasattr(port, name)]
    assert not missing, f"repro_torch.{package} lacks {missing}"
    assert set(ref.__all__) <= set(port.__all__)
    assert set(ref.__all__) <= set(dir(port))
    with pytest.raises(AttributeError):
        port.no_such_name  # noqa: B018


FIRST_IMPORTS = {
    "comm_then_core": ["import repro_torch.comm",
                       "from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs"],
    "ops_then_core": ["import repro_torch.kernels.ops",
                      "from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs"],
    "core_then_comm": ["from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs",
                       "import repro_torch.comm", "import repro_torch.kernels.ops"],
    "models_then_core": ["from repro_torch.models import LMFedModel, FedModel",
                         "from repro_torch.optim import AdamWOpt, LocalOpt",
                         "from repro_torch.core import RoundEngine, evaluate, local_sgd"],
}


@pytest.mark.parametrize("order", list(FIRST_IMPORTS))
def test_imports_work_first_in_a_fresh_interpreter(order):
    code = "\n".join(FIRST_IMPORTS[order] + ["import sys",
                                             "assert 'jax' not in sys.modules",
                                             "print('ok')"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_protocols_accept_the_port_s_implementations():
    from repro_torch.configs.registry import smoke_config

    assert isinstance(LMFedModel(smoke_config("qwen3-0.6b")), FedModel)
    for opt in (PlainSGD(), MomentumSGD(), AdamWOpt()):
        assert isinstance(opt, LocalOpt)


# ---------------------------------------------------------------------------
# the classifier-signature oracles and evaluate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mlp():
    jclf = jax_make_classifier("mlp", "mnist", (28, 28, 1), 10)
    clf = make_classifier("mlp", "mnist", (28, 28, 1), 10)
    jparams = jclf.init(jax.random.PRNGKey(0))
    return jclf, clf, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def images(rng, *lead):
    x = rng.uniform(size=(*lead, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=lead).astype(np.int32)
    return x, y


def assert_trees_close(tree, jtree):
    leaves, jleaves = utils.tree_leaves(tree), jax.tree.leaves(jtree)
    assert len(leaves) == len(jleaves)
    for t, a in zip(leaves, jleaves):
        assert tuple(t.shape) == a.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_local_sgd_matches_reference(mlp):
    jclf, clf, jparams, params = mlp
    x, y = images(np.random.default_rng(0), 3, 16)
    lrs = np.array([0.1, 0.05, 0.02], np.float32)
    jp, jloss = jax_local_sgd(jclf)(jparams, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lrs))
    p, loss = local_sgd(clf)(params, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(lrs))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert_trees_close(p, jp)
    assert local_sgd(clf) is local_sgd(clf)  # cached per model, as the reference's


def test_multi_client_local_sgd_matches_reference(mlp):
    jclf, clf, jparams, params = mlp
    x, y = images(np.random.default_rng(1), 4, 2, 8)
    lrs = np.array([0.1, 0.1], np.float32)
    jp, jloss = jax_multi_client_local_sgd(jclf)(jparams, jnp.asarray(x), jnp.asarray(y),
                                                 jnp.asarray(lrs))
    p, loss = multi_client_local_sgd(clf)(params, torch.from_numpy(x), torch.from_numpy(y),
                                          [0.1, 0.1])
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=RTOL)
    assert_trees_close(p, jp)


def test_cluster_sgd_matches_reference(mlp):
    jclf, clf, jparams, params = mlp
    x, y = images(np.random.default_rng(2), 3, 4, 8)
    gammas = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    lrs = np.array([0.1, 0.05, 0.05], np.float32)
    jp, jloss = jax_cluster_sgd(jclf)(jparams, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(gammas), jnp.asarray(lrs))
    p, loss = cluster_sgd(clf)(params, torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(gammas), torch.from_numpy(lrs))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert_trees_close(p, jp)


def test_evaluate_and_classifier_helpers_match_reference(mlp):
    jclf, clf, jparams, params = mlp
    jds = jax_make_dataset("mnist", train_size=200, test_size=200, seed=0)
    ds = make_dataset("mnist", train_size=200, test_size=200, seed=0)
    np.testing.assert_array_equal(ds.test_x, np.asarray(jds.test_x))
    assert evaluate(clf, params, ds) == jax_evaluate(jclf, jparams, jds)
    x, y = ds.test_x[:64], ds.test_y[:64]
    jacc = float(jclf.accuracy(jparams, jnp.asarray(x), jnp.asarray(y)))
    assert float(clf.accuracy(params, torch.from_numpy(x), torch.from_numpy(y))) == jacc
    jloss, jgrads = jclf.loss_and_grad(jparams, jnp.asarray(x), jnp.asarray(y))
    loss, grads = clf.loss_and_grad(params, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert_trees_close(grads, jgrads)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
def test_cross_entropy_z_loss_matches_reference(z_loss):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want = float(jax_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss))
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   z_loss=z_loss))
    assert got == pytest.approx(want, rel=1e-6)


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": [(5,), (2, 2, 2)]}
    make = lambda: {"a": rng.standard_normal(shapes["a"]).astype(np.float32),  # noqa: E731
                    "b": [rng.standard_normal(s).astype(np.float32) for s in shapes["b"]]}
    xs = [make() for _ in range(3)]
    jx = [jax.tree.map(jnp.asarray, x) for x in xs]
    tx = [params_from_jax(x, "cpu") for x in xs]
    w = [0.5, -1.25, 2.0]
    pairs = [
        (utils.tree_sub(tx[0], tx[1]), jutils.tree_sub(jx[0], jx[1])),
        (utils.tree_scale(tx[0], 0.3), jutils.tree_scale(jx[0], 0.3)),
        (utils.tree_axpy(0.7, tx[0], tx[1]), jutils.tree_axpy(0.7, jx[0], jx[1])),
        (utils.tree_weighted_sum(tx, w), jutils.tree_weighted_sum(jx, w)),
        (utils.tree_zeros_like(tx[2]), jutils.tree_zeros_like(jx[2])),
    ]
    for got, want in pairs:
        assert_trees_close(got, want)
    assert float(utils.tree_dot(tx[0], tx[1])) == pytest.approx(
        float(jutils.tree_dot(jx[0], jx[1])), rel=1e-6)
    assert float(utils.tree_sq_norm(tx[2])) == pytest.approx(
        float(jutils.tree_sq_norm(jx[2])), rel=1e-6)
    assert utils.tree_num_bytes(tx[0]) == jutils.tree_num_bytes(jx[0]) == 4 * (12 + 5 + 8)
    assert not utils.tree_any_nan(tx[0]) and not jutils.tree_any_nan(jx[0])
    nan = dict(tx[0], a=torch.full((3, 4), float("nan")))
    assert utils.tree_any_nan(nan) and jutils.tree_any_nan(jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), nan))
    with pytest.raises(ValueError):
        utils.tree_weighted_sum([], [])
    key = jax.random.PRNGKey(7)
    jkeys = jutils.split_like(key, jx[0])
    keys = utils.split_like(np.asarray(key, np.uint32), tx[0])
    for k, jk in zip(utils.tree_leaves(keys), jax.tree.leaves(jkeys)):
        np.testing.assert_array_equal(k, np.asarray(jk, np.uint32))


def test_torch_quickstart_runs_on_the_cpu():
    """`examples/torch_quickstart.py`, the twin of the reference's quickstart
    with the same `repro_torch.core` import, 5 rounds: it trains (accuracy
    above chance) and prints zero parameter-server traffic."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
                          "--device", "cpu", "--rounds", "5"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    final = [line for line in out.stdout.splitlines() if line.startswith("final accuracy")]
    assert len(final) == 1 and float(final[0].split(":")[1]) > 0.5
    hops = [line for line in out.stdout.splitlines() if line.startswith("per-hop bits")]
    assert len(hops) == 1 and "_ps" not in hops[0] and "ps_" not in hops[0]
