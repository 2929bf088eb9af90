"""The port's Appendix-A classifiers against the reference's, weights carried
across with `params_from_jax`.

Forward, loss and gradients are f32 on both sides but reduce in other
orders (XLA's dot and convolution against torch's), so they agree to about
1e-6 relative; atol 2e-5 on logits and gradients leaves room for the
few-hundred-term sums of LeNet's convolutions and fc1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.core.simulation import FLTask as JaxFLTask
from repro.data import assign_clusters, dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro_torch.core.simulation import FLTask
from repro_torch.models.classifier import make_classifier
from repro_torch.utils import resolve_device, tree_flatten, tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

MODELS = [("mlp", 1.0), ("lenet", 0.125)]


def both(model, width):
    jclf = jax_make_classifier(model, "mnist", (28, 28, 1), 10, width_scale=width)
    tclf = make_classifier(model, "mnist", (28, 28, 1), 10, width_scale=width)
    return jclf, tclf


@pytest.mark.parametrize("model,width", MODELS)
def test_forward_loss_grads_match_reference(model, width):
    jclf, tclf = both(model, width)
    jparams = jclf.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(16, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=16).astype(np.int32)

    want_logits = np.asarray(jclf.apply(jparams, jnp.asarray(x)))
    got_logits = tclf.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-5, atol=2e-5)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jclf.loss))(jparams, jnp.asarray(x),
                                                                   jnp.asarray(y))
    grads, loss = grad_and_value(tclf.loss)(params, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("model,width", MODELS)
def test_layout_and_leaf_order_match_reference(model, width):
    """Dense (in, out), conv HWIO, leaves in jax.tree.flatten order: the QSGD
    blocks and per-leaf keys depend on all three."""
    jclf, tclf = both(model, width)
    jparams = jclf.init(jax.random.PRNGKey(0))
    params = tclf.init(0, device="cpu")
    jleaves, jdef = jax.tree.flatten(jparams)
    leaves, _ = tree_flatten(params)
    paths = ["/".join(str(k.key) for k in p) for p, _ in jax.tree.flatten_with_path(jparams)[0]]
    assert paths == [f"{k}/{n}" for k in sorted(params) for n in sorted(params[k])]
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape) for a in jleaves]
    # He-normal scales sqrt(2 / fan_in): the port's own init draws from a
    # torch.Generator; a sample std of n draws is within 4 / sqrt(2n)
    for t, a in zip(leaves, jleaves):
        if t.ndim > 1:
            scale = np.sqrt(2.0 / np.prod(t.shape[:-1]))
            assert abs(float(t.std()) / scale - 1) < 4 / np.sqrt(2 * t.numel())
        else:
            assert not t.any()


def test_lenet_flattens_in_nhwc_order():
    """A weight on fc1 row r must see feature (h, w, c) at r = (h*W + w)*C + c."""
    _, tclf = both("lenet", 0.125)
    params = tclf.init(0, device="cpu")
    params = {k: {n: torch.zeros_like(t) for n, t in v.items()} for k, v in params.items()}
    c2 = params["conv2"]["b"].shape[0]
    params["conv2"]["b"][3] = 1.0  # channel 3 is 1 everywhere after relu+pool
    params["fc1"]["w"][(2 * 7 + 5) * c2 + 3, 0] = 1.0  # feature (h=2, w=5, c=3)
    params["fc2"]["w"][0, 0] = 1.0
    params["out"]["w"][0, 0] = 1.0
    logits = tclf.apply(params, torch.zeros(1, 28, 28, 1))
    assert float(logits[0, 0]) == 1.0


def test_task_staging_and_leaf_sizes_match_reference():
    ds = make_dataset("mnist", train_size=600, test_size=100, seed=0)
    clients = dirichlet_partition(ds.train_y, 8, 0.6, seed=0)
    clusters = assign_clusters(8, 2, seed=0)
    jclf, tclf = both("lenet", 0.125)
    jt = JaxFLTask(jclf, ds, clients, clusters, batch_size=8, seed=0)
    tt = FLTask(tclf, ds, clients, clusters, batch_size=8, seed=0, device="cpu")
    assert tt.param_leaf_sizes() == jt.param_leaf_sizes()
    assert tt.num_params() == jt.num_params()
    np.testing.assert_array_equal(tt.cluster_weights(1), jt.cluster_weights(1))
    want = jt.sample_round_batches(1, 6, 3)
    got = tt.sample_round_batches(1, 6, 3)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    want = jt.sample_cluster_batches(0, 2)
    got = tt.sample_cluster_batches(0, 2)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jparams = jclf.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert tt.evaluate(params) == jt.evaluate(jparams)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No card and no explicit device: raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tclf = both("mlp", 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        tclf.init(0)
    with pytest.raises(RuntimeError):
        params_from_jax({"w": np.zeros(3, np.float32)})
    ds = make_dataset("mnist", train_size=100, test_size=10, seed=0)
    with pytest.raises(RuntimeError):
        FLTask(tclf, ds, dirichlet_partition(ds.train_y, 2, 0.6, seed=0), [[0, 1]], 4)
