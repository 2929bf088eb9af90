"""The classifiers' initial weights from a seed, against the reference's
(`repro_torch.models.classifier`, `repro_torch.core.prng.normal`).

* `prng.normal(key, shape)` is `jax.random.normal(key, shape, float32)` bit
  for bit: the port's threefry words (partitionable layout), the uniform
  from their top 23 bits, XLA's f32 `erf_inv` with its fused multiply-adds;
  the words JAX draws here are the expected ones.
* `FLTask(...).init_params()` of the MLP and LeNet (width 1.0 and 1/8) at
  seeds 0 and 1 equals the reference's `init_params()`, every leaf, bit for
  bit.
* The quickstart's Fed-CHS run from the port's own init (nothing carried
  across from the reference) has the reference's ledger, and its
  accuracies stay within the port's 1-ulp control (the largest gap
  between two of its runs from the seed's weights and from weights 1 ulp
  above and 1 ulp below them).
* At Appendix-A scale (LeNet-MNIST, 100 clients), a FedAvg client's first
  local run of K = 20 plain SGD steps from the seed-0 init goes non-finite
  at the drivers' default step 1/(K sqrt(k+1)) and stays finite at the
  paper's 1/(2K sqrt(k+1)), in the reference as in the port: client 42
  (of 100, the one the reference's run loses there).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import prng

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,shape", [(0, (784, 200)), (1, (5, 5, 1, 64)), (7, (3, 1000)),
                                        (2 ** 31 - 1, (4097,))])
def test_normal_matches_jax_bit_for_bit(seed, shape):
    import jax
    import jax.numpy as jnp

    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng.normal(np.asarray(jax.random.key_data(key), np.uint32), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _tasks(model, width):
    from repro.core import FLTask as JTask
    from repro.data import assign_clusters as j_assign
    from repro.data import dirichlet_partition as j_part
    from repro.data import make_dataset as j_data
    from repro.models.classifier import make_classifier as j_clf
    from repro_torch.core import FLTask
    from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
    from repro_torch.models.classifier import make_classifier

    def build(data, part, assign, clf, task, **kw):
        ds = data("mnist", train_size=400, test_size=100, seed=0)
        return lambda seed: task(
            clf(model, "mnist", ds.spec.image_shape, 10, width_scale=width), ds,
            part(ds.train_y, 4, 0.6, seed=0), assign(4, 2, seed=0), batch_size=8, seed=seed, **kw)

    return (build(make_dataset, dirichlet_partition, assign_clusters, make_classifier, FLTask,
                  device="cpu"),
            build(j_data, j_part, j_assign, j_clf, JTask))


@pytest.mark.parametrize("model,width", [("mlp", 1.0), ("lenet", 1.0), ("lenet", 0.125)])
@pytest.mark.parametrize("seed", [0, 1])
def test_init_params_equal_the_reference(model, width, seed):
    import jax

    port, ref = _tasks(model, width)
    got, want = port(seed).init_params(), ref(seed).init_params()
    for layer, leaves in want.items():
        for name, leaf in leaves.items():
            w = np.asarray(leaf)
            g = got[layer][name].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, (layer, name)
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    assert len(jax.tree.leaves(want)) == sum(len(v) for v in got.values())


def _quickstart(api, task, rounds=6):
    return api.run_fed_chs(task, api.FedCHSConfig(rounds=rounds, local_steps=10,
                                                  topology="random_sparse", eval_every=2))


def test_quickstart_run_from_the_ports_own_init_holds_the_reference():
    import repro.core as J

    import repro_torch.core as T
    from repro.data import assign_clusters as j_assign
    from repro.data import dirichlet_partition as j_part
    from repro.data import make_dataset as j_data
    from repro.models.classifier import make_classifier as j_clf
    from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
    from repro_torch.models.classifier import make_classifier

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    args = (ds, dirichlet_partition(ds.train_y, 20, 0.6, seed=0), assign_clusters(20, 4, seed=0))
    port = _quickstart(T, T.FLTask(clf, *args, batch_size=32, seed=0, device="cpu"))

    def ulp_init(toward):
        return lambda seed=0, device=None: {
            k: {n: torch.nextafter(t, torch.full_like(t, toward)) for n, t in v.items()}
            for k, v in clf.init(seed, device).items()}

    ctrls = [_quickstart(T, T.FLTask(dataclasses.replace(clf, init=ulp_init(toward)), *args,
                                     batch_size=32, seed=0, device="cpu"))
             for toward in (np.inf, -np.inf)]
    jds = j_data("mnist", train_size=4000, test_size=1000, seed=0)
    ref = _quickstart(J, J.FLTask(j_clf("mlp", "mnist", jds.spec.image_shape, 10), jds,
                                  j_part(jds.train_y, 20, 0.6, seed=0), j_assign(20, 4, seed=0),
                                  batch_size=32, seed=0))
    assert {k: int(v) for k, v in port.ledger.bits.items() if v} == \
        {k: int(v) for k, v in ref.ledger.bits.items() if v}
    gap = max(abs(a - b) for a, b in zip(port.test_acc, ref.test_acc))
    control = max(abs(a - b) for r, q in itertools.combinations([port, *ctrls], 2)
                  for a, b in zip(r.test_acc, q.test_acc))
    print(f"quickstart accuracies: gap to the reference {gap:.4g}, 1-ulp control {control:.4g}")
    assert len(port.test_acc) == len(ref.test_acc) >= 3
    assert gap <= control


DIVERGING_CLIENT, LOCAL_STEPS = 42, 20


def _appendix_a_client(api, data, part, assign, clf, **kw):
    """The seed-0 init and client 42's first K batches of the Appendix-A
    task (100 clients, Dirichlet(0.6), batch 32)."""
    ds = data("mnist", seed=0)
    model = clf("lenet", "mnist", ds.spec.image_shape, 10)
    task = api.FLTask(model, ds, part(ds.train_y, 100, 0.6, seed=0), assign(100, 10, seed=0),
                      batch_size=32, seed=0, **kw)
    task.reset_loaders(0)  # each client's loader is its own: the draws of the others do not matter
    return model, task.init_params(), task.sample_client_batches(DIVERGING_CLIENT, LOCAL_STEPS)


def _lr(k: int, half: bool) -> float:
    return 1.0 / ((2 if half else 1) * LOCAL_STEPS * np.sqrt(k + 1))


def _reference_local_run(half: bool) -> bool:
    import jax

    import repro.core as J
    from repro.data import assign_clusters, dirichlet_partition, make_dataset
    from repro.models.classifier import make_classifier

    model, params, b = _appendix_a_client(J, make_dataset, dirichlet_partition, assign_clusters,
                                          make_classifier)
    step = jax.jit(lambda p, x, y, lr: jax.tree.map(
        lambda a, g: a - lr * g, p, jax.grad(model.loss)(p, x, y)))
    for k in range(LOCAL_STEPS):
        params = step(params, b["x"][k], b["y"][k], _lr(k, half))
    return all(bool(np.isfinite(np.asarray(leaf)).all()) for leaf in jax.tree.leaves(params))


def _port_local_run(half: bool) -> bool:
    import repro_torch.core as T
    from repro_torch.data import assign_clusters, dirichlet_partition, make_dataset
    from repro_torch.models.classifier import make_classifier

    model, params, b = _appendix_a_client(T, make_dataset, dirichlet_partition, assign_clusters,
                                          make_classifier, device="cpu")
    for k in range(LOCAL_STEPS):
        leaves = [t.requires_grad_() for v in params.values() for t in v.values()]
        grads = iter(torch.autograd.grad(model.loss(params, b["x"][k], b["y"][k]), leaves))
        params = {name: {n: (t - _lr(k, half) * next(grads)).detach() for n, t in v.items()}
                  for name, v in params.items()}
    return all(bool(torch.isfinite(t).all()) for v in params.values() for t in v.values())


@pytest.mark.parametrize("package", ["reference", "port"])
def test_appendix_a_fedavg_client_diverges_only_at_the_default_step(package):
    run = _reference_local_run if package == "reference" else _port_local_run
    assert not run(half=False)
    assert run(half=True)
