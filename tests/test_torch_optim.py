"""The port's client-held optimizers against the reference package.

Each case feeds the same seeded params, gradients and step sizes to the
reference's `LocalOpt` and to the port's, for 3 steps, on one client and on
a stack of clients (the engine steps all clients of a round at once; the
reference vmaps one client's step).  Held at rtol 1e-6: torch and XLA round
the same f32 expressions alike except the square root, which CPU torch does
not round correctly.  AdamW's bias corrections 1 - b ** count match the
reference bit for bit (`test_adamw_bias_correction_is_bit_equal`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import local as jlocal
from repro_torch.core.engine import RoundEngine
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import local as tlocal
from repro_torch.utils import tree_leaves

torch.set_num_threads(1)

SHAPES = {"w": (7, 5), "b": (5,), "deep": {"k": (3, 2, 4)}}
LRS = (0.1, 0.05, 0.02)

OPTS = [
    ("plain", {}, "PlainSGD"),
    ("momentum", {"momentum": 0.9}, "MomentumSGD"),
    ("nesterov", {"momentum": 0.8, "nesterov": True}, "MomentumSGD"),
    ("momentum_wd", {"momentum": 0.9, "weight_decay": 0.01}, "MomentumSGD"),
    ("nesterov_wd", {"momentum": 0.5, "weight_decay": 0.1, "nesterov": True}, "MomentumSGD"),
    ("adamw", {}, "AdamWOpt"),
    ("adamw_custom", {"b1": 0.8, "b2": 0.999, "eps": 1e-6, "weight_decay": 0.0}, "AdamWOpt"),
]


def draw(rng, shapes, lead=()):
    if isinstance(shapes, dict):
        return {k: draw(rng, v, lead) for k, v in shapes.items()}
    return rng.standard_normal(lead + shapes).astype(np.float32)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def flat(leaves):
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


def run(opt, params, grads, step):
    state = opt.init(params)
    for lr, g in zip(LRS, grads):
        params, state = step(opt, params, state, g, lr)
    return params, state


@pytest.mark.parametrize("name,kw,cls", OPTS, ids=[o[0] for o in OPTS])
@pytest.mark.parametrize("clients", [0, 4])
def test_optimizer_steps_match_reference(name, kw, cls, clients):
    """3 steps on one client (clients=0), or on a stack of 4 clients, whose
    state the port stacks as `RoundEngine.init_opt_state` does."""
    rng = np.random.default_rng(clients)
    lead = (clients,) if clients else ()
    p0 = draw(rng, SHAPES, lead)
    grads = [draw(rng, SHAPES, lead) for _ in LRS]
    jopt, topt = getattr(jlocal, cls)(**kw), getattr(tlocal, cls)(**kw)

    def jstep(opt, p, s, g, lr):
        step = lambda p, s, g: opt.step(p, s, g, jnp.float32(lr))
        return (jax.vmap(step) if clients else step)(p, s, g)

    if clients:
        one = jax.tree.map(lambda a: jnp.asarray(a[0]), p0)
        jstate = jax.tree.map(lambda a: jnp.broadcast_to(a, (clients,) + a.shape),
                              jopt.init(one))
        jp = jax.tree.map(jnp.asarray, p0)
        for lr, g in zip(LRS, grads):
            jp, jstate = jstep(jopt, jp, jstate, jax.tree.map(jnp.asarray, g), lr)
        tp = to_torch(p0)
        tstate = RoundEngine(lambda: None, local_opt=topt).init_opt_state(
            to_torch(jax.tree.map(lambda a: a[0], p0)), clients)
        for lr, g in zip(LRS, grads):
            tp, tstate = topt.step(tp, tstate, to_torch(g), lr)
    else:
        jp, jstate = run(jopt, jax.tree.map(jnp.asarray, p0),
                         [jax.tree.map(jnp.asarray, g) for g in grads], jstep)
        tp, tstate = run(topt, to_torch(p0), [to_torch(g) for g in grads],
                         lambda opt, p, s, g, lr: opt.step(p, s, g, lr))
    np.testing.assert_allclose(flat(tree_leaves(tp)), flat(jax.tree.leaves(jp)),
                               rtol=1e-6, atol=1e-7)
    jleaves, tleaves = jax.tree.leaves(jstate), tree_leaves(tstate)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_adamw_count_is_per_client():
    """The step count rides the stacked client axis, as under the
    reference's client vmap."""
    params = to_torch(draw(np.random.default_rng(0), SHAPES))
    state = RoundEngine(lambda: None, local_opt=tlocal.AdamWOpt()).init_opt_state(params, 2, 3)
    assert tuple(state["count"].shape) == (2, 3) and state["count"].dtype == torch.int32
    assert tuple(state["mu"]["w"].shape) == (2, 3, 7, 5)


def test_adamw_bias_correction_is_bit_equal():
    counts = np.arange(1, 300, dtype=np.int32)
    for b in (0.9, 0.95, 0.999):
        want = jax.jit(lambda c: 1 - b ** c.astype(jnp.float32))(jnp.asarray(counts))
        got = tadamw._correction(b, torch.from_numpy(counts))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_sgd_is_stateless():
    params = to_torch(draw(np.random.default_rng(1), SHAPES))
    assert tlocal.PlainSGD().init(params) == ()
    assert tlocal.MomentumSGD(momentum=0.0).init(params) == ()
