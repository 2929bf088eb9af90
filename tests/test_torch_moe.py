"""The port's Mixture-of-Experts block against the reference, on the CPU.

At dbrx-132b's smoke config (d_model 256, 4 experts, top-2, f32) with the
reference's params carried over (`params_from_jax`):

* `init_moe`'s leaves, shapes and dtypes equal the reference's (the router
  f32 inside a bf16 tree), shared experts included;
* `moe_forward`, both methods, against the reference's: global routing
  (G = 1) and group-limited routing (G = B), capacity factors 1.0 and
  1.25, shared experts (`num_shared_experts=1`): y and the aux loss at the
  f32 tolerance of `tests/test_torch_lm.py` (rtol 1e-4, atol 1e-5; the
  observed gap is about 1e-6);
* ties go to the lower index, as `jax.lax.top_k`: duplicated token rows
  (expert choice) and duplicated router columns (token choice) pick what
  the reference picks;
* the zero-input fixed point, and group-limited routing equal to global
  routing applied per group, as `tests/test_property_moe.py` pins them for
  the reference;
* `loss_fn` (cross entropy + aux) and its grads at the whole smoke model,
  flash on and off, remat on and off, under the engine's vmap over two
  clients: the loss at 1e-5 relative and every grad leaf within 1e-4 in
  relative L2, the rules of `tests/test_torch_lm.py`;
* `launch.steps.make_train_round` (the Fed-CHS chain pass and the HFL
  chain mean, C = 3 and 2, and the C = 1 shortcut) against the reference's, two
  rounds: params and loss at rtol 1e-4 / atol 1e-5;
* whole Fed-CHS runs of `LMFedModel(smoke dbrx)`: a 2-round QSGD(16) run
  and a grad-mode run, ledgers and visit order exact, the QSGD run's update
  within 3% and the grad-mode params within 3e-5 of the reference's (the
  lossy and f32 bounds of `tests/test_torch_lm.py`);
* the remat MoE LM under FedAvg, WRWGD, Hier-Local-QSGD and Fed-CHS with
  `Precision()` and client_microbatch 1: scanned runs bit-equal to looped
  runs, ledgers equal to the reference's;
* `params_from_jax` carries a bf16 MoE tree (the f32 router kept) and a
  cache tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.comm.channels import DenseChannel as JaxDenseChannel
from repro.comm.channels import QSGDChannel as JaxQSGDChannel
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import FedCHSConfig as JaxConfig
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core.baselines import FedAvgConfig as JaxFedAvgConfig
from repro.core.baselines import HierLocalQSGDConfig as JaxHierConfig
from repro.core.baselines import WRWGDConfig as JaxWRWGDConfig
from repro.core.baselines import run_fedavg as jax_run_fedavg
from repro.core.baselines import run_hier_local_qsgd as jax_run_hier
from repro.core.baselines import run_wrwgd as jax_run_wrwgd
from repro.core.precision import Precision as JaxPrecision
from repro.core.simulation import FLTask as JaxFLTask
from repro.data.sources import TokenSource as JaxTokenSource
from repro.launch import steps as launch_steps
from repro.models import ffn as jffn
from repro.models import transformer as jtf
from repro.models.fed import LMFedModel as JaxLMFedModel
from repro_torch.comm.channels import DenseChannel, QSGDChannel
from repro_torch.configs.registry import smoke_config
from repro_torch.core.baselines import (
    FedAvgConfig,
    HierLocalQSGDConfig,
    WRWGDConfig,
    run_fedavg,
    run_hier_local_qsgd,
    run_wrwgd,
)
from repro_torch.core import prng
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.precision import Precision
from repro_torch.core.simulation import FLTask
from repro_torch.data.sources import TokenSource
from repro_torch.launch.steps import make_train_round
from repro_torch.models import ffn
from repro_torch.models import transformer as tf
from repro_torch.models.fed import LMFedModel
from repro_torch.utils import tree_flatten, tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ARCH = "dbrx-132b"
RTOL, ATOL = 1e-4, 1e-5


def carried(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


@pytest.fixture(scope="module")
def moe():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jp = jffn.init_moe(jcfg, jax.random.PRNGKey(0), jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, carried(jp), x


def both(jcfg, cfg, jp, p, x, **kw):
    jy, jaux = jffn.moe_forward(jcfg, jp, jnp.asarray(x), **kw)
    y, aux = ffn.moe_forward(cfg, p, torch.from_numpy(x), **kw)
    return (np.asarray(jy), float(jaux)), (y.numpy(), float(aux))


@pytest.mark.parametrize("shared", [0, 1])
def test_init_moe_leaves_match_reference(shared):
    jcfg, cfg = (dataclasses.replace(c, num_shared_experts=shared)
                 for c in (jax_smoke_config(ARCH), smoke_config(ARCH)))
    jp = jffn.init_moe(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    p = ffn.init_moe(cfg, prng.PRNGKey(0), torch.bfloat16, "cpu")
    jleaves = jax.tree.leaves(jp)
    leaves, _ = tree_flatten(p)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves] == \
        [(a.shape, str(a.dtype)) for a in jleaves]
    assert p["router"].dtype == torch.float32 and p["w_out"].dtype == torch.bfloat16
    assert ("shared" in p) == bool(shared)
    # the stacked layout of init_params: a leading layer axis on every leaf
    stacked = tf.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 0, "cpu")
    ffn_leaves = tree_leaves(stacked["super"][0]["ffn"])
    assert [tuple(t.shape) for t in ffn_leaves] == [(cfg.num_layers, *a.shape)
                                                    for a in jleaves]
    # the reference's draws, bit for bit (the router in f32, the experts
    # at scales computed in f32)
    for a, t in zip(jleaves, leaves):
        a = np.asarray(a)
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(got, a.view(got.dtype))


@pytest.mark.parametrize("method", ["dense_topk", "expert_choice"])
@pytest.mark.parametrize("groups", [1, 2], ids=["G1", "GB"])
@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_moe_forward_matches_reference(moe, method, groups, cf):
    jcfg, cfg, jp, p, x = moe
    jcfg, cfg = (dataclasses.replace(c, moe_groups=groups) for c in (jcfg, cfg))
    (jy, jaux), (y, aux) = both(jcfg, cfg, jp, p, x, method=method, capacity_factor=cf)
    np.testing.assert_allclose(y, jy, rtol=RTOL, atol=ATOL)
    assert aux == pytest.approx(jaux, rel=1e-5)


@pytest.mark.parametrize("method", ["dense_topk", "expert_choice"])
def test_shared_experts_match_reference(method):
    jcfg, cfg = (dataclasses.replace(c, num_shared_experts=1)
                 for c in (jax_smoke_config(ARCH), smoke_config(ARCH)))
    jp = jffn.init_moe(jcfg, jax.random.PRNGKey(3), jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    (jy, jaux), (y, aux) = both(jcfg, cfg, jp, carried(jp), x, method=method)
    np.testing.assert_allclose(y, jy, rtol=RTOL, atol=ATOL)
    assert aux == pytest.approx(jaux, rel=1e-5)


def test_top_k_takes_the_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    v, i = ffn.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    assert v.tolist() == np.asarray(jv).tolist()


@pytest.mark.parametrize("method", ["dense_topk", "expert_choice"])
def test_ties_resolve_as_the_reference(moe, method):
    """Expert choice over duplicated token rows (each expert's scores tie
    across the copies, and the copy it takes decides which row gets the
    output) and token choice over three equal router columns (experts 0-2
    tie): the port picks what the reference picks."""
    jcfg, cfg, jp, p, x = moe
    x = np.repeat(x[:, :2], 4, axis=1)  # rows 0, 1 of each sequence, 4 copies each
    col = jp["router"][:, 0]
    jp = dict(jp, router=jp["router"].at[:, 1].set(col).at[:, 2].set(col))
    (jy, _), (y, _) = both(jcfg, cfg, jp, carried(jp), x, method=method)
    np.testing.assert_allclose(y, jy, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["dense_topk", "expert_choice"])
def test_zero_input_is_a_fixed_point(moe, method):
    _, cfg, _, p, _ = moe
    y, aux = ffn.moe_forward(cfg, p, torch.zeros((2, 8, cfg.d_model)), method=method)
    torch.testing.assert_close(y, torch.zeros_like(y), atol=1e-6, rtol=0)
    assert float(aux) >= 0


@pytest.mark.parametrize("G", [2, 4])
def test_group_limited_equals_global_on_uniform_groups(moe, G):
    _, cfg, _, p, _ = moe
    x = torch.from_numpy(
        np.random.default_rng(G).standard_normal((G, 8, cfg.d_model)).astype(np.float32) * 0.5)
    y_g, _ = ffn.moe_forward(dataclasses.replace(cfg, moe_groups=G), p, x)
    rows = torch.cat([ffn.moe_forward(cfg, p, x[i:i + 1])[0] for i in range(G)])
    torch.testing.assert_close(y_g, rows, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the whole smoke model: loss_fn and its grads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 17)).astype(np.int32)
    return jcfg, cfg, jparams, carried(jparams), {"tokens": toks[..., :-1],
                                                  "labels": toks[..., 1:]}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(smoke, flash, remat):
    jcfg, cfg, jparams, params, batch = smoke
    jcfg, cfg = (dataclasses.replace(c, use_flash=flash) for c in (jcfg, cfg))
    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b, remat=remat)), in_axes=(None, 0)))(
        jparams, jax.tree.map(jnp.asarray, batch))
    grads, loss = vmap(grad_and_value(lambda p, b: tf.loss_fn(cfg, p, b, remat=remat)),
                       in_dims=(None, 0))(params, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(leaves) == len(jleaves) == 13
    for a, t in zip(jleaves, leaves):
        a = np.asarray(a)
        assert np.linalg.norm(t.numpy() - a) <= 1e-4 * np.linalg.norm(a)


def test_forward_returns_the_aux_loss_and_last_only_logits(smoke):
    jcfg, cfg, jparams, params, batch = smoke
    b = {k: v[0] for k, v in batch.items()}
    jlogits, jaux = jtf.forward(jcfg, jparams, jax.tree.map(jnp.asarray, b), last_only=True)
    logits, aux = tf.forward(cfg, params, {k: torch.from_numpy(v) for k, v in b.items()},
                             last_only=True)
    assert logits.shape == jlogits.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5) and float(aux) > 0


def test_train_step_matches_reference(smoke):
    """`make_train_step` (remat on, the default): new params within 1e-5 of
    |p| and the loss at 1e-5 relative, two steps."""
    jcfg, cfg, jparams, params, batch = smoke
    jstep, step = jax.jit(jtf.make_train_step(jcfg)), tf.make_train_step(cfg)
    for i in range(2):
        b = {k: v[i] for k, v in batch.items()}
        jparams, jloss = jstep(jparams, jax.tree.map(jnp.asarray, b), jnp.float32(0.5))
        params, loss = step(params, {k: torch.from_numpy(v) for k, v in b.items()}, 0.5)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = np.concatenate([t.numpy().ravel() for t in tree_leaves(params)])
    want = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jparams)])
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("variant,C", [("fedchs", 3), ("hfl", 3), ("fedchs", 2), ("hfl", 2),
                                       ("fedchs", 1), ("hfl", 1)])
def test_train_round_matches_reference(smoke, variant, C):
    """`launch.steps.make_train_round` against the reference's: C chains
    from different weights (seeds 0, 1, 2), each on its own cluster's batch,
    two rounds; the chain pass (a roll by one, whose direction shows from
    C = 3 on) or the chain mean, and the C = 1 shortcut.  Every param and
    the loss at rtol 1e-4 / atol 1e-5."""
    jcfg, cfg, jparams, _, _ = smoke
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 2, 17)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jchains = [jparams] + [jtf.init_params(jcfg, jax.random.PRNGKey(s)) for s in (1, 2)]
    jchains = jchains[:C]
    jstacked = jax.tree.map(lambda *x: jnp.stack(x), *jchains)
    stacked = carried(jstacked)
    jround = jax.jit(launch_steps.make_train_round(jcfg, variant=variant, remat=False))
    round_fn = make_train_round(cfg, variant=variant, remat=False)
    for _ in range(2):
        jstacked, jloss = jround(jstacked, jax.tree.map(lambda v: jnp.asarray(v[:C]), batch),
                                 jnp.float32(0.5))
        stacked, loss = round_fn(stacked, {k: torch.from_numpy(v[:C]) for k, v in batch.items()},
                                 0.5)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    jleaves, leaves = jax.tree.leaves(jstacked), tree_leaves(stacked)
    assert len(leaves) == len(jleaves)
    for a, t in zip(jleaves, leaves):
        assert tuple(t.shape) == a.shape and t.shape[0] == C
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# whole Fed-CHS runs of the smoke MoE LM
# ---------------------------------------------------------------------------

CLUSTERS = [[0, 2], [1, 3]]


class CarriedInit:
    """The port's model with the reference's initial params."""

    def __init__(self, model, p0):
        self.model, self.p0 = model, p0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init(self, seed=0, device=None):
        return params_from_jax(self.p0, device)


@pytest.fixture(scope="module")
def moe_tasks():
    def source(module):
        return module(512, num_clients=4, batch_size=2, seq_len=16, topics=4, seed=0)

    jtask = JaxFLTask.from_source(JaxLMFedModel(jax_smoke_config(ARCH), flash=True),
                                  source(JaxTokenSource), CLUSTERS, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    model = CarriedInit(LMFedModel(smoke_config(ARCH), flash=True), p0)
    task = FLTask.from_source(model, source(TokenSource), CLUSTERS, seed=0, device="cpu")
    return jtask, task, p0


def flat(leaves):
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


@pytest.mark.parametrize("qsgd", [False, True], ids=["grad_mode", "qsgd16"])
def test_moe_lm_fed_chs_run_matches_reference(moe_tasks, qsgd):
    jtask, task, p0 = moe_tasks
    kw = dict(rounds=2, local_steps=2, eval_every=1, seed=0, schedule=lambda k: 0.3)
    if qsgd:
        kw["local_epochs"] = 2
    jres = jax_run_fed_chs(jtask, JaxConfig(
        channel=JaxQSGDChannel(16) if qsgd else JaxDenseChannel(), **kw))
    res = run_fed_chs(task, FedCHSConfig(channel=QSGDChannel(16) if qsgd else DenseChannel(),
                                         **kw))
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits) and dict(tl.messages) == dict(jl.messages)
    assert tl.history == jl.history and tl.events == jl.events
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    if qsgd:
        assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want - flat(
            jax.tree.leaves(p0)))
        np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=0.02)
    else:
        assert np.linalg.norm(got - want) <= 3e-5 * np.linalg.norm(want)
        np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=1e-5)
        np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-5)


JAX_CONFIGS = {"fedavg": JaxFedAvgConfig, "wrwgd": JaxWRWGDConfig, "hier": JaxHierConfig,
               "fed_chs_lean": JaxConfig}
DRIVERS = {
    "fedavg": lambda: (run_fedavg, FedAvgConfig(rounds=2, local_steps=2, qsgd_levels=16,
                                                eval_every=1)),
    "wrwgd": lambda: (run_wrwgd, WRWGDConfig(rounds=3, local_steps=2, eval_every=1)),
    "hier": lambda: (run_hier_local_qsgd, HierLocalQSGDConfig(
        rounds=2, local_steps=2, local_epochs=2, qsgd_levels=16, eval_every=1)),
    "fed_chs_lean": lambda: (run_fed_chs, FedCHSConfig(
        rounds=2, local_steps=2, local_epochs=2, qsgd_levels=16, eval_every=1,
        precision=Precision(), client_microbatch=1)),
}


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_moe_lm_runs_under_every_driver_scanned_as_looped(moe_tasks, driver):
    """The smoke MoE LM (remat on) under the three baselines and under
    Fed-CHS with `Precision()` and client_microbatch 1: the scanned run
    (every driver's default) equals the looped run bit for bit, its ledger
    equals the reference's looped run's, and the params stay finite."""
    jtask, task, p0 = moe_tasks
    run, config = DRIVERS[driver]()
    remat = CarriedInit(LMFedModel(smoke_config(ARCH), flash=True, remat=True), p0)
    task = FLTask.from_source(remat, task.source, CLUSTERS, seed=0, device="cpu")
    scanned = run(task, config)
    looped = run(task, dataclasses.replace(config, scan_rounds=False))
    for a, b in zip(tree_leaves(scanned.final_params), tree_leaves(looped.final_params)):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert scanned.test_acc == looped.test_acc
    assert scanned.ledger.events == looped.ledger.events
    jrun = {"fedavg": jax_run_fedavg, "wrwgd": jax_run_wrwgd, "hier": jax_run_hier,
            "fed_chs_lean": jax_run_fed_chs}[driver]
    jconfig = JAX_CONFIGS[driver](**{f.name: getattr(config, f.name)
                                     for f in dataclasses.fields(config)
                                     if f.name not in ("precision", "scan_rounds")})
    if driver == "fed_chs_lean":
        jconfig = dataclasses.replace(jconfig, precision=JaxPrecision())
    jres = jrun(jtask, dataclasses.replace(jconfig, scan_rounds=False))
    assert scanned.ledger.events == jres.ledger.events
    assert dict(scanned.ledger.bits) == dict(jres.ledger.bits)


def test_params_from_jax_carries_a_bf16_moe_tree_and_caches():
    """The f32 router inside a bf16 tree keeps its dtype, the bf16 leaves
    their bits; a cache tree keeps its int32 lengths."""
    jcfg = jax_smoke_config(ARCH)
    jp = jffn.init_moe(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    p = carried(jp)
    assert p["router"].dtype == torch.float32 and p["w_in"].dtype == torch.bfloat16
    for k, a in jp.items():
        np.testing.assert_array_equal(p[k].float().numpy(), np.asarray(a, np.float32))
    jc = jtf.set_cache_len(jtf.init_caches(dataclasses.replace(jcfg, dtype="bfloat16"), 2, 4), 3)
    c = carried(jc)
    assert c["super"][0]["self"]["k"].dtype == torch.bfloat16
    assert c["super"][0]["self"]["len"].dtype == torch.int32
    assert c["super"][0]["self"]["len"].tolist() == [[3, 3]] * jcfg.num_layers
