"""The port's RG-LRU (Griffin) blocks and recurrentgemma-9b against the
reference, on the CPU.

* `_lru_scan`, the port's doubling scan, against the reference's
  `associative_scan` and against a plain loop over T, in f32 at rtol 1e-5
  (atol 1e-6), T from 1 to 2112 with a drawn as `init_rglru_block` draws it;
  its gradients against `jax.grad` of the reference's at rtol 1e-5 (atol
  1e-6);
* `init_rglru_block`'s leaves (an f32 `lambda` inside a bf16 block),
  `rglru_block_forward` and `rglru_block_decode` against the reference's,
  at rtol 1e-4 / atol 1e-5;
* at recurrentgemma-9b's smoke config (rglru, rglru, local; d_model 256,
  LRU width 256, window 16, f32) with the reference's params carried over:
  the tree and caches (the f32 state beside the bf16 conv history of a
  bf16 config, which `set_cache_len`, the slot splice and
  `params_from_jax` keep), `decode_step` and `prefill` against the
  reference's, teacher-forced decode over 40 tokens (the window's ring
  buffer wraps twice) against the reference's decode at the same rules,
  and against `forward` at the reference's 2e-3 (`tests/test_decode_parity.py`)
  beside an off-by-one control, `loss_fn` and its grads with remat off and
  on (the rules of `tests/test_torch_lm.py`), `make_train_step`,
  `serve_loop` tokens exactly, and 2-round Fed-CHS runs under the rules of
  `tests/test_torch_moe.py` (QSGD(16) within 3% of the update, grad mode
  within 3e-5 of |p|, ledgers exact), and a lean run (`Precision()`,
  client_microbatch 1, remat, QSGD(16)) scanned = looped bit for bit, its
  ledger the reference's, its params within 2^-3 of |p_T|.
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
from repro.core.simulation import FLTask as JaxFLTask
from repro.data.sources import TokenSource as JaxTokenSource
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models import rglru as jrglru
from repro.models import transformer as jtf
from repro.models.fed import LMFedModel as JaxLMFedModel
from repro_torch.checkpoint.io import treedef_str
from repro_torch.comm.channels import DenseChannel, QSGDChannel
from repro_torch.configs.registry import smoke_config
from repro_torch.core import FedCHSConfig, FLTask, run_fed_chs
from repro_torch.data.sources import TokenSource
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.launch.serve import _splice_slot, serve_loop
from repro_torch.models import LMFedModel
from repro_torch.models import rglru
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_flatten, tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
RTOL, ATOL = 1e-4, 1e-5


def carried(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def jarrays(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def scan_inputs(seed, B=2, T=16, W=8):
    """a = exp(-8 softplus(lambda) r), lambda in (0.3, 0.8) and r in (0, 1),
    as the block makes it; u standard normal."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.3, 0.8, W)
    r = rng.uniform(0.0, 1.0, (B, T, W))
    a = np.exp(-8.0 * np.log1p(np.exp(lam)) * r).astype(np.float32)
    u = rng.standard_normal((B, T, W)).astype(np.float32)
    return a, u


def looped(a, u):
    h, hs = torch.zeros_like(u[:, 0]), []
    for t in range(u.shape[1]):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 2, 5, 16, 33, 512, 2112])
def test_lru_scan_matches_associative_scan_and_the_loop(T):
    a, u = scan_inputs(T, T=T)
    want = np.asarray(jrglru._lru_scan(jnp.asarray(a), jnp.asarray(u)))
    got = rglru._lru_scan(torch.from_numpy(a), torch.from_numpy(u))
    assert got.shape == u.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), looped(*map(torch.from_numpy, (a, u))).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [7, 64])
def test_lru_scan_gradients_match_reference(T):
    a, u = scan_inputs(T + 1, T=T)
    w = np.random.default_rng(T).standard_normal(u.shape).astype(np.float32)
    jga, jgu = jax.grad(lambda a, u: jnp.sum(jrglru._lru_scan(a, u) * w), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(u))
    wt = torch.from_numpy(w)
    ga, gu = torch.func.grad(lambda a, u: torch.sum(rglru._lru_scan(a, u) * wt),
                             argnums=(0, 1))(torch.from_numpy(a), torch.from_numpy(u))
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gu.numpy(), np.asarray(jgu), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jp = jrglru.init_rglru_block(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jp = dict(jp, conv_b=jnp.full(jp["conv_b"].shape, 0.1))  # a non-zero conv bias shows
    return jcfg, cfg, jp, carried(jp)


def test_init_rglru_block_leaves_match_reference():
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="bfloat16")
    jp = jrglru.init_rglru_block(jax_smoke_config(ARCH), jax.random.PRNGKey(0), jnp.bfloat16)
    p = rglru.init_rglru_block(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    leaves, _ = tree_flatten(p)
    assert sorted(p) == sorted(jp)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves] == \
        [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jp)]
    assert p["lambda"].dtype == torch.float32
    assert 0.3 <= float(p["lambda"].min()) and float(p["lambda"].max()) < 0.8
    stacked = rglru.init_rglru_block(cfg, torch.Generator().manual_seed(0), torch.bfloat16,
                                     (3,))
    assert stacked["lambda"].shape == (3, p["lambda"].shape[0])
    assert stacked["lambda"].dtype == torch.float32
    # params_from_jax keeps the f32 leaf of the bf16 tree, bit for bit
    back = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert back["lambda"].dtype == torch.float32 and back["w_x"].dtype == torch.bfloat16
    for k, t in back.items():
        want = np.asarray(jp[k])
        got = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(got, want.view(np.uint16) if want.dtype.name ==
                                      "bfloat16" else want)


@pytest.mark.parametrize("T", [1, 16, 37])
def test_rglru_block_forward_matches_reference(block, T):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(T).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    want = jrglru.rglru_block_forward(jcfg, jp, jnp.asarray(x))
    got = rglru.rglru_block_forward(cfg, p, torch.from_numpy(x))
    assert got.shape == (2, T, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_rglru_block_decode_matches_reference_and_its_forward(block):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(4).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    jc = jrglru.init_rglru_cache(jcfg, 2, jnp.float32)
    c = rglru.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(6):
        jy, jc = jrglru.rglru_block_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = rglru.rglru_block_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), c)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
        ys.append(y)
    for k in ("conv", "h"):
        assert tuple(c[k].shape) == jc[k].shape
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=RTOL, atol=ATOL)
    fwd = rglru.rglru_block_forward(cfg, p, torch.from_numpy(x))
    torch.testing.assert_close(torch.cat(ys, dim=1), fwd, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the smoke recurrentgemma LM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 21)).astype(np.int32)
    return jcfg, cfg, jparams, carried(jparams), {"tokens": toks[..., :-1],
                                                  "labels": toks[..., 1:]}


def test_tree_and_caches_match_reference(gemma):
    jcfg, cfg, jparams, params, _ = gemma
    assert treedef_str(params) == str(jax.tree.structure(jparams))
    assert set(params["super"][0]) == {"ln1", "mixer", "ln2", "ffn"}  # RG-LRU keeps its FFN
    assert set(params["super"][2]) == {"ln1", "attn", "ln2", "ffn"}
    own = tf.init_params(cfg, 0, "cpu")
    assert treedef_str(own) == treedef_str(params)
    assert [tuple(t.shape) for t in tree_leaves(own)] == [tuple(t.shape) for t in
                                                          tree_leaves(params)]
    for dtype in ("float32", "bfloat16"):
        jc = jtf.init_caches(dataclasses.replace(jcfg, dtype=dtype), 3, 10)
        c = tf.init_caches(dataclasses.replace(cfg, dtype=dtype), 3, 10, device="cpu")
        assert treedef_str(c) == str(jax.tree.structure(jc))
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tree_leaves(c)] \
            == [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jc)]
        assert c["super"][0]["mixer"]["h"].dtype == torch.float32
        back = params_from_jax(jax.tree.map(np.asarray, jc), "cpu")
        assert [t.dtype for t in tree_leaves(back)] == [t.dtype for t in tree_leaves(c)]
    # bf16 caches: set_cache_len moves the local block's `len` only, and the
    # slot splice keeps the f32 state and the bf16 history of the other slots
    filled = tf.init_caches(dataclasses.replace(cfg, dtype="bfloat16"), 3, 10, device="cpu")
    mix = filled["super"][0]["mixer"]
    filled["super"][0]["mixer"] = {"conv": torch.full_like(mix["conv"], 2.0),
                                   "h": torch.full_like(mix["h"], 1.0 + 2.0**-20)}
    moved = tf.set_cache_len(filled, 5)
    assert bool((moved["super"][2]["self"]["len"] == 5).all())
    assert torch.equal(moved["super"][0]["mixer"]["h"], filled["super"][0]["mixer"]["h"])
    empty = tf.init_caches(dataclasses.replace(cfg, dtype="bfloat16"), 3, 10, device="cpu")
    spliced = _splice_slot(empty, filled, 1)["super"][0]["mixer"]
    assert spliced["h"].dtype == torch.float32 and spliced["conv"].dtype == torch.bfloat16
    assert spliced["h"][:, 1].eq(1.0 + 2.0**-20).all() and spliced["h"][:, 0].eq(0).all()
    assert spliced["conv"][:, 1].eq(2.0).all() and spliced["conv"][:, 2].eq(0).all()


def test_decode_steps_and_prefill_match_reference(gemma):
    jcfg, cfg, jparams, params, _ = gemma
    toks = synthetic_lm_batch(cfg.vocab_size, 2, 3, seed=1)["tokens"]
    jc, c = jtf.init_caches(jcfg, 2, 8), tf.init_caches(cfg, 2, 8, device="cpu")
    for t in range(3):
        jlogits, jc = jtf.decode_step(jcfg, jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        logits, c = tf.decode_step(cfg, params, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    b = synthetic_lm_batch(cfg.vocab_size, 2, 10, seed=2)
    jlogits, jc = jtf.prefill(jcfg, jparams, jarrays(b))
    logits, c = tf.prefill(cfg, params, tensors(b))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    for t, a in zip(tree_leaves(c), jax.tree.leaves(jc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_decode_past_the_window_matches_reference_and_forward(gemma):
    """40 tokens through the window of 16: the local block's ring buffer
    wraps twice.  Teacher-forced decode equals the reference's decode at
    the rules above, and the port's forward at 2e-3; an off-by-one cache
    control reads far outside that."""
    jcfg, cfg, jparams, params, _ = gemma
    T = 40
    batch = synthetic_lm_batch(cfg.vocab_size, 2, T, seed=3)
    jc, c = jtf.init_caches(jcfg, 2, T), tf.init_caches(cfg, 2, T, device="cpu")
    assert c["super"][2]["self"]["k"].shape[2] == cfg.sliding_window
    toks = torch.from_numpy(batch["tokens"])
    outs, ctrl, cc = [], [], c
    for t in range(T):
        jlogits, jc = jtf.decode_step(jcfg, jparams, jc, jnp.asarray(batch["tokens"][:, t:t + 1]))
        logits, c = tf.decode_step(cfg, params, c, toks[:, t:t + 1])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
        outs.append(logits)
        if t:
            cc = tf.set_cache_len(cc, t - 1)
        logits_c, cc = tf.decode_step(cfg, params, cc, toks[:, t:t + 1])
        ctrl.append(logits_c)
    fwd, _ = tf.forward(cfg, params, tensors(batch))
    torch.testing.assert_close(torch.stack(outs, 1), fwd, atol=2e-3, rtol=2e-3)
    assert float((torch.stack(ctrl, 1) - fwd).abs().max()) > 0.1


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(gemma, remat):
    jcfg, cfg, jparams, params, batch = gemma
    jloss, jgrads = jax.vmap(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b, remat=remat)), in_axes=(None, 0))(
        jparams, jarrays(batch))
    grads, loss = vmap(grad_and_value(lambda p, b: tf.loss_fn(cfg, p, b, remat=remat)),
                       in_dims=(None, 0))(params, tensors(batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for a, t in zip(jleaves, leaves):
        a = np.asarray(a)
        assert np.linalg.norm(t.numpy() - a) <= 1e-4 * np.linalg.norm(a)
    assert float(grads["super"][0]["mixer"]["lambda"].abs().sum()) > 0  # the f32 leaf learns


def test_train_step_matches_reference(gemma):
    jcfg, cfg, jparams, params, batch = gemma
    jstep, step = jtf.make_train_step(jcfg), tf.make_train_step(cfg)
    for i in range(2):
        b = {k: v[i] for k, v in batch.items()}
        jparams, jloss = jstep(jparams, jarrays(b), jnp.float32(0.5))
        params, loss = step(params, tensors(b), 0.5)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = np.concatenate([t.numpy().ravel() for t in tree_leaves(params)])
    want = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jparams)])
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_serve_loop_matches_reference(gemma):
    jcfg, cfg, jparams, params, _ = gemma
    kw = dict(requests=5, slots=2, prompt_len=6, max_new=14)  # 20 > the window of 16
    jdone, jsteps = jax_serve_loop(jcfg, jparams, **kw)
    done, steps = serve_loop(cfg, params, **kw)
    assert done == jdone and steps == jsteps
    batched, _ = serve_loop(cfg, params, requests=5, slots=3, prompt_len=6, max_new=14)
    assert batched == done


CLUSTERS = [[0, 2], [1, 3]]


class CarriedInit:
    """The port's model with the reference's initial params."""

    def __init__(self, model, p0):
        self.model, self.p0 = model, p0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init(self, seed=0, device=None):
        return params_from_jax(self.p0, device)


def flat(leaves):
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


@pytest.mark.parametrize("qsgd", [False, True], ids=["grad_mode", "qsgd16"])
def test_recurrentgemma_fed_chs_run_matches_reference(qsgd):
    def source(module):
        return module(512, num_clients=4, batch_size=2, seq_len=16, topics=4, seed=0)

    jtask = JaxFLTask.from_source(JaxLMFedModel(jax_smoke_config(ARCH)),
                                  source(JaxTokenSource), CLUSTERS, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    task = FLTask.from_source(CarriedInit(LMFedModel(smoke_config(ARCH)), p0),
                              source(TokenSource), CLUSTERS, seed=0, device="cpu")
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


def test_lean_run_matches_reference_and_scans_as_it_loops():
    """The smoke model (remat on) under `Precision()`, client_microbatch 1
    and QSGD(16), 2 rounds: the f32 `lambda` leaf cast to bf16 for compute
    and quantized with the rest; the scanned run bit-equal to the looped
    run, the ledger equal to the reference's, the params back in f32 and
    within the bf16 bound of `tests/test_torch_lm.py` (2^-3 of |p_T|;
    perplexity within 5%)."""
    from repro.core.precision import Precision as JaxPrecision
    from repro_torch.core.precision import Precision

    def source(module):
        return module(512, num_clients=4, batch_size=2, seq_len=16, topics=4, seed=0)

    jtask = JaxFLTask.from_source(JaxLMFedModel(jax_smoke_config(ARCH), remat=True),
                                  source(JaxTokenSource), CLUSTERS, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    task = FLTask.from_source(CarriedInit(LMFedModel(smoke_config(ARCH), remat=True), p0),
                              source(TokenSource), CLUSTERS, seed=0, device="cpu")
    kw = dict(rounds=2, local_steps=2, local_epochs=2, eval_every=1, seed=0,
              schedule=lambda k: 0.3, client_microbatch=1, qsgd_levels=16)
    jres = jax_run_fed_chs(jtask, JaxConfig(precision=JaxPrecision(), scan_rounds=False, **kw))
    res = run_fed_chs(task, FedCHSConfig(precision=Precision(), **kw))
    looped = run_fed_chs(task, FedCHSConfig(precision=Precision(), scan_rounds=False, **kw))
    for a, b in zip(tree_leaves(res.final_params), tree_leaves(looped.final_params)):
        assert torch.equal(a, b) and a.dtype == torch.float32
    assert res.test_acc == looped.test_acc
    assert res.ledger.events == jres.ledger.events
    assert dict(res.ledger.bits) == dict(jres.ledger.bits)
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    assert np.linalg.norm(got - want) <= 2.0**-3 * np.linalg.norm(want)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=0.05)
