"""The port's SSD (Mamba-2) blocks and mamba2-370m against the reference, on
the CPU.

* `ssd_chunked` against the reference's on the same inputs (f32, rtol 1e-5,
  atol 1e-5: the port sums the reference's three-operand einsums in
  another order), and against the port's own `ssd_decode_step` looped
  token by token (y and the final state, at the reference's recurrence
  tolerance of `tests/test_attention_oracles.py`, 1e-3); a T that is not a
  multiple of the chunk raises; decode continues a chunked prefill's state;
* gradients through `ssd_chunked` where the masked segment sums overflow
  (decays of e^-60 a step over chunks of 16): finite, and equal to the
  reference's at rtol 1e-4;
* `init_ssd_block`'s leaves (A_log and dt_bias f32 inside a bf16 block),
  `ssd_block_forward` with T = 20 over chunks of 16 (padded inside) and
  `ssd_block_decode` against the reference's, at rtol 1e-4 / atol 1e-5;
* at mamba2-370m's smoke config (2 layers, d_model 256, state 32, heads of
  32, chunk 16, f32) with the reference's params carried over: the tree
  and caches (no FFN, no `len`), `set_cache_len` and the slot splice
  leaving the SSD caches' state alone, `decode_step` and `prefill`
  against the reference's, teacher-forced decode against `forward` at the
  reference's 2e-3 (`tests/test_decode_parity.py`) beside a control that
  drops the state, `loss_fn` and its grads (the rules of
  `tests/test_torch_lm.py`), `make_train_step`, `serve_loop` tokens
  exactly, and 2-round Fed-CHS runs under the rules of
  `tests/test_torch_moe.py` (QSGD(16) within 3% of the update, grad mode
  within 3e-5 of |p|, ledgers exact), and a lean run (`Precision()`,
  client_microbatch 1, remat, QSGD(16)) scanned = looped bit for bit, its
  ledger the reference's, its params within 2^-3 of |p_T| (the bf16 bound
  of `tests/test_torch_lm.py`).
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
from repro.models import ssd as jssd
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
from repro_torch.models import ssd
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_flatten, tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ARCH = "mamba2-370m"
RTOL, ATOL = 1e-4, 1e-5


def carried(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def jarrays(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def ssd_inputs(seed, B=2, T=48, H=3, P=8, N=4, decay=(0.01, 1.0)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    log_a = -rng.uniform(*decay, size=(B, T, H)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return x, log_a, Bm, Cm


def decoded(x, log_a, Bm, Cm, state=None):
    """The port's `ssd_decode_step` looped over T: (y (B,T,H,P), state)."""
    B, T, H, P = x.shape
    if state is None:
        state = torch.zeros((B, H, P, Bm.shape[-1]))
    ys = []
    for t in range(T):
        y, state = ssd.ssd_decode_step(x[:, t], log_a[:, t], Bm[:, t], Cm[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# the chunked dual form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk", [(32, 8), (64, 16), (64, 64), (48, 16)])
def test_ssd_chunked_matches_reference_and_the_recurrence(T, chunk):
    arrays = ssd_inputs(T + chunk, T=T)
    jy, jS = jssd.ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    y, S = ssd.ssd_chunked(*map(torch.from_numpy, arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5, atol=1e-5)
    y_rec, S_rec = decoded(*map(torch.from_numpy, arrays))
    torch.testing.assert_close(y, y_rec, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(S, S_rec, atol=1e-3, rtol=1e-3)


def test_ssd_chunked_refuses_a_ragged_length():
    with pytest.raises(ValueError, match="multiple"):
        ssd.ssd_chunked(*map(torch.from_numpy, ssd_inputs(0, T=20)), chunk=16)


def test_decode_continues_the_chunked_state():
    x, log_a, Bm, Cm = map(torch.from_numpy, ssd_inputs(9, B=1, T=17, H=2, P=4))
    _, S = ssd.ssd_chunked(x[:, :16], log_a[:, :16], Bm[:, :16], Cm[:, :16], chunk=8)
    y_next, _ = ssd.ssd_decode_step(x[:, 16], log_a[:, 16], Bm[:, 16], Cm[:, 16], S)
    y_rec, _ = decoded(x, log_a, Bm, Cm)
    torch.testing.assert_close(y_next, y_rec[:, 16], atol=1e-3, rtol=1e-3)


def test_gradients_stay_finite_where_the_masked_segments_overflow():
    """log decay -60 a step: a masked entry's segment sum reaches 60 x 15 =
    900 and exp of it overflows f32; the first `where` keeps it out of exp,
    so no inf * 0 reaches the backward."""
    arrays = ssd_inputs(2, T=32, decay=(60.0, 60.0))
    jgrads = jax.grad(lambda *a: jnp.sum(jssd.ssd_chunked(*a, chunk=16)[0] ** 2),
                      argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    grads = torch.func.grad(lambda *a: torch.sum(ssd.ssd_chunked(*a, chunk=16)[0] ** 2),
                            argnums=(0, 1, 2, 3))(*map(torch.from_numpy, arrays))
    for g, jg in zip(grads, jgrads):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jp = jssd.init_ssd_block(jcfg, jax.random.PRNGKey(0), jnp.float32)
    # a non-zero dt_bias and conv biases, so each term shows
    jp = dict(jp, dt_bias=jnp.linspace(-1.0, 1.0, jp["dt_bias"].shape[0]),
              conv_b=jnp.full(jp["conv_b"].shape, 0.1), D=jp["D"] * 0.5)
    return jcfg, cfg, jp, carried(jp)


def test_init_ssd_block_leaves_match_reference():
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="bfloat16")
    jp = jssd.init_ssd_block(jax_smoke_config(ARCH), jax.random.PRNGKey(0), jnp.bfloat16)
    p = ssd.init_ssd_block(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    leaves, _ = tree_flatten(p)
    assert sorted(p) == sorted(jp)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves] == \
        [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jp)]
    assert p["A_log"].dtype == p["dt_bias"].dtype == torch.float32
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]), rtol=1e-6)
    stacked = ssd.init_ssd_block(cfg, torch.Generator().manual_seed(0), torch.bfloat16, (3,))
    assert stacked["A_log"].shape == (3, p["A_log"].shape[0])
    assert torch.equal(stacked["A_log"][2], p["A_log"])


@pytest.mark.parametrize("T", [16, 20, 37], ids=["T16", "T20_ragged", "T37_ragged"])
def test_ssd_block_forward_matches_reference(block, T):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(T).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    want = jssd.ssd_block_forward(jcfg, jp, jnp.asarray(x))
    got = ssd.ssd_block_forward(cfg, p, torch.from_numpy(x))
    assert got.shape == (2, T, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_ssd_block_decode_matches_reference(block):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jc = jssd.init_ssd_cache(jcfg, 2, jnp.float32)
    c = ssd.init_ssd_cache(cfg, 2, torch.float32, "cpu")
    for t in range(5):
        jy, jc = jssd.ssd_block_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = ssd.ssd_block_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), c)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    for k in ("conv", "conv_bc", "state"):
        assert tuple(c[k].shape) == jc[k].shape and c[k].shape[1] in (cfg.ssm_conv - 1,
                                                                     jc["state"].shape[1])
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the smoke mamba2 LM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 21)).astype(np.int32)
    return jcfg, cfg, jparams, carried(jparams), {"tokens": toks[..., :-1],
                                                  "labels": toks[..., 1:]}


def test_tree_and_caches_match_reference(mamba):
    jcfg, cfg, jparams, params, _ = mamba
    assert treedef_str(params) == str(jax.tree.structure(jparams))
    assert set(params["super"][0]) == {"ln1", "mixer"}  # no FFN
    own = tf.init_params(cfg, 0, "cpu")
    assert treedef_str(own) == treedef_str(params)
    jc, c = jtf.init_caches(jcfg, 3, 10), tf.init_caches(cfg, 3, 10, device="cpu")
    assert treedef_str(c) == str(jax.tree.structure(jc))
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tree_leaves(c)] \
        == [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jc)]
    # no `len` leaf: set_cache_len and the slot splice leave the state alone
    filled = dict(c, super=[{"mixer": {k: torch.full_like(t, 2.0)
                                       for k, t in c["super"][0]["mixer"].items()}}])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tf.set_cache_len(filled, 5)),
                                                 tree_leaves(filled)))
    spliced = _splice_slot(c, filled, 1)["super"][0]["mixer"]["state"]
    assert spliced[:, 1].eq(2.0).all() and spliced[:, 0].eq(0).all() and spliced[:, 2].eq(0).all()


def test_decode_steps_and_prefill_match_reference(mamba):
    jcfg, cfg, jparams, params, _ = mamba
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


def test_teacher_forced_decode_matches_forward():
    """Over 20 tokens (two chunks of 16, the second ragged); a control that
    restarts every step from an empty state reads far outside the bound."""
    cfg = smoke_config(ARCH)
    params = tf.init_params(cfg, 0, "cpu")
    batch = tensors(synthetic_lm_batch(cfg.vocab_size, 2, 20, seed=0))
    fwd, _ = tf.forward(cfg, params, batch)
    outs, ctrl = [], []
    caches = tf.init_caches(cfg, 2, 20, device="cpu")
    empty = caches
    for t in range(20):
        logits, caches = tf.decode_step(cfg, params, caches, batch["tokens"][:, t:t + 1])
        outs.append(logits)
        ctrl.append(tf.decode_step(cfg, params, empty, batch["tokens"][:, t:t + 1])[0])
    torch.testing.assert_close(torch.stack(outs, 1), fwd, atol=2e-3, rtol=2e-3)
    assert float((torch.stack(ctrl, 1) - fwd).abs().max()) > 0.1


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(mamba, remat):
    jcfg, cfg, jparams, params, batch = mamba
    jloss, jgrads = jax.vmap(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b, remat=remat)), in_axes=(None, 0))(
        jparams, jarrays(batch))
    grads, loss = vmap(grad_and_value(lambda p, b: tf.loss_fn(cfg, p, b, remat=remat)),
                       in_dims=(None, 0))(params, tensors(batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(leaves) == len(jleaves) == 16
    for a, t in zip(jleaves, leaves):
        a = np.asarray(a)
        assert np.linalg.norm(t.numpy() - a) <= 1e-4 * np.linalg.norm(a)


def test_train_step_matches_reference(mamba):
    jcfg, cfg, jparams, params, batch = mamba
    jstep, step = jtf.make_train_step(jcfg), tf.make_train_step(cfg)
    for i in range(2):
        b = {k: v[i] for k, v in batch.items()}
        jparams, jloss = jstep(jparams, jarrays(b), jnp.float32(0.5))
        params, loss = step(params, tensors(b), 0.5)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = np.concatenate([t.numpy().ravel() for t in tree_leaves(params)])
    want = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jparams)])
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_serve_loop_matches_reference(mamba):
    jcfg, cfg, jparams, params, _ = mamba
    kw = dict(requests=5, slots=2, prompt_len=6, max_new=9)
    jdone, jsteps = jax_serve_loop(jcfg, jparams, **kw)
    done, steps = serve_loop(cfg, params, **kw)
    assert done == jdone and steps == jsteps
    batched, _ = serve_loop(cfg, params, requests=5, slots=3, prompt_len=6, max_new=9)
    assert batched == done  # the recurrence has no cross-slot term


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
def test_mamba2_fed_chs_run_matches_reference(qsgd):
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
    """The smoke LM (remat on) under `Precision()`, client_microbatch 1 and
    QSGD(16), 2 rounds: the scanned run bit-equal to the looped run, the
    ledger equal to the reference's, the params back in f32 (the f32
    leaves of a bf16-compute model, such as an SSD block's `A_log`, cast
    as the reference casts them) and within the bf16 bound of
    `tests/test_torch_lm.py` (2^-3 of |p_T|; perplexity within 5%)."""
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
