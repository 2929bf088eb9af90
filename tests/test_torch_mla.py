"""The port's MLA, multi-token prediction and deepseek-v3-671b against the
reference, on the CPU.

At deepseek-v3-671b's smoke config (d_model 256, 4 heads, MLA q rank 64,
kv rank 32, nope 32 + rope 16, v 32; 4 experts top-2 and a shared expert;
MTP depth 1; f32) with the reference's params carried over
(`params_from_jax`), at the f32 rules of `tests/test_torch_lm.py` (rtol
1e-4 / atol 1e-5 on activations and logits, the loss at 1e-5 relative,
each grad leaf within 1e-4 in relative L2):

* `init_mla`'s leaves (with and without a q rank) and `init_params`'s tree
  (the `mtp` subtree included) equal the reference's in names, shapes and
  dtypes;
* `mla_forward` against the reference's, and `blockwise_attention` with v
  heads narrower than q/k heads against naive attention at the reference's
  atol 2e-5 (`tests/test_attention_oracles.py::test_mla_distinct_v_dim`);
* `mla_decode` / `decode_step` against the reference's step for step (the
  latent caches too), and teacher-forced decode against `forward` at the
  reference's own 2e-3 (`tests/test_decode_parity.py`), beside an
  off-by-one cache control that the bound rejects;
* `loss_fn` with MTP (and `_mtp_loss` alone) and its grads, remat off and
  on, under the engine's vmap over two clients; `make_train_step`, two
  steps; `prefill`; `serve_loop` tokens exactly;
* 2-round Fed-CHS runs of `LMFedModel(smoke deepseek)`, under the rules of
  `tests/test_torch_moe.py`: ledgers and events exact, QSGD(16) params
  within 3% of the update, grad mode within 3e-5 of |p|;
* a lean run (`Precision()`, client_microbatch 1, remat, QSGD(16)):
  scanned = looped bit for bit, the ledger the reference's, the params
  within 2^-3 of |p_T| (the bf16 bound of `tests/test_torch_lm.py`);
* the sigmoid router of more than 32 experts (`models/ffn.py::
  _router_probs`, deepseek-v3's 256 experts take it): `moe_forward` at 64
  experts top-4 with a shared expert, expert choice and dense top-k;
* the draw order: `init_params` of the qwen3-0.6b and dbrx-132b smoke
  configs gives, leaf for leaf, the reference's tensors, pinned (sha256
  prefixes of each leaf's bytes, seed 0, CPU).
"""
import dataclasses
import hashlib
import math

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
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import transformer as jtf
from repro.models.fed import LMFedModel as JaxLMFedModel
from repro_torch.checkpoint.io import treedef_str
from repro_torch.comm.channels import DenseChannel, QSGDChannel
from repro_torch.configs.registry import smoke_config
from repro_torch.core import FedCHSConfig, FLTask, prng, run_fed_chs
from repro_torch.data.sources import TokenSource
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.launch.serve import serve_loop
from repro_torch.models import LMFedModel
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_flatten, tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
RTOL, ATOL = 1e-4, 1e-5


def carried(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


def described(leaves):
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves]


def jdescribed(jtree):
    return [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jtree)]


@pytest.fixture(scope="module")
def deepseek():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 17)).astype(np.int32)
    return jcfg, cfg, jparams, carried(jparams), {"tokens": toks[..., :-1],
                                                  "labels": toks[..., 1:]}


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def jarrays(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_rank", [64, 0], ids=["q_lora", "no_q_lora"])
def test_init_mla_leaves_match_reference(q_rank):
    jcfg, cfg = (dataclasses.replace(c, mla=dataclasses.replace(c.mla, q_lora_rank=q_rank))
                 for c in (jax_smoke_config(ARCH), smoke_config(ARCH)))
    jp = jattn.init_mla(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    p = attn.init_mla(cfg, prng.PRNGKey(0), torch.bfloat16, "cpu")
    assert sorted(p) == sorted(jp)
    assert described(tree_flatten(p)[0]) == jdescribed(jp)
    for a, t in zip(jax.tree.leaves(jp), tree_flatten(p)[0]):  # the reference's draw
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))


def test_init_params_tree_matches_reference():
    """bf16, the mtp subtree and the f32 router included, at the
    reference's shapes and dtypes (`tests/test_torch_lm_init.py` holds the
    values)."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in (jax_smoke_config(ARCH), smoke_config(ARCH)))
    jp = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    p = tf.init_params(cfg, 0, "cpu")
    assert treedef_str(p) == str(jax.tree.structure(jp))
    assert described(tree_leaves(p)) == jdescribed(jp)
    assert len(tree_leaves(p)) == 37 and set(p["mtp"]) == {"block", "norm", "proj"}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def naive_attention(q, k, v):
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    T = q.shape[1]
    s = s.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool)), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)


def test_blockwise_attention_with_distinct_v_dim():
    g = torch.Generator().manual_seed(3)
    B, T, H, hd, hdv = 2, 48, 4, 24, 12
    q, k = (torch.randn((B, T, H, hd), generator=g) for _ in range(2))
    v = torch.randn((B, T, H, hdv), generator=g)
    out = attn.blockwise_attention(q, k, v, causal=True, kv_block=16)
    assert out.shape == (B, T, H, hdv)
    torch.testing.assert_close(out, naive_attention(q, k, v), atol=2e-5, rtol=0)


def test_mla_forward_matches_reference(deepseek):
    jcfg, cfg, jparams, params, _ = deepseek
    jp, p = jparams["super"][0]["attn"], params["super"][0]["attn"]
    x = np.random.default_rng(1).standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    want = jattn.mla_forward(jcfg, jax.tree.map(lambda a: a[0], jp), jnp.asarray(x))
    got = attn.mla_forward(cfg, {k: t[0] for k, t in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mla_forward_ignores_use_flash(deepseek):
    """The reference runs MLA blockwise whatever `use_flash` says: its v
    heads are narrower than its q/k heads, which the flash kernel does not
    take."""
    _, cfg, _, params, batch = deepseek
    b = tensors({k: v[0] for k, v in batch.items()})
    plain, _ = tf.forward(cfg, params, b)
    flash, _ = tf.forward(dataclasses.replace(cfg, use_flash=True), params, b)
    assert torch.equal(plain, flash)


def test_decode_steps_match_reference(deepseek):
    """Three tokens from empty caches, `dense_topk`: the logits and every
    cache leaf (the latent `c_kv`, the shared `k_rope`, `len` exact)."""
    jcfg, cfg, jparams, params, _ = deepseek
    toks = synthetic_lm_batch(cfg.vocab_size, 2, 3, seed=1)["tokens"]
    jc, c = jtf.init_caches(jcfg, 2, 8), tf.init_caches(cfg, 2, 8, device="cpu")
    assert treedef_str(c) == str(jax.tree.structure(jc))
    assert described(tree_leaves(c)) == jdescribed(jc)
    for t in range(3):
        jlogits, jc = jtf.decode_step(jcfg, jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                                      moe_method="dense_topk")
        logits, c = tf.decode_step(cfg, params, c, torch.from_numpy(toks[:, t:t + 1]),
                                   moe_method="dense_topk")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    for t, a in zip(tree_leaves(c), jax.tree.leaves(jc)):
        if a.dtype == np.int32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def teacher_forced(cfg, params, toks, off_by_one=False):
    caches, outs = tf.init_caches(cfg, toks.shape[0], toks.shape[1], device="cpu"), []
    for t in range(toks.shape[1]):
        if off_by_one and t:
            caches = tf.set_cache_len(caches, t - 1)
        logits, caches = tf.decode_step(cfg, params, caches, toks[:, t:t + 1],
                                        moe_method="dense_topk")
        outs.append(logits)
    return torch.stack(outs, dim=1)


def test_teacher_forced_absorbed_decode_matches_forward():
    """The absorbed decode (q W_uk c) against the materialised forward
    ((c W_uk) q) differ by float order only: the reference's 2e-3.  Writing
    each token over the previous one's slot reads far above it."""
    cfg = smoke_config(ARCH)
    params = tf.init_params(cfg, 0, "cpu")
    batch = tensors(synthetic_lm_batch(cfg.vocab_size, 2, 12, seed=0))
    fwd, _ = tf.forward(cfg, params, batch, moe_method="dense_topk")
    torch.testing.assert_close(teacher_forced(cfg, params, batch["tokens"]), fwd,
                               atol=2e-3, rtol=2e-3)
    ctrl = teacher_forced(cfg, params, batch["tokens"], off_by_one=True)
    assert float((ctrl - fwd).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# loss with MTP, grads, train step, prefill, serving
# ---------------------------------------------------------------------------


def test_mtp_loss_matches_reference(deepseek):
    jcfg, cfg, jparams, params, batch = deepseek
    b = {k: v[0] for k, v in batch.items()}
    want = float(jax.jit(lambda p, b: jtf._mtp_loss(jcfg, p, b))(jparams, jarrays(b)))
    got = float(tf._mtp_loss(cfg, params, tensors(b)))
    assert got == pytest.approx(want, rel=1e-5)
    # the shifted labels repeat the last label: it is scored, not ignored
    b2 = dict(b, labels=b["labels"].copy())
    b2["labels"][:, -1] = (b2["labels"][:, -1] + 1) % cfg.vocab_size
    assert float(tf._mtp_loss(cfg, params, tensors(b2))) != got


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_with_mtp_match_reference(deepseek, remat):
    jcfg, cfg, jparams, params, batch = deepseek
    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b, remat=remat)), in_axes=(None, 0)))(
        jparams, jarrays(batch))
    grads, loss = vmap(grad_and_value(lambda p, b: tf.loss_fn(cfg, p, b, remat=remat)),
                       in_dims=(None, 0))(params, tensors(batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(leaves) == len(jleaves) == 37
    for a, t in zip(jleaves, leaves):
        a = np.asarray(a)
        assert np.linalg.norm(t.numpy() - a) <= 1e-4 * np.linalg.norm(a)
    # embed and lm_head take gradient from both heads; the MTP block's too
    mtp_grads = tree_leaves(grads["mtp"])
    assert all(bool(g.abs().sum() > 0) for g in mtp_grads)


def test_train_step_matches_reference(deepseek):
    """`make_train_step` (remat on, the default), two steps of lr 0.5: the
    loss at 1e-5 relative and the params within 1e-5 of |p|."""
    jcfg, cfg, jparams, params, batch = deepseek
    jstep, step = jax.jit(jtf.make_train_step(jcfg)), tf.make_train_step(cfg)
    for i in range(2):
        b = {k: v[i] for k, v in batch.items()}
        jparams, jloss = jstep(jparams, jarrays(b), jnp.float32(0.5))
        params, loss = step(params, tensors(b), 0.5)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = np.concatenate([t.numpy().ravel() for t in tree_leaves(params)])
    want = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jparams)])
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_sgd_update_frees_each_gradient_it_is_given_as_a_list():
    params = {"a": torch.ones(3), "b": [torch.ones(2), torch.zeros(1)]}
    grads = [torch.full((3,), 2.0), torch.ones(2), torch.ones(1)]
    new = tf.sgd_update(params, grads, 0.5)
    assert grads == [None, None, None]
    assert new["a"].tolist() == [0.0] * 3 and new["b"][1].tolist() == [-0.5]
    tree = {"a": torch.ones(3), "b": [torch.ones(2), torch.ones(1)]}
    assert tf.sgd_update(params, tree, 1.0)["b"][0].tolist() == [0.0, 0.0]
    assert tree["a"] is not None  # a tree is not emptied


def test_prefill_matches_reference(deepseek):
    jcfg, cfg, jparams, params, _ = deepseek
    b = synthetic_lm_batch(cfg.vocab_size, 2, 10, seed=2)
    jlogits, jc = jtf.prefill(jcfg, jparams, jarrays(b), capacity=14)
    logits, c = tf.prefill(cfg, params, tensors(b), capacity=14)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    for t, a in zip(tree_leaves(c), jax.tree.leaves(jc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_serve_loop_matches_reference(deepseek):
    """3 requests over 4 slots on the default route (absorbed decode, expert
    choice across the slots): the reference's tokens exactly."""
    jcfg, cfg, jparams, params, _ = deepseek
    kw = dict(requests=3, slots=4, prompt_len=4, max_new=6)
    jdone, jsteps = jax_serve_loop(jcfg, jparams, **kw)
    done, steps = serve_loop(cfg, params, **kw)
    assert done == jdone and steps == jsteps
    assert sorted(done) == list(range(3)) and all(len(t) == 6 for t in done.values())


# ---------------------------------------------------------------------------
# the sigmoid router (more than 32 experts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dense_topk", "expert_choice"])
def test_sigmoid_router_moe_matches_reference(method):
    jcfg, cfg = (dataclasses.replace(c, num_experts=64, experts_per_token=4)
                 for c in (jax_smoke_config(ARCH), smoke_config(ARCH)))
    assert cfg.num_shared_experts == 1
    jp = jffn.init_moe(jcfg, jax.random.PRNGKey(5), jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = jffn.moe_forward(jcfg, jp, jnp.asarray(x), method=method)
    y, aux = ffn.moe_forward(cfg, carried(jp), torch.from_numpy(x), method=method)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    probs = ffn._router_probs(cfg, carried(jp), torch.from_numpy(x).reshape(-1, cfg.d_model))
    assert bool((probs > 0).all() and (probs < 1).all())
    assert not torch.allclose(probs.sum(-1), torch.ones(32))  # sigmoid, not softmax


# ---------------------------------------------------------------------------
# whole Fed-CHS runs of the smoke deepseek LM
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


def flat(leaves):
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


@pytest.mark.parametrize("qsgd", [False, True], ids=["grad_mode", "qsgd16"])
def test_deepseek_fed_chs_run_matches_reference(qsgd):
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


# ---------------------------------------------------------------------------
# the draw order of the configs that came before
# ---------------------------------------------------------------------------

# sha256 prefixes of each leaf of `init_params(smoke_config(arch), 0, "cpu")` in
# leaf order: the reference's `init_params(smoke_config(arch), PRNGKey(0))`, whose
# key tree gives each block its own key, so MLA, MTP and SSD blocks, which came
# later, leave these configs' weights as they were
EARLIER_DRAWS = {
    "qwen3-0.6b": [
        "3c5c0d49cb73073e", "893a106828fbdb95", "e33ee706e764af49", "02722f124d0f1736",
        "02722f124d0f1736", "80ce6d5d3cd5f7e7", "a796f5021e066fa3", "2e4af8190be72786",
        "caaeba4705b972b8", "0ddea787c96118ab", "adbeddbf153d3e7e", "7bdbd26ce71a5422",
        "fef951e6c76ad6a0", "fef951e6c76ad6a0"],
    "dbrx-132b": [
        "3c5c0d49cb73073e", "893a106828fbdb95", "e33ee706e764af49", "80ce6d5d3cd5f7e7",
        "a796f5021e066fa3", "2e4af8190be72786", "caaeba4705b972b8", "aa2b9e543fec6e1e",
        "b91b57d5017f27f8", "bc3f359206966801", "f0b8b5baf015ddf1", "fef951e6c76ad6a0",
        "fef951e6c76ad6a0"],
}


@pytest.mark.parametrize("arch", list(EARLIER_DRAWS))
def test_earlier_configs_draw_the_same_weights(arch):
    leaves = tree_leaves(tf.init_params(smoke_config(arch), 0, "cpu"))
    assert [hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]
            for t in leaves] == EARLIER_DRAWS[arch]


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
