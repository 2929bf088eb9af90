"""The port's transformer LM path against the reference package, on the CPU.

Model functions at the qwen3-0.6b smoke config (2 layers, d_model 256,
GQA 4/2 heads of 64, qk_norm, vocab 512) with the reference's params
carried over: the loss within 1e-5 relative and every gradient leaf within
1e-4 in relative L2 (both packages compute in f32 and sum in other orders;
the observed gaps are about 1e-7 and 2e-6), with flash attention on (the
reference's Pallas kernel in interpret mode, the port's plain version) and
off.  The token source draws bit for bit.  Whole Fed-CHS runs on the toy LM
of `tests/test_fedtask_lm.py` with flash on in both packages: the ledger
and visit order exact; the QSGD(16) run's update p_T - p_0 within 3% in
relative L2 and the perplexity trace within 2% (a code flips where
float-order noise crosses a rounding boundary, see
`tests/test_torch_fed_chs.py`; the observed update gap is about 3e-7,
and the update is about a quarter of |p_T|); the dense grad-mode
run's loss and perplexity traces within 1e-5 relative, its params within
3e-5 in relative L2.  That last bound is looser than 1e-5 because training
at lr 0.3 amplifies float-order noise: the params differ by 5e-7 after one
round and by 1.1e-5 after three (1.4e-5 with flash off, so the growth is
not the kernel's), most of it in the embedding rows of the few tokens seen.

Remat (`LMFedModel(remat=True)`) recomputes each superblock in the
backward: its loss and grads are bit-equal to the path without it in the
port, in f32 and bf16, and held against the reference's
`loss_fn(remat=True)` at the rules above; the flash forward then runs twice
per layer.  The memory-lean configuration (remat, `client_microbatch=1`,
flash) is held at f32 by the rules of the whole runs above, and under
`Precision()` at the bounds stated beside `LEAN_TOL`.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.comm.channels import DenseChannel as JaxDenseChannel
from repro.comm.channels import QSGDChannel as JaxQSGDChannel
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import FedCHSConfig as JaxConfig
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core.precision import Precision as JaxPrecision
from repro.core.simulation import FLTask as JaxFLTask
from repro.data.sources import TokenSource as JaxTokenSource
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.models.fed import LMFedModel as JaxLMFedModel
from repro_torch.comm.channels import DenseChannel, QSGDChannel
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.precision import Precision, cast_floats
from repro_torch.core.simulation import FLTask
from repro_torch.data.sources import TokenSource
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.models.fed import LMFedModel
from repro_torch.utils import tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ARCH = "qwen3-0.6b"


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    return jcfg, cfg, jparams, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x, w = f32(rng, 2, 9, 4, 64), f32(rng, 64)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), rtol=1e-6,
        atol=1e-6)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    jcos, jsin = jcommon.rope_angles(jnp.asarray(pos), 64, 1e6)
    cos, sin = common.rope_angles(torch.from_numpy(pos.copy()), 64, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jcos, jsin)), atol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_forward_matches_reference(smoke, flash):
    jcfg, cfg, jparams, params, _ = smoke
    jcfg, cfg = (dataclasses.replace(c, use_flash=flash) for c in (jcfg, cfg))
    x = f32(np.random.default_rng(2), 2, 32, cfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["super"][0]["attn"])
    p = {k: t[0] for k, t in params["super"][0]["attn"].items()}
    want = jattn.attention_forward(jcfg, jp, jnp.asarray(x))
    got = attn.attention_forward(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_grads_match_reference(smoke, flash):
    jcfg, cfg, jparams, params, batch = smoke
    jcfg, cfg = (dataclasses.replace(c, use_flash=flash) for c in (jcfg, cfg))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)))(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, loss = grad_and_value(lambda p: tf.loss_fn(cfg, p, tbatch))(params)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(leaves) == len(jleaves) == 14
    for a, t in zip(jleaves, leaves):
        a = np.asarray(a)
        assert np.linalg.norm(t.numpy() - a) <= 1e-4 * np.linalg.norm(a)


def test_vmapped_loss_launches_one_flash_call_per_layer(smoke, monkeypatch):
    """Under the engine's vmap over clients the flash op runs once per layer
    for all clients, and the backward runs none (blockwise recompute)."""
    _, cfg, _, params, batch = smoke
    model = LMFedModel(cfg, flash=True)
    calls = []
    real = attn.flash_attention
    monkeypatch.setattr(attn, "flash_attention",
                        lambda q, *a, **k: calls.append(tuple(q.shape)) or real(q, *a, **k))
    stacked = {k: torch.from_numpy(np.stack([v, v[::-1].copy()])) for k, v in batch.items()}
    per_client = vmap(grad_and_value(model.loss), in_dims=(None, 0))
    _, losses = per_client(params, stacked)
    assert losses.shape == (2,)
    assert calls == [(4, 32, cfg.num_heads, cfg.head_dim)] * cfg.num_layers


def test_token_source_draws_match_reference():
    kw = dict(num_clients=3, batch_size=2, seq_len=24, topics=3, seed=5)
    jsrc, src = JaxTokenSource(512, **kw), TokenSource(512, **kw)
    for name in ("tokens", "labels"):
        np.testing.assert_array_equal(src.eval_data()[name], jsrc.eval_data()[name])
    for client in (0, 2, 1, 0, 0):
        a, b = src.next_batch(client), jsrc.next_batch(client)
        for name in ("tokens", "labels"):
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])
    src.reset(7), jsrc.reset(7)
    src.fast_forward([2, 0, 1]), jsrc.fast_forward([2, 0, 1])
    np.testing.assert_array_equal(src.next_batch(0)["tokens"], jsrc.next_batch(0)["tokens"])


# ids as the cases had them when they raised NotImplementedError (make1,
# remat=True and the MoE case, went first): make2 and make3 were deepseek-v3
# (MLA, MTP) and mamba2 (SSD blocks) beside RG-LRU blocks, make4-make6 the
# configs with RG-LRU blocks, an encoder and patch embeddings.  Every one is
# ported now, and each builds and takes the reference's loss at the rules of
# `test_loss_and_grads_match_reference`; make7, a block kind neither
# package knows, raises ValueError in both.
UNKNOWN_KIND = dataclasses.replace(smoke_config(ARCH), block_pattern=("attn", "conv"))


@pytest.mark.parametrize("make", [
    lambda: LMFedModel(dataclasses.replace(smoke_config("deepseek-v3-671b"),
                                           block_pattern=("attn", "rglru"))),
    lambda: LMFedModel(dataclasses.replace(smoke_config("mamba2-370m"),
                                           block_pattern=("ssd", "rglru"))),
    lambda: LMFedModel(smoke_config("recurrentgemma-9b")),  # RG-LRU blocks
    lambda: LMFedModel(smoke_config("whisper-tiny")),       # encoder
    lambda: LMFedModel(smoke_config("phi-3-vision-4.2b")),  # patch embeddings
    lambda: LMFedModel(UNKNOWN_KIND),
], ids=["make2", "make3", "make4", "make5", "make6", "make7"])
def test_unported_model_options_raise(make):
    model = make()
    fields = {f.name: getattr(model.cfg, f.name) for f in dataclasses.fields(model.cfg)}
    if model.cfg.mla is not None:
        fields["mla"] = JaxMLAConfig(**dataclasses.asdict(model.cfg.mla))
    jmodel = JaxLMFedModel(JaxArchConfig(**fields))
    if model.cfg is UNKNOWN_KIND:
        with pytest.raises(ValueError, match="conv"):
            jmodel.init(jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="conv"):
            model.init(0, "cpu")
        return
    cfg = model.cfg
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert [tuple(t.shape) for t in tree_leaves(model.init(0, "cpu"))] == \
        [a.shape for a in jax.tree.leaves(jparams)]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["frames"] = f32(rng, 2, cfg.num_audio_frames, cfg.d_model)
    if cfg.num_patches:
        batch["patches"] = f32(rng, 2, cfg.num_patches, 1024)
    want = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# whole runs on the toy LM of tests/test_fedtask_lm.py, flash on
# ---------------------------------------------------------------------------

TOY = dict(name="toy-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
           num_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")
CLUSTERS = [[0, 1], [2, 3]]


class CarriedInit:
    """The port's model with the reference's initial params."""

    def __init__(self, model, p0):
        self.model, self.p0 = model, p0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init(self, seed=0, device=None):
        return params_from_jax(self.p0, device)


@pytest.fixture(scope="module")
def toy_tasks():
    def source(module):
        return module(64, num_clients=4, batch_size=2, seq_len=16, topics=4, seed=0)

    jtask = JaxFLTask.from_source(JaxLMFedModel(JaxArchConfig(**TOY), flash=True),
                                  source(JaxTokenSource), CLUSTERS, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    model = CarriedInit(LMFedModel(ArchConfig(**TOY), flash=True), p0)
    task = FLTask.from_source(model, source(TokenSource), CLUSTERS, seed=0, device="cpu")
    assert task.num_clients == 4 and task.metric_name == "perplexity"
    return jtask, task


def run_both(toy_tasks, channel, **kw):
    jtask, task = toy_tasks
    jchannel = JaxQSGDChannel(channel.levels) if isinstance(channel, QSGDChannel) \
        else JaxDenseChannel()
    common_kw = dict(rounds=3, eval_every=1, seed=0, schedule=lambda k: 0.3, **kw)
    return (jax_run_fed_chs(jtask, JaxConfig(channel=jchannel, **common_kw)),
            run_fed_chs(task, FedCHSConfig(channel=channel, **common_kw)))


def assert_ledgers_equal(jres, res):
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits) and dict(tl.messages) == dict(jl.messages)
    assert tl.history == jl.history and tl.events == jl.events
    assert res.rounds == jres.rounds and res.metric_mode == "min"


def flat(leaves):
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


def test_qsgd_lm_run_matches_reference(toy_tasks):
    jres, res = run_both(toy_tasks, QSGDChannel(16), local_steps=4, local_epochs=2)
    assert_ledgers_equal(jres, res)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=0.02)
    p0 = flat(jax.tree.leaves(toy_tasks[0].init_params()))
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    # the updates p_T - p_0 (about a quarter of |p_T| here) within 3% of each other
    assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want - p0)
    assert res.train_loss[-1] < res.train_loss[0]


def test_grad_mode_lm_run_matches_reference(toy_tasks):
    jres, res = run_both(toy_tasks, DenseChannel(), local_steps=4)
    assert_ledgers_equal(jres, res)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=1e-5)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-5)
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    assert np.linalg.norm(got - want) <= 3e-5 * np.linalg.norm(want)


# ---------------------------------------------------------------------------
# remat and the memory-lean configuration
# ---------------------------------------------------------------------------


def two_clients(batch):
    return {k: np.stack([v, v[::-1].copy()]) for k, v in batch.items()}


@pytest.mark.parametrize("flash", [False, True])
def test_remat_loss_and_grads_equal_no_remat(smoke, flash):
    """Under the engine's vmap(grad_and_value) over 2 clients, in f32 and in
    bf16, remat recomputes the same graph: loss and grads bit-equal."""
    _, cfg, _, params, batch = smoke
    stacked = {k: torch.from_numpy(v) for k, v in two_clients(batch).items()}
    for p in (params, cast_floats(params, "bfloat16")):
        (g0, l0), (g1, l1) = [
            vmap(grad_and_value(LMFedModel(cfg, remat=remat, flash=flash).loss),
                 in_dims=(None, 0))(p, stacked) for remat in (False, True)]
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) and a.dtype == b.dtype == tree_leaves(p)[0].dtype
                   for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


@pytest.mark.parametrize("flash", [False, True])
def test_remat_loss_and_grads_match_reference(smoke, flash):
    """`loss_fn(remat=True)` in both packages under a vmap over 2 clients,
    held as the non-remat path is: the loss at 1e-5 relative, every grad
    leaf at 1e-4 in relative L2."""
    jcfg, cfg, jparams, params, batch = smoke
    jcfg, cfg = (dataclasses.replace(c, use_flash=flash) for c in (jcfg, cfg))
    stacked = two_clients(batch)
    jloss, jgrads = jax.vmap(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b, remat=True)), in_axes=(None, 0))(
        jparams, jax.tree.map(jnp.asarray, stacked))
    grads, loss = vmap(grad_and_value(lambda p, b: tf.loss_fn(cfg, p, b, remat=True)),
                       in_dims=(None, 0))(params, {k: torch.from_numpy(v)
                                                   for k, v in stacked.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    for a, t in zip(jax.tree.leaves(jgrads), tree_leaves(grads)):
        a = np.asarray(a)
        assert np.linalg.norm(t.numpy() - a) <= 1e-4 * np.linalg.norm(a)


def test_remat_runs_the_flash_forward_twice_per_layer(smoke, monkeypatch):
    """Forward, then the recompute in the backward: two flash calls per
    layer for all clients of a step, none in the blockwise backward."""
    _, cfg, _, params, batch = smoke
    calls = []
    real = attn.flash_attention
    monkeypatch.setattr(attn, "flash_attention",
                        lambda q, *a, **k: calls.append(tuple(q.shape)) or real(q, *a, **k))
    stacked = {k: torch.from_numpy(v) for k, v in two_clients(batch).items()}
    model = LMFedModel(cfg, remat=True, flash=True)
    vmap(grad_and_value(model.loss), in_dims=(None, 0))(params, stacked)
    assert calls == [(4, 32, cfg.num_heads, cfg.head_dim)] * (2 * cfg.num_layers)


def lean_tasks(remat=True):
    def source(module):
        return module(64, num_clients=4, batch_size=2, seq_len=16, topics=4, seed=0)

    jtask = JaxFLTask.from_source(
        JaxLMFedModel(JaxArchConfig(**TOY), remat=remat, flash=True), source(JaxTokenSource),
        CLUSTERS, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    model = CarriedInit(LMFedModel(ArchConfig(**TOY), remat=remat, flash=True), p0)
    return jtask, FLTask.from_source(model, source(TokenSource), CLUSTERS, seed=0, device="cpu")


@pytest.mark.parametrize("qsgd", [False, True], ids=["dense", "qsgd16"])
def test_remat_microbatched_lm_run_matches_reference_in_f32(qsgd):
    """remat + client_microbatch=1 + flash at f32: the structure of the lean
    path held at the f32 rules of the runs above (dense: params within 3e-5
    of |p_T|, perplexity at 1e-5; QSGD: the update within 3%)."""
    jtask, task = lean_tasks()
    kw = dict(rounds=3, local_steps=4, local_epochs=2, eval_every=1, seed=0,
              schedule=lambda k: 0.3, client_microbatch=1, qsgd_levels=16 if qsgd else None)
    jres, res = jax_run_fed_chs(jtask, JaxConfig(**kw)), run_fed_chs(task, FedCHSConfig(**kw))
    assert_ledgers_equal(jres, res)
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    if qsgd:
        p0 = flat(jax.tree.leaves(jtask.init_params()))
        assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want - p0)
        np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=0.02)
    else:
        assert np.linalg.norm(got - want) <= 3e-5 * np.linalg.norm(want)
        np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=1e-5)


# Under Precision() the toy LM at lr 0.3 moves |p| by a quarter in 3 rounds,
# and the packages' bf16 rounding (see tests/test_torch_precision.py) puts
# their runs 3.3% of |p_T| apart with the bf16 dense wire and 9.4% with
# QSGD(16), whose codes flip where that noise crosses a level: no nearer
# than a run of the port in f32 compute is to the reference's bf16 run (3.8%
# and 8.9%).  So the params are held at bf16-run bounds, the perplexity
# trace at 3% (QSGD 5%), and the lean path's structure at f32 by the test
# above (ROADMAP Queue C).
LEAN_TOL = {False: 2.0**-4, True: 2.0**-3}
LEAN_PPL = {False: 0.03, True: 0.05}


@pytest.mark.parametrize("qsgd", [False, True], ids=["bf16_wire", "qsgd16"])
def test_lean_lm_run_matches_reference(qsgd):
    """The toy LM under all three knobs: `Precision()`, client_microbatch=1,
    `LMFedModel(remat=True, flash=True)`.  Ledgers and visit order exact
    (every broadcast at bf16 width, uplinks too unless QSGD); params back in
    f32 and within `LEAN_TOL` of |p_T| of the reference's; perplexity
    within `LEAN_PPL`; the train loss falls."""
    jtask, task = lean_tasks()
    kw = dict(rounds=3, local_steps=4, local_epochs=2, eval_every=1, seed=0,
              schedule=lambda k: 0.3, client_microbatch=1, qsgd_levels=16 if qsgd else None)
    jres = jax_run_fed_chs(jtask, JaxConfig(precision=JaxPrecision(), **kw))
    res = run_fed_chs(task, FedCHSConfig(precision=Precision(), **kw))
    assert_ledgers_equal(jres, res)
    d = task.num_params()
    assert {e.n_bits for e in res.ledger.events if e.hop != "client_to_es"} == {16 * d}
    assert {t.dtype for t in tree_leaves(res.final_params)} == {torch.float32}
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    assert np.linalg.norm(got - want) <= LEAN_TOL[qsgd] * np.linalg.norm(want)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=LEAN_PPL[qsgd])
    assert res.train_loss[-1] < res.train_loss[0]


def test_lm_example_runs_the_lean_configuration_on_the_cpu():
    """`examples/torch_train_lm_fedchs.py` end to end at a toy size with the
    memory-lean knobs on: 2 rounds, the bf16 dense wire priced at half the
    f32 message."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "examples" / "torch_train_lm_fedchs.py"), "--device", "cpu",
         "--d-model", "64", "--layers", "2", "--vocab", "128", "--seq", "16", "--rounds", "2",
         "--eval-every", "1", "--mixed-precision", "--remat", "--flash", "--qsgd", "0",
         "--client-microbatch", "1"],
        env=dict(os.environ, PYTHONPATH=str(root / "src")), check=True, timeout=600,
        capture_output=True, text=True).stdout
    assert "microbatch=1, bf16 compute / f32 master, remat, flash" in out
    assert "DenseChannel[bfloat16] uplink" in out
    assert out.count("held-out ppl") == 2
