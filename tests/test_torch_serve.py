"""The port's serving path against the reference, on the CPU.

Smoke configs (f32), the reference's params carried over
(`params_from_jax`):

* `init_caches`: the tree, shapes and dtypes of the reference's (stacked
  superblock caches with the batch on axis 1, ring buffers of
  `sliding_window` entries), and `set_cache_len`;
* `decode_step` against the reference's `decode_step`, three tokens from
  empty caches, for qwen3-0.6b, qwen1.5-32b, starcoder2-3b,
  mistral-nemo-12b and dbrx-132b (`moe_method="dense_topk"`, and the
  default expert choice over four slots, two of them tied): logits and
  every cache leaf at rtol 1e-4 / atol 1e-5 (the f32 rule of
  `tests/test_torch_lm.py`), `len` exact;
* teacher-forced decode equal to `forward` for the same five archs, and the
  sliding-window ring buffer against the windowed forward, at the
  reference's own bound in `tests/test_decode_parity.py` (atol = rtol =
  2e-3);
* `prefill` (last logits and caches) against the reference's, and with
  `capacity` beyond the prompt;
* `serve_loop`: the same tokens as the reference's serve loop on the same
  weights (qwen3-0.6b, and dbrx-132b with expert choice and idle slots),
  exactly `max_new` per request, and batched equal to solo, as
  `tests/test_serve_exec.py` pins for the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models import transformer as jtf
from repro_torch.checkpoint.io import treedef_str
from repro_torch.configs.registry import smoke_config
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.launch.serve import _splice_slot, serve_loop
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_flatten, tree_leaves
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

ARCHS = ["qwen3-0.6b", "qwen1.5-32b", "starcoder2-3b", "mistral-nemo-12b", "dbrx-132b"]
RTOL, ATOL = 1e-4, 1e-5
# a pattern of two kinds over 3 layers: one superblock and a tail layer
MIXED = {"block_pattern": ("attn", "local"), "sliding_window": 4}


def method(cfg):
    return "dense_topk" if cfg.is_moe else "expert_choice"


def models(arch, **replace):
    jcfg, cfg = (dataclasses.replace(c, **replace)
                 for c in (jax_smoke_config(arch), smoke_config(arch)))
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def tokens(cfg, B, T, seed=0):
    return synthetic_lm_batch(cfg.vocab_size, B, T, seed=seed)


def assert_caches_close(caches, jcaches):
    leaves, _ = tree_flatten(caches)
    jleaves = jax.tree.leaves(jcaches)
    assert len(leaves) == len(jleaves)
    for t, a in zip(leaves, jleaves):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype == np.int32:
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            np.testing.assert_allclose(t.numpy(), a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch,replace", [
    ("qwen3-0.6b", {}), ("dbrx-132b", {"num_layers": 3, **MIXED}),
    ("mistral-nemo-12b", {"block_pattern": ("local",), "sliding_window": 6}),
], ids=["qwen3", "dbrx_tail", "ring"])
def test_init_caches_match_reference(arch, replace):
    jcfg, cfg = (dataclasses.replace(c, **replace)
                 for c in (jax_smoke_config(arch), smoke_config(arch)))
    jc = jtf.init_caches(jcfg, 3, 10)
    c = tf.init_caches(cfg, 3, 10, device="cpu")
    leaves, _ = tree_flatten(c)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves] == \
        [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jc)]
    assert treedef_str(c) == str(jax.tree.structure(jc))
    c5 = tf.set_cache_len(c, 5)
    assert all(int(t.min()) == int(t.max()) == 5 for t in tree_leaves(c5)
               if t.dtype == torch.int32)
    assert_caches_close(c5, jtf.set_cache_len(jc, 5))


@pytest.mark.parametrize("arch,moe_method", [
    *(pytest.param(a, None, id=a) for a in ARCHS),
    pytest.param("dbrx-132b", "expert_choice", id="dbrx-132b-expert_choice"),
])
def test_decode_step_matches_reference(arch, moe_method):
    """`moe_method` None: `method(cfg)`.  The expert-choice case decodes
    four slots of which two carry the same token from the same (empty)
    caches, so their router scores tie exactly, as idle slots' do in
    `serve_loop`."""
    jcfg, cfg, jparams, params = models(arch)
    moe_method = moe_method or method(cfg)
    tied = moe_method == "expert_choice" and cfg.is_moe
    B = 4 if tied else 2
    toks = tokens(cfg, B, 3, seed=1)["tokens"]
    if tied:
        toks[3] = toks[2]
    jc, c = jtf.init_caches(jcfg, B, 8), tf.init_caches(cfg, B, 8, device="cpu")
    for t in range(3):
        jlogits, jc = jtf.decode_step(jcfg, jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                                      moe_method=moe_method)
        logits, c = tf.decode_step(cfg, params, c, torch.from_numpy(toks[:, t:t + 1]),
                                   moe_method=moe_method)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    assert_caches_close(c, jc)


def teacher_forced(cfg, params, toks, capacity, **kw):
    caches = tf.init_caches(cfg, toks.shape[0], capacity, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, caches = tf.decode_step(cfg, params, caches, toks[:, t:t + 1], **kw)
        outs.append(logits)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    cfg = smoke_config(arch)
    params = tf.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in tokens(cfg, 2, 12).items()}
    fwd, _ = tf.forward(cfg, params, batch, moe_method=method(cfg))
    dec = teacher_forced(cfg, params, batch["tokens"], 12, moe_method=method(cfg))
    torch.testing.assert_close(dec, fwd, atol=2e-3, rtol=2e-3)


def test_sliding_window_ring_buffer_parity():
    cfg = dataclasses.replace(smoke_config("mistral-nemo-12b"), block_pattern=("local",),
                              sliding_window=6)
    params = tf.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in tokens(cfg, 2, 20, seed=3).items()}
    fwd, _ = tf.forward(cfg, params, batch)
    dec = teacher_forced(cfg, params, batch["tokens"], cfg.sliding_window)
    torch.testing.assert_close(dec, fwd, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch,capacity,replace", [
    ("qwen3-0.6b", None, {}), ("dbrx-132b", 16, {}),
    ("mistral-nemo-12b", 12, {"num_layers": 3, **MIXED}),
], ids=["qwen3", "dbrx_capacity", "ring_tail"])
def test_prefill_matches_reference(arch, capacity, replace):
    jcfg, cfg, jparams, params = models(arch, **replace)
    b = tokens(cfg, 2, 10, seed=2)
    jlogits, jc = jtf.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in b.items()},
                              capacity=capacity)
    logits, c = tf.prefill(cfg, params, {k: torch.from_numpy(v) for k, v in b.items()},
                           capacity=capacity)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    assert_caches_close(c, jc)
    # the launchers' step builders run the same functions
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    for last_only in (False, True):
        torch.testing.assert_close(make_prefill_step(cfg, last_only=last_only)(params, b),
                                   logits, rtol=1e-6, atol=1e-6)
    step_logits, _ = make_decode_step(cfg)(params, c, b["tokens"][:, :1])
    assert step_logits.shape == (2, cfg.vocab_size)


def test_splice_slot_takes_one_slot_from_the_donor():
    cfg = dataclasses.replace(smoke_config("qwen3-0.6b"), num_layers=3, **MIXED)
    base = tf.set_cache_len(tf.init_caches(cfg, 3, 4, device="cpu"), 2)
    donor = tf.set_cache_len(tf.init_caches(cfg, 3, 4, device="cpu"), 7)
    out = _splice_slot(base, donor, 1)
    assert out["super"][1]["self"]["len"].tolist() == [[2, 7, 2]]
    assert out["tail"][0]["self"]["len"].tolist() == [2, 7, 2]
    assert base["super"][1]["self"]["len"].tolist() == [[2, 2, 2]]  # not written


@pytest.fixture(scope="module")
def qwen():
    return models("qwen3-0.6b")


def test_serve_loop_matches_reference(qwen):
    jcfg, cfg, jparams, params = qwen
    kw = dict(requests=5, slots=2, prompt_len=6, max_new=9)
    jdone, jsteps = jax_serve_loop(jcfg, jparams, **kw)
    done, steps = serve_loop(cfg, params, **kw)
    assert done == jdone and steps == jsteps
    assert sorted(done) == list(range(5)) and all(len(t) == 9 for t in done.values())


@pytest.mark.parametrize("slots", [3, 4])
def test_batched_equals_solo(qwen, slots):
    _, cfg, _, params = qwen
    batched, _ = serve_loop(cfg, params, requests=6, slots=slots, prompt_len=6, max_new=8)
    solo, _ = serve_loop(cfg, params, requests=6, slots=1, prompt_len=6, max_new=8)
    assert batched == solo and all(len(t) == 8 for t in solo.values())


def test_moe_serve_loop_matches_reference():
    """dbrx-132b on the default route (`decode_step` with expert choice
    across the slots): 3 requests over 4 slots, so idle slots carry the
    same token and their router scores tie; the tokens equal the
    reference's serve loop's on the same weights, exactly."""
    jcfg, cfg, jparams, params = models("dbrx-132b")
    kw = dict(requests=3, slots=4, prompt_len=4, max_new=6)
    jdone, jsteps = jax_serve_loop(jcfg, jparams, **kw)
    done, steps = serve_loop(cfg, params, **kw)
    assert done == jdone and steps == jsteps
    assert sorted(done) == list(range(3)) and all(len(t) == 6 for t in done.values())


def test_serve_loop_runs_a_moe_model_at_exactly_max_new():
    cfg = smoke_config("dbrx-132b")
    params = tf.init_params(cfg, 0, "cpu")
    done, steps = serve_loop(cfg, params, requests=5, slots=2, prompt_len=4, max_new=5)
    assert sorted(done) == list(range(5)) and all(len(t) == 5 for t in done.values())
    assert steps >= (5 * 4) // 2
