"""The port's encoder, cross-attention caches and patch embeddings
(whisper-tiny, phi-3-vision-4.2b) against the reference, on the CPU.

Smoke configs (f32; whisper: 2 decoder and 2 encoder layers, d_model 256,
24 frames; phi-3-vision: 2 layers, 8 patches of width 1024) with the
reference's params carried over, frames and patches drawn from a numpy
seed:
* `layer_norm` against the reference's at rtol 1e-6 (atol 1e-6);
* the encoder: the sinusoid table equal to the reference's in f32, the
  encoder's output and the cross caches of `prefill` against the
  reference's at rtol 1e-4 / atol 1e-5; `prefill`, `decode_step` over
  filled cross caches and teacher-forced decode against the reference's
  at the same rules, and against `forward` at the reference's 2e-3
  (`tests/test_decode_parity.py`) beside two controls (an off-by-one
  cache, zeroed cross caches) that read far outside it;
* whisper's and phi-3-vision's loss within 1e-5 relative and every
  gradient leaf within 1e-4 in relative L2 (the rules of
  `tests/test_torch_lm.py`), under vmap over the batch, with remat off and
  on: the encoder's and the projector's gradients included, and nonzero;
  the logits of phi-3-vision are the tokens' only;
* `make_train_round` over two chains with frames, as `train --execute`
  runs it (remat on, the engine's vmap over chains);
* phi-3-vision's decode (tokens only, as the reference's `prefill` and
  `serve_loop` replay them) against the forward of the backbone without
  the patches, at 2e-3;
* `serve_loop` tokens exactly the reference's for both configs (whisper
  decodes over zero cross caches, as the reference's does), batched equal
  to solo;
* `params_from_jax` on the encoder and projector trees, bf16 beside f32,
  bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.launch.steps import make_train_round as jax_make_train_round
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.checkpoint.io import treedef_str
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.steps import make_train_round
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_leaves, tree_map
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

WHISPER, PHI = "whisper-tiny", "phi-3-vision-4.2b"
RTOL, ATOL = 1e-4, 1e-5


def carried(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def jarrays(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def lm_batch(cfg, lead, T, seed):
    """Tokens and labels (*lead, T), and the stub frontend's frames or
    patches, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (*lead, T + 1)).astype(np.int32)
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.is_encoder_decoder:
        b["frames"] = rng.standard_normal((*lead, cfg.num_audio_frames, cfg.d_model)).astype(
            np.float32)
    if cfg.num_patches:
        b["patches"] = rng.standard_normal((*lead, cfg.num_patches, 1024)).astype(np.float32)
    return b


def model(arch):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, carried(jparams)


@pytest.fixture(scope="module")
def whisper():
    return model(WHISPER)


@pytest.fixture(scope="module")
def phi():
    return model(PHI)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 48), (48,), (48,)))
    want = jcommon.layer_norm(*map(jnp.asarray, (x, w, b)))
    got = common.layer_norm(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert common.layer_norm(xb, *map(torch.from_numpy, (w, b))).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# whisper: the encoder and the cross caches
# ---------------------------------------------------------------------------


def test_tree_and_caches_match_reference(whisper):
    jcfg, cfg, jparams, params = whisper
    assert treedef_str(params) == str(jax.tree.structure(jparams))
    own = tf.init_params(cfg, 0, "cpu")
    assert treedef_str(own) == treedef_str(params)
    assert [tuple(t.shape) for t in tree_leaves(own)] == [a.shape for a in
                                                          jax.tree.leaves(jparams)]
    assert set(params["super"][0]) == {"ln1", "attn", "ln_x", "xattn", "ln2", "ffn"}
    assert params["encoder"]["blocks"]["attn"]["wq"].shape[0] == cfg.encoder_layers
    for dtype in ("float32", "bfloat16"):
        jc = jtf.init_caches(dataclasses.replace(jcfg, dtype=dtype), 3, 10, enc_len=7)
        c = tf.init_caches(dataclasses.replace(cfg, dtype=dtype), 3, 10, enc_len=7,
                           device="cpu")
        assert treedef_str(c) == str(jax.tree.structure(jc))
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tree_leaves(c)] \
            == [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jc)]


def test_sinusoids_and_encoder_match_reference(whisper):
    jcfg, cfg, jparams, params = whisper
    b = lm_batch(cfg, (2,), 5, 0)
    # the table the reference adds, through its own code: the encoder of
    # zero frames with no layers and a unit norm is rms_norm(pe)
    empty = dict(jparams["encoder"], blocks=jax.tree.map(lambda a: a[:0],
                                                         jparams["encoder"]["blocks"]))
    zeros = np.zeros((1, cfg.num_audio_frames, cfg.d_model), np.float32)
    jpe = jtf._encoder_forward(jcfg, empty, jnp.asarray(zeros))
    pe = tf._encoder_forward(cfg, carried(empty), torch.from_numpy(zeros))
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-6, atol=1e-7)
    want = jtf._encoder_forward(jcfg, jparams["encoder"], jnp.asarray(b["frames"]))
    got = tf._encoder_forward(cfg, params["encoder"], torch.from_numpy(b["frames"]))
    assert got.shape == (2, cfg.num_audio_frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_prefill_cross_caches_and_decode_match_reference(whisper):
    jcfg, cfg, jparams, params = whisper
    b = lm_batch(cfg, (2,), 7, 1)
    jlogits, jc = jtf.prefill(jcfg, jparams, jarrays(b), capacity=12)
    logits, c = tf.prefill(cfg, params, tensors(b), capacity=12)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    assert treedef_str(c) == str(jax.tree.structure(jc))
    for t, a in zip(tree_leaves(c), jax.tree.leaves(jc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    assert float(c["super"][0]["cross_k"].abs().max()) > 0
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    for t in range(4):
        jlogits, jc = jtf.decode_step(jcfg, jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        logits, c = tf.decode_step(cfg, params, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)


def teacher_forced(cfg, params, caches, tokens, control=None):
    out = []
    for t in range(tokens.shape[1]):
        if control == "off_by_one" and t:
            caches = tf.set_cache_len(caches, t - 1)
        logits, caches = tf.decode_step(cfg, params, caches, tokens[:, t:t + 1])
        out.append(logits)
    return torch.stack(out, dim=1)


def test_teacher_forced_decode_matches_forward(whisper):
    """Decode over the cross caches `_fill_cross_caches` pins equals the
    forward at 2e-3; an off-by-one cache and zeroed cross caches read far
    outside."""
    jcfg, cfg, jparams, params = whisper
    T = 12
    batch = tensors(lm_batch(cfg, (2,), T, 3))
    fwd, _ = tf.forward(cfg, params, batch)
    empty = tf.init_caches(cfg, 2, T, enc_len=cfg.num_audio_frames, device="cpu")
    filled = tf._fill_cross_caches(cfg, params, batch, empty)
    dec = teacher_forced(cfg, params, filled, batch["tokens"])
    torch.testing.assert_close(dec, fwd, atol=2e-3, rtol=2e-3)
    for caches, control in ((filled, "off_by_one"), (empty, None)):
        ctrl = teacher_forced(cfg, params, caches, batch["tokens"], control)
        assert float((ctrl - fwd).abs().max()) > 0.1


@pytest.mark.parametrize("arch", [WHISPER, PHI])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(whisper, phi, arch, remat):
    jcfg, cfg, jparams, params = whisper if arch == WHISPER else phi
    batch = lm_batch(cfg, (2, 2), 9, 4)
    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b, remat=remat)), in_axes=(None, 0)))(
        jparams, jarrays(batch))
    grads, loss = vmap(grad_and_value(lambda p, b: tf.loss_fn(cfg, p, b, remat=remat)),
                       in_dims=(None, 0))(params, tensors(batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    assert treedef_str(grads) == str(jax.tree.structure(jgrads))
    for a, t in zip(jax.tree.leaves(jgrads), tree_leaves(grads)):
        a = np.asarray(a)
        assert np.linalg.norm(t.numpy() - a) <= 1e-4 * np.linalg.norm(a)
    new = grads["encoder"] if arch == WHISPER else grads["projector"]
    assert all(float(t.abs().sum()) > 0 for t in tree_leaves(new))
    logits, _ = tf.forward(cfg, params, tensors({k: v[0] for k, v in batch.items()}))
    assert logits.shape == (2, 9, cfg.vocab_size)


def test_train_round_with_frames_matches_reference(whisper):
    """`make_train_round` (fedchs, remat on) over two chains, each with its
    own frames: the engine's vmap over chains carries the encoder through
    `RematBlock`."""
    jcfg, cfg, jparams, params = whisper
    batch = lm_batch(cfg, (2, 2), 8, 5)
    jstacked = jax.tree.map(lambda x: jnp.stack([x, x * 0.5]), jparams)
    stacked = carried(jstacked)
    jround = jax.jit(jax_make_train_round(jcfg, variant="fedchs", remat=True))
    rnd = make_train_round(cfg, variant="fedchs", remat=True)
    for _ in range(2):
        jstacked, jloss = jround(jstacked, jarrays(batch), jnp.float32(0.3))
        stacked, loss = rnd(stacked, tensors(batch), 0.3)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = np.concatenate([t.numpy().ravel() for t in tree_leaves(stacked["encoder"])])
    want = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jstacked["encoder"])])
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    moved = tree_leaves(tree_map(lambda a, b: (a - b).abs().sum(), stacked["encoder"],
                                 carried(jax.tree.map(lambda x: jnp.stack([x, x * 0.5]),
                                                      jparams))["encoder"]))
    assert all(float(m) > 0 for m in moved)


# ---------------------------------------------------------------------------
# phi-3-vision: patch embeddings
# ---------------------------------------------------------------------------


def test_vlm_forward_matches_reference(phi):
    jcfg, cfg, jparams, params = phi
    assert params["projector"].shape == (1024, cfg.d_model)
    assert treedef_str(tf.init_params(cfg, 0, "cpu")) == treedef_str(params)
    b = lm_batch(cfg, (2,), 6, 6)
    jlogits, jaux = jtf.forward(jcfg, jparams, jarrays(b))
    logits, aux = tf.forward(cfg, params, tensors(b))
    assert logits.shape == (2, 6, cfg.vocab_size) == jlogits.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    last, _ = tf.forward(cfg, params, tensors(b), last_only=True)
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=1e-6, atol=1e-6)
    jlogits, _ = jtf.prefill(jcfg, jparams, jarrays(b))
    got, _ = tf.prefill(cfg, params, tensors(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)


def test_vlm_decode_matches_the_backbone_without_patches(phi):
    """The reference's decode parity holds a VLM's decode against the
    forward of its backbone without the prefix: decode never sees patches."""
    jcfg, cfg, jparams, params = phi
    b = tensors(lm_batch(dataclasses.replace(cfg, num_patches=0), (2,), 10, 7))
    backbone = dataclasses.replace(cfg, num_patches=0)
    fwd, _ = tf.forward(backbone, params, b)
    caches = tf.init_caches(cfg, 2, 10, device="cpu")
    dec = teacher_forced(cfg, params, caches, b["tokens"])
    torch.testing.assert_close(dec, fwd, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", [WHISPER, PHI])
def test_serve_loop_matches_reference(whisper, phi, arch):
    jcfg, cfg, jparams, params = whisper if arch == WHISPER else phi
    kw = dict(requests=4, slots=2, prompt_len=5, max_new=6)
    jdone, jsteps = jax_serve_loop(jcfg, jparams, **kw)
    done, steps = serve_loop(cfg, params, **kw)
    assert done == jdone and steps == jsteps
    solo, _ = serve_loop(cfg, params, requests=4, slots=1, prompt_len=5, max_new=6)
    assert solo == done


@pytest.mark.parametrize("arch", [WHISPER, PHI])
def test_params_from_jax_carries_the_new_trees(arch):
    """The encoder and projector trees of a bf16 config bit for bit, and
    its caches (the cross caches over the encoder's frames) in their
    dtypes."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="bfloat16")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    params = carried(jparams)
    assert treedef_str(params) == str(jax.tree.structure(jparams))
    for a, t in zip(jax.tree.leaves(jparams), tree_leaves(params)):
        a = np.asarray(a)
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
        got = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        want = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(got, want)
    enc_len = cfg.num_audio_frames
    back = carried(jtf.init_caches(jcfg, 2, 4, enc_len=enc_len))
    own = tf.init_caches(cfg, 2, 4, enc_len=enc_len, device="cpu")
    assert [(t.dtype, t.shape) for t in tree_leaves(back)] == \
        [(t.dtype, t.shape) for t in tree_leaves(own)]
