"""The port's model mesh on the CPU (`launch.mesh.make_debug_mesh`,
`launch.steps`, `models.moe_shardmap`): four `gloo` ranks, spawned once
for the module, run the cases and hand back whole tensors, which the main
process holds against the port's one-device runs and the reference:

* smoke qwen3-0.6b (f32, flash on: its plain version on the CPU, through
  `local_map` on each rank's heads) on (data 2, model 2): one
  `make_train_round` (C = 1), a prefill and 2 decode steps against one
  device, in relative L2, under a bound set beside a 1-ulp control (the
  one-device run from weights 1 ulp apart): model-mesh runs add partial
  sums in another order, so they are not bit-equal;
* on (pod 2, data 1, model 2): a Fed-CHS and an HFL round (C = 2, chain c
  on pod c) against the one-device vmapped round, beside a control the
  bound rejects (the chains not rolled), and the prefill and decode with
  the batch split over (pod, data);
* decode with one kv head on (2, 2): the caches split their sequence
  axis over "model" (flash-decode style), 4 steps against one device;
* `moe_routed_shardmap` of smoke dbrx-132b on (2, 2) against the
  reference's grouped oracle (`moe_forward` with `moe_groups=2`) at its
  atol 1e-5, its gradients against the port's one-device oracle's
  (w_out and the router get theirs); at (1, 1) against the reference's
  `moe_routed_shardmap` at atol 1e-5.

The ranks import this module, so it imports jax and the reference lazily,
inside the tests that compare against them.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh, spawn_ranks
from repro_torch.models import ffn as F
from repro_torch.models import transformer as tf
from repro_torch.models.moe_shardmap import moe_routed_shardmap, shardmap_supported
from repro_torch.sharding.ctx import model_mesh
from repro_torch.sharding.specs import PartitionSpec as P
from repro_torch.sharding.specs import distribute, named_shardings
from repro_torch.utils import tree_leaves, tree_map

torch.set_num_threads(1)

B, T, DECODE = 4, 16, 2
LR = 0.5
# model-mesh runs against one device: the relative L2 gap stays within
# BOUND x the 1-ulp control's gap (measured: 0.61x to 0.87x on the cases)
BOUND = 2.0


def qwen_cfg():
    return dataclasses.replace(smoke_config("qwen3-0.6b"), use_flash=True)


@functools.lru_cache(maxsize=None)
def lm_inputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (B, T + DECODE + 1)).astype(np.int64)
    return toks


def _full(tree):
    return tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t)
                    .detach().numpy().copy(), tree)


def lm_steps(cfg, params, chain2, mesh=None):
    """Train round (C = 1), prefill, decode; with `chain2`, Fed-CHS and HFL
    rounds over two chains (the second from `chain2`).  On `mesh` the
    inputs are laid out by `steps.place`."""
    toks = torch.from_numpy(lm_inputs())
    batch = {"tokens": toks[:, :T], "labels": toks[:, 1:T + 1]}
    prompt = {"tokens": toks[:, :T]}
    caches = tf.init_caches(cfg, B, T + DECODE, device="cpu")
    on = mesh is not None
    out = {}
    with (model_mesh(mesh) if on else contextlib.nullcontext()), \
            (steps._replicating() if on else contextlib.nullcontext()):
        if not on or "pod" not in mesh.axis_names:
            stacked = tree_map(lambda t: t[None], params)
            b1 = {k: v[None] for k, v in batch.items()}
            if on:
                stacked, b1 = steps.place(cfg, mesh, stacked, b1, chains=1)
            new, loss = steps.make_train_round(cfg)(stacked, b1, LR)
            out["train"] = (_full(new), float(_full(loss)))
        # serving on every mesh, the batch split over (pod, data)
        pp, pr, cc = (params, prompt, caches) if not on else steps.place(
            cfg, mesh, params, prompt, caches)
        out["prefill"] = _full(steps.make_prefill_step(cfg)(pp, pr))
        logits = []
        for i in range(DECODE):
            tok = {"t": toks[:, T + i:T + i + 1]}
            tok = (tok if not on else steps.place(cfg, mesh, batch=tok))["t"]
            lg, cc = tf.decode_step(cfg, pp, cc, tok)
            logits.append(_full(lg))
        out["decode"] = np.stack(logits)
        if chain2 is not None and (not on or "pod" in mesh.axis_names):
            for variant in ("fedchs", "hfl"):
                stacked2 = tree_map(lambda a, b: torch.stack([a, b]), params, chain2)
                batch2 = {k: v.reshape(2, B // 2, T) for k, v in batch.items()}
                if on:
                    stacked2, batch2 = steps.place(cfg, mesh, stacked2, batch2, chains=2)
                new, loss = steps.make_train_round(cfg, variant=variant)(stacked2, batch2, LR)
                out[variant] = (_full(new), float(_full(loss)))
    return out


def mqa_cfg():
    """One kv head: over "model" the caches split their sequence axis."""
    return dataclasses.replace(qwen_cfg(), num_kv_heads=1)


def seq_split_decode(params, mesh=None):
    """DECODE + 2 decode steps against sequence-split caches on `mesh`."""
    cfg, toks = mqa_cfg(), torch.from_numpy(lm_inputs())
    caches = tf.init_caches(cfg, B, DECODE + 2, device="cpu")  # both halves written
    pp, cc = (params, caches) if mesh is None else steps.place(cfg, mesh, params, caches=caches)
    logits = []
    with model_mesh(mesh), steps._replicating():
        for i in range(DECODE + 2):
            tok = {"t": toks[:, i:i + 1]}
            tok = (tok if mesh is None else steps.place(cfg, mesh, batch=tok))["t"]
            lg, cc = tf.decode_step(cfg, pp, cc, tok)
            logits.append(_full(lg))
    return np.stack(logits)


def moe_setup():
    cfg = smoke_config("dbrx-132b")  # 4 experts top-2, no shared experts
    rng = np.random.default_rng(3)
    p = {"router": rng.normal(size=(cfg.d_model, 4)).astype(np.float32) / 16,
         "w_gate": rng.normal(size=(4, cfg.d_model, cfg.d_ff)).astype(np.float32) / 16,
         "w_in": rng.normal(size=(4, cfg.d_model, cfg.d_ff)).astype(np.float32) / 16,
         "w_out": rng.normal(size=(4, cfg.d_ff, cfg.d_model)).astype(np.float32) / 22.6}
    x = (rng.normal(size=(2, 8, cfg.d_model)) * 0.3).astype(np.float32)
    return cfg, p, x


def moe_loss(y, aux):
    return (y * y).mean() + aux


def moe_case(mesh):
    cfg, p, x = moe_setup()
    specs = {"router": P(), "w_gate": P("model"), "w_in": P("model"), "w_out": P("model")}
    dp = distribute({k: torch.from_numpy(v) for k, v in p.items()}, named_shardings(mesh, specs))
    dx = distribute(torch.from_numpy(x), named_shardings(mesh, P("data")))
    dp = tree_map(lambda t: t.detach().requires_grad_(), dp)
    y, aux = moe_routed_shardmap(cfg, dp, dx, mesh)
    grads = torch.autograd.grad(moe_loss(y, aux), [dp["router"], dp["w_out"], dp["w_gate"]])
    return _full(y), float(_full(aux)), [_full(g) for g in grads]


def rank_cases(rank):
    cfg = qwen_cfg()
    params = tf.init_params(cfg, 0, "cpu")
    chain2 = tf.init_params(cfg, 1, "cpu")
    mesh22 = make_debug_mesh(2, 2, device="cpu")
    res = {"lm22": lm_steps(cfg, params, None, mesh22), "moe22": moe_case(mesh22),
           "seq_split": {"decode": seq_split_decode(tf.init_params(mqa_cfg(), 0, "cpu"),
                                                    mesh22)}}
    res["lm_pod"] = lm_steps(cfg, params, chain2, make_debug_mesh(1, 2, pod=2, device="cpu"))
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(rank_cases, 4, threads=1, tmp_dir=str(tmp_path_factory.mktemp("mm")))


@pytest.fixture(scope="module")
def single():
    cfg = qwen_cfg()
    params = tf.init_params(cfg, 0, "cpu")
    chain2 = tf.init_params(cfg, 1, "cpu")
    ulp = tree_map(lambda t: torch.nextafter(t, torch.full_like(t, np.inf)), params)
    ulp2 = tree_map(lambda t: torch.nextafter(t, torch.full_like(t, np.inf)), chain2)
    mqa = tf.init_params(mqa_cfg(), 0, "cpu")
    mqa_ulp = tree_map(lambda t: torch.nextafter(t, torch.full_like(t, np.inf)), mqa)
    return ({**lm_steps(cfg, params, chain2), "seq_split": seq_split_decode(mqa)},
            {**lm_steps(cfg, ulp, ulp2), "seq_split": seq_split_decode(mqa_ulp)})


def _rel(a, b) -> float:
    a = np.concatenate([np.ravel(x) for x in tree_leaves(a)])
    b = np.concatenate([np.ravel(x) for x in tree_leaves(b)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_ranks_hold_the_same_whole_results(ranks):
    for r in ranks[1:]:
        for case in ("lm22", "lm_pod", "seq_split"):
            for k, v in r[case].items():
                assert _rel(v, ranks[0][case][k]) == 0.0, (case, k)


@pytest.mark.parametrize("case,step", [("lm22", "train"), ("lm22", "prefill"),
                                       ("lm22", "decode"), ("lm_pod", "fedchs"),
                                       ("lm_pod", "hfl"), ("lm_pod", "prefill"),
                                       ("lm_pod", "decode"), ("seq_split", "decode")])
def test_model_mesh_step_against_one_device(ranks, single, case, step):
    ref, ulp = single
    key = "seq_split" if case == "seq_split" else step
    got = ranks[0][case][step]
    gap, control = _rel(got, ref[key]), _rel(ulp[key], ref[key])
    assert control > 0
    print(f"{case} {step}: gap {gap:.3e}, 1-ulp control {control:.3e}, {gap / control:.2f}x")
    assert gap <= BOUND * control, (gap, control)
    if isinstance(got, tuple):  # a train round's loss
        assert got[1] == pytest.approx(ref[key][1], rel=1e-5)


def test_unrolled_chains_are_rejected(ranks, single):
    """The control the bound must reject: the Fed-CHS round with the chains
    not passed on."""
    ref, ulp = single
    new, _ = ref["fedchs"]
    unrolled = tree_map(lambda a: np.roll(a, -1, axis=0), new)
    control = _rel(ulp["fedchs"], ref["fedchs"])
    assert _rel(ranks[0]["lm_pod"]["fedchs"][0], unrolled) > BOUND * control


def test_moe_shardmap_on_2x2_matches_reference_grouped_oracle(ranks):
    import jax.numpy as jnp

    from repro.models import ffn as RF

    cfg, p, x = moe_setup()
    ref_cfg = dataclasses.replace(_ref_cfg("dbrx-132b"), moe_groups=2)
    y_ref, aux_ref = RF.moe_forward(ref_cfg, {k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x))
    y, aux, _ = ranks[0]["moe22"]
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=1e-5)
    assert aux * cfg.router_aux_coef == pytest.approx(float(aux_ref), rel=1e-5)


def test_moe_shardmap_gradients_match_the_one_device_oracle(ranks):
    cfg, p, x = moe_setup()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    y, aux = F.moe_forward(dataclasses.replace(cfg, moe_groups=2), tp, torch.from_numpy(x))
    grads = torch.autograd.grad(moe_loss(y, aux / cfg.router_aux_coef),
                                [tp["router"], tp["w_out"], tp["w_gate"]])
    for got, want in zip(ranks[0]["moe22"][2], grads):
        assert np.abs(want.numpy()).max() > 0  # w_out and the router get a gradient
        # summed over ranks in another order: 1e-5 of the leaf's largest entry
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4,
                                   atol=1e-5 * np.abs(want.numpy()).max())


def _ref_cfg(arch):
    from repro.configs.registry import smoke_config as ref_smoke

    return ref_smoke(arch)


def test_moe_shardmap_on_1x1_matches_reference():
    import jax.numpy as jnp

    from repro.launch.mesh import make_debug_mesh as ref_mesh
    from repro.models.moe_shardmap import moe_routed_shardmap as ref_msm

    cfg, p, x = moe_setup()
    mesh = make_debug_mesh(1, 1, device="cpu")
    assert shardmap_supported(cfg, mesh, 2)
    y, aux = moe_routed_shardmap(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, mesh=mesh,
                                 x=torch.from_numpy(x))
    y_ref, aux_ref = ref_msm(_ref_cfg("dbrx-132b"), {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), ref_mesh(1, 1))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5)
    # and the flag routes moe_forward through it, bit for bit
    with model_mesh(mesh):
        y2, _ = F.moe_forward(dataclasses.replace(cfg, moe_shardmap=True),
                              {k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    assert torch.equal(y2, y)
