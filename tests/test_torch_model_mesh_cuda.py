"""The model mesh on the card (skipped without one; imports no jax): 2
gloo ranks share the card on a (1, 2) mesh, split over "model".  Smoke
qwen3-0.6b (f32, flash) prefills and takes a train round there; the
logits and the new params stay within MESH_BOUND of one card's run beside
the 1-ulp control, each rank launches the flash kernel once a layer on
its local heads in the prefill (twice in the round: forward and the remat
recompute), and gloo's all-gathers of CUDA tensors go through the list
form (`launch.mesh`)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import build
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh, spawn_ranks
from repro_torch.models import transformer as tf
from repro_torch.sharding.ctx import model_mesh
from repro_torch.utils import tree_leaves, tree_map

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="runs the flash kernel on a CUDA device")
MESH_BOUND = 2.0


def cfg():
    return dataclasses.replace(smoke_config("qwen3-0.6b"), use_flash=True)


def inputs():
    toks = np.random.default_rng(0).integers(0, 512, (2, 33))
    return torch.from_numpy(toks).to("cuda")


def run_steps(params, mesh=None):
    c, toks = cfg(), inputs()
    batch = {"tokens": toks[:, :32][None], "labels": toks[:, 1:][None]}
    stacked = tree_map(lambda t: t[None], params)
    prompt = {"tokens": toks[:, :32]}
    if mesh is not None:
        stacked, batch = steps.place(c, mesh, stacked, batch, chains=1)
        params, prompt = steps.place(c, mesh, params, prompt)
    with model_mesh(mesh), steps._replicating():
        logits = steps.make_prefill_step(c)(params, prompt)
        new, _ = steps.make_train_round(c)(stacked, batch, 0.5)
    full = [t.full_tensor() if hasattr(t, "full_tensor") else t for t in tree_leaves(new)]
    logits = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
    return logits.float().cpu(), torch.cat([t.reshape(-1) for t in full]).float().cpu()


def rank_fn(rank):
    torch.cuda.set_device(0)
    mesh = make_debug_mesh(1, 2)
    build.reset_launches()
    logits, new = run_steps(tf.init_params(cfg(), 0, "cuda"), mesh)
    return logits, new, dict(build.LAUNCHES)


@needs_card
def test_model_mesh_on_the_card(tmp_path):
    ranks = spawn_ranks(rank_fn, 2, tmp_dir=str(tmp_path))
    params = tf.init_params(cfg(), 0, "cuda")
    ref = run_steps(params)
    ulp = run_steps(tree_map(lambda t: torch.nextafter(t, torch.full_like(t, np.inf)), params))
    for got, want, control in zip(ranks[0][:2], ref, ulp):
        gap = float((got - want).norm() / want.norm())
        ctl = float((control - want).norm() / want.norm())
        assert 0 < ctl and gap <= MESH_BOUND * ctl, (gap, ctl)
    n_layers = cfg().num_layers
    for r in ranks:
        assert r[2].get("flash_attention", 0) == 3 * n_layers
