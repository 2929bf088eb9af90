"""The port's tree helpers flatten like `jax.tree.flatten`, lists included.

A message's per-leaf QSGD keys (`split(key, n_leaves)`) and its ledger
price (per-leaf packed blocks) depend on the number and order of leaves,
so the LM's params, whose "super" and "tail" entries are lists, must
flatten to the reference's leaves exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.comm.channels import QSGDChannel as JaxQSGDChannel
from repro.comm.channels import channel_wire_bits as jax_channel_wire_bits
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro_torch.comm.channels import QSGDChannel, channel_wire_bits
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.weights import params_from_jax


@pytest.fixture(scope="module")
def lm_trees():
    jparams = jtf.init_params(jax_smoke_config("qwen3-0.6b"), jax.random.PRNGKey(0))
    return jparams, tf.init_params(smoke_config("qwen3-0.6b"), 0, "cpu")


def test_lm_leaves_match_reference(lm_trees):
    jparams, params = lm_trees
    jleaves, leaves = jax.tree.leaves(jparams), tree_leaves(params)
    assert len(leaves) == len(jleaves) == 14
    assert [tuple(t.shape) for t in leaves] == [a.shape for a in jleaves]
    jpaths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    assert jpaths[:3] == ["['embed']", "['final_norm']", "['lm_head']"]
    assert jpaths[3] == "['super'][0]['attn']['k_norm']"


def test_qwen3_full_width_leaf_sizes():
    """The full-width qwen3-0.6b message: 14 leaves, layers stacked."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b"), dtype="float32")
    assert dataclasses.asdict(get_config("qwen3-0.6b")) == dataclasses.asdict(
        jax_get_config("qwen3-0.6b"))
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k), jax.random.PRNGKey(0))
    sizes = [int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)]
    assert len(sizes) == 14 and sum(sizes) == 751_632_384
    assert channel_wire_bits(QSGDChannel(16), sum(sizes), sizes) == jax_channel_wire_bits(
        JaxQSGDChannel(16), sum(sizes), sizes)


@pytest.mark.parametrize("levels", [1, 16, 127])
def test_wire_bits_of_the_lm_message_match_reference(lm_trees, levels):
    jparams, params = lm_trees
    sizes = [t.numel() for t in tree_leaves(params)]
    jsizes = [a.size for a in jax.tree.leaves(jparams)]
    assert sizes == jsizes
    assert channel_wire_bits(QSGDChannel(levels), sum(sizes), sizes) == \
        jax_channel_wire_bits(JaxQSGDChannel(levels), sum(jsizes), jsizes)


def test_params_from_jax_round_trips_lists(lm_trees):
    jparams, _ = lm_trees
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert isinstance(params["super"], list) and params["tail"] == []
    for a, t in zip(jax.tree.leaves(jparams), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    back = tree_map(lambda t: t.numpy(), params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)


@pytest.mark.parametrize("tree", [
    {"b": [torch.zeros(1), {"y": torch.zeros(2), "x": torch.zeros(3)}], "a": (), "c": []},
    [torch.zeros(1), (torch.zeros(2), [torch.zeros(3)])],
    {"z": torch.zeros(1), "a": {"k": [], "j": torch.zeros(2)}},
])
def test_flatten_order_and_rebuild_match_jax(tree):
    leaves, treedef = tree_flatten(tree)
    np_tree = tree_map(lambda t: t.numpy(), tree)
    jleaves = jax.tree.leaves(np_tree)
    assert [t.numel() for t in leaves] == [a.size for a in jleaves]
    rebuilt = tree_unflatten(treedef, leaves)
    assert jax.tree.structure(tree_map(lambda t: t.numpy(), rebuilt)) == \
        jax.tree.structure(np_tree)
