"""The port's Sign-SGD, Top-K, bf16 dense-wire and low-bit channels against
the reference package, on the same seeded numpy inputs.

Integer results are held exactly: sign payloads, QSGD payloads, Top-K
selections, wire sizes.  Sign-SGD scales are the mean |v| of a block: exact
on dyadic inputs (entries k * 2^-8, |k| <= 64, whose sums are exact in any
order), at rtol 1e-6 on Gaussian ones, where torch and XLA sum in other
orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import channels as jch
from repro.kernels import ops as jops
from repro_torch.comm import channels as tch
from repro_torch.utils import tree_leaves

torch.set_num_threads(1)

LEAF_SHAPES = {"a": (3, 700), "b": (1500,), "c": (5,)}  # tails: 1 and several blocks


def dyadic(rng, shape):
    return (rng.integers(-64, 65, size=shape) * 2.0**-8).astype(np.float32)


def gaussian(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def make_tree(kind, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    draw = dyadic if kind == "dyadic" else gaussian
    tree = {k: draw(rng, lead + s) for k, s in LEAF_SHAPES.items()}
    tree["z"] = np.zeros(lead + (40,), np.float32)  # an all-zero leaf
    return tree


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def words(payload):
    """Payload words as uint32 from either side."""
    if isinstance(payload, torch.Tensor):
        return payload.numpy().view(np.uint32)
    return np.asarray(payload)


@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
@pytest.mark.parametrize("block", [32, 1024])
def test_signsgd_encode_matches_reference(kind, block):
    tree = make_tree(kind, seed=1)
    tree["a"][0, :3] = [-0.0, 0.0, -1e-30]  # -0.0 maps to code 1 on both sides
    jw = jch.SignSGDChannel(block).encode(to_jax(tree))
    tw = tch.SignSGDChannel(block).encode(to_torch(tree))
    rtol = 0 if kind == "dyadic" else 1e-6
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(words(t["payload"]), words(j["payload"]))
        np.testing.assert_allclose(t["norms"].numpy(), np.asarray(j["norms"]), rtol=rtol, atol=0)
    assert not np.asarray(jw[-1]["norms"]).any() and not tw[-1]["norms"].any()


@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
def test_signsgd_compress_with_senders_matches_reference(kind):
    """A stacked uplink of 3 senders in one pass against the reference's
    per-message vmap; the all-zero leaf decodes to exact zeros."""
    tree = make_tree(kind, seed=2, lead=(3,))
    tree["b"][1] = 0.0  # one sender's leaf all zero
    want = jax.vmap(lambda t: jops.signsgd_compress_tree(t, block=128))(to_jax(tree))
    got = tch.SignSGDChannel(128).compress(to_torch(tree), np.zeros((3, 2), np.uint32))
    rtol = 0 if kind == "dyadic" else 1e-6
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=0)
    assert not got["z"].any() and not got["b"][1].any()
    wires = tch.SignSGDChannel(128).encode(to_torch(tree), np.zeros((3, 2), np.uint32))
    assert tuple(wires[0]["payload"].shape) == (3, 17, 4)  # ceil(2100 / 128) blocks


def test_signsgd_wire_bits_are_the_payload():
    tree = to_torch(make_tree("gaussian"))
    ch = tch.SignSGDChannel()
    sizes = [t.numel() for t in tree_leaves(tree)]
    got = sum(32 * (w["payload"].numel() + w["norms"].numel()) for w in ch.encode(tree))
    assert got == ch.wire_bits(sizes) == jch.SignSGDChannel().wire_bits(sizes)
    assert ch.message_bits(5000) == jch.SignSGDChannel().message_bits(5000)


@pytest.mark.parametrize("fraction", [0.01, 0.05, 0.5, 1.0])
def test_topk_matches_reference(fraction):
    tree = make_tree("gaussian", seed=3)
    want = jops.topk_sparsify_tree(to_jax(tree), fraction=fraction)
    got = tch.TopKChannel(fraction).compress(to_torch(tree))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert np.array_equal(np.signbit(got[k].numpy()), np.signbit(np.asarray(want[k])))


def test_topk_ties_keep_the_lower_index():
    """Dyadic entries repeat magnitudes: many ties sit at the k-th, and
    `jax.lax.top_k` keeps the lower index among equals."""
    tree = make_tree("dyadic", seed=4)
    flat = np.concatenate([v.ravel() for v in tree.values()])
    k = int(np.ceil(0.05 * flat.size))
    kth = np.sort(np.abs(flat))[::-1][k - 1]
    assert (np.abs(flat) > kth).sum() < k < (np.abs(flat) >= kth).sum()  # a tie at the k-th
    want = jops.topk_sparsify_tree(to_jax(tree), fraction=0.05)
    got = tch.TopKChannel(0.05).compress(to_torch(tree))
    for key in tree:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert sum(int((g != 0).sum()) for g in got.values()) <= k


def test_topk_selects_per_sender():
    """Each sender's message is selected on its own, as the reference's
    per-message vmap does."""
    tree = make_tree("dyadic", seed=5, lead=(4,))
    want = jax.vmap(lambda t: jops.topk_sparsify_tree(t, fraction=0.1))(to_jax(tree))
    got = tch.TopKChannel(0.1).compress(to_torch(tree), np.zeros((4, 2), np.uint32))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_topk_prices_by_the_flat_formula():
    ch, jc = tch.TopKChannel(0.05), jch.TopKChannel(0.05)
    assert tch.channel_wire_bits(ch, 6000, (1000, 5000)) == jc.message_bits(6000)
    assert jch.channel_wire_bits(jc, 6000, (1000, 5000)) == ch.message_bits(6000)


@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
def test_dense_wire_dtype_matches_reference(wire):
    tree = make_tree("gaussian", seed=6)
    tree["a"][0, :2] = [1e-40, 3.0e38]  # a subnormal and a value near f32's top
    jc, tc = jch.DenseChannel(wire_dtype=wire), tch.DenseChannel(wire_dtype=wire)
    want = jc.compress(to_jax(tree), None)
    got = tc.compress(to_torch(tree))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].dtype == torch.float32
    wires = tc.encode(to_torch(tree))
    assert all(w["payload"].dtype == getattr(torch, wire) for w in wires)
    back = tc.decode(wires, to_torch(tree))
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), got[k].numpy())
    sizes = [v.size for v in tree.values()]
    assert tc.bits_per_param == jc.bits_per_param == 16
    assert tc.wire_bits(sizes) == jc.wire_bits(sizes) == 16 * sum(sizes)
    assert tc.message_bits(sum(sizes)) == jc.message_bits(sum(sizes))


def test_dense_default_is_the_identity():
    tree = to_torch(make_tree("gaussian", seed=7))
    assert tch.DenseChannel().compress(tree) is tree
    wires = tch.DenseChannel().encode(tree)
    assert all(w["payload"].dtype == torch.float32 for w in wires)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_low_bit_channel_matches_reference(bits):
    jc, tc = jch.low_bit_channel(bits), tch.low_bit_channel(bits)
    assert type(tc).__name__ == type(jc).__name__
    assert tc.stochastic == jc.stochastic and tc.per_message == jc.per_message
    tree = make_tree("dyadic", seed=8 + bits)
    sizes = [v.size for v in tree.values()]
    assert tc.wire_bits(sizes) == jc.wire_bits(sizes)
    key = np.asarray(jax.random.PRNGKey(bits), np.uint32)
    jw = jc.encode(to_jax(tree), jnp.asarray(key))
    tw = tc.encode(to_torch(tree), key)
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(words(t["payload"]), words(j["payload"]))
        np.testing.assert_array_equal(t["norms"].numpy(), np.asarray(j["norms"]))
    assert sum(32 * (w["payload"].numel() + w["norms"].numel()) for w in tw) == tc.wire_bits(sizes)
    if bits > 1:
        assert tc.levels == jc.levels


def test_low_bit_channel_rejects_other_widths():
    with pytest.raises(ValueError, match="3-bit"):
        tch.low_bit_channel(3)


def test_new_channels_are_exported():
    from repro_torch import comm

    for name in ("SignSGDChannel", "TopKChannel", "low_bit_channel", "signsgd_message_bits",
                 "topk_message_bits"):
        assert hasattr(comm, name)
