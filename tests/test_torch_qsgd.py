"""The port's QSGD (dither, quantize->pack, unpack->dequantize, the dense
codes, tree wrappers, channel sizes) against the reference package.

The reference's Pallas kernels run as its own tests run them on the CPU, in
interpret mode; its `kernels.ops` routes to the jnp oracle.

Inputs are dyadic where bit equality is asserted: entries k * 2^-8 with
integer |k| <= 64 make every partial sum of squares exact in f32, so every
block norm is the same in any summation order and codes, payloads and norms
must agree bit for bit.  On Gaussian inputs the norms may differ in the
last place between summation orders, so a code on a floor boundary may
differ by one: norms are held at rtol 1e-6, codes to |diff| <= 1 on at most
0.1% of entries and equal elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.channels import QSGDChannel as JaxQSGDChannel
from repro.comm.channels import channel_wire_bits as jax_channel_wire_bits
from repro.core.engine import compress_uplinks as jax_compress_uplinks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.qsgd import (
    qsgd_dequantize_blocks,
    qsgd_quantize_blocks,
    qsgd_quantize_pack_blocks,
    qsgd_unpack_dequantize_blocks,
)
from repro_torch import comm
from repro_torch.comm.channels import DenseChannel, QSGDChannel, channel_wire_bits
from repro_torch.core.engine import compress_uplinks
from repro_torch.kernels import ops, qsgd, ref

torch.set_num_threads(1)

LEVELS = [1, 3, 7, 15, 16, 127]
BLOCKS = [128, 1024]


def dyadic(rng, shape):
    return (rng.integers(-64, 65, size=shape) * 2.0**-8).astype(np.float32)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def key_words(seed: int) -> np.ndarray:
    return np.asarray(jax.random.PRNGKey(seed))


def mlp_tree(rng, fn=dyadic):
    """Leaf shapes of the Appendix-A MNIST MLP (tails at every block size)."""
    shapes = {"fc1": {"b": (200,), "w": (784, 200)}, "fc2": {"b": (200,), "w": (200, 200)},
              "out": {"b": (10,), "w": (200, 10)}}
    return {k: {n: fn(rng, s) for n, s in v.items()} for k, v in shapes.items()}


def to_torch(tree):
    return {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in tree.items()}


@pytest.mark.parametrize("shape", [(7,), (4, 1024), (3, 333), (2, 2, 65)])
@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_cheap_uniform_bit_exact(seed, shape):
    key = key_words(seed)
    want = np.asarray(jops._cheap_uniform(jnp.asarray(key), shape))
    got = ops._cheap_uniform(key, shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("s", LEVELS)
def test_quantize_pack_bit_exact_on_dyadic_inputs(s, block):
    rng = np.random.default_rng(s * 7 + block)
    nb = 5
    v = dyadic(rng, (nb, block))
    v[2] = 0.0  # a zero-norm row
    key = key_words(s + block)
    u = jops._cheap_uniform(jnp.asarray(key), (nb, block))
    want_payload, want_norms = qsgd_quantize_pack_blocks(jnp.asarray(v), u, s=s)
    codes, _ = jref.qsgd_quantize_codes_ref(jnp.asarray(v), u, s)
    oracle = jref.pack_codes_ref(codes, jref.qsgd_code_bits(s))
    np.testing.assert_array_equal(np.asarray(want_payload), np.asarray(oracle))

    keys = torch.from_numpy(key[None].copy().view(np.int32))
    payload, norms = qsgd.qsgd_quantize_pack(torch.from_numpy(v)[None], keys, s)
    np.testing.assert_array_equal(u32(payload[0]), np.asarray(want_payload))
    np.testing.assert_array_equal(norms[0].numpy(), np.asarray(want_norms))
    # the port's naive layout oracle agrees with its vectorized pack
    u_t = ops._cheap_uniform(key, (nb, block))
    t_codes, _ = ref.qsgd_quantize_codes_ref(torch.from_numpy(v), u_t, s)
    np.testing.assert_array_equal(u32(ref.pack_codes_ref(t_codes, ref.qsgd_code_bits(s))),
                                  np.asarray(oracle))
    np.testing.assert_array_equal(ref.unpack_codes_ref(payload[0], ref.qsgd_code_bits(s)),
                                  t_codes.numpy())

    want_v = qsgd_unpack_dequantize_blocks(want_payload, want_norms, s=s, block=block)
    got_v = qsgd.qsgd_unpack_dequantize(payload[0], norms[0], s, block)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6, atol=0)


@pytest.mark.parametrize("s", [3, 16])
def test_quantize_pack_on_gaussian_inputs(s):
    rng = np.random.default_rng(s)
    block, nb = 1024, 64
    v = rng.normal(size=(nb, block)).astype(np.float32)
    key = key_words(11)
    u = jops._cheap_uniform(jnp.asarray(key), (nb, block))
    want_codes, want_norms = jref.qsgd_quantize_codes_ref(jnp.asarray(v), u, s)
    keys = torch.from_numpy(key[None].copy().view(np.int32))
    payload, norms = qsgd.qsgd_quantize_pack(torch.from_numpy(v)[None], keys, s)
    np.testing.assert_allclose(norms[0].numpy(), np.asarray(want_norms), rtol=1e-6)
    codes = ref.unpack_codes_ref(payload[0], ref.qsgd_code_bits(s)).numpy()
    diff = np.abs(codes - np.asarray(want_codes).astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("s", [1, 16, 127])
def test_encode_decode_tree_match_reference(s):
    rng = np.random.default_rng(s)
    tree = mlp_tree(rng)
    key = key_words(42)
    want = jops.qsgd_encode_tree(jax.tree.map(jnp.asarray, tree), jnp.asarray(key), s=s)
    got = QSGDChannel(s).encode(to_torch(tree), key)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g["payload"]), np.asarray(w["payload"]))
        np.testing.assert_array_equal(g["norms"].numpy(), np.asarray(w["norms"]))
    like = jax.tree.map(jnp.asarray, tree)
    want_tree = jops.qsgd_decode_tree(want, like, s=s)
    got_tree = QSGDChannel(s).decode(got, to_torch(tree))
    for k in tree:
        for n in tree[k]:
            np.testing.assert_allclose(got_tree[k][n].numpy(), np.asarray(want_tree[k][n]),
                                       rtol=1e-6, atol=0)


def test_compress_uplinks_matches_reference():
    """A stacked uplink: sender i keyed with fold_in(sub, i), per-leaf split."""
    rng = np.random.default_rng(3)
    n = 3
    tree = mlp_tree(rng, fn=lambda r, s: dyadic(r, (n,) + s))
    sub = key_words(9)
    want = jax_compress_uplinks(JaxQSGDChannel(16), jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(sub))
    got = compress_uplinks(QSGDChannel(16), to_torch(tree), sub)
    for k in tree:
        for name in tree[k]:
            np.testing.assert_array_equal(got[k][name].numpy(), np.asarray(want[k][name]))


@pytest.mark.parametrize("levels", LEVELS)
def test_channel_bits_exact(levels):
    leaf_sizes = (200, 156800, 200, 40000, 10, 2000)
    for block in BLOCKS:
        ch, jch = QSGDChannel(levels, block), JaxQSGDChannel(levels, block)
        assert ch.wire_bits(leaf_sizes) == jch.wire_bits(leaf_sizes)
        assert ch.message_bits(sum(leaf_sizes)) == jch.message_bits(sum(leaf_sizes))
        assert channel_wire_bits(ch, sum(leaf_sizes), leaf_sizes) == \
            jax_channel_wire_bits(jch, sum(leaf_sizes), leaf_sizes)
    assert channel_wire_bits(DenseChannel(), 1234, (1000, 234)) == 1234 * 32


def test_channel_rejects_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):
        QSGDChannel(128)
    with pytest.raises(ValueError):
        QSGDChannel(16, block=100)
    with pytest.raises(ValueError):
        qsgd.qsgd_quantize_pack(torch.zeros(1, 1, 8192), torch.zeros(1, 2, dtype=torch.int32), 16)


@pytest.mark.parametrize("shape", [(7,), (3, 1024), (5000,), (2, 3, 700)])
@pytest.mark.parametrize("s", [1, 16, 127])
def test_dense_codes_bit_exact_on_dyadic_inputs(s, shape):
    """`qsgd_quantize` pads to tiles of 8 blocks and keeps the padded rows;
    codes and norms equal the reference's bit for bit.  Dequantized values
    and the roundtrip at the same key agree to rtol 1e-6: the port divides
    norm / s correctly rounded, as the CUDA kernel does, while XLA's jit of
    the reference rewrites the division by the constant s (at s = 3 its
    result differs from the correctly rounded one in the last place at
    about a quarter of the entries)."""
    rng = np.random.default_rng(s + len(shape))
    v = dyadic(rng, shape)
    key = key_words(s * 3 + 1)
    jq, jnorms, jn = jops.qsgd_quantize(jnp.asarray(v), jnp.asarray(key), s=s)
    q, norms, n = comm.qsgd_quantize(torch.from_numpy(v), key, s=s)
    assert n == jn and q.dtype == torch.int8 and q.shape == jq.shape
    assert q.shape[0] % 8 == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(norms.numpy(), np.asarray(jnorms))
    want = jops.qsgd_dequantize(jq, jnorms, s=s, shape=shape)
    got = comm.qsgd_dequantize(q, norms, s=s, shape=shape)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        comm.qsgd_roundtrip(torch.from_numpy(v), key, s=s).numpy(),
        np.asarray(jops.qsgd_roundtrip(jnp.asarray(v), jnp.asarray(key), s=s)),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("s", [3, 16])
def test_dense_code_plain_versions_match_the_pallas_kernels(s):
    """The plain versions against the reference's Pallas kernels, run in
    interpret mode, with the dither of the same key (dequantized values to
    rtol 1e-6, for the reason above)."""
    rng = np.random.default_rng(s)
    v = dyadic(rng, (16, 128))
    v[3] = 0.0
    key = key_words(s)
    u = jops._cheap_uniform(jnp.asarray(key), v.shape)
    jq, jnorms = qsgd_quantize_blocks(jnp.asarray(v), u, s=s)
    q, norms = qsgd.qsgd_quantize_blocks(torch.from_numpy(v),
                                         torch.from_numpy(key.view(np.int32).copy()), s)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(norms.numpy(), np.asarray(jnorms))
    np.testing.assert_allclose(qsgd.qsgd_dequantize_blocks(q, norms, s).numpy(),
                               np.asarray(qsgd_dequantize_blocks(jq, jnorms, s=s)),
                               rtol=1e-6, atol=0)
