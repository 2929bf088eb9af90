"""The port's QSGD kernels on the card against their plain torch versions.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_qsgd_cuda.py``.
Without a CUDA device every case skips.  Dyadic inputs (entries k * 2^-8,
|k| <= 64) make block norms exact in any summation order, so payloads,
norms and dequantized values must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import qsgd

torch.set_num_threads(1)

LEVELS = [1, 3, 7, 15, 16, 63, 127]
BLOCKS = [32, 96, 128, 1024, 4096]  # W = block / 32 = 1, 3, 4, 32, 128


def dyadic(rng, shape):
    return (rng.integers(-64, 65, size=shape) * 2.0**-8).astype(np.float32)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("s", LEVELS)
def test_cuda_kernels_match_plain_versions(s):
    rng = np.random.default_rng(s)
    for block in BLOCKS:
        for nb in (1, 7, 300):
            v = dyadic(rng, (3, nb, block))
            v[1, 0] = 0.0
            keys = torch.from_numpy(rng.integers(0, 2**32, size=(3, 2), dtype=np.uint32)
                                    .view(np.int32))
            payload, norms = qsgd.qsgd_quantize_pack_plain(torch.from_numpy(v), keys, s)
            cv, ck = torch.from_numpy(v).cuda(), keys.cuda()
            c_payload, c_norms = qsgd.qsgd_quantize_pack(cv, ck, s)
            torch.cuda.synchronize()
            assert torch.equal(c_payload.cpu(), payload)
            assert torch.equal(c_norms.cpu(), norms)
            rows = payload.reshape(-1, payload.shape[-1])
            out = qsgd.qsgd_unpack_dequantize_plain(rows, norms.reshape(-1), s, block)
            c_out = qsgd.qsgd_unpack_dequantize(c_payload.reshape(rows.shape),
                                                c_norms.reshape(-1), s, block)
            torch.cuda.synchronize()
            assert torch.equal(c_out.cpu(), out)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("s", LEVELS)
def test_cuda_dense_code_kernels_match_plain_versions(s):
    rng = np.random.default_rng(100 + s)
    for block in BLOCKS:
        for nb in (1, 8, 300):
            v = dyadic(rng, (nb, block))
            v[0] = 0.0
            key = torch.from_numpy(rng.integers(0, 2**32, size=2, dtype=np.uint32)
                                   .view(np.int32))
            q, norms = qsgd.qsgd_quantize_blocks_plain(torch.from_numpy(v), key, s)
            c_q, c_norms = qsgd.qsgd_quantize_blocks(torch.from_numpy(v).cuda(), key.cuda(), s)
            torch.cuda.synchronize()
            assert torch.equal(c_q.cpu(), q)
            assert torch.equal(c_norms.cpu(), norms)
            out = qsgd.qsgd_dequantize_blocks_plain(q, norms, s)
            c_out = qsgd.qsgd_dequantize_blocks(c_q, c_norms, s)
            torch.cuda.synchronize()
            assert torch.equal(c_out.cpu(), out)


def _gaussian_wire(gen, s, block, rows):
    """Payload and norms of `rows` Gaussian blocks packed on the card; row 0
    has norm 0."""
    v = torch.randn((1, rows, block), generator=gen).cuda()
    v[0, 0] = 0.0
    keys = torch.randint(-2**31, 2**31, (1, 2), generator=gen, dtype=torch.int64)
    payload, norms = qsgd.qsgd_quantize_pack(v, keys.to(torch.int32).cuda(), s)
    return payload[0], norms[0]


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("s", LEVELS)
def test_cuda_unpack_dequantize_matches_plain_on_gaussian_inputs(s):
    """Decoding sums nothing, so the kernel is bit-equal to its plain version
    on any payload.  Row counts: 1, 7, 300, and more rows than one wave of the
    persistent grid can hold (64 resident warps on each SM), so warps stride
    over rows and stop at the last."""
    gen = torch.Generator().manual_seed(200 + s)
    wave = torch.cuda.get_device_properties(0).multi_processor_count * 64
    for block in BLOCKS:
        for rows in (1, 7, 300, wave + 3):
            payload, norms = _gaussian_wire(gen, s, block, rows)
            assert float(norms[0]) == 0.0
            out = qsgd.qsgd_unpack_dequantize(payload, norms, s, block)
            torch.cuda.synchronize()
            want = qsgd.qsgd_unpack_dequantize_plain(payload, norms, s, block)
            assert torch.equal(out, want), (block, rows)
            assert not bool(out[0].any())


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("block", BLOCKS)
def test_cuda_unpack_dequantize_copies_misaligned_payloads(block):
    """A payload view 4 bytes past a 16-byte boundary goes through the
    wrapper's aligned copy and decodes as the aligned payload does."""
    s, rows = 16, 300
    payload, norms = _gaussian_wire(torch.Generator().manual_seed(block), s, block, rows)
    flat = torch.empty(payload.numel() + 1, dtype=torch.int32, device="cuda")
    view = flat[1:].view(payload.shape)
    view.copy_(payload)
    assert view.data_ptr() % 16 == 4
    out = qsgd.qsgd_unpack_dequantize(view, norms, s, block)
    torch.cuda.synchronize()
    assert torch.equal(out, qsgd.qsgd_unpack_dequantize_plain(payload, norms, s, block))


# blocks of 1024 per leaf of the LeNet-MNIST message, in leaf order
LENET_LEAF_BLOCKS = [1, 2, 1, 400, 1, 6272, 1, 64, 1, 2]


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
@pytest.mark.parametrize("senders,s", [(100, 16), (10, 16), (10, 1), (10, 7), (10, 127)],
                         ids=["hier_grid_s16", "es_hop_s16", "2bit", "4bit", "8bit"])
def test_cuda_kernels_match_plain_at_the_baselines_shapes(senders, s):
    """Every LeNet leaf with the shapes the comparison path gives the packed
    pair: Hier-Local-QSGD's flattened client grid (100 senders), its ES hop
    (10 senders), and `low_bit_channel(2/4/8)`'s code widths (s = 1, 7,
    127).  The plain versions run on the card too: dyadic inputs, so bit for
    bit."""
    gen = torch.Generator(device="cuda").manual_seed(senders + s)
    for nb in LENET_LEAF_BLOCKS:
        v = torch.randint(-64, 65, (senders, nb, 1024), generator=gen, device="cuda")
        v = v.to(torch.float32).mul_(2.0**-8)
        v[senders - 1] = 0.0  # a padded slot's zero delta
        keys = torch.randint(-2**31, 2**31, (senders, 2), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
        payload, norms = qsgd.qsgd_quantize_pack(v, keys, s)
        p_payload, p_norms = qsgd.qsgd_quantize_pack_plain(v, keys, s)
        assert torch.equal(payload, p_payload) and torch.equal(norms, p_norms), nb
        rows, nrows = payload.reshape(-1, payload.shape[-1]), norms.reshape(-1)
        out = qsgd.qsgd_unpack_dequantize(rows, nrows, s, 1024)
        assert torch.equal(out, qsgd.qsgd_unpack_dequantize_plain(rows, nrows, s, 1024)), nb
        assert not bool(out.reshape(senders, -1)[senders - 1].any())
        del v, payload, p_payload, out
