"""The port's roofline (`repro_torch.roofline`) on the CPU: the counting
mode's per-device dot FLOPs and collective bytes, exact on the reference's
scan test and on a tensor-parallel MLP laid out as DTensors on a fake
(16, 16) world; phase bytes billed to the QSGD wire's named scopes; the
H100 constants and the reference's arithmetic over them; the fake world
that owns its process group."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import _model_mesh, fake_world
from repro_torch.roofline import H100, HW, analyze_trace, counting, model_flops, roofline_terms
from repro_torch.roofline.analysis import arithmetic_intensity, compute_seconds
from repro_torch.roofline.attribution import (collective_breakdown, phase_bytes,
                                              top_output_bytes)


def test_scan_dot_flops_exact():
    """The reference's trip-scaling test: 12 products of (64,128)x(128,128)."""
    def f(x, w):
        h = x
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i])
        return h.sum()

    with counting() as tr:
        f(torch.randn(64, 128), torch.randn(12, 128, 128))
    rec = analyze_trace(tr)
    assert rec["dot_flops_per_device"] == 12 * 2 * 64 * 128 * 128
    assert rec["dot_flops_by_dtype"] == {"f32": 12 * 2 * 64 * 128 * 128}
    assert rec["collective_bytes_per_device"] == 0.0


def test_tensor_parallel_mlp_counted_at_local_shapes():
    """x (256, 4096, 1024) split over data, w1 column- and w2 row-parallel
    over model on a fake (16, 16) world: one device does 6.872e10 FLOPs
    (DTensor's global-shape propagation would read 256 times that) and one
    all-reduce of (16, 4096, 1024) f32, billed at twice its bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(256):
        dm = _model_mesh((16, 16), ("data", "model"), torch.device("cpu")).device_mesh
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(256, 4096, 1024), dm, [Shard(0), Replicate()])
            w1 = distribute_tensor(torch.empty(1024, 4096), dm, [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(4096, 1024), dm, [Replicate(), Shard(0)])
            with counting((x, w1, w2)) as tr:
                y = torch.relu(x @ w1) @ w2
                y.redistribute(dm, [Shard(0), Replicate()])
    rec = analyze_trace(tr)
    assert rec["dot_flops_per_device"] == 2 * 2 * 16 * 4096 * 1024 * 256 == 68_719_476_736
    assert rec["collectives"] == {"all-reduce": 2 * 268_435_456}
    rows = collective_breakdown(tr)
    assert len(rows) == 1 and rows[0]["shape"] == str((16, 4096, 1024))
    assert rec["memory"]["argument_bytes"] == (16 * 4096 * 1024 + 2 * 1024 * 256) * 4
    assert not dist.is_initialized()


def test_phase_bytes_bill_the_qsgd_wire():
    """A 4096-entry QSGD(16) round trip: the encode and the decode scopes
    are billed, the encode at least the 3072-byte payload (4096 x 6 bits)."""
    from repro_torch.kernels.ops import qsgd_decode, qsgd_encode

    v = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    keys = np.array([[1, 2]], dtype=np.uint32)
    with counting() as tr:
        wire = qsgd_encode(v[None], keys, s=16)
        out = qsgd_decode(wire, s=16, shape=(1, 4096))
    got = phase_bytes(tr, {"encode": r"qsgd_encode", "decode": r"qsgd_decode"})
    assert got["encode"] >= 3072 and got["decode"] >= 3072, got
    assert out.shape == (1, 4096)
    assert top_output_bytes(tr, top=3)[0]["bytes"] >= 4096 * 4


def test_h100_constants_and_reference_arithmetic():
    from repro.roofline import analysis as ref

    assert H100 == HW(peak_flops=989.4e12, peak_flops_f32=66.9e12, hbm_bw=3.35e12, ici_bw=50e9)
    rec = {"dot_flops_per_device": 3e12, "dot_flops_by_dtype": {"bf16": 2e12, "f32": 1e12},
           "scaled_bytes_per_device": 4e10, "collective_bytes_per_device": 2e9}
    ref_hw = ref.HW(peak_flops=H100.peak_flops, peak_flops_f32=H100.peak_flops_f32,
                    hbm_bw=H100.hbm_bw, ici_bw=H100.ici_bw)
    assert roofline_terms(rec) == pytest.approx(ref.roofline_terms(rec, hw=ref_hw))
    assert compute_seconds(rec) == pytest.approx(ref.compute_seconds(rec, hw=ref_hw))
    assert arithmetic_intensity(rec) == ref.arithmetic_intensity(rec)
    assert model_flops(10, 7) == ref.model_flops(10, 7)
    assert model_flops(10, 7, kind="serve") == ref.model_flops(10, 7, kind="serve")


def test_fake_world_owns_its_group():
    with fake_world(8):
        assert dist.get_world_size() == 8
    assert not dist.is_initialized()
    with fake_world(4):
        with pytest.raises(RuntimeError, match="no default process group"):
            with fake_world(2):
                pass
    assert not dist.is_initialized()
