"""`normal_fill` on the card against its plain version (needs an NVIDIA GPU;
skips here).

The kernel (`csrc/prng.cu`) draws `jax.random.normal` bit for bit: windows
of a draw at offsets below and past 2^32 (a nonzero high counter word), in
f32 and bf16 and at three scales, are bit-equal to `kernels/ref.py::
normal_ref` on the CPU and on the card; `init_params` of a smoke config on
the card is bit-equal to the CPU's, and launches the kernel once per drawn
matrix.  This file imports no JAX.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.core import prng
from repro_torch.kernels import build
from repro_torch.kernels.normal import normal_fill
from repro_torch.kernels.ref import normal_ref
from repro_torch.models import transformer as tf
from repro_torch.utils import resolve_device, tree_leaves

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU")
KEY = prng.split(prng.PRNGKey(11), 3)[2]


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


@needs_card
@pytest.mark.parametrize("offset", [0, 12345, (1 << 32) - 1000, 3 << 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 0.02, 0.2])
def test_normal_fill_equals_plain(offset, dtype, scale):
    device = resolve_device("cuda")
    n = 70001
    build.reset_launches()
    got = normal_fill(torch.empty(n, dtype=dtype, device=device), KEY, scale, offset)
    torch.cuda.synchronize()
    assert build.LAUNCHES["normal_fill"] == 1
    assert torch.equal(bits(got), bits(normal_ref(KEY, offset, n, scale, dtype)))
    assert torch.equal(bits(got), bits(normal_ref(KEY, offset, n, scale, dtype, device=device)))


@needs_card
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b", "recurrentgemma-9b"])
def test_init_params_on_the_card_equals_the_cpu(arch):
    device = resolve_device("cuda")
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    build.reset_launches()
    card = tree_leaves(tf.init_params(cfg, 1, device))
    torch.cuda.synchronize()
    assert build.LAUNCHES["normal_fill"] > 0
    cpu = tree_leaves(tf.init_params(cfg, 1, "cpu"))
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(card, cpu))
