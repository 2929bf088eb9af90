"""The reference's weight draw on the card: `normal_fill`.

`normal_fill(out, key, scale, offset)` writes entries [offset, offset +
out.numel()) of `jax.random.normal(key, shape, float32)` (over its flat
index) times the f32 `scale` into `out`, rounded to out's dtype (f32 or
bf16): a tensor on the card through the hand-written CUDA kernel in
`repro_torch/csrc/prng.cu`, a tensor on the CPU through its plain version
`kernels/ref.py::normal_ref`.  A CUDA tensor never falls back to the plain
version: the wrapper launches the kernel or raises.  A fake tensor (the dry
run's `abstract_params`) holds no data, and nothing is drawn into it.  The
kernel is built at first use and counted in `build.LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.build import LAUNCHES, library
from repro_torch.kernels.ref import normal_ref

DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _load() -> ctypes.CDLL:
    lib = library("prng")
    lib.normal_fill.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_float,
                                ctypes.c_void_p]
    lib.normal_fill.restype = ctypes.c_int
    return lib


def normal_fill(out: torch.Tensor, key, scale: float, offset: int = 0) -> torch.Tensor:
    """Fill contiguous `out` with the reference's normal draw under `key`
    (two uint32 key words), entries from `offset` on, times `scale`
    (rounded to f32).  Returns `out`."""
    if out.dtype not in DTYPES or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous f32 or bf16 tensor, got {out.dtype}")
    n = out.numel()
    if is_fake(out) or n == 0:
        return out
    k0, k1 = (int(k) & 0xFFFFFFFF for k in np.asarray(key).reshape(2))
    scale = float(np.float32(scale))
    if out.device.type == "cpu":
        out.view(-1).copy_(normal_ref((k0, k1), offset, n, scale, out.dtype))
        return out
    if out.device.type != "cuda":
        raise ValueError(f"out must be a CPU or CUDA tensor, got {out.device}")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        rc = _load().normal_fill(out.data_ptr(), int(out.dtype == torch.bfloat16), k0, k1,
                                 offset, n, scale, stream)
    if rc:
        raise RuntimeError(f"normal_fill launch failed: CUDA error {rc}")
    LAUNCHES["normal_fill"] += 1
    return out
