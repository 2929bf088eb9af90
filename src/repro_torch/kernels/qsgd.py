"""Hopper kernels for QSGD, their plain versions and their wrappers.

The packed wire: `qsgd_quantize_pack` and `qsgd_unpack_dequantize`.  The
dense codes: `qsgd_quantize_blocks` (signed int8 codes and norms) and
`qsgd_dequantize_blocks`.  Each takes a tensor on the card to its
hand-written CUDA kernel in `repro_torch/csrc/qsgd.cu` and a tensor on the
CPU to its plain torch version (`*_plain`, in this module).  A CUDA tensor
never falls back to the plain version: the wrapper launches the kernel or
raises.  Kernels are built at first use and counted in `build.LAUNCHES`.

Unlike the TPU kernels they replace, the quantizers take the key words
instead of a uniform tensor: they compute the dither of the reference's
`ops._cheap_uniform` themselves (see the note in `qsgd.cu`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import LAUNCHES, library
from repro_torch.kernels.ref import (
    MASK32,
    cheap_uniform_ref,
    qsgd_code_bits,
    qsgd_dequantize_blocks_ref,
    qsgd_dequantize_codes_ref,
    qsgd_quantize_blocks_ref,
    qsgd_quantize_codes_ref,
    u32_to_i32,
)

MAX_BLOCK = 4096
MAX_LEVELS = 127  # codes in [0, 2s] must fit the kernels' 8 bit planes


@functools.cache
def _load() -> ctypes.CDLL:
    lib = library("qsgd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qsgd_quantize_pack.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.qsgd_unpack_dequantize.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.qsgd_quantize.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.qsgd_dequantize.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    for fn in (lib.qsgd_quantize_pack, lib.qsgd_unpack_dequantize, lib.qsgd_quantize,
               lib.qsgd_dequantize):
        fn.restype = i32
    return lib


def _check_shape(block: int, s: int) -> None:
    if block % 32 or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be a multiple of 32 in [32, {MAX_BLOCK}], got {block}")
    if not 1 <= s <= MAX_LEVELS:
        raise ValueError(f"levels must be in [1, {MAX_LEVELS}], got {s}")


def _check_cuda(t: torch.Tensor, dtype: torch.dtype, name: str, align: int = 4) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be a contiguous, {align}-byte aligned {dtype} tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the comparison on the card)
# ---------------------------------------------------------------------------


def _pack_words(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(rows, block) int64 codes -> (rows, bits*block/32) int32 payload, the
    layout of `ref.pack_codes_ref`, vectorized over the 32 codes of a word.
    Each plane's word is a sum of distinct powers of two taken as int32 bit
    patterns (bit 31 negative), which no order of addition overflows."""
    rows, block = codes.shape
    c = codes.to(torch.int32).reshape(rows, 32, block // 32)
    weight = u32_to_i32(1 << torch.arange(32, dtype=torch.int64, device=codes.device))
    weight = weight[None, :, None]
    planes = [(((c >> j) & 1) * weight).sum(dim=1, dtype=torch.int32) for j in range(bits)]
    return torch.cat(planes, dim=1)


def _unpack_words(payload: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact inverse of `_pack_words`: (rows, bits*W) int32 -> (rows, 32*W) int64.
    Bit k of an int32 word survives its sign-extending shift right by k."""
    rows, total = payload.shape
    w = total // bits
    words = payload.reshape(rows, bits, 1, w)
    pos = torch.arange(32, dtype=torch.int32, device=payload.device)[None, :, None]
    c = torch.zeros((rows, 32, w), dtype=torch.int32, device=payload.device)
    for j in range(bits):
        c |= ((words[:, j] >> pos) & 1) << j
    return c.reshape(rows, 32 * w).to(torch.int64)


def qsgd_quantize_pack_plain(v: torch.Tensor, keys: torch.Tensor, s: int):
    """The kernel's function in plain torch: `_cheap_uniform` dither of each
    sender's key, the reference quantizer, the bit-plane pack."""
    senders, nb, block = v.shape
    u = cheap_uniform_ref(keys, nb * block).reshape(senders * nb, block)
    codes, norms = qsgd_quantize_codes_ref(v.reshape(senders * nb, block), u, s)
    payload = _pack_words(codes, qsgd_code_bits(s))
    return payload.reshape(senders, nb, -1), norms.reshape(senders, nb)


def qsgd_unpack_dequantize_plain(payload: torch.Tensor, norms: torch.Tensor, s: int,
                                 block: int) -> torch.Tensor:
    del block  # implied by the payload width
    return qsgd_dequantize_codes_ref(_unpack_words(payload, qsgd_code_bits(s)), norms, s)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def qsgd_quantize_pack(v: torch.Tensor, keys: torch.Tensor, s: int):
    """Fused quantize + bit-pack of every sender's blocks of one leaf.

    v: (senders, nb, block) f32; keys: (senders, 2) int32 key words (uint32
    bit patterns) on v's device.  Returns (payload (senders, nb,
    bits*block/32) int32, norms (senders, nb) f32)."""
    senders, nb, block = v.shape
    _check_shape(block, s)
    if keys.shape != (senders, 2):
        raise ValueError(f"keys must be ({senders}, 2), got {tuple(keys.shape)}")
    if nb * block > MASK32 + 1:
        raise ValueError("a leaf's padded size must fit 32-bit indices")
    if v.device.type == "cpu":
        return qsgd_quantize_pack_plain(v, keys, s)
    _check_cuda(v, torch.float32, "v", align=16)
    _check_cuda(keys, torch.int32, "keys")
    if not 1 <= senders or senders * nb >= 2**31:
        raise ValueError(f"need 1 <= senders and senders * nb < 2^31, got {senders} x {nb}")
    bits = qsgd_code_bits(s)
    payload = torch.empty((senders, nb, bits * block // 32), dtype=torch.int32, device=v.device)
    norms = torch.empty((senders, nb), dtype=torch.float32, device=v.device)
    err = _load().qsgd_quantize_pack(v.data_ptr(), keys.data_ptr(), payload.data_ptr(),
                                     norms.data_ptr(), senders, nb, block, s, bits,
                                     _stream(v))
    if err:
        raise RuntimeError(f"qsgd_quantize_pack launch failed: cudaError {err}")
    LAUNCHES["qsgd_quantize_pack"] += 1
    return payload, norms


def qsgd_unpack_dequantize(payload: torch.Tensor, norms: torch.Tensor, s: int,
                           block: int) -> torch.Tensor:
    """Fused unpack + dequantize: payload (rows, bits*block/32) int32 + norms
    (rows,) f32 -> (rows, block) f32.  A payload whose base is not on 16
    bytes is copied first."""
    _check_shape(block, s)
    rows = payload.shape[0]
    bits = qsgd_code_bits(s)
    if payload.shape != (rows, bits * block // 32) or norms.shape != (rows,):
        raise ValueError(f"payload {tuple(payload.shape)} / norms {tuple(norms.shape)} "
                         f"do not match s={s}, block={block}")
    if payload.device.type == "cpu":
        return qsgd_unpack_dequantize_plain(payload, norms, s, block)
    _check_cuda(payload, torch.int32, "payload")
    _check_cuda(norms, torch.float32, "norms")
    if not 1 <= rows < 2**31:
        raise ValueError(f"need 1 <= rows < 2^31, got {rows}")
    if payload.data_ptr() % 16:  # the kernel at block 1024 reads rows in 16-byte pieces
        payload = payload.clone()  # on the allocator's aligned base
    out = torch.empty((rows, block), dtype=torch.float32, device=payload.device)
    err = _load().qsgd_unpack_dequantize(payload.data_ptr(), norms.data_ptr(),
                                         out.data_ptr(), rows, block, s, bits,
                                         _stream(payload))
    if err:
        raise RuntimeError(f"qsgd_unpack_dequantize launch failed: cudaError {err}")
    LAUNCHES["qsgd_unpack_dequantize"] += 1
    return out


# ---------------------------------------------------------------------------
# dense codes: quantize to signed int8, dequantize
# ---------------------------------------------------------------------------


def qsgd_quantize_blocks_plain(v: torch.Tensor, key: torch.Tensor, s: int):
    """The kernel's function in plain torch: the `_cheap_uniform` dither of
    the key over the flat index of the whole (nb, block) array, then the
    reference quantizer."""
    nb, block = v.shape
    u = cheap_uniform_ref(key.reshape(1, 2), nb * block).reshape(nb, block)
    return qsgd_quantize_blocks_ref(v, u, s)


def qsgd_dequantize_blocks_plain(q: torch.Tensor, norms: torch.Tensor, s: int) -> torch.Tensor:
    return qsgd_dequantize_blocks_ref(q, norms, s)


def qsgd_quantize_blocks(v: torch.Tensor, key: torch.Tensor, s: int):
    """QSGD quantize of one message's blocks to dense codes.

    v: (nb, block) f32; key: (2,) int32 key words (uint32 bit patterns) on
    v's device.  Returns (q (nb, block) int8 in [-s, s], norms (nb,) f32)."""
    nb, block = v.shape
    _check_shape(block, s)
    if key.shape != (2,):
        raise ValueError(f"key must be (2,), got {tuple(key.shape)}")
    if nb * block > MASK32 + 1:
        raise ValueError("the padded message must fit 32-bit indices")
    if v.device.type == "cpu":
        return qsgd_quantize_blocks_plain(v, key, s)
    _check_cuda(v, torch.float32, "v", align=16)
    _check_cuda(key, torch.int32, "key")
    if nb < 1:
        raise ValueError("nothing to encode")
    q = torch.empty((nb, block), dtype=torch.int8, device=v.device)
    norms = torch.empty((nb,), dtype=torch.float32, device=v.device)
    err = _load().qsgd_quantize(v.data_ptr(), key.data_ptr(), q.data_ptr(), norms.data_ptr(),
                                nb, block, s, _stream(v))
    if err:
        raise RuntimeError(f"qsgd_quantize launch failed: cudaError {err}")
    LAUNCHES["qsgd_quantize"] += 1
    return q, norms


def qsgd_dequantize_blocks(q: torch.Tensor, norms: torch.Tensor, s: int) -> torch.Tensor:
    """Dense codes back to values: q (nb, block) int8 + norms (nb,) f32 ->
    q * (norm / s) as (nb, block) f32."""
    rows, block = q.shape
    _check_shape(block, s)
    if norms.shape != (rows,):
        raise ValueError(f"norms {tuple(norms.shape)} do not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return qsgd_dequantize_blocks_plain(q, norms, s)
    _check_cuda(q, torch.int8, "q")
    _check_cuda(norms, torch.float32, "norms")
    if rows < 1:
        raise ValueError("nothing to decode")
    out = torch.empty((rows, block), dtype=torch.float32, device=q.device)
    err = _load().qsgd_dequantize(q.data_ptr(), norms.data_ptr(), out.data_ptr(), rows, block,
                                  s, _stream(q))
    if err:
        raise RuntimeError(f"qsgd_dequantize launch failed: cudaError {err}")
    LAUNCHES["qsgd_dequantize"] += 1
    return out
