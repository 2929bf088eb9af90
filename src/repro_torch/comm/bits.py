"""Pure message-size formulas (no torch imports — safe at any layer).

A copy of the reference package's `repro/comm/bits.py`, shared by the
channel abstraction (`repro_torch.comm.channels`) and the ledger
(`repro_torch.core.ledger`).
"""
from __future__ import annotations

import math


def dense_message_bits(num_params: int, bits_per_param: int = 32) -> int:
    return num_params * bits_per_param


# itemsize * 8 of every dtype a dense wire may carry
DTYPE_BITS = {
    "float32": 32,
    "bfloat16": 16,
    "float16": 16,
    "float8_e4m3fn": 8,
}


def dtype_bits(dtype: str) -> int:
    """Bits per parameter of a dense wire carrying `dtype` values."""
    try:
        return DTYPE_BITS[dtype]
    except KeyError:
        raise ValueError(
            f"no wire width for dtype {dtype!r} (choose {sorted(DTYPE_BITS)})"
        ) from None


def qsgd_code_bits(levels: int) -> int:
    """Bits per packed QSGD entry: the sign is folded into the code
    (c = q + s in [0, 2s]) so one entry costs ceil(log2(2s+1)) bits — equal,
    for every s >= 1, to the 1 sign bit + ceil(log2(s+1)) level-index bits the
    formula historically charged.  (Duplicated from `repro_torch.kernels.ref` to
    keep this module free of torch.)"""
    return max(1, math.ceil(math.log2(2 * levels + 1)))


def qsgd_message_bits(num_params: int, levels: int, block: int = 1024) -> int:
    """Size of the *actual* packed QSGD wire message (Alistarh et al. 2017):
    ceil(n/block) blocks, each carrying block packed codes
    (ceil(log2(2s+1)) bits/entry, tail block zero-padded to full width) plus
    one f32 norm word.  This is exactly `payload.size * 32 + norms.size * 32`
    of the uint32 payload `qsgd_encode` emits for one flat n-vector."""
    n_blocks = max(1, math.ceil(num_params / block))
    return n_blocks * (qsgd_code_bits(levels) * block + 32)


def signsgd_message_bits(num_params: int, block: int = 1024) -> int:
    """1-bit sign-SGD wire size: 1 bit/entry (tail-padded) + one f32 scale
    per block."""
    n_blocks = max(1, math.ceil(num_params / block))
    return n_blocks * (block + 32)


def packed_wire_bits(leaf_sizes, code_bits: int, block: int = 1024) -> int:
    """Exact wire size of a multi-leaf packed message: blocks are laid out
    *per leaf* (padding-invariant block boundaries), so each leaf rounds up to
    whole blocks independently."""
    total = 0
    for n in leaf_sizes:
        total += max(1, math.ceil(n / block)) * (code_bits * block + 32)
    return total


def topk_message_bits(num_params: int, fraction: float, bits_per_param: int = 32) -> int:
    """Top-K sparse encoding: (index, value) pairs for the k survivors."""
    k = max(1, math.ceil(fraction * num_params))
    index_bits = max(1, math.ceil(math.log2(max(num_params, 2))))
    return k * (bits_per_param + index_bits)
