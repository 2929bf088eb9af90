"""Channels (dense, QSGD, Sign-SGD, Top-K), exact message-size formulas, and the QSGD wrappers.

Re-exports the channel abstraction and the kernel wrappers so higher
layers depend on `repro_torch.comm`, not on kernel internals.
"""
from repro_torch.comm.bits import (
    dense_message_bits,
    qsgd_message_bits,
    signsgd_message_bits,
    topk_message_bits,
)
from repro_torch.comm.channels import (
    Channel,
    DenseChannel,
    QSGDChannel,
    SignSGDChannel,
    TopKChannel,
    channel_wire_bits,
    low_bit_channel,
    make_channel,
)
from repro_torch.kernels.ops import (
    qsgd_compress_tree,
    qsgd_decode,
    qsgd_dequantize,
    qsgd_encode,
    qsgd_quantize,
    qsgd_roundtrip,
)

__all__ = [
    "Channel",
    "DenseChannel",
    "QSGDChannel",
    "SignSGDChannel",
    "TopKChannel",
    "channel_wire_bits",
    "low_bit_channel",
    "make_channel",
    "dense_message_bits",
    "qsgd_message_bits",
    "signsgd_message_bits",
    "topk_message_bits",
    "qsgd_compress_tree",
    "qsgd_decode",
    "qsgd_dequantize",
    "qsgd_encode",
    "qsgd_quantize",
    "qsgd_roundtrip",
]
