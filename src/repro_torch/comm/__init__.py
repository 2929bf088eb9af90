"""Channels (dense, QSGD, Sign-SGD, Top-K), exact message-size formulas, and the QSGD wrappers.

Re-exports the channel abstraction and the kernel wrappers so higher
layers depend on `repro_torch.comm`, not on kernel internals.  `CommLedger`
is imported on first use: `core/ledger.py` imports `comm.bits`, so an
eager import here would import the ledger while it is half made.
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
    signsgd_decode,
    signsgd_encode,
    topk_sparsify,
    topk_sparsify_tree,
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
    "CommLedger",
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
    "signsgd_decode",
    "signsgd_encode",
    "topk_sparsify",
    "topk_sparsify_tree",
]


def __getattr__(name: str):
    if name != "CommLedger":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from repro_torch.core.ledger import CommLedger

    globals()[name] = CommLedger
    return CommLedger


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
