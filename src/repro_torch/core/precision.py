"""The drivers' channel rules (port of the ``precision=None`` branch of
`repro/core/precision.py`).

The reference's `Precision` policy (bf16 client compute, an f32 master, a
wire dtype) is not ported: a driver given one raises `NotImplementedError`
through its config.  Without a policy the rules are these: an explicit
uplink channel wins, else `make_channel(qsgd_levels, bits_per_param)`; a
dense model broadcast travels at `bits_per_param`.
"""
from __future__ import annotations

from repro_torch.comm.channels import Channel, make_channel


def resolve_channel(precision=None, channel: Channel | None = None,
                    qsgd_levels: int | None = None, bits_per_param: int = 32) -> Channel:
    """The uplink channel of a driver's config."""
    if precision is not None:
        raise NotImplementedError("Precision policies are not ported to repro_torch yet")
    if channel is not None:
        return channel
    return make_channel(qsgd_levels, bits_per_param)


def downlink_bits_per_param(precision=None, bits_per_param: int = 32) -> int:
    """Width of a dense model broadcast (ES->client, ES->ES, ES<->PS)."""
    if precision is not None:
        raise NotImplementedError("Precision policies are not ported to repro_torch yet")
    return bits_per_param
