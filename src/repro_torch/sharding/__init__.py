"""Sharding (port of `repro/sharding/`): the partition rules (`specs`), the
ambient mesh (`ctx`) and the federation mesh's sharded round bodies
(`fed`).  `named_shardings` needs a model mesh, which the port does not
build yet."""
from repro_torch.sharding.specs import (
    FED_AXES,
    PartitionSpec,
    batch_pspec,
    cache_pspecs,
    fed_engine_pspecs,
    param_pspecs,
)

__all__ = ["FED_AXES", "PartitionSpec", "batch_pspec", "cache_pspecs", "fed_engine_pspecs",
           "param_pspecs"]
