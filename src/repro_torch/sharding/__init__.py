"""Sharding (port of `repro/sharding/`): the partition rules (`specs`), the
ambient mesh (`ctx`) and the federation mesh's sharded round bodies
(`fed`), and the model mesh's shardings (`named_shardings`, `distribute`)."""
from repro_torch.sharding.specs import (
    FED_AXES,
    NamedSharding,
    PartitionSpec,
    batch_pspec,
    cache_pspecs,
    distribute,
    fed_engine_pspecs,
    named_shardings,
    param_pspecs,
)

__all__ = ["FED_AXES", "NamedSharding", "PartitionSpec", "batch_pspec", "cache_pspecs",
           "distribute", "fed_engine_pspecs", "named_shardings", "param_pspecs"]
