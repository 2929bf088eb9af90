"""Fed-CHS protocol: keys, topology, scheduler, ledger, round engine, driver.

The package exports the names of the reference's `repro.core`.  They are
imported on first use (a module `__getattr__`): `kernels/ops.py` imports
`core.prng`, which loads this package, and an eager import of the engine
here would load `comm.channels` and `kernels.ops` again while they are
half made.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "FedCHSConfig": "fed_chs",
    "run_fed_chs": "fed_chs",
    "RoundEngine": "engine",
    "split_chain": "prng",
    "CommEvent": "ledger",
    "CommLedger": "ledger",
    "dense_message_bits": "ledger",
    "qsgd_message_bits": "ledger",
    "AvailabilityAwareScheduler": "scheduler",
    "FedCHSScheduler": "scheduler",
    "LatencyAwareScheduler": "scheduler",
    "RandomWalkScheduler": "scheduler",
    "RingScheduler": "scheduler",
    "FLTask": "simulation",
    "RunRecorder": "simulation",
    "RunResult": "simulation",
    "run_sweep": "sweep",
    "evaluate": "simulation",
    "local_sgd": "oracles",
    "multi_client_local_sgd": "oracles",
    "cluster_sgd": "oracles",
    "Topology": "topology",
    "make_topology": "topology",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
