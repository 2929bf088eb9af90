"""Async federation service: event-driven drivers where netsim arrival
traces decide what gets folded and when (port of `repro/async_fl/`).

`run_async_fed_chs` is the paper's sequential ES->ES chain made
asynchronous with bounded-staleness buffers, HiFlash-style staleness
discounts, quorum/deadline fold triggers, and continuous crash-safe
checkpointing.  `run_async_fedavg` / `run_async_hier` are the classic
async-PS comparison arms (FedBuff / two-tier FedAsync) built from the same
computations and the same network model.
"""
from repro_torch.async_fl.arrivals import Dispatch, chain_arrival, dispatch_cohort, fire_time
from repro_torch.async_fl.buffer import StalenessBuffer, Update, staleness_weight
from repro_torch.async_fl.compute import client_updates_fn, fold_fn, stack_updates
from repro_torch.async_fl.fed_chs import (
    AsyncFedCHSConfig,
    load_async_state,
    run_async_fed_chs,
    save_async_state,
)
from repro_torch.async_fl.ps import AsyncPSConfig, run_async_fedavg, run_async_hier

__all__ = [
    "AsyncFedCHSConfig",
    "AsyncPSConfig",
    "Dispatch",
    "StalenessBuffer",
    "Update",
    "chain_arrival",
    "client_updates_fn",
    "dispatch_cohort",
    "fire_time",
    "fold_fn",
    "load_async_state",
    "run_async_fed_chs",
    "run_async_fedavg",
    "run_async_hier",
    "save_async_state",
    "stack_updates",
    "staleness_weight",
]
