"""Bounded-staleness update buffers + HiFlash-style staleness discounts
(copy of `repro/async_fl/buffer.py`).

An `Update` is one client's post-channel delta pytree tagged with the model
version it was computed on; `staleness_weight` is the polynomial discount
``gamma * (1 + tau)^(-alpha)`` (HiFlash's adaptive staleness control uses an
inverse-polynomial family; alpha=0 recovers undiscounted FedBuff).  A
`StalenessBuffer` holds the updates an aggregator has received but not yet
folded, and evicts anything older than `max_staleness` model versions — the
bounded-staleness guarantee that keeps a long-dead straggler from dragging
the model backwards.
"""
from __future__ import annotations

import dataclasses
from typing import Any

PyTree = Any


@dataclasses.dataclass
class Update:
    """One arrived client update, waiting in an aggregator's buffer."""

    client: int
    cluster: int
    version: int      # model version the delta was computed on
    arrival: float    # simulated seconds at which the upload completed
    gamma: float      # data-size base weight (within its cluster)
    delta: PyTree     # post-channel delta, same structure as params (its own
                      # storage once buffered: never a view of a whole cohort)


def staleness_weight(gamma: float, tau: int, alpha: float) -> float:
    """``gamma * (1 + tau)^(-alpha)`` — tau is in model versions (folds)."""
    assert tau >= 0
    return gamma * (1.0 + tau) ** (-alpha)


@dataclasses.dataclass
class StalenessBuffer:
    """Arrived-but-unfolded updates with bounded staleness."""

    max_staleness: int | None = None  # None: unbounded
    updates: list[Update] = dataclasses.field(default_factory=list)
    dropped: int = 0  # evicted for exceeding the staleness bound

    def add(self, u: Update) -> None:
        self.updates.append(u)

    def __len__(self) -> int:
        return len(self.updates)

    def evict_stale(self, current_version: int) -> list[Update]:
        """Drop updates whose staleness at the *next* fold would exceed the
        bound; returns the evicted updates (their bits were still spent —
        the caller meters them with their terminal staleness)."""
        if self.max_staleness is None:
            return []
        keep, out = [], []
        for u in self.updates:
            if current_version - u.version > self.max_staleness:
                out.append(u)
            else:
                keep.append(u)
        self.updates = keep
        self.dropped += len(out)
        return out

    def take(self) -> list[Update]:
        """Drain every buffered update, oldest version first (ties by
        arrival, then client id — a total order, so folds are deterministic
        regardless of insertion order)."""
        out = sorted(self.updates, key=lambda u: (u.version, u.arrival, u.client))
        self.updates = []
        return out

    def take_arrived(self, now: float) -> list[Update]:
        """Drain only the updates that have fully arrived by `now`."""
        ready = [u for u in self.updates if u.arrival <= now]
        self.updates = [u for u in self.updates if u.arrival > now]
        return sorted(ready, key=lambda u: (u.version, u.arrival, u.client))
