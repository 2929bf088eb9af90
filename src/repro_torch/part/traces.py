"""Seeded per-client availability processes + participation samplers.

Real hierarchical edge deployments are defined by intermittent client
availability: devices sleep, radios fade in bursts, operators sample a
subset per round to bound tail latency.  This module is the *process* half
of the participation subsystem — who could report this round, and who is
asked to:

  * `AvailabilityTrace` — a deterministic per-(client, round) on/off
    process.  `AlwaysOn`, `BernoulliTrace` (IID coins) and
    `GilbertElliottTrace` (two-state Markov on/off bursts — the classic
    wireless fading model) all key every draw by ``(seed, client, round)``
    through the same crc32-hashed scheme as `repro_torch.netsim.links`, so traces
    are platform-stable and query-order independent.
  * `Sampler` — which of a round's *candidate* clients actually
    participate.  `FullParticipation` is the default everywhere and is the
    seed-parity path: the training loops treat it exactly like "no sampler", so fixed
    -seed trajectories are bit-identical to the pre-participation stack.
    `AvailabilityAware` takes everyone the trace reports up;
    `UniformK` additionally subsamples k of them uniformly (the FedAvg
    -style participation cap).

Samplers are pure functions of ``(round_idx, clients)`` — the training loops, the
schedulers' reachability probes, and the closed-form ledger tests can all
re-evaluate them and see the same participant sets.  The *mechanics* half
(masked engine rounds, pass-through hops, deadline dropouts) lives in
`core/engine.py`, `core/fed_chs.py`, `core/baselines/` and `netsim/adapters.py`.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = [
    "AvailabilityTrace",
    "AlwaysOn",
    "BernoulliTrace",
    "GilbertElliottTrace",
    "Sampler",
    "FullParticipation",
    "AvailabilityAware",
    "UniformK",
    "is_full_participation",
    "participation_mask",
    "schedule_participants",
    "stack_masks",
]


def _uniform(*key) -> float:
    """One deterministic U[0,1) draw from a structured key (crc32-hashed,
    platform-stable — the same scheme as `repro_torch.netsim.links._rng`)."""
    return float(np.random.default_rng(zlib.crc32(repr(key).encode())).random())


# --------------------------------------------------------------------------
# availability traces
# --------------------------------------------------------------------------


@runtime_checkable
class AvailabilityTrace(Protocol):
    """Deterministic per-(client, round) on/off availability process."""

    def available(self, client: int, round_idx: int) -> bool:
        ...


@dataclasses.dataclass(frozen=True)
class AlwaysOn:
    """Every client is up every round — the implicit pre-participation world."""

    def available(self, client: int, round_idx: int) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class BernoulliTrace:
    """IID per-(client, round) coin: up with probability `p`.

    Memoryless churn — the standard "each device reports with probability p"
    model.  Every coin is keyed by (seed, client, round), so two traces with
    the same seed agree draw-for-draw no matter the query order.
    """

    p: float = 0.9
    seed: int = 0

    def available(self, client: int, round_idx: int) -> bool:
        return _uniform(self.seed, "bernoulli", client, round_idx) < self.p


@dataclasses.dataclass
class GilbertElliottTrace:
    """Two-state Markov on/off process — bursty outages, not IID blips.

    From ON a client fails with `p_fail`; from OFF it recovers with
    `p_recover` (so mean outage length is 1/p_recover rounds).  The chain is
    sequential by nature, but each *transition draw* is independently keyed
    by (seed, client, round): states are computed once per client, cached,
    and identical regardless of which (client, round) is asked first.
    """

    p_fail: float = 0.1
    p_recover: float = 0.5
    seed: int = 0
    start_on: bool = True
    _chains: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def available(self, client: int, round_idx: int) -> bool:
        chain = self._chains.setdefault(client, [self.start_on])
        while len(chain) <= round_idx:
            t = len(chain)  # transition into round t
            u = _uniform(self.seed, "gilbert_elliott", client, t)
            chain.append((u >= self.p_fail) if chain[-1] else (u < self.p_recover))
        return chain[round_idx]

    def steady_state_up(self) -> float:
        """Long-run fraction of rounds a client is ON."""
        return self.p_recover / (self.p_fail + self.p_recover)


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------


@runtime_checkable
class Sampler(Protocol):
    """Which of a round's candidate clients participate.  Pure in
    (round_idx, clients): re-evaluating never changes the answer."""

    def participants(self, round_idx: int, clients: Sequence[int]) -> list[int]:
        ...


@dataclasses.dataclass(frozen=True)
class FullParticipation:
    """Everyone participates — the seed-parity default.  Drivers route this
    through the exact pre-participation code path (no masks anywhere), so
    trajectories are bit-identical to a run with no sampler at all."""

    def participants(self, round_idx: int, clients: Sequence[int]) -> list[int]:
        return list(clients)


@dataclasses.dataclass(frozen=True)
class AvailabilityAware:
    """Everyone the trace reports up participates; nobody else can."""

    trace: AvailabilityTrace = AlwaysOn()

    def participants(self, round_idx: int, clients: Sequence[int]) -> list[int]:
        return [c for c in clients if self.trace.available(c, round_idx)]


@dataclasses.dataclass(frozen=True)
class UniformK:
    """Uniformly sample (without replacement) at most `k` of the available
    clients per round — the FedAvg-style participation cap.  With no trace,
    everyone is a candidate.  The selection draw is keyed by (seed, round,
    candidate set) — still a pure function of the inputs, but distinct
    candidate sets queried in the same round (e.g. every cluster of a
    hierarchical round) draw independently instead of picking correlated
    positions."""

    k: int = 5
    seed: int = 0
    trace: AvailabilityTrace | None = None

    def participants(self, round_idx: int, clients: Sequence[int]) -> list[int]:
        avail = (
            list(clients)
            if self.trace is None
            else [c for c in clients if self.trace.available(c, round_idx)]
        )
        if len(avail) <= self.k:
            return avail
        g = np.random.default_rng(
            zlib.crc32(repr((self.seed, "uniform_k", round_idx, tuple(avail))).encode())
        )
        picked = g.choice(len(avail), size=self.k, replace=False)
        return sorted(avail[i] for i in picked)


def is_full_participation(sampler: Sampler | None) -> bool:
    """True when a training loop should take the unmasked path (bit-identical
    to the pre-participation stack)."""
    return sampler is None or isinstance(sampler, FullParticipation)


def participation_mask(members: Sequence[int], participating: Sequence[int]) -> np.ndarray:
    """1/0 float mask over `members` marking the participating subset."""
    part = set(participating)
    return np.asarray([1.0 if c in part else 0.0 for c in members], dtype=np.float32)


def schedule_participants(
    sampler: Sampler | None, rounds: int, clients: Sequence[int]
) -> list[list[int]]:
    """Precompute the whole run's participant sets over a fixed candidate
    list — samplers are pure in (round_idx, clients), so the scanned
    whole-run drivers evaluate them once up front and see exactly the sets
    the looped drivers would query round-by-round.  `None` (and
    `FullParticipation`) yields every client every round."""
    if is_full_participation(sampler):
        full = list(clients)
        return [list(full) for _ in range(rounds)]
    return [sampler.participants(t, clients) for t in range(rounds)]


def stack_masks(
    members: Sequence[int], parts_by_round: Sequence[Sequence[int]], width: int | None = None
) -> np.ndarray:
    """Stack per-round participation masks over `members` into one
    (rounds, width) float array — the scanned executor's per-round mask
    input.  `width` pads columns with zeros past len(members) (the engine's
    padded client slots for ragged clusters)."""
    n = len(members) if width is None else width
    out = np.zeros((len(parts_by_round), n), dtype=np.float32)
    for t, parts in enumerate(parts_by_round):
        out[t, : len(members)] = participation_mask(members, parts)
    return out
