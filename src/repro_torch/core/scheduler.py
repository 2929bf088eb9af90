"""Next-passing-cluster selection — the paper's deterministic 2-step rule.

Section 3.2: from the neighbors A(m(t)) of the currently active ES,
  Step 1: C(t) = argmin_{m' in A(m(t))} c(m')   (least traversed so far)
  Step 2: if |C(t)| > 1, pick argmax cluster dataset size D_{A,m'}.
The chosen node's visit count is incremented (Algorithm 1 line 17).

We also ship alternative schedulers to reproduce the baselines' walks:
`RandomWalkScheduler` (uniform over neighbors — WRWGD's walk) and
`RingScheduler` (fixed order — ring-topology SFL), plus a link-aware
variant the paper's topology-free rule invites: `LatencyAwareScheduler`
breaks the least-traversed tie by *smallest ES->ES link delay* (from a
`repro.netsim` link model) instead of largest dataset — the natural rule
when the sequential model pass itself is the wall-clock bottleneck.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.topology import Topology


@dataclasses.dataclass
class SchedulerState:
    current: int
    visit_counts: np.ndarray  # c(m), length M
    step: int = 0


class FedCHSScheduler:
    """The paper's 2-step deterministic rule."""

    def __init__(self, topology: Topology, cluster_sizes: list[int], initial: int = 0):
        assert len(cluster_sizes) == topology.num_nodes
        self.topology = topology
        self.cluster_sizes = np.asarray(cluster_sizes)
        counts = np.zeros(topology.num_nodes, dtype=np.int64)
        counts[initial] = 1  # the starting ES has been visited once
        self.state = SchedulerState(current=initial, visit_counts=counts)

    def set_topology(self, topology: Topology) -> None:
        """Swap the connectivity graph between rounds (dynamic networks —
        core/dynamics.py). Visit counts and the current node persist: the
        2-step rule itself is topology-free."""
        assert topology.num_nodes == self.topology.num_nodes
        self.topology = topology

    def _candidate_pool(self, nbrs: list[int]) -> list[int]:
        """Neighbors eligible for the 2-step rule (hook for availability-aware
        variants). The base rule considers every neighbor."""
        return nbrs

    def peek(self) -> int:
        """Apply the 2-step rule without mutating state."""
        st = self.state
        nbrs = self._candidate_pool(list(self.topology.neighbors(st.current)))
        counts = st.visit_counts[list(nbrs)]
        least = counts.min()
        candidates = [m for m, c in zip(nbrs, counts) if c == least]
        if len(candidates) == 1:
            return candidates[0]
        return self._tie_break(st.current, candidates)

    def _tie_break(self, current: int, candidates: list[int]) -> int:
        """Step 2: the paper picks the largest cluster dataset."""
        del current
        sizes = self.cluster_sizes[candidates]
        return candidates[int(np.argmax(sizes))]

    def advance(self) -> int:
        nxt = self.peek()
        self.state.visit_counts[nxt] += 1
        self.state.current = nxt
        self.state.step += 1
        return nxt

    def schedule(self, rounds: int) -> list[int]:
        """The full deterministic visiting order for `rounds` rounds (m(0)..m(T-1)).

        Does not mutate `self`; replays on a copy.
        """
        return list(self.precompute(rounds))

    def precompute(self, rounds: int, dynamic=None) -> np.ndarray:
        """Precompute the whole run's visit order as one int array.

        The 2-step rule (and its latency-/availability-aware variants, whose
        tie-break and candidate-pool hooks are deterministic functions of
        (topology, link delays, participation traces)) is fully determined by
        its inputs, so the scanned whole-run executor (`engine.run_scan`)
        consumes this instead of advancing the scheduler round-by-round on
        the host.  Replays `advance()` on a state copy — `self` is not
        mutated, and the replay is step-exact with the looped drivers'
        advances (including the `state.step`-indexed availability probes).

        `dynamic` (a `core.dynamics` callable t -> Topology) replays a
        dynamic network: the graph is swapped to `dynamic(t)` before the
        advance that leaves round t, exactly where the looped driver calls
        `set_topology` — IoV/LEO graphs are seed-deterministic functions of
        the round index, so the whole visit order is just as precomputable.
        The scheduler's own topology is restored after the replay.
        """
        saved = SchedulerState(self.state.current, self.state.visit_counts.copy(), self.state.step)
        saved_topo = self.topology
        order = [self.state.current]
        for t in range(rounds - 1):
            if dynamic is not None:
                self.set_topology(dynamic(t))
            order.append(self.advance())
        self.state = saved
        self.topology = saved_topo
        return np.asarray(order, dtype=np.int64)


class LatencyAwareScheduler(FedCHSScheduler):
    """2-step rule, tie broken by link delay instead of dataset size.

    Step 1 is unchanged (least traversed — the fairness half of the paper's
    rule).  Step 2 picks the candidate with the smallest ES->ES link delay
    from the current node; remaining exact-delay ties fall back to the
    paper's largest-dataset rule.  `link_delay(a, b) -> seconds` is any
    deterministic pair cost, e.g. `NetworkModel.backhaul_delay` bound to the
    model-message size (see repro/netsim/links.py).
    """

    def __init__(
        self,
        topology,
        cluster_sizes: list[int],
        link_delay: Callable[[int, int], float],
        initial: int = 0,
    ):
        super().__init__(topology, cluster_sizes, initial=initial)
        self.link_delay = link_delay

    def _tie_break(self, current: int, candidates: list[int]) -> int:
        delays = np.array([self.link_delay(current, m) for m in candidates])
        best = delays.min()
        fastest = [m for m, d in zip(candidates, delays) if d == best]
        if len(fastest) == 1:
            return fastest[0]
        return super()._tie_break(current, fastest)


class AvailabilityAwareScheduler(FedCHSScheduler):
    """2-step rule over the *reachable* neighbors only.

    A cluster is reachable for a round when it will have at least one
    participating client (`reachable(cluster, round_idx) -> bool`, typically
    closed over a `repro.part` sampler and the task's cluster membership).
    Step 1/Step 2 of the paper's rule then run over the reachable subset —
    the EdgeFLow-style sequential migration that skips unavailable edges
    entirely.  When NO neighbor is reachable the rule falls back to the full
    neighbor set: the model still has to move, and the receiving ES simply
    becomes a pass-through hop that round (forwarded model, no training).

    Round accounting: the scheduler picks m(t+1) while round t = `state.step`
    is finishing, so reachability is probed at ``state.step + 1``.
    """

    def __init__(
        self,
        topology,
        cluster_sizes: list[int],
        reachable: Callable[[int, int], bool],
        initial: int = 0,
    ):
        super().__init__(topology, cluster_sizes, initial=initial)
        self.reachable = reachable

    def _candidate_pool(self, nbrs: list[int]) -> list[int]:
        next_round = self.state.step + 1
        live = [m for m in nbrs if self.reachable(m, next_round)]
        return live or nbrs


class RandomWalkScheduler:
    """Uniform random neighbor — models WRWGD-style random walks."""

    def __init__(self, topology: Topology, initial: int = 0, seed: int = 0):
        self.topology = topology
        self.rng = np.random.default_rng(seed)
        self.state = SchedulerState(
            current=initial, visit_counts=np.zeros(topology.num_nodes, dtype=np.int64)
        )
        self.state.visit_counts[initial] = 1

    def advance(self) -> int:
        nbrs = self.topology.neighbors(self.state.current)
        nxt = int(self.rng.choice(nbrs))
        self.state.visit_counts[nxt] += 1
        self.state.current = nxt
        self.state.step += 1
        return nxt


class RingScheduler:
    """Fixed-order traversal (requires / induces a ring)."""

    def __init__(self, num_nodes: int, initial: int = 0):
        self.num_nodes = num_nodes
        self.state = SchedulerState(
            current=initial, visit_counts=np.zeros(num_nodes, dtype=np.int64)
        )
        self.state.visit_counts[initial] = 1

    def advance(self) -> int:
        nxt = (self.state.current + 1) % self.num_nodes
        self.state.visit_counts[nxt] += 1
        self.state.current = nxt
        self.state.step += 1
        return nxt
