"""Time-varying ES topologies — the paper's Appendix-D deployment scenarios.

Fed-CHS's selling point (§1) is being "general to network topology,
especially when the topology is highly dynamic or not in a star shape".
The two motivating systems, made concrete:

  * LEO constellation (`leo_constellation`): M satellites on a circular
    orbit; at any round only satellites within an angular window of each
    other have an inter-satellite link, and the whole ring ROTATES by one
    slot every `period` rounds (a satellite "sets" and its neighbor set
    shifts). The visibility graph is a rotating banded ring.
  * IoV roadside units (`iov_gilbert`): RSUs along a road with line links
    whose availability flaps round-to-round (Gilbert-style on/off fading,
    seeded per round — deterministic and replayable). Links may drop, but
    each round's graph is repaired to stay connected (a disconnected RSU
    would simply buffer, which the round-based protocol models by skipping).

Both return plain `Topology` objects per round, so the 2-step scheduler
needs nothing but `set_topology` between rounds — the rule itself is
topology-free, exactly the paper's claim.

For the network-time simulator (`repro_torch.netsim`), connectivity alone is too
coarse: an IoV link that faded this round but was re-added by the repair
step is *flaky*, not free — the RSU relays through vehicles at a fraction
of the base bandwidth.  `iov_gilbert` therefore exposes the pre-repair drop
set as a `dropped(t)` attribute on the returned callable; `NetworkModel`
maps "dropped or invisible this round" to degraded bandwidth rather than a
missing edge (the paper's §3.2 overhead model counts the bits either way —
only the *time* differs).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.topology import Topology, _freeze

DynamicTopology = Callable[[int], Topology]  # round index -> graph


def leo_constellation(num_nodes: int, *, window: int = 2, period: int = 1) -> DynamicTopology:
    """Rotating banded ring: node m sees nodes within `window` slots, with the
    band offset advancing every `period` rounds (orbital drift)."""
    assert num_nodes >= 3 and 1 <= window < num_nodes // 2 + 1

    def at(t: int) -> Topology:
        off = (t // max(period, 1)) % num_nodes
        adj: list[set[int]] = [set() for _ in range(num_nodes)]
        for m in range(num_nodes):
            for d in range(1, window + 1):
                v = (m + d + off) % num_nodes
                if v != m:
                    adj[m].add(v)
                    adj[v].add(m)
        return _freeze(adj)

    return at


def iov_gilbert(num_nodes: int, *, p_drop: float = 0.3, seed: int = 0) -> DynamicTopology:
    """Line of RSUs; each link is independently down with prob `p_drop` this
    round (seeded by (seed, t): replayable). The graph is then repaired to
    connectivity by re-adding the leftmost dropped link of each break."""
    assert num_nodes >= 2

    # base graph: the line plus vehicle-relay skip links (m, m+2)
    base = [(m, m + 1) for m in range(num_nodes - 1)]
    base += [(m, m + 2) for m in range(num_nodes - 2)]

    def dropped_at(t: int) -> frozenset[tuple[int, int]]:
        """The links Gilbert fading took down this round, *before* repair —
        replayable standalone because the drop draws precede the repair
        draws in the shared per-round rng."""
        rng = np.random.default_rng((seed + 1) * 1_000_003 + t)
        return frozenset(e for e in base if rng.random() < p_drop)

    def at(t: int) -> Topology:
        rng = np.random.default_rng((seed + 1) * 1_000_003 + t)
        up = [e for e in base if rng.random() >= p_drop]
        dropped = [e for e in base if e not in set(up)]

        def build(edges):
            adj: list[set[int]] = [set() for _ in range(num_nodes)]
            for a, b in edges:
                adj[a].add(b)
                adj[b].add(a)
            return adj

        adj = build(up)
        # repair to connectivity: re-add dropped links (the RSU buffers until
        # a link returns; the protocol sees the repaired graph that round)
        while dropped:
            topo = Topology(num_nodes, tuple(tuple(sorted(s)) for s in adj))
            if all(adj[m] for m in range(num_nodes)) and topo.is_connected():
                break
            up.append(dropped.pop(int(rng.integers(len(dropped)))))
            adj = build(up)
        return _freeze(adj)

    at.dropped = dropped_at  # degraded-link metadata for repro_torch.netsim
    return at


def make_dynamic(kind: str, num_nodes: int, *, seed: int = 0) -> DynamicTopology:
    if kind == "leo":
        return leo_constellation(num_nodes, window=2, period=1)
    if kind == "iov":
        return iov_gilbert(num_nodes, seed=seed)
    raise ValueError(f"unknown dynamic topology {kind!r}")
