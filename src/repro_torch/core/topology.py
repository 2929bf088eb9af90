"""ES-node network topologies for sequential (SFL) passing.

The paper (Appendix B.1) randomly generates a sparse topology where every ES
node connects to at most 3 other ES nodes. We also provide ring / star / line
topologies so the scheduler can be exercised on the shapes the related work
assumes (ring for fixed-order SFL, star for classic HFL).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Undirected connectivity graph over M ES nodes."""

    num_nodes: int
    adjacency: tuple[tuple[int, ...], ...]  # adjacency[m] = sorted neighbor ids

    def neighbors(self, m: int) -> tuple[int, ...]:
        return self.adjacency[m]

    def degree(self, m: int) -> int:
        return len(self.adjacency[m])

    def is_connected(self) -> bool:
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for v in self.adjacency[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return len(seen) == self.num_nodes

    def validate(self) -> None:
        assert len(self.adjacency) == self.num_nodes
        for m, nbrs in enumerate(self.adjacency):
            assert m not in nbrs, f"self-loop at {m}"
            for v in nbrs:
                assert 0 <= v < self.num_nodes
                assert m in self.adjacency[v], f"asymmetric edge {m}->{v}"


def _freeze(adj: list[set[int]]) -> Topology:
    topo = Topology(len(adj), tuple(tuple(sorted(s)) for s in adj))
    topo.validate()
    return topo


def ring(num_nodes: int) -> Topology:
    assert num_nodes >= 2
    if num_nodes == 2:
        return _freeze([{1}, {0}])
    adj = [{(m - 1) % num_nodes, (m + 1) % num_nodes} for m in range(num_nodes)]
    return _freeze(adj)


def line(num_nodes: int) -> Topology:
    assert num_nodes >= 2
    adj: list[set[int]] = [set() for _ in range(num_nodes)]
    for m in range(num_nodes - 1):
        adj[m].add(m + 1)
        adj[m + 1].add(m)
    return _freeze(adj)


def star(num_nodes: int) -> Topology:
    """Hub = node 0 (models the classic HFL PS-centred shape)."""
    assert num_nodes >= 2
    adj: list[set[int]] = [set(range(1, num_nodes))] + [{0} for _ in range(num_nodes - 1)]
    return _freeze(adj)


def full(num_nodes: int) -> Topology:
    assert num_nodes >= 2
    adj = [set(range(num_nodes)) - {m} for m in range(num_nodes)]
    return _freeze(adj)


def random_sparse(num_nodes: int, max_degree: int = 3, seed: int = 0) -> Topology:
    """Paper's Appendix B.1 topology: connected, degree <= max_degree.

    Built as a random spanning tree with bounded degree, then densified with
    random extra edges while respecting the degree cap.
    """
    assert num_nodes >= 2 and max_degree >= 2
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_nodes)
    adj: list[set[int]] = [set() for _ in range(num_nodes)]
    # bounded-degree random spanning tree
    in_tree = [int(order[0])]
    for u in order[1:]:
        candidates = [v for v in in_tree if len(adj[v]) < max_degree]
        if not candidates:  # cannot happen for max_degree>=2, but stay safe
            candidates = in_tree
        v = int(rng.choice(candidates))
        adj[int(u)].add(v)
        adj[v].add(int(u))
        in_tree.append(int(u))
    # densify
    extra = num_nodes  # attempt a handful of extra edges
    for _ in range(extra):
        u, v = rng.integers(0, num_nodes, size=2)
        u, v = int(u), int(v)
        if u == v or v in adj[u]:
            continue
        if len(adj[u]) < max_degree and len(adj[v]) < max_degree:
            adj[u].add(v)
            adj[v].add(u)
    return _freeze(adj)


def make_topology(kind: str, num_nodes: int, *, max_degree: int = 3, seed: int = 0) -> Topology:
    factory = {
        "ring": ring,
        "line": line,
        "star": star,
        "full": full,
    }
    if kind in factory:
        return factory[kind](num_nodes)
    if kind == "random_sparse":
        return random_sparse(num_nodes, max_degree=max_degree, seed=seed)
    raise ValueError(f"unknown topology kind: {kind!r}")
