"""Non-IID client partitioning.

Paper §5.1: "the label distribution on each device follows the Dirichlet
distribution with λ > 0 being a concentration parameter". We implement the
standard Dirichlet label-skew partitioner, plus the paper's Appendix-B
*partial heterogeneity* mode (Fig. 4): data distribution is IID **across
clusters** but non-IID across clients **within** every cluster.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClientData:
    """Index-based view into a dataset for one client."""

    client_id: int
    indices: np.ndarray  # int64 indices into the train split

    @property
    def size(self) -> int:
        return int(len(self.indices))


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    *,
    seed: int = 0,
    min_size: int = 2,
) -> list[ClientData]:
    """Dirichlet(alpha) label-skew partition of `labels` into `num_clients`.

    For each class c, the class's samples are split across clients with
    proportions ~ Dirichlet(alpha * 1_N). Retries until every client has at
    least `min_size` samples (standard practice, e.g. Li et al. 2022).
    """
    assert alpha > 0 and num_clients >= 1
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    n = len(labels)
    for _attempt in range(100):
        idx_per_client: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, chunk in enumerate(np.split(idx_c, cuts)):
                idx_per_client[client].append(chunk)
        sizes = [sum(len(ch) for ch in chunks) for chunks in idx_per_client]
        if min(sizes) >= min_size or n < num_clients * min_size:
            break
    clients = []
    for cid, chunks in enumerate(idx_per_client):
        idx = np.concatenate(chunks) if chunks else np.empty((0,), dtype=np.int64)
        rng.shuffle(idx)
        clients.append(ClientData(cid, idx.astype(np.int64)))
    return clients


def iid_partition(labels: np.ndarray, num_clients: int, *, seed: int = 0) -> list[ClientData]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels)).astype(np.int64)
    return [ClientData(cid, chunk) for cid, chunk in enumerate(np.array_split(idx, num_clients))]


def assign_clusters(num_clients: int, num_clusters: int, *, seed: int = 0) -> list[list[int]]:
    """Assign clients to clusters (ESs) — roughly equal-sized random clusters,
    matching the paper's 100 clients / 10 ES setup."""
    assert 1 <= num_clusters <= num_clients
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_clients)
    return [sorted(int(c) for c in chunk) for chunk in np.array_split(order, num_clusters)]


def partial_heterogeneity_partition(
    labels: np.ndarray,
    num_clients: int,
    num_clusters: int,
    alpha: float,
    *,
    seed: int = 0,
) -> tuple[list[ClientData], list[list[int]]]:
    """Fig. 4 mode: clusters are IID copies of the global distribution; clients
    *within* a cluster are Dirichlet(alpha) non-IID over the cluster's shard."""
    rng = np.random.default_rng(seed)
    cluster_members = assign_clusters(num_clients, num_clusters, seed=seed)
    # IID split across clusters
    global_idx = rng.permutation(len(labels)).astype(np.int64)
    cluster_shards = np.array_split(global_idx, num_clusters)
    clients: list[ClientData | None] = [None] * num_clients
    for m, (members, shard) in enumerate(zip(cluster_members, cluster_shards)):
        sub = dirichlet_partition(labels[shard], len(members), alpha, seed=seed + 1000 + m)
        for local, cid in enumerate(members):
            clients[cid] = ClientData(cid, shard[sub[local].indices])
    return [c for c in clients if c is not None], cluster_members


def label_histogram(labels: np.ndarray, clients: list[ClientData], num_classes: int) -> np.ndarray:
    hist = np.zeros((len(clients), num_classes), dtype=np.int64)
    for c in clients:
        np.add.at(hist[c.client_id], labels[c.indices], 1)
    return hist
