"""Per-client mini-batch sampling (ξ_{n,k} in Eq. 5)."""
from __future__ import annotations

import numpy as np

from repro_torch.data.partition import ClientData
from repro_torch.data.synthetic import Dataset


class ClientLoader:
    """Stateful sampler of random mini-batches ξ ⊆ D_n for one client."""

    def __init__(self, dataset: Dataset, client: ClientData, batch_size: int, *, seed: int = 0):
        assert client.size > 0, f"client {client.client_id} has no data"
        self.dataset = dataset
        self.client = client
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed + 7919 * client.client_id)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        # Every batch is exactly batch_size so cluster batches stack for the
        # vmapped Eq. (5) aggregation; clients whose Dirichlet shard is
        # smaller than a batch sample with replacement (still a valid random
        # xi_{n,k} subset draw).
        idx = self.next_indices()
        return self.dataset.train_x[idx], self.dataset.train_y[idx]

    def next_indices(self, count: int = 1) -> np.ndarray:
        """Draw `count` batches' worth of sample indices, (count*B,) flat.

        Issues exactly `count` sequential `rng.choice` calls — the same rng
        state evolution as `count` `next_batch` calls — but defers the (much
        more expensive) dataset gather to the caller, which can fetch every
        staged batch of a whole scan chunk with one fancy-index read."""
        replace = self.client.size < self.batch_size
        draws = [
            self.rng.choice(self.client.indices, size=self.batch_size, replace=replace)
            for _ in range(count)
        ]
        return draws[0] if count == 1 else np.concatenate(draws)

    @property
    def num_samples(self) -> int:
        return self.client.size


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Deterministic full pass (used for test-set evaluation)."""
    for i in range(0, len(x), batch_size):
        yield x[i : i + batch_size], y[i : i + batch_size]
