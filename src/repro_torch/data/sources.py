"""Per-client batch source for the classifier task (port of `ArraySource`).

`next_batch(client)` yields one mini-batch ``{"x", "y"}`` of numpy arrays;
the per-client rng seeding and draw order are the reference's exactly, so
a run of the port sees the reference's batches draw for draw.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.loader import ClientLoader
from repro_torch.data.partition import ClientData
from repro_torch.data.synthetic import Dataset


class ArraySource:
    """Classification batches from a `Dataset` + per-client index shards."""

    def __init__(self, dataset: Dataset, clients: list[ClientData], batch_size: int,
                 *, seed: int = 0):
        self.dataset = dataset
        self.clients = clients
        self.batch_size = batch_size
        self.num_clients = len(clients)
        self.client_sizes = np.array([c.size for c in clients], dtype=np.float64)
        self.reset(seed)

    def reset(self, seed: int) -> None:
        self.loaders = [
            ClientLoader(self.dataset, c, self.batch_size, seed=seed) for c in self.clients
        ]
        self.draw_counts = [0] * self.num_clients

    def next_batch(self, client: int) -> dict:
        self.draw_counts[client] += 1
        x, y = self.loaders[client].next_batch()
        return {"x": x, "y": y}

    def eval_data(self) -> Dataset:
        return self.dataset
