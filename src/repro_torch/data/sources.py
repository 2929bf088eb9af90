"""Per-client batch sources (port of `ArraySource` and `TokenSource` of
`repro/data/sources.py`).

`next_batch(client)` yields one mini-batch dict of numpy arrays (``{"x",
"y"}`` for the classifier, ``{"tokens", "labels"}`` for the LM), and
`eval_data()` what the task's `FedModel.eval_metric` consumes.  The
per-client rng seeding and draw order are the reference's exactly, so a
run of the port sees the reference's batches draw for draw.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.loader import ClientLoader
from repro_torch.data.partition import ClientData
from repro_torch.data.synthetic import Dataset
from repro_torch.data.tokens import MarkovTokens


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


class TokenSource:
    """Non-IID LM batches: per-client topic-skewed Markov token streams.

    All clients share one transition-table set (`tables_seed`); client n's
    rows carry its dominant topic ``n % topics`` with probability
    `dominance`, the rest spread uniformly.  `eval_data()` is a fixed,
    seed-independent stack of uniform-mixture batches (leading eval-batch
    axis).  Every draw is a pure function of (seed, client, draw index).
    """

    def __init__(self, vocab_size: int, num_clients: int, batch_size: int, seq_len: int,
                 *, topics: int = 4, branch: int = 4, dominance: float = 0.9,
                 tables_seed: int = 0, seed: int = 0, eval_batches: int = 4):
        assert topics >= 1 and 0.0 <= dominance <= 1.0
        self.vocab = vocab_size
        self.num_clients = num_clients
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.gen = MarkovTokens(vocab_size, topics=topics, branch=branch, seed=tables_seed)
        self.client_sizes = np.ones(num_clients, dtype=np.float64)
        off = (1.0 - dominance) / max(topics - 1, 1) if topics > 1 else 0.0
        self.topic_probs = np.full((num_clients, topics), off)
        for n in range(num_clients):
            self.topic_probs[n, n % topics] = dominance if topics > 1 else 1.0
        self._eval = self._make_eval(tables_seed, eval_batches)
        self.reset(seed)

    def _make_eval(self, tables_seed: int, eval_batches: int) -> dict:
        rng = np.random.default_rng((tables_seed, 0x7EA1))
        toks = np.stack([
            self.gen.sample(rng, self.batch_size, self.seq_len + 1)
            for _ in range(eval_batches)
        ])  # (n_eval, B, T+1)
        return {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}

    def reset(self, seed: int) -> None:
        self.seed = seed
        self.draw_counts = [0] * self.num_clients

    def fast_forward(self, draw_counts: list[int]) -> None:
        """Resume mid-run: set each client's stream position explicitly."""
        assert len(draw_counts) == self.num_clients
        self.draw_counts = list(draw_counts)

    def next_batch(self, client: int) -> dict:
        idx = self.draw_counts[client]
        self.draw_counts[client] = idx + 1
        rng = np.random.default_rng((self.seed, client, idx))
        topic = rng.choice(len(self.topic_probs[client]), size=self.batch_size,
                           p=self.topic_probs[client])
        toks = self.gen.sample_topics(rng, topic, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def eval_data(self) -> dict:
        return self._eval
