"""Per-client batch sources and bulk staging (port of
`repro/data/sources.py`).

`next_batch(client)` yields one mini-batch dict of numpy arrays (``{"x",
"y"}`` for the classifier, ``{"tokens", "labels"}`` for the LM), and
`eval_data()` what the task's `FedModel.eval_metric` consumes.  The
per-client rng seeding and draw order are the reference's exactly, so a
run of the port sees the reference's batches draw for draw.

The scanned drivers stage a chunk of rounds at once: `stage_chunk` reads
each client's draws of the chunk with one `bulk_batches` call (one dataset
gather on an `ArraySource`) and scatters them into the chunk's arrays.  A
bulk read equals the same number of `next_batch` calls, draw for draw, and
leaves the stream where they would.  On a federation mesh `put_sharded`
copies only the rank's window of a staged chunk to its device.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.data.loader import ClientLoader
from repro_torch.data.partition import ClientData
from repro_torch.data.synthetic import Dataset
from repro_torch.data.tokens import MarkovTokens


Batch = Any  # tree of numpy arrays with matching leading (B, ...) axes


@runtime_checkable
class DataSource(Protocol):
    """Per-client batch supply + held-out eval data for one FL experiment."""

    num_clients: int
    batch_size: int
    client_sizes: np.ndarray  # per-client dataset sizes (gamma weights)

    def reset(self, seed: int) -> None:
        """Rewind every client's stream (same-seed runs must be identical)."""
        ...

    def next_batch(self, client: int) -> Batch:
        """The client's next mini-batch tree (numpy leaves)."""
        ...

    def eval_data(self) -> Any:
        """Held-out data in whatever form the task's FedModel evaluates."""
        ...


def _leafwise(fn, tree, *rest):
    """`fn` over the leaves of equal-structure dicts of arrays (a batch)."""
    if isinstance(tree, dict):
        return {k: _leafwise(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def scatter_put(index, reshape):
    """A `stage_chunk` scatter: writes one client's reshaped draw stack into
    the chunk buffer at a fixed fancy index, leaf-wise."""

    def put(batch: Batch, draws: Batch) -> None:
        _leafwise(lambda bl, dl: bl.__setitem__(index, reshape(dl)), batch, draws)

    return put


def stage_chunk(source, plan, alloc) -> Batch:
    """Bulk-stage one chunk of per-client batches.

    `plan` is an iterable of ``(client, count, put)``: each client's `count`
    draws are fetched with one `bulk_batches` read and scattered into the
    chunk buffer by ``put(batch, draws)`` (see `scatter_put`).  The buffer is
    allocated from the first draws: ``alloc(leaf) -> shape`` gives each
    zero-filled leaf's full chunk shape.  Returns None for an empty plan."""
    batch = None
    for client, count, put in plan:
        draws = bulk_batches(source, client, count)
        if batch is None:
            batch = _leafwise(lambda a: np.zeros(alloc(a), a.dtype), draws)
        put(batch, draws)
    return batch


def put_sharded(xs: dict, windows: dict, device) -> dict:
    """Move a staged chunk (a dict of numpy trees) to this rank's device,
    leaf by leaf: every leaf under ``xs[k]`` is cut to the index
    ``windows[k]`` (a tuple of slices) before its copy, and a key without a
    window goes whole.  So a rank copies only its client and cluster window
    of the batches and keys, and the global stacked batch never reaches one
    device.  uint32 key words travel as int32 of the same bits, as the
    executor's own staging does."""

    def put(a, index):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if index is not None:
            a = a[index]
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {k: _leafwise(lambda a, k=k: put(a, windows.get(k)), v) for k, v in xs.items()}


def bulk_batches(source, client: int, count: int) -> Batch:
    """`count` sequential draws for one client, stacked (count, B, ...).

    Uses the source's vectorized `next_batches` where it has one
    (`ArraySource`: one dataset gather for the whole chunk), else stacks
    `next_batch` calls; either way the draws and the stream position after
    them are those of `count` `next_batch` calls."""
    fast = getattr(source, "next_batches", None)
    if fast is not None:
        return fast(client, count)
    batches = [source.next_batch(client) for _ in range(count)]
    return _leafwise(lambda *leaves: np.stack(leaves), *batches)


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

    def fast_forward(self, draw_counts: list[int]) -> None:
        """Resume mid-run: advance each client's rng stream to an absolute
        batch-draw position by drawing and discarding indices, so the state
        equals that after as many live draws."""
        assert len(draw_counts) == self.num_clients
        for c, n in enumerate(draw_counts):
            delta = int(n) - self.draw_counts[c]
            assert delta >= 0, (f"client {c}: cannot rewind an rng stream "
                                f"({self.draw_counts[c]} -> {n}); reset() first")
            if delta:
                self.loaders[c].next_indices(delta)
                self.draw_counts[c] = int(n)

    def next_batch(self, client: int) -> dict:
        self.draw_counts[client] += 1
        x, y = self.loaders[client].next_batch()
        return {"x": x, "y": y}

    def next_batches(self, client: int, count: int) -> dict:
        """`count` sequential draws as stacked (count, B, ...) leaves: the
        rng state moves as under `count` `next_batch` calls, and the
        dataset is gathered once."""
        self.draw_counts[client] += count
        idx = self.loaders[client].next_indices(count).reshape(count, self.batch_size)
        return {"x": self.dataset.train_x[idx], "y": self.dataset.train_y[idx]}

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
