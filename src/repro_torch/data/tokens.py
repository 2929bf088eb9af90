"""Synthetic LM token pipeline (the Markov chain of the reference's
`data/tokens.py`, which `TokenSource` samples; the draws are the same numpy
streams).

Generates structured (not uniform-random) token streams so that ~100M-scale
training in examples/ actually reduces loss: a first-order Markov chain over
the vocabulary with a small number of latent "topics".
"""
from __future__ import annotations

import numpy as np


def _markov_tables(vocab: int, topics: int, branch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(topics, vocab, branch), dtype=np.int64)
    return succ


class MarkovTokens:
    def __init__(self, vocab_size: int, *, topics: int = 8, branch: int = 4, seed: int = 0):
        self.vocab = vocab_size
        self.succ = _markov_tables(vocab_size, topics, branch, seed)
        self.topics = topics
        self.branch = branch

    def sample(self, rng: np.random.Generator, batch: int, seq_len: int) -> np.ndarray:
        topic = rng.integers(0, self.topics, size=batch)
        return self.sample_topics(rng, topic, seq_len)

    def sample_topics(self, rng: np.random.Generator, topic: np.ndarray, seq_len: int
                      ) -> np.ndarray:
        """Walk the chain with a *given* per-row topic assignment — the hook
        non-IID federated sources use to skew each client's topic mixture."""
        batch = len(topic)
        out = np.empty((batch, seq_len), dtype=np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        choices = rng.integers(0, self.branch, size=(batch, seq_len))
        for t in range(1, seq_len):
            out[:, t] = self.succ[topic, out[:, t - 1], choices[:, t]]
        return out


def synthetic_lm_batch(vocab_size: int, batch: int, seq_len: int, *, seed: int = 0
                       ) -> dict[str, np.ndarray]:
    """One (tokens, labels) LM batch; labels are next-token shifted."""
    gen = MarkovTokens(min(vocab_size, 32_768), seed=seed)
    rng = np.random.default_rng(seed)
    toks = gen.sample(rng, batch, seq_len + 1) % vocab_size
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
