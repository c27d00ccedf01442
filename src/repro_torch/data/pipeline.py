"""Deterministic synthetic token streams for training: a copy of the
reference's ``TokenPipeline`` (``repro/data/pipeline.py``), numpy only, so
the same seed gives the same batches bit for bit.

Synthetic text is a structured Markov-ish mixture (not uniform noise) so
training loss actually decreases: each document draws a latent "topic"
that biases a per-position transition rule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_topics: int = 16

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)  # active vocab subset
        self._active = v
        self._topic_bias = rng.integers(0, v, size=(self.n_topics, 8))
        self._step = 0

    def _sample_doc(self, rng: np.random.Generator) -> np.ndarray:
        v = self._active
        topic = rng.integers(0, self.n_topics)
        bias = self._topic_bias[topic]
        toks = np.empty(self.seq_len + 1, np.int32)
        toks[0] = rng.integers(0, v)
        for t in range(1, self.seq_len + 1):
            if rng.random() < 0.6:
                # deterministic-ish continuation: next token depends on
                # previous token and topic (learnable structure)
                toks[t] = (toks[t - 1] * 31 + bias[t % 8]) % v
            else:
                toks[t] = rng.integers(0, v)
        return toks

    def batch(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Returns {"tokens": (B, L), "labels": (B, L)} — labels are the
        next-token shift."""
        step = self._step if step is None else step
        self._step = step + 1
        rng = np.random.default_rng((self.seed << 20) ^ step)
        docs = np.stack([self._sample_doc(rng)
                         for _ in range(self.batch_size)])
        return {"tokens": docs[:, :-1], "labels": docs[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()
