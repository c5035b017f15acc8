"""Data pipeline: deterministic synthetic corpus + batching + microbatching.

The paper trains on Wikipedia-En; offline we use a synthetic Zipf-Markov
corpus with enough structure for the loss to fall (bigram dependencies) so
convergence comparisons (Fig. 6) are meaningful.  Data nodes each own a
disjoint shard (paper Sec. III: data nodes hold the training data).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int               # per data node, per iteration
    microbatch_size: int
    seed: int = 0


class SyntheticCorpus:
    """Zipf unigram + sticky bigram Markov chain: learnable structure."""

    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2,
                 stickiness: float = 0.7):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = ranks ** (-zipf_a)
        self.unigram /= self.unigram.sum()
        self.stickiness = stickiness
        # each token deterministically prefers a successor
        self.successor = self.rng.permutation(vocab_size)

    def sample(self, n_tokens: int) -> np.ndarray:
        out = np.empty(n_tokens, dtype=np.int32)
        out[0] = self.rng.choice(self.vocab, p=self.unigram)
        stick = self.rng.uniform(size=n_tokens) < self.stickiness
        rand = self.rng.choice(self.vocab, p=self.unigram, size=n_tokens)
        for i in range(1, n_tokens):
            out[i] = self.successor[out[i - 1]] if stick[i] else rand[i]
        return out


class DataNodeShard:
    """One data node's stream of (tokens, labels) batches."""

    def __init__(self, cfg: DataConfig, shard_id: int, num_shards: int):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg.vocab_size,
                                      seed=cfg.seed * 1000 + shard_id)

    def next_batch(self) -> dict:
        c = self.cfg
        toks = self.corpus.sample(c.batch_size * (c.seq_len + 1))
        toks = toks.reshape(c.batch_size, c.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def microbatches(self) -> List[dict]:
        b = self.next_batch()
        n = self.cfg.batch_size // self.cfg.microbatch_size
        return [{k: v[i * self.cfg.microbatch_size:(i + 1) * self.cfg.microbatch_size]
                 for k, v in b.items()} for i in range(n)]
