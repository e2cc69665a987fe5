"""Deterministic, stateless data: the synthetic LM stream and a seeded
Zipf corpus with its inverted index.

The same generators as the JAX package's ``repro.data.pipeline``, so both
packages see the same batches and postings from the same seed.
``SyntheticLMData.batch_at(step)`` is a pure function of (seed, step):
resume after a restart is exact with no iterator state to persist beyond
the step counter (recorded in the checkpoint manifest).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterator, List, Sequence

import numpy as np

__all__ = ["SyntheticLMData", "zipf_corpus", "inverted_index"]


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    mask64 = np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & mask64
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & mask64
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``tokens`` and next-token ``labels``, (batch, seq) int32."""
        # Learnable-but-unbounded stream: within each 16-token run the next
        # token is the affine map (31*t + 7) mod V of the previous one; run
        # starts are splitmix-hashed (deterministic in (seed, step, index)).
        n = self.batch * (self.seq + 1)
        base = np.arange(n, dtype=np.uint64) + np.uint64(step) * np.uint64(n) \
            + (np.uint64(self.seed) << np.uint64(40))
        starts = (_splitmix(base) % np.uint64(self.vocab)).astype(np.int64)
        starts = starts.reshape(self.batch, self.seq + 1)
        toks = starts.copy()
        pos_in_run = np.arange(self.seq + 1) % 16
        for j in range(1, self.seq + 1):
            if pos_in_run[j] == 0:
                continue
            toks[:, j] = (toks[:, j - 1] * 31 + 7) % self.vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def zipf_corpus(n_docs: int, vocab: int = 50000, mean_len: int = 200,
                alpha: float = 1.2, seed: int = 0) -> List[np.ndarray]:
    """Documents as arrays of term-ids with a Zipf unigram distribution —
    realistically skewed posting-list lengths for the search engine
    (frequent terms -> long lists, as in the paper's Bing data)."""
    rng = np.random.default_rng(seed)
    docs = []
    lengths = rng.poisson(mean_len, size=n_docs).clip(min=8)
    for i in range(n_docs):
        terms = rng.zipf(alpha, size=lengths[i])
        docs.append(np.unique((terms - 1) % vocab).astype(np.uint32))
    return docs


def inverted_index(docs: Sequence[np.ndarray]) -> Dict[int, np.ndarray]:
    """term -> sorted array of doc ids."""
    post = defaultdict(list)
    for doc_id, terms in enumerate(docs):
        for t in terms.tolist():
            post[t].append(doc_id)
    return {t: np.asarray(sorted(ids), dtype=np.uint32)
            for t, ids in post.items()}
