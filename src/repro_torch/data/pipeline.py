"""Seeded synthetic corpus: Zipf documents and their inverted index.

The same generator as the JAX package's ``repro.data.pipeline``, so both
packages see the same postings from the same seed.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["zipf_corpus", "inverted_index"]


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
