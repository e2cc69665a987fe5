"""Shingle-based near-duplicate detection with the paper's RanGroupScan.

Each document is reduced to a set of token k-gram (shingle) hashes; a pair
of documents is a near-dup candidate when their shingle sets intersect in
more than ``threshold`` elements.  The candidate search is exactly a batch
of set intersections, executed with RanGroupScan — the word-representation
filter skips the (overwhelmingly common) empty-overlap pairs, which is the
paper's r << n regime in its purest form.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.hashing import default_permutation, random_hash_family
from ..core.intersect import rangroupscan
from ..core.partition import preprocess_prefix


def shingles(tokens: np.ndarray, k: int = 5) -> np.ndarray:
    """Token k-grams hashed to uint32 (sorted unique)."""
    if len(tokens) < k:
        return np.unique(tokens.astype(np.uint32))
    windows = np.lib.stride_tricks.sliding_window_view(tokens.astype(np.uint64), k)
    mix = np.uint64(0x100000001B3)
    h = np.zeros(len(windows), dtype=np.uint64)
    for i in range(k):
        h = (h ^ windows[:, i]) * mix & np.uint64(0xFFFFFFFFFFFFFFFF)
    return np.unique((h >> np.uint64(32)).astype(np.uint32))


class Deduplicator:
    """Documents as preprocessed shingle sets; pair overlaps by
    :func:`~repro_torch.core.intersect.rangroupscan` on the host."""

    def __init__(self, w: int = 256, m: int = 2, seed: int = 0):
        self.family = random_hash_family(m, w, seed=seed)
        self.perm = default_permutation(seed)
        self.w, self.m = w, m
        self.indexes = {}

    def add(self, doc_id: int, tokens: np.ndarray, k: int = 5) -> None:
        sh = shingles(tokens, k)
        self.indexes[doc_id] = preprocess_prefix(
            sh, w=self.w, m=self.m, family=self.family, perm=self.perm)

    def overlap(self, a: int, b: int) -> int:
        res, _ = rangroupscan([self.indexes[a], self.indexes[b]])
        return len(res)

    def near_dups(self, threshold: float = 0.5) -> List[Tuple[int, int, float]]:
        """All pairs with Jaccard >= threshold (quadratic candidate loop —
        the per-pair test is the engine's fast path; banding/LSH pre-filters
        are orthogonal and omitted)."""
        ids = sorted(self.indexes)
        out = []
        for i, a in enumerate(ids):
            for b in ids[i + 1:]:
                inter = self.overlap(a, b)
                union = self.indexes[a].n + self.indexes[b].n - inter
                j = inter / max(1, union)
                if j >= threshold:
                    out.append((a, b, j))
        return out
