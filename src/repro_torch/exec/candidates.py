"""Hash-bin candidate pre-filter of the suggestion path (host, numpy).

Scoring a probe against every corpus set on the device would make a
suggestion O(corpus) in device work.  The paper's HashBin structure (§3.3)
gives each set a w-bin occupancy signature for free: hash ``h_0`` maps
elements into ``[0, w)``, and two sets that share an element occupy the same
bin under the same family, so ``popcount(bins(probe) & bins(candidate)) >=
1`` for every candidate with a non-empty intersection.  The pre-filter keeps
the candidates whose shared-bin count reaches ``min_shared_bins``; at the
default of 1 it never drops a candidate with a true overlap, so the device's
count pass stays exact over what it keeps.

Kept candidates order by ``(-shared_bins, id)``, so an optional
``max_candidates`` cap keeps the most plausible prefix.  A cap can drop true
positives; exact callers leave it ``None``.

Counters: ``EXEC_COUNTERS["suggest_prefilter_in"]`` counts candidates
examined, ``["suggest_prefilter_kept"]`` candidates kept.

A numpy copy of the JAX package's ``repro.exec.candidates``: same
signatures, same order, same counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.engine import EXEC_COUNTERS
from ..core.hashing import HashFamily

__all__ = ["CandidateIndex"]


class CandidateIndex:
    """Per-set hash-bin occupancy bitmaps and the shared-bin screen.

    :meth:`add` folds one set's values through the family's ``h_0`` into a
    packed ``w``-bit row; :meth:`candidates` screens the whole corpus
    against one probe with one vectorized AND and popcount.  All sets share
    one :class:`~repro_torch.core.hashing.HashFamily` (the screen's
    soundness needs a common ``h_0``).
    """

    def __init__(self, family: HashFamily):
        self.family = family
        self.w = int(family.w)
        self.words = self.w // 32
        if self.words * 32 != self.w:
            raise ValueError("w must be a multiple of 32")
        self._ids: List = []
        self._pos: Dict = {}
        self._rows: List[np.ndarray] = []
        self._matrix: Optional[np.ndarray] = None  # (n_sets, words) cache

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, set_id) -> bool:
        return set_id in self._pos

    def _signature(self, values: np.ndarray) -> np.ndarray:
        bins = np.asarray(
            self.family.apply(np.asarray(values, np.uint32), 0), np.uint32)
        row = np.zeros(self.words, np.uint32)
        np.bitwise_or.at(row, bins >> np.uint32(5),
                         np.uint32(1) << (bins & np.uint32(31)))
        return row

    def add(self, set_id, values: Sequence[int]) -> None:
        """Register (or refresh) one corpus set's occupancy signature."""
        row = self._signature(np.asarray(values, np.uint32))
        if set_id in self._pos:
            self._rows[self._pos[set_id]] = row
        else:
            self._pos[set_id] = len(self._ids)
            self._ids.append(set_id)
            self._rows.append(row)
        self._matrix = None

    def _stacked(self) -> np.ndarray:
        if self._matrix is None:
            self._matrix = (np.stack(self._rows) if self._rows
                            else np.zeros((0, self.words), np.uint32))
        return self._matrix

    def candidates(
        self,
        probe_values: Sequence[int],
        exclude=None,
        min_shared_bins: int = 1,
        max_candidates: Optional[int] = None,
    ) -> List:
        """Screen the corpus against one probe; returns the kept set ids,
        ordered by ``(-shared_bins, id)``.  ``exclude`` (the probe's own
        id) is never returned; ``max_candidates`` keeps the most-shared
        prefix."""
        matrix = self._stacked()
        EXEC_COUNTERS.bump("suggest_prefilter_in", len(self._ids))
        if not len(self._ids):
            return []
        row = self._signature(np.asarray(probe_values, np.uint32))
        inter = matrix & row[None, :]
        shared = np.unpackbits(
            inter.view(np.uint8), axis=1).sum(axis=1).astype(np.int64)
        keep = np.nonzero(shared >= int(min_shared_bins))[0]
        kept = sorted((int(-shared[i]), self._ids[i]) for i in keep
                      if self._ids[i] != exclude)
        if max_candidates is not None:
            kept = kept[:int(max_candidates)]
        EXEC_COUNTERS.bump("suggest_prefilter_kept", len(kept))
        return [set_id for _, set_id in kept]
