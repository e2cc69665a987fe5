"""Host intersection algorithms the online policy routes to (numpy).

* :func:`hashbin` — Section 3.4 (skewed sizes; per-bin binary search).  The
  planner's §3.4 policy sends two-set queries with an extreme size ratio
  here instead of to the device.

Each returns ``(result, Stats)``.  ``Stats`` carries implementation-
independent operation counters.  The host RanGroupScan/RanGroup/IntGroup
algorithms of the JAX package are not ported yet: the port always has a
device (CUDA or an explicit CPU), so no plan routes to them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .partition import PrefixIndex

__all__ = ["Stats", "hashbin"]


@dataclasses.dataclass
class Stats:
    algorithm: str
    k: int
    n_total: int
    r: int = 0
    group_tuples: int = 0        # tuples (pairs) of small groups examined
    tuples_filtered: int = 0     # tuples whose word-AND proved emptiness
    tuples_survived: int = 0     # tuples that reached the recovery phase
    element_pairs: int = 0       # |I| — element pairs sharing a hash value
    elements_touched: int = 0    # elements read during recovery
    comparisons: int = 0         # value comparisons (merge/binary search)
    words_read: int = 0          # packed bitmap words read by the filter

    @property
    def filter_rate(self) -> float:
        empty = max(1, self.group_tuples)
        return self.tuples_filtered / empty


def hashbin(A: PrefixIndex, B: PrefixIndex) -> Tuple[np.ndarray, Stats]:
    """Per-bin binary search of each x in the smaller set (A) inside the
    matching bin of B, in g-order (Appendix A.6.1).

    Execution is the vectorized global ``searchsorted`` over B's g-sorted
    keys (bins are contiguous intervals, so the per-bin search visits the
    same elements); ``comparisons`` is counted per bin as
    ``|A^z| * ceil(log2(|B^z| + 1))``.
    """
    if A.n > B.n:
        A, B = B, A
    st = Stats("hashbin", 2, A.n + B.n)
    t = max(0, math.ceil(math.log2(max(1, A.n))))
    # bin boundaries at resolution t, computed on demand from sorted g-keys
    bounds = ((np.arange((1 << t) + 1, dtype=np.uint64) << (32 - t))
              .astype(np.uint32) if t else np.array([0, 0], np.uint32))
    if t:
        offA = np.searchsorted(A.g_keys, bounds[:-1]).astype(np.int64)
        offB = np.searchsorted(B.g_keys, bounds[:-1]).astype(np.int64)
        cntA = np.diff(np.concatenate([offA, [A.n]]))
        cntB = np.diff(np.concatenate([offB, [B.n]]))
        st.comparisons = int(np.sum(cntA * np.ceil(np.log2(cntB + 1))))
    else:
        st.comparisons = int(A.n * math.ceil(math.log2(B.n + 1)))
    pos = np.searchsorted(B.g_keys, A.g_keys).clip(max=B.n - 1)
    found = B.g_keys[pos] == A.g_keys
    result = np.sort(A.values[found]).astype(np.uint32)
    st.r = len(result)
    st.elements_touched = A.n
    st.group_tuples = 1 << t
    return result, st
