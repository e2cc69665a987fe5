"""Competitor algorithms from Section 4 — every baseline the paper compares.

All operate on sorted uint32 numpy arrays, on the host, as the JAX
package's copies do, with the same results and operation counts.  Where
the algorithm is a vectorizable primitive (Merge via sorted intersect, SvS
via galloping searchsorted, Lookup via bucketed searchsorted, Hash via a
C-backed hash container) it is vectorized numpy.  SkipList, BaezaYates and
BPP are serial pointer walks, written as Python loops; their operation
counts are reported beside their times.

Each function returns ``(result, stats_dict)``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "merge", "svs_gallop", "hash_lookup", "lookup_st", "baezayates",
    "skiplist", "bpp", "BASELINES",
]


def merge(sets: Sequence[np.ndarray]) -> Tuple[np.ndarray, Dict]:
    """Linear merge (parallel scan) — the inverted-index workhorse.

    np.intersect1d with assume_unique on pre-sorted inputs is the C
    equivalent of the branch-minimized scan the paper implements.
    """
    out = sets[0]
    comparisons = 0
    for s in sets[1:]:
        comparisons += len(out) + len(s)
        out = np.intersect1d(out, s, assume_unique=True)
        if len(out) == 0:
            break
    return out.astype(np.uint32), {"comparisons": comparisons}


def svs_gallop(sets: Sequence[np.ndarray]) -> Tuple[np.ndarray, Dict]:
    """SvS with galloping/binary search: intersect smallest-first by probing
    each candidate into the next list (Demaine et al. / standard SvS)."""
    order = sorted(sets, key=len)
    out = order[0]
    comparisons = 0
    for s in order[1:]:
        if len(out) == 0:
            break
        pos = np.searchsorted(s, out)
        comparisons += len(out) * max(1, int(math.ceil(math.log2(len(s) + 1))))
        found = (pos < len(s)) & (s[np.minimum(pos, len(s) - 1)] == out)
        out = out[found]
    return out.astype(np.uint32), {"comparisons": comparisons}


def hash_lookup(sets: Sequence[np.ndarray]) -> Tuple[np.ndarray, Dict]:
    """Hash: iterate the smallest set, probe hash tables of the others.

    numpy's np.isin with a dict-backed probe is not available; we use
    python sets (C hash table) — the per-probe indirection cost the paper
    describes is exactly what this measures.
    """
    order = sorted(sets, key=len)
    tables = [set(s.tolist()) for s in order[1:]]
    out = [x for x in order[0].tolist() if all(x in t for t in tables)]
    return (np.asarray(sorted(out), dtype=np.uint32),
            {"probes": len(order[0]) * len(tables)})


def lookup_st(sets: Sequence[np.ndarray], bucket: int = 32) -> Tuple[np.ndarray, Dict]:
    """Sanders/Transier two-level 'Lookup' (ALENEX'07): bucket doc-ids by
    id // B; per element of the smaller set, scan the matching bucket of the
    larger.  Vectorized: bucket boundaries via searchsorted, then a bounded
    per-bucket scan implemented as a clipped window equality test."""
    order = sorted(sets, key=len)
    out = order[0]
    touched = 0
    for s in order[1:]:
        if len(out) == 0:
            break
        # positions of each candidate's bucket in s; window must cover the
        # largest bucket for exactness
        b_lo = np.searchsorted(s, (out // bucket) * bucket)
        bounds = np.searchsorted(s, np.arange(0, int(s[-1]) + bucket + 1, bucket))
        width = max(1, int(np.diff(bounds).max())) if len(bounds) > 1 else len(s)
        idx = b_lo[:, None] + np.arange(width)[None, :]
        window = s[np.minimum(idx, len(s) - 1)]
        touched += window.size
        found = (window == out[:, None]).any(axis=1)
        out = out[found]
    return out.astype(np.uint32), {"elements_touched": touched}


def baezayates(sets: Sequence[np.ndarray]) -> Tuple[np.ndarray, Dict]:
    """Baeza-Yates divide & conquer (CPM'04), generalized to k sets by
    iterative pairwise application smallest-first (as in [5])."""
    stats = {"comparisons": 0}

    def by_pair(a: np.ndarray, b: np.ndarray, out: List[int]):
        # recursion on the median of the smaller list
        if len(a) == 0 or len(b) == 0:
            return
        if len(a) > len(b):
            a, b = b, a
        mid = len(a) // 2
        x = a[mid]
        pos = int(np.searchsorted(b, x))
        stats["comparisons"] += max(1, int(math.ceil(math.log2(len(b) + 1))))
        if pos < len(b) and b[pos] == x:
            out.append(int(x))
        by_pair(a[:mid], b[:pos], out)
        by_pair(a[mid + 1:], b[pos:], out)

    order = sorted(sets, key=len)
    cur = order[0]
    for s in order[1:]:
        acc: List[int] = []
        by_pair(cur, s, acc)
        cur = np.asarray(sorted(acc), dtype=np.uint32)
        if len(cur) == 0:
            break
    return cur, stats


class _SkipList:
    """Static skip list (Pugh cookbook): level-i pointers skip 2^i nodes.
    Built over a sorted array; supports seek(x) from a moving finger."""

    def __init__(self, arr: np.ndarray, p: int = 2):
        self.arr = arr
        self.levels: List[np.ndarray] = []
        step = p
        while step < len(arr):
            self.levels.append(np.arange(0, len(arr), step))
            step *= p

    def seek(self, x: int, start: int) -> int:
        """first index >= start with arr[idx] >= x; counts comparisons."""
        pos = start
        comps = 0
        for lvl in reversed(self.levels):
            # advance along this level while next skip target < x
            i = np.searchsorted(lvl, pos)
            while i < len(lvl) and self.arr[lvl[i]] < x:
                pos = int(lvl[i]); i += 1; comps += 1
        while pos < len(self.arr) and self.arr[pos] < x:
            pos += 1; comps += 1
        return pos, comps


def skiplist(sets: Sequence[np.ndarray]) -> Tuple[np.ndarray, Dict]:
    order = sorted(sets, key=len)
    base, rest = order[0], order[1:]
    lists = [_SkipList(s) for s in rest]
    fingers = [0] * len(rest)
    out = []
    comparisons = 0
    for x in base.tolist():
        ok = True
        for li, sl in enumerate(lists):
            pos, c = sl.seek(x, fingers[li])
            comparisons += c + 1
            fingers[li] = pos
            if pos >= len(sl.arr) or sl.arr[pos] != x:
                ok = False
                break
        if ok:
            out.append(x)
    return np.asarray(out, dtype=np.uint32), {"comparisons": comparisons}


def bpp(sets: Sequence[np.ndarray], w: int = 64) -> Tuple[np.ndarray, Dict]:
    """Bille-Pagh-Pagh (ISAAC'07), simplified as in the paper's Section 4:
    map elements through h to w/log^2(w)-bit packed approximations, AND the
    packed images, then verify candidates.  Implemented at the word level
    with numpy packing (the heavy bit-trickery is what makes it slow)."""
    logw2 = max(1, int(math.log2(w)) ** 2)
    field = max(2, w // logw2)  # bits per packed slot — 'small' by design
    nbuckets = 1 << 12
    order = sorted(sets, key=len)
    # hash into buckets; per bucket keep a field-bit signature word
    stats = {"words": 0}
    sigs = []
    for s in order:
        h = (s.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - 12)
        sig = np.zeros(nbuckets, dtype=np.uint64)
        sub = (s.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)) >> np.uint64(64 - 6)
        np.bitwise_or.at(sig, h.astype(np.int64),
                         np.uint64(1) << (sub % np.uint64(min(64, field * 8))))
        sigs.append(sig)
        stats["words"] += nbuckets
    mask = sigs[0]
    for sg in sigs[1:]:
        mask = mask & sg
    # verify: only elements whose bucket-signature bit survived
    def survives(s):
        h = (s.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - 12)
        sub = (s.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)) >> np.uint64(64 - 6)
        bit = np.uint64(1) << (sub % np.uint64(min(64, field * 8)))
        return (mask[h.astype(np.int64)] & bit) != 0
    cands = [s[survives(s)] for s in order]
    out, st2 = merge(cands)
    stats.update(st2)
    return out, stats


BASELINES = {
    "Merge": merge,
    "SvS": svs_gallop,
    "Hash": hash_lookup,
    "Lookup": lookup_st,
    "BaezaYates": baezayates,
    "SkipList": skiplist,
    "BPP": bpp,
}
