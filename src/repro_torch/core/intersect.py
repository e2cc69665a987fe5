"""The paper's intersection algorithms on the host (numpy), Section 3:

* :func:`intgroup`     — Alg. 1 + Alg. 2 (fixed-width partitions, 2 sets)
* :func:`rangroup`     — Alg. 3 / Alg. 4 (randomized partitions, k sets,
                          single-h inverted-mapping recovery)
* :func:`rangroupscan` — Alg. 5 (m filter images + scan recovery; the
                          practical algorithm), vectorized.  A search engine
                          without a device (``use_device=False``) serves
                          conjunctions with it.
* :func:`hashbin`      — Section 3.4 (skewed sizes; per-bin binary search).
                          The planner's §3.4 policy sends two-set queries
                          with an extreme size ratio here.

Each returns ``(result, Stats)``.  ``Stats`` carries implementation-
independent operation counters (group tuples examined and filtered, element
pairs, comparisons), equal to the JAX package's on the same inputs.  The
filter phases are vectorized numpy; IntGroup and RanGroup recover survivors
by walking the ``first/next`` inverted mappings in Python, so they suit
small sets only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from .partition import FixedWidthIndex, PrefixIndex, _first_next

__all__ = ["Stats", "intgroup", "rangroup", "rangroupscan", "hashbin"]


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


# --------------------------------------------------------------------------
# IntGroup — Section 3.1 (Algorithms 1 + 2)
# --------------------------------------------------------------------------

def _walk_inverted(idx, gi: int, y: int) -> List[int]:
    """h^{-1}(y, group gi) via the first/next threading (ordered access)."""
    lo, hi = idx.offsets[gi], idx.offsets[gi + 1]
    ys = idx.first_y[gi]
    pos = np.searchsorted(ys, y)
    if pos == len(ys) or ys[pos] != y:
        return []
    cur = int(idx.first_idx[gi][pos])
    out = []
    while cur != -1 and cur < hi:
        out.append(cur)
        cur = int(idx.nxt[cur])
    return out


def intgroup(A: FixedWidthIndex, B: FixedWidthIndex,
             recovery: str = "searchsorted") -> Tuple[np.ndarray, Stats]:
    """Algorithm 1: scan fixed-width groups in order, intersect overlapping
    pairs with IntersectSmall (Algorithm 2).

    recovery="inverted" walks the faithful first/next threaded mappings
    (Fig. 2); "searchsorted" recovers survivors with one vectorized binary
    search (values are globally sorted; a hit counts only inside the paired
    group's range) — C-speed, same results.
    """
    if A.w != B.w or A.family is not B.family:
        raise ValueError("both sets must share h")
    st = Stats("intgroup", 2, A.n + B.n)
    # --- vectorized Algorithm-1 pairing: group q of B overlaps group p of A
    # iff [lo_q, hi_q] ∩ [lo_p, hi_p] != ∅; overlapping q's are a contiguous
    # range per p because both sides are sorted (two-pointer walk, batched).
    qlo = np.searchsorted(B.hi, A.lo, side="left")
    qhi = np.searchsorted(B.lo, A.hi, side="right")
    counts = np.maximum(0, qhi - qlo)
    p_ids = np.repeat(np.arange(A.G), counts)
    q_ids = (np.arange(len(p_ids))
             - np.repeat(np.cumsum(counts) - counts, counts)) + np.repeat(qlo, counts)
    st.group_tuples = len(p_ids)
    # --- Algorithm 2, phase 1: H = h(A^p) AND h(B^q), vectorized
    Ha = A.images[p_ids, 0]                      # (P, W)
    Hb = B.images[q_ids, 0]
    H = Ha & Hb
    st.words_read = H.size * 2
    nz = np.bitwise_or.reduce(H, axis=1) != 0
    st.tuples_filtered = int((~nz).sum())
    st.tuples_survived = int(nz.sum())

    if recovery == "searchsorted":
        pa = A.padded_vals[p_ids[nz]]                    # (P, s)
        ma = A.mask[p_ids[nz]]
        flat = pa[ma]
        pair_of = np.repeat(np.arange(len(pa)), ma.sum(axis=1))
        st.elements_touched += len(flat)
        pos = np.searchsorted(B.values, flat).clip(max=B.n - 1)
        st.comparisons += len(flat) * max(1, int(math.log2(B.n + 1)))
        found = B.values[pos] == flat
        qf = q_ids[nz][pair_of]
        in_q = (pos >= B.offsets[qf]) & (pos < B.offsets[qf + 1])
        hits = flat[found & in_q]
        st.element_pairs = len(hits)
        result = np.unique(hits).astype(np.uint32)
        st.r = len(result)
        return result, st

    # --- Algorithm 2, phase 2: recover via inverted mappings per set bit y
    out: List[int] = []
    W = A.w // 32
    for p, q, h_pair in zip(p_ids[nz], q_ids[nz], H[nz]):
        for lane in range(W):
            word = int(h_pair[lane])
            while word:
                low = word & -word
                y = lane * 32 + low.bit_length() - 1
                word ^= low
                ia = _walk_inverted(A, int(p), y)
                ib = _walk_inverted(B, int(q), y)
                st.elements_touched += len(ia) + len(ib)
                # linear merge of the two short value-ordered lists
                va = A.values[ia]
                vb = B.values[ib]
                i = j = 0
                while i < len(va) and j < len(vb):
                    st.comparisons += 1
                    if va[i] == vb[j]:
                        out.append(int(va[i])); i += 1; j += 1
                        st.element_pairs += 1
                    elif va[i] < vb[j]:
                        i += 1
                    else:
                        j += 1
    result = np.unique(np.asarray(out, dtype=np.uint32))
    st.r = len(result)
    return result, st


# --------------------------------------------------------------------------
# RanGroup — Section 3.2 (Algorithms 3 + 4), single-h recovery
# --------------------------------------------------------------------------

def rangroup(indexes: Sequence[PrefixIndex]) -> Tuple[np.ndarray, Stats]:
    """Algorithm 4 (Algorithm 3 when k == 2): prefix-aligned groups, one
    word-image AND, recovery through the inverted mappings.

    The AND phase over all z_k is vectorized (one gather + AND per set, the
    memoized-partial-AND trick of Appendix A.3 is subsumed by reuse of the
    gathered rows); survivors are recovered via h^{-1} walks.
    """
    idxs = sorted(indexes, key=lambda s: s.t)
    k = len(idxs)
    st = Stats("rangroup", k, sum(s.n for s in idxs))
    tk = idxs[-1].t
    G = 1 << tk
    zk = np.arange(G, dtype=np.int64)
    H = idxs[-1].images[:, 0, :].copy()          # (G, W) — use h_1 only
    st.words_read += H.size
    z_of = []
    for s in idxs[:-1]:
        zi = zk >> (tk - s.t)
        z_of.append(zi)
        H &= s.images[zi, 0, :]
        st.words_read += H.size
    z_of.append(zk)
    st.group_tuples = G
    nz = np.bitwise_or.reduce(H, axis=1) != 0
    st.tuples_filtered = int((~nz).sum())
    st.tuples_survived = int(nz.sum())
    out: List[int] = []
    W = idxs[0].w // 32
    for row in np.nonzero(nz)[0]:
        h_row = H[row]
        for lane in range(W):
            word = int(h_row[lane])
            while word:
                low = word & -word
                y = lane * 32 + low.bit_length() - 1
                word ^= low
                lists = []
                for s, zi in zip(idxs, z_of):
                    ii = _walk_inverted_prefix(s, int(zi[row]), y)
                    st.elements_touched += len(ii)
                    lists.append(s.values[ii])
                common = lists[0]
                for other in lists[1:]:
                    st.comparisons += len(common) + len(other)
                    common = np.intersect1d(common, other)
                    if len(common) == 0:
                        break
                out.extend(int(v) for v in common)
                st.element_pairs += len(common)
    result = np.unique(np.asarray(out, dtype=np.uint32))
    st.r = len(result)
    return result, st


def _walk_inverted_prefix(idx: PrefixIndex, z: int, y: int) -> List[int]:
    """h^{-1}(y, L^z) for a PrefixIndex with inverted mappings attached."""
    if not hasattr(idx, "_nxt"):
        _attach_inverted(idx)
    lo, hi = idx.offsets[z], idx.offsets[z + 1]
    ys = idx._first_y[z]
    pos = np.searchsorted(ys, y)
    if pos == len(ys) or ys[pos] != y:
        return []
    cur = int(idx._first_idx[z][pos])
    out = []
    while cur != -1 and cur < hi:
        out.append(cur)
        cur = int(idx._nxt[cur])
    return out


def _attach_inverted(idx: PrefixIndex) -> None:
    """Lazily build the Fig.-2 first/next threading for a PrefixIndex
    (only RanGroup's recovery needs it; RanGroupScan does not — §3.3)."""
    h_vals = np.asarray(idx.family.apply(idx.values, 0))
    nxt, first_y, first_idx = _first_next(h_vals, idx.offsets, idx.w)
    idx._nxt = nxt
    idx._first_y = first_y
    idx._first_idx = first_idx


# --------------------------------------------------------------------------
# RanGroupScan — Section 3.3 (Algorithm 5), fully vectorized
# --------------------------------------------------------------------------

def rangroupscan(indexes: Sequence[PrefixIndex],
                 recovery: str = "searchsorted") -> Tuple[np.ndarray, Stats]:
    """Algorithm 5: skip a group tuple if ANY of the m image-ANDs is empty;
    intersect survivors by scanning the raw groups.

    Two equivalent survivor-recovery executions (same elements touched,
    same results — the skip structure is the algorithm; recovery is an
    execution detail):

    * "allpairs"     — masked all-pairs equality on the padded dense groups;
                       the branch-free formulation of the device's phase-2
                       kernel (``kernels/group_intersect.py``).
    * "searchsorted" — one vectorized binary search of every survivor
                       element into the other sets' g-sorted key arrays
                       (groups are contiguous g-intervals, so the global
                       search visits exactly the aligned group).  This is
                       the host's fast form: one numpy call replaces the
                       broadcast compare.  The default.
    """
    idxs = sorted(indexes, key=lambda s: s.t)
    k = len(idxs)
    st = Stats("rangroupscan", k, sum(s.n for s in idxs))
    tk = idxs[-1].t
    G = 1 << tk
    zk = np.arange(G, dtype=np.int64)
    z_of = [zk >> (tk - s.t) for s in idxs]
    # --- filter phase: pass only if ALL m image-ANDs are non-empty (line 3).
    # One fused AND pass over the (G, m, W) image arrays; aligned gathers are
    # skipped when t_i == t_k (identity).
    H = idxs[-1].images
    st.words_read += H.size
    for s, zi in zip(idxs[:-1], z_of[:-1]):
        im = s.images if s.t == tk else s.images[zi]
        st.words_read += im.size
        H = H & im
    nz_any = np.bitwise_or.reduce(H, axis=2) != 0        # (G, m)
    pass_mask = nz_any.all(axis=1)
    st.group_tuples = G
    st.tuples_survived = int(pass_mask.sum())
    st.tuples_filtered = G - st.tuples_survived
    surv = np.nonzero(pass_mask)[0]
    if len(surv) == 0:
        return np.empty(0, dtype=np.uint32), st

    if recovery == "searchsorted":
        # Gather surviving groups of the smallest set as (flat) g-keys, then
        # one vectorized binary search per other set.  Prefix alignment
        # guarantees a hit can only occur inside the aligned group, so a
        # global search over the g-sorted keys is exact.
        keys = idxs[0].padded_keys[z_of[0][surv]]       # (S, g0)
        mask = idxs[0].mask[z_of[0][surv]]
        flat = keys[mask]                               # true elements only
        st.elements_touched += len(flat)
        keep = np.ones(len(flat), dtype=bool)
        for s in idxs[1:]:
            pos = np.searchsorted(s.g_keys, flat).clip(max=s.n - 1)
            st.comparisons += len(flat) * max(1, int(math.log2(s.n + 1)))
            keep &= s.g_keys[pos] == flat
        hits = flat[keep]
        st.element_pairs = len(hits)
        # map g-keys back to original values; unique() dedups base elements
        # that appeared under several surviving z_k children (t_0 < t_k)
        pos0 = np.searchsorted(idxs[0].g_keys, np.unique(hits))
        result = np.sort(idxs[0].values[pos0]).astype(np.uint32)
        st.r = len(result)
        return result, st

    # --- "allpairs" recovery: masked all-pairs match
    base_vals = idxs[0].padded_vals[z_of[0][surv]]      # (S, g0)
    keep = idxs[0].mask[z_of[0][surv]]
    st.elements_touched += int(keep.sum())
    for s, zi in zip(idxs[1:], z_of[1:]):
        other = s.padded_vals[zi[surv]]                 # (S, gi)
        st.elements_touched += int(s.mask[zi[surv]].sum())
        st.comparisons += keep.sum() * other.shape[1]
        keep &= (base_vals[:, :, None] == other[:, None, :]).any(axis=2)
    result = np.unique(base_vals[keep]).astype(np.uint32)
    st.r = len(result)
    st.element_pairs = int(keep.sum())
    return result, st


# --------------------------------------------------------------------------
# HashBin — Section 3.4
# --------------------------------------------------------------------------

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
