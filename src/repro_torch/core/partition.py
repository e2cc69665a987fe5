"""Pre-processing stage: partition sets into small groups (Sections 3.1-3.3).

* :class:`FixedWidthIndex` — Section 3.1 (IntGroup): a sorted set cut into
  consecutive rank ranges of ``sqrt(w)`` elements, with per-group [min, max]
  ranges, word images under ``h`` and the ``first/next`` threaded inverted
  mappings ``h^{-1}(y, L^j)``.
* :class:`PrefixIndex` — Sections 3.2/3.3 (RanGroup / RanGroupScan /
  HashBin): elements ordered by the permutation ``g``; group ``L^z`` holds
  the elements whose ``t``-bit prefix ``g_t(x)`` equals ``z``.  It is stored
  both as CSR (host algorithms) and as a dense padded ``(2^t, gmax)`` matrix
  (the device layout; padding is the sentinel 0xFFFFFFFF, which never
  equals a real element).
* :class:`MultiResolutionIndex` — Section 3.2.1: every power-of-two
  resolution ``t = 0..ceil(log2 n)`` of one PrefixIndex in O(n) space.

The offline stage is host-side numpy, as in the JAX package, and gives
byte-identical arrays from the same inputs and seed.  Device mirrors are
made by ``core.engine.DeviceSet``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from .bitmaps import build_images_chunked
from .hashing import (
    BitMixPermutation, HashFamily, default_permutation, random_hash_family,
)

__all__ = [
    "FixedWidthIndex",
    "PrefixIndex",
    "MultiResolutionIndex",
    "choose_t",
    "preprocess_fixed",
    "preprocess_prefix",
    "preprocess_multiresolution",
    "prefix_index_from_arrays",
]

SENTINEL = np.uint32(0xFFFFFFFF)


def choose_t(n: int, w: int) -> int:
    """t_i = ceil(log2(n_i / sqrt(w))) — Theorems 3.6/3.7/3.9."""
    if n <= 1:
        return 0
    return max(0, math.ceil(math.log2(max(1.0, n / math.sqrt(w)))))


def _pad_groups(flat: np.ndarray, offsets: np.ndarray, gmax: Optional[int] = None):
    """CSR -> dense padded (G, gmax) + mask."""
    G = len(offsets) - 1
    counts = np.diff(offsets)
    if gmax is None:
        gmax = int(counts.max()) if G else 1
        gmax = max(8, int(8 * math.ceil(gmax / 8)))  # align the pad to 8
    dense = np.full((G, gmax), SENTINEL, dtype=np.uint32)
    mask = np.zeros((G, gmax), dtype=bool)
    # vectorized scatter: position of each element within its group
    if len(flat):
        group_of = np.repeat(np.arange(G), counts)
        within = np.arange(len(flat)) - np.repeat(offsets[:-1], counts)
        dense[group_of, within] = flat
        mask[group_of, within] = True
    return dense, mask, gmax


def _first_next(h_vals: np.ndarray, offsets: np.ndarray, w: int):
    """Faithful inverted mappings (Fig. 2): ``next`` pointers threading equal
    hash values in storage order, plus per-group CSR of (y, first_index).

    The paper packs ``first(y, L^z)`` into O(log|L^z|) bits; here the
    indices sit in a CSR keyed by the hash values present (<= |L^z| entries
    per group, O(n) total).
    """
    n = len(h_vals)
    nxt = np.full(n, -1, dtype=np.int64)
    # next same-hash element to the right, computed per hash bucket globally;
    # group boundaries are handled at query time via offsets.
    order = np.lexsort((np.arange(n), h_vals))  # stable by (h, position)
    sorted_h = h_vals[order]
    same = sorted_h[1:] == sorted_h[:-1]
    nxt[order[:-1][same]] = order[1:][same]
    # per-group first occurrence of each y
    G = len(offsets) - 1
    first_y: List[np.ndarray] = []
    first_idx: List[np.ndarray] = []
    for gi in range(G):
        lo, hi = offsets[gi], offsets[gi + 1]
        hs = h_vals[lo:hi]
        ys, first_pos = np.unique(hs, return_index=True)
        first_y.append(ys.astype(np.uint32))
        first_idx.append((first_pos + lo).astype(np.int64))
    return nxt, first_y, first_idx


@dataclasses.dataclass
class FixedWidthIndex:
    """Section 3.1 structure: rank-partition of a sorted set."""

    values: np.ndarray        # (n,) uint32, sorted ascending
    group_size: int           # s (= sqrt(w) by default)
    padded_vals: np.ndarray   # (G, s) sentinel-padded
    mask: np.ndarray          # (G, s) bool
    offsets: np.ndarray       # (G+1,)
    lo: np.ndarray            # (G,) inf of each group
    hi: np.ndarray            # (G,) sup of each group
    images: np.ndarray        # (G, 1, W) uint32 — single h image
    nxt: np.ndarray           # (n,) next same-h index or -1
    first_y: List[np.ndarray]
    first_idx: List[np.ndarray]
    family: HashFamily
    w: int

    @property
    def n(self) -> int:
        return len(self.values)

    @property
    def G(self) -> int:
        return len(self.offsets) - 1

    def h_of(self, x):
        return self.family.apply(x, 0)


def preprocess_fixed(
    values: np.ndarray,
    w: int = 64,
    group_size: Optional[int] = None,
    family: Optional[HashFamily] = None,
    seed: int = 0,
) -> FixedWidthIndex:
    """Pre-process for IntGroup (Theorem 3.4): sort + fixed-width groups."""
    values = np.unique(np.asarray(values, dtype=np.uint32))
    n = len(values)
    s = group_size or max(1, int(round(math.sqrt(w))))
    family = family or random_hash_family(1, w, seed=seed)
    G = max(1, math.ceil(n / s))
    offsets = np.minimum(np.arange(G + 1) * s, n).astype(np.int64)
    lo = values[offsets[:-1].clip(max=max(n - 1, 0))]
    hi = values[(offsets[1:] - 1).clip(min=0, max=max(n - 1, 0))]
    h = family.apply(values, 0)
    dense, mask, gmax = _pad_groups(values, offsets)
    hashes = family.apply_all(dense).astype(np.uint32)  # (G, gmax, m=1)
    images = build_images_chunked(hashes, mask, w)
    nxt, first_y, first_idx = _first_next(np.asarray(h), offsets, w)
    return FixedWidthIndex(
        values=values, group_size=s, padded_vals=dense, mask=mask,
        offsets=offsets, lo=lo, hi=hi,
        images=images, nxt=nxt, first_y=first_y, first_idx=first_idx,
        family=family, w=w,
    )


@dataclasses.dataclass
class PrefixIndex:
    """Sections 3.2/3.3 structure: g-ordered, prefix-partitioned set.

    ``g_keys`` are the permuted keys g(x), sorted ascending; ``values`` are
    the original elements in the same order.  Group ``z`` occupies
    ``[offsets[z], offsets[z+1])``.  ``images[z, j]`` is the packed word
    representation of ``h_j(L^z)``.
    """

    values: np.ndarray        # (n,) uint32 — original ids, ordered by g(x)
    g_keys: np.ndarray        # (n,) uint32 — g(x), ascending
    t: int
    offsets: np.ndarray       # (2^t + 1,)
    padded_keys: np.ndarray   # (2^t, gmax) uint32 (sentinel-padded g keys)
    padded_vals: np.ndarray   # (2^t, gmax) uint32 (original values)
    mask: np.ndarray          # (2^t, gmax) bool
    gmax: int
    images: np.ndarray        # (2^t, m, W) uint32
    family: HashFamily        # the m filter hashes h_j
    perm: BitMixPermutation   # g
    w: int

    @property
    def n(self) -> int:
        return len(self.values)

    @property
    def G(self) -> int:
        return 1 << self.t

    def group_slice(self, z: int):
        lo, hi = self.offsets[z], self.offsets[z + 1]
        return self.values[lo:hi], self.g_keys[lo:hi]

    def storage_words(self) -> int:
        """Uncompressed structure size (words), per Section 3.3.1:
        n*(1 + (m+1)/|group|) words — elements + m images + len per group."""
        m = self.family.m
        return int(self.n + self.G * (m + 1))


def preprocess_prefix(
    values: np.ndarray,
    w: int = 256,
    m: int = 2,
    t: Optional[int] = None,
    family: Optional[HashFamily] = None,
    perm: Optional[BitMixPermutation] = None,
    seed: int = 0,
    gmax: Optional[int] = None,
) -> PrefixIndex:
    """Pre-process for RanGroup/RanGroupScan/HashBin (Theorems 3.8/3.10)."""
    values = np.unique(np.asarray(values, dtype=np.uint32))
    n = len(values)
    family = family or random_hash_family(m, w, seed=seed)
    perm = perm or default_permutation(seed)
    if t is None:
        t = choose_t(n, w)
    g = np.asarray(perm.forward(values))
    order = np.argsort(g, kind="stable")
    g_sorted = g[order]
    v_sorted = values[order]
    z = ((g_sorted >> np.uint32(32 - t)).astype(np.int64) if t > 0
         else np.zeros(n, np.int64))
    counts = np.bincount(z, minlength=1 << t)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    padded_keys, mask, gmax = _pad_groups(g_sorted, offsets, gmax)
    padded_vals, _, _ = _pad_groups(v_sorted, offsets, gmax)
    hashes = family.apply_all(padded_vals).astype(np.uint32)
    images = build_images_chunked(hashes, mask, w)
    return PrefixIndex(
        values=v_sorted, g_keys=g_sorted, t=t, offsets=offsets,
        padded_keys=padded_keys, padded_vals=padded_vals, mask=mask,
        gmax=gmax, images=images, family=family, perm=perm, w=w,
    )


@dataclasses.dataclass
class MultiResolutionIndex:
    """Section 3.2.1: all resolutions t = 0..T of one set in O(n) space.

    ``resolutions[t]`` gives (offsets, images) for the partition induced by
    ``g_t``; elements/g_keys are shared across resolutions (they are the same
    g-sorted array — each group is a contiguous interval).  Inverted mappings
    are threaded once globally (``nxt``) and resolved per group via binary
    search over ``first`` entries, as in Fig. 2.
    """

    base: PrefixIndex                      # finest resolution (t = T)
    offsets_by_t: List[np.ndarray]         # index t -> (2^t + 1,)
    images_by_t: List[np.ndarray]          # index t -> (2^t, m, W)

    @property
    def T(self) -> int:
        return self.base.t

    def at(self, t: int) -> "PrefixIndex":
        """Materialize a PrefixIndex view at resolution t (cheap: reuses the
        shared g-ordered arrays; pads groups on demand)."""
        if not 0 <= t <= self.T:
            raise ValueError(f"resolution {t} outside 0..{self.T}")
        if t == self.T:
            return self.base
        offsets = self.offsets_by_t[t]
        padded_keys, mask, gmax = _pad_groups(self.base.g_keys, offsets)
        padded_vals, _, _ = _pad_groups(self.base.values, offsets, gmax)
        return PrefixIndex(
            values=self.base.values, g_keys=self.base.g_keys, t=t,
            offsets=offsets, padded_keys=padded_keys, padded_vals=padded_vals,
            mask=mask, gmax=gmax, images=self.images_by_t[t],
            family=self.base.family, perm=self.base.perm, w=self.base.w,
        )

    def storage_words(self) -> int:
        """Total words over all resolutions — O(n): sum_t 2^t * (m + 1) + n."""
        m = self.base.family.m
        tot = self.base.n
        for t in range(self.T + 1):
            tot += (1 << t) * (m + 1)
        return int(tot)


def preprocess_multiresolution(
    values: np.ndarray,
    w: int = 256,
    m: int = 2,
    family: Optional[HashFamily] = None,
    perm: Optional[BitMixPermutation] = None,
    seed: int = 0,
) -> MultiResolutionIndex:
    """Pre-process every resolution of one set (Section 3.2.1)."""
    values = np.unique(np.asarray(values, dtype=np.uint32))
    n = len(values)
    T = max(0, math.ceil(math.log2(max(1, n))))
    base = preprocess_prefix(values, w=w, m=m, t=T, family=family, perm=perm, seed=seed)
    offsets_by_t: List[np.ndarray] = []
    images_by_t: List[np.ndarray] = []
    z_full = ((base.g_keys >> np.uint32(32 - T)).astype(np.int64) if T
              else np.zeros(n, np.int64))
    for t in range(T + 1):
        if t == T:
            offsets_by_t.append(base.offsets)
            images_by_t.append(base.images)
            continue
        z = z_full >> (T - t)
        counts = np.bincount(z, minlength=1 << t)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        offsets_by_t.append(offsets)
        padded_vals, mask, _ = _pad_groups(base.values, offsets)
        hashes = base.family.apply_all(padded_vals).astype(np.uint32)
        images_by_t.append(build_images_chunked(hashes, mask, base.w))
    return MultiResolutionIndex(base=base, offsets_by_t=offsets_by_t,
                                images_by_t=images_by_t)


def prefix_index_from_arrays(
    *,
    values: np.ndarray,
    g_keys: np.ndarray,
    t: int,
    offsets: np.ndarray,
    padded_keys: np.ndarray,
    padded_vals: np.ndarray,
    mask: np.ndarray,
    gmax: int,
    images: np.ndarray,
    w: int,
    family_a: np.ndarray,
    family_b: np.ndarray,
    perm_mults: Sequence[int],
    perm_shifts: Sequence[int],
) -> PrefixIndex:
    """Build a :class:`PrefixIndex` from another package's fields as plain
    numpy arrays and ints — how an index preprocessed elsewhere (the JAX
    package, a file) is carried into the port without importing its code.

    Shapes are checked against each other; arrays are copied with their
    dtypes fixed (uint32 data, int64 offsets, bool mask).
    """
    u32 = lambda x: np.array(x, dtype=np.uint32)  # noqa: E731
    idx = PrefixIndex(
        values=u32(values), g_keys=u32(g_keys), t=int(t),
        offsets=np.array(offsets, dtype=np.int64),
        padded_keys=u32(padded_keys), padded_vals=u32(padded_vals),
        mask=np.array(mask, dtype=bool), gmax=int(gmax), images=u32(images),
        family=HashFamily(a=u32(family_a), b=u32(family_b), w=int(w)),
        perm=BitMixPermutation(mults=tuple(int(v) for v in perm_mults),
                               shifts=tuple(int(v) for v in perm_shifts)),
        w=int(w),
    )
    G = 1 << idx.t
    if idx.offsets.shape != (G + 1,) or int(idx.offsets[-1]) != idx.n:
        raise ValueError("offsets do not match t and the number of values")
    if idx.g_keys.shape != idx.values.shape:
        raise ValueError("g_keys and values differ in length")
    for name in ("padded_keys", "padded_vals", "mask"):
        if getattr(idx, name).shape != (G, idx.gmax):
            raise ValueError(f"{name} is not ({G}, {idx.gmax})")
    if idx.images.shape != (G, idx.family.m, idx.w // 32):
        raise ValueError(f"images is not ({G}, {idx.family.m}, {idx.w // 32})")
    return idx
