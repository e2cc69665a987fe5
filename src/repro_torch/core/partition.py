"""Pre-processing stage: partition sets into small groups (Sections 3.2/3.3).

:class:`PrefixIndex` is the RanGroupScan / HashBin structure: elements ordered
by the permutation ``g``; group ``L^z`` holds the elements whose ``t``-bit
prefix ``g_t(x)`` equals ``z``.  It is stored both as CSR (host algorithms)
and as a dense padded ``(2^t, gmax)`` matrix (the device layout; padding is
the sentinel 0xFFFFFFFF, which never equals a real element).

The offline stage is host-side numpy, as in the JAX package, and gives
byte-identical arrays from the same inputs and seed.  Device mirrors are
made by ``core.engine.DeviceSet``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from .bitmaps import build_images_chunked
from .hashing import (
    BitMixPermutation, HashFamily, default_permutation, random_hash_family,
)

__all__ = [
    "PrefixIndex",
    "choose_t",
    "preprocess_prefix",
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
    """Pre-process for RanGroupScan/HashBin (Theorems 3.8/3.10)."""
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
