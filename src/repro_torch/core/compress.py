"""Compression of the pre-processed structures (Appendix B) and γ/δ coding.

Appendix-B scheme for Algorithm 5's blocks:
  (i)   group sizes |L^z| in unary code;
  (ii)  m hash-image words only when |L^z| > 0;
  (iii) elements stored as lowbits_t(x) = g(x) mod 2^{32-t} — the high t bits
        are the group id z, reconstructed by concatenation at query time.

Decode is a shift-and-OR per group.  The γ/δ (Elias) coders serve the
compressed Merge/Lookup baselines and the space accounting
(:func:`space_report`).  Host numpy, bit-identical to the JAX package's
copy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .partition import PrefixIndex

__all__ = [
    "LowbitsIndex", "compress_lowbits", "decompress_group",
    "gamma_encode", "gamma_decode", "delta_encode", "delta_decode",
    "space_report",
]


@dataclasses.dataclass
class LowbitsIndex:
    """Appendix-B compressed form of a PrefixIndex."""

    t: int
    w: int
    m: int
    n: int
    counts: np.ndarray        # (2^t,) — stored unary in the bit accounting
    offsets: np.ndarray       # (2^t+1,)
    lowbits: np.ndarray       # (n,) minimal-width storage of g(x) mod 2^{32-t}
    lowbits_dtype: str
    images: np.ndarray        # (#nonempty, m, W) — only for non-empty groups
    nonempty_map: np.ndarray  # (2^t,) -> row in images or -1

    def storage_bits(self) -> int:
        """Appendix-B accounting: unary sizes + images (non-empty only) +
        (32 - t) bits per element."""
        unary = int(self.n + len(self.counts))          # n ones + G zeros
        imgs = int((self.counts > 0).sum()) * self.m * self.w
        elems = self.n * (32 - self.t)
        return unary + imgs + elems


def compress_lowbits(idx: PrefixIndex) -> LowbitsIndex:
    low_width = 32 - idx.t
    low = idx.g_keys & np.uint32((1 << low_width) - 1) if low_width < 32 else idx.g_keys
    if low_width <= 8:
        stored, sdt = low.astype(np.uint8), "uint8"
    elif low_width <= 16:
        stored, sdt = low.astype(np.uint16), "uint16"
    else:
        stored, sdt = low.astype(np.uint32), "uint32"
    counts = np.diff(idx.offsets).astype(np.int64)
    nonempty = np.nonzero(counts > 0)[0]
    nonempty_map = np.full(len(counts), -1, dtype=np.int64)
    nonempty_map[nonempty] = np.arange(len(nonempty))
    return LowbitsIndex(
        t=idx.t, w=idx.w, m=idx.family.m, n=idx.n,
        counts=counts, offsets=idx.offsets, lowbits=stored, lowbits_dtype=sdt,
        images=idx.images[nonempty], nonempty_map=nonempty_map,
    )


def decompress_group(cidx: LowbitsIndex, z: int) -> np.ndarray:
    """Reconstruct the g-keys of group z: concatenate z to the low bits."""
    lo, hi = cidx.offsets[z], cidx.offsets[z + 1]
    low = cidx.lowbits[lo:hi].astype(np.uint32)
    if cidx.t == 0:
        return low
    return (np.uint32(z) << np.uint32(32 - cidx.t)) | low


# ---------------------------------------------------------------------------
# Elias γ / δ coding (bit-level, for baselines' compressed posting lists)
# ---------------------------------------------------------------------------

def _to_gaps(sorted_vals: np.ndarray) -> np.ndarray:
    g = np.empty_like(sorted_vals)
    g[0] = sorted_vals[0] + 1  # codes need positives
    g[1:] = sorted_vals[1:] - sorted_vals[:-1]
    return g.astype(np.uint64)


def gamma_encode(sorted_vals: np.ndarray) -> Tuple[np.ndarray, int]:
    """Elias-γ over d-gaps -> packed bit array (np.uint8) + bit length."""
    gaps = _to_gaps(sorted_vals)
    nbits_val = np.floor(np.log2(gaps)).astype(np.int64)
    total = int(np.sum(2 * nbits_val + 1))
    out = np.zeros((total + 7) // 8, dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(2 * nbits_val + 1)])[:-1]
    for gap, nb, st in zip(gaps.tolist(), nbits_val.tolist(), starts.tolist()):
        p = st + nb  # nb zeros, then the (nb+1)-bit binary of gap (MSB first)
        for b in range(nb, -1, -1):
            if (gap >> b) & 1:
                out[(p) >> 3] |= 1 << ((p) & 7)
            p += 1
    return out, total


def gamma_decode(bits: np.ndarray, total_bits: int) -> np.ndarray:
    unpacked = np.unpackbits(bits, bitorder="little")[:total_bits]
    vals = []
    i = 0
    while i < total_bits:
        nb = 0
        while unpacked[i] == 0:
            nb += 1; i += 1
        val = 0
        for _ in range(nb + 1):
            val = (val << 1) | int(unpacked[i]); i += 1
        vals.append(val)
    gaps = np.asarray(vals, dtype=np.uint64)
    out = np.cumsum(gaps) - 1
    return out.astype(np.uint32)


def delta_encode(sorted_vals: np.ndarray) -> Tuple[np.ndarray, int]:
    """Elias-δ over d-gaps: γ-code the length field — smaller asymptotically."""
    gaps = _to_gaps(sorted_vals)
    nb = np.floor(np.log2(gaps)).astype(np.int64)           # value bits - 1
    lb = np.floor(np.log2(nb + 1)).astype(np.int64)          # γ of (nb+1)
    lens = 2 * lb + 1 + nb
    total = int(lens.sum())
    out = np.zeros((total + 7) // 8, dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
    for gap, n_, l_, st in zip(gaps.tolist(), nb.tolist(), lb.tolist(),
                               starts.tolist()):
        p = st + l_  # l_ zeros then (l_+1)-bit binary of (n_+1)
        ln = n_ + 1
        for b in range(l_, -1, -1):
            if (ln >> b) & 1:
                out[p >> 3] |= 1 << (p & 7)
            p += 1
        for b in range(n_ - 1, -1, -1):  # n_ low bits of gap (MSB first)
            if (gap >> b) & 1:
                out[p >> 3] |= 1 << (p & 7)
            p += 1
    return out, total


def delta_decode(bits: np.ndarray, total_bits: int) -> np.ndarray:
    unpacked = np.unpackbits(bits, bitorder="little")[:total_bits]
    vals = []
    i = 0
    while i < total_bits:
        lb = 0
        while unpacked[i] == 0:
            lb += 1; i += 1
        ln = 0
        for _ in range(lb + 1):
            ln = (ln << 1) | int(unpacked[i]); i += 1
        nb = ln - 1
        val = 1
        for _ in range(nb):
            val = (val << 1) | int(unpacked[i]); i += 1
        vals.append(val)
    gaps = np.asarray(vals, dtype=np.uint64)
    return (np.cumsum(gaps) - 1).astype(np.uint32)


def space_report(idx: PrefixIndex) -> Dict[str, float]:
    """Bits-per-element of each representation (paper §4 'size' + Fig. 8)."""
    n = idx.n
    plain = 32.0
    un_scan = idx.storage_words() * 32 / n
    cidx = compress_lowbits(idx)
    low = cidx.storage_bits() / n
    gbits = gamma_encode(np.sort(idx.values))[1] / n
    dbits = delta_encode(np.sort(idx.values))[1] / n
    return {
        "plain_inverted": plain,
        "rangroupscan_uncompressed": un_scan,
        "rangroupscan_lowbits": low,
        "merge_gamma": gbits,
        "merge_delta": dbits,
    }
