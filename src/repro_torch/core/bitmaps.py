"""Word representations of small sets (Section 3.1), packed into uint32 words.

The paper encodes a set ``A ⊆ [w]`` as one w-bit machine word; here a w-bit
representation is ``W = w // 32`` packed uint32 words.  ``w`` is
configurable (64..512); the engine's default is 256 (8 words, 32 bytes — two
16-byte loads for the phase-1 kernel).

Host-side numpy only: images are built during pre-processing and mirrored
to the device as int32 bit patterns by ``core.engine.DeviceSet``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "num_lanes",
    "build_images",
    "build_images_chunked",
    "popcount32",
    "bits_to_values",
    "any_nonzero",
]


def num_lanes(w: int) -> int:
    if w % 32 or w & (w - 1):
        raise ValueError(f"w={w} must be a power of two and a multiple of 32")
    return w // 32


def build_images(hashes: np.ndarray, valid: np.ndarray, w: int) -> np.ndarray:
    """Pack per-element hash values into word-representation bitmaps.

    Args:
      hashes: (..., G, gmax, m) uint32 in [0, w) — hash of each element under
        each of the m functions (padding rows may hold arbitrary values).
      valid:  (..., G, gmax) bool — which elements are real.
      w: bitmap width in bits.

    Returns:
      (..., G, m, W) uint32 — the m word representations per group.
    """
    W = num_lanes(w)
    lane = (hashes >> np.uint32(5)).astype(np.int32)  # word index in [0, W)
    bit = np.left_shift(np.uint32(1), hashes & np.uint32(31))
    # one-hot over words: (..., G, gmax, m, W)
    onehot = (lane[..., None] == np.arange(W, dtype=np.int32)).astype(np.uint32)
    contrib = onehot * bit[..., None]
    contrib = contrib * valid[..., None, None].astype(np.uint32)
    # OR-reduce over the elements of the group (the same bit can repeat)
    return np.bitwise_or.reduce(contrib, axis=-3)


def build_images_chunked(hashes: np.ndarray, valid: np.ndarray, w: int,
                         chunk: int = 65536) -> np.ndarray:
    """Chunked :func:`build_images` over the group axis (bounded temp memory)."""
    G = hashes.shape[0]
    out = np.zeros((G, hashes.shape[2], num_lanes(w)), dtype=np.uint32)
    for lo in range(0, G, chunk):
        hi = min(G, lo + chunk)
        out[lo:hi] = build_images(hashes[lo:hi], valid[lo:hi], w)
    return out


def popcount32(x) -> np.ndarray:
    """Per-word popcount of uint32 (SWAR)."""
    x = np.asarray(x, dtype=np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> np.uint32(24)


def any_nonzero(images: np.ndarray, axis: int = -1) -> np.ndarray:
    """True where the OR over ``axis`` words is non-zero (H != empty set)."""
    return np.bitwise_or.reduce(images, axis=axis) != 0


def bits_to_values(word_rep: np.ndarray, w: int) -> np.ndarray:
    """Enumerate the set bits of a packed bitmap -> sorted values."""
    W = num_lanes(w)
    if word_rep.shape[-1] != W:
        raise ValueError(f"expected {W} words, got {word_rep.shape[-1]}")
    le_bytes = word_rep.astype("<u4").view(np.uint8)
    bits = np.unpackbits(le_bytes, bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint32)
