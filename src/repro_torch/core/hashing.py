"""Hash families used by the paper's data structures (numpy, host side).

Two kinds of hash functions appear in the paper:

* ``h : Sigma -> [w]`` — 2-universal hashes whose images are encoded as w-bit
  word representations (Section 3.1).  Multiply-shift hashing
  (Dietzfelbinger et al.): ``h_{a,b}(x) = (a*x + b) >> (32 - log2 w)`` with a
  random odd 32-bit ``a``.

* ``g : Sigma -> Sigma`` — a *random permutation* used for the randomized
  partitioning (Section 3.2): elements are ordered by ``g(x)`` and grouped by
  the ``t`` most significant bits ``g_t(x)``.  ``g`` is an invertible
  bit-mixing permutation on uint32 (odd-multiply and xor-shift rounds, both
  bijections mod 2^32).

Everything stays in uint32 numpy.  The seeds and arithmetic are those of the
JAX package's ``repro.core.hashing``, so both packages build byte-identical
indexes from the same seed (the differential tests check it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "HashFamily",
    "BitMixPermutation",
    "random_hash_family",
    "default_permutation",
    "identity_permutation",
]


@dataclasses.dataclass(frozen=True)
class HashFamily:
    """``m`` independent 2-universal multiply-shift hashes Sigma -> [w].

    ``w`` must be a power of two; each hash returns values in ``[0, w)``.
    """

    a: np.ndarray  # (m,) uint32, odd
    b: np.ndarray  # (m,) uint32
    w: int

    def __post_init__(self):
        if self.w & (self.w - 1):
            raise ValueError("w must be a power of two")
        if not np.all(self.a % 2 == 1):
            raise ValueError("multipliers must be odd")

    @property
    def m(self) -> int:
        return int(self.a.shape[0])

    @property
    def shift(self) -> int:
        return 32 - int(self.w).bit_length() + 1  # 32 - log2(w)

    def apply(self, x, j: int) -> np.ndarray:
        """Hash values ``x`` (uint32 array) with the ``j``-th function -> [w)."""
        x = np.asarray(x, dtype=np.uint32)
        return (np.uint32(self.a[j]) * x + np.uint32(self.b[j])) >> np.uint32(
            self.shift)

    def apply_all(self, x) -> np.ndarray:
        """Hash with every function: returns ``x.shape + (m,)`` in ``[0, w)``."""
        x = np.asarray(x, dtype=np.uint32)
        a = self.a.astype(np.uint32)
        b = self.b.astype(np.uint32)
        return (x[..., None] * a + b) >> np.uint32(self.shift)


@dataclasses.dataclass(frozen=True)
class BitMixPermutation:
    """An invertible bit-mixing permutation g on uint32.

    Rounds of ``x *= odd`` (invertible mod 2^32) and ``x ^= x >> s``
    (invertible by iterated shifts).  ``prefix(x, t)`` returns the ``t`` most
    significant bits of ``g(x)`` — the paper's ``g_t(x)`` group id.
    """

    mults: tuple  # odd uint32 multipliers
    shifts: tuple  # xor-shift amounts

    def forward(self, x) -> np.ndarray:
        y = np.asarray(x, dtype=np.uint32)
        for mul, sh in zip(self.mults, self.shifts):
            y = y * np.uint32(mul)
            y = y ^ (y >> np.uint32(sh))
        return y

    def inverse(self, y) -> np.ndarray:
        x = np.asarray(y, dtype=np.uint32)
        for mul, sh in zip(reversed(self.mults), reversed(self.shifts)):
            # invert x ^= x >> sh by repeated application
            z = x
            s = sh
            while s < 32:
                z = x ^ (z >> np.uint32(sh))
                s += sh
            x = z
            # invert odd multiply via modular inverse mod 2^32
            inv = pow(int(mul), -1, 1 << 32)
            x = x * np.uint32(inv)
        return x

    def prefix(self, x, t: int) -> np.ndarray:
        """g_t(x): the t most significant bits of g(x) (0 <= t <= 32)."""
        if t == 0:
            return np.zeros_like(np.asarray(x, dtype=np.uint32))
        return self.forward(x) >> np.uint32(32 - t)


def random_hash_family(m: int, w: int, seed: int = 0) -> HashFamily:
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 1 << 32, size=m, dtype=np.uint64).astype(np.uint32)
         | np.uint32(1))
    b = rng.integers(0, 1 << 32, size=m, dtype=np.uint64).astype(np.uint32)
    return HashFamily(a=a, b=b, w=w)


def default_permutation(seed: int = 0) -> BitMixPermutation:
    rng = np.random.default_rng(seed + 7)
    mults = tuple(
        int(v) | 1 for v in rng.integers(1, 1 << 32, size=3, dtype=np.uint64)
    )
    shifts = (16, 13, 17)
    return BitMixPermutation(mults=mults, shifts=shifts)


def identity_permutation() -> BitMixPermutation:
    """g = identity — handy for deterministic tests (sorted order == g-order)."""
    return BitMixPermutation(mults=(1,), shifts=())
