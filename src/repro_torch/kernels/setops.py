"""Batched dense sorted-set passes: union / difference / intersection.

The expression evaluator (``core/engine.py``) works on **dense value
rows**: each leaf's ``(2^t, gmax)`` z-prefix group layout flattens to one
sorted row per query, and every DAG node is a sort-merge pass over its
children's rows.  These are the JAX package's ``kernels/setops.py`` passes
as torch ops (``torch.sort``, ``torch.searchsorted``); they were never
Pallas there (sorting dominates them, and the backend's sort is already
tuned), so they are not a kernel port.

Key order.  The JAX passes sort ``uint32`` with the sentinel
``0xFFFFFFFF`` last.  Torch's ``searchsorted`` has no ``uint32`` support
on the CPU, so the rows here are ``int32`` **keys**: a value's ``uint32``
bit pattern with the sign bit flipped (``x ^ INT32_MIN``).  Signed order of
keys is unsigned order of values, and both the ``-1`` padding of
``DeviceSet.vals`` and the sentinel become ``SENTINEL = INT32_MAX``, which
sorts last.  :func:`to_values_np` flips back on the host.  (Widening to
``int64`` would also work, at twice the bytes of the largest sorts.)

All passes are shape-static: callers pick the output width
(``min(capacity, natural width)``) and get back ``(rows, count)``.
``count`` is the TRUE result size, so ``count > width`` is the per-query
overflow signal behind the executor's single enlarged re-run.

The numpy oracles (``densify_ref`` …) keep the JAX package's ``uint32``
layout, sentinel ``0xFFFFFFFF``; :func:`to_keys_np` / :func:`to_values_np`
convert between the two layouts.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "INT32_MIN", "SENTINEL", "densify", "member_mask", "union_pass",
    "diff_pass", "intersect_pass", "to_keys_np", "to_values_np",
    "densify_ref", "union_ref", "diff_ref", "intersect_ref",
]

INT32_MIN = -(1 << 31)
SENTINEL = (1 << 31) - 1   # the key of 0xFFFFFFFF (and of the -1 padding)


def densify(vals: torch.Tensor) -> torch.Tensor:
    """(B, 2^t, gmax) int32 device-set values (uint32 bit patterns, -1
    padded) -> (B, 2^t * gmax) sorted int32 key rows, SENTINEL-padded."""
    keys = vals.reshape(vals.shape[0], -1) ^ INT32_MIN
    return torch.sort(keys, dim=1).values


def member_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, La) needles x (B, Lb) sorted haystacks -> (B, La) bool: needle
    present in its row's haystack.  SENTINEL needles are never members.
    Needles may be unsorted (only the haystack feeds searchsorted)."""
    idx = torch.searchsorted(b, a).clamp_(max=b.shape[1] - 1)
    return (torch.gather(b, 1, idx) == a) & (a != SENTINEL)


def _count(rows: torch.Tensor) -> torch.Tensor:
    return (rows != SENTINEL).sum(dim=1, dtype=torch.int32)


def _head(rows: torch.Tensor, width: int) -> torch.Tensor:
    """The first ``width`` columns, contiguous (a later pass searches them
    and the collect copies them)."""
    return rows if width >= rows.shape[1] else rows[:, :width].contiguous()


def union_pass(bufs: Sequence[torch.Tensor], width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n-ary ∪ of sorted SENTINEL-padded rows -> (out (B, width) sorted,
    count (B,) int32 = true union size): concat, sort, drop adjacent
    repeats, sort again, slice.  ``count > width`` means truncation."""
    uniq = torch.sort(torch.cat(list(bufs), dim=1), dim=1).values
    repeat = uniq[:, 1:] == uniq[:, :-1]
    uniq[:, 1:].masked_fill_(repeat, SENTINEL)
    count = _count(uniq)
    return _head(torch.sort(uniq, dim=1).values, width), count


def diff_pass(a: torch.Tensor, b: torch.Tensor, width: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """∖: drop ``a``'s members of ``b`` -> (out (B, width) sorted, count
    (B,) int32).  Both inputs are sorted SENTINEL-padded rows."""
    out = a.masked_fill(member_mask(a, b), SENTINEL)
    count = _count(out)
    return _head(torch.sort(out, dim=1).values, width), count


def intersect_pass(bufs: Sequence[torch.Tensor], width: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n-ary ∩ -> (out (B, width) sorted, count (B,) int32).  Folds
    membership onto the first (canonically smallest) row."""
    acc = bufs[0]
    for b in bufs[1:]:
        acc = acc.masked_fill(~member_mask(acc, b), SENTINEL)
    count = _count(acc)
    return _head(torch.sort(acc, dim=1).values, width), count


# ---------------------------------------------------------------------------
# layouts, and the numpy oracles (the JAX package's uint32 layout)
# ---------------------------------------------------------------------------

_SENT_NP = np.uint32(0xFFFFFFFF)


def to_keys_np(u: np.ndarray) -> np.ndarray:
    """uint32 values (sentinel 0xFFFFFFFF) -> int32 keys (SENTINEL)."""
    return (np.asarray(u, np.uint32) ^ np.uint32(0x80000000)).view(np.int32)


def to_values_np(keys: np.ndarray) -> np.ndarray:
    """int32 keys -> uint32 values; SENTINEL becomes 0xFFFFFFFF."""
    return np.asarray(keys, np.int32).view(np.uint32) ^ np.uint32(0x80000000)


def _pad_rows(rows: List[np.ndarray], width: int) -> np.ndarray:
    out = np.full((len(rows), width), _SENT_NP, dtype=np.uint32)
    for i, r in enumerate(rows):
        out[i, :min(len(r), width)] = r[:width]
    return out


def densify_ref(vals: np.ndarray) -> np.ndarray:
    u = vals.astype(np.int64).reshape(vals.shape[0], -1)
    u = np.where(u < 0, int(_SENT_NP), u).astype(np.uint32)
    return np.sort(u, axis=1)


def union_ref(bufs: Sequence[np.ndarray], width: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    rows, counts = [], []
    for i in range(bufs[0].shape[0]):
        vals = np.concatenate([b[i][b[i] != _SENT_NP] for b in bufs])
        u = np.unique(vals)
        rows.append(u)
        counts.append(len(u))
    return _pad_rows(rows, width), np.asarray(counts, dtype=np.int32)


def diff_ref(a: np.ndarray, b: np.ndarray, width: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    rows, counts = [], []
    for i in range(a.shape[0]):
        d = np.setdiff1d(a[i][a[i] != _SENT_NP], b[i][b[i] != _SENT_NP])
        rows.append(d)
        counts.append(len(d))
    return _pad_rows(rows, width), np.asarray(counts, dtype=np.int32)


def intersect_ref(bufs: Sequence[np.ndarray], width: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    rows, counts = [], []
    for i in range(bufs[0].shape[0]):
        out = bufs[0][i][bufs[0][i] != _SENT_NP]
        for b in bufs[1:]:
            out = np.intersect1d(out, b[i][b[i] != _SENT_NP])
        rows.append(out)
        counts.append(len(out))
    return _pad_rows(rows, width), np.asarray(counts, dtype=np.int32)
