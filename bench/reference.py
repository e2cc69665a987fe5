"""The plain reference: the exact conjunction of raw posting lists.

The shortest list is searched in each of the others with
``torch.searchsorted`` (on whatever device the lists are on), which is
independent of the program: it takes the sorted id lists the benchmark made,
none of the program's groups, images or tables.  ``Reference`` answers each
distinct conjunction once.

``control_intersect`` is the same search with the ids held as float32, one
precision below the exact ids the configuration states: it is what the
comparison has to fail.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch


def intersect(lists: Sequence[torch.Tensor]) -> torch.Tensor:
    """Ids in every one of the sorted, duplicate-free ``lists``, sorted."""
    ordered = sorted(lists, key=len)
    out = ordered[0]
    for other in ordered[1:]:
        if len(out) == 0 or len(other) == 0:
            return out[:0]
        pos = torch.searchsorted(other, out).clamp_(max=len(other) - 1)
        out = out[other[pos] == out]
    return out


def control_intersect(lists: Sequence[torch.Tensor]) -> torch.Tensor:
    """``intersect`` with every id rounded to float32 first: ids past 2^24
    lose their low bits, so neighbours collide and answers come back
    rounded."""
    return intersect([x.to(torch.float32) for x in lists]).to(torch.int64)


class Reference:
    """Exact answers of conjunctions over ``postings`` (term -> sorted ids),
    each distinct conjunction worked out once, on ``device``.

    ``answer(terms)`` returns a sorted uint32 numpy array.  ``control=True``
    answers with ``control_intersect`` instead."""

    def __init__(self, postings: Dict[int, np.ndarray], device: str = "cpu",
                 control: bool = False):
        self.device = device
        self.lists = {t: torch.from_numpy(v.astype(np.int64)).to(device)
                      for t, v in postings.items()}
        self.fn = control_intersect if control else intersect
        self.memo: Dict[Tuple[int, ...], np.ndarray] = {}

    def answer(self, terms: Iterable[int]) -> np.ndarray:
        key = tuple(sorted(set(int(t) for t in terms)))
        got = self.memo.get(key)
        if got is None:
            out = self.fn([self.lists[t] for t in key])
            got = self.memo[key] = out.cpu().numpy().astype(np.uint32)
        return got
