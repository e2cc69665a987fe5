"""The benchmark's arithmetic: the window rule, spreads, and the
work that phase 1 and phase 2 of a query need, in bytes.

Everything here counts what a query needs, whatever the program builds to
answer it: no buffer of the program is read.  The byte counts follow the
paper's layout (Ding and Konig 2011, sections 3.2-3.3): set i of n_i elements
is cut into 2^{t_i} groups, t_i = ceil(log2(n_i / sqrt(w))), and each group
carries m images of w bits.
"""
from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence

# NVIDIA H100 SXM, HBM3: the data sheet's 3.35 TB/s at the 700 W limit
PEAK_HBM_BYTES_PER_S = 3.35e12


def window_qps(answered: int, t_start: float, t_end: float) -> float:
    """Queries answered in the window over the window's length.  The window
    of a closed loop ends at the first return after the requested seconds,
    so ``t_end`` is that return's time and every query of the last call
    counts."""
    if t_end <= t_start:
        raise ValueError("the window has no length")
    return answered / (t_end - t_start)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, quartiles as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def choose_t(n: int, w: int) -> int:
    """t = ceil(log2(n / sqrt(w))): the paper's group count for a set of n
    elements (Theorems 3.6, 3.7 and 3.9)."""
    if n <= 1:
        return 0
    return max(0, math.ceil(math.log2(max(1.0, n / math.sqrt(w)))))


def phase1_bytes(ns: Sequence[int], w: int, m: int) -> int:
    """Phase 1 of one query: each set's images read once (2^{t_i} groups of
    m images of w bits) and one survivor flag written per group tuple of the
    deepest partition (2^{max t_i} bytes)."""
    ts = [choose_t(n, w) for n in ns]
    reads = sum((1 << t) * m * (w // 8) for t in ts)
    return reads + (1 << max(ts))


def phase2_bytes(ns: Sequence[int], w: int, survivors: int) -> float:
    """Phase 2 of one query over ``survivors`` group tuples: for each set,
    the real elements of the groups the survivors name (n_i / 2^{t_i} an
    average group, 4 bytes an element), read once; and one kept flag written
    for each element of the base set's groups.  The base set is the one the
    planner puts first: smallest t, then smallest n."""
    per_group = [(choose_t(n, w), n, n / (1 << choose_t(n, w))) for n in ns]
    reads = sum(survivors * g * 4 for _, _, g in per_group)
    base = min(per_group)[2]
    return reads + survivors * base


def roofline_percent(work_bytes: float, kernel_seconds: float,
                     peak: float = PEAK_HBM_BYTES_PER_S) -> Optional[float]:
    """The least time the bytes take at the peak rate, as a percentage of the
    kernels' measured time; None when the kernels took no time (nothing to
    read), never 0."""
    if kernel_seconds <= 0 or work_bytes <= 0:
        return None
    return 100.0 * (work_bytes / peak) / kernel_seconds
