"""Bucketed batch executor: group QueryPlans by shape signature and run each
bucket as ONE pass of ``core.engine``'s two-phase pipeline.

Every plan in a bucket shares ``ShapeSig(k, ts, gmaxes, capacity_tier)``, so
the bucket's rows stack into shape-uniform ``(B, …)`` tensors.  Queries
whose survivor count exceeds the capacity tier are re-run once, as a
subset, at full capacity.  A suggest bucket (``sig.cands > 0``) runs the
count-only pass instead (``core.engine.dispatch_count_batch``): no survivor
buffer and no re-run, and ``sig.capacity_tier`` is its top-K tier.  An
expression bucket (``sig.eshape`` set) runs the expression pass
(``core.engine.dispatch_expr_batch``): rows in the plan's leaf traversal
order, never re-sorted, each query with its canonical subexpression keys,
so the collected stats carry the intermediate node values for the
subexpression cache.

Per-query timing is amortized: each result's stats carry ``batch_us`` (the
bucket's dispatch-to-collect wall time divided by bucket size).

Dispatch is split from collection: :func:`dispatch_bucket` enqueues the
bucket's first pass and returns an :class:`InFlightBucket` whose
:meth:`~InFlightBucket.collect` blocks for the results;
:func:`execute_plan_buckets` enqueues up to ``max_inflight`` buckets ahead
of the one it collects.  Every bucket runs on the compute stream, but a
collect's copy waits only on its own bucket's event (from a side stream),
so it does not queue behind the buckets dispatched after it.  With a
``capacity_model`` attached, collect feeds each bucket's survivor counts
to it.  ``EXEC_COUNTERS`` tracks the window: ``inflight_dispatches`` per
dispatched bucket, ``inflight_collects`` per one-shot teardown (equal
after a drain), ``overlap_high_water`` (most buckets in flight at once),
``collect_us`` (blocking collect time) and ``dispatch_failures`` (buckets
whose dispatch or collect raised).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import (
    Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple,
)

import numpy as np

from ..core.engine import (
    EXEC_COUNTERS, DeviceSet, PendingBatch, dispatch_count_batch,
    dispatch_device_batch, dispatch_expr_batch,
)
from ..device import Device
from .expr import subexpr_keys
from .plan import QueryPlan, ShapeSig, plan_query

__all__ = [
    "bucket_plans",
    "InFlightBucket",
    "dispatch_bucket",
    "execute_bucket",
    "execute_plan_buckets",
    "execute_name_queries",
]

# process-wide in-flight gauge behind overlap_high_water: dispatch_bucket
# increments, InFlightBucket teardown decrements
_inflight_lock = threading.Lock()
_inflight_now = 0


def _inflight_enter() -> None:
    global _inflight_now
    with _inflight_lock:
        _inflight_now += 1
        if _inflight_now > EXEC_COUNTERS["overlap_high_water"]:
            EXEC_COUNTERS["overlap_high_water"] = _inflight_now


def _inflight_exit() -> None:
    global _inflight_now
    with _inflight_lock:
        _inflight_now = max(0, _inflight_now - 1)


def bucket_plans(
    indexed_plans: Iterable[Tuple[int, QueryPlan]],
) -> Dict[ShapeSig, List[Tuple[int, QueryPlan]]]:
    """Group (query_index, plan) pairs by shape signature (insertion order).
    Accepts device plans only."""
    buckets: Dict[ShapeSig, List[Tuple[int, QueryPlan]]] = defaultdict(list)
    for qi, plan in indexed_plans:
        if plan.algorithm != "device" or plan.sig is None:
            raise ValueError(f"only device plans can be bucketed: {plan}")
        buckets[plan.sig].append((qi, plan))
    return dict(buckets)


class InFlightBucket:
    """Handle for one dispatched-but-not-collected bucket.

    Holds the pipeline's :class:`~repro_torch.core.engine.PendingBatch` and
    the bucket bookkeeping; :meth:`collect` finishes the job.  Collect is
    memoized; the in-flight teardown happens exactly once, also when
    collect raises.  ``is_ready()`` is safe to poll from any thread.
    """

    def __init__(self, sig: ShapeSig, items: Sequence[Tuple[int, QueryPlan]],
                 pending: PendingBatch, dispatched_at: float,
                 capacity_model=None):
        self.sig = sig
        self.items = list(items)
        self.pending = pending
        self.dispatched_at = dispatched_at
        self.dispatch_end_at = time.perf_counter()
        self.capacity_model = capacity_model
        self._out: Optional[Dict[int, Tuple[np.ndarray, Dict]]] = None
        self._finished = False

    def is_ready(self) -> bool:
        """Non-blocking peek: True when the first pass has finished."""
        return self.pending.is_ready()

    def _finish(self, failed: bool = False) -> None:
        """One-shot teardown on the first collect completion or failure;
        ``failed`` also counts a ``dispatch_failures``."""
        if self._finished:
            return
        self._finished = True
        EXEC_COUNTERS.bump_many({"inflight_collects": 1,
                                 "dispatch_failures": int(failed)})
        _inflight_exit()

    def collect(self) -> Dict[int, Tuple[np.ndarray, Dict]]:
        """Block for the bucket's results: {query_index: (values, stats)}.
        Stamps ``batch_us``, adds the blocking time to ``collect_us`` and
        feeds the capacity model."""
        if self._out is not None:
            return self._out
        c0 = time.perf_counter()
        try:
            results = self.pending.collect()
        except BaseException:
            self._finish(failed=True)
            raise
        self._finish()
        c1 = time.perf_counter()
        EXEC_COUNTERS.bump("collect_us", int((c1 - c0) * 1e6))
        us = (c1 - self.dispatched_at) * 1e6
        out: Dict[int, Tuple[np.ndarray, Dict]] = {}
        for (qi, _), (values, stats) in zip(self.items, results):
            stats["batch_us"] = us / len(self.items)
            out[qi] = (values, stats)
        if self.capacity_model is not None:
            self.capacity_model.observe_bucket(
                self.sig, [stats for _, stats in out.values()])
        self._out = out
        return out


def dispatch_bucket(
    get_set: Callable[[object], DeviceSet],
    sig: ShapeSig,
    items: Sequence[Tuple[int, QueryPlan]],
    device: Device = "cuda",
    capacity_model=None,
) -> InFlightBucket:
    """Enqueue ONE same-signature bucket without blocking; ``get_set``
    resolves a planned term to its DeviceSet.  Bumps
    ``inflight_dispatches``; the pipeline bumps ``batch_calls`` (a suggest
    bucket's count pass bumps ``count_calls``, an expression bucket's pass
    ``expr_calls``).  A dispatch that raises bumps ``dispatch_failures``.
    ``capacity_model`` is fed at collect."""
    t0 = time.perf_counter()
    try:
        if sig.eshape is not None:
            # plan.terms IS the leaf traversal order: never re-sorted
            rows = [[get_set(t) for t in plan.terms] for _, plan in items]
            pending = dispatch_expr_batch(
                rows, sig.eshape, capacity=sig.capacity_tier,
                sub_keys=[subexpr_keys(plan.expr) for _, plan in items],
                device=device)
        elif sig.cands > 0:
            # plan.terms is (probe, *candidates), candidates ascending: the
            # order the count pass's tie-break reads as "smallest id first"
            rows = [(get_set(plan.terms[0]),
                     [get_set(t) for t in plan.terms[1:]])
                    for _, plan in items]
            pending = dispatch_count_batch(rows, sig.capacity_tier,
                                           device=device)
        else:
            rows = [[get_set(t) for t in plan.terms] for _, plan in items]
            pending = dispatch_device_batch(rows, capacity=sig.capacity_tier,
                                            device=device)
    except BaseException:
        EXEC_COUNTERS.bump("dispatch_failures")
        raise
    EXEC_COUNTERS.bump("inflight_dispatches")
    _inflight_enter()
    return InFlightBucket(sig, items, pending, t0,
                          capacity_model=capacity_model)


def execute_bucket(
    get_set: Callable[[object], DeviceSet],
    sig: ShapeSig,
    items: Sequence[Tuple[int, QueryPlan]],
    device: Device = "cuda",
    capacity_model=None,
) -> Dict[int, Tuple[np.ndarray, Dict]]:
    """Execute ONE same-signature bucket: {query_index: (values, stats)}.
    The synchronous composition of :func:`dispatch_bucket` and
    :meth:`InFlightBucket.collect`."""
    return dispatch_bucket(get_set, sig, items, device=device,
                           capacity_model=capacity_model).collect()


def execute_plan_buckets(
    get_set: Callable[[object], DeviceSet],
    indexed_plans: Iterable[Tuple[int, QueryPlan]],
    device: Device = "cuda",
    capacity_model=None,
    max_inflight: int = 4,
) -> Dict[int, Tuple[np.ndarray, Dict]]:
    """Execute device plans bucket by bucket: {query_index: (values, stats)}.

    One pass per distinct signature (plus rare overflow re-runs), with up to
    ``max_inflight`` buckets dispatched ahead of their collection.  All
    results are collected before returning.
    """
    out: Dict[int, Tuple[np.ndarray, Dict]] = {}
    window: List[InFlightBucket] = []
    for sig, items in bucket_plans(indexed_plans).items():
        window.append(dispatch_bucket(get_set, sig, items, device=device,
                                      capacity_model=capacity_model))
        if len(window) >= max(1, max_inflight):
            out.update(window.pop(0).collect())
    for bucket in window:
        out.update(bucket.collect())
    return out


def execute_name_queries(
    sets: Mapping[object, DeviceSet],
    queries: Sequence[Sequence],
    device: Device = "cuda",
) -> List[Tuple[np.ndarray, Dict]]:
    """``BatchedEngine.query_many`` backend: plan -> bucket -> execute ->
    scatter.  Unknown names raise KeyError; duplicate names within a query
    are deduped by the planner; results return in request order."""
    for q in queries:
        for name in q:
            if name not in sets:
                raise KeyError(name)
    plans = [plan_query(sets, q, hashbin_ratio=float("inf")) for q in queries]
    by_index = execute_plan_buckets(
        lambda name: sets[name],
        [(i, p) for i, p in enumerate(plans) if p.algorithm == "device"],
        device=device,
    )
    # fresh objects per miss: callers annotate stats dicts in place
    return [
        by_index[i] if i in by_index else (np.empty(0, np.uint32),
                                           {"r": 0, "batch_size": 0})
        for i in range(len(queries))
    ]
