"""Bucketed batch executor: group QueryPlans by shape signature and run each
bucket as ONE pass of ``core.engine``'s two-phase pipeline.

Every plan in a bucket shares ``ShapeSig(k, ts, gmaxes, capacity_tier,
shards, replicas)``, so the bucket's rows stack into shape-uniform ``(B,
…)`` tensors.  Queries
whose survivor count exceeds the capacity tier are re-run once, as a
subset, at full capacity.  A suggest bucket (``sig.cands > 0``) runs the
count-only pass instead (``core.engine.dispatch_count_batch``): no survivor
buffer and no re-run, and ``sig.capacity_tier`` is its top-K tier.  An
expression bucket (``sig.eshape`` set) runs the expression pass
(``core.engine.dispatch_expr_batch``): rows in the plan's leaf traversal
order, never re-sorted, each query with its canonical subexpression keys,
so the collected stats carry the intermediate node values for the
subexpression cache.

Mesh routing: a bucket whose signature carries ``shards > 1`` runs its
pass z-sharded over the engine's 1-D ``mesh`` (``get_sharded_set``
resolves the z-sharded mirrors), with the per-shard capacity derived from
``sig.capacity_tier``; with a 2-D ``topology``, a mesh-routed bucket
(``shards > 1`` or ``replicas > 1``) runs the 2-D pass on the engine's
replicated mirrors, and a single-device bucket is placed on the replica
row the topology's :class:`~repro_torch.exec.topology.ReplicaBalancer`
picks (``get_replica_set(r, term)``), holding that row's weight from
dispatch until collect.  Placement is not part of the signature.

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
``collect_us`` (blocking collect time) with its parts
``collect_wait_us`` / ``collect_copy_us`` / ``collect_filter_us``, the
bytes copied to the host (``d2h_bytes``) and the passes' device-clock
time (``pass_device_us``), all in one ``bump_many`` a collect, and
``dispatch_failures`` (buckets whose dispatch or collect raised).

With an ``obs`` (:class:`repro_torch.obs.Obs`) a bucket also reports
through it: the in-flight gauge and its high water, the dispatch-to-collect
latency, batch-size and survivor histograms, the per-signature profile
store, and, with its tracer on, a ``bucket`` span with ``dispatch``,
``device`` and ``collect`` children.  ``device`` runs from the end of
dispatch to the start of collect on the host clock, the same boundaries as
the JAX package's span: host time while the card works, not device
compute.  Its ``device_us`` attribute is the device-clock time of the
bucket's passes (``pass_device_us``), ``passes`` their number.
``collect`` has a ``wait``, ``copy`` and ``filter`` child for each of its
parts, in order (:class:`~repro_torch.core.engine.CollectTimes`).
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
    EXEC_COUNTERS, SHARD_AXIS, DeviceSet, PendingBatch,
    default_capacity_per_shard, default_expr_capacity_per_shard,
    dispatch_count_batch, dispatch_count_mesh2d_batch,
    dispatch_count_sharded_batch, dispatch_device_batch, dispatch_expr_batch,
    dispatch_expr_mesh2d_batch, dispatch_expr_sharded_batch,
    dispatch_mesh2d_batch, dispatch_sharded_batch, expr_total_width,
)
from ..device import Device
from ..obs.profile import sig_label
from ..obs.trace import profiler_range
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

    A bucket the balancer placed (``replica`` set) holds its row's
    in-flight ``weight`` from dispatch until the teardown, so least-loaded
    routing of the next dispatch sees it; the teardown releases it exactly
    once, flagged as a failure when the collect raised.

    With ``obs`` the bucket enters the in-flight gauge at once and, with
    the tracer on, opens its ``bucket`` span backdated to
    ``dispatched_at`` with the ``dispatch`` child already closed.  Its
    ``device`` child is host time from the end of dispatch to the start of
    collect; the passes' device-clock time is its ``device_us``.
    """

    def __init__(self, sig: ShapeSig, items: Sequence[Tuple[int, QueryPlan]],
                 pending: PendingBatch, dispatched_at: float,
                 capacity_model=None, topology=None,
                 replica: Optional[int] = None, weight: float = 0.0,
                 obs=None):
        self.sig = sig
        self.items = list(items)
        self.pending = pending
        self.dispatched_at = dispatched_at
        self.dispatch_end_at = time.perf_counter()
        self.capacity_model = capacity_model
        self.topology = topology
        self.replica = replica
        self.weight = weight
        self.obs = obs
        self.span = None
        self._out: Optional[Dict[int, Tuple[np.ndarray, Dict]]] = None
        self._finished = False
        if obs is not None:
            obs.inflight.inc()
            obs.inflight_high_water.set(obs.inflight.value)
            if obs.tracer.enabled:
                self.span = obs.tracer.start(
                    "bucket", start_us=dispatched_at * 1e6,
                    sig=sig_label(sig), batch=len(self.items),
                    replica=replica)
                obs.tracer.span_at(
                    "dispatch", dispatched_at * 1e6,
                    self.dispatch_end_at * 1e6, parent=self.span)

    def is_ready(self) -> bool:
        """Non-blocking peek: True when the first pass has finished."""
        return self.pending.is_ready()

    def _finish(self, failed: bool = False) -> None:
        """One-shot teardown on the first collect completion or failure:
        releases the balancer weight and leaves the in-flight gauge;
        ``failed`` also counts a ``dispatch_failures`` (in ``obs`` too) and
        closes the bucket span with ``error=True``."""
        if self._finished:
            return
        self._finished = True
        if self.replica is not None and self.topology is not None:
            self.topology.balancer.release(self.replica, self.weight,
                                           failed=failed)
        EXEC_COUNTERS.bump_many({"inflight_collects": 1,
                                 "dispatch_failures": int(failed)})
        _inflight_exit()
        if self.obs is not None:
            self.obs.inflight.dec()
            if failed:
                self.obs.dispatch_failures.inc()
                if self.span is not None:
                    self.span.end(error=True)

    def collect(self) -> Dict[int, Tuple[np.ndarray, Dict]]:
        """Block for the bucket's results: {query_index: (values, stats)}.
        Stamps ``batch_us`` (and the ``replica`` of a placed bucket), adds
        the blocking time to ``collect_us``, with its parts, bytes and
        device time, and feeds the capacity model.  With ``obs``: the
        latency, batch-size and survivor observations, the profile sample,
        and the ``device`` and ``collect`` children (the latter with its
        ``wait`` / ``copy`` / ``filter`` children) that close the bucket
        span."""
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
        times = self.pending.times
        EXEC_COUNTERS.bump_many({"collect_us": int((c1 - c0) * 1e6),
                                 **times.counters()})
        us = (c1 - self.dispatched_at) * 1e6
        out: Dict[int, Tuple[np.ndarray, Dict]] = {}
        for (qi, _), (values, stats) in zip(self.items, results):
            stats["batch_us"] = us / len(self.items)
            if self.replica is not None:
                stats["replica"] = self.replica
            out[qi] = (values, stats)
        if self.capacity_model is not None:
            self.capacity_model.observe_bucket(
                self.sig, [stats for _, stats in out.values()])
        if self.obs is not None:
            self.obs.collect_latency.observe(us)
            self.obs.batch_size.observe(len(self.items))
            for _, stats in out.values():
                if "r" in stats:
                    self.obs.survivors.observe(stats["r"])
            self.obs.profile.observe(self.sig, len(self.items), us)
            if self.span is not None:
                tracer = self.obs.tracer
                tracer.span_at(
                    "device", self.dispatch_end_at * 1e6, c0 * 1e6,
                    parent=self.span, device_us=times.device_us,
                    passes=times.passes)
                collect = tracer.span_at(
                    "collect", c0 * 1e6, c1 * 1e6, parent=self.span)
                for name, t0, t1 in times.parts:
                    tracer.span_at(name, t0 * 1e6, t1 * 1e6, parent=collect)
                self.span.end()
        self._out = out
        return out


def _placed(topology, weight: float, dispatch: Callable[[int], PendingBatch]):
    """Run ``dispatch`` on the replica row the balancer picks for
    ``weight``; a dispatch that raises gives the weight back at once
    (nothing will collect it).  Returns (pending, replica)."""
    replica = topology.balancer.acquire(weight)
    try:
        pending = dispatch(replica)
    except BaseException:
        topology.balancer.release(replica, weight, failed=True)
        raise
    EXEC_COUNTERS.bump("replica_dispatches")
    return pending, replica


def dispatch_bucket(
    get_set: Callable[[object], DeviceSet],
    sig: ShapeSig,
    items: Sequence[Tuple[int, QueryPlan]],
    device: Device = "cuda",
    capacity_model=None,
    mesh=None,
    shard_axis: str = SHARD_AXIS,
    get_sharded_set: Optional[Callable[[object], object]] = None,
    topology=None,
    get_replica_set: Optional[Callable[[int, object], DeviceSet]] = None,
    obs=None,
) -> InFlightBucket:
    """Enqueue ONE same-signature bucket without blocking; ``get_set``
    resolves a planned term to its DeviceSet.

    Routing: with a ``topology``, a mesh-routed signature (``shards > 1``
    or ``replicas > 1``) runs the 2-D pass on ``get_sharded_set``'s
    replicated mirrors; ``shards > 1`` on a 1-D ``mesh`` runs the sharded
    pass (``get_sharded_set``, falling back to ``get_set``); a
    single-device bucket on a topology of several replicas runs on the
    least-loaded row (``get_replica_set(r, term)``, weight ``B * G`` for a
    point bucket, ``B * C * G`` for a count bucket, ``B`` times the total
    leaf width for an expression bucket), counted in
    ``replica_dispatches``; anything else runs on ``device``.  The
    per-shard capacity derives from ``sig.capacity_tier``.

    Bumps ``inflight_dispatches``; the pipeline bumps its pass counters.
    A dispatch that raises bumps ``dispatch_failures``.  Dispatches must be
    serialized by the caller (the lazy mirror builders are not locked);
    collects need no lock.  ``capacity_model`` is fed at collect; ``obs``
    (a :class:`repro_torch.obs.Obs`, or None for ``EXEC_COUNTERS`` only)
    gets the bucket's metrics and spans."""
    t0 = time.perf_counter()
    replica: Optional[int] = None
    weight = 0.0
    mesh_routed = topology is not None and (sig.shards > 1
                                            or sig.replicas > 1)
    sharded = not mesh_routed and sig.shards > 1
    placed = (not mesh_routed and not sharded and topology is not None
              and topology.replicas > 1 and get_replica_set is not None)
    resolve = get_sharded_set or get_set
    if mesh_routed and get_sharded_set is None:
        raise ValueError("2-D buckets resolve through the engine's "
                         "replicated mirrors (get_sharded_set)")
    if sharded and mesh is None:
        raise ValueError("a sharded bucket needs the engine's mesh")
    try:
        with profiler_range("bucket.dispatch"):
            if sig.eshape is not None:
                # plan.terms IS the leaf traversal order: never re-sorted
                sub_keys = [subexpr_keys(plan.expr) for _, plan in items]

                def rows(get):
                    return [[get(t) for t in plan.terms] for _, plan in items]

                if mesh_routed or sharded:
                    cap = default_expr_capacity_per_shard(
                        sig.ts, sig.gmaxes, sig.shards,
                        capacity=sig.capacity_tier)
                if mesh_routed:
                    pending = dispatch_expr_mesh2d_batch(
                        rows(resolve), sig.eshape, topology,
                        capacity_per_shard=cap, sub_keys=sub_keys)
                elif sharded:
                    pending = dispatch_expr_sharded_batch(
                        rows(resolve), sig.eshape, mesh, axis=shard_axis,
                        capacity_per_shard=cap, sub_keys=sub_keys)
                elif placed:
                    weight = float(len(items)
                                   * expr_total_width(sig.ts, sig.gmaxes))
                    pending, replica = _placed(
                        topology, weight, lambda r: dispatch_expr_batch(
                            rows(lambda t: get_replica_set(r, t)), sig.eshape,
                            capacity=sig.capacity_tier, sub_keys=sub_keys,
                            device=topology.replica_device(r)))
                else:
                    pending = dispatch_expr_batch(
                        rows(get_set), sig.eshape, capacity=sig.capacity_tier,
                        sub_keys=sub_keys, device=device)
            elif sig.cands > 0:
                # plan.terms is (probe, *candidates), candidates ascending: the
                # order the count pass's tie-break reads as "smallest id first"
                def rows(get):
                    return [(get(plan.terms[0]), [get(t) for t in plan.terms[1:]])
                            for _, plan in items]

                k = sig.capacity_tier
                if mesh_routed:
                    pending = dispatch_count_mesh2d_batch(rows(resolve), k,
                                                          topology)
                elif sharded:
                    pending = dispatch_count_sharded_batch(rows(resolve), k, mesh,
                                                           axis=shard_axis)
                elif placed:
                    weight = float(len(items) * sig.cands * (1 << max(sig.ts)))
                    pending, replica = _placed(
                        topology, weight, lambda r: dispatch_count_batch(
                            rows(lambda t: get_replica_set(r, t)), k,
                            device=topology.replica_device(r)))
                else:
                    pending = dispatch_count_batch(rows(get_set), k,
                                                   device=device)
            else:
                def rows(get):
                    return [[get(t) for t in plan.terms] for _, plan in items]

                if mesh_routed or sharded:
                    cap = default_capacity_per_shard(sig.ts, sig.shards,
                                                     capacity=sig.capacity_tier)
                if mesh_routed:
                    pending = dispatch_mesh2d_batch(rows(resolve), topology,
                                                    capacity_per_shard=cap)
                elif sharded:
                    pending = dispatch_sharded_batch(rows(resolve), mesh,
                                                     axis=shard_axis,
                                                     capacity_per_shard=cap)
                elif placed:
                    weight = float(len(items) * (1 << sig.ts[-1]))  # B * G rows
                    pending, replica = _placed(
                        topology, weight, lambda r: dispatch_device_batch(
                            rows(lambda t: get_replica_set(r, t)),
                            capacity=sig.capacity_tier,
                            device=topology.replica_device(r)))
                else:
                    pending = dispatch_device_batch(rows(get_set),
                                                    capacity=sig.capacity_tier,
                                                    device=device)
    except BaseException:
        EXEC_COUNTERS.bump("dispatch_failures")
        if obs is not None:
            obs.dispatch_failures.inc()
        raise
    EXEC_COUNTERS.bump("inflight_dispatches")
    _inflight_enter()
    return InFlightBucket(sig, items, pending, t0,
                          capacity_model=capacity_model, topology=topology,
                          replica=replica, weight=weight, obs=obs)


def execute_bucket(
    get_set: Callable[[object], DeviceSet],
    sig: ShapeSig,
    items: Sequence[Tuple[int, QueryPlan]],
    device: Device = "cuda",
    capacity_model=None,
    obs=None,
    **layout,
) -> Dict[int, Tuple[np.ndarray, Dict]]:
    """Execute ONE same-signature bucket: {query_index: (values, stats)}.
    The synchronous composition of :func:`dispatch_bucket` and
    :meth:`InFlightBucket.collect`; ``layout`` takes its ``mesh``,
    ``shard_axis``, ``get_sharded_set``, ``topology`` and
    ``get_replica_set``."""
    return dispatch_bucket(get_set, sig, items, device=device,
                           capacity_model=capacity_model, obs=obs,
                           **layout).collect()


def execute_plan_buckets(
    get_set: Callable[[object], DeviceSet],
    indexed_plans: Iterable[Tuple[int, QueryPlan]],
    device: Device = "cuda",
    capacity_model=None,
    max_inflight: int = 4,
    obs=None,
    **layout,
) -> Dict[int, Tuple[np.ndarray, Dict]]:
    """Execute device plans bucket by bucket: {query_index: (values, stats)}.

    One pass per distinct signature (plus rare overflow re-runs), with up to
    ``max_inflight`` buckets dispatched ahead of their collection.  All
    results are collected before returning.  ``layout`` is passed to
    :func:`dispatch_bucket` (mesh and topology routing), and so is ``obs``.
    """
    out: Dict[int, Tuple[np.ndarray, Dict]] = {}
    window: List[InFlightBucket] = []
    for sig, items in bucket_plans(indexed_plans).items():
        window.append(dispatch_bucket(get_set, sig, items, device=device,
                                      capacity_model=capacity_model,
                                      obs=obs, **layout))
        if len(window) >= max(1, max_inflight):
            out.update(window.pop(0).collect())
    for bucket in window:
        out.update(bucket.collect())
    return out


def execute_name_queries(
    sets: Mapping[object, DeviceSet],
    queries: Sequence[Sequence],
    device: Device = "cuda",
    mesh=None,
    shard_axis: str = SHARD_AXIS,
    shard_min_g: Optional[int] = None,
    get_sharded_set: Optional[Callable[[object], object]] = None,
    topology=None,
    get_replica_set: Optional[Callable[[int, object], DeviceSet]] = None,
) -> List[Tuple[np.ndarray, Dict]]:
    """``BatchedEngine.query_many`` backend: plan -> bucket -> execute ->
    scatter.  Unknown names raise KeyError; duplicate names within a query
    are deduped by the planner; results return in request order.  With a
    ``mesh`` (or a 2-D ``topology``) large plans route to the mesh per
    ``shard_min_g``, resolving mirrors through the engine's lazy builders
    (``get_sharded_set``, ``get_replica_set``)."""
    for q in queries:
        for name in q:
            if name not in sets:
                raise KeyError(name)
    if topology is not None:
        mesh_shards, mesh_replicas = topology.shards, topology.replicas
    else:
        mesh_shards = mesh.shape[shard_axis] if mesh is not None else 1
        mesh_replicas = 1
    plan_kw = {} if shard_min_g is None else {"shard_min_g": shard_min_g}
    plans = [plan_query(sets, q, hashbin_ratio=float("inf"),
                        mesh_shards=mesh_shards, mesh_replicas=mesh_replicas,
                        **plan_kw)
             for q in queries]
    by_index = execute_plan_buckets(
        lambda name: sets[name],
        [(i, p) for i, p in enumerate(plans) if p.algorithm == "device"],
        device=device, mesh=mesh, shard_axis=shard_axis,
        get_sharded_set=get_sharded_set, topology=topology,
        get_replica_set=get_replica_set,
    )
    # fresh objects per miss: callers annotate stats dicts in place
    return [
        by_index[i] if i in by_index else (np.empty(0, np.uint32),
                                           {"r": 0, "batch_size": 0})
        for i in range(len(queries))
    ]
