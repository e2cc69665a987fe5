"""Conjunctive-query search serving — the paper's own application.

Builds the pre-processed index (one PrefixIndex per term posting list,
host-side numpy), mirrors every list to the device, and serves conjunctive
AND-queries and boolean ∪/∩/∖ expressions: every request batch is
**planned** (terms deduped, resolved, routed per the paper's §3.4 online
policy — HashBin on the host when the size ratio is extreme, RanGroupScan
on the device otherwise, or on the host for an engine built with
``use_device=False``; an expression is canonicalized, and one that is not
a bare conjunction runs the expression pass on the device, or on the host
without one),
**bucketed** by static shape signature, **executed** one pass per bucket,
and the results **scattered** back in request order.  Single-query
``query`` is a batch of one.  A query is a term list, an
``exec.expr.Expr`` or a ``parse`` string (``"(1|2)&3-4"``).

With a 1-D ``mesh`` (``core.engine.make_shard_mesh``) the engines run
queries whose largest set has at least ``shard_min_g`` group tuples
z-sharded over it (``rangroupscan/sharded``, ``expr/sharded``,
``suggest/sharded``); with a 2-D ``topology`` (``exec.topology.
make_topology``) they run them over its replica rows (``.../mesh2d``) and
spread single-device buckets over the rows.  On one GPU the mesh lists the
card several times: ``make_shard_mesh(4, devices=["cuda:0"] * 4)``.

An optional LRU result cache keyed on the normalized plan answers repeated
queries without touching the device; it also remembers the values of
canonical subexpressions, so an expression sharing a cached subtree is
merged on the host (``expr/subcache``).  :meth:`SearchEngine.warm` runs
the hot shape signatures of a sample workload before live traffic.

Two front ends share that pipeline: :class:`SearchEngine`, synchronous (the
caller hands over a batch and blocks for it), and
:class:`AsyncSearchEngine`, online (callers ``submit`` single queries; an
admission queue gathers them into per-signature micro-batches and flushes
a bucket when it fills a power-of-two tier or its oldest query's deadline
budget expires, with up to ``max_inflight`` buckets dispatched before the
oldest is collected).

:class:`SuggestEngine` serves the count-only top-K suggestion path over a
corpus of sets on the same substrate: a host pre-filter, one plan per
candidate shape class, the bucketed count passes, a host merge.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import (
    EXEC_COUNTERS, SHARD_MIN_G, BatchedEngine, gmax_tier, pow2_tiers,
)
from ..core.hashing import default_permutation, random_hash_family
from ..core.intersect import hashbin, rangroupscan
from ..core.partition import preprocess_prefix
from ..device import Device
from ..exec.adaptive import AdaptiveDeadline, CapacityModel, adaptive_key
from ..exec.batch import InFlightBucket, dispatch_bucket, execute_plan_buckets
from ..exec.cache import ResultCache
from ..exec.candidates import CandidateIndex
from ..exec.expr import (
    And, Diff, Expr, Or, Term, canonicalize, eval_host, expr_key,
)
from ..exec.plan import QueryPlan, ShapeSig, plan_query, plan_suggest
from ..obs import get_obs, sig_label
from .admission import AdmissionQueue, Ticket

__all__ = ["AsyncSearchEngine", "QueryResult", "SearchEngine",
           "SuggestEngine", "SuggestResult", "repeated_query_log",
           "zipf_query_log"]


@dataclasses.dataclass
class QueryResult:
    """One served query: sorted doc ids + how they were produced.

    ``latency_us`` is per-query wall time for host paths and the amortized
    ``batch_us`` (bucket wall / bucket size) for device buckets;
    ``algorithm`` names the executed path (``"rangroupscan/device"``,
    ``"rangroupscan/sharded"``, ``"rangroupscan/mesh2d"``, the same three
    for ``"expr/..."``, ``"expr/subcache"``, ``"expr/host"``,
    ``"rangroupscan"`` (on the host), ``"hashbin"``, ``"empty"``); device
    stats include ``r``, ``tuples_survived``, ``capacity``
    (``capacity_per_shard`` on a mesh),
    ``batch_size`` (expression buckets add ``expr_width`` and
    ``subexprs``; balancer-placed buckets ``replica``); cache hits carry
    ``{"cached": True}``.  ``doc_ids`` may be shared with the result cache
    — treat it as immutable.
    """

    doc_ids: np.ndarray
    latency_us: float
    algorithm: str
    stats: Dict


def _union_sorted(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Sorted union of sorted unique arrays: ``np.union1d`` without its
    ``np.unique``."""
    out = np.sort(np.concatenate(arrays))
    if len(out) < 2:
        return out
    return out[np.concatenate(([True], out[1:] != out[:-1]))]


def _device_result_name(stats: Dict) -> str:
    """Executed-path label of a device bucket's result: the 2-D pass stamps
    ``n_replicas`` (even when 1), the sharded pass ``n_shards > 1``, and
    expression buckets ``expr_width``."""
    base = "expr" if "expr_width" in stats else "rangroupscan"
    if "n_replicas" in stats:
        return base + "/mesh2d"
    if stats.get("n_shards", 1) > 1:
        return base + "/sharded"
    return base + "/device"


class SearchEngine:
    """In-memory conjunctive search over an inverted index.

    ``device`` ("cuda" by default; "cpu" only when asked) holds the mirrors
    of every posting list and runs the device path.  ``use_device=False``
    builds no device engine: every query runs on the host (RanGroupScan,
    HashBin, host expression evaluation).  The port's default is
    ``use_device=True``, where the JAX package's ``SearchEngine`` defaults
    to the host: the port's entry points run on the card unless asked
    otherwise.  A ``mesh`` or ``topology`` implies the device.
    ``result_cache``
    (entries; 0 disables) adds the LRU result cache; it registers itself on
    the device engine's mutation hook, so :meth:`add_postings` can never
    serve stale cached results.  ``adaptive_capacity`` (True for the
    default model, or a :class:`~repro_torch.exec.adaptive.CapacityModel`)
    sizes survivor buffers from observed survivor counts instead of the
    static G/4 rule: the planner consults the model, the executor feeds it,
    and a tier change invalidates the result cache and re-warms the new
    specialization.

    ``mesh`` (a 1-D ``core.engine.Mesh``) also builds z-sharded mirrors and
    runs queries whose largest set has at least ``shard_min_g`` group
    tuples z-sharded over it; ``topology`` (an ``exec.topology.Topology``,
    exclusive with ``mesh``) runs them over its replica rows and spreads
    single-device buckets over the rows with its balancer.  ``device``
    holds the plain mirrors either way.

    ``obs`` (a :class:`repro_torch.obs.Obs`; the process-global
    :func:`~repro_torch.obs.get_obs` by default) receives every bucket's
    metrics, profile samples and, with its tracer on, spans.
    """

    def __init__(self, postings: Dict[int, np.ndarray], w: int = 256,
                 m: int = 2, seed: int = 0, hashbin_ratio: float = 100.0,
                 result_cache: int = 0, adaptive_capacity=False,
                 device: Device = "cuda", mesh=None,
                 shard_min_g: int = SHARD_MIN_G, topology=None,
                 use_device: bool = True, obs=None):
        self.obs = obs if obs is not None else get_obs()
        self.family = random_hash_family(m, w, seed=seed)
        self.perm = default_permutation(seed)
        self.w, self.m = w, m
        self.hashbin_ratio = hashbin_ratio
        self.use_device = (use_device or mesh is not None
                           or topology is not None)
        self.device = (BatchedEngine(device=device, mesh=mesh,
                                     shard_min_g=shard_min_g,
                                     topology=topology)
                       if self.use_device else None)
        t0 = time.perf_counter()
        self.index = {
            t: preprocess_prefix(p, w=w, m=m, family=self.family,
                                 perm=self.perm)
            for t, p in postings.items() if len(p)
        }
        self.build_s = time.perf_counter() - t0
        self.cache = ResultCache(result_cache)
        if self.device is not None:
            for t, idx in self.index.items():
                self.device.add(t, idx)
            # build-time adds are done; from here on every index mutation
            # stales the result cache
            self.device.on_mutate(self.cache.bump_generation)
        if isinstance(adaptive_capacity, CapacityModel):
            self.capacity_model: Optional[CapacityModel] = adaptive_capacity
        else:
            self.capacity_model = CapacityModel() if adaptive_capacity else None
        if self.capacity_model is not None:
            self.capacity_model.on_promotion(self._on_tier_promotion)
        self.warmed_sigs: List[ShapeSig] = []
        # adaptive key -> (representative query, warmed b_tiers): what a
        # tier change re-warms
        self._warm_reps: Dict[Tuple, Tuple] = {}

    def plan(self, terms) -> QueryPlan:
        """Normalize and route one query (dedup, §3.4 policy, shape sig,
        mesh routing when a mesh or topology is attached, learned capacity
        tier when an adaptive model is attached).  ``terms`` is a term
        sequence, an ``exec.expr.Expr`` or a ``parse`` string."""
        dev = self.device
        return plan_query(self.index, terms, hashbin_ratio=self.hashbin_ratio,
                          capacity_model=self.capacity_model,
                          mesh_shards=dev.n_shards if dev else 1,
                          mesh_replicas=dev.n_replicas if dev else 1,
                          shard_min_g=dev.shard_min_g if dev else SHARD_MIN_G,
                          device=dev is not None)

    def _on_tier_promotion(self, key, old_tier: int, new_tier: int) -> None:
        """Capacity-tier change hook (fired by the CapacityModel, for
        promotions and demotions alike).  Invalidates the result cache (an
        in-flight result captured against the old generation must not
        re-enter) and, when the signature was warmed, re-runs its
        representative at the warmed tiers, so the new specialization is
        seen here and not at the next live flush."""
        self.cache.invalidate()
        rep = self._warm_reps.get(key)
        if rep is None or self.device is None:
            return
        spec, b_tiers = rep
        plan = self.plan(spec)  # re-plans at the new tier
        if plan.algorithm != "device":
            return
        self.device.warm_plans([plan], top_k=1, b_tiers=b_tiers)
        if plan.sig not in self.warmed_sigs:
            self.warmed_sigs.append(plan.sig)

    def warm(self, sample_queries: Sequence, top_k: int = 8,
             b_tiers: Sequence[int] = (1,)) -> List[ShapeSig]:
        """Run the hot shape signatures of a sample workload before live
        traffic: plans ``sample_queries``, and runs one representative of
        each of the ``top_k`` most frequent device signatures at every
        batch tier in ``b_tiers`` (``core.engine.warm_from_plans``; tier
        ``b`` covers live buckets of size in ``(b/2, b]``).  Live buckets on
        a warmed signature then count no ``batch_traces``.  Returns the
        warmed signatures, most frequent first, also kept on
        ``warmed_sigs``.  Raises without a device."""
        if self.device is None:
            raise ValueError("warming is a device-path concept")
        plans = [self.plan(q) for q in sample_queries]
        self.warmed_sigs = self.device.warm_plans(plans, top_k=top_k,
                                                  b_tiers=b_tiers)
        # one representative per warmed signature, for re-warming after an
        # adaptive tier change
        warmed_keys = {adaptive_key(sig) for sig in self.warmed_sigs}
        for p in plans:
            if p.algorithm != "device":
                continue
            key = adaptive_key(p.sig)
            if key in warmed_keys and key not in self._warm_reps:
                self._warm_reps[key] = (p.query_spec(), tuple(b_tiers))
        return self.warmed_sigs

    def add_postings(self, term: int, postings: np.ndarray) -> None:
        """Add or replace one term's posting list after build: re-runs
        preprocessing, refreshes the device mirror and — via the engine's
        mutation hook, or directly without a device — stales every cached
        result."""
        idx = preprocess_prefix(np.asarray(postings, dtype=np.uint32),
                                w=self.w, m=self.m, family=self.family,
                                perm=self.perm)
        self.index[term] = idx
        if self.device is not None:
            self.device.add(term, idx)  # fires the cache hook
        else:
            self.cache.bump_generation()

    def invalidate_cache(self) -> None:
        """Explicit result-cache invalidation."""
        self.cache.invalidate()

    def _cached_result(self, plan: QueryPlan) -> Optional[QueryResult]:
        """Result-cache lookup; ``"empty"`` plans bypass the cache (no work
        to save, and their misses would skew hit-rate telemetry).

        An expression plan whose root misses gets a second chance: if any
        composite subtree of its canonical DAG is cached, the rest merges
        on the host from cached subtree values and raw postings (no device
        work, one ``subexpr_host_merges``), and the root is stored so the
        next identical query is a plain hit."""
        if plan.algorithm == "empty":
            return None
        hit = self.cache.get(plan)
        if hit is not None:
            doc_ids, algorithm = hit
            return QueryResult(doc_ids, 0.0, algorithm,
                               {"cached": True, "r": len(doc_ids)})
        if plan.expr is not None:
            doc_ids = self._resolve_expr_from_subcache(plan.expr)
            if doc_ids is not None:
                EXEC_COUNTERS.bump("subexpr_host_merges")
                result = QueryResult(
                    doc_ids, 0.0, "expr/subcache",
                    {"cached": True, "r": len(doc_ids),
                     "subexpr_merge": True})
                self._store(plan, result)
                return result
        return None

    def _resolve_expr_from_subcache(self, e: Expr) -> Optional[np.ndarray]:
        """Answer a canonical expression from cached subexpression values
        and raw leaf postings, without the device, or return None.

        Probes every composite node once (each probe counts a
        ``subexpr_cache_hits`` / ``_misses``).  With no composite subtree
        cached the query goes to the device untouched; with at least one,
        uncached nodes merge on the host with the oracle's semantics, so
        the answer is the device's bit for bit.  Every operand is a sorted
        unique array (a leaf's postings are unique by construction), so the
        merges sort and never call ``np.unique``, which recent numpy
        releases run through a hash table, seconds on lists of millions."""
        probes: Dict[Tuple, Optional[np.ndarray]] = {}

        def probe(node: Expr) -> Optional[np.ndarray]:
            key = expr_key(node)
            if key not in probes:
                probes[key] = self.cache.get_sub(key)
            return probes[key]

        def any_cached(node: Expr) -> bool:
            if isinstance(node, Term):
                return False
            if probe(node) is not None:
                return True
            if isinstance(node, Diff):
                return any_cached(node.left) or any_cached(node.right)
            return any(any_cached(c) for c in node.children)

        if not any_cached(e):
            return None
        memo: Dict[Tuple, np.ndarray] = {}

        def merge(node: Expr) -> np.ndarray:
            key = expr_key(node)
            if key in memo:
                return memo[key]
            if isinstance(node, Term):
                out = np.sort(self.index[node.term].values)
            else:
                cached = probe(node)
                if cached is not None:
                    out = cached
                elif isinstance(node, And):
                    out = merge(node.children[0])
                    for c in node.children[1:]:
                        out = np.intersect1d(out, merge(c), assume_unique=True)
                elif isinstance(node, Or):
                    out = _union_sorted([merge(c) for c in node.children])
                else:
                    out = np.setdiff1d(merge(node.left), merge(node.right),
                                       assume_unique=True)
            out = out.astype(np.uint32, copy=False)
            memo[key] = out
            return out

        return merge(e)

    def _execute_host_plan(self, plan: QueryPlan) -> QueryResult:
        """Run one non-device plan: ``empty``, ``hashbin``, or ``host`` (an
        expression evaluated on the host, ``expr/host``, or a conjunction
        through RanGroupScan, ``rangroupscan``).  ``latency_us`` is the
        query's host wall time; no ``EXEC_COUNTERS`` move (they count
        device work)."""
        if plan.algorithm == "empty":
            return QueryResult(np.empty(0, np.uint32), 0.0, "empty", {})
        if plan.expr is not None:
            t0 = time.perf_counter()
            res = eval_host(plan.expr, lambda t: self.index[t].values)
            dt = (time.perf_counter() - t0) * 1e6
            return QueryResult(res, dt, "expr/host", {"r": len(res)})
        idxs = [self.index[t] for t in plan.terms]
        t0 = time.perf_counter()
        if plan.algorithm == "hashbin":
            res, stats = hashbin(idxs[0], idxs[1])
            name = "hashbin"
        else:
            res, stats = rangroupscan(idxs)
            name = "rangroupscan"
        dt = (time.perf_counter() - t0) * 1e6
        return QueryResult(res, dt, name, stats.__dict__)

    def query(self, terms) -> QueryResult:
        """Serve one query (a term list, an ``Expr`` or a ``parse``
        string) — a batch of one through :meth:`query_batch`."""
        return self.query_batch([terms])[0]

    def query_batch(self, queries: Sequence) -> List[QueryResult]:
        """Plan -> bucket -> execute -> scatter (request order preserved).

        Each query is a term list, an ``Expr`` or a ``parse`` string.
        Device-routed plans are grouped by shape signature and each bucket
        runs as ONE pass (plus rare overflow re-runs), each bumping
        ``EXEC_COUNTERS["batch_calls"]`` (``"expr_calls"`` for expression
        buckets), reporting through ``obs``.  HashBin and host plans run
        per query on the host.  Cache hits
        (and expressions merged from cached subexpressions) are answered in
        place; misses are inserted after execution.
        """
        gen = self.cache.generation  # results compute against THIS index
        plans = [self.plan(q) for q in queries]
        results: List[Optional[QueryResult]] = [None] * len(queries)
        device_plans: List[Tuple[int, QueryPlan]] = []
        for i, plan in enumerate(plans):
            cached = self._cached_result(plan)
            if cached is not None:
                results[i] = cached
            elif plan.algorithm == "device":
                device_plans.append((i, plan))
            else:
                results[i] = self._execute_host_plan(plan)
                self._store(plan, results[i], generation=gen)
        if device_plans:
            by_index = execute_plan_buckets(
                self.device.sets.__getitem__, device_plans,
                device=self.device.device,
                capacity_model=self.capacity_model, obs=self.obs,
                **self.device.routing())
            for i, plan in device_plans:
                res, stats = by_index[i]
                results[i] = QueryResult(res, stats.get("batch_us", 0.0),
                                         _device_result_name(stats), stats)
                self._store(plan, results[i], generation=gen)
        return results  # type: ignore[return-value]

    def _store(self, plan: QueryPlan, result: QueryResult,
               generation: Optional[int] = None) -> None:
        """Cache a computed result.  ``generation`` is the cache generation
        captured before execution started — the cache rejects the entry if
        a mutation landed in between.

        A computed (not cached) result also feeds the subexpression cache:
        an expression bucket's intermediate node values
        (``stats["subexprs"]``), and the root value under its canonical
        expression key (for a flat conjunction, the key of its canonical
        ``And``), so any finished query can later resolve as a shared
        subtree of a bigger expression."""
        if plan.algorithm == "empty":
            return
        self.cache.put(plan, (result.doc_ids, result.algorithm),
                       generation=generation)
        if self.cache.capacity <= 0 or result.stats.get("cached"):
            return
        for key, value in result.stats.get("subexprs", ()):
            self.cache.put_sub(key, value, generation=generation)
        if plan.expr is not None:
            root_key = expr_key(plan.expr)
        else:
            root_key = expr_key(canonicalize(
                And(tuple(Term(t) for t in plan.terms)), self.index))
        self.cache.put_sub(root_key, result.doc_ids, generation=generation)


@dataclasses.dataclass
class _Flight:
    """One dispatched-but-uncollected bucket in the serving window: the
    executor's :class:`~repro_torch.exec.batch.InFlightBucket`, the live
    (ticket, plan) entries in bucket-row order, the flush time (``wait_us``
    runs from submit to flush start, what the deadline budget bounds) and
    the result-cache generation captured before dispatch."""

    bucket: InFlightBucket
    entries: List[Tuple[Ticket, QueryPlan]]
    flush_at: float
    generation: int


class AsyncSearchEngine(SearchEngine):
    """Online front end: single-query admission, deadline-bounded flushing.

    Callers :meth:`submit` one query at a time and get a
    :class:`~repro_torch.serve.admission.Ticket` back at once.
    Device-routed plans gather in an :class:`~repro_torch.serve.admission.
    AdmissionQueue` keyed by shape signature; a bucket runs when it fills
    the power-of-two ``flush_tier`` or its earliest ``deadline_us`` budget
    expires.  Host-routed, empty and cache-hit queries resolve inside
    ``submit``.

    Two ways to flush:

    - **Manual** (default): the caller calls :meth:`pump` on a timer;
      full-tier buckets also flush inline at submit time
      (``inline_tier_flush``; a virtual-time caller that owns flush timing
      sets it False).
    - **Background flusher** (:meth:`start` / :meth:`stop`, or ``with
      engine:``): a daemon thread sleeps until the next deadline, is woken
      by every device-routed submit, and pumps; ``submit`` then only
      queues.  Each wake-up bumps ``flusher_wakeups``.  It sleeps in real
      time, so it assumes the engine ``clock`` is wall time.

    Flushing is split into *dispatch* (the bucket's pass is enqueued on
    the device, under one execution lock) and *collect* (the copy to the
    host, any overflow re-run and ticket resolution, outside it), so up to
    ``max_inflight`` buckets (default 8) are on the device at once;
    ``overlap_high_water`` records the overlap reached.  On the card each
    collect waits for its own bucket only (``core.engine``'s copy stream).
    With flights outstanding the flusher waits on the oldest one's
    collection, not on a timer.  The flusher thread runs under the
    engine's CUDA device, since the current device is per thread.

    Thread-safety: many threads may ``submit`` beside the flusher or manual
    ``pump`` / ``drain`` callers.  ``submit`` takes no engine-wide lock.
    The queue's atomic bucket pops dispatch each ticket exactly once and
    the flight list's atomic pops collect each bucket exactly once, so
    ``drain`` is idempotent and safe while the flusher runs.  The inherited
    synchronous paths (``query`` / ``query_batch`` / ``warm``) are
    single-caller: do not interleave them with concurrent submits.

    ``adaptive_capacity`` (inherited) learns capacity tiers;
    ``adaptive_deadline`` (True, or an :class:`~repro_torch.exec.adaptive.
    AdaptiveDeadline`) shrinks a signature's flush budget when its arrival
    rate cannot fill a bucket within the default; an explicit per-query
    ``deadline_us`` always wins.  ``warm_queries`` warms their hot
    signatures at construction, at ``warm_b_tiers`` (default every pow2
    tier up to ``flush_tier``, so no partial flush meets an unseen
    specialization).  The result cache defaults on (1024 entries).

    Observability (``obs``, inherited): every ticket's wait lands in
    ``queue_wait_us``; with the tracer on, each submit opens a ``request``
    root span (a ``plan`` child, an ``admission`` child for queued
    tickets, its ``route``) that closes exactly once at resolution.  The
    flusher pushes one registry snapshot onto ``obs.ring`` every
    ``snapshot_every_s`` (0 disables).
    """

    def __init__(self, postings: Dict[int, np.ndarray],
                 deadline_us: float = 2000.0, flush_tier: int = 64,
                 result_cache: int = 1024,
                 clock: Callable[[], float] = time.perf_counter,
                 warm_queries: Optional[Sequence] = None,
                 warm_top_k: int = 8,
                 warm_b_tiers: Optional[Sequence[int]] = None,
                 adaptive_deadline=False,
                 max_inflight: int = 8,
                 inline_tier_flush: bool = True,
                 snapshot_every_s: float = 1.0,
                 **kw):
        super().__init__(postings, result_cache=result_cache, **kw)
        if max_inflight < 1:
            raise ValueError("max_inflight must be at least 1")
        self.clock = clock
        self.snapshot_every_s = float(snapshot_every_s)
        self._last_snapshot_at = 0.0
        self.inline_tier_flush = bool(inline_tier_flush)
        self.admission = AdmissionQueue(flush_tier=flush_tier,
                                        deadline_us=deadline_us, clock=clock)
        # serializes bucket DISPATCH; submit never takes it and collection
        # runs outside it.  _flight_cv may be taken while holding it, never
        # the reverse.
        self._exec_lock = threading.RLock()
        self.max_inflight = int(max_inflight)
        self._flight_cv = threading.Condition()
        self._flights: List[_Flight] = []
        self._collecting = 0  # flights popped whose collect is running
        if isinstance(adaptive_deadline, AdaptiveDeadline):
            self.adaptive_deadline: Optional[AdaptiveDeadline] = \
                adaptive_deadline
        else:
            self.adaptive_deadline = (AdaptiveDeadline() if adaptive_deadline
                                      else None)
        self._wake = threading.Event()
        self._stop_flusher = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._flusher_lock = threading.Lock()  # start/stop transitions only
        self._flusher_idle_s = 0.05  # re-check cadence when the queue is empty
        self._flusher_error: Optional[BaseException] = None
        if warm_queries is not None:
            if warm_b_tiers is None:
                warm_b_tiers = pow2_tiers(flush_tier)
            self.warm(warm_queries, top_k=warm_top_k, b_tiers=warm_b_tiers)

    # -- background flusher lifecycle ---------------------------------------

    def start(self) -> "AsyncSearchEngine":
        """Start the background flusher thread (idempotent); returns
        ``self``.  Daemonized, but call :meth:`stop` for a clean shutdown
        that drains in-flight tickets."""
        with self._flusher_lock:
            if self._flusher is not None and self._flusher.is_alive():
                return self
            self._stop_flusher.clear()
            self._flusher = threading.Thread(
                target=self._flusher_loop, name="repro-torch-flusher",
                daemon=True)
            self._flusher.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the flusher (idempotent) and, by default, drain: join the
        thread, then flush every pending bucket so no ticket stays
        unresolved.  Raises if the flusher hit an error outside a bucket
        (tickets were still drained)."""
        with self._flusher_lock:
            thread = self._flusher
            self._flusher = None
            if thread is not None:
                self._stop_flusher.set()
                self._wake.set()
                thread.join()
                self._wake.clear()
        if drain:
            self.drain()
            if self.pending():
                self.drain()  # a submit raced the join; its bucket is here
        error, self._flusher_error = self._flusher_error, None
        if error is not None:
            raise RuntimeError(
                "background flusher hit a non-bucket error "
                "(tickets were still drained)") from error

    @property
    def running(self) -> bool:
        """True while the background flusher thread is alive."""
        thread = self._flusher
        return thread is not None and thread.is_alive()

    def __enter__(self) -> "AsyncSearchEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    def _flusher_loop(self) -> None:
        """Each round: dispatch every due bucket (window-bounded), collect
        the flights already finished without blocking, then wait: on the
        oldest flight's collection while flights are out, else until the
        next admission deadline (or the idle re-check), cut short by a
        submit's wake.  Every ``snapshot_every_s`` a wake also pushes a
        registry snapshot onto ``obs.ring``.  Runs under the engine's CUDA
        device: the current device is per thread."""
        dev = self.device.device if self.device is not None else None
        with (torch.cuda.device(dev) if dev is not None and dev.type == "cuda"
              else contextlib.nullcontext()):
            while True:
                next_us = self.admission.next_deadline_in_us()
                if self._inflight_count() == 0:
                    timeout = (self._flusher_idle_s if next_us is None
                               else max(0.0, next_us * 1e-6))
                    if timeout > 0:
                        self._wake.wait(timeout)
                if self._stop_flusher.is_set():
                    # collect what is still in flight, so stop()'s drain only
                    # deals with the queue
                    while self._collect_one():
                        pass
                    return
                self._wake.clear()
                EXEC_COUNTERS.bump("flusher_wakeups")
                if self.snapshot_every_s > 0:
                    now_mono = time.monotonic()
                    if (now_mono - self._last_snapshot_at
                            >= self.snapshot_every_s):
                        self._last_snapshot_at = now_mono
                        self.obs.ring.push(now_mono,
                                           self.obs.registry.snapshot())
                try:
                    self._flush(self.admission.take_due())
                    while self._collect_one(ready_only=True):
                        pass
                    if not self._wake.is_set():
                        self._collect_one()
                except Exception as exc:  # bucket failures already resolved
                    # their tickets; anything else surfaces on the next stop()
                    self._flusher_error = exc

    # -- admission API ------------------------------------------------------

    def submit(self, terms,
               deadline_us: Optional[float] = None,
               arrival_at: Optional[float] = None) -> Ticket:
        """Admit one query (a term list, an ``Expr`` or a ``parse``
        string); returns a Ticket resolving to a QueryResult.

        Empty, host-routed and cache-hit queries resolve before return, and
        so does an expression merged from cached subexpressions (route
        ``subcache``: ``algorithm`` ``"expr/subcache"``); device-routed ones
        resolve when their bucket flushes (full tier, deadline or
        ``drain``).  With the flusher running, submit only queues and
        wakes it.  ``arrival_at`` (engine-clock seconds) back-stamps the
        query's scheduled arrival, so an open-loop generator's lateness counts
        in the wait and the budget, on every path.

        With the tracer on, the submit opens a ``request`` root span with a
        ``plan`` child and sets its ``route``: ``cache``, ``subcache``,
        ``host`` (with ``algorithm``) or ``device`` (with the signature's
        label); a raise before the ticket exists ends it with
        ``error=True``.
        """
        span = (self.obs.tracer.start("request")
                if self.obs.tracer.enabled else None)
        try:
            if span is not None:
                with span.child("plan"):
                    plan = self.plan(terms)
            else:
                plan = self.plan(terms)
            cached = self._cached_result(plan)
            if cached is not None:
                if span is not None:
                    span.set(route=("subcache" if cached.stats.get(
                        "subexpr_merge") else "cache"))
                return self._resolved_now(cached, arrival_at, span=span)
            if plan.algorithm != "device":
                if span is not None:
                    span.set(route="host", algorithm=plan.algorithm)
                gen = self.cache.generation
                result = self._execute_host_plan(plan)
                self._store(plan, result, generation=gen)
                return self._resolved_now(result, arrival_at, span=span)
        except BaseException:
            if span is not None:
                span.end(error=True)
            raise
        if span is not None:
            span.set(route="device", sig=sig_label(plan.sig))
        if self.adaptive_deadline is not None:
            key = adaptive_key(plan.sig)
            self.adaptive_deadline.observe(key, self.clock())
            if deadline_us is None:
                deadline_us = self.adaptive_deadline.budget_for(
                    key, self.admission.deadline_us)
        ticket = self.admission.submit(plan.sig, plan, deadline_us,
                                       submitted_at=arrival_at,
                                       span=span, obs=self.obs)
        if self.running:
            # the queue reports 0 for full tiers, so the wake covers both
            # the tier flush and a new earliest deadline
            self._wake.set()
            if self.running:
                return ticket
            # the flusher stopped between the enqueue and the wake: fall
            # through to manual mode (stop() re-drains partial buckets)
        if self.inline_tier_flush:
            self._flush(self.admission.take_full())
            self._collect_all()
        return ticket

    def pump(self) -> int:
        """Flush the buckets whose deadline expired or whose tier filled;
        returns #buckets flushed.  Dispatches them back to back
        (window-bounded), then collects every flight before returning."""
        count = self._flush(self.admission.take_due())
        self._collect_all()
        return count

    def drain(self) -> int:
        """Flush every pending bucket now; returns #buckets flushed.
        Afterwards every ticket issued before the call is resolved, also
        those of flights another thread was collecting.  Idempotent and
        safe while the flusher runs."""
        count = self._flush(self.admission.take_all())
        self._collect_all()
        self._wait_flights()
        return count

    def pending(self) -> int:
        """Queued, unflushed submissions (device path only)."""
        return self.admission.pending()

    def _resolved_now(self, result: QueryResult,
                      arrival_at: Optional[float] = None,
                      span=None) -> Ticket:
        """A ticket resolved inside ``submit``; with ``arrival_at`` its wait
        is the submitter's lateness (scheduled arrival to now).  The root
        ``span`` closes through the ticket's resolution, as on the queued
        path."""
        now = self.clock()
        arrival = now if arrival_at is None else min(float(arrival_at), now)
        ticket = Ticket(submitted_at=arrival, deadline_us=0.0)
        ticket.span = span
        ticket.obs = self.obs
        ticket.resolve(result, wait_us=(now - arrival) * 1e6)
        return ticket

    def _flush(self, buckets) -> int:
        """Dispatch flushed buckets into the in-flight window; returns
        #buckets dispatched.  Dispatch runs under ``_exec_lock``; when the
        window is full this thread collects the oldest flight to free a
        slot.  After the last dispatch the queue is polled again, so a
        deadline that expired meanwhile is not left for the next pump.  A
        bucket whose dispatch raises resolves its tickets with the error."""
        count = 0
        pending = list(buckets)
        while pending:
            with self._exec_lock:
                while pending and self._inflight_count() < self.max_inflight:
                    sig, entries = pending.pop(0)
                    self._dispatch_one(sig, entries)
                    count += 1
                    if not pending:
                        pending.extend(self.admission.take_due())
            if pending and not self._collect_one():
                # window full of flights other threads are collecting:
                # wait for one to finish
                with self._flight_cv:
                    if not self._flights and self._collecting:
                        self._flight_cv.wait(0.01)
        return count

    def _dispatch_one(self, sig, entries) -> None:
        """Dispatch one admission bucket (caller holds ``_exec_lock``).

        An index mutation between submit and flush can re-tier a queued
        term, so each plan is re-planned from its query; entries whose
        signature changed run through the synchronous path and resolve at
        once.  ``wait_us`` runs from submit to this dispatch.  The pickup
        ends each ticket's ``admission`` span; a traced bucket's span lists
        its member traces and each member's root names the bucket span and
        its replica.
        """
        flush_at = self.clock()
        for ticket, _ in entries:
            if ticket.admission_span is not None:
                ticket.admission_span.end()
        live = []
        for ticket, plan in entries:
            if self.plan(plan.query_spec()).sig == sig:
                live.append((ticket, plan))
                continue
            wait_us = (flush_at - ticket.submitted_at) * 1e6
            try:
                result = self.query(plan.query_spec())
            except Exception as exc:
                ticket.resolve_error(exc, wait_us=wait_us)
            else:
                ticket.resolve(result, wait_us=wait_us)
        if not live:
            return
        items = [(row, plan) for row, (_, plan) in enumerate(live)]
        gen = self.cache.generation  # capture before executing
        try:
            bucket = dispatch_bucket(
                self.device.sets.__getitem__, sig, items,
                device=self.device.device,
                capacity_model=self.capacity_model, obs=self.obs,
                **self.device.routing())
        except Exception as exc:
            for ticket, _ in live:
                ticket.resolve_error(
                    exc, wait_us=(flush_at - ticket.submitted_at) * 1e6)
            return
        if bucket.span is not None:
            bucket.span.set(traces=[t.span.trace_id for t, _ in live
                                    if t.span is not None])
            for ticket, _ in live:
                if ticket.span is not None:
                    ticket.span.set(bucket_span=bucket.span.span_id,
                                    replica=bucket.replica)
        with self._flight_cv:
            self._flights.append(_Flight(bucket, live, flush_at, gen))
            self._flight_cv.notify_all()

    # -- collection (outside the exec lock) ---------------------------------

    def _inflight_count(self) -> int:
        """Flights queued plus flights being collected (both hold slots)."""
        with self._flight_cv:
            return len(self._flights) + self._collecting

    def _collect_one(self, ready_only: bool = False) -> bool:
        """Pop and collect the oldest flight and resolve its tickets.
        Returns False when there is nothing to pop, or, with
        ``ready_only``, when the oldest flight's first pass has not
        finished (a CUDA event query: never blocks).  Pops are atomic, so
        each flight is collected exactly once."""
        with self._flight_cv:
            if not self._flights:
                return False
            if ready_only and not self._flights[0].bucket.is_ready():
                return False
            flight = self._flights.pop(0)
            self._collecting += 1
        try:
            self._resolve_flight(flight)
        finally:
            with self._flight_cv:
                self._collecting -= 1
                self._flight_cv.notify_all()
        return True

    def _collect_all(self) -> None:
        """Collect every queued flight, in dispatch order."""
        while self._collect_one():
            pass

    def _wait_flights(self) -> None:
        """Block until the window is empty: collect queued flights and wait
        out those other threads are collecting (drain's guarantee)."""
        while True:
            if self._collect_one():
                continue
            with self._flight_cv:
                if not self._flights and not self._collecting:
                    return
                self._flight_cv.wait()

    def _resolve_flight(self, flight: _Flight) -> None:
        """Collect one flight and resolve its tickets: results are cached
        under the dispatch-time generation; a failed collect resolves every
        ticket with the error."""
        try:
            by_row = flight.bucket.collect()
        except Exception as exc:
            for ticket, _ in flight.entries:
                ticket.resolve_error(
                    exc, wait_us=(flight.flush_at - ticket.submitted_at) * 1e6)
            return
        for row, (ticket, plan) in enumerate(flight.entries):
            res, stats = by_row[row]
            result = QueryResult(res, stats.get("batch_us", 0.0),
                                 _device_result_name(stats), stats)
            self._store(plan, result, generation=flight.generation)
            ticket.resolve(
                result, wait_us=(flight.flush_at - ticket.submitted_at) * 1e6)


@dataclasses.dataclass
class SuggestResult:
    """One served suggestion query.

    ``suggestions`` is the top-K list of ``(set_id, |probe ∩ candidate|)``
    pairs, best-first under the order ``(-count, smallest id)``;
    candidates with no overlap never appear.  ``algorithm`` is
    ``"suggest/device"``, ``"suggest/sharded"``, ``"suggest/mesh2d"`` or
    ``"suggest/host"``; cache hits carry
    ``{"cached": True}`` in ``stats``.
    """

    suggestions: List[Tuple[int, int]]
    latency_us: float
    algorithm: str
    stats: Dict


@dataclasses.dataclass(frozen=True)
class _SuggestCacheKey:
    """Result-cache key of a whole suggest request: the merged answer is
    what repeats in live traffic, so it is cached under ``(set_id, k)``.
    Duck-types the one method ``ResultCache`` calls."""

    set_id: int
    k: int

    def cache_key(self):
        return ("suggest_result", (self.set_id, self.k))


class SuggestEngine:
    """Top-K set-similarity suggestions over a corpus of sets.

    ``suggest(set_id, k)`` returns the ``k`` corpus sets with the largest
    intersection with the probe set, exact, equal counts ordered by the
    smaller set id.  A request batch runs:

    1. **Pre-filter** (host): the probe's hash-bin signature against every
       corpus signature (:class:`~repro_torch.exec.candidates.
       CandidateIndex`) at its defaults, which drop no candidate with a
       true overlap.
    2. **Plan**: the kept candidates split into ``(t, gmax_tier)`` shape
       classes, one :func:`~repro_torch.exec.plan.plan_suggest` plan each.
    3. **Execute**: the plans of every request bucket together by
       signature and run through :func:`~repro_torch.exec.batch.
       execute_plan_buckets`, one count pass per bucket (the ``pair_count``
       CUDA kernel on the card, then a top-K).
    4. **Merge** (host): the per-class top lists merge by ``(-count, id)``
       and are cut to ``k``; exact, because each class returns its own top
       ``min(k_tier, c_tier) >= min(k, |class|)``.

    ``device`` ("cuda" by default; "cpu" only when asked) holds the set
    mirrors; ``use_device=False`` serves every request on the host with
    exact numpy counts instead (``"suggest/host"``).  ``mesh`` /
    ``topology`` / ``shard_min_g`` route count buckets whose deeper set
    has at least ``shard_min_g`` group tuples z-sharded or 2-D, as in
    :class:`SearchEngine` (``"suggest/sharded"``, ``"suggest/mesh2d"``).
    The result cache stores merged answers per ``(set_id, k)`` and is
    stamped with the index generation, so :meth:`add_set` never lets a
    stale answer out.  ``obs`` (the global :func:`~repro_torch.obs.get_obs`
    by default) receives the count buckets' metrics and, with its tracer
    on, one ``request`` span per request (``kind="suggest"``, a ``plan``
    child, ``route`` ``cache`` / ``device`` / ``host``).
    """

    def __init__(self, corpus: Dict[int, np.ndarray], w: int = 256,
                 m: int = 2, seed: int = 0, use_device: bool = True,
                 result_cache: int = 1024, device: Device = "cuda",
                 mesh=None, shard_min_g: int = SHARD_MIN_G, topology=None,
                 obs=None):
        self.obs = obs if obs is not None else get_obs()
        self.family = random_hash_family(m, w, seed=seed)
        self.perm = default_permutation(seed)
        self.w, self.m = w, m
        self.corpus: Dict[int, np.ndarray] = {}
        self.index: Dict[int, object] = {}
        self.prefilter = CandidateIndex(self.family)
        if not use_device and (mesh is not None or topology is not None):
            raise ValueError("a mesh or topology needs use_device=True")
        self.device = (BatchedEngine(device=device, mesh=mesh,
                                     shard_min_g=shard_min_g,
                                     topology=topology)
                       if use_device else None)
        self.cache = ResultCache(result_cache)
        if self.device:
            self.device.on_mutate(self.cache.bump_generation)
        t0 = time.perf_counter()
        for set_id, values in corpus.items():
            if len(values):
                self.add_set(set_id, values)
        self.build_s = time.perf_counter() - t0

    def add_set(self, set_id: int, values: np.ndarray) -> None:
        """Add or replace one corpus set (the streaming-ingest entry
        point): preprocesses it, refreshes its device mirror and pre-filter
        signature, and stales every cached suggestion."""
        values = np.unique(np.asarray(values, np.uint32))
        idx = preprocess_prefix(values, w=self.w, m=self.m,
                                family=self.family, perm=self.perm)
        self.corpus[set_id] = values
        self.index[set_id] = idx
        self.prefilter.add(set_id, values)
        if self.device:
            self.device.add(set_id, idx)  # fires the cache hook
        else:
            self.cache.bump_generation()

    def _classes(self, candidates: Sequence[int]) -> Dict[Tuple, List[int]]:
        """The kept candidates by ``(t, gmax_tier)`` shape class, classes in
        key order and ids ascending in each (the tie-break reads the id
        order)."""
        classes: Dict[Tuple, List[int]] = {}
        for c in candidates:
            idx = self.index[c]
            classes.setdefault((idx.t, gmax_tier(idx.gmax)), []).append(c)
        return {key: sorted(classes[key]) for key in sorted(classes)}

    def _plans_for(self, set_id: int, k: int) -> List[QueryPlan]:
        """Pre-filter and per-class plans of one request."""
        cands = self.prefilter.candidates(self.corpus[set_id], exclude=set_id)
        dev = self.device
        return [plan_suggest(self.index, set_id, class_cands, k,
                             device=dev is not None,
                             mesh_shards=dev.n_shards if dev else 1,
                             mesh_replicas=dev.n_replicas if dev else 1,
                             shard_min_g=dev.shard_min_g if dev
                             else SHARD_MIN_G)
                for class_cands in self._classes(cands).values()]

    @staticmethod
    def _merge(per_class: List[List[Tuple[int, int]]], k: int
               ) -> List[Tuple[int, int]]:
        """Per-class top lists into the global top-k, by ``(-count, id)``."""
        merged = [pair for pairs in per_class for pair in pairs]
        merged.sort(key=lambda pair: (-pair[1], pair[0]))
        return merged[:k]

    def _host_counts(self, set_id: int, plan: QueryPlan
                     ) -> List[Tuple[int, int]]:
        """Host path of one class plan: exact numpy counts."""
        probe = self.corpus[set_id]
        out = []
        for c in plan.terms[1:]:
            n = len(np.intersect1d(probe, self.corpus[c]))
            if n >= 1:
                out.append((c, n))
        return out

    def suggest(self, set_id: int, k: int) -> SuggestResult:
        """Serve one suggestion query — a batch of one."""
        return self.suggest_batch([(set_id, k)])[0]

    def suggest_batch(self, requests: Sequence[Tuple[int, int]]
                      ) -> List[SuggestResult]:
        """Pre-filter -> plan -> bucket -> execute -> merge for a batch of
        ``(set_id, k)`` requests, in request order.

        The class plans of all requests bucket together, so the device
        passes (``count_calls``) number the distinct signatures, not the
        requests.  An unknown ``set_id`` raises KeyError.  A raise in the
        device passes ends every open request span with ``error=True``.
        """
        for set_id, _ in requests:
            if set_id not in self.corpus:
                raise KeyError(set_id)
        gen = self.cache.generation  # results compute against THIS index
        tracing = self.obs.tracer.enabled
        spans = [self.obs.tracer.start("request", kind="suggest",
                                       set_id=set_id, k=int(k))
                 if tracing else None
                 for set_id, k in requests]
        results: List[Optional[SuggestResult]] = [None] * len(requests)
        req_plans: Dict[int, List[Tuple[int, QueryPlan]]] = {}
        flat: List[Tuple[int, QueryPlan]] = []
        for ri, (set_id, k) in enumerate(requests):
            hit = self.cache.get(_SuggestCacheKey(set_id, int(k)))
            if hit is not None:
                suggestions, algorithm = hit
                results[ri] = SuggestResult(suggestions, 0.0, algorithm,
                                            {"cached": True, "k": int(k)})
                if spans[ri] is not None:
                    spans[ri].end(route="cache")
                continue
            plans = []
            if spans[ri] is not None:
                with spans[ri].child("plan"):
                    class_plans = self._plans_for(set_id, int(k))
            else:
                class_plans = self._plans_for(set_id, int(k))
            for plan in class_plans:
                if plan.algorithm == "device":
                    plans.append((len(flat), plan))
                    flat.append((len(flat), plan))
                else:
                    plans.append((-1, plan))
            req_plans[ri] = plans
        try:
            by_index = (execute_plan_buckets(self.device.sets.__getitem__,
                                             flat, device=self.device.device,
                                             obs=self.obs,
                                             **self.device.routing())
                        if flat else {})
        except BaseException:
            for span in spans:  # Span.end is idempotent: cache hits stay
                if span is not None:
                    span.end(error=True)
            raise
        for ri, (set_id, k) in enumerate(requests):
            if results[ri] is not None:
                continue
            per_class: List[List[Tuple[int, int]]] = []
            algorithm = "suggest/host"
            stats: Dict = {"k": int(k), "classes": len(req_plans[ri])}
            batch_us = 0.0
            for fi, plan in req_plans[ri]:
                if plan.algorithm == "empty":
                    continue
                if fi < 0:
                    per_class.append(self._host_counts(set_id, plan))
                    continue
                pairs, cstats = by_index[fi]
                cands = plan.terms[1:]
                per_class.append([(cands[int(idx)], int(count))
                                  for idx, count in pairs if count >= 1])
                algorithm = "suggest" + _device_result_name(
                    cstats).removeprefix("rangroupscan")
                batch_us += cstats.get("batch_us", 0.0)
                stats["n_cands"] = stats.get("n_cands", 0) + cstats["n_cands"]
            suggestions = self._merge(per_class, int(k))
            stats["r"] = len(suggestions)
            results[ri] = SuggestResult(suggestions, batch_us, algorithm, stats)
            if spans[ri] is not None:
                spans[ri].end(route="device" if any(
                    fi >= 0 for fi, _ in req_plans[ri]) else "host",
                    algorithm=algorithm, r=len(suggestions))
            self.cache.put(_SuggestCacheKey(set_id, int(k)),
                           (suggestions, algorithm), generation=gen)
        return results  # type: ignore[return-value]

    def warm(self, sample_ids: Sequence[int], k: int,
             b_tiers: Sequence[int] = (1,)) -> List[ShapeSig]:
        """Run the count specializations a sample of probes would meet:
        plans each sample id exactly as :meth:`suggest_batch` will
        (pre-filter included, so the candidate tiers match live traffic)
        and runs every device signature at each tier of ``b_tiers``.
        Serving those probes in buckets of up to ``max(b_tiers)`` rows then
        counts no ``count_traces``.  Returns the warmed signatures."""
        if self.device is None:
            raise ValueError("warming is a device-path concept")
        plans = [p for sid in sample_ids for p in self._plans_for(sid, k)]
        self.warmed_sigs = self.device.warm_plans(
            plans, top_k=len(plans) or 1, b_tiers=b_tiers)
        return self.warmed_sigs


def zipf_query_log(index_terms: Sequence[int], n_queries: int = 1000,
                   seed: int = 1, kw_dist=((2, 0.68), (3, 0.23), (4, 0.09))
                   ) -> List[List[int]]:
    """Synthetic query log with the paper's keyword-count distribution
    (68% 2-word, 23% 3-word, 9% 4-word) and Zipf-skewed term popularity."""
    rng = np.random.default_rng(seed)
    terms = np.asarray(sorted(index_terms))
    ks, ps = zip(*kw_dist)
    out = []
    for _ in range(n_queries):
        k = rng.choice(ks, p=np.asarray(ps) / sum(ps))
        # skewed term choice: favor low term-ids (frequent under Zipf corpus)
        idx = np.minimum(len(terms) - 1,
                         (rng.pareto(1.0, size=k) * 10).astype(int))
        out.append(sorted(set(terms[idx].tolist())) or [int(terms[0])])
    return out


def repeated_query_log(index_terms: Sequence[int], n_queries: int = 1000,
                       n_distinct: int = 64, seed: int = 1) -> List[List[int]]:
    """A live-traffic-shaped log: ``n_queries`` drawn Zipf-style from a pool
    of ``n_distinct`` conjunctions, so exact repeats occur (the regime where
    the result cache pays).  The pool follows the paper's keyword-count mix
    via :func:`zipf_query_log`."""
    pool = zipf_query_log(index_terms, n_distinct, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    return [pool[i] for i in rng.choice(len(pool), size=n_queries, p=p)]
