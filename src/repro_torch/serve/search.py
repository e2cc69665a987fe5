"""Conjunctive-query search serving — the paper's own application.

Builds the pre-processed index (one PrefixIndex per term posting list,
host-side numpy), mirrors every list to the device, and serves conjunctive
AND-queries: every request batch is **planned** (terms deduped, resolved,
routed per the paper's §3.4 online policy — HashBin on the host when the
size ratio is extreme, RanGroupScan on the device otherwise), **bucketed**
by static shape signature, **executed** one pass per bucket, and the
results **scattered** back in request order.  Single-query ``query`` is a
batch of one.

An optional LRU result cache keyed on the normalized plan answers repeated
conjunctions without touching the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import BatchedEngine
from ..core.hashing import default_permutation, random_hash_family
from ..core.intersect import hashbin
from ..core.partition import preprocess_prefix
from ..device import Device
from ..exec.batch import execute_plan_buckets
from ..exec.cache import ResultCache
from ..exec.plan import QueryPlan, plan_query

__all__ = ["QueryResult", "SearchEngine", "zipf_query_log"]


@dataclasses.dataclass
class QueryResult:
    """One served query: sorted doc ids + how they were produced.

    ``latency_us`` is per-query wall time for host paths and the amortized
    ``batch_us`` (bucket wall / bucket size) for device buckets;
    ``algorithm`` names the executed path (``"rangroupscan/device"``,
    ``"hashbin"``, ``"empty"``); device stats include ``r``,
    ``tuples_survived``, ``capacity``, ``batch_size``; cache hits carry
    ``{"cached": True}``.  ``doc_ids`` may be shared with the result cache —
    treat it as immutable.
    """

    doc_ids: np.ndarray
    latency_us: float
    algorithm: str
    stats: Dict


class SearchEngine:
    """In-memory conjunctive search over an inverted index.

    ``device`` ("cuda" by default; "cpu" only when asked) holds the mirrors
    of every posting list and runs the device path.  ``result_cache``
    (entries; 0 disables) adds the LRU result cache; it registers itself on
    the device engine's mutation hook, so :meth:`add_postings` can never
    serve stale cached results.
    """

    def __init__(self, postings: Dict[int, np.ndarray], w: int = 256,
                 m: int = 2, seed: int = 0, hashbin_ratio: float = 100.0,
                 result_cache: int = 0,
                 device: Device = "cuda"):
        self.family = random_hash_family(m, w, seed=seed)
        self.perm = default_permutation(seed)
        self.w, self.m = w, m
        self.hashbin_ratio = hashbin_ratio
        self.device = BatchedEngine(device=device)
        t0 = time.perf_counter()
        self.index = {
            t: preprocess_prefix(p, w=w, m=m, family=self.family,
                                 perm=self.perm)
            for t, p in postings.items() if len(p)
        }
        self.build_s = time.perf_counter() - t0
        for t, idx in self.index.items():
            self.device.add(t, idx)
        self.cache = ResultCache(result_cache)
        # build-time adds are done; from here on every index mutation
        # stales the result cache
        self.device.on_mutate(self.cache.bump_generation)

    def plan(self, terms) -> QueryPlan:
        """Normalize and route one query (dedup, §3.4 policy, shape sig)."""
        return plan_query(self.index, terms, hashbin_ratio=self.hashbin_ratio)

    def add_postings(self, term: int, postings: np.ndarray) -> None:
        """Add or replace one term's posting list after build: re-runs
        preprocessing, refreshes the device mirror and — via the engine's
        mutation hook — stales every cached result."""
        idx = preprocess_prefix(np.asarray(postings, dtype=np.uint32),
                                w=self.w, m=self.m, family=self.family,
                                perm=self.perm)
        self.index[term] = idx
        self.device.add(term, idx)

    def invalidate_cache(self) -> None:
        """Explicit result-cache invalidation."""
        self.cache.invalidate()

    def _cached_result(self, plan: QueryPlan) -> Optional[QueryResult]:
        """Result-cache lookup; ``"empty"`` plans bypass the cache (no work
        to save, and their misses would skew hit-rate telemetry)."""
        if plan.algorithm == "empty":
            return None
        hit = self.cache.get(plan)
        if hit is None:
            return None
        doc_ids, algorithm = hit
        return QueryResult(doc_ids, 0.0, algorithm,
                           {"cached": True, "r": len(doc_ids)})

    def _execute_host_plan(self, plan: QueryPlan) -> QueryResult:
        """Run one non-device plan (``empty`` / ``hashbin``)."""
        if plan.algorithm == "empty":
            return QueryResult(np.empty(0, np.uint32), 0.0, "empty", {})
        if plan.algorithm != "hashbin":
            raise ValueError(f"no host path for {plan.algorithm!r}")
        a, b = (self.index[t] for t in plan.terms)
        t0 = time.perf_counter()
        res, stats = hashbin(a, b)
        dt = (time.perf_counter() - t0) * 1e6
        return QueryResult(res, dt, "hashbin", stats.__dict__)

    def query(self, terms: Sequence[int]) -> QueryResult:
        """Serve one query — a batch of one through :meth:`query_batch`."""
        return self.query_batch([terms])[0]

    def query_batch(self, queries: Sequence[Sequence[int]]) -> List[QueryResult]:
        """Plan -> bucket -> execute -> scatter (request order preserved).

        Device-routed plans are grouped by shape signature and each bucket
        runs as ONE pass (plus rare overflow re-runs), each bumping
        ``EXEC_COUNTERS["batch_calls"]``.  HashBin plans run per query on
        the host.  Cache hits are answered in place; misses are inserted
        after execution.
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
                lambda term: self.device.sets[term], device_plans,
                device=self.device.device)
            for i, plan in device_plans:
                res, stats = by_index[i]
                # the port's one device path: single device, flat conjunctions
                results[i] = QueryResult(res, stats.get("batch_us", 0.0),
                                         "rangroupscan/device", stats)
                self._store(plan, results[i], generation=gen)
        return results  # type: ignore[return-value]

    def _store(self, plan: QueryPlan, result: QueryResult,
               generation: Optional[int] = None) -> None:
        """Cache a computed result.  ``generation`` is the cache generation
        captured before execution started — the cache rejects the entry if
        a mutation landed in between."""
        if plan.algorithm == "empty":
            return
        self.cache.put(plan, (result.doc_ids, result.algorithm),
                       generation=generation)


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
