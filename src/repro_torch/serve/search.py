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

:class:`SuggestEngine` serves the count-only top-K suggestion path over a
corpus of sets on the same substrate: a host pre-filter, one plan per
candidate shape class, the bucketed count passes, a host merge.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import BatchedEngine, gmax_tier
from ..core.hashing import default_permutation, random_hash_family
from ..core.intersect import hashbin
from ..core.partition import preprocess_prefix
from ..device import Device
from ..exec.batch import execute_plan_buckets
from ..exec.cache import ResultCache
from ..exec.candidates import CandidateIndex
from ..exec.plan import QueryPlan, plan_query, plan_suggest

__all__ = ["QueryResult", "SearchEngine", "SuggestEngine", "SuggestResult",
           "zipf_query_log"]


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


@dataclasses.dataclass
class SuggestResult:
    """One served suggestion query.

    ``suggestions`` is the top-K list of ``(set_id, |probe ∩ candidate|)``
    pairs, best-first under the order ``(-count, smallest id)``;
    candidates with no overlap never appear.  ``algorithm`` is
    ``"suggest/device"`` or ``"suggest/host"``; cache hits carry
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
    exact numpy counts instead (``"suggest/host"``).  The result cache
    stores merged answers per ``(set_id, k)`` and is stamped with the
    index generation, so :meth:`add_set` never lets a stale answer out.
    """

    def __init__(self, corpus: Dict[int, np.ndarray], w: int = 256,
                 m: int = 2, seed: int = 0, use_device: bool = True,
                 result_cache: int = 1024, device: Device = "cuda"):
        self.family = random_hash_family(m, w, seed=seed)
        self.perm = default_permutation(seed)
        self.w, self.m = w, m
        self.corpus: Dict[int, np.ndarray] = {}
        self.index: Dict[int, object] = {}
        self.prefilter = CandidateIndex(self.family)
        self.device = BatchedEngine(device=device) if use_device else None
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
        return [plan_suggest(self.index, set_id, class_cands, k,
                             device=self.device is not None)
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
        requests.  An unknown ``set_id`` raises KeyError.
        """
        for set_id, _ in requests:
            if set_id not in self.corpus:
                raise KeyError(set_id)
        gen = self.cache.generation  # results compute against THIS index
        results: List[Optional[SuggestResult]] = [None] * len(requests)
        req_plans: Dict[int, List[Tuple[int, QueryPlan]]] = {}
        flat: List[Tuple[int, QueryPlan]] = []
        for ri, (set_id, k) in enumerate(requests):
            hit = self.cache.get(_SuggestCacheKey(set_id, int(k)))
            if hit is not None:
                suggestions, algorithm = hit
                results[ri] = SuggestResult(suggestions, 0.0, algorithm,
                                            {"cached": True, "k": int(k)})
                continue
            plans = []
            for plan in self._plans_for(set_id, int(k)):
                if plan.algorithm == "device":
                    plans.append((len(flat), plan))
                    flat.append((len(flat), plan))
                else:
                    plans.append((-1, plan))
            req_plans[ri] = plans
        by_index = (execute_plan_buckets(self.device.sets.__getitem__, flat,
                                         device=self.device.device)
                    if flat else {})
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
                algorithm = "suggest/device"
                batch_us += cstats.get("batch_us", 0.0)
                stats["n_cands"] = stats.get("n_cands", 0) + cstats["n_cands"]
            suggestions = self._merge(per_class, int(k))
            stats["r"] = len(suggestions)
            results[ri] = SuggestResult(suggestions, batch_us, algorithm, stats)
            self.cache.put(_SuggestCacheKey(set_id, int(k)),
                           (suggestions, algorithm), generation=gen)
        return results  # type: ignore[return-value]


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
