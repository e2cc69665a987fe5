"""The port's dispatch / collect split and serving window on the CPU,
mirroring ``tests/test_async_dispatch.py`` (its balancer, topology and
forced-multi-device cases wait for the port's sharded execution).

Covers the overlap counters, the in-flight window (``execute_plan_buckets``
at ``max_inflight`` 1 against 4, and the async engine's window bound),
failure accounting, the flusher's event-driven wait, and submitters racing
two buckets in flight.  Results are compared bit for bit (tolerance 0).
"""
import threading
import time

import numpy as np
import pytest

from repro.core.engine import EXEC_COUNTERS as JAX_COUNTERS
from repro.exec.batch import execute_plan_buckets as jax_execute_plan_buckets
from repro.serve.search import SearchEngine as JaxSearchEngine

from repro_torch.core.engine import EXEC_COUNTERS, PendingBatch
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.exec.batch import (
    bucket_plans, dispatch_bucket, execute_plan_buckets,
)
from repro_torch.serve.search import (
    AsyncSearchEngine, SearchEngine, zipf_query_log,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset_port_counters():
    EXEC_COUNTERS.reset()
    yield


@pytest.fixture(scope="module")
def postings():
    docs = zipf_corpus(3000, vocab=400, mean_len=40, seed=3)
    return inverted_index(docs)


@pytest.fixture(scope="module")
def engine(postings):
    return SearchEngine(postings, seed=3, device=CPU)


def _device_plans(eng, log):
    return [(i, p) for i, p in enumerate(map(eng.plan, log))
            if p.algorithm == "device"]


# -- PendingBatch -------------------------------------------------------------

def test_pending_batch_empty_and_memoized():
    pb = PendingBatch(n_queries=0, _collect=lambda: [])
    assert pb.is_ready()
    first = pb.collect()
    assert first == []
    assert pb.collect() is first


def test_cpu_pass_is_ready_at_dispatch(engine):
    """On the CPU the pass ran inside dispatch: no event, ready at once,
    and collect drops the handles."""
    log = zipf_query_log(sorted(engine.index), 8, seed=11)
    sig, items = next(iter(bucket_plans(_device_plans(engine, log)).items()))
    bucket = dispatch_bucket(engine.device.sets.__getitem__, sig, items,
                             device=CPU)
    assert bucket.pending.ready is None and bucket.pending.handles is not None
    assert bucket.is_ready()
    assert bucket.dispatch_end_at >= bucket.dispatched_at
    bucket.collect()
    assert bucket.pending.handles is None


# -- the in-flight window -------------------------------------------------------

@pytest.mark.parametrize("max_inflight", [1, 4])
def test_execute_plan_buckets_window_matches_jax(engine, postings,
                                                 max_inflight):
    """The window at 1 (dispatch, then collect, bucket by bucket) and at 4
    gives the same results and stats as the JAX package's executor at the
    same window, and the high-water mark follows the window."""
    log = zipf_query_log(sorted(engine.index), 24, seed=11)
    plans = _device_plans(engine, log)
    n_buckets = len(bucket_plans(plans))
    assert n_buckets >= 2, "need >= 2 signatures"
    jeng = JaxSearchEngine(postings, seed=3, use_device=True)
    want = jax_execute_plan_buckets(
        lambda term: jeng.device.sets[str(term)],
        [(i, jeng.plan(q)) for i, q in enumerate(log)
         if jeng.plan(q).algorithm == "device"],
        max_inflight=max_inflight)
    JAX_COUNTERS.reset()
    got = execute_plan_buckets(engine.device.sets.__getitem__, plans,
                               device=CPU, max_inflight=max_inflight)
    assert got.keys() == want.keys()
    for i in got:
        assert np.array_equal(got[i][0], np.asarray(want[i][0])), log[i]
        for key in ("r", "tuples_survived", "capacity", "batch_size"):
            assert got[i][1][key] == want[i][1][key], key
    snap = EXEC_COUNTERS.snapshot()
    assert snap["inflight_dispatches"] == snap["inflight_collects"] == n_buckets
    assert snap["overlap_high_water"] == min(max_inflight, n_buckets)


def test_drain_overlaps_buckets_and_counts(postings, engine):
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=64,
                            result_cache=0, max_inflight=8, device=CPU)
    log = zipf_query_log(sorted(engine.index), 24, seed=11)
    want = engine.query_batch(log)
    tickets = [eng.submit(q) for q in log]
    EXEC_COUNTERS.reset()
    n_buckets = eng.drain()
    assert n_buckets >= 2
    for q, t, b in zip(log, tickets, want):
        assert t.done
        assert np.array_equal(t.value.doc_ids, b.doc_ids), q
    assert EXEC_COUNTERS["inflight_dispatches"] == n_buckets
    assert EXEC_COUNTERS["overlap_high_water"] >= 2
    assert EXEC_COUNTERS["collect_us"] >= 0
    assert eng._inflight_count() == 0


def test_window_bound_respected(postings, engine):
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=64,
                            result_cache=0, max_inflight=1, device=CPU)
    log = zipf_query_log(sorted(engine.index), 24, seed=11)
    tickets = [eng.submit(q) for q in log]
    EXEC_COUNTERS.reset()
    eng.drain()
    assert all(t.done for t in tickets)
    assert EXEC_COUNTERS["overlap_high_water"] <= 1
    with pytest.raises(ValueError):
        AsyncSearchEngine(postings, seed=3, max_inflight=0, device=CPU)


def test_failures_are_counted_once(engine):
    """A dispatch that raises and a collect that raises each count one
    ``dispatch_failures``; the failed bucket still leaves the window."""
    log = zipf_query_log(sorted(engine.index), 8, seed=11)
    sig, items = next(iter(bucket_plans(_device_plans(engine, log)).items()))

    def missing(term):
        raise KeyError(term)

    with pytest.raises(KeyError):
        dispatch_bucket(missing, sig, items, device=CPU)
    assert EXEC_COUNTERS["dispatch_failures"] == 1
    bucket = dispatch_bucket(engine.device.sets.__getitem__, sig, items,
                             device=CPU)

    def broken():
        raise RuntimeError("copy failed")

    bucket.pending._collect = broken
    with pytest.raises(RuntimeError, match="copy failed"):
        bucket.collect()
    with pytest.raises(RuntimeError, match="copy failed"):
        bucket.collect()
    snap = EXEC_COUNTERS.snapshot()
    assert snap["dispatch_failures"] == 2
    assert snap["inflight_dispatches"] == snap["inflight_collects"] == 1


# -- the flusher ----------------------------------------------------------------

def test_flusher_resolves_before_idle_timer(postings, engine):
    """With a huge idle re-check cadence the flusher still resolves a
    deadline-flushed ticket at once: it wakes on the submit and sleeps only
    until the deadline."""
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=64,
                            deadline_us=1000.0, result_cache=0, device=CPU)
    eng._flusher_idle_s = 60.0
    with eng:
        q = zipf_query_log(sorted(engine.index), 1, seed=11)[0]
        t0 = time.perf_counter()
        ticket = eng.submit(q)
        assert ticket.wait(timeout=10.0)
        assert time.perf_counter() - t0 < 10.0
    assert eng._flusher_error is None


def test_submit_race_two_buckets_in_flight(postings, engine):
    log = zipf_query_log(sorted(engine.index), 48, seed=11)
    want = {tuple(q): r for q, r in zip(log, engine.query_batch(log))}
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=4,
                            deadline_us=500.0, result_cache=0,
                            max_inflight=4, device=CPU)
    tickets = []
    tlock = threading.Lock()

    def hammer(span):
        for q in span:
            t = eng.submit(q)
            with tlock:
                tickets.append((q, t))

    with eng:
        threads = [threading.Thread(target=hammer, args=(log[i::4],))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in threads)
        eng.drain()
    assert eng._flusher_error is None
    assert len(tickets) == len(log)
    for q, t in tickets:
        assert t.done
        assert np.array_equal(t.value.doc_ids, want[tuple(q)].doc_ids), q


# -- expressions: a FakeClock script of parse strings through both packages ----

class FakeClock:
    """Injectable clock: tests advance time explicitly (seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def shared_subtree_strings(terms, n_queries, seed):
    """``benchmarks/fig_boolean_qps.py::shared_subtree_log`` as parse
    strings over ``terms``: 3 union bases ``(t_2j | t_2j+1)``, each query
    ``base & extra``, every third ``(base & extra) - cut``."""
    rng = np.random.default_rng(seed)
    bases = [f"({terms[2 * j]}|{terms[2 * j + 1]})" for j in range(3)]
    extras = terms[6:]
    log = []
    for i in range(n_queries):
        s = f"{bases[int(rng.integers(3))]}&{extras[int(rng.integers(len(extras)))]}"
        if i % 3 == 2:
            s = f"({s})-{extras[int(rng.integers(len(extras)))]}"
        log.append(s)
    return log


EXPR_COUNTERS = ("tier_flushes", "deadline_flushes", "tickets_resolved",
                 "deadline_violations", "expr_calls", "expr_rerun_calls",
                 "batch_calls", "rerun_calls", "result_cache_hits",
                 "result_cache_misses", "subexpr_cache_hits",
                 "subexpr_cache_misses", "subexpr_cache_stores",
                 "subexpr_host_merges")


@pytest.mark.parametrize("cache", [0, 256])
def test_fakeclock_expression_script_matches_jax(postings, engine, cache):
    """Expressions (and two flat conjunctions written as expressions)
    submitted as parse strings every 250 us, a pump every third arrival
    and a drain: every ticket's doc ids, route, wait and stats, and the
    flush, ticket, pass and (sub)cache counters equal the JAX
    ``AsyncSearchEngine``'s.  With the cache on, later roots over a cached
    union base resolve at submit from the subexpression cache."""
    from repro.exec.expr import parse as jax_parse
    from repro.serve.search import AsyncSearchEngine as JaxAsyncSearchEngine
    from repro_torch.exec.expr import eval_host, parse

    terms = [t for t in sorted(engine.index)
             if 60 <= len(postings[t]) <= 160][:12]
    assert len(terms) == 12
    log = shared_subtree_strings(terms, 18, seed=5)
    log[4:4] = [f"{terms[6]}&{terms[7]}", f"({terms[8]}&{terms[9]})&{terms[8]}"]
    kw = dict(seed=3, deadline_us=2000.0, flush_tier=4, result_cache=cache)
    out = {}
    for name, cls, counters, parse_fn, extra in (
            ("jax", JaxAsyncSearchEngine, JAX_COUNTERS, jax_parse,
             {"use_device": True}),
            ("port", AsyncSearchEngine, EXEC_COUNTERS, str, {"device": CPU})):
        clk = FakeClock()
        eng = cls(postings, clock=clk, **kw, **extra)
        counters.reset()
        tickets = []
        for i, s in enumerate(log):
            tickets.append(eng.submit(parse_fn(s)))
            clk.t += 250e-6
            if i % 3 == 2:
                eng.pump()
        clk.t += 600e-6
        eng.pump()
        eng.drain()
        out[name] = (tickets, {k: counters[k] for k in EXPR_COUNTERS})
    (jt, jc), (tt, tc) = out["jax"], out["port"]
    assert tc == jc
    routes = []
    for s, p, j in zip(log, tt, jt):
        assert p.done and j.done and p.error is None and j.error is None
        pv, jv = p.value, j.value
        assert np.array_equal(pv.doc_ids, np.asarray(jv.doc_ids)), s
        assert np.array_equal(pv.doc_ids, eval_host(
            parse(s), postings.__getitem__)), s
        assert pv.algorithm == jv.algorithm and p.wait_us == j.wait_us
        assert pv.stats.get("cached") == jv.stats.get("cached")
        if not pv.stats.get("cached"):
            for key in ("r", "tuples_survived", "capacity", "batch_size",
                        "expr_width"):
                assert pv.stats.get(key) == jv.stats.get(key), key
        routes.append(pv.algorithm)
    assert {"expr/device", "rangroupscan/device"} <= set(routes)
    if cache:
        assert "expr/subcache" in routes and tc["subexpr_host_merges"] >= 1
    else:
        assert tc["subexpr_cache_stores"] == 0
