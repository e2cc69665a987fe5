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
