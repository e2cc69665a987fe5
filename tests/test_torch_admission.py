"""The port's admission queue and async front end on the CPU, mirroring
``tests/test_admission.py``, plus a differential run against the JAX
package's ``AsyncSearchEngine``.

Covers the queue's deadline and tier flushes, tickets, the result cache,
index mutation between submit and flush, a failing bucket, results equal to
``query_batch``, warming (zero serve-time ``batch_traces`` / ``count_traces``
after it), and one ``FakeClock`` script of ``submit`` / ``pump`` / ``drain``
served by both packages: every ticket's doc ids, route, stats and wait and
the flush, ticket and re-run counters must be equal (tolerance 0: all are
integers, or waits computed from the same virtual clock).
"""
import threading

import numpy as np
import pytest

from repro.core.engine import EXEC_COUNTERS as JAX_COUNTERS
from repro.serve.search import AsyncSearchEngine as JaxAsyncSearchEngine

from repro_torch.core.engine import (
    EXEC_COUNTERS, clear_specializations, pow2_tiers, warm_executables,
)
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.exec.cache import ResultCache
from repro_torch.exec.plan import plan_query
from repro_torch.serve.admission import AdmissionQueue, Ticket
from repro_torch.serve.search import (
    AsyncSearchEngine, SearchEngine, SuggestEngine, repeated_query_log,
    zipf_query_log,
)

CPU = "cpu"


class FakeClock:
    """Injectable clock: tests advance time explicitly (seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_us(self, us):
        self.t += us * 1e-6


@pytest.fixture(autouse=True)
def _reset_port_counters():
    EXEC_COUNTERS.reset()
    yield


@pytest.fixture(scope="module")
def postings():
    docs = zipf_corpus(2500, vocab=500, mean_len=30, seed=3)
    return inverted_index(docs)


def _async_engine(postings, clock, **kw):
    kw.setdefault("deadline_us", 2000.0)
    kw.setdefault("flush_tier", 8)
    return AsyncSearchEngine(postings, clock=clock, seed=3, device=CPU, **kw)


# -- AdmissionQueue unit behavior -------------------------------------------

def test_admission_queue_deadline_and_tier():
    clk = FakeClock()
    q = AdmissionQueue(flush_tier=4, deadline_us=1000.0, clock=clk)
    t1 = q.submit("sig", "a")
    assert isinstance(t1, Ticket) and not t1.done
    assert q.take_due() == []
    clk.advance_us(999)
    assert q.take_due() == []
    clk.advance_us(2)
    (key, bucket), = q.take_due()
    assert key == "sig" and [it for _, it in bucket] == ["a"]
    assert EXEC_COUNTERS["deadline_flushes"] == 1
    assert q.pending() == 0
    for x in range(4):
        q.submit("sig", x)
    (_, bucket), = q.take_full()
    assert len(bucket) == 4
    assert EXEC_COUNTERS["tier_flushes"] == 1


def test_admission_queue_next_deadline():
    clk = FakeClock()
    q = AdmissionQueue(flush_tier=4, deadline_us=500.0, clock=clk)
    assert q.next_deadline_in_us() is None
    q.submit("s1", 1)
    clk.advance_us(100)
    q.submit("s2", 2)
    assert q.next_deadline_in_us() == pytest.approx(400.0, abs=1e-6)


def test_tighter_per_query_deadline_binds():
    clk = FakeClock()
    q = AdmissionQueue(flush_tier=8, deadline_us=2000.0, clock=clk)
    q.submit("sig", "a")
    clk.advance_us(50)
    q.submit("sig", "b", deadline_us=100.0)
    assert q.next_deadline_in_us() == pytest.approx(100.0, abs=1e-6)
    clk.advance_us(99)
    assert q.take_due() == []
    clk.advance_us(2)
    (_, bucket), = q.take_due()
    assert [it for _, it in bucket] == ["a", "b"]


def test_take_all_counts_causes_and_rejects_bad_tier():
    q = AdmissionQueue(flush_tier=2, deadline_us=5000.0, clock=FakeClock())
    q.submit("full", 1)
    q.submit("full", 2)
    q.submit("partial", 3)
    assert sorted(k for k, _ in q.take_all()) == ["full", "partial"]
    assert (EXEC_COUNTERS["tier_flushes"],
            EXEC_COUNTERS["deadline_flushes"]) == (1, 1)
    with pytest.raises(ValueError):
        AdmissionQueue(flush_tier=3)


def test_ticket_value_before_resolve_raises():
    t = Ticket(submitted_at=0.0, deadline_us=100.0)
    with pytest.raises(RuntimeError):
        _ = t.value


def test_next_deadline_zero_when_bucket_full():
    clk = FakeClock()
    q = AdmissionQueue(flush_tier=2, deadline_us=5000.0, clock=clk)
    q.submit("sig", "a")
    assert q.next_deadline_in_us() == pytest.approx(5000.0, abs=1e-6)
    q.submit("sig", "b")
    assert q.next_deadline_in_us() == 0.0
    q.submit("other", "c")
    assert q.next_deadline_in_us() == 0.0
    q.take_full()
    assert q.next_deadline_in_us() == pytest.approx(5000.0, abs=1e-6)


def test_ticket_resolution_is_single_shot_and_event_backed():
    t = Ticket(submitted_at=0.0, deadline_us=100.0)
    assert not t.done and not t.wait(timeout=0.0)
    seen = []
    waiter = threading.Thread(target=lambda: seen.append(
        (t.wait(timeout=5.0), t.value)))
    waiter.start()
    t.resolve("result", wait_us=7.0)
    waiter.join(timeout=5.0)
    assert not waiter.is_alive()
    assert seen == [(True, "result")]
    assert t.done and t.value == "result" and t.resolved_at is not None
    with pytest.raises(RuntimeError, match="already resolved"):
        t.resolve("clobber")
    with pytest.raises(RuntimeError, match="already resolved"):
        t.resolve_error(ValueError("late failure"))
    assert t.value == "result"
    assert (EXEC_COUNTERS["tickets_resolved"],
            EXEC_COUNTERS["queue_wait_us"]) == (1, 7)

    t2 = Ticket(submitted_at=0.0, deadline_us=100.0)
    t2.resolve_error(ValueError("boom"), wait_us=101.0)
    assert t2.done
    assert EXEC_COUNTERS["deadline_violations"] == 1
    with pytest.raises(RuntimeError, match="already resolved"):
        t2.resolve("too late")
    with pytest.raises(ValueError, match="boom"):
        _ = t2.value


# -- result cache -------------------------------------------------------------

def test_result_cache_lru_and_counters(postings):
    idx = SearchEngine(postings, seed=3, device=CPU).index
    terms = sorted(idx)
    cache = ResultCache(capacity=2)
    plans = [plan_query(idx, [t]) for t in terms[:3]]
    assert cache.get(plans[0]) is None
    assert EXEC_COUNTERS["result_cache_misses"] == 1
    cache.put(plans[0], "r0")
    cache.put(plans[1], "r1")
    assert cache.get(plans[0]) == "r0"
    cache.put(plans[2], "r2")
    assert cache.get(plans[1]) is None
    assert cache.get(plans[2]) == "r2"
    assert EXEC_COUNTERS["result_cache_hits"] == 2
    a, b = terms[0], terms[1]
    k = plan_query(idx, [a, b]).cache_key()
    assert plan_query(idx, [b, a]).cache_key() == k
    assert plan_query(idx, [a, a, b]).cache_key() == k


def test_result_cache_generation_invalidates_stale_entries(postings):
    idx = SearchEngine(postings, seed=3, device=CPU).index
    cache = ResultCache(capacity=8)
    plan = plan_query(idx, [sorted(idx)[0]])
    cache.put(plan, "old-postings")
    assert cache.get(plan) == "old-postings"
    cache.bump_generation()
    EXEC_COUNTERS.reset()
    assert cache.get(plan) is None
    assert EXEC_COUNTERS["result_cache_misses"] == 1
    assert len(cache) == 0
    cache.put(plan, "new-postings")
    assert cache.get(plan) == "new-postings"
    cache.invalidate()
    assert len(cache) == 0
    assert cache.get(plan) is None
    cache.put(plan, "again")
    gen = cache.generation
    cache.clear()
    assert len(cache) == 0 and cache.generation == gen


def test_index_mutation_invalidates_served_results(postings):
    eng = SearchEngine(postings, seed=3, result_cache=64, device=CPU)
    term = sorted(eng.index)[0]
    before = eng.query([term])
    assert np.array_equal(np.sort(before.doc_ids),
                          np.sort(eng.index[term].values))
    assert eng.query([term]).stats.get("cached") is True
    new_postings = np.array([5, 17, 99], dtype=np.uint32)
    eng.add_postings(term, new_postings)
    after = eng.query([term])
    assert not after.stats.get("cached")
    assert np.array_equal(after.doc_ids, new_postings)
    again = eng.query([term])
    assert again.stats.get("cached") is True
    assert np.array_equal(again.doc_ids, new_postings)


def test_put_rejects_results_computed_against_old_generation(postings):
    idx = SearchEngine(postings, seed=3, device=CPU).index
    cache = ResultCache(capacity=8)
    plan = plan_query(idx, [sorted(idx)[0]])
    gen = cache.generation
    cache.bump_generation()
    cache.put(plan, "stale-result", generation=gen)
    assert len(cache) == 0
    assert cache.get(plan) is None
    cache.put(plan, "fresh-result")
    assert cache.get(plan) == "fresh-result"


def test_mutation_between_submit_and_flush_does_not_poison_bucket(postings):
    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=0)
    qs = [q for q in zipf_query_log(sorted(eng.index), 64, seed=7)
          if eng.plan(q).algorithm == "device" and len(q) >= 2]
    query = qs[0]
    ticket = eng.submit(query)
    assert not ticket.done
    eng.add_postings(query[0], np.array([3, 7, 11], dtype=np.uint32))
    clk.advance_us(2001)
    eng.pump()
    assert ticket.done and ticket.error is None
    truth = np.array([3, 7, 11], dtype=np.uint32)
    for t in query[1:]:
        truth = np.intersect1d(truth, np.sort(eng.index[t].values))
    assert np.array_equal(ticket.value.doc_ids, truth)


def test_cache_hit_skips_device_execution(postings):
    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=64)
    q = zipf_query_log(sorted(eng.index), 8, seed=9)[0]
    t1 = eng.submit(q)
    eng.drain()
    assert t1.done
    EXEC_COUNTERS.reset()
    t2 = eng.submit(q)
    assert t2.done
    assert EXEC_COUNTERS["result_cache_hits"] == 1
    assert EXEC_COUNTERS["batch_calls"] == 0
    assert t2.value.stats.get("cached") is True
    assert np.array_equal(t2.value.doc_ids, t1.value.doc_ids)


# -- async engine flush semantics ---------------------------------------------

def test_deadline_flush_fires_on_lone_query(postings):
    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=0)
    q = zipf_query_log(sorted(eng.index), 4, seed=2)[0]
    ticket = eng.submit(q)
    assert not ticket.done and eng.pending() == 1
    assert eng.pump() == 0
    clk.advance_us(2001)
    assert eng.pump() == 1
    assert ticket.done
    assert EXEC_COUNTERS["deadline_flushes"] == 1
    assert ticket.wait_us >= 2000.0
    oracle = SearchEngine(postings, seed=3, device=CPU).query(q)
    assert np.array_equal(ticket.value.doc_ids, oracle.doc_ids)


def test_tier_flush_fires_without_pump(postings):
    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=0, flush_tier=2)
    qs = [q for q in zipf_query_log(sorted(eng.index), 64, seed=7)
          if eng.plan(q).algorithm == "device"]
    sigs = [eng.plan(q).sig for q in qs]
    pair = next((qs[i], qs[j]) for i in range(len(qs))
                for j in range(i + 1, len(qs))
                if sigs[i] == sigs[j] and qs[i] != qs[j])
    t1 = eng.submit(pair[0])
    assert not t1.done
    t2 = eng.submit(pair[1])
    assert t1.done and t2.done
    assert EXEC_COUNTERS["tier_flushes"] == 1
    assert EXEC_COUNTERS["deadline_flushes"] == 0
    assert t1.value.stats["batch_size"] == 2


def test_bucket_failure_resolves_tickets_with_error(postings, monkeypatch):
    import repro_torch.serve.search as search_mod

    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=0)

    def boom(*a, **k):
        raise RuntimeError("device exploded")

    monkeypatch.setattr(search_mod, "dispatch_bucket", boom)
    q = zipf_query_log(sorted(eng.index), 4, seed=2)[0]
    ticket = eng.submit(q)
    clk.advance_us(2001)
    eng.pump()
    assert ticket.done and ticket.error is not None
    with pytest.raises(RuntimeError, match="device exploded"):
        _ = ticket.value
    assert eng.pending() == 0


def test_async_results_match_query_batch_oracle(postings):
    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=128, flush_tier=8)
    log = repeated_query_log(sorted(eng.index), 48, n_distinct=12, seed=5)
    tickets = []
    for q in log:
        tickets.append(eng.submit(q))
        clk.advance_us(300)
        eng.pump()
    eng.drain()
    assert all(t.done for t in tickets)
    oracle = SearchEngine(postings, seed=3, device=CPU).query_batch(log)
    for q, t, o in zip(log, tickets, oracle):
        assert np.array_equal(t.value.doc_ids, o.doc_ids), q
    assert EXEC_COUNTERS["result_cache_hits"] > 0
    assert EXEC_COUNTERS["tickets_resolved"] == len(log)


# -- warming ------------------------------------------------------------------

def test_warmed_signature_zero_traces_on_first_query(postings):
    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=0)
    sample = zipf_query_log(sorted(eng.index), 64, seed=13)
    clear_specializations()
    EXEC_COUNTERS.reset()
    warmed = eng.warm(sample, top_k=32, b_tiers=(1,))
    assert warmed and EXEC_COUNTERS["batch_traces"] >= len(warmed)
    assert EXEC_COUNTERS["warm_executions"] == len(warmed)
    q = next(q for q in sample if eng.plan(q).algorithm == "device"
             and eng.plan(q).sig == warmed[0])
    EXEC_COUNTERS.reset()
    ticket = eng.submit(q)
    clk.advance_us(2001)
    eng.pump()
    assert ticket.done
    assert EXEC_COUNTERS["batch_calls"] >= 1
    assert EXEC_COUNTERS["batch_traces"] == 0


def test_warm_executables_counts():
    assert warm_executables([], device=CPU) == 0
    assert EXEC_COUNTERS["warm_executions"] == 0
    with pytest.raises(ValueError):
        pow2_tiers(6)
    assert pow2_tiers(8) == (1, 2, 4, 8)


def test_warming_the_log_leaves_zero_serve_time_traces(postings):
    """The gate of the online front end: after ``warm(log, top_k=len(log),
    b_tiers=pow2_tiers(flush_tier))`` serving that log through the
    admission queue counts no new ``batch_traces``."""
    clk = FakeClock()
    eng = _async_engine(postings, clk, result_cache=0, flush_tier=8)
    log = repeated_query_log(sorted(eng.index), 96, n_distinct=24, seed=4)
    clear_specializations()
    eng.warm(log, top_k=len(log), b_tiers=pow2_tiers(8))
    assert EXEC_COUNTERS["batch_traces"] > 0
    EXEC_COUNTERS.reset()
    tickets = []
    for q in log:
        tickets.append(eng.submit(q))
        clk.advance_us(150)
        eng.pump()
    eng.drain()
    assert all(t.done and t.error is None for t in tickets)
    assert EXEC_COUNTERS["batch_calls"] > 0
    assert EXEC_COUNTERS["batch_traces"] == 0


def test_warming_differs_from_jax_only_by_the_rerun_pass():
    """Where the two packages' warming differs on purpose.  Queries [0, 1]
    and [2, 3] share one signature; [0, 1] (the representative) fits its
    capacity, [2, 3] (two equal lists) overflows and re-runs at capacity
    G.  Both packages run the same ``warm_executions``; the port adds one
    ``warm_reruns`` pass at capacity G per tier, so serving [2, 3] then
    traces nothing, where the JAX package traces its re-run once.  Answers
    and stats stay equal (tolerance 0).  The sharded and 2-D arms keep the
    same difference at the local group count:
    ``test_*_warming_differs_from_jax_only_by_the_rerun_pass`` in
    ``tests/test_torch_sharded.py`` and ``tests/test_torch_mesh2d.py``."""
    from repro.core.engine import clear_exec_jit_cache

    rng = np.random.default_rng(11)

    def draw(n):
        return np.unique(rng.choice(1 << 20, size=n,
                                    replace=False)).astype(np.uint32)

    a, b, c = draw(3000), draw(3000), draw(3000)
    lists = {0: a, 1: b, 2: c, 3: c.copy()}
    kw = dict(seed=3, result_cache=0, flush_tier=8, deadline_us=2000.0)
    jeng = JaxAsyncSearchEngine(lists, use_device=True, **kw)
    teng = AsyncSearchEngine(lists, device=CPU, **kw)
    assert teng.plan([0, 1]).sig == teng.plan([2, 3]).sig
    tiers = (1, 2)
    out = {}
    for name, eng, counters, clear in (
            ("jax", jeng, JAX_COUNTERS, clear_exec_jit_cache),
            ("port", teng, EXEC_COUNTERS, clear_specializations)):
        clear()
        counters.reset()
        eng.warm([[0, 1], [2, 3]], top_k=2, b_tiers=tiers)
        warm = dict(counters)
        counters.reset()
        ticket = eng.submit([2, 3])
        eng.drain()
        out[name] = (warm, dict(counters), ticket.value)
    (jwarm, jserve, jval), (twarm, tserve, tval) = out["jax"], out["port"]
    assert twarm["warm_executions"] == jwarm["warm_executions"] == len(tiers)
    assert jwarm["rerun_calls"] == twarm["rerun_calls"] == 0
    assert twarm["warm_reruns"] == len(tiers)
    assert "warm_reruns" not in jwarm
    assert jserve["rerun_calls"] == tserve["rerun_calls"] == 1
    assert jserve["batch_traces"] == 1
    assert tserve["batch_traces"] == 0
    assert np.array_equal(tval.doc_ids, np.asarray(jval.doc_ids))
    assert np.array_equal(tval.doc_ids, np.sort(c))
    for key in DIFF_STATS:
        assert tval.stats[key] == jval.stats[key], key


def test_expression_warming_differs_from_jax_only_by_the_rerun_pass():
    """The expression form of the difference above.  ``(0|1|2)&3`` and
    ``(4|5|6)&7`` share one signature; the representative's union holds
    one list three times and fits its node buffers, the sibling's union of
    three disjoint lists overflows and re-runs at the total leaf width.
    Both packages run the same ``warm_executions``; the port adds one
    ``warm_reruns`` pass at the total width per tier, so serving the
    sibling then counts no ``expr_traces``, where the JAX package traces
    its re-run once.  Answers and stats stay equal (tolerance 0)."""
    from repro.core.engine import clear_exec_jit_cache
    from repro.exec.expr import parse as jax_parse

    rng = np.random.default_rng(11)

    def draw(n):
        return np.unique(rng.choice(1 << 20, size=n,
                                    replace=False)).astype(np.uint32)

    a, b, c, d, e = (draw(3000) for _ in range(5))
    lists = {0: a, 1: a.copy(), 2: a.copy(), 3: c, 4: b, 5: d, 6: e,
             7: c.copy()}
    kw = dict(seed=3, result_cache=0, flush_tier=8, deadline_us=2000.0)
    jeng = JaxAsyncSearchEngine(lists, use_device=True, **kw)
    teng = AsyncSearchEngine(lists, device=CPU, **kw)
    rep, sibling = "(0|1|2)&3", "(4|5|6)&7"
    assert teng.plan(rep).sig == teng.plan(sibling).sig
    assert teng.plan(rep).sig.eshape is not None
    tiers = (1, 2)
    out = {}
    for name, eng, counters, clear, parse in (
            ("jax", jeng, JAX_COUNTERS, clear_exec_jit_cache, jax_parse),
            ("port", teng, EXEC_COUNTERS, clear_specializations, str)):
        clear()
        counters.reset()
        eng.warm([parse(rep), parse(sibling)], top_k=2, b_tiers=tiers)
        warm = dict(counters)
        counters.reset()
        ticket = eng.submit(parse(sibling))
        eng.drain()
        out[name] = (warm, dict(counters), ticket.value)
    (jwarm, jserve, jval), (twarm, tserve, tval) = out["jax"], out["port"]
    assert twarm["warm_executions"] == jwarm["warm_executions"] == len(tiers)
    assert jwarm["expr_rerun_calls"] == twarm["expr_rerun_calls"] == 0
    assert twarm["warm_reruns"] == len(tiers)
    assert jserve["expr_rerun_calls"] == tserve["expr_rerun_calls"] == 1
    assert jserve["expr_traces"] == 1
    assert tserve["expr_traces"] == 0
    assert tval.algorithm == jval.algorithm == "expr/device"
    assert np.array_equal(tval.doc_ids, np.asarray(jval.doc_ids))
    assert np.array_equal(tval.doc_ids, np.intersect1d(
        np.union1d(np.union1d(b, d), e), c))
    for key in DIFF_STATS + ("expr_width",):
        assert tval.stats[key] == jval.stats[key], key


def test_suggest_warm_leaves_zero_count_traces():
    rng = np.random.default_rng(5)
    corpus = {i: np.unique(rng.integers(0, 4000, size=int(n))).astype(np.uint32)
              for i, n in enumerate(rng.integers(40, 400, size=48))}
    eng = SuggestEngine(corpus, seed=5, result_cache=0, device=CPU)
    probes = list(range(0, 48, 3))
    clear_specializations()
    warmed = eng.warm(probes, k=8, b_tiers=pow2_tiers(8))
    assert warmed and EXEC_COUNTERS["count_traces"] > 0
    assert EXEC_COUNTERS["warm_executions"] == len(warmed) * 4
    EXEC_COUNTERS.reset()
    for i in range(0, len(probes), 8):
        eng.suggest_batch([(p, 8) for p in probes[i:i + 8]])
    assert EXEC_COUNTERS["count_calls"] > 0
    assert EXEC_COUNTERS["count_traces"] == 0


# -- differential: the same FakeClock script through both packages --------------

DIFF_COUNTERS = ("tier_flushes", "deadline_flushes", "tickets_resolved",
                 "deadline_violations", "rerun_calls")
DIFF_STATS = ("r", "tuples_survived", "capacity", "batch_size")


def run_script(eng, clk, log, counters):
    """Submit the log with 250 us gaps, a tighter budget on every fifth
    query, pumps between arrivals and a drain at the end; returns the
    tickets and the counters of the script."""
    counters.reset()
    tickets = []
    for i, q in enumerate(log):
        tickets.append(eng.submit(q, deadline_us=500.0 if i % 5 == 4 else None))
        clk.advance_us(250)
        if i % 3 == 2:
            eng.pump()
    clk.advance_us(600)
    eng.pump()
    eng.drain()
    return tickets, {k: counters[k] for k in DIFF_COUNTERS}


def assert_same_tickets(port, ref):
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        assert p.done and j.done and p.error is None and j.error is None
        pv, jv = p.value, j.value
        assert pv.doc_ids.dtype == np.uint32
        assert np.array_equal(pv.doc_ids, np.asarray(jv.doc_ids))
        assert pv.algorithm == jv.algorithm
        assert p.wait_us == j.wait_us
        assert pv.stats.get("cached") == jv.stats.get("cached")
        if pv.algorithm.endswith("/device") and not pv.stats.get("cached"):
            for key in DIFF_STATS:
                assert pv.stats[key] == jv.stats[key], key
        else:
            assert pv.stats.get("r") == jv.stats.get("r")


@pytest.mark.parametrize("flush_tier,cache", [(4, 0), (8, 256)])
def test_fakeclock_script_matches_jax(postings, flush_tier, cache):
    kw = dict(seed=3, deadline_us=2000.0, flush_tier=flush_tier,
              result_cache=cache, hashbin_ratio=8.0)
    jclk, tclk = FakeClock(), FakeClock()
    jeng = JaxAsyncSearchEngine(postings, clock=jclk, use_device=True, **kw)
    teng = AsyncSearchEngine(postings, clock=tclk, device=CPU, **kw)
    log = repeated_query_log(sorted(teng.index), 72, n_distinct=20, seed=6)
    routes = {teng.plan(q).algorithm for q in log}
    assert {"device", "hashbin"} <= routes
    ref, ref_counts = run_script(jeng, jclk, log, JAX_COUNTERS)
    port, port_counts = run_script(teng, tclk, log, EXEC_COUNTERS)
    assert_same_tickets(port, ref)
    assert port_counts == ref_counts
    assert port_counts["deadline_flushes"] > 0
    if cache:
        assert any(t.value.stats.get("cached") for t in port)
    else:
        assert port_counts["tier_flushes"] > 0
