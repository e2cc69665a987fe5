"""The port's adaptive controllers (``exec/adaptive.py``) and background
flusher on the CPU, mirroring ``tests/test_adaptive.py``, plus differential
runs against the JAX package's copies.

Covers the capacity model (cold start, convergence, shrink, time decay, the
learning key's replica and shard fields), adaptive capacity through the
serving stack (no re-run on replay, cache invalidation and re-warming on a
tier change), the adaptive deadline, and the flusher (no manual ``pump``,
clean start/stop, results equal to ``query_batch``, submitters hammering
beside concurrent drains).  The differential runs hold ``budget_for`` on one
gap sequence, and the promotions, demotions, saved re-runs and learned
tiers of one ``FakeClock`` script, equal to the JAX package's (tolerance
0).
"""
import dataclasses
import sys
import threading
import time
from typing import Optional, Tuple

import numpy as np
import pytest

from repro.core.engine import EXEC_COUNTERS as JAX_COUNTERS
from repro.exec.adaptive import AdaptiveDeadline as JaxAdaptiveDeadline
from repro.exec.adaptive import CapacityModel as JaxCapacityModel
from repro.serve.search import AsyncSearchEngine as JaxAsyncSearchEngine

from repro_torch.core.engine import (
    EXEC_COUNTERS, clear_specializations, default_capacity,
)
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.exec.adaptive import (
    AdaptiveDeadline, CapacityModel, adaptive_key,
)
from repro_torch.exec.plan import ShapeSig
from repro_torch.serve.search import (
    AsyncSearchEngine, SearchEngine, zipf_query_log,
)

CPU = "cpu"


class FakeClock:
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


@pytest.fixture(scope="module")
def overflow_postings():
    """Two identical dense terms: every group tuple of [1, 2] survives phase
    1, so survivors ~ G > G/4 and the static rule overflows."""
    rng = np.random.default_rng(0)
    dense = rng.choice(100_000, size=2048, replace=False).astype(np.uint32)
    sparse = rng.choice(100_000, size=300, replace=False).astype(np.uint32)
    return {1: dense, 2: dense.copy(), 3: sparse}


@dataclasses.dataclass(frozen=True)
class MeshSig:
    """A signature with the JAX package's mesh fields: the model is copied
    whole, so its learning key still separates shard and replica widths."""

    k: int
    ts: Tuple[int, ...]
    gmaxes: Tuple[int, ...]
    capacity_tier: int
    shards: int = 1
    replicas: int = 1
    cands: int = 0
    eshape: Optional[Tuple] = None


def _sig(ts=(9, 9), shards=1, capacity=None):
    if shards > 1:
        return MeshSig(k=len(ts), ts=tuple(ts), gmaxes=(8,) * len(ts),
                       capacity_tier=capacity or default_capacity(ts),
                       shards=shards)
    return ShapeSig(k=len(ts), ts=tuple(ts), gmaxes=(8,) * len(ts),
                    capacity_tier=capacity or default_capacity(ts))


# -- CapacityModel unit behavior -----------------------------------------------

def test_cold_start_falls_back_to_static_rule():
    model = CapacityModel(min_observations=8)
    sig = _sig()
    key = adaptive_key(sig)
    assert key == (2, (9, 9), (8, 8), 1, 1, 0, None)
    assert model.capacity_for(key, default_capacity(sig.ts)) == \
        default_capacity(sig.ts)
    model.observe_bucket(sig, [{"tuples_survived": 400}] * 7)
    assert model.capacity_for(key, default_capacity(sig.ts)) == \
        default_capacity(sig.ts)
    assert EXEC_COUNTERS["adaptive_promotions"] == 0


def test_learned_tier_converges_for_hot_sig():
    model = CapacityModel(min_observations=8, quantile=0.99, margin=1.25)
    sig = _sig(ts=(9, 9))
    key = adaptive_key(sig)
    model.observe_bucket(sig, [{"tuples_survived": 200}] * 8)
    assert model.capacity_for(key, 128) == 256
    assert EXEC_COUNTERS["adaptive_promotions"] == 1
    model.observe_bucket(sig, [{"tuples_survived": 200}] * 8)
    assert model.capacity_for(key, 128) == 256
    assert EXEC_COUNTERS["adaptive_promotions"] == 1
    model.observe_bucket(sig, [{"tuples_survived": 512}] * 32)
    assert model.capacity_for(key, 128) <= 512


def test_learned_tier_can_shrink_below_static_rule():
    model = CapacityModel(min_observations=8)
    sig = _sig(ts=(9, 9))
    key = adaptive_key(sig)
    model.observe_bucket(sig, [{"tuples_survived": 10}] * 8)
    assert model.capacity_for(key, 128) == 64
    assert EXEC_COUNTERS["adaptive_demotions"] == 1
    assert EXEC_COUNTERS["adaptive_promotions"] == 0


def test_decayed_window_demotes_after_workload_drift():
    now = [0.0]
    model = CapacityModel(min_observations=8, decay_s=10.0,
                          clock=lambda: now[0])
    sig = _sig(ts=(9, 9))
    key = adaptive_key(sig)
    changes = []
    model.on_promotion(lambda *a: changes.append(a))
    model.observe_bucket(sig, [{"tuples_survived": 400}] * 8)
    assert model.capacity_for(key, 128) == 512
    assert EXEC_COUNTERS["adaptive_promotions"] == 1
    assert changes == [(key, 128, 512)]
    now[0] = 11.0
    model.observe_bucket(sig, [{"tuples_survived": 10}] * 8)
    assert model.capacity_for(key, 128) == 64
    assert EXEC_COUNTERS["adaptive_demotions"] == 1
    assert EXEC_COUNTERS["adaptive_promotions"] == 1
    assert changes[-1] == (key, 512, 64)
    assert model.observations(key) == 8


def test_pruned_window_below_min_observations_keeps_tier():
    now = [0.0]
    model = CapacityModel(min_observations=8, decay_s=10.0,
                          clock=lambda: now[0])
    sig = _sig(ts=(9, 9))
    key = adaptive_key(sig)
    model.observe_bucket(sig, [{"tuples_survived": 400}] * 8)
    assert model.capacity_for(key, 128) == 512
    now[0] = 20.0
    model.observe_bucket(sig, [{"tuples_survived": 10}] * 2)
    assert model.observations(key) == 2
    assert model.capacity_for(key, 128) == 512
    assert EXEC_COUNTERS["adaptive_demotions"] == 0
    model.observe_bucket(sig, [{"tuples_survived": 10}] * 6)
    assert model.capacity_for(key, 128) == 64
    assert EXEC_COUNTERS["adaptive_demotions"] == 1


def test_adaptive_key_separates_replica_widths():
    ts = (9, 9)
    flat = ShapeSig(k=2, ts=ts, gmaxes=(8, 8), capacity_tier=128)
    wide = MeshSig(k=2, ts=ts, gmaxes=(8, 8), capacity_tier=128,
                   shards=2, replicas=2)
    assert adaptive_key(flat) != adaptive_key(wide)
    model = CapacityModel(min_observations=4)
    model.observe_bucket(wide, [{"tuples_survived": 400}] * 4)
    assert model.capacity_for(adaptive_key(flat), 128) == 128
    assert model.capacity_for(adaptive_key(wide), 128) == 512


def test_sharded_stats_observe_per_shard_survivors():
    model = CapacityModel(min_observations=4)
    sig = _sig(ts=(9, 9), shards=4)
    key = adaptive_key(sig)
    stats = [{"n_shards": 4, "max_shard_survivors": 50,
              "tuples_survived": 120}] * 4
    model.observe_bucket(sig, stats)
    assert model.capacity_for(key, 128) == 256


def test_overflow_saved_counter():
    model = CapacityModel(min_observations=64)
    learned = _sig(ts=(9, 9), capacity=256)
    model.observe_bucket(learned, [{"tuples_survived": 200}])
    assert EXEC_COUNTERS["adaptive_overflow_saved"] == 1
    model.observe_bucket(_sig(ts=(9, 9)), [{"tuples_survived": 200}])
    assert EXEC_COUNTERS["adaptive_overflow_saved"] == 1


def test_count_and_expression_signatures():
    """Count buckets carry nothing to learn; expression buckets learn under
    their own key (``eshape`` last), against the DAG's dense widths: 400
    node values at margin 1.25 make a tier of 512, within [64, 2 * 2^9 *
    8]."""
    model = CapacityModel(min_observations=1)
    count = ShapeSig(k=2, ts=(9, 9), gmaxes=(8, 8), capacity_tier=8, cands=4)
    model.observe_bucket(count, [{"tuples_survived": 400}])
    assert model.learned_tiers() == {}
    expr = MeshSig(k=2, ts=(9, 9), gmaxes=(8, 8), capacity_tier=128,
                   eshape=("and", 0, 1))
    model.observe_bucket(expr, [{"tuples_survived": 400}])
    assert model.learned_tiers() == {adaptive_key(expr): 512}
    assert adaptive_key(expr)[-1] == ("and", 0, 1)
    model.observe_bucket(expr, [{"tuples_survived": 1 << 20}])
    assert model.capacity_for(adaptive_key(expr), 128) == 2 * (1 << 9) * 8


# -- adaptive capacity through the serving stack ---------------------------------

def test_plan_consults_model_and_replay_has_zero_reruns(overflow_postings):
    model = CapacityModel(min_observations=4)
    eng = SearchEngine(overflow_postings, adaptive_capacity=model,
                       result_cache=0, device=CPU)
    static_sig = eng.plan([1, 2]).sig
    assert static_sig.capacity_tier == default_capacity(static_sig.ts)
    EXEC_COUNTERS.reset()
    eng.query_batch([[1, 2]] * 6)
    assert EXEC_COUNTERS["rerun_calls"] >= 1
    assert EXEC_COUNTERS["adaptive_promotions"] >= 1
    learned_sig = eng.plan([1, 2]).sig
    assert learned_sig.capacity_tier > static_sig.capacity_tier
    EXEC_COUNTERS.reset()
    results = eng.query_batch([[1, 2]] * 6)
    assert EXEC_COUNTERS["rerun_calls"] == 0
    assert EXEC_COUNTERS["adaptive_overflow_saved"] == 6
    oracle = np.sort(np.intersect1d(overflow_postings[1],
                                    overflow_postings[2]))
    for r in results:
        assert np.array_equal(r.doc_ids, oracle)


def test_tier_promotion_invalidates_stale_cache_entries(overflow_postings):
    model = CapacityModel(min_observations=4)
    eng = SearchEngine(overflow_postings, adaptive_capacity=model,
                       result_cache=64, device=CPU)
    first = eng.query([1, 3])
    assert not first.stats.get("cached")
    assert eng.query([1, 3]).stats.get("cached") is True
    EXEC_COUNTERS.reset()
    eng.cache.clear()
    eng.query_batch([[1, 2]] * 6)
    assert EXEC_COUNTERS["adaptive_promotions"] >= 1
    refreshed = eng.query([1, 3])
    assert not refreshed.stats.get("cached")
    assert np.array_equal(refreshed.doc_ids, first.doc_ids)


def test_promotion_rewarm_traces_promoted_executable(overflow_postings):
    model = CapacityModel(min_observations=4)
    eng = SearchEngine(overflow_postings, adaptive_capacity=model,
                       result_cache=0, device=CPU)
    clear_specializations()
    eng.warm([[1, 2]], top_k=1, b_tiers=(1,))
    EXEC_COUNTERS.reset()
    eng.query_batch([[1, 2]] * 6)
    assert EXEC_COUNTERS["adaptive_promotions"] >= 1
    assert EXEC_COUNTERS["warm_executions"] >= 1
    EXEC_COUNTERS.reset()
    eng.query([1, 2])
    assert EXEC_COUNTERS["batch_calls"] >= 1
    assert EXEC_COUNTERS["batch_traces"] == 0


def test_promotion_rewarm_traces_the_learned_tier_executable():
    rng = np.random.default_rng(7)
    pool = rng.choice(1 << 20, size=2 * 8192, replace=False).astype(np.uint32)
    a, b = pool[:8192], pool[8192:]
    b[:64] = a[:64]
    model = CapacityModel(min_observations=4)
    eng = SearchEngine({1: a, 2: b}, adaptive_capacity=model,
                       result_cache=0, device=CPU)
    sig = eng.plan([1, 2]).sig
    assert sig.ts[-1] == 9 and sig.capacity_tier == 128
    clear_specializations()
    eng.warm([[1, 2]], top_k=1, b_tiers=(1,))
    EXEC_COUNTERS.reset()
    model.observe_bucket(sig, [{"tuples_survived": 150}] * 4)
    assert EXEC_COUNTERS["adaptive_promotions"] == 1
    assert eng.plan([1, 2]).sig.capacity_tier == 256
    assert EXEC_COUNTERS["warm_executions"] >= 1
    EXEC_COUNTERS.reset()
    eng.query([1, 2])
    assert EXEC_COUNTERS["batch_calls"] >= 1
    assert EXEC_COUNTERS["rerun_calls"] == 0
    assert EXEC_COUNTERS["batch_traces"] == 0


# -- AdaptiveDeadline ---------------------------------------------------------

def test_adaptive_deadline_budget_policy():
    ctl = AdaptiveDeadline(min_observations=4, alpha=1.0, min_fraction=0.125)
    key = ("sig",)
    assert ctl.budget_for(key, 2000.0) == 2000.0
    for i in range(6):
        ctl.observe(key, i * 0.000_100)
    assert ctl.budget_for(key, 2000.0) == 2000.0
    slow = ("slow",)
    for i in range(6):
        ctl.observe(slow, i * 0.100)
    assert ctl.budget_for(slow, 2000.0) == pytest.approx(250.0)
    mid = ("mid",)
    for i in range(6):
        ctl.observe(mid, i * 0.004)
    assert ctl.budget_for(mid, 2000.0) == pytest.approx(1000.0)


def test_adaptive_deadline_shrinks_ticket_budget(postings):
    clk = FakeClock()
    eng = AsyncSearchEngine(postings, clock=clk, seed=3, deadline_us=2000.0,
                            flush_tier=8, result_cache=0, device=CPU,
                            adaptive_deadline=AdaptiveDeadline(
                                min_observations=3, alpha=1.0))
    q = next(q for q in zipf_query_log(sorted(eng.index), 32, seed=2)
             if eng.plan(q).algorithm == "device")
    tickets = []
    for _ in range(6):
        tickets.append(eng.submit(q))
        clk.t += 0.050
        eng.drain()
    assert tickets[-1].deadline_us < 2000.0
    assert tickets[0].deadline_us == 2000.0


def test_adaptive_deadline_budgets_match_jax():
    """One gap sequence (seeded, three keys at different rates) through both
    copies: every ``budget_for`` is equal (tolerance 0, same float ops)."""
    rng = np.random.default_rng(11)
    kw = dict(min_observations=5, alpha=0.3, min_fraction=0.2)
    port, ref = AdaptiveDeadline(**kw), JaxAdaptiveDeadline(**kw)
    t = {("a",): 0.0, ("b",): 0.0, ("c",): 0.0}
    scale = {("a",): 1e-4, ("b",): 3e-3, ("c",): 5e-2}
    for i in range(200):
        key = list(t)[i % 3]
        t[key] += float(rng.exponential(scale[key]))
        port.observe(key, t[key])
        ref.observe(key, t[key])
        for default in (500.0, 2000.0):
            assert port.budget_for(key, default) == ref.budget_for(key, default)
    assert port.telemetry() == ref.telemetry()


def test_adaptive_capacity_script_matches_jax(overflow_postings):
    """One FakeClock script with adaptive capacity on, through the JAX
    package's AsyncSearchEngine and the port's: the tickets and the
    promotion, demotion and saved re-run counters and the learned tiers are
    equal."""
    rng = np.random.default_rng(2)
    extra = {10 + i: np.unique(rng.integers(0, 100_000, size=int(n)))
             .astype(np.uint32)
             for i, n in enumerate(rng.integers(200, 3000, size=6))}
    corpus = {**overflow_postings, **extra}
    kw = dict(seed=3, deadline_us=1000.0, flush_tier=4, result_cache=0)
    jclk, tclk = FakeClock(), FakeClock()
    jeng = JaxAsyncSearchEngine(
        corpus, clock=jclk, use_device=True,
        adaptive_capacity=JaxCapacityModel(min_observations=4, decay_s=None),
        **kw)
    teng = AsyncSearchEngine(
        corpus, clock=tclk, device=CPU,
        adaptive_capacity=CapacityModel(min_observations=4, decay_s=None),
        **kw)
    queries = [[1, 2], [1, 3], [2, 10], [11, 12], [1, 2, 13], [14, 15],
               [10, 11, 12]]
    log = [queries[i] for i in rng.integers(0, len(queries), size=60)]
    keys = ("adaptive_promotions", "adaptive_demotions",
            "adaptive_overflow_saved", "rerun_calls", "tickets_resolved")
    out = []
    for eng, clk, counters in ((jeng, jclk, JAX_COUNTERS),
                               (teng, tclk, EXEC_COUNTERS)):
        counters.reset()
        tickets = []
        for q in log:
            tickets.append(eng.submit(q))
            clk.advance_us(300)
            eng.pump()
        eng.drain()
        out.append((tickets, {k: counters[k] for k in keys},
                    eng.capacity_model.learned_tiers()))
    (jt, jc, jl), (tt, tc, tl) = out
    for p, j in zip(tt, jt):
        assert np.array_equal(p.value.doc_ids, np.asarray(j.value.doc_ids))
        assert p.value.algorithm == j.value.algorithm
        assert p.wait_us == j.wait_us
        for key in ("r", "tuples_survived", "capacity", "batch_size"):
            assert p.value.stats.get(key) == j.value.stats.get(key), key
    assert tc == jc
    assert tl == jl
    assert tc["adaptive_promotions"] >= 1 and tl


# -- background flusher -------------------------------------------------------

def _flusher_threads():
    return [t for t in threading.enumerate()
            if t.name == "repro-torch-flusher"]


def test_flusher_start_stop_leaves_no_dangling_threads(postings):
    assert _flusher_threads() == []
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=8, result_cache=0,
                            device=CPU)
    eng.start()
    eng.start()
    assert len(_flusher_threads()) == 1 and eng.running
    eng.stop()
    assert _flusher_threads() == [] and not eng.running
    with eng:
        assert len(_flusher_threads()) == 1
    assert _flusher_threads() == []


def test_flusher_resolves_tickets_without_manual_pump(postings):
    eng = AsyncSearchEngine(postings, seed=3, deadline_us=2000.0,
                            flush_tier=8, result_cache=0, device=CPU)
    q = next(q for q in zipf_query_log(sorted(eng.index), 8, seed=2)
             if eng.plan(q).algorithm == "device")
    with eng:
        ticket = eng.submit(q)
        assert ticket.wait(timeout=30.0), "flusher never flushed the bucket"
    assert ticket.error is None
    assert EXEC_COUNTERS["flusher_wakeups"] >= 1
    oracle = SearchEngine(postings, seed=3, device=CPU).query(q)
    assert np.array_equal(ticket.value.doc_ids, oracle.doc_ids)


def test_flusher_bit_identical_to_query_batch_on_zipf_workload(postings):
    log = zipf_query_log(sorted(SearchEngine(postings, seed=3,
                                             device=CPU).index), 256, seed=11)
    eng = AsyncSearchEngine(postings, seed=3, deadline_us=2000.0,
                            flush_tier=8, result_cache=1024, device=CPU)
    with eng:
        tickets = [eng.submit(q) for q in log]
        for t in tickets:
            assert t.wait(timeout=60.0)
    assert all(t.error is None for t in tickets)
    oracle = SearchEngine(postings, seed=3, device=CPU).query_batch(log)
    for q, t, o in zip(log, tickets, oracle):
        assert np.array_equal(t.value.doc_ids, o.doc_ids), q
    snap = EXEC_COUNTERS.snapshot()
    assert snap["inflight_dispatches"] == snap["inflight_collects"]


def test_submit_hammering_during_flush_and_idempotent_drain(postings):
    """Submitter threads hammer while the flusher runs buckets, with
    concurrent drains racing it, under a shortened switch interval: every
    ticket resolves exactly once with a correct result."""
    eng = AsyncSearchEngine(postings, seed=3, deadline_us=500.0,
                            flush_tier=4, result_cache=0, device=CPU)
    log = [q for q in zipf_query_log(sorted(eng.index), 48, seed=5)
           if eng.plan(q).algorithm == "device"][:32]
    results: dict = {}
    errors = []

    def submitter(worker: int):
        try:
            for i, q in enumerate(log):
                ticket = eng.submit(q)
                assert ticket.wait(timeout=30.0)
                results[(worker, i)] = (q, ticket)
                time.sleep(0.0005)
        except Exception as exc:  # pragma: no cover - fail path
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with eng:
            workers = [threading.Thread(target=submitter, args=(w,))
                       for w in range(8)]
            for w in workers:
                w.start()
            for _ in range(20):
                eng.drain()
                time.sleep(0.002)
            for w in workers:
                w.join(timeout=60.0)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert eng.pending() == 0
    oracle = {tuple(q): r.doc_ids for q, r in zip(
        log, SearchEngine(postings, seed=3, device=CPU).query_batch(log))}
    assert len(results) == 8 * len(log)
    for q, ticket in results.values():
        assert ticket.error is None
        assert np.array_equal(ticket.value.doc_ids, oracle[tuple(q)])
    snap = EXEC_COUNTERS.snapshot()
    assert snap["tickets_resolved"] == 8 * len(log)
    assert snap["inflight_dispatches"] == snap["inflight_collects"]
