"""The port's open-loop load harness on the CPU, against the JAX package,
mirroring ``tests/test_loadgen.py``.

The same shapes and seeds give the same schedules (arrival times equal
element for element, the same queries); ``_make_report`` reads identical
tickets alike; ``run_virtual`` with one fixed ``CostModel`` (never a
calibrated one, which reads the wall) gives the same report field for
field, except ``p99_e2e_us`` (it holds wall latency), and the same answers.
Then the harness's own behavior on the port: overload burns and low load
does not, the clock attach guards, and a wall-clock soak with four
submitters against the background flusher.  Exact unless stated.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serve.loadgen as jax_loadgen
from repro.core.engine import EXEC_COUNTERS as JAX_COUNTERS
from repro.obs.profile import ProfileStore as JaxProfileStore
from repro.serve.admission import Ticket as JaxTicket
from repro.serve.search import AsyncSearchEngine as JaxAsyncSearchEngine

import repro_torch.serve.loadgen as loadgen
from repro_torch.core.engine import EXEC_COUNTERS
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.exec.plan import ShapeSig
from repro_torch.obs import reset_obs
from repro_torch.obs.profile import ProfileStore
from repro_torch.serve.admission import Ticket
from repro_torch.serve.loadgen import (
    BURN_EPS_US, ArrivalSchedule, CostModel, QueryMix, TrafficShape,
    _make_report, attach_virtual_clock, attach_wall_clock, build_schedule,
    calibrate_from_profile, run_virtual, run_wallclock,
)
from repro_torch.serve.search import AsyncSearchEngine, SearchEngine

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset_port_obs():
    EXEC_COUNTERS.reset()
    reset_obs()
    yield


@pytest.fixture(scope="module")
def postings():
    return inverted_index(zipf_corpus(3000, vocab=400, mean_len=40, seed=3))


@pytest.fixture(scope="module")
def index_terms(postings):
    return sorted(t for t, p in postings.items() if len(p))


def _query_pool(index_terms, n=12, seed=5):
    return QueryMix().sample(index_terms, n, np.random.default_rng(seed))


# ---------------------------------------------------------------------------
# traffic synthesis against the JAX package
# ---------------------------------------------------------------------------

SHAPES = [
    TrafficShape(base_qps=800.0, duration_s=1.0),
    TrafficShape(base_qps=3000.0, duration_s=2.0, diurnal_amplitude=0.5,
                 burst_rate_hz=0.0),
    TrafficShape(base_qps=200.0, duration_s=2.0, burst_rate_hz=5.0,
                 burst_size=30.0),
    TrafficShape(base_qps=100.0, duration_s=1.5, diurnal_amplitude=2.0,
                 diurnal_period_s=0.5, burst_rate_hz=2.0, burst_size=20.0,
                 burst_width_s=0.02),
]


def _jax_shape(shape):
    return jax_loadgen.TrafficShape(**shape.__dict__)


@pytest.mark.parametrize("shape_i", range(len(SHAPES)))
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("pooled", [False, True])
def test_build_schedule_matches_jax(index_terms, shape_i, seed, pooled):
    shape = SHAPES[shape_i]
    pool = _query_pool(index_terms, n=6) if pooled else None
    mix = QueryMix(distinct_pool=None if pooled else 16)
    jax_mix = jax_loadgen.QueryMix(distinct_pool=mix.distinct_pool)
    got = build_schedule(shape, index_terms, mix, seed=seed, pool=pool)
    want = jax_loadgen.build_schedule(_jax_shape(shape), index_terms,
                                      jax_mix, seed=seed, pool=pool)
    assert np.array_equal(got.times, want.times)
    assert got.queries == want.queries
    assert got.duration_s == want.duration_s
    assert got.offered_qps == want.offered_qps
    assert len(got) and np.all(np.diff(got.times) >= 0)
    assert got.times[-1] < shape.duration_s
    if pooled:
        assert set(got.queries) <= {tuple(q) for q in pool}


def test_rate_and_mix_match_jax(index_terms):
    shape = TrafficShape(base_qps=100.0, diurnal_amplitude=0.5,
                         diurnal_period_s=4.0)
    jshape = _jax_shape(shape)
    for t in np.linspace(0.0, 8.0, 33):
        assert shape.rate_at(t) == jshape.rate_at(t)
    assert shape.rate_at(1.0) == pytest.approx(150.0)
    assert shape.scaled(2.5).__dict__ == jshape.scaled(2.5).__dict__
    deep = TrafficShape(base_qps=100.0, diurnal_amplitude=2.0,
                        diurnal_period_s=4.0)
    assert deep.rate_at(3.0) == 0.0
    for distinct in (None, 8):
        got = QueryMix(distinct_pool=distinct).sample(
            index_terms, 200, np.random.default_rng(3))
        want = jax_loadgen.QueryMix(distinct_pool=distinct).sample(
            index_terms, 200, np.random.default_rng(3))
        assert got == want


def test_cost_model_matches_jax():
    cost = CostModel(per_bucket_us=200.0, per_query_us=50.0)
    jcost = jax_loadgen.CostModel(per_bucket_us=200.0, per_query_us=50.0)
    assert cost.flush_cost_us(2, 10) == jcost.flush_cost_us(2, 10) == 900.0
    for tier in (1, 8, 64):
        assert cost.capacity_qps(tier) == jcost.capacity_qps(tier)


def test_calibrate_from_profile_matches_jax():
    stores = (ProfileStore(), JaxProfileStore())
    rng = np.random.default_rng(2)
    samples = [(int(rng.integers(1, 33)), float(rng.uniform(100, 900)))
               for _ in range(60)]
    sig = dict(k=2, ts=(4, 5), gmaxes=(16, 32), capacity_tier=256)
    for store in stores:
        for b, us in samples:
            store.observe(ShapeSig(**sig), b, us)
    got = calibrate_from_profile(stores[0])
    want = jax_loadgen.calibrate_from_profile(stores[1])
    assert (got.per_bucket_us, got.per_query_us) == \
        (want.per_bucket_us, want.per_query_us)
    flat = ProfileStore()
    flat.observe(ShapeSig(**sig), 4, 120.0)
    assert calibrate_from_profile(flat) is None


# ---------------------------------------------------------------------------
# burn accounting on identical tickets
# ---------------------------------------------------------------------------

def _fake_ticket(cls, wait_us, deadline_us=1000.0, cached=False, error=None):
    t = cls(submitted_at=0.0, deadline_us=deadline_us)
    if error is not None:
        t.resolve_error(error, wait_us=wait_us)
        return t
    stats = {"cached": True} if cached else {"batch_size": 4}
    t.resolve(SimpleNamespace(latency_us=5.0, stats=stats), wait_us=wait_us)
    return t


def _stub_entries(cls):
    boom = RuntimeError("bucket failed")
    return [
        (0.05, _fake_ticket(cls, 999.0)),
        (0.15, _fake_ticket(cls, 1000.0 + BURN_EPS_US)),
        (0.25, _fake_ticket(cls, 1001.0)),
        (0.35, _fake_ticket(cls, 400.0, deadline_us=0.0, cached=True)),
        (0.45, _fake_ticket(cls, 1500.0, deadline_us=0.0, cached=True)),
        (0.2, _fake_ticket(cls, 100.0, error=boom)),
        (0.99, _fake_ticket(cls, 2000.0)),
    ]


@pytest.mark.parametrize("windows", [2, 5])
def test_make_report_matches_jax(windows):
    EXEC_COUNTERS.reset()
    JAX_COUNTERS.reset()
    got = _make_report("virtual", _stub_entries(Ticket), deadline_us=1000.0,
                       duration_s=0.5, windows=windows)
    want = jax_loadgen._make_report("virtual", _stub_entries(JaxTicket),
                                    deadline_us=1000.0, duration_s=0.5,
                                    windows=windows)
    assert got.to_json() == want.to_json()
    assert got.completed == 6 and got.errors == 1 and got.burned == 3
    assert got.queued_queries == 4
    assert got.burn_curve[-1]["burned"] >= 1
    assert set(got.counters) == set(want.counters)


# ---------------------------------------------------------------------------
# the virtual-time replay against the JAX package
# ---------------------------------------------------------------------------

def _fresh_engine(postings, pool, flush_tier=4, deadline_us=2000.0,
                  jax=False):
    if jax:
        return JaxAsyncSearchEngine(postings, seed=3, flush_tier=flush_tier,
                                    deadline_us=deadline_us, result_cache=0,
                                    warm_queries=pool)
    return AsyncSearchEngine(postings, seed=3, flush_tier=flush_tier,
                             deadline_us=deadline_us, result_cache=0,
                             warm_queries=pool, device=CPU)


def _device_query(eng, pool):
    return next(tuple(q) for q in pool
                if eng.plan(list(q)).algorithm == "device")


@pytest.mark.parametrize("cost_args,scale", [((500.0, 100.0), 1.0),
                                             ((2000.0, 750.0), 25.0)])
def test_run_virtual_matches_jax(postings, index_terms, cost_args, scale):
    pool = _query_pool(index_terms, n=8)
    shape = TrafficShape(base_qps=300.0 if scale == 1.0 else 30.0,
                         duration_s=0.5, burst_rate_hz=2.0, burst_size=6.0)
    sched = build_schedule(shape.scaled(scale), index_terms, seed=11,
                           pool=pool)
    jsched = jax_loadgen.build_schedule(_jax_shape(shape).scaled(scale),
                                        index_terms, seed=11, pool=pool)
    assert len(sched) > 50
    rep, entries = run_virtual(_fresh_engine(postings, pool), sched,
                               CostModel(*cost_args))
    jrep, jentries = jax_loadgen.run_virtual(
        _fresh_engine(postings, pool, jax=True), jsched,
        jax_loadgen.CostModel(*cost_args))
    got, want = rep.to_json(), jrep.to_json()
    got.pop("p99_e2e_us")
    want.pop("p99_e2e_us")
    assert got == want
    assert [t.wait_us for _, t in entries] == [t.wait_us for _, t in jentries]
    for (_, t), (_, jt) in zip(entries, jentries):
        assert t.error is None and jt.error is None
        assert np.array_equal(t.value.doc_ids, np.asarray(jt.value.doc_ids))
        assert t.value.algorithm == jt.value.algorithm


def test_run_virtual_waits_and_restores_engine(postings, index_terms):
    pool = _query_pool(index_terms, n=4)
    eng = _fresh_engine(postings, pool, deadline_us=2000.0)
    q = _device_query(eng, pool)
    sched = ArrivalSchedule(times=np.asarray([0.1]), queries=(q,),
                            duration_s=0.2)
    rep, [(_, ticket)] = run_virtual(eng, sched, CostModel(200.0, 50.0))
    assert ticket.wait_us == pytest.approx(2000.0, abs=BURN_EPS_US)
    assert rep.burned == 0 and EXEC_COUNTERS["deadline_flushes"] == 1
    assert eng.inline_tier_flush and eng.pending() == 0
    full = ArrivalSchedule(times=np.zeros(4), queries=(q,) * 4,
                           duration_s=0.1)
    rep, entries = run_virtual(eng, full, CostModel(200.0, 50.0))
    assert EXEC_COUNTERS["tier_flushes"] == 1
    assert all(t.wait_us == pytest.approx(0.0, abs=BURN_EPS_US)
               for _, t in entries)


def test_virtual_overload_burns_low_load_does_not(postings, index_terms):
    pool = _query_pool(index_terms, n=8)
    cost = CostModel(per_bucket_us=2000.0, per_query_us=750.0)
    shape = TrafficShape(base_qps=30.0, duration_s=0.5, burst_rate_hz=0.0)
    low = build_schedule(shape, index_terms, seed=4, pool=pool)
    high = build_schedule(shape.scaled(25.0), index_terms, seed=4, pool=pool)
    rep_low, _ = run_virtual(_fresh_engine(postings, pool), low, cost)
    rep_high, _ = run_virtual(_fresh_engine(postings, pool), high, cost)
    assert rep_low.burn_rate < 0.2
    assert rep_high.burn_rate > max(0.3, 2 * rep_low.burn_rate)
    assert rep_high.p99_wait_us > rep_high.deadline_us


def test_attach_clock_guards(postings, index_terms):
    pool = _query_pool(index_terms, n=4)
    eng = _fresh_engine(postings, pool)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="stop the background"):
            attach_virtual_clock(eng)
        with pytest.raises(RuntimeError, match="owns"):
            run_virtual(eng, ArrivalSchedule(np.zeros(0), (), 0.1),
                        CostModel(1.0, 1.0))
    finally:
        eng.stop()
    clk = attach_virtual_clock(eng)
    eng.inline_tier_flush = False
    try:
        eng.submit(list(_device_query(eng, pool)))
        assert eng.pending() == 1
        with pytest.raises(RuntimeError, match="work in flight"):
            attach_wall_clock(eng)
        with pytest.raises(ValueError, match="perf_counter"):
            run_wallclock(eng, ArrivalSchedule(np.zeros(0), (), 0.1))
        clk.t += 1.0
        eng.pump()
    finally:
        eng.inline_tier_flush = True
    attach_wall_clock(eng)
    assert eng.clock is time.perf_counter


def test_calibrate_cost_on_the_port(postings, index_terms):
    pool = _query_pool(index_terms, n=8)
    eng = _fresh_engine(postings, pool, flush_tier=4)
    q = list(_device_query(eng, pool))
    cost = loadgen.calibrate_cost(eng, [q] * 4, tier=4, passes=2)
    assert cost.per_bucket_us >= 1.0 and cost.per_query_us >= 0.0
    assert cost.capacity_qps(4) > 0
    with pytest.raises(ValueError, match="tier"):
        loadgen.calibrate_cost(eng, [q], tier=4)


# ---------------------------------------------------------------------------
# wall-clock soak: 4 submitters and the background flusher
# ---------------------------------------------------------------------------

def test_wallclock_soak_exactly_once_no_leaks(postings, index_terms):
    pool = _query_pool(index_terms, n=8)
    eng = _fresh_engine(postings, pool, flush_tier=4, deadline_us=500.0)
    shape = TrafficShape(base_qps=150.0, duration_s=0.8, burst_rate_hz=2.0,
                         burst_size=8.0)
    sched = build_schedule(shape, index_terms, seed=6, pool=pool)
    assert len(sched) > 60
    before = set(threading.enumerate())
    rep, entries = run_wallclock(eng, sched, submitters=4, windows=4)
    assert eng._flusher_error is None
    assert rep.thread_leak == 0
    assert set(threading.enumerate()) <= before
    assert rep.arrivals == rep.completed == len(sched) and rep.errors == 0
    assert rep.counters["tickets_resolved"] == rep.completed
    assert rep.counters["inflight_dispatches"] == \
        rep.counters["inflight_collects"]
    assert rep.counters["tier_flushes"] + rep.counters["deadline_flushes"] \
        == rep.counters["inflight_dispatches"]
    oracle = SearchEngine(postings, seed=3, device=CPU)
    memo = {tuple(q): oracle.query(list(q)).doc_ids for q in pool}
    for (_, ticket), q in zip(entries, sched.queries):
        assert np.array_equal(ticket.value.doc_ids, memo[q]), q
    with pytest.raises(RuntimeError, match="single-shot"):
        entries[0][1].resolve(None)
