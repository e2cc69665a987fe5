"""The port's observability layer on the CPU, against the JAX package,
mirroring ``tests/test_obs.py``.

Units first: the same operations on both packages' registries, tracers and
profile stores give equal snapshots, expositions, span trees, residuals and
fits, and ``sig_label`` names every kind of plan alike.  Then the serving
stack: the same submits through both packages' ``AsyncSearchEngine``s
(``Obs(trace=True)``, a fake clock; the port on ``device="cpu"``, the JAX
package on its reference path) cover every route (cache, subcache, host
RanGroupScan and expression, HashBin, device flat and expression buckets,
a failed bucket) and must give equal span forests (ids and times dropped,
cross-links mapped), equal histogram counts and equal counters.  A traced
``SuggestEngine`` and a 2x2 topology (the JAX side in a subprocess with
eight forced host devices) are held to the same.  Exact unless stated.
"""
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import _torch_mesh_cases as cases
import repro.obs as jax_obs
import repro.serve.search as jax_search
from repro.core.engine import EXEC_COUNTERS as JAX_COUNTERS
from repro.exec.plan import ShapeSig as JaxShapeSig
from repro.exec.plan import plan_query as jax_plan_query
from repro.exec.plan import plan_suggest as jax_plan_suggest
from repro.serve.loadgen import CostModel as JaxCostModel

import repro_torch.obs as obs_mod
import repro_torch.serve.search as search
from repro_torch.core.engine import EXEC_COUNTERS, PendingBatch
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.exec.batch import bucket_plans, dispatch_bucket
from repro_torch.exec.plan import ShapeSig, plan_query, plan_suggest
from repro_torch.obs import (
    NULL_SPAN, Obs, get_obs, parse_json, parse_prometheus, reset_obs, set_obs,
    sig_label, to_json, to_prometheus,
)
from repro_torch.obs.profile import ProfileStore
from repro_torch.obs.trace import Tracer, format_trace
from repro_torch.serve.loadgen import CostModel, calibrate_from_profile
from repro_torch.serve.search import (
    AsyncSearchEngine, SearchEngine, zipf_query_log,
)

CPU = "cpu"
# counters only the port keeps
PORT_ONLY_COUNTERS = {"warm_reruns"}
# counters that depend on what ran before in the process (first sightings)
# or on the wall clock
UNCOMPARED_COUNTERS = {"batch_traces", "count_traces", "expr_traces",
                       "sharded_traces", "mesh2d_traces", "collect_us"}


@pytest.fixture(autouse=True)
def _reset_port_obs():
    EXEC_COUNTERS.reset()
    reset_obs()
    yield


@pytest.fixture(scope="module")
def postings():
    return inverted_index(zipf_corpus(3000, vocab=400, mean_len=40, seed=3))


PORT = SimpleNamespace(obs=obs_mod, search=search, counters=EXEC_COUNTERS,
                       cost=CostModel, kw={"device": CPU})
JAX = SimpleNamespace(obs=jax_obs, search=jax_search, counters=JAX_COUNTERS,
                      cost=JaxCostModel, kw={"use_device": True})


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_us(self, us):
        self.t += us * 1e-6


# ---------------------------------------------------------------------------
# units: registry, exposition, tracer, profile, labels
# ---------------------------------------------------------------------------

def _registry_script(pkg):
    r = pkg.obs.MetricsRegistry()
    c = r.counter("reqs", "requests")
    g = r.gauge("depth", "queue depth")
    hw = r.gauge("high", "high water", track_max=True)
    h = r.histogram("lat_us", "latency", buckets=[1.0, 10.0, 100.0])
    p2 = r.histogram("rows", buckets=pkg.obs.pow2_buckets(1, 64))
    lat = r.histogram("wait_us")
    c.inc()
    c.inc(2.5)
    g.set(5)
    g.dec(2)
    g.inc(0.25)
    hw.set(4)
    hw.set(2)
    for v in (0.5, 3.0, 10.0, 50.0, 1e6):
        h.observe(v)
    for v in (1, 3, 64, 65):
        p2.observe(v)
    for v in (0.1, 7.0, 2e3, 3e7):
        lat.observe(v)
    r.register_collector(lambda: {"ext_thing": 7.0, "ext_other": 0.5})
    quantiles = [h.quantile(q) for q in (0.0, 0.25, 0.5, 0.99, 1.0)]
    with pytest.raises(ValueError):
        r.gauge("reqs")
    with pytest.raises(ValueError):
        c.inc(-1)
    return r, quantiles


def test_registry_snapshot_and_exposition_match_jax():
    port, port_q = _registry_script(PORT)
    jax, jax_q = _registry_script(JAX)
    assert port.names() == jax.names()
    assert port.snapshot() == jax.snapshot()
    assert port_q == jax_q
    text = to_prometheus(port.snapshot())
    assert text == jax_obs.to_prometheus(jax.snapshot())
    assert to_json(port.snapshot()) == jax_obs.to_json(jax.snapshot())
    assert parse_prometheus(text) == jax_obs.parse_prometheus(text)
    assert parse_json(to_json(port.snapshot())) == port.snapshot()
    port.reset()
    jax.reset()
    assert port.snapshot() == jax.snapshot()
    assert port.snapshot()["counters"]["reqs"] == 0


def test_bucket_lattices_match_jax():
    assert obs_mod.default_latency_buckets() == \
        jax_obs.default_latency_buckets()
    assert obs_mod.default_latency_buckets(1.0, 100.0) == \
        [1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0]
    assert obs_mod.pow2_buckets(1, 1 << 20) == jax_obs.pow2_buckets(1, 1 << 20)


def test_parsers_reject_what_jax_rejects():
    for parse in (parse_prometheus, jax_obs.parse_prometheus):
        with pytest.raises(ValueError, match="unparseable"):
            parse("this is { not an exposition\n")
        bad = ('# TYPE h histogram\nh_bucket{le="1"} 5\n'
               'h_bucket{le="2"} 3\nh_sum 1\nh_count 5\n')
        with pytest.raises(ValueError, match="not cumulative"):
            parse(bad)
    broken = Obs().snapshot()
    broken["histograms"]["bucket_batch_size"]["count"] = 99
    for parse, write in ((parse_json, to_json),
                         (jax_obs.parse_json, jax_obs.to_json)):
        with pytest.raises(ValueError, match="missing section"):
            parse("{}")
        with pytest.raises(ValueError, match="count"):
            parse(write(broken))


def test_snapshot_ring_matches_jax():
    rings = [obs_mod.SnapshotRing(maxlen=3), jax_obs.SnapshotRing(maxlen=3)]
    for ring in rings:
        for i in range(5):
            ring.push(float(i), {"i": i})
    assert [r.entries() for r in rings][0] == rings[1].entries()
    assert len(rings[0]) == 3 and rings[0].latest() == (4.0, {"i": 4})
    rings[0].clear()
    assert rings[0].latest() is None


def _trace_script(pkg):
    fake = [100.0]
    t = pkg.obs.Tracer(enabled=True, max_finished=6, clock=lambda: fake[0])
    root = t.start("request", route="device")
    with root.child("plan"):
        fake[0] += 1e-4
    t.span_at("device", 10.0, 20.0, parent=root)
    bucket = t.start("bucket", start_us=50.0 * 1e6, sig="k2/t4x5/cap256")
    fake[0] = 101.0
    bucket.end(error=True)
    root.end(wait_us=3.0)
    root.end(wait_us=9.0)  # idempotent
    with pytest.raises(ValueError):
        with t.start("request") as failing:
            raise ValueError("nope")
    still_open = t.start("stuck")
    tree = [(s.name, s.start_us, s.end_us, sorted(s.attrs.items()),
             s.parent_id is None) for s in t.finished()]
    dump = re.sub(r"#\d+|trace \d+", "#", t.dump())
    for i in range(10):
        t.span_at(f"s{i}", 0.0, 1.0)
    disabled = pkg.obs.Tracer(enabled=False)
    null = disabled.start("request")
    null.child("plan").set(x=1).end()
    return {"tree": tree, "dump": dump, "open": t.open_count(),
            "open_names": [s.name for s in t.open_spans()],
            "kept": len(t.finished()), "dropped": t.dropped,
            "failing": "error" in failing.attrs,
            "still_open": repr(still_open).endswith("open)"),
            "null": (null is pkg.obs.NULL_SPAN, null.attrs,
                     disabled.finished(), disabled.open_count())}


def test_tracer_matches_jax():
    port, jax = _trace_script(PORT), _trace_script(JAX)
    assert port == jax
    assert port["kept"] == 6 and port["dropped"] > 0
    assert port["open_names"] == ["stuck"]
    assert port["null"] == (True, {}, [], 0)


def test_format_trace_orphans_and_limit():
    t = Tracer(enabled=True)
    root = t.start("request")
    child = root.child("plan")
    child.end()
    root.end()
    only_child = format_trace([child])
    assert f"parent=#{root.span_id}" in only_child
    for _ in range(5):
        t.start("bucket").end()
    assert format_trace(t.finished(), limit=2).count("trace ") == 2


def _profile_script(pkg, sig):
    store = pkg.obs.ProfileStore(
        max_samples=8, cost_model=pkg.cost(per_bucket_us=100.0,
                                           per_query_us=5.0))
    rng = np.random.default_rng(4)
    for i in range(40):
        b = int(rng.integers(1, 17))
        store.observe(sig(256 << (i % 2)), b,
                      100.0 + 5.0 * b + float(rng.normal(0, 20)))
    single = pkg.obs.ProfileStore()
    for _ in range(5):
        single.observe(sig(256), 4, 120.0)
    return store.residuals(), store.fit_cost(), single.fit_cost()


def _sig_pair(cap, shards=1, replicas=1):
    kw = dict(k=2, ts=(4, 5), gmaxes=(16, 32), capacity_tier=cap,
              shards=shards, replicas=replicas)
    return ShapeSig(**kw), JaxShapeSig(**kw)


def test_profile_residuals_and_fit_match_jax():
    port = _profile_script(PORT, lambda cap: _sig_pair(cap)[0])
    jax = _profile_script(JAX, lambda cap: _sig_pair(cap)[1])
    assert port[0].keys() == jax[0].keys()
    for label in port[0]:
        for key, v in port[0][label].items():
            assert v == pytest.approx(jax[0][label][key], rel=1e-9), key
    assert port[1] == pytest.approx(jax[1], rel=1e-9)
    assert port[2] is None and jax[2] is None
    fit = calibrate_from_profile(ProfileStore())
    assert fit is None


def test_profile_fit_closes_calibration_loop():
    store = ProfileStore()
    for b in (1, 2, 4, 8, 16):
        store.observe(_sig_pair(256)[0], b, 200.0 + 7.0 * b)
    fit = calibrate_from_profile(store)
    assert fit.per_bucket_us == pytest.approx(200.0, rel=1e-6)
    assert fit.per_query_us == pytest.approx(7.0, rel=1e-6)
    windowed = ProfileStore(max_samples=8)
    for i in range(50):
        windowed.observe(_sig_pair(256)[0], 1 + i % 3, 10.0)
    assert windowed.residuals()[sig_label(_sig_pair(256)[0])][
        "buckets"] == 50
    assert len(windowed._sigs[_sig_pair(256)[0]].samples) == 8


def test_sig_label_matches_jax_on_a_mixed_log(postings):
    """Flat, expression, count and sharded / 2-D signatures: the port's
    planner and the JAX package's plan the same signatures, and both
    label them letter for letter alike (HashBin plans carry none)."""
    eng = SearchEngine(postings, seed=3, device=CPU)
    terms = sorted(eng.index)
    log = zipf_query_log(terms, 24, seed=11)
    t = [str(x) for x in terms[:6]]
    log += [f"({t[0]}|{t[1]})&{t[2]}", f"({t[3]}&{t[4]})-{t[5]}",
            f"{t[0]}|{t[5]}"]
    by_n = sorted(terms, key=lambda x: eng.index[x].n)
    log.append([by_n[0], by_n[-1]])  # HashBin
    labels, kinds = [], set()
    for mesh in ({}, {"mesh_shards": 4, "shard_min_g": 4},
                 {"mesh_shards": 2, "mesh_replicas": 2, "shard_min_g": 4}):
        for q in log:
            p = plan_query(eng.index, q, **mesh)
            j = jax_plan_query(eng.index, q, **mesh)
            assert p.algorithm == j.algorithm, q
            if p.sig is None:
                continue
            assert sig_label(p.sig) == jax_obs.sig_label(j.sig), q
            labels.append(sig_label(p.sig))
    for probe, cands, k in ((terms[0], terms[1:4], 8),
                            (terms[2], terms[5:6], 3)):
        cands = [c for c in cands
                 if (eng.index[c].t, eng.index[c].gmax)
                 == (eng.index[cands[0]].t, eng.index[cands[0]].gmax)]
        for mesh in ({}, {"mesh_shards": 2, "shard_min_g": 1}):
            p = plan_suggest(eng.index, probe, cands, k, **mesh)
            j = jax_plan_suggest(eng.index, probe, cands, k, **mesh)
            assert sig_label(p.sig) == jax_obs.sig_label(j.sig)
            labels.append(sig_label(p.sig))
    for label in labels:
        kinds |= {part[0] for part in label.split("/")[3:]}
        kinds |= {"e" for part in label.split("/") if part == "expr"}
    assert {"s", "r", "e", "c"} <= kinds, labels


# ---------------------------------------------------------------------------
# the serving stack, both packages through the same script
# ---------------------------------------------------------------------------

def _error_bucket(*a, **kw):
    raise RuntimeError("boom")


def _engine_script(pkg, postings, monkeypatch):
    """Every route of ``submit`` through a traced AsyncSearchEngine on a
    fake clock, plus a device-less engine on the same ``Obs``."""
    pkg.counters.reset()
    obs = pkg.obs.Obs(trace=True)
    clock = FakeClock()
    eng = pkg.search.AsyncSearchEngine(
        postings, seed=3, flush_tier=4, deadline_us=1000.0, result_cache=64,
        hashbin_ratio=30.0, clock=clock, obs=obs, **pkg.kw)
    host = pkg.search.AsyncSearchEngine(
        postings, seed=3, result_cache=0, clock=clock, obs=obs,
        use_device=False)
    terms = sorted(eng.index)
    log = zipf_query_log(terms, 12, seed=11)
    t = [str(x) for x in terms[:6]]
    by_n = sorted(terms, key=lambda x: eng.index[x].n)
    hashbin_pair = [by_n[0], by_n[-1]]  # sizes 66 and 2997
    tickets = []
    for q in log:  # device buckets: full tiers flush inline, the rest here
        clock.advance_us(150.0)
        tickets.append(eng.submit(q))
    clock.advance_us(2000.0)
    eng.pump()
    for q in log[:3]:  # cache hits
        tickets.append(eng.submit(q))
    tickets.append(eng.submit(f"({t[0]}|{t[1]})&{t[2]}"))  # expr/device
    clock.advance_us(300.0)
    eng.drain()
    tickets.append(eng.submit(f"({t[0]}|{t[1]})&{t[3]}"))  # expr/subcache
    tickets.append(eng.submit(hashbin_pair))                # hashbin
    tickets.append(host.submit(log[0]))                     # rangroupscan
    tickets.append(host.submit(f"({t[0]}|{t[1]})&{t[2]}"))  # expr/host
    eng.invalidate_cache()
    with monkeypatch.context() as m:                        # a failed bucket
        m.setattr(pkg.search, "dispatch_bucket", _error_bucket)
        tickets.append(eng.submit(next(
            q for q in log if eng.plan(q).algorithm == "device")))
        eng.drain()
    with pytest.raises(ValueError):                         # a failed plan
        eng.submit(f"({t[0]}|")
    snap = obs.registry.snapshot()
    return SimpleNamespace(
        tickets=tickets, obs=obs, snap=snap,
        forest=cases.span_forest(obs.tracer),
        answers=[(t.error is None and t.value.algorithm,
                  t.error is None and t.value.doc_ids.tolist(),
                  type(t.error).__name__, t.wait_us) for t in tickets],
        counters=pkg.counters.snapshot())


def test_async_engine_spans_match_jax(postings, monkeypatch):
    port = _engine_script(PORT, postings, monkeypatch)
    jax = _engine_script(JAX, postings, monkeypatch)
    assert port.answers == jax.answers
    algos = {a for a, *_ in port.answers}
    assert {"rangroupscan/device", "expr/device", "expr/subcache",
            "hashbin", "rangroupscan", "expr/host", False} <= algos, algos
    assert port.forest == jax.forest
    roots = port.obs.tracer.finished("request")
    routes = {s.attrs.get("route") for s in roots}
    assert routes == {"device", "cache", "subcache", "host", None}, routes
    # one closed root per ticket, plus the submit that raised in planning
    assert len(roots) == len(port.tickets) + 1
    assert port.obs.tracer.open_count() == 0
    assert sum(s.attrs.get("error") == "RuntimeError" for s in roots) == 1
    assert sum(s.attrs.get("error") is True for s in roots) == 1
    bucket_spans = port.obs.tracer.finished("bucket")
    assert bucket_spans and all(s.attrs["traces"] for s in bucket_spans)
    for name in ("dispatch", "device", "collect"):
        assert len(port.obs.tracer.finished(name)) == len(bucket_spans)
    # histograms: equal counts (waits come from the fake clock)
    ph, jh = port.snap["histograms"], jax.snap["histograms"]
    assert ph.keys() == jh.keys()
    for name in ("queue_wait_us", "bucket_batch_size", "bucket_survivors"):
        assert ph[name]["counts"] == jh[name]["counts"], name
        assert ph[name]["count"] == jh[name]["count"], name
    assert ph["queue_wait_us"]["sum"] == pytest.approx(
        jh["queue_wait_us"]["sum"])
    assert ph["queue_wait_us"]["count"] == len(port.tickets)
    assert ph["collect_latency_us"]["count"] == \
        jh["collect_latency_us"]["count"] == len(bucket_spans)
    assert port.snap["counters"] == jax.snap["counters"]
    assert port.snap["gauges"] == jax.snap["gauges"]
    # the exec_ collector: JAX's key set, the port's own keys listed
    pc, jc = port.snap["collected"], jax.snap["collected"]
    assert set(pc) - set(jc) == {f"exec_{k}" for k in PORT_ONLY_COUNTERS}
    assert set(jc) <= set(pc)
    skip = {f"exec_{k}" for k in UNCOMPARED_COUNTERS}
    assert {k: pc[k] for k in jc if k not in skip} == \
        {k: v for k, v in jc.items() if k not in skip}
    assert pc["exec_tickets_resolved"] == len(port.tickets)


def test_disabled_tracer_records_no_spans(postings):
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=64, max_inflight=8,
                            device=CPU)
    assert eng.obs is get_obs() and not eng.obs.tracer.enabled
    assert eng.obs.tracer.start("request") is NULL_SPAN
    log = zipf_query_log(sorted(eng.index), 8, seed=11)
    for q in log:
        eng.submit(q)
    eng.drain()
    assert eng.obs.tracer.finished() == []
    assert eng.obs.tracer.open_count() == 0
    assert eng.obs.queue_wait.count == len(log)  # metrics still flow
    assert eng.obs.batch_size.count >= 1


def test_global_obs_reset_discards_override():
    mine = set_obs(Obs(trace=True))
    assert get_obs() is mine
    reset_obs()
    fresh = get_obs()
    assert fresh is not mine and not fresh.tracer.enabled


def test_obs_reset_leaves_exec_counters_alone():
    obs = Obs()
    obs.dispatch_failures.inc()
    obs.queue_wait.observe(5.0)
    EXEC_COUNTERS.bump("batch_calls", 3)
    obs.reset()
    assert obs.dispatch_failures.value == 0
    assert obs.queue_wait.count == 0
    assert EXEC_COUNTERS["batch_calls"] == 3
    assert obs.snapshot()["collected"]["exec_batch_calls"] == 3.0


def test_prometheus_round_trip_reads_port_counters():
    obs = Obs()
    obs.queue_wait.observe(42.0)
    obs.queue_wait.observe(4200.0)
    obs.dispatch_failures.inc(3)
    obs.inflight.set(2)
    EXEC_COUNTERS.bump("batch_calls", 5)
    parsed = parse_prometheus(to_prometheus(obs.snapshot()))
    h = parsed["repro_queue_wait_us"]
    assert h["type"] == "histogram" and h["count"] == 2
    assert h["sum"] == pytest.approx(4242.0)
    assert h["buckets"][-1] == (float("inf"), 2)
    assert parsed["repro_dispatch_failures"]["value"] == 3
    assert parsed["repro_inflight_buckets"]["value"] == 2
    assert parsed["repro_exec_batch_calls"]["value"] == 5
    assert parsed["repro_exec_warm_reruns"]["value"] == 0


def test_flusher_fills_snapshot_ring(postings):
    obs = Obs()
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=4, deadline_us=500.0,
                            max_inflight=8, snapshot_every_s=0.05, obs=obs,
                            device=CPU)
    log = zipf_query_log(sorted(eng.index), 6, seed=11)

    def resolved_in_latest():
        latest = obs.ring.latest()
        return 0 if latest is None else \
            latest[1]["collected"]["exec_tickets_resolved"]

    with eng:
        tickets = [eng.submit(q) for q in log]
        for t in tickets:
            assert t.wait(timeout=60.0)
        deadline = time.time() + 10.0
        while resolved_in_latest() < len(log) and time.time() < deadline:
            time.sleep(0.01)
    assert len(obs.ring) >= 1
    assert resolved_in_latest() >= len(log)
    times = [t for t, _ in obs.ring.entries()]
    assert times == sorted(times)


def test_bucket_spans_overlap_in_window(postings):
    """An overlapped drain dispatches before it collects: bucket spans
    overlap, each with its three stage children, and the profile store
    saw every bucket."""
    obs = Obs(trace=True)
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=64, result_cache=0,
                            max_inflight=8, obs=obs, device=CPU)
    for q in zipf_query_log(sorted(eng.index), 24, seed=11):
        eng.submit(q)
    n_buckets = eng.drain()
    assert n_buckets >= 2
    bspans = sorted(obs.tracer.finished("bucket"), key=lambda s: s.start_us)
    assert len(bspans) == n_buckets
    assert any(b.start_us < a.end_us for a, b in zip(bspans, bspans[1:]))
    for name in ("dispatch", "device", "collect"):
        stage = obs.tracer.finished(name)
        assert {s.parent_id for s in stage} == {s.span_id for s in bspans}
    assert obs.inflight.value == 0
    assert obs.inflight_high_water.value == min(8, n_buckets)
    assert obs.batch_size.count == obs.collect_latency.count == n_buckets
    assert {sig_label(s) for s in obs.profile.signatures()} == \
        {s.attrs["sig"] for s in bspans}


def test_collect_failure_counts_once_and_closes_span(postings):
    obs = Obs(trace=True)
    eng = SearchEngine(postings, seed=3, device=CPU)
    log = zipf_query_log(sorted(eng.index), 8, seed=11)
    plans = [(i, eng.plan(q)) for i, q in enumerate(log)]
    buckets = bucket_plans([(i, p) for i, p in plans
                            if p.algorithm == "device"])
    sig = next(iter(buckets))
    bucket = dispatch_bucket(eng.device.sets.__getitem__, sig, buckets[sig],
                             device=CPU, obs=obs)
    assert obs.inflight.value == 1

    def boom():
        raise RuntimeError("fell over mid-collect")

    bucket.pending = PendingBatch(n_queries=len(buckets[sig]), _collect=boom)
    for _ in range(2):  # the teardown is one-shot
        with pytest.raises(RuntimeError, match="mid-collect"):
            bucket.collect()
    assert obs.inflight.value == 0
    assert obs.dispatch_failures.value == 1
    assert EXEC_COUNTERS["dispatch_failures"] == 1
    [span] = obs.tracer.finished("bucket")
    assert span.attrs["error"] is True
    assert obs.tracer.open_count() == 0


# ---------------------------------------------------------------------------
# suggestions
# ---------------------------------------------------------------------------

def _suggest_script(pkg, corpus, monkeypatch):
    pkg.counters.reset()
    obs = pkg.obs.Obs(trace=True)
    eng = pkg.search.SuggestEngine(corpus, seed=0, obs=obs, **pkg.kw)
    host = pkg.search.SuggestEngine(corpus, seed=0, obs=obs,
                                    use_device=False)
    reqs = [(0, 4), (3, 2), (5, 8), (0, 4)]
    first = eng.suggest_batch(reqs)
    second = eng.suggest_batch(reqs[:2] + [(7, 3)])  # cache hits and a miss
    on_host = host.suggest_batch([(1, 5)])
    with monkeypatch.context() as m:
        m.setattr(pkg.search, "execute_plan_buckets", _error_bucket)
        with pytest.raises(RuntimeError, match="boom"):
            eng.suggest_batch([(0, 4), (9, 6)])
    return SimpleNamespace(
        answers=[(r.suggestions, r.algorithm)
                 for r in first + second + on_host],
        forest=cases.span_forest(obs.tracer), obs=obs,
        hist={k: v["counts"] for k, v in
              obs.registry.snapshot()["histograms"].items()
              if k != "collect_latency_us"})


def test_suggest_batch_spans_match_jax(monkeypatch):
    corpus = cases.suggest_corpus(5)
    port = _suggest_script(PORT, corpus, monkeypatch)
    jax = _suggest_script(JAX, corpus, monkeypatch)
    assert port.answers == jax.answers
    assert port.forest == jax.forest
    assert port.hist == jax.hist
    roots = port.obs.tracer.finished("request")
    assert all(s.attrs["kind"] == "suggest" for s in roots)
    assert {s.attrs.get("route") for s in roots} == {"cache", "device",
                                                     "host", None}
    assert port.obs.tracer.open_count() == 0
    errored = [s for s in roots if s.attrs.get("error") is True]
    assert len(errored) == 1  # (0, 4) was a cache hit and closed already


# ---------------------------------------------------------------------------
# a 2x2 topology: the JAX side with eight forced host devices
# ---------------------------------------------------------------------------

def test_traced_2x2_topology_matches_jax(tmp_path):
    jax_results = cases.run_jax_cases(tmp_path, "obs")
    jax, port = cases.both(jax_results, "obs_mesh2d_traced")
    assert port["done"] and jax["done"]
    assert port["served"] == jax["served"]
    assert port["forest"] == jax["forest"]
    assert port["open"] == jax["open"] == 0
    assert port["hist"] == jax["hist"]
    assert port["counters"] == jax["counters"]
    assert port["loads"] == jax["loads"]
    placed = [dict(attrs) for name, _, attrs, _ in port["forest"]
              if name == "bucket" and dict(attrs)["replica"] is not None]
    assert placed, "no balancer-placed bucket"
    assert port["counters"].get("mesh2d_calls"), port["counters"]


def test_concurrent_submitters_close_every_root(postings):
    """Four submitter threads beside the flusher: every ticket closes
    exactly one root span, on whichever thread resolves it."""
    obs = Obs(trace=True)
    eng = AsyncSearchEngine(postings, seed=3, flush_tier=4, deadline_us=500.0,
                            result_cache=0, max_inflight=4, obs=obs,
                            device=CPU)
    log = zipf_query_log(sorted(eng.index), 40, seed=7)
    tickets = [None] * len(log)

    def submit(offset):
        for j in range(offset, len(log), 4):
            tickets[j] = eng.submit(log[j])

    with eng:
        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for t in tickets:
            assert t.wait(timeout=60.0)
    roots = obs.tracer.finished("request")
    assert len(roots) == len(log)
    assert len({s.trace_id for s in roots}) == len(log)
    assert obs.tracer.open_count() == 0
    assert obs.queue_wait.count == len(log)
    for s in obs.tracer.finished("bucket"):
        kids = {c.name for c in obs.tracer.finished()
                if c.parent_id == s.span_id}
        assert kids == {"dispatch", "device", "collect"}
