"""The port's collect timed from inside, on the CPU: the bytes each pass
brings to the host, the collect's parts against ``collect_us``, host-plan
time, the ``wait`` / ``copy`` / ``filter`` and ``host_plan`` spans, the
``device`` span's ``device_us`` and ``passes``, and the profiler ranges,
opened only while a profiler records."""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engine
from repro_torch.core.engine import EXEC_COUNTERS
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.exec.batch import bucket_plans, dispatch_bucket
from repro_torch.obs import Obs, reset_obs
from repro_torch.obs.trace import profiler_range
from repro_torch.serve.search import SearchEngine, zipf_query_log

CPU = "cpu"
PARTS = ("collect_wait_us", "collect_copy_us", "collect_filter_us")
RANGES = ("search.query_batch", "search.plan", "host_plan", "bucket.dispatch",
          "phase1.stack", "phase1.filter", "phase2", "collect.wait",
          "collect.copy", "collect.filter")


@pytest.fixture(autouse=True)
def _reset_port_obs():
    EXEC_COUNTERS.reset()
    reset_obs()
    yield


@pytest.fixture(scope="module")
def postings():
    return inverted_index(zipf_corpus(3000, vocab=400, mean_len=40, seed=3))


def mixed_log(eng):
    """Conjunctions, on the device and, past a size ratio of 30, HashBin
    pairs (one of sizes 66 and 2997 at least), and one expression."""
    terms = sorted(eng.index)
    by_n = sorted(terms, key=lambda x: eng.index[x].n)
    t = [str(x) for x in terms[:3]]
    return (zipf_query_log(terms, 16, seed=11) + [[by_n[0], by_n[-1]]]
            + [f"({t[0]}|{t[1]})&{t[2]}"])


def largest_bucket(eng, log):
    plans = [(i, eng.plan(q)) for i, q in enumerate(log)]
    buckets = bucket_plans([(i, p) for i, p in plans
                            if p.algorithm == "device" and p.expr is None])
    return max(buckets.items(), key=lambda kv: len(kv[1]))


@pytest.mark.parametrize("rerun", [False, True], ids=["first_pass", "rerun"])
def test_d2h_bytes_are_the_pass_outputs(postings, monkeypatch, rerun):
    """``d2h_bytes`` is what every pass's compaction leaves to copy, the
    first and an overflow re-run alike: 4 bytes an id of the rows taken
    (overflow rows are re-run, not copied), then the row offsets and the
    stats tensors; ``passes`` counts both passes."""
    eng = SearchEngine(postings, seed=3, device=CPU)
    sig, items = largest_bucket(eng, zipf_query_log(sorted(eng.index), 32,
                                                    seed=5))
    # capacity G holds every survivor; at 1, a query with two re-runs
    sig = dataclasses.replace(sig, capacity_tier=1 if rerun
                              else 1 << sig.ts[-1])
    outputs = []
    real = engine._intersect_k_batch

    def recorded(*args):
        out = packed, r, n_surv, overflow = real(*args)
        small = (len(r) + 1) * 8 + sum(t.numel() * t.element_size()
                                       for t in (r, n_surv, overflow))
        outputs.append(4 * int(r[~overflow].sum()) + small)
        return out

    monkeypatch.setattr(engine, "_intersect_k_batch", recorded)
    obs = Obs(trace=True)
    EXEC_COUNTERS.reset()
    dispatch_bucket(eng.device.sets.__getitem__, sig, items, device=CPU,
                    obs=obs).collect()
    snap = EXEC_COUNTERS.snapshot()
    assert snap["rerun_calls"] == int(rerun)
    assert len(outputs) == snap["batch_calls"] == 1 + int(rerun)
    assert snap["d2h_bytes"] == sum(outputs)
    [device] = obs.tracer.finished("device")
    assert device.attrs == {"device_us": 0.0, "passes": 1 + int(rerun)}
    kids = [s.name for s in obs.tracer.finished()
            if s.parent_id == obs.tracer.finished("collect")[0].span_id]
    assert kids == ["wait", "copy", "filter"] * (1 + int(rerun))


def packed_collect(queries, capacity):
    """The collect as it was before compaction: every pass's whole packed
    buffer, its -1 padding dropped on the host, overflow rows re-run once
    at capacity G."""
    ordered = [sorted(q, key=engine.set_sort_key) for q in queries]
    ts = tuple(s.t for s in ordered[0])
    G = 1 << ts[-1]
    results = [None] * len(ordered)
    active, cap = list(range(len(ordered))), capacity
    while active:
        packed, r, n_surv, over = engine._intersect_k_batch(
            [[ordered[i][j].vals for i in active] for j in range(len(ts))],
            [[ordered[i][j].images for i in active] for j in range(len(ts))],
            ts, cap)
        rerun = []
        for row, qi in enumerate(active):
            if over[row]:
                rerun.append(qi)
                continue
            vals = packed[row].numpy().ravel()
            results[qi] = (np.sort(vals[vals != -1].view(np.uint32)), {
                "group_tuples": G, "tuples_survived": int(n_surv[row]),
                "capacity": cap, "r": int(r[row]),
                "batch_size": len(active)})
        active, cap = rerun, G
    return results


@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
def test_compacted_collect_gives_the_packed_answers(postings, overflow):
    """``intersect_device_batch`` gives, value for value and stat for stat,
    what the collect of the whole packed buffer gave, a bucket that
    overflows and re-runs at G included, and the exact intersections."""
    eng = SearchEngine(postings, seed=3, device=CPU)
    sig, items = largest_bucket(eng, zipf_query_log(sorted(eng.index), 32,
                                                    seed=5))
    terms = [p.terms for _, p in items]
    queries = [[eng.device.sets[t] for t in q] for q in terms]
    # capacity G holds every survivor; at 1, the queries with two re-run
    cap = 1 if overflow else 1 << sig.ts[-1]
    got = engine.intersect_device_batch(queries, capacity=cap, device=CPU)
    want = packed_collect(queries, cap)
    assert len(got) == len(want) == len(items) > 1
    for (gv, gs), (wv, ws), q in zip(got, want, terms):
        assert gv.dtype == np.uint32 and np.array_equal(gv, wv)
        assert gs == ws
        exact = functools.reduce(np.intersect1d, [postings[t] for t in q])
        assert np.array_equal(gv, exact)
    reruns = sum(s["capacity"] != cap for _, s in got)
    assert (reruns > 0) == overflow
    assert EXEC_COUNTERS["compact_calls"] == EXEC_COUNTERS["batch_calls"] \
        == 1 + int(reruns > 0)


def test_collect_parts_add_up_to_no_more_than_collect_us(postings):
    eng = SearchEngine(postings, seed=3, device=CPU, hashbin_ratio=30.0)
    log = mixed_log(eng)
    for _ in range(3):
        eng.query_batch(log)
    snap = EXEC_COUNTERS.snapshot()
    assert sum(snap[p] for p in PARTS) <= snap["collect_us"]
    assert snap["collect_filter_us"] > 0 and snap["d2h_bytes"] > 0
    assert snap["pass_device_us"] == 0  # no device clock on the CPU


def test_host_plan_us_moves_only_with_host_plans(postings):
    eng = SearchEngine(postings, seed=3, device=CPU, hashbin_ratio=30.0)
    log = mixed_log(eng)
    device_only = [q for q in log if eng.plan(q).algorithm == "device"]
    hashbin_pairs = [q for q in log if eng.plan(q).algorithm == "hashbin"]
    assert hashbin_pairs and len(device_only) + len(hashbin_pairs) == len(log)
    eng.query_batch(device_only)
    assert EXEC_COUNTERS["host_plan_us"] == 0
    assert EXEC_COUNTERS["batch_calls"] > 0
    got = eng.query_batch(hashbin_pairs * 8)
    assert {r.algorithm for r in got} == {"hashbin"}
    assert EXEC_COUNTERS["host_plan_us"] >= int(sum(r.latency_us
                                                    for r in got)) - len(got)
    assert EXEC_COUNTERS["host_plan_us"] > 0


def test_traced_query_batch_spans(postings):
    """Every ``collect`` has its parts as children, every ``device`` span
    its ``device_us`` and ``passes`` (as many as the passes run), and each
    host-routed query a ``host_plan`` root naming its algorithm."""
    obs = Obs(trace=True)
    eng = SearchEngine(postings, seed=3, device=CPU, hashbin_ratio=30.0,
                       obs=obs)
    got = eng.query_batch(mixed_log(eng))
    spans = obs.tracer.finished()
    collects = [s for s in spans if s.name == "collect"]
    assert len(collects) == len(obs.tracer.finished("bucket")) > 1
    for c in collects:
        kids = sorted((s for s in spans if s.parent_id == c.span_id),
                      key=lambda s: s.start_us)
        assert [s.name for s in kids][:3] == ["wait", "copy", "filter"]
        assert {s.name for s in kids} == {"wait", "copy", "filter"}
        assert c.start_us <= kids[0].start_us
        assert kids[-1].end_us <= c.end_us
    devices = obs.tracer.finished("device")
    assert all(s.attrs["device_us"] == 0.0 for s in devices)
    assert sum(s.attrs["passes"] for s in devices) == \
        EXEC_COUNTERS["batch_calls"] + EXEC_COUNTERS["expr_calls"]
    host = obs.tracer.finished("host_plan")
    assert [s.attrs["algorithm"] for s in host] == \
        [r.algorithm for r in got if not r.algorithm.startswith(
            ("rangroupscan/", "expr/device"))]
    assert {s.attrs["algorithm"] for s in host} == {"hashbin"}
    assert all(s.parent_id is None for s in host)
    assert obs.tracer.open_count() == 0


def test_profiler_sees_the_program_ranges(postings):
    eng = SearchEngine(postings, seed=3, device=CPU, hashbin_ratio=30.0)
    log = mixed_log(eng)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.query_batch(log)
    names = {e.name for e in prof.events()}
    assert set(RANGES) <= names, set(RANGES) - names


def test_no_range_without_a_profiler(postings, monkeypatch):
    """With no profiler recording, no site opens a range: the helper hands
    back one shared no-op context."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    eng = SearchEngine(postings, seed=3, device=CPU, hashbin_ratio=30.0)
    eng.query_batch(mixed_log(eng))
    assert entered == []
    assert profiler_range("a") is profiler_range("b")
    with profile(activities=[ProfilerActivity.CPU]):
        eng.query_batch(mixed_log(eng))
    assert set(RANGES) <= set(entered)
