"""The slice end to end on the CPU: the port's ``SearchEngine.query_batch``
against the JAX package's, on the same band-passed Zipf corpus and the same
128-query paper-mix log.  Every query's doc ids, route and device stats must
be equal (tolerance 0), and so must the pass and result-cache counters.
"""
import numpy as np
import pytest

from repro.core.engine import EXEC_COUNTERS as JAX_COUNTERS
from repro.serve.search import SearchEngine as JaxSearchEngine
from repro.serve.search import zipf_query_log as jax_zipf_query_log

from repro_torch.core.engine import EXEC_COUNTERS
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.serve.search import SearchEngine, zipf_query_log

N_DOCS = 3000
STAT_KEYS = ("r", "tuples_survived", "capacity", "group_tuples", "batch_size")
COUNTER_KEYS = ("batch_calls", "rerun_calls", "result_cache_hits",
                "result_cache_misses", "inflight_dispatches",
                "inflight_collects")


@pytest.fixture(autouse=True)
def _reset_port_counters():
    EXEC_COUNTERS.reset()
    yield


@pytest.fixture(scope="module")
def postings():
    """Band-passed as benchmarks/fig_batched_qps.py does: drop stopword-like
    and hapax-range terms, keeping the paper's mid-frequency regime."""
    docs = zipf_corpus(N_DOCS, vocab=15000, mean_len=60, seed=11)
    return {t: p for t, p in inverted_index(docs).items()
            if 32 <= len(p) <= 0.04 * N_DOCS}


@pytest.fixture(scope="module")
def engines(postings):
    """(JAX, port) engine pairs by hashbin ratio; 2.0 routes the wider-ratio
    pairs of the log to the host HashBin path."""
    out = {}
    for ratio in (100.0, 2.0):
        out[ratio] = (
            JaxSearchEngine(postings, w=256, m=2, seed=11, use_device=True,
                            hashbin_ratio=ratio, result_cache=256),
            SearchEngine(postings, w=256, m=2, seed=11, hashbin_ratio=ratio,
                         result_cache=256, device="cpu"),
        )
    return out


def assert_same_answers(port, ref):
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        assert p.doc_ids.dtype == np.uint32
        assert np.array_equal(p.doc_ids, np.asarray(j.doc_ids))
        assert p.algorithm == j.algorithm
        if p.algorithm.endswith("/device") and not p.stats.get("cached"):
            for key in STAT_KEYS:
                assert p.stats[key] == j.stats[key], key
        else:
            assert p.stats.get("r") == j.stats.get("r")


def test_query_log_matches(postings):
    terms = sorted(postings)
    assert zipf_query_log(terms, 128, seed=12) == \
        jax_zipf_query_log(terms, 128, seed=12)


@pytest.mark.parametrize("ratio", [100.0, 2.0])
def test_query_batch_matches_jax(engines, ratio):
    jeng, teng = engines[ratio]
    jeng.invalidate_cache()
    teng.invalidate_cache()
    log = zipf_query_log(sorted(teng.index), 128, seed=12)
    routes = {teng.plan(q).algorithm for q in log}
    assert "device" in routes
    assert ("hashbin" in routes) == (ratio == 2.0)
    JAX_COUNTERS.reset()
    EXEC_COUNTERS.reset()
    ref = jeng.query_batch(log)
    port = teng.query_batch(log)
    assert_same_answers(port, ref)
    for q, res in zip(log, port):
        truth = teng.index[q[0]].values
        for t in q[1:]:
            truth = np.intersect1d(truth, teng.index[t].values)
        assert np.array_equal(res.doc_ids, np.sort(truth))
    for key in COUNTER_KEYS:
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key
    assert EXEC_COUNTERS["batch_calls"] < len(log)


@pytest.mark.parametrize("ratio", [100.0, 2.0])
def test_result_cache_hits_match_jax(engines, ratio):
    jeng, teng = engines[ratio]
    jeng.invalidate_cache()
    teng.invalidate_cache()
    log = zipf_query_log(sorted(teng.index), 64, seed=13)
    JAX_COUNTERS.reset()
    EXEC_COUNTERS.reset()
    first = (jeng.query_batch(log), teng.query_batch(log))
    assert_same_answers(first[1], first[0])
    again = (jeng.query_batch(log), teng.query_batch(log))
    assert_same_answers(again[1], again[0])
    assert all(r.stats.get("cached") for r in again[1])
    for key in COUNTER_KEYS:
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key
    assert EXEC_COUNTERS["result_cache_hits"] >= len(log)


def test_add_postings_stales_cache(engines):
    _, teng = engines[100.0]
    teng.invalidate_cache()
    a, b = sorted(teng.index)[:2]
    before = teng.query([a, b])
    assert teng.query([a, b]).stats.get("cached")
    extra = np.setdiff1d(teng.index[b].values, teng.index[a].values)[:5]
    old = teng.index[a].values.copy()
    try:
        teng.add_postings(a, np.union1d(old, extra))
        after = teng.query([a, b])
        assert not after.stats.get("cached")
        assert np.array_equal(after.doc_ids,
                              np.union1d(before.doc_ids, extra))
    finally:
        teng.add_postings(a, old)


def test_query_single_and_empty(engines):
    _, teng = engines[100.0]
    a, b = sorted(teng.index)[:2]
    single = teng.query([b, a, a])
    batch = teng.query_batch([[a, b]])[0]
    assert np.array_equal(single.doc_ids, batch.doc_ids)
    missing = teng.query([a, -1])
    assert missing.algorithm == "empty" and missing.doc_ids.size == 0
