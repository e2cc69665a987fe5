"""The port's host algorithms and host route on the CPU, against the JAX
package: twins of ``tests/test_core_intersect.py``,
``tests/test_partition_baselines.py`` and ``tests/test_engine_and_compress.py``.

Both packages preprocess the same seeded sets with their own code; the
port's IntGroup, RanGroup, RanGroupScan (both recoveries), HashBin, the
seven Section-4 baselines, the Appendix-B compression and the γ/δ coders
must give the JAX package's outputs and ``Stats.__dict__``, and the numpy
oracle's intersections.  ``SearchEngine(use_device=False)`` of both
packages must serve flat and expression logs alike (values, algorithm and
stats).  All comparisons are exact.
"""
import math

import numpy as np
import pytest

from repro.core import baselines as jax_baselines
from repro.core import compress as jax_compress
from repro.core import intersect as jax_intersect
from repro.core import partition as jax_partition
from repro.core.hashing import default_permutation as jax_permutation
from repro.core.hashing import random_hash_family as jax_family
from repro.data import dedup as jax_dedup
from repro.exec.plan import plan_query as jax_plan_query
from repro.serve.search import SearchEngine as JaxSearchEngine

from repro_torch.core import baselines, compress, intersect, partition
from repro_torch.core.engine import EXEC_COUNTERS, make_shard_mesh
from repro_torch.core.hashing import default_permutation, random_hash_family
from repro_torch.data import dedup
from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.exec.plan import plan_query
from repro_torch.obs import reset_obs
from repro_torch.serve.search import (
    AsyncSearchEngine, SearchEngine, zipf_query_log,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset_port_obs():
    EXEC_COUNTERS.reset()
    reset_obs()
    yield


def make_sets(rng, k=2, n=2000, overlap=100, universe=1 << 24):
    common = rng.choice(universe, overlap, replace=False).astype(np.uint32)
    out = []
    for _ in range(k):
        own = rng.choice(universe, n, replace=False).astype(np.uint32)
        out.append(np.unique(np.concatenate([own, common])))
    return out


def truth_of(sets):
    out = sets[0]
    for s in sets[1:]:
        out = np.intersect1d(out, s)
    return out


def prefix_both(sets, w=256, m=2, seed=12, perm_seed=13):
    """Each package's PrefixIndexes of ``sets``, from its own code."""
    fam, perm = random_hash_family(m, w, seed=seed), \
        default_permutation(perm_seed)
    jfam, jperm = jax_family(m, w, seed=seed), jax_permutation(perm_seed)
    port = [partition.preprocess_prefix(s, w=w, m=m, family=fam, perm=perm)
            for s in sets]
    jax = [jax_partition.preprocess_prefix(s, w=w, m=m, family=jfam,
                                           perm=jperm) for s in sets]
    return port, jax


def assert_same(got, want):
    """(result, Stats) pairs equal: values and every counter."""
    assert np.array_equal(got[0], want[0])
    assert got[0].dtype == np.uint32
    assert got[1].__dict__ == want[1].__dict__


# ---------------------------------------------------------------------------
# the paper's algorithms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recovery", ["searchsorted", "inverted"])
@pytest.mark.parametrize("n,overlap", [(100, 5), (3000, 30), (5000, 2500)])
def test_intgroup_matches_jax(n, overlap, recovery):
    rng = np.random.default_rng(n)
    a, b = make_sets(rng, 2, n, overlap)
    fam, jfam = random_hash_family(1, 64, seed=11), jax_family(1, 64, seed=11)
    ia, ib = (partition.preprocess_fixed(s, w=64, family=fam) for s in (a, b))
    ja, jb = (jax_partition.preprocess_fixed(s, w=64, family=jfam)
              for s in (a, b))
    got = intersect.intgroup(ia, ib, recovery=recovery)
    assert_same(got, jax_intersect.intgroup(ja, jb, recovery=recovery))
    assert np.array_equal(got[0], truth_of([a, b]))


def test_intgroup_needs_one_hash():
    a, b = make_sets(np.random.default_rng(1), 2, 50, 5)
    ia = partition.preprocess_fixed(a, w=64, seed=1)
    ib = partition.preprocess_fixed(b, w=64, seed=2)
    with pytest.raises(ValueError, match="share h"):
        intersect.intgroup(ia, ib)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_rangroup_matches_jax(k):
    sets = make_sets(np.random.default_rng(k), k, 2000, 50)
    port, jax = prefix_both(sets)
    got = intersect.rangroup(port)
    assert_same(got, jax_intersect.rangroup(jax))
    assert np.array_equal(got[0], truth_of(sets))


@pytest.mark.parametrize("recovery", ["searchsorted", "allpairs"])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("w,m", [(64, 1), (64, 4), (256, 2), (512, 2)])
def test_rangroupscan_matches_jax(k, w, m, recovery):
    sets = make_sets(np.random.default_rng(k * w + m), k, 1500, 40)
    port, jax = prefix_both(sets, w=w, m=m, seed=w + m)
    got = intersect.rangroupscan(port, recovery=recovery)
    assert_same(got, jax_intersect.rangroupscan(jax, recovery=recovery))
    assert np.array_equal(got[0], truth_of(sets))


def test_rangroupscan_disjoint_and_skewed():
    rng = np.random.default_rng(3)
    a = np.unique(rng.choice(1 << 20, 400).astype(np.uint32))
    b = np.unique(rng.choice(1 << 20, 400).astype(np.uint32) + (1 << 21))
    c = np.unique(rng.choice(1 << 22, 30000).astype(np.uint32))
    for sets in ([a, b], [a, c], [c, a, b]):
        port, jax = prefix_both(sets)
        for recovery in ("searchsorted", "allpairs"):
            got = intersect.rangroupscan(port, recovery=recovery)
            assert_same(got, jax_intersect.rangroupscan(
                jax, recovery=recovery))
            assert np.array_equal(got[0], truth_of(sets))


@pytest.mark.parametrize("n1,n2", [(100, 50000), (1000, 1000), (17, 9999)])
def test_hashbin_matches_jax(n1, n2):
    rng = np.random.default_rng(n1 + n2)
    common = rng.choice(1 << 24, 13, replace=False).astype(np.uint32)
    a = np.unique(np.concatenate(
        [rng.choice(1 << 24, n1).astype(np.uint32), common]))
    b = np.unique(np.concatenate(
        [rng.choice(1 << 24, n2).astype(np.uint32), common]))
    (pa, pb), (ja, jb) = prefix_both([a, b])
    got = intersect.hashbin(pa, pb)
    assert_same(got, jax_intersect.hashbin(ja, jb))
    assert np.array_equal(got[0], truth_of([a, b]))
    assert got[1].comparisons <= 8 * min(n1, n2) * max(
        1, math.log2(max(n1, n2) / min(n1, n2) + 2) + 2)


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(1, 64), (500, 64), (3000, 256)])
def test_fixed_width_index_equals_jax(n, w):
    vals = np.random.default_rng(n).choice(1 << 24, n, replace=False)
    got = partition.preprocess_fixed(vals, w=w, seed=4)
    want = jax_partition.preprocess_fixed(vals, w=w, seed=4)
    for field in ("values", "padded_vals", "mask", "offsets", "lo", "hi",
                  "images", "nxt"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), \
            field
    assert (got.group_size, got.G, got.n) == (want.group_size, want.G, want.n)
    for a, b in zip(got.first_y + got.first_idx,
                    want.first_y + want.first_idx):
        assert np.array_equal(a, b)
    for z in range(got.G):
        grp = got.values[got.offsets[z]:got.offsets[z + 1]]
        assert got.lo[z] == grp[0] and got.hi[z] == grp[-1]


def test_multiresolution_equals_jax():
    vals = np.random.default_rng(6).choice(1 << 24, 1200, replace=False)
    got = partition.preprocess_multiresolution(vals, seed=2)
    want = jax_partition.preprocess_multiresolution(vals, seed=2)
    assert got.T == want.T
    assert got.storage_words() == want.storage_words()
    m = got.base.family.m
    assert got.storage_words() == got.base.n + sum(
        (1 << t) * (m + 1) for t in range(got.T + 1))
    for t in range(got.T + 1):
        a, b = got.at(t), want.at(t)
        for field in ("values", "g_keys", "offsets", "padded_keys",
                      "padded_vals", "mask", "images"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), \
                (t, field)
        direct = partition.preprocess_prefix(
            vals, t=t, family=got.base.family, perm=got.base.perm)
        assert np.array_equal(a.images, direct.images)
    with pytest.raises(ValueError):
        got.at(got.T + 1)


def test_rangroup_on_multiresolution_views():
    """RanGroup and RanGroupScan accept any resolution view (the inverted
    mappings are attached lazily per view)."""
    a, b = make_sets(np.random.default_rng(8), 2, 800, 40)
    fam, perm = random_hash_family(2, 256, seed=3), default_permutation(3)
    ma = partition.preprocess_multiresolution(a, family=fam, perm=perm)
    mb = partition.preprocess_multiresolution(b, family=fam, perm=perm)
    for ta, tb in ((ma.T, mb.T), (2, mb.T), (0, 0)):
        for algo in (intersect.rangroup, intersect.rangroupscan):
            res, _ = algo([ma.at(ta), mb.at(tb)])
            assert np.array_equal(res, truth_of([a, b])), (algo, ta, tb)


# ---------------------------------------------------------------------------
# baselines, compression, dedup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(baselines.BASELINES))
@pytest.mark.parametrize("k", [2, 3, 4])
def test_baseline_matches_jax(name, k):
    sets = make_sets(np.random.default_rng(17 * k), k, 400, 60, 1 << 22)
    res, stats = baselines.BASELINES[name](sets)
    jres, jstats = jax_baselines.BASELINES[name](sets)
    assert np.array_equal(res, jres) and res.dtype == np.uint32
    assert stats == jstats
    assert np.array_equal(res, truth_of(sets))


def test_baselines_edge_cases_match_jax():
    cases = [[np.array([1, 3, 5], np.uint32), np.array([2, 4, 6], np.uint32)],
             [np.arange(10, dtype=np.uint32)] * 2,
             [np.array([7], np.uint32), np.array([7], np.uint32)]]
    for name, fn in baselines.BASELINES.items():
        for sets in cases:
            res, stats = fn(sets)
            jres, jstats = jax_baselines.BASELINES[name](sets)
            assert np.array_equal(np.asarray(res, np.uint32), jres), name
            assert stats == jstats, name
            assert np.array_equal(res, truth_of(sets)), name


@pytest.mark.parametrize("name", ["beta", "gamma"])
def test_lowbits_matches_jax(name):
    rng = np.random.default_rng(5)
    n = {"beta": 9000, "gamma": 2500}[name]
    vals = np.unique(rng.choice(1 << 24, n, replace=False).astype(np.uint32))
    (idx,), (jidx,) = prefix_both([vals], seed=5, perm_seed=5)
    c, jc = compress.compress_lowbits(idx), jax_compress.compress_lowbits(jidx)
    for field in ("counts", "offsets", "lowbits", "images", "nonempty_map"):
        assert np.array_equal(getattr(c, field), getattr(jc, field)), field
    assert c.lowbits_dtype == jc.lowbits_dtype
    assert c.storage_bits() == jc.storage_bits()
    recon = np.concatenate([compress.decompress_group(c, z)
                            for z in range(1 << idx.t)])
    assert np.array_equal(recon, idx.g_keys)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elias_codes_match_jax(seed):
    rng = np.random.default_rng(seed)
    arr = np.unique(rng.choice(1 << 28, 300, replace=False)).astype(np.uint32)
    for enc, dec, jenc in (
            (compress.gamma_encode, compress.gamma_decode,
             jax_compress.gamma_encode),
            (compress.delta_encode, compress.delta_decode,
             jax_compress.delta_encode)):
        bits, n = enc(arr)
        jbits, jn = jenc(arr)
        assert n == jn and np.array_equal(bits, jbits)
        assert np.array_equal(dec(bits, n), arr)


def test_space_report_matches_jax():
    vals = np.unique(np.random.default_rng(11).choice(
        1 << 26, 60000, replace=False).astype(np.uint32))
    idx = partition.preprocess_prefix(vals, w=64, m=2)
    jidx = jax_partition.preprocess_prefix(vals, w=64, m=2)
    rep = compress.space_report(idx)
    assert rep == jax_compress.space_report(jidx)
    overhead = rep["rangroupscan_uncompressed"] / rep["plain_inverted"] - 1
    assert 0.25 < overhead < 0.55  # the paper's 37% for m = 2
    assert rep["merge_delta"] < rep["plain_inverted"]


def test_dedup_matches_jax():
    rng = np.random.default_rng(9)
    base = rng.integers(0, 5000, 400)
    docs = {0: base, 1: base.copy(), 2: np.concatenate([base[:300],
                                                         rng.integers(0, 5000,
                                                                      100)]),
            3: rng.integers(0, 5000, 400), 4: rng.integers(0, 5000, 3)}
    got, want = dedup.Deduplicator(seed=1), jax_dedup.Deduplicator(seed=1)
    for doc_id, tokens in docs.items():
        assert np.array_equal(dedup.shingles(tokens),
                              jax_dedup.shingles(tokens))
        got.add(doc_id, tokens)
        want.add(doc_id, tokens)
    assert got.overlap(0, 2) == want.overlap(0, 2)
    pairs = got.near_dups(threshold=0.3)
    assert pairs == want.near_dups(threshold=0.3)
    assert (0, 1, 1.0) in pairs and any(p[:2] == (0, 2) for p in pairs)


# ---------------------------------------------------------------------------
# the host route of the search engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def postings():
    return inverted_index(zipf_corpus(3000, vocab=400, mean_len=40, seed=3))


def _mixed_log(terms, n=40):
    log = zipf_query_log(terms, n, seed=11)
    t = [str(x) for x in terms[:8]]
    log += [f"({t[0]}|{t[1]})&{t[2]}", f"({t[3]}&{t[4]})-{t[5]}",
            f"{t[6]}|{t[7]}", f"{t[0]}&{t[1]}", [terms[0], terms[0]],
            [terms[-1], 10 ** 6], []]
    return log


@pytest.mark.parametrize("ratio", [100.0, 30.0])
def test_plan_query_host_arm_matches_jax(postings, ratio):
    eng = SearchEngine(postings, seed=3, use_device=False)
    for q in _mixed_log(sorted(eng.index)):
        got = plan_query(eng.index, q, hashbin_ratio=ratio, device=False)
        want = jax_plan_query(eng.index, q, hashbin_ratio=ratio,
                              device=False)
        assert (got.terms, got.algorithm, got.sig) == \
            (want.terms, want.algorithm, want.sig), q
        assert got.cache_key() == want.cache_key()
        assert got.algorithm in ("host", "hashbin", "empty")


@pytest.mark.parametrize("cache", [0, 64])
def test_host_search_engine_matches_jax(postings, cache):
    eng = SearchEngine(postings, seed=3, use_device=False, result_cache=cache,
                       hashbin_ratio=30.0)
    jeng = JaxSearchEngine(postings, seed=3, use_device=False,
                           result_cache=cache, hashbin_ratio=30.0)
    assert eng.device is None and jeng.device is None
    log = _mixed_log(sorted(eng.index))
    for _ in range(2):  # the second pass hits the cache when it is on
        got, want = eng.query_batch(log), jeng.query_batch(log)
        for q, r, j in zip(log, got, want):
            assert np.array_equal(r.doc_ids, j.doc_ids), q
            assert r.algorithm == j.algorithm, q
            assert r.stats == j.stats, q
    algos = {r.algorithm for r in got}
    if cache:
        assert algos <= {"rangroupscan", "hashbin", "expr/host", "empty",
                         "expr/subcache"} and algos != {"empty"}
    else:
        assert {"rangroupscan", "hashbin", "expr/host", "empty"} <= algos
    assert EXEC_COUNTERS["batch_calls"] == 0  # no device work at all


def test_host_results_equal_device_results(postings):
    host = SearchEngine(postings, seed=3, use_device=False)
    dev = SearchEngine(postings, seed=3, device=CPU)
    log = _mixed_log(sorted(host.index))
    for q, h, d in zip(log, host.query_batch(log), dev.query_batch(log)):
        assert np.array_equal(h.doc_ids, d.doc_ids), q
        if h.algorithm == "rangroupscan":
            assert d.algorithm == "rangroupscan/device"
            assert (h.stats["r"], h.stats["tuples_survived"]) == \
                (d.stats["r"], d.stats["tuples_survived"])


def test_host_engine_mutation_and_guards(postings):
    eng = SearchEngine(postings, seed=3, use_device=False, result_cache=16)
    terms = sorted(eng.index)
    q = [terms[0], terms[1]]
    before = eng.query(q)
    gen = eng.cache.generation
    eng.add_postings(terms[1], np.asarray(postings[terms[0]]))
    assert eng.cache.generation == gen + 1
    after = eng.query(q)
    assert after.algorithm == "rangroupscan" and not after.stats.get("cached")
    assert np.array_equal(after.doc_ids, np.sort(postings[terms[0]]))
    assert not np.array_equal(before.doc_ids, after.doc_ids)
    with pytest.raises(ValueError, match="device"):
        eng.warm([q])
    meshed = SearchEngine(postings, seed=3, use_device=False, device=CPU,
                          mesh=make_shard_mesh(2, devices=[CPU] * 2))
    assert meshed.use_device and meshed.device is not None


def test_host_async_engine_resolves_at_submit(postings):
    eng = AsyncSearchEngine(postings, seed=3, use_device=False,
                            result_cache=0)
    log = _mixed_log(sorted(eng.index), n=12)
    tickets = [eng.submit(q) for q in log]
    assert all(t.done for t in tickets) and eng.pending() == 0
    want = SearchEngine(postings, seed=3, use_device=False).query_batch(log)
    for t, w in zip(tickets, want):
        assert np.array_equal(t.value.doc_ids, w.doc_ids)
        assert t.value.algorithm == w.algorithm
    with eng:  # a flusher with no device runs and stops cleanly
        assert eng.submit(log[0]).done
    assert EXEC_COUNTERS["tickets_resolved"] == len(log) + 1


def test_quickstart_all_algorithms_match_the_oracle():
    """``examples/quickstart.py``'s check on the port: every algorithm and
    baseline equals ``np.intersect1d`` on the example's sets, and the
    compression round-trips."""
    rng = np.random.default_rng(0)
    universe = 1 << 26
    common = rng.choice(universe, 500, replace=False).astype(np.uint32)
    a = np.unique(np.concatenate(
        [rng.choice(universe, 40000).astype(np.uint32), common]))
    b = np.unique(np.concatenate(
        [rng.choice(universe, 90000).astype(np.uint32), common]))
    truth = np.intersect1d(a, b)
    fam = random_hash_family(m=2, w=256, seed=1)
    perm = default_permutation(seed=1)
    ia, ib = (partition.preprocess_prefix(s, w=256, m=2, family=fam,
                                          perm=perm) for s in (a, b))
    for recovery in ("searchsorted", "allpairs"):
        assert np.array_equal(
            intersect.rangroupscan([ia, ib], recovery=recovery)[0], truth)
    assert np.array_equal(intersect.rangroup([ia, ib])[0], truth)
    assert np.array_equal(intersect.hashbin(ia, ib)[0], truth)
    f64 = random_hash_family(m=1, w=64, seed=2)
    fa, fb = (partition.preprocess_fixed(s, w=64, family=f64)
              for s in (a, b))
    for recovery in ("searchsorted", "inverted"):
        assert np.array_equal(
            intersect.intgroup(fa, fb, recovery=recovery)[0], truth)
    for name, fn in baselines.BASELINES.items():
        assert np.array_equal(fn([a, b])[0], truth), name
    c = compress.compress_lowbits(ib)
    assert np.array_equal(np.concatenate(
        [compress.decompress_group(c, z) for z in range(1 << ib.t)]),
        ib.g_keys)
    for enc, dec in ((compress.gamma_encode, compress.gamma_decode),
                     (compress.delta_encode, compress.delta_decode)):
        assert np.array_equal(dec(*enc(truth)), truth)
