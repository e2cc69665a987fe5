"""The benchmark's inputs: the same seed gives the same lists and queries;
every seed gets the same sizes and query pool; the k mix and the
popularity law hold after the distinct-term draw."""
import collections

import numpy as np
import pytest

from bench import data

TERMS = {"generator": "independent_terms", "universe_bits": 25,
         "lengths": [64, 300, 1000, 5000]}
PLANTED = {"generator": "planted_sets", "universe_bits": 31, "n_sets": 4,
           "n": 3000, "planted": 30}
MIX = {"kw_dist": [[2, 0.68], [3, 0.23], [4, 0.09]],
       "popularity": {"law": "zipf", "s": 1.0},
       "pool_size": 4000, "pool_seed": 7}


@pytest.mark.parametrize("config", [TERMS, PLANTED], ids=["terms", "planted"])
def test_postings_same_seed_same_lists(config):
    a = data.make_postings(config, 2 ** 31 + 12345, device="cpu")
    b = data.make_postings(config, 2 ** 31 + 12345, device="cpu")
    c = data.make_postings(config, 2 ** 31 + 12346, device="cpu")
    assert a.keys() == b.keys() == c.keys()
    for t in a:
        assert np.array_equal(a[t], b[t])
        assert a[t].dtype == np.uint32
    assert any(not np.array_equal(a[t], c[t]) for t in a)


@pytest.mark.parametrize("config", [TERMS, PLANTED], ids=["terms", "planted"])
def test_postings_sizes_are_the_configs(config):
    got = data.make_postings(config, 3, device="cpu")
    lengths = data.term_lengths(config)
    for t, v in got.items():
        assert len(v) == lengths[t]
        assert np.all(np.diff(v.astype(np.int64)) > 0)
        assert int(v.max()) < 1 << config["universe_bits"]


def test_planted_ids_are_in_every_set():
    got = data.make_postings(PLANTED, 11, device="cpu")
    common = got[0]
    for t in range(1, PLANTED["n_sets"]):
        common = np.intersect1d(common, got[t])
    assert len(common) >= PLANTED["planted"]


def test_pool_is_the_same_for_every_seed_and_keeps_k():
    pool = data.query_pool(MIX, 32)
    assert pool == data.query_pool(MIX, 32)
    counts = collections.Counter(len(q) for q in pool)
    for k, p in MIX["kw_dist"]:
        assert abs(counts[k] / len(pool) - p) < 0.03
    assert all(len(set(q)) == len(q) and list(q) == sorted(q) for q in pool)


def test_zipf_popularity_is_by_rank():
    pool = data.query_pool(MIX, 32)
    hits = collections.Counter(t for q in pool for t in q)
    assert hits[0] > hits[1] > hits[8] > hits[31]


def test_k_holds_with_fewer_terms_than_the_tail():
    pool = data.query_pool(dict(MIX, popularity={"law": "uniform"}), 4)
    assert collections.Counter(len(q) for q in pool)[4] > 0
    assert all(len(set(q)) == len(q) for q in pool)


def test_pool_order_is_seeded_and_covers_the_pool():
    pool = data.query_pool(dict(MIX, pool_size=50), 32)
    a = [next(it) for it in [data.pool_order(pool, 5)] for _ in range(100)]
    b = [next(it) for it in [data.pool_order(pool, 5)] for _ in range(100)]
    c = [next(it) for it in [data.pool_order(pool, 6)] for _ in range(100)]
    assert a == b and a != c
    assert sorted(a[:50]) == sorted(pool) == sorted(a[50:])
