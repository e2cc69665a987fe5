"""The port's host stage and device engine against the JAX package, on the
CPU: the same seeded numpy inputs go through both, and every output must be
equal (tolerance 0 — all outputs are integers or bools).

Covers hashing, images, preprocessing (byte for byte), the index carried
across with ``prefix_index_from_arrays``, ``DeviceSet`` mirrors,
``intersect_device_batch`` results and stats (forced overflow included, with
its ``batch_calls`` / ``rerun_calls``), ``BatchedEngine.query_many`` and
``hashbin``.
"""
import numpy as np
import pytest
import torch

from repro.core import bitmaps as jbitmaps
from repro.core import hashing as jhashing
from repro.core import partition as jpartition
from repro.core.engine import (
    EXEC_COUNTERS as JAX_COUNTERS, BatchedEngine as JaxBatchedEngine,
    DeviceSet as JaxDeviceSet, default_capacity as jax_default_capacity,
    gmax_tier as jax_gmax_tier, intersect_device as jax_intersect_device,
    intersect_device_batch as jax_intersect_device_batch,
)
from repro.core.intersect import hashbin as jax_hashbin
from repro.exec.plan import plan_query as jax_plan_query

from repro_torch.core import bitmaps, hashing, partition
from repro_torch.core.engine import (
    EXEC_COUNTERS, BatchedEngine, DeviceSet, default_capacity, gmax_tier,
    intersect_device, intersect_device_batch, set_sort_key,
)
from repro_torch.core.intersect import hashbin
from repro_torch.data import pipeline
from repro_torch.exec.plan import plan_query

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset_port_counters():
    EXEC_COUNTERS.reset()
    yield


def carry(idx):
    """A JAX-package PrefixIndex carried into the port as plain arrays."""
    return partition.prefix_index_from_arrays(
        values=idx.values, g_keys=idx.g_keys, t=idx.t, offsets=idx.offsets,
        padded_keys=idx.padded_keys, padded_vals=idx.padded_vals,
        mask=idx.mask, gmax=idx.gmax, images=idx.images, w=idx.w,
        family_a=idx.family.a, family_b=idx.family.b,
        perm_mults=idx.perm.mults, perm_shifts=idx.perm.shifts)


INDEX_FIELDS = ("values", "g_keys", "offsets", "padded_keys", "padded_vals",
                "mask", "images")


def assert_same_index(a, b):
    for name in INDEX_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (a.t, a.gmax, a.w, a.n) == (b.t, b.gmax, b.w, b.n)
    assert np.array_equal(a.family.a, b.family.a)
    assert np.array_equal(a.family.b, b.family.b)
    assert (a.perm.mults, a.perm.shifts) == (b.perm.mults, b.perm.shifts)


@pytest.fixture(scope="module")
def corpus():
    """The tests/test_exec_batch.py corpus: assorted (t, gmax) shapes."""
    rng = np.random.default_rng(7)
    fam = jhashing.random_hash_family(2, 256, seed=7)
    perm = jhashing.default_permutation(7)
    common = rng.choice(1 << 24, 80, replace=False).astype(np.uint32)
    raw, jidx = {}, {}
    for name, n in [("a", 900), ("b", 1100), ("c", 4000),
                    ("d", 4300), ("e", 9000)]:
        s = np.unique(np.concatenate(
            [rng.choice(1 << 24, n, replace=False).astype(np.uint32), common]))
        raw[name] = s
        jidx[name] = jpartition.preprocess_prefix(s, w=256, m=2, family=fam,
                                                  perm=perm)
    tidx = {k: carry(v) for k, v in jidx.items()}
    return raw, jidx, tidx


MIXED_QUERIES = [
    ["a", "b"], ["c", "d"], ["a", "e"], ["a", "b", "c"],
    ["c", "d", "e"], ["b", "a"], ["a", "b", "c", "d"], ["e", "c", "d"],
    ["a"], ["a", "a", "b"],
]
STAT_KEYS = ("r", "tuples_survived", "capacity", "group_tuples", "batch_size")


def truth_of(sets):
    out = sets[0]
    for s in sets[1:]:
        out = np.intersect1d(out, s)
    return out


def assert_same_results(port, ref):
    assert len(port) == len(ref)
    for (pv, ps), (jv, js) in zip(port, ref):
        assert pv.dtype == np.uint32
        assert np.array_equal(pv, np.asarray(jv))
        for key in STAT_KEYS:
            assert ps[key] == js[key], key


# -- host stage -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("m,w", [(1, 64), (2, 256), (3, 128)])
def test_hashing_matches(seed, m, w):
    jf, tf = jhashing.random_hash_family(m, w, seed), \
        hashing.random_hash_family(m, w, seed)
    assert np.array_equal(jf.a, tf.a) and np.array_equal(jf.b, tf.b)
    jp, tp = jhashing.default_permutation(seed), hashing.default_permutation(seed)
    assert (jp.mults, jp.shifts) == (tp.mults, tp.shifts)
    x = np.random.default_rng(seed).integers(
        0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(jf.apply_all(x), tf.apply_all(x))
    assert np.array_equal(jf.apply(x, m - 1), tf.apply(x, m - 1))
    assert np.array_equal(jp.forward(x), tp.forward(x))
    assert np.array_equal(tp.inverse(tp.forward(x)), x)
    assert np.array_equal(jp.prefix(x, 7), tp.prefix(x, 7))


@pytest.mark.parametrize("w", [64, 256, 512])
def test_bitmaps_match(w):
    rng = np.random.default_rng(w)
    hashes = rng.integers(0, w, size=(50, 16, 2)).astype(np.uint32)
    valid = rng.random((50, 16)) < 0.7
    a = jbitmaps.build_images_chunked(hashes, valid, w, chunk=7)
    b = bitmaps.build_images_chunked(hashes, valid, w, chunk=7)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jbitmaps.popcount32(a), bitmaps.popcount32(b))
    assert np.array_equal(jbitmaps.any_nonzero(a), bitmaps.any_nonzero(b))
    assert np.array_equal(jbitmaps.bits_to_values(a[3, 1], w),
                          bitmaps.bits_to_values(b[3, 1], w))


@pytest.mark.parametrize("n,w,m,t,gmax", [
    (1, 256, 2, None, None), (900, 256, 2, None, None),
    (9000, 256, 2, None, None), (5000, 64, 3, None, None),
    (3000, 256, 2, 4, None), (2000, 256, 1, None, 64), (0, 256, 2, None, None),
])
def test_preprocess_prefix_byte_identical(n, w, m, t, gmax):
    vals = np.random.default_rng(n + w).choice(1 << 26, n, replace=False)
    a = jpartition.preprocess_prefix(vals, w=w, m=m, t=t, seed=5, gmax=gmax)
    b = partition.preprocess_prefix(vals, w=w, m=m, t=t, seed=5, gmax=gmax)
    assert_same_index(a, b)
    assert a.storage_words() == b.storage_words()


def test_carried_index_equals_port_build(corpus):
    raw, jidx, tidx = corpus
    fam = hashing.random_hash_family(2, 256, seed=7)
    perm = hashing.default_permutation(7)
    for name, s in raw.items():
        own = partition.preprocess_prefix(s, w=256, m=2, family=fam, perm=perm)
        assert_same_index(tidx[name], own)
        assert_same_index(tidx[name], jidx[name])


def test_prefix_index_from_arrays_rejects_bad_shapes(corpus):
    _, jidx, _ = corpus
    a = jidx["a"]
    with pytest.raises(ValueError):
        partition.prefix_index_from_arrays(
            values=a.values, g_keys=a.g_keys, t=a.t + 1, offsets=a.offsets,
            padded_keys=a.padded_keys, padded_vals=a.padded_vals, mask=a.mask,
            gmax=a.gmax, images=a.images, w=a.w, family_a=a.family.a,
            family_b=a.family.b, perm_mults=a.perm.mults,
            perm_shifts=a.perm.shifts)


@pytest.mark.parametrize("n", [0, 1, 2, 17, 100, 4096, 10 ** 6, 10 ** 7])
@pytest.mark.parametrize("w", [64, 256])
def test_shape_helpers_match(n, w):
    assert partition.choose_t(n, w) == jpartition.choose_t(n, w)
    g = max(1, n % 300)
    assert gmax_tier(g) == jax_gmax_tier(g)
    ts = (partition.choose_t(n, w),)
    assert default_capacity(ts) == jax_default_capacity(ts)


def test_zipf_corpus_matches():
    from repro.data.pipeline import inverted_index as jinv, zipf_corpus as jz

    a = jz(200, vocab=300, mean_len=20, seed=4)
    b = pipeline.zipf_corpus(200, vocab=300, mean_len=20, seed=4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    ja, tb = jinv(a), pipeline.inverted_index(b)
    assert list(ja) == list(tb)
    assert all(np.array_equal(ja[t], tb[t]) for t in ja)


@pytest.mark.parametrize("pair", [("a", "e"), ("b", "c"), ("e", "a"),
                                  ("d", "d")])
def test_hashbin_matches(corpus, pair):
    _, jidx, tidx = corpus
    jr, js = jax_hashbin(jidx[pair[0]], jidx[pair[1]])
    tr, ts_ = hashbin(tidx[pair[0]], tidx[pair[1]])
    assert np.array_equal(jr, tr)
    assert js.__dict__ == ts_.__dict__


# -- device engine on the CPU -----------------------------------------------

def test_device_set_mirror_matches(corpus):
    _, jidx, tidx = corpus
    for name in jidx:
        j = JaxDeviceSet.from_host(jidx[name])
        t = DeviceSet.from_host(tidx[name], device=CPU)
        assert (j.t, j.gmax, j.m, j.w, j.n) == (t.t, t.gmax, t.m, t.w, t.n)
        assert t.vals.dtype == torch.int32 and t.images.dtype == torch.int32
        assert np.array_equal(np.asarray(j.vals), t.vals.numpy())
        assert np.array_equal(np.asarray(j.images).view(np.int32),
                              t.images.numpy())
        assert t.device == torch.device(CPU)


def test_planner_matches(corpus):
    _, jidx, tidx = corpus
    for q in MIXED_QUERIES + [["a", "zz"], [], ["e", "a"]]:
        for ratio in (100.0, 2.0):
            jp = jax_plan_query(jidx, q, hashbin_ratio=ratio)
            tp = plan_query(tidx, q, hashbin_ratio=ratio)
            assert (jp.terms, jp.algorithm) == (tp.terms, tp.algorithm)
            assert jp.cache_key() == tp.cache_key()
            if tp.sig is not None:
                assert (jp.sig.k, jp.sig.ts, jp.sig.gmaxes,
                        jp.sig.capacity_tier) == (tp.sig.k, tp.sig.ts,
                                                  tp.sig.gmaxes,
                                                  tp.sig.capacity_tier)


@pytest.mark.parametrize("queries", [
    [["a", "b"]], [["a", "b"], ["b", "a"]], [["c", "d"], ["d", "c"]],
    [["a", "b", "c"]], [["a", "e"]], [["a", "b", "c", "d"]],
    [["c", "d", "e"], ["e", "c", "d"]], [["a"]], [["e"]],
], ids=lambda q: "|".join("".join(x) for x in q))
@pytest.mark.parametrize("capacity", [None, 4, 1 << 12])
def test_intersect_device_batch_matches(corpus, queries, capacity):
    raw, jidx, tidx = corpus
    jsets = {k: JaxDeviceSet.from_host(v) for k, v in jidx.items()}
    tsets = {k: DeviceSet.from_host(v, device=CPU) for k, v in tidx.items()}
    JAX_COUNTERS.reset()
    ref = jax_intersect_device_batch([[jsets[n] for n in q] for q in queries],
                                     capacity=capacity, use_pallas=False)
    port = intersect_device_batch([[tsets[n] for n in q] for q in queries],
                                  capacity=capacity, device=CPU)
    assert_same_results(port, ref)
    for q, (values, _) in zip(queries, port):
        assert np.array_equal(values, truth_of([raw[n] for n in q]))
    for key in ("batch_calls", "rerun_calls"):
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key


def test_forced_overflow_reruns_once(corpus):
    raw, jidx, tidx = corpus
    jsets = {k: JaxDeviceSet.from_host(v) for k, v in jidx.items()}
    tsets = {k: DeviceSet.from_host(v, device=CPU) for k, v in tidx.items()}
    JAX_COUNTERS.reset()
    ref = jax_intersect_device_batch(
        [[jsets["a"], jsets["b"]], [jsets["b"], jsets["a"]]], capacity=4,
        use_pallas=False)
    port = intersect_device_batch(
        [[tsets["a"], tsets["b"]], [tsets["b"], tsets["a"]]], capacity=4,
        device=CPU)
    assert_same_results(port, ref)
    for _, stats in port:
        assert stats["capacity"] > 4  # re-run at full capacity G
    assert EXEC_COUNTERS["rerun_calls"] == JAX_COUNTERS["rerun_calls"] == 1
    assert EXEC_COUNTERS["batch_calls"] == JAX_COUNTERS["batch_calls"] == 2


def test_intersect_device_single_matches(corpus):
    _, jidx, tidx = corpus
    names = ["c", "a", "d"]
    jv, js = jax_intersect_device([JaxDeviceSet.from_host(jidx[n]) for n in names],
                                  use_pallas=False)
    tv, ts_ = intersect_device([DeviceSet.from_host(tidx[n], device=CPU)
                                for n in names], device=CPU)
    assert_same_results([(tv, ts_)], [(jv, js)])


def test_mixed_signature_and_device_rejected(corpus):
    _, _, tidx = corpus
    tsets = {k: DeviceSet.from_host(v, device=CPU) for k, v in tidx.items()}
    with pytest.raises(ValueError):
        intersect_device_batch([[tsets["a"], tsets["b"]],
                                [tsets["a"], tsets["e"]]], device=CPU)
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else ValueError):
        intersect_device_batch([[tsets["a"], tsets["b"]]], device="cuda")


def test_entry_points_default_to_cuda(corpus, monkeypatch):
    """No silent CPU fallback: asking for the default device without a GPU
    raises."""
    _, _, tidx = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DeviceSet.from_host(tidx["a"])
    with pytest.raises(RuntimeError):
        BatchedEngine()
    tset = DeviceSet.from_host(tidx["a"], device=CPU)
    with pytest.raises(RuntimeError):
        intersect_device([tset, tset])


def test_pending_batch_ready_and_memoized(corpus):
    from repro_torch.core.engine import dispatch_device_batch

    _, _, tidx = corpus
    tsets = {k: DeviceSet.from_host(v, device=CPU) for k, v in tidx.items()}
    pending = dispatch_device_batch([[tsets["a"], tsets["c"]]], device=CPU)
    assert pending.is_ready()
    first = pending.collect()
    assert pending.collect() is first
    assert EXEC_COUNTERS["batch_calls"] == 1 + EXEC_COUNTERS["rerun_calls"]


def test_set_sort_key_orders_like_jax(corpus):
    _, jidx, tidx = corpus
    order = sorted(tidx, key=lambda n: set_sort_key(tidx[n]))
    assert order == sorted(jidx, key=lambda n: (jidx[n].t, jidx[n].n))


def test_query_many_matches_jax(corpus):
    raw, jidx, tidx = corpus
    jeng = JaxBatchedEngine(use_pallas=False)
    teng = BatchedEngine(device=CPU)
    for k in jidx:
        jeng.add(k, jidx[k])
        teng.add(k, tidx[k])
    JAX_COUNTERS.reset()
    ref = jeng.query_many(MIXED_QUERIES)
    port = teng.query_many(MIXED_QUERIES)
    assert_same_results(port, ref)
    for q, (values, _) in zip(MIXED_QUERIES, port):
        assert np.array_equal(values, truth_of([raw[n] for n in set(q)]))
    for key in ("batch_calls", "rerun_calls", "inflight_dispatches",
                "inflight_collects"):
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key
    with pytest.raises(KeyError):
        teng.query_many([["a", "zz"]])
