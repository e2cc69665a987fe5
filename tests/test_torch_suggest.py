"""The port's count-only suggestion path against the JAX package's, on the
CPU, tolerance 0 everywhere (every output is an integer).

The same seeded numpy inputs go through both packages: ``pair_count_ref``
(against the jnp reference and the Pallas kernel in interpret mode),
``count_block_ref`` against ``_count_block`` in all three alignment
directions, the composite-key top-K against ``lax.top_k``,
``intersect_count_batch`` (duplicate-candidate tie and padded slot
included), ``default_k_tier``, ``plan_suggest``, ``CandidateIndex``, the
RSI1 ingest format, and ``SuggestEngine`` end to end (device path on the
CPU, host path, result cache, mutation, bucket sharing).  The CUDA kernel
itself is held against ``count_block_ref`` on the card by ``chip_smoke.py``.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rows import padded_rows
from repro.core import hashing as jhashing
from repro.core import partition as jpartition
from repro.core.engine import (
    EXEC_COUNTERS as JAX_COUNTERS, DeviceSet as JaxDeviceSet,
    _count_block as jax_count_block, default_k_tier as jax_default_k_tier,
    intersect_count_batch as jax_intersect_count_batch,
)
from repro.data import ingest as jingest
from repro.exec.candidates import CandidateIndex as JaxCandidateIndex
from repro.exec.plan import plan_suggest as jax_plan_suggest
from repro.kernels.count import pair_count_pallas
from repro.kernels.count import pair_count_ref as jax_pair_count_ref
from repro.serve.search import SuggestEngine as JaxSuggestEngine

from repro_torch.core import hashing, partition
from repro_torch.core.engine import (
    EXEC_COUNTERS, DeviceSet, _top_k_slots, default_k_tier,
    intersect_count_batch,
)
from repro_torch.data import ingest
from repro_torch.exec.candidates import CandidateIndex
from repro_torch.exec.plan import plan_suggest
from repro_torch.kernels import ops, ref
from repro_torch.kernels.count import count_block_cuda, make_count_table
from repro_torch.serve.search import SuggestEngine

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


def oracle_topk(corpus, sid, k):
    pairs = []
    for c in sorted(corpus):
        if c == sid:
            continue
        n = len(np.intersect1d(np.unique(corpus[sid]), np.unique(corpus[c])))
        if n >= 1:
            pairs.append((c, n))
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return pairs[:k]


# -- pair_count_ref ---------------------------------------------------------

@pytest.mark.parametrize("s,ga,gb", [(1, 1, 1), (3, 4, 8), (8, 16, 4),
                                     (13, 7, 31)])
def test_pair_count_ref_matches_jax(s, ga, gb):
    """The rows of ``test_pair_count_matches_numpy``: duplicate-free, a
    forced overlap, random sentinel padding in A."""
    rng = np.random.default_rng(s * 100 + ga)
    a = np.empty((s, ga), np.int32)
    b = np.empty((s, gb), np.int32)
    for i in range(s):
        pool = rng.permutation(200).astype(np.int32)
        a[i] = pool[:ga]
        take = int(rng.integers(0, min(ga, gb) + 1))
        b[i] = np.concatenate([rng.permutation(a[i])[:take],
                               pool[ga:ga + gb - take]])
        n_pad = int(rng.integers(0, ga))
        if n_pad:
            a[i, ga - n_pad:] = -1
    want = np.array([len(np.intersect1d(a[i][a[i] != -1], b[i]))
                     for i in range(s)], np.int32)
    got = ref.pair_count_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_pair_count_ref(a, b)))
    np.testing.assert_array_equal(
        got, np.asarray(pair_count_pallas(a, b, interpret=True)))


@pytest.mark.parametrize("kind_a,kind_b", [
    ("left", "left"), ("full", "full"), ("pad", "full"), ("full", "pad"),
    ("interior", "interior")])
@pytest.mark.parametrize("ga,gb", [(1, 3), (3, 33), (33, 1)])
def test_pair_count_ref_padding_layouts(kind_a, kind_b, ga, gb):
    """The contract the CUDA kernel keeps whatever the rows' layout: an A
    element counts once if it is real and occurs in its B row, however
    often; -1 wherever it lies counts nothing; odd widths."""
    rng = np.random.default_rng(ga * 100 + gb)
    a = padded_rows(rng, kind_a, (17, ga))
    b = padded_rows(rng, kind_b, (17, gb))
    want = np.array([sum(v != -1 and v in set(b[s]) for v in a[s])
                     for s in range(len(a))], np.int32)
    got = ref.pair_count_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_pair_count_ref(a, b)))
    np.testing.assert_array_equal(
        got, np.asarray(pair_count_pallas(a, b, interpret=True)))


def test_pair_count_ref_empty_disjoint_identical():
    pad = np.full((4, 8), -1, np.int32)
    live = np.arange(32, dtype=np.int32).reshape(4, 8)
    for a, b, want in ((pad, live, 0), (live, live + 1000, 0),
                       (live, live, 8), (pad, pad, 0)):
        got = ref.pair_count_ref(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), np.full(4, want, np.int32))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_pair_count_ref(a, b)))


def test_pair_count_ref_leading_axes():
    rng = np.random.default_rng(5)
    a = rng.permutation(200)[:96].astype(np.int32).reshape(2, 3, 4, 4)
    b = rng.permutation(200)[:48].astype(np.int32).reshape(2, 3, 4, 2)
    got = ref.pair_count_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2, 3, 4)
    np.testing.assert_array_equal(got, np.asarray(jax_pair_count_ref(a, b)))


# -- count_block_ref and the packed table -------------------------------------

def random_mirrors(rng, n, t, g, hi=300):
    x = rng.integers(0, hi, size=(n, 1 << t, g)).astype(np.int32)
    x[rng.random(x.shape) < 0.3] = -1
    return x


@pytest.mark.parametrize("tp,tc", [(4, 2), (3, 3), (1, 4)])
@pytest.mark.parametrize("gp,gc", [(8, 16), (16, 8)])
def test_count_block_ref_matches_jax(tp, tc, gp, gc):
    """(B, Gp, gp) probes x (B, C, Gc, gc) candidates, as ``_count_block``
    takes them: the port's plain version, its table route and the JAX
    function with the jnp path and with Pallas in interpret mode."""
    rng = np.random.default_rng(tp * 10 + tc + gp)
    B, C = 3, 5
    pv = random_mirrors(rng, B, tp, gp)
    cv = random_mirrors(rng, B * C, tc, gc).reshape(B, C, 1 << tc, gc)
    want = np.asarray(jax_count_block(jnp.asarray(pv), jnp.asarray(cv),
                                      (tp, tc), False))
    np.testing.assert_array_equal(want, np.asarray(jax_count_block(
        jnp.asarray(pv), jnp.asarray(cv), (tp, tc), True)))
    probes = [torch.from_numpy(p) for p in pv]
    cands = [[torch.from_numpy(c) for c in row] for row in cv]
    got = ref.count_block_ref(probes, cands, (tp, tc))
    assert got.dtype == torch.int32 and got.shape == (B, C)
    np.testing.assert_array_equal(got.numpy(), want)
    table = make_count_table(probes, cands, (tp, tc))
    np.testing.assert_array_equal(ops.count_block(table).numpy(), want)


def test_count_block_ref_chunks_and_pads(monkeypatch):
    """Rows of unequal length padded to c_tier count 0 past their end, and
    chunking the candidate axis changes nothing."""
    rng = np.random.default_rng(3)
    pv = random_mirrors(rng, 2, 3, 8)
    pool = random_mirrors(rng, 6, 2, 8)
    probes = [torch.from_numpy(p) for p in pv]
    cands = [[torch.from_numpy(c) for c in pool[:5]],
             [torch.from_numpy(c) for c in pool[2:4]]]
    whole = ref.count_block_ref(probes, cands, (3, 2), c_tier=8)
    monkeypatch.setattr(ref, "COUNT_CHUNK_BYTES", 1)
    chunked = ref.count_block_ref(probes, cands, (3, 2), c_tier=8)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    assert whole.shape == (2, 8)
    assert not whole[0, 5:].any() and not whole[1, 2:].any()
    for b, row in enumerate(cands):
        stacked = np.stack([c.numpy() for c in row])[None]
        want = np.asarray(jax_count_block(jnp.asarray(pv[b:b + 1]),
                                          jnp.asarray(stacked), (3, 2), False))
        np.testing.assert_array_equal(whole[b, :len(row)].numpy(), want[0])


def test_count_table_layout_and_checks():
    rng = np.random.default_rng(4)
    p = torch.from_numpy(random_mirrors(rng, 1, 3, 8)[0])
    c = [torch.from_numpy(x) for x in random_mirrors(rng, 3, 2, 16)]
    table = make_count_table([p, p], [c, c[:1]], (3, 2), c_tier=4)
    assert table.c_tier == 4 and table.ptrs.dtype == torch.int64
    assert table.ptrs[0].tolist() == \
        [p.data_ptr()] + [x.data_ptr() for x in c] + [0]
    assert table.real.tolist() == [[True, True, True, False],
                                   [True, False, False, False]]
    with pytest.raises(ValueError):
        make_count_table([p], [c], (3, 2), c_tier=2)        # c_tier < row
    with pytest.raises(ValueError):
        make_count_table([p], [[c[0].to(torch.int64)]], (3, 2))
    with pytest.raises(ValueError):
        make_count_table([p], [[p]], (3, 2))                 # wrong shape
    with pytest.raises(ValueError):
        make_count_table([p], [[]], (3, 2))                  # empty row
    with pytest.raises(ValueError):
        count_block_cuda(table)                              # CPU table
    launches = count_block_cuda.launches
    ops.count_block(table)
    assert count_block_cuda.launches == launches


# -- the top-K ----------------------------------------------------------------

def test_top_k_ties_match_lax_top_k():
    """Equal counts order by ascending slot, as ``lax.top_k`` does (on this
    row ``torch.topk`` alone returns another order)."""
    counts = np.array([[1, 3, 3, -1, 3, 2, 3, -1]], np.int32)
    got = _top_k_slots(torch.from_numpy(counts), 5).numpy()
    vals, idx = jax.lax.top_k(jnp.asarray(counts), 5)
    np.testing.assert_array_equal(got[0, :, 0], np.asarray(idx)[0])
    np.testing.assert_array_equal(got[0, :, 1], np.asarray(vals)[0])
    assert got[0, :, 0].tolist() == [1, 2, 4, 6, 5]


@pytest.mark.parametrize("seed", range(4))
def test_top_k_sweep_matches_lax_top_k(seed):
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 300))
    counts = rng.integers(-1, 4, size=(6, C)).astype(np.int32)
    k = int(rng.integers(1, C + 1))
    got = _top_k_slots(torch.from_numpy(counts), k).numpy()
    vals, idx = jax.lax.top_k(jnp.asarray(counts), k)
    np.testing.assert_array_equal(got[..., 0], np.asarray(idx))
    np.testing.assert_array_equal(got[..., 1], np.asarray(vals))


def test_default_k_tier_matches_jax():
    for k in list(range(1, 70)) + [100, 128, 129, 1000]:
        assert default_k_tier(k) == jax_default_k_tier(k), k
    assert [default_k_tier(k) for k in (1, 8, 9, 16, 100)] == \
        [8, 8, 16, 16, 128]


# -- intersect_count_batch ----------------------------------------------------

def build_class(rng, sizes, t=3, gmax=64):
    """One (t, gmax) class of sets, preprocessed by the JAX package and
    carried into the port; returns (values, JAX mirrors, port mirrors)."""
    fam = jhashing.random_hash_family(2, 256, seed=1)
    perm = jhashing.default_permutation(1)
    pool = rng.choice(1 << 18, size=max(sizes) * 8, replace=False)
    vals = [np.sort(rng.choice(pool, size=n, replace=False)).astype(np.uint32)
            for n in sizes]
    jidx = [jpartition.preprocess_prefix(v, family=fam, perm=perm, t=t,
                                         gmax=gmax) for v in vals]
    return (vals, [JaxDeviceSet.from_host(i) for i in jidx],
            [DeviceSet.from_host(carry(i), CPU) for i in jidx])


def assert_same_count_results(port, want):
    assert len(port) == len(want)
    for (pp, ps), (jp, js) in zip(port, want):
        assert pp.dtype == np.int32
        np.testing.assert_array_equal(pp, np.asarray(jp))
        assert ps == js


def test_intersect_count_batch_tie_and_padding_match_jax():
    rng = np.random.default_rng(2)
    vals, jsets, tsets = build_class(rng, [120, 90, 90, 60, 60, 30])
    # a duplicate candidate forces a tie; 6 candidates pad to c_tier 8
    rows_j = [(jsets[0], jsets[1:] + [jsets[1]])]
    rows_t = [(tsets[0], tsets[1:] + [tsets[1]])]
    want = jax_intersect_count_batch(rows_j, k=8, use_pallas=False)
    got = intersect_count_batch(rows_t, k=8, device=CPU)
    assert_same_count_results(got, want)
    pairs, stats = got[0]
    assert stats["c_tier"] == 8 and stats["k_sel"] == 8
    ranked = [int(i) for i, c in pairs if c >= 1]
    assert ranked.index(0) < ranked.index(5)
    assert pairs[-2:, 1].tolist() == [-1, -1]
    truth = [len(np.intersect1d(vals[0], v)) for v in vals[1:] + [vals[1]]]
    assert {int(i): int(c) for i, c in pairs if c >= 0} == \
        dict(enumerate(truth))


def test_intersect_count_batch_padded_slot_and_rows_match_jax():
    rng = np.random.default_rng(9)
    _, jsets, tsets = build_class(rng, [64, 64, 64, 64, 50, 40])
    # row 0: 3 candidates (c_tier 4); row 1: 1; row 2: 4; k_sel = c_tier
    pick = [(0, [1, 2, 3]), (4, [5]), (5, [0, 1, 2, 3])]
    rows_j = [(jsets[p], [jsets[c] for c in cs]) for p, cs in pick]
    rows_t = [(tsets[p], [tsets[c] for c in cs]) for p, cs in pick]
    for k in (1, 2, 8, 16):
        want = jax_intersect_count_batch(rows_j, k=k, use_pallas=False)
        got = intersect_count_batch(rows_t, k=k, device=CPU)
        assert_same_count_results(got, want)
    got = intersect_count_batch(rows_t[:1], k=8, device=CPU)
    pairs, stats = got[0]
    assert stats["c_tier"] == 4 and pairs.shape == (4, 2)
    assert int(pairs[-1, 1]) == -1 and int(pairs[-1, 0]) == 3
    assert EXEC_COUNTERS["count_calls"] == 5


@pytest.mark.parametrize("t_probe,t_cand", [(4, 2), (2, 4)])
def test_intersect_count_batch_directions_match_jax(t_probe, t_cand):
    rng = np.random.default_rng(t_probe)
    # the shallow class (4 groups) needs wide rows
    _, jp, tp = build_class(rng, [200, 150], t=t_probe,
                            gmax=32 if t_probe > t_cand else 128)
    _, jc, tc = build_class(rng, [180, 120, 90], t=t_cand,
                            gmax=64 if t_cand > t_probe else 128)
    rows_j = [(jp[0], jc), (jp[1], jc[1:])]
    rows_t = [(tp[0], tc), (tp[1], tc[1:])]
    want = jax_intersect_count_batch(rows_j, k=8, use_pallas=False)
    got = intersect_count_batch(rows_t, k=8, device=CPU)
    assert_same_count_results(got, want)
    assert got[0][1]["group_tuples"] == 1 << max(t_probe, t_cand)


def test_intersect_count_batch_rejects_mixed_shapes():
    rng = np.random.default_rng(1)
    _, _, a = build_class(rng, [40, 40], t=3)
    _, _, b = build_class(rng, [40], t=2)
    with pytest.raises(ValueError):
        intersect_count_batch([(a[0], [a[1], b[0]])], k=8, device=CPU)
    with pytest.raises(ValueError):
        intersect_count_batch([(a[0], [a[1]]), (b[0], [a[1]])], k=8,
                              device=CPU)
    with pytest.raises(ValueError):
        intersect_count_batch([(a[0], [])], k=8, device=CPU)
    assert intersect_count_batch([], k=8, device=CPU) == []


# -- plan_suggest, CandidateIndex ---------------------------------------------

@pytest.fixture(scope="module")
def plan_index():
    rng = np.random.default_rng(21)
    fam = jhashing.random_hash_family(2, 256, seed=2)
    perm = jhashing.default_permutation(2)
    jidx = {sid: jpartition.preprocess_prefix(
        rng.choice(1 << 16, size=80, replace=False).astype(np.uint32),
        family=fam, perm=perm, gmax=64) for sid in range(6)}
    jidx[999] = jpartition.preprocess_prefix(
        rng.choice(1 << 18, size=3000, replace=False).astype(np.uint32),
        family=fam, perm=perm)
    return jidx, {sid: carry(i) for sid, i in jidx.items()}


@pytest.mark.parametrize("probe,cands,k", [
    (0, [3, 1, 2], 5), (0, [3, 1, 2], 100), (2, [5, 4, 4, 1, 0], 1),
    (1, [0], 9), (999, [0, 1, 2, 3, 4, 5], 20),
    (0, [99], 5), (99, [1], 5), (0, [], 5)])
def test_plan_suggest_matches_jax(plan_index, probe, cands, k):
    jidx, tidx = plan_index
    for device in (True, False):
        got = plan_suggest(tidx, probe, cands, k, device=device)
        want = jax_plan_suggest(jidx, probe, cands, k, device=device)
        assert got.terms == want.terms
        assert got.algorithm == want.algorithm
        assert got.cache_key() == want.cache_key()
        if want.sig is None:
            assert got.sig is None
        else:
            for name in ("k", "ts", "gmaxes", "capacity_tier", "cands"):
                assert getattr(got.sig, name) == getattr(want.sig, name), name


def test_plan_suggest_keys_and_mixed_classes(plan_index):
    jidx, tidx = plan_index
    plan = plan_suggest(tidx, 0, [3, 1, 2], k=5)
    assert plan.terms == (0, 1, 2, 3) and plan.sig.cands == 4
    assert plan.cache_key()[0] == "suggest"
    assert plan.cache_key() != plan_suggest(tidx, 0, [3, 1, 2],
                                            k=100).cache_key()
    with pytest.raises(AssertionError):
        jax_plan_suggest(jidx, 0, [1, 999], k=5)
    with pytest.raises(ValueError):
        plan_suggest(tidx, 0, [1, 999], k=5)


def test_candidate_index_matches_jax():
    rng = np.random.default_rng(11)
    jci = JaxCandidateIndex(jhashing.random_hash_family(2, 256, seed=4))
    tci = CandidateIndex(hashing.random_hash_family(2, 256, seed=4))
    corpus = {}
    pool = rng.choice(1 << 20, size=5000, replace=False)
    for sid in range(60):
        corpus[sid] = rng.choice(pool, size=int(rng.integers(10, 200)),
                                 replace=False).astype(np.uint32)
        jci.add(sid, corpus[sid])
        tci.add(sid, corpus[sid])
    tci.add(5, corpus[5][:3])        # a refresh keeps the set's position
    jci.add(5, corpus[5][:3])
    assert len(tci) == 60 and 3 in tci and 60 not in tci
    for sid in (0, 7, 33):
        for kwargs in ({}, {"min_shared_bins": 4}, {"max_candidates": 5}):
            got = tci.candidates(corpus[sid], exclude=sid, **kwargs)
            assert got == jci.candidates(corpus[sid], exclude=sid, **kwargs)
            assert sid not in got
        kept = set(tci.candidates(corpus[sid], exclude=sid))
        assert kept == set(jci.candidates(corpus[sid], exclude=sid))
        for c in corpus:
            if c not in (sid, 5) and len(np.intersect1d(corpus[sid],
                                                        corpus[c])):
                assert c in kept, (sid, c)
    for key in ("suggest_prefilter_in", "suggest_prefilter_kept"):
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key
    assert EXEC_COUNTERS["suggest_prefilter_in"] == 4 * 3 * 60
    assert CandidateIndex(tci.family).candidates(corpus[0]) == []


# -- ingest -------------------------------------------------------------------

def test_ingest_roundtrip_chunks_and_cross_package(tmp_path):
    rng = np.random.default_rng(3)
    recs = [(i, rng.integers(0, 1 << 20, size=int(rng.integers(1, 200)),
                             dtype=np.uint32)) for i in range(25)]
    path = tmp_path / "corpus.rsi"
    assert ingest.write_records(path, recs) == 25
    raw = path.read_bytes()
    assert raw[:4] == ingest.MAGIC
    jpath = tmp_path / "jax.rsi"
    jingest.write_records(jpath, recs)
    assert jpath.read_bytes() == raw
    back = list(ingest.read_records(path, chunk_size=7))
    assert [i for i, _ in back] == [i for i, _ in recs]
    assert all(np.array_equal(v, w) for (_, v), (_, w) in zip(recs, back))
    for chunks in ([bytes([b]) for b in raw], [raw]):
        again = list(ingest.stream_records(chunks))
        want = list(jingest.stream_records(chunks))
        assert [i for i, _ in again] == [i for i, _ in want]
        assert all(np.array_equal(v, w) for (_, v), (_, w) in zip(again, want))
    buf = io.BytesIO()
    ingest.write_records(buf, recs[:3])
    assert len(list(ingest.stream_records([buf.getvalue()]))) == 3


def test_ingest_rejects_bad_magic_and_truncation(tmp_path):
    path = tmp_path / "c.rsi"
    ingest.write_records(path, [(1, np.arange(10, dtype=np.uint32))])
    raw = path.read_bytes()
    with pytest.raises(ValueError, match="magic"):
        list(ingest.stream_records([b"XXXX" + raw[4:]]))
    with pytest.raises(ValueError, match="magic"):
        list(ingest.stream_records([b"RS"]))
    with pytest.raises(ValueError, match="truncated"):
        list(ingest.stream_records([raw[:-2]]))
    with pytest.raises(ValueError, match="truncated"):
        list(ingest.stream_records(bytes([b]) for b in raw[:-5]))


def test_ingest_file_feeds_engine(tmp_path):
    rng = np.random.default_rng(8)
    pool = rng.choice(1 << 18, size=3000, replace=False)
    corpus = {sid: rng.choice(pool, size=60, replace=False).astype(np.uint32)
              for sid in range(12)}
    path = tmp_path / "c.rsi"
    ingest.write_records(path, [*corpus.items(), (99, np.array([], np.uint32))])
    eng = SuggestEngine({}, use_device=False)
    assert ingest.ingest_file(path, eng) == 12
    assert eng.suggest(0, 5).suggestions == oracle_topk(corpus, 0, 5)
    dev = SuggestEngine({}, device=CPU)
    assert ingest.ingest_file(path, dev, chunk_size=5) == 12
    jeng = JaxSuggestEngine({}, use_device=False)
    jingest.ingest_file(path, jeng)
    assert dev.suggest(0, 5).suggestions == jeng.suggest(0, 5).suggestions


# -- SuggestEngine end to end ---------------------------------------------------

def make_corpus(seed=0, n_sets=30, lo=30, hi=250):
    rng = np.random.default_rng(seed)
    pool = rng.choice(1 << 20, size=4000, replace=False)
    corpus = {sid: rng.choice(pool, size=int(rng.integers(lo, hi)),
                              replace=False).astype(np.uint32)
              for sid in range(n_sets)}
    corpus[100] = corpus[3].copy()   # identical sets: forced exact ties
    corpus[101] = corpus[3].copy()
    return corpus


def assert_same_suggestions(port, want):
    assert len(port) == len(want)
    for p, j in zip(port, want):
        assert p.suggestions == j.suggestions
        assert p.algorithm == j.algorithm
        assert p.stats == j.stats


@pytest.fixture(scope="module")
def engines():
    """(corpus, JAX engine, port engine) with the device path, the port's
    on the CPU."""
    corpus = make_corpus()
    return (corpus, JaxSuggestEngine(corpus, use_device=True),
            SuggestEngine(corpus, device=CPU))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_suggest_device_path_matches_jax(engines, k):
    corpus, jeng, teng = engines
    jeng.cache.invalidate()
    teng.cache.invalidate()
    requests = [(sid, k) for sid in (0, 3, 100, 101, 17)]
    JAX_COUNTERS.reset()
    EXEC_COUNTERS.reset()
    got = teng.suggest_batch(requests)
    assert_same_suggestions(got, jeng.suggest_batch(requests))
    for (sid, _), res in zip(requests, got):
        assert res.suggestions == oracle_topk(corpus, sid, k)
        assert res.algorithm == "suggest/device"
    for key in ("count_calls", "suggest_prefilter_in",
                "suggest_prefilter_kept", "result_cache_misses",
                "inflight_dispatches", "inflight_collects"):
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key
    assert EXEC_COUNTERS["batch_calls"] == 0


def test_suggest_tie_break_end_to_end(engines):
    corpus, _, teng = engines
    top = teng.suggest(101, 3).suggestions
    assert top[0][0] == 3 and top[1][0] == 100 and top[0][1] == top[1][1]
    assert teng.suggest(3, 2).suggestions == [(100, len(corpus[3])),
                                              (101, len(corpus[3]))]
    with pytest.raises(KeyError):
        teng.suggest(999, 5)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_suggest_host_path_matches_jax(k):
    corpus = make_corpus(seed=4, n_sets=15)
    jeng = JaxSuggestEngine(corpus, use_device=False)
    teng = SuggestEngine(corpus, use_device=False)
    assert teng.device is None
    requests = [(sid, k) for sid in (0, 3, 100, 9)]
    got = teng.suggest_batch(requests)
    assert_same_suggestions(got, jeng.suggest_batch(requests))
    assert all(r.algorithm == "suggest/host" for r in got)
    for (sid, _), res in zip(requests, got):
        assert res.suggestions == oracle_topk(corpus, sid, k)


def test_suggest_cache_and_mutation_match_jax():
    corpus = make_corpus(seed=1, n_sets=15)
    jeng = JaxSuggestEngine(corpus, use_device=True)
    teng = SuggestEngine(corpus, device=CPU)
    JAX_COUNTERS.reset()
    EXEC_COUNTERS.reset()
    for eng in (jeng, teng):
        first = eng.suggest(2, 5)
        hit = eng.suggest(2, 5)
        assert hit.stats == {"cached": True, "k": 5}
        assert hit.suggestions == first.suggestions
        assert not eng.suggest(2, 4).stats.get("cached")
        eng.add_set(2, np.concatenate([corpus[2], corpus[7][:10]]))
        after = eng.suggest(2, 5)
        assert not after.stats.get("cached")
    for key in ("count_calls", "result_cache_hits", "result_cache_misses"):
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key
    assert EXEC_COUNTERS["result_cache_hits"] == 1
    grown = dict(corpus)
    grown[2] = np.unique(np.concatenate([corpus[2], corpus[7][:10]]))
    assert teng.suggest(2, 5).suggestions == oracle_topk(grown, 2, 5)
    assert teng.suggest(2, 5).suggestions == jeng.suggest(2, 5).suggestions


def test_suggest_batch_shares_buckets():
    corpus = make_corpus(seed=3, n_sets=20)
    jeng = JaxSuggestEngine(corpus, use_device=True)
    teng = SuggestEngine(corpus, device=CPU)
    requests = [(0, 5), (1, 5), (2, 5), (3, 5)]
    JAX_COUNTERS.reset()
    EXEC_COUNTERS.reset()
    got = teng.suggest_batch(requests)
    assert_same_suggestions(got, jeng.suggest_batch(requests))
    for (sid, k), res in zip(requests, got):
        assert res.suggestions == oracle_topk(corpus, sid, k)
    n_classes = sum(r.stats["classes"] for r in got)
    assert EXEC_COUNTERS["count_calls"] == JAX_COUNTERS["count_calls"]
    assert EXEC_COUNTERS["count_calls"] < n_classes
