"""The port's boolean ∪/∩/∖ expression path on the CPU, against the JAX
package, mirroring ``tests/test_expr.py`` (its sharded and 2-D cases wait
for the port's sharded execution).

The same seeded numpy inputs go through both packages and every output
must be equal (tolerance 0: doc ids, stats and counters are integers):
the expression algebra (``expr_key``, ``expr_shape``, ``leaf_terms``,
``subexpr_keys``, ``flat_terms``, ``canonicalize``, ``parse``), the set
passes (also against their numpy oracles, at values >= 2^31 and
``0xFFFFFFFE``), ``intersect_expr_batch`` with forced overflow, planning,
the ``eshape`` arm of ``CapacityModel``, mixed batches through
``SearchEngine`` and ``AsyncSearchEngine``, the subexpression cache with
its counter deltas, ``expr/host`` and expression warming.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.engine import EXEC_COUNTERS as JAX_COUNTERS
from repro.core.engine import intersect_expr_batch as jax_intersect_expr_batch
from repro.core.engine import DeviceSet as JaxDeviceSet
from repro.core.hashing import default_permutation, random_hash_family
from repro.core.partition import preprocess_prefix
from repro.exec import expr as jexpr
from repro.exec.adaptive import CapacityModel as JaxCapacityModel
from repro.exec.plan import plan_query as jax_plan_query
from repro.kernels import setops as jsetops
from repro.serve.search import AsyncSearchEngine as JaxAsyncSearchEngine
from repro.serve.search import SearchEngine as JaxSearchEngine

from repro_torch.core import partition
from repro_torch.core.engine import (
    EXEC_COUNTERS, DeviceSet, _count_expr_subs, clear_specializations,
    default_expr_capacity, expr_total_width, intersect_expr_batch,
    pow2_tiers,
)
from repro_torch.exec import expr as texpr
from repro_torch.exec.adaptive import CapacityModel, adaptive_key
from repro_torch.exec.plan import QueryPlan, plan_query
from repro_torch.kernels import setops
from repro_torch.serve.search import AsyncSearchEngine, SearchEngine

CPU = "cpu"
STATS = ("r", "tuples_survived", "capacity", "batch_size", "expr_width")
COUNTERS = ("expr_calls", "expr_traces", "expr_rerun_calls", "batch_calls",
            "rerun_calls", "result_cache_hits", "result_cache_misses",
            "subexpr_cache_hits", "subexpr_cache_misses",
            "subexpr_cache_stores", "subexpr_host_merges",
            "inflight_dispatches", "inflight_collects")


@pytest.fixture(autouse=True)
def _reset_port_counters():
    EXEC_COUNTERS.reset()
    yield


# ---------------------------------------------------------------------------
# the expression algebra (metadata-only index: .t / .n / .gmax)
# ---------------------------------------------------------------------------

class _Meta:
    def __init__(self, t, n, gmax=4):
        self.t, self.n, self.gmax = t, n, gmax


IDX = {name: _Meta(t=i % 3 + 1, n=10 + 7 * i)
       for i, name in enumerate("abcdef")}


def both(s):
    """Canonical form of ``s`` in (port, JAX)."""
    return (texpr.canonicalize(texpr.parse(s), IDX),
            jexpr.canonicalize(jexpr.parse(s), IDX))


# the canonicalization cases of tests/test_expr.py: groups of expressions
# that must share one canonical key, in both packages
EQUAL_GROUPS = [
    ("a&(b&c)", "(c&a)&b", "b&c&a&b"),
    ("a|(b|c)", "(c|a)|b", "b|c|a|b"),
    ("a&a", "a", "a|a"),
    ("(a|b)-c", "(a-c)|(b-c)"),
    ("(a-b)-c", "a-(b|c)"),
    ("(a-d)&b", "(a&b)-d"),
    ("a|zz", "a", "a-zz"),
]
EMPTY_CASES = ["a-a", "a-(b|a)", "a&zz", "zz-a"]


@pytest.mark.parametrize("group", EQUAL_GROUPS, ids=lambda g: g[0])
def test_canonical_groups_match_jax(group):
    keys = set()
    for s in group:
        port, ref = both(s)
        assert texpr.expr_key(port) == jexpr.expr_key(ref)
        keys.add(texpr.expr_key(port))
    assert len(keys) == 1


@pytest.mark.parametrize("s", EMPTY_CASES)
def test_empty_cases_match_jax(s):
    port, ref = both(s)
    assert port is texpr.EMPTY and ref is jexpr.EMPTY


def test_parser_matches_jax():
    for s in ("a&b|c-d", "1&2", "a ∩ b ∪ c ∖ d", "(0|1)&(2|3)-4"):
        assert texpr.expr_key(texpr.parse(s)) == jexpr.expr_key(jexpr.parse(s))
    assert texpr.parse("1&2") == texpr.And((texpr.Term(1), texpr.Term(2)))
    for bad in ("a &", "(a|b"):
        with pytest.raises(ValueError):
            texpr.parse(bad)


def random_expr_str(rng, terms, depth=0, max_depth=2):
    """The generator of tests/test_expr.py, written as a parse string."""
    if depth >= max_depth or rng.random() < 0.35:
        return str(terms[int(rng.integers(0, len(terms)))])
    op = int(rng.integers(0, 3))
    if op == 2:
        return "({}-{})".format(
            random_expr_str(rng, terms, depth + 1, max_depth),
            random_expr_str(rng, terms, depth + 1, max_depth))
    kids = [random_expr_str(rng, terms, depth + 1, max_depth)
            for _ in range(int(rng.integers(2, 4)))]
    return "(" + ("&" if op == 0 else "|").join(kids) + ")"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_expressions_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        s = random_expr_str(rng, list("abcdef"), max_depth=3)
        assert texpr.expr_key(texpr.parse(s)) == jexpr.expr_key(jexpr.parse(s))
        port, ref = both(s)
        if ref is jexpr.EMPTY:
            assert port is texpr.EMPTY
            continue
        assert texpr.expr_key(port) == jexpr.expr_key(ref)
        assert texpr.expr_shape(port) == jexpr.expr_shape(ref)
        assert texpr.leaf_terms(port) == jexpr.leaf_terms(ref)
        assert texpr.subexpr_keys(port) == jexpr.subexpr_keys(ref)
        assert texpr.flat_terms(port) == jexpr.flat_terms(ref)
        assert texpr.expr_key(texpr.canonicalize(port, IDX)) == \
            texpr.expr_key(port)
        assert _count_expr_subs(texpr.expr_shape(port)) == \
            len(texpr.subexpr_keys(port))


def test_eval_host_matches_jax():
    vals = {"a": np.array([1, 2, 3, 4], np.uint32),
            "b": np.array([3, 4, 5, 0xFFFFFFFE], np.uint32),
            "c": np.array([4, 6, 1 << 31], np.uint32)}
    for s in ("a&b", "a|c", "a-b", "(a|c)&b-c", "(b|c)-a"):
        got = texpr.eval_host(texpr.parse(s), vals.__getitem__)
        want = jexpr.eval_host(jexpr.parse(s), vals.__getitem__)
        assert got.dtype == np.uint32 and np.array_equal(got, want), s


# ---------------------------------------------------------------------------
# the set passes, against the JAX passes and the numpy oracles
# ---------------------------------------------------------------------------

def _rows(rng, B, width, n_real, high=False):
    """(B, width) sorted uint32 rows, 0xFFFFFFFF padded; ``high`` draws
    from [2^31, 2^32 - 1) and plants 0xFFFFFFFE."""
    out = np.full((B, width), 0xFFFFFFFF, np.uint32)
    for i in range(B):
        lo = (1 << 31) if high else 0
        vals = rng.integers(lo, 0xFFFFFFFE, size=n_real, dtype=np.uint64)
        vals = np.unique(np.concatenate(
            [vals.astype(np.uint32), [0xFFFFFFFE] if high else []]
        ).astype(np.uint32))[:width]
        out[i, :len(vals)] = vals
    out[0] = 0xFFFFFFFF  # an all-sentinel row
    return out


PASS_CASES = [  # (B, widths, n_real, high, out width)
    (3, (16, 16), 10, False, 32),
    (3, (16, 24), 14, True, 40),
    (2, (32, 8, 16), 6, True, 8),      # width < count: truncation
    (2, (8, 8), 8, False, 4),
]


def _keys(u):
    return torch.from_numpy(setops.to_keys_np(u))


@pytest.mark.parametrize("case", PASS_CASES, ids=str)
def test_set_passes_match_jax_and_oracle(case):
    B, widths, n_real, high, width = case
    rng = np.random.default_rng(sum(widths) + n_real)
    # shared values so unions, differences and intersections are nontrivial
    base = _rows(rng, B, max(widths), n_real, high)
    bufs = []
    for w in widths:
        extra = _rows(rng, B, w, n_real // 2, high)
        mixed = np.sort(np.concatenate([base[:, :w // 2], extra], axis=1),
                        axis=1)[:, :w]
        bufs.append(np.stack([np.concatenate([np.unique(r), np.full(
            w, 0xFFFFFFFF, np.uint32)])[:w] for r in mixed]).astype(np.uint32))
    cases = [
        ("union", setops.union_pass, jsetops.union_pass, jsetops.union_ref,
         (bufs,)),
        ("diff", setops.diff_pass, jsetops.diff_pass, jsetops.diff_ref,
         (bufs[0], bufs[1])),
        ("intersect", setops.intersect_pass, jsetops.intersect_pass,
         jsetops.intersect_ref, (bufs,)),
    ]
    for name, port_fn, jax_fn, ref_fn, args in cases:
        w = min(width, sum(b.shape[1] for b in bufs) if name == "union"
                else bufs[0].shape[1])
        if isinstance(args[0], list):
            out, count = port_fn([_keys(b) for b in args[0]], w)
            jout, jcount = jax_fn([jnp.asarray(b) for b in args[0]], w)
        else:
            out, count = port_fn(*(_keys(b) for b in args), w)
            jout, jcount = jax_fn(*(jnp.asarray(b) for b in args), w)
        rout, rcount = ref_fn(*args, w)
        got = setops.to_values_np(out.numpy())
        assert np.array_equal(got, np.asarray(jout)), name
        assert np.array_equal(got, rout), name
        assert np.array_equal(count.numpy(), np.asarray(jcount)), name
        assert np.array_equal(count.numpy(), rcount), name
    assert any(c > width for c in jsetops.union_ref(bufs, width)[1]) or \
        width >= 32


def test_densify_and_member_mask_match_jax():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 0xFFFFFFFE, size=(3, 4, 8), dtype=np.uint64)
    vals = vals.astype(np.uint32)
    vals[0, 1, 5:] = 0xFFFFFFFF
    vals[1, :, :] = 0xFFFFFFFF
    vals[2, 0, 0] = 0xFFFFFFFE
    vals[2, 0, 1] = 1 << 31
    as_i32 = vals.view(np.int32)
    dense = setops.densify(torch.from_numpy(as_i32))
    want = np.asarray(jsetops.densify(jnp.asarray(as_i32)))
    assert np.array_equal(setops.to_values_np(dense.numpy()), want)
    # densify_ref reads every negative int32 as padding, so its values stay
    # below 2^31
    low = np.where(as_i32 == -1, -1, as_i32 & 0x7FFFFFFF).astype(np.int32)
    assert np.array_equal(
        setops.to_values_np(setops.densify(torch.from_numpy(low)).numpy()),
        jsetops.densify_ref(low))
    needles = want[:, ::-1].copy()  # unsorted needles, sentinels first
    got = setops.member_mask(_keys(needles), dense)
    ref = jsetops.member_mask(jnp.asarray(needles), jnp.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the expression pass on the same PrefixIndex inputs
# ---------------------------------------------------------------------------

def carry(idx):
    """A JAX-package PrefixIndex carried into the port as plain arrays."""
    return partition.prefix_index_from_arrays(
        values=idx.values, g_keys=idx.g_keys, t=idx.t, offsets=idx.offsets,
        padded_keys=idx.padded_keys, padded_vals=idx.padded_vals,
        mask=idx.mask, gmax=idx.gmax, images=idx.images, w=idx.w,
        family_a=idx.family.a, family_b=idx.family.b,
        perm_mults=idx.perm.mults, perm_shifts=idx.perm.shifts)


@pytest.fixture(scope="module")
def leaf_rows():
    """Three overlapping leaves (tests/test_expr.py::_overlapping_leaf_rows):
    the sets, JAX DeviceSets and the port's mirrors of the same indexes."""
    rng = np.random.default_rng(0)
    fam = random_hash_family(2, 256, seed=7)
    perm = default_permutation(7)
    common = rng.choice(1 << 22, 250, replace=False).astype(np.uint32)
    sets = [np.unique(np.concatenate(
        [rng.choice(1 << 22, 400, replace=False).astype(np.uint32), common]))
        for _ in range(3)]
    idxs = [preprocess_prefix(s, w=256, m=2, family=fam, perm=perm)
            for s in sets]
    return (sets, [JaxDeviceSet.from_host(i) for i in idxs],
            [DeviceSet.from_host(carry(i), CPU) for i in idxs])


SHAPES = [("-", ("|", "T", "T"), "T"), ("&", ("|", "T", "T"), "T"),
          ("|", ("-", "T", "T"), "T")]


@pytest.mark.parametrize("cap", [None, 2, 16])
@pytest.mark.parametrize("eshape", SHAPES, ids=str)
def test_intersect_expr_batch_matches_jax(leaf_rows, eshape, cap):
    sets, jrow, trow = leaf_rows
    keys = [[("k", i, j) for j in range(_count_expr_subs(eshape))]
            for i in range(2)]
    JAX_COUNTERS.reset()
    want = jax_intersect_expr_batch([jrow, jrow], eshape, capacity=cap,
                                    sub_keys=keys)
    got = intersect_expr_batch([trow, trow], eshape, capacity=cap,
                               sub_keys=keys, device=CPU)
    for (res, stats), (jres, jstats) in zip(got, want):
        assert res.dtype == np.uint32
        assert np.array_equal(res, np.asarray(jres))
        for key in STATS:
            assert stats[key] == jstats[key], key
        assert len(stats["subexprs"]) == len(jstats["subexprs"])
        for (k, v), (jk, jv) in zip(stats["subexprs"], jstats["subexprs"]):
            assert k == jk and np.array_equal(v, np.asarray(jv))
    for key in ("expr_calls", "expr_rerun_calls"):
        assert EXEC_COUNTERS[key] == JAX_COUNTERS[key], key
    if cap is not None:
        assert EXEC_COUNTERS["expr_rerun_calls"] >= 1
    if eshape == SHAPES[0]:  # (a ∪ b) ∖ c against the numpy oracle
        truth = np.setdiff1d(np.union1d(sets[0], sets[1]), sets[2])
        assert np.array_equal(got[0][0], truth.astype(np.uint32))


def test_expr_widths_match_jax():
    from repro.core.engine import (
        default_expr_capacity as jax_default_expr_capacity,
        expr_total_width as jax_expr_total_width,
    )
    for ts, gmaxes in [((3,), (8,)), ((4, 6, 9), (8, 16, 32)),
                       ((12, 19), (64, 64))]:
        assert expr_total_width(ts, gmaxes) == jax_expr_total_width(ts, gmaxes)
        assert default_expr_capacity(ts, gmaxes) == \
            jax_default_expr_capacity(ts, gmaxes)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def _small_index(seed=0, n_terms=6):
    rng = np.random.default_rng(seed)
    fam = random_hash_family(2, 256, seed=7)
    perm = default_permutation(7)
    common = rng.choice(1 << 20, 60, replace=False).astype(np.uint32)
    jidx = {}
    for t in range(n_terms):
        own = rng.choice(1 << 20, int(rng.integers(40, 600)),
                         replace=False).astype(np.uint32)
        jidx[t] = preprocess_prefix(np.unique(np.concatenate([own, common])),
                                    w=256, m=2, family=fam, perm=perm)
    return jidx, {t: carry(i) for t, i in jidx.items()}


SIG_FIELDS = ("k", "ts", "gmaxes", "capacity_tier", "eshape", "cands")
PLAN_CASES = ["1&2", "2&(0&1)", "3|3", "4&5&4", "(0|1)&(2|3)-4",
              "((3|2)&(1|0))-4", "0|1", "(0-1)&2", "0&9", "0-0", "(0|9)&1"]


def assert_same_plan(port, ref):
    assert port.terms == ref.terms and port.algorithm == ref.algorithm
    assert port.cache_key() == ref.cache_key()
    assert (port.expr is None) == (ref.expr is None)
    if ref.expr is not None:
        assert texpr.expr_key(port.expr) == jexpr.expr_key(ref.expr)
    assert (port.sig is None) == (ref.sig is None)
    if ref.sig is not None:
        for f in SIG_FIELDS:
            assert getattr(port.sig, f) == getattr(ref.sig, f), f


@pytest.mark.parametrize("hashbin_ratio", [100.0, 1.0])
def test_plan_query_matches_jax(hashbin_ratio):
    """At ratio 1.0 every two-term conjunction of unequal sizes, flat
    normalizing expressions included, routes to HashBin; an expression
    never does."""
    jidx, tidx = _small_index()
    kw = {"hashbin_ratio": hashbin_ratio}
    for s in PLAN_CASES:
        want = jax_plan_query(jidx, jexpr.parse(s), **kw)
        assert_same_plan(plan_query(tidx, s, **kw), want)
        assert_same_plan(plan_query(tidx, texpr.parse(s), **kw), want)
    # expressions that normalize flat plan exactly as the term list
    for q, s in [([1, 2], "1&2"), ([0, 1, 2], "2&(0&1)"), ([3], "3|3"),
                 ([4, 5], "4&5&4")]:
        assert plan_query(tidx, s, **kw) == plan_query(tidx, q, **kw)
        assert plan_query(tidx, s).sig is None or \
            plan_query(tidx, s).sig.eshape is None
    if hashbin_ratio == 1.0:
        assert plan_query(tidx, "1&2", **kw).algorithm == "hashbin"
    p = plan_query(tidx, "(0|1)&(2|3)-4")
    assert p.query_spec() is p.expr and plan_query(tidx, [0, 1]).query_spec() \
        == list(plan_query(tidx, [0, 1]).terms)
    assert adaptive_key(p.sig)[-1] == p.sig.eshape


# ---------------------------------------------------------------------------
# the eshape arm of CapacityModel
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_capacity_model_eshape_arm_matches_jax():
    """One scripted observation sequence (counts above and below the
    expression prior, a decay, a drift down) through both packages' model:
    equal learned tiers, hook calls and counter deltas."""
    jidx, tidx = _small_index()
    s = "(0|1)&2"
    tsig = plan_query(tidx, s).sig
    jsig = jax_plan_query(jidx, jexpr.parse(s)).sig
    total = expr_total_width(tsig.ts, tsig.gmaxes)
    prior = default_expr_capacity(tsig.ts, tsig.gmaxes)
    script = [(0.0, [prior * 2] * 3), (1.0, [prior // 8] * 2),
              (2.0, [total * 4]), (400.0, [prior // 16] * 4),
              (401.0, [3] * 4)]
    out = {}
    for name, model_cls, sig, counters in (
            ("port", CapacityModel, tsig, EXEC_COUNTERS),
            ("jax", JaxCapacityModel, jsig, JAX_COUNTERS)):
        clk = FakeClock()
        model = model_cls(min_observations=4, clock=clk)
        moves = []
        model.on_promotion(lambda k, a, b: moves.append((a, b)))
        counters.reset()
        tiers = []
        for at, survivors in script:
            clk.t = at
            model.observe_bucket(sig, [{"tuples_survived": n}
                                       for n in survivors])
            tiers.append(model.capacity_for(adaptive_key(sig), prior))
        out[name] = (tiers, moves, {k: counters[k] for k in (
            "adaptive_promotions", "adaptive_demotions",
            "adaptive_overflow_saved")})
    assert out["port"] == out["jax"]
    tiers, moves, deltas = out["port"]
    assert max(tiers) == total  # clamped to the total leaf width
    assert deltas["adaptive_promotions"] >= 1
    assert deltas["adaptive_demotions"] >= 1


# ---------------------------------------------------------------------------
# the serving layer: mixed batches, the subexpression cache, warming
# ---------------------------------------------------------------------------

def random_postings(rng, n_terms=8, max_len=400, universe=1 << 18):
    common = rng.choice(universe, 40, replace=False).astype(np.uint32)
    postings = {}
    for t in range(n_terms):
        own = rng.choice(universe, int(rng.integers(5, max_len)),
                         replace=False).astype(np.uint32)
        postings[t] = np.unique(np.concatenate([own, common]))
    return postings


def assert_same_results(port, ref):
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        assert p.doc_ids.dtype == np.uint32
        assert np.array_equal(p.doc_ids, np.asarray(j.doc_ids))
        assert p.algorithm == j.algorithm
        assert p.stats.get("cached") == j.stats.get("cached")
        if p.algorithm.endswith("/device") and not p.stats.get("cached"):
            for key in STATS:
                assert p.stats.get(key) == j.stats.get(key), key
        else:
            assert p.stats.get("r") == j.stats.get("r")


def deltas(counters):
    return {k: counters[k] for k in COUNTERS}


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_batch_matches_jax(seed):
    """tests/test_expr.py's differential: random expressions and flat
    conjunctions in one batch, then the expressions through the async
    front end; both packages equal each other and the oracle."""
    rng = np.random.default_rng(seed)
    postings = random_postings(rng)
    terms = list(postings)
    exprs = [random_expr_str(rng, terms) for _ in range(8)]
    exprs.append("(0|1)&(2|3)-4")
    truths = [texpr.eval_host(texpr.parse(s), postings.__getitem__)
              for s in exprs]
    flat = [[0, 1], [2, 3, 4]]
    teng = SearchEngine(postings, seed=3, device=CPU)
    jeng = JaxSearchEngine(postings, seed=3, use_device=True)
    JAX_COUNTERS.reset()
    want = jeng.query_batch([jexpr.parse(s) for s in exprs] + flat)
    got = teng.query_batch(list(exprs) + flat)
    assert_same_results(got, want)
    assert deltas(EXEC_COUNTERS) == deltas(JAX_COUNTERS)
    for s, truth, r in zip(exprs, truths, got):
        assert np.array_equal(r.doc_ids, truth), s
    assert {r.algorithm for r in got} >= {"expr/device",
                                          "rangroupscan/device"}
    kw = dict(seed=3, flush_tier=8, result_cache=0)
    taeng = AsyncSearchEngine(postings, device=CPU, **kw)
    jaeng = JaxAsyncSearchEngine(postings, **kw)
    JAX_COUNTERS.reset()
    EXEC_COUNTERS.reset()
    jt = [jaeng.submit(jexpr.parse(s)) for s in exprs]
    jaeng.drain()
    tt = [taeng.submit(s) for s in exprs]
    taeng.drain()
    assert_same_results([t.value for t in tt], [t.value for t in jt])
    assert deltas(EXEC_COUNTERS) == deltas(JAX_COUNTERS)
    for s, truth, t in zip(exprs, truths, tt):
        assert t.done and t.error is None
        assert np.array_equal(t.value.doc_ids, truth), s


def _both_engines(postings, **kw):
    return (SearchEngine(postings, seed=3, device=CPU, **kw),
            JaxSearchEngine(postings, seed=3, use_device=True, **kw))


def _run_both(script, teng, jeng):
    """``script(eng, parse, counters)`` through both packages, counters
    reset before each; returns (port out, JAX out)."""
    EXEC_COUNTERS.reset()
    JAX_COUNTERS.reset()
    return (script(teng, texpr.parse, EXEC_COUNTERS),
            script(jeng, jexpr.parse, JAX_COUNTERS))


def test_subexpr_cache_host_merge_matches_jax():
    rng = np.random.default_rng(2)
    postings = random_postings(rng)
    oracle = lambda s: texpr.eval_host(texpr.parse(s), postings.__getitem__)

    def script(eng, parse, counters):
        out = []
        for q in (parse("(0|1)&(2|3)-4"), parse("(0|1)&5"),
                  parse("5&(1|0)"), [4, 5], parse("(4&5)|6")):
            res = eng.query(q)
            out.append((res, deltas(counters)))
        return out

    port, ref = _run_both(script, *_both_engines(postings, result_cache=64))
    assert_same_results([r for r, _ in port], [r for r, _ in ref])
    assert [d for _, d in port] == [d for _, d in ref]
    algos = [r.algorithm for r, _ in port]
    assert algos == ["expr/device", "expr/subcache", "expr/subcache",
                     "rangroupscan/device", "expr/subcache"]
    assert port[2][0].stats.get("cached")  # the algebraic twin: a root hit
    for (res, _), s in zip(port, ("(0|1)&(2|3)-4", "(0|1)&5", "5&(1|0)",
                                  "4&5", "(4&5)|6")):
        assert np.array_equal(res.doc_ids, oracle(s)), s
    merges = [d["subexpr_host_merges"] for _, d in port]
    assert merges == [0, 1, 1, 1, 2]


def test_subexpr_cache_through_async_matches_jax():
    rng = np.random.default_rng(3)
    postings = random_postings(rng)
    kw = dict(seed=3, flush_tier=8, result_cache=64)
    teng = AsyncSearchEngine(postings, device=CPU, **kw)
    jeng = JaxAsyncSearchEngine(postings, **kw)

    def script(eng, parse, counters):
        t = eng.submit(parse("(0|1)&(2|3)"))
        eng.drain()
        t2 = eng.submit(parse("(2|3)&7"))  # shares 2|3: merged at submit
        assert t2.done
        return [t.value, t2.value], deltas(counters)

    (tvals, td), (jvals, jd) = _run_both(script, teng, jeng)
    assert_same_results(tvals, jvals)
    assert td == jd
    assert tvals[1].algorithm == "expr/subcache"
    assert td["subexpr_cache_hits"] >= 1 and td["subexpr_host_merges"] == 1
    assert np.array_equal(tvals[1].doc_ids, texpr.eval_host(
        texpr.parse("(2|3)&7"), postings.__getitem__))


def test_subexpr_cache_respects_generation_matches_jax():
    rng = np.random.default_rng(4)
    postings = random_postings(rng)
    new = np.arange(10, dtype=np.uint32)

    def script(eng, parse, counters):
        eng.query(parse("(0|1)&(2|3)"))
        eng.add_postings(1, new)
        before = counters["subexpr_cache_hits"]
        r = eng.query(parse("(0|1)&5"))
        return r, counters["subexpr_cache_hits"] - before, deltas(counters)

    (tr, th, td), (jr, jh, jd) = _run_both(
        script, *_both_engines(postings, result_cache=64))
    assert th == jh == 0
    assert td == jd
    assert_same_results([tr], [jr])
    assert np.array_equal(tr.doc_ids, texpr.eval_host(
        texpr.parse("(0|1)&5"),
        lambda t: new if t == 1 else postings[t]))


def test_expr_host_matches_jax():
    """A host plan of an expression runs ``eval_host`` as ``expr/host``,
    as the JAX package's host engine serves it."""
    rng = np.random.default_rng(6)
    postings = random_postings(rng)
    teng = SearchEngine(postings, seed=3, device=CPU)
    jeng = JaxSearchEngine(postings, seed=3)  # no device: host routing
    for s in ("(0|1)&(2|3)-4", "0|1", "(5-6)&7"):
        can = texpr.canonicalize(texpr.parse(s), teng.index)
        plan = QueryPlan(terms=texpr.leaf_terms(can), algorithm="host",
                         expr=can)
        got = teng._execute_host_plan(plan)
        want = jeng.query(jexpr.parse(s))
        assert got.algorithm == want.algorithm == "expr/host"
        assert np.array_equal(got.doc_ids, np.asarray(want.doc_ids))
        assert got.stats == want.stats


def test_expression_warming_leaves_zero_serve_time_traces():
    """Warming a log of expressions at every tier up to the flush tier
    (first passes and, the port's addition, the re-runs at the total leaf
    width) leaves 0 ``expr_traces`` when the log is served, overflowing
    siblings included."""
    rng = np.random.default_rng(7)
    postings = random_postings(rng, n_terms=10)
    log = ["(0|1)&%d" % e for e in (4, 5, 6, 7, 8)] + \
          ["((2|3)&%d)-%d" % (e, c) for e, c in ((4, 9), (5, 8), (6, 7))] + \
          ["0&4", "(0&4)&0"]
    cap = CapacityModel(min_observations=1 << 20)  # never learns: fixed tiers
    eng = AsyncSearchEngine(postings, seed=3, device=CPU, flush_tier=4,
                            result_cache=0, adaptive_capacity=cap)
    clear_specializations()
    warmed = eng.warm(log, top_k=len(log), b_tiers=pow2_tiers(4))
    assert any(sig.eshape is not None for sig in warmed)
    warm = dict(EXEC_COUNTERS)
    assert warm["expr_traces"] > 0 and warm["warm_reruns"] > 0
    EXEC_COUNTERS.reset()
    tickets = [eng.submit(s) for s in log]
    eng.drain()
    for s, t in zip(log, tickets):
        assert np.array_equal(t.value.doc_ids, texpr.eval_host(
            texpr.parse(s), postings.__getitem__)), s
    assert EXEC_COUNTERS["expr_calls"] > 0
    assert EXEC_COUNTERS["expr_traces"] == 0
    assert EXEC_COUNTERS["batch_traces"] == 0
