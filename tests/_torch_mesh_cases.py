"""Scenarios of z-sharded and 2-D execution, run against either package.

Each ``case_*`` function drives one scenario through an :class:`Api` (the
JAX package's or the port's entry points) and returns plain data: sorted
values as lists of ints, the stats the two packages share, counter deltas
and whatever else the scenario reads.  ``tests/test_torch_sharded.py`` and
``tests/test_torch_mesh2d.py`` run every case of theirs once in a JAX
subprocess with eight forced host devices (:func:`main`) and once on the
port in-process, over logical CPU devices (a mesh listing ``"cpu"``
several times), and require the two results to be equal.

The inputs are seeded numpy data, preprocessed by each package's own
``preprocess_prefix``.  Every case clears the package's specialization
memory first (``clear_exec_jit_cache`` / ``clear_specializations``), so
trace counts do not depend on which cases ran before it.
"""
import os
import pathlib
import pickle
import subprocess
import sys
import traceback

import numpy as np

# stats the two packages' passes both report (batch_us is a wall time)
STATS = ("r", "tuples_survived", "max_shard_survivors", "capacity",
         "capacity_per_shard", "n_shards", "n_replicas", "replica",
         "batch_size", "group_tuples", "expr_width", "n_cands", "k_sel",
         "c_tier", "cached")
# counters the two packages both keep (the port's warm_reruns is its own)
COUNTERS = ("batch_calls", "batch_traces", "rerun_calls",
            "sharded_calls", "sharded_traces", "sharded_rerun_calls",
            "mesh2d_calls", "mesh2d_traces", "mesh2d_rerun_calls",
            "mesh2d_row_dispatches", "replica_dispatches",
            "inflight_dispatches", "inflight_collects", "warm_executions",
            "expr_calls", "expr_traces", "expr_rerun_calls",
            "count_calls", "count_traces", "dispatch_failures",
            "result_cache_hits", "result_cache_misses",
            "subexpr_cache_stores")
LAYOUTS = ((1, 4), (2, 2), (4, 1))


class Api:
    """One package's entry points, called the same way by every case."""

    def __init__(self, package: str):
        self.package = package
        if package == "jax":
            from repro.core import engine
            from repro.core import hashing, partition
            from repro.exec import batch, expr, plan, topology
            from repro.serve import search
        else:
            from repro_torch.core import engine
            from repro_torch.core import hashing, partition
            from repro_torch.exec import batch, expr, plan, topology
            from repro_torch.serve import search
        self.E, self.B, self.X, self.P, self.T, self.S = (
            engine, batch, expr, plan, topology, search)
        self.hashing, self.partition = hashing, partition

    # -- layout ---------------------------------------------------------------

    @property
    def port(self) -> bool:
        return self.package == "torch"

    def mesh(self, n: int):
        if self.port:
            return self.E.make_shard_mesh(n, devices=["cpu"] * n)
        return self.E.make_shard_mesh(n)

    def topology(self, replicas: int, shards: int):
        if self.port:
            return self.T.make_topology(replicas, shards,
                                        devices=["cpu"] * (replicas * shards))
        return self.T.make_topology(replicas, shards)

    def dset(self, idx):
        if self.port:
            return self.E.DeviceSet.from_host(idx, "cpu")
        return self.E.DeviceSet.from_host(idx)

    def replicated(self, idx, topo):
        """A ReplicatedDeviceSet built as the engines build one."""
        ds = self.dset(idx)
        if topo.shards > 1:
            rows = tuple(ds.shard(topo.row_mesh(r), topo.shard_axis)
                         for r in range(topo.replicas))
        else:
            rows = tuple(ds.place(topo.replica_device(r))
                         for r in range(topo.replicas))
        return self.E.ReplicatedDeviceSet(rows)

    def kw(self, **kw):
        """Engine keywords: the port runs on the CPU when asked, the JAX
        package on its device path."""
        if self.port:
            kw.setdefault("device", "cpu")
        else:
            kw.setdefault("use_device", True)
        return kw

    def device_batch(self, rows, **kw):
        if self.port:
            kw["device"] = "cpu"
        return self.E.intersect_device_batch(rows, **kw)

    def name(self, term):
        """A term's key in an engine's ``device.sets``."""
        return term if self.port else str(term)

    # -- counters ---------------------------------------------------------------

    def fresh(self) -> None:
        if self.port:
            self.E.clear_specializations()
        else:
            self.E.clear_exec_jit_cache()
        self.E.EXEC_COUNTERS.reset()

    def delta(self, reset: bool = True) -> dict:
        snap = self.E.EXEC_COUNTERS.snapshot()
        out = {k: snap[k] for k in COUNTERS if snap[k]}
        if self.port and snap["warm_reruns"]:
            out["port_warm_reruns"] = snap["warm_reruns"]
        if reset:
            self.E.EXEC_COUNTERS.reset()
        return out


def vals(a) -> list:
    return np.asarray(a, np.uint32).tolist()


def stats_of(stats: dict) -> dict:
    return {k: (int(v) if not isinstance(v, bool) else v)
            for k, v in stats.items() if k in STATS}


def res(out) -> list:
    """[(values, stats), ...] -> comparable data."""
    return [(vals(v), stats_of(s)) for v, s in out]


def served(results) -> list:
    """QueryResults -> (values, algorithm, stats, sub keys) per query."""
    return [(vals(r.doc_ids), r.algorithm, stats_of(r.stats),
             [(repr(k), vals(v)) for k, v in r.stats.get("subexprs", ())])
            for r in results]


def sig_of(sig) -> tuple:
    return (sig.k, sig.ts, sig.gmaxes, sig.capacity_tier, sig.shards,
            sig.replicas, sig.cands, sig.eshape)


# -- data ------------------------------------------------------------------------

def corpus(api: Api, seed: int = 0):
    """Three overlapping sets big enough to split over 4 shards (t = 8, 9,
    10), as ``tests/test_sharded.py`` builds them."""
    rng = np.random.default_rng(seed)
    fam = api.hashing.random_hash_family(2, 256, seed=7)
    perm = api.hashing.default_permutation(7)
    common = rng.choice(1 << 24, 60, replace=False).astype(np.uint32)
    raw, idxs = {}, {}
    for name, n in [("a", 3000), ("b", 5000), ("c", 9000)]:
        s = np.unique(np.concatenate(
            [rng.choice(1 << 24, n, replace=False).astype(np.uint32),
             common]))
        raw[name] = s
        idxs[name] = api.partition.preprocess_prefix(s, w=256, m=2,
                                                     family=fam, perm=perm)
    return raw, idxs


def truth_of(raw, names) -> list:
    out = raw[names[0]]
    for n in names[1:]:
        out = np.intersect1d(out, raw[n])
    return vals(out)


def postings(api: Api):
    if api.port:
        from repro_torch.data.pipeline import inverted_index, zipf_corpus
    else:
        from repro.data.pipeline import inverted_index, zipf_corpus
    return inverted_index(zipf_corpus(2000, vocab=300, mean_len=30, seed=3))


def query_log(api: Api, index, n: int, seed: int):
    return api.S.zipf_query_log(sorted(index), n, seed=seed)


def expr_log(terms) -> list:
    """Expressions over the most frequent terms: unions, differences and
    mixes, each shape at least twice so buckets hold several rows."""
    t = [str(x) for x in sorted(terms)[:8]]
    return [f"({t[0]}|{t[1]})&{t[2]}", f"({t[3]}|{t[4]})&{t[5]}",
            f"{t[0]}|{t[6]}", f"{t[1]}|{t[7]}",
            f"({t[0]}&{t[3]})-{t[4]}", f"({t[1]}&{t[2]})-{t[5]}",
            f"({t[0]}|{t[1]}|{t[2]})-{t[3]}", f"{t[6]}-{t[7]}"]


def suggest_corpus(seed: int, n_sets: int = 12, lo: int = 300,
                   hi: int = 900) -> dict:
    """``tests/test_suggest.py``'s corpus, with forced exact ties."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(1 << 20, size=4000, replace=False)
    out = {sid: rng.choice(pool, size=int(rng.integers(lo, hi)),
                           replace=False).astype(np.uint32)
           for sid in range(n_sets)}
    out[100] = out[3].copy()
    out[101] = out[3].copy()
    return out


def oracle_topk(corpus_, sid: int, k: int) -> list:
    pairs = []
    for c in sorted(corpus_):
        if c != sid:
            n = len(np.intersect1d(corpus_[sid], corpus_[c]))
            if n >= 1:
                pairs.append((c, n))
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return pairs[:k]


# -- 1-D z-sharded cases -----------------------------------------------------------

def case_sharded_oracle(api: Api, names: str):
    raw, idxs = corpus(api)
    names = list(names)
    mesh = api.mesh(4)
    sets = {k: api.dset(v).shard(mesh) for k, v in idxs.items()}
    row = [sets[n] for n in names]
    api.fresh()
    batch = api.E.intersect_sharded_batch([row, row[::-1]], mesh)
    single = api.E.intersect_sharded(row, mesh)
    sharded_counters = api.delta()
    plain = api.device_batch([[api.dset(idxs[n]) for n in names]])
    return {"truth": truth_of(raw, names), "batch": res(batch),
            "single": res([single]), "plain": res(plain),
            "counters": sharded_counters}


def case_sharded_forced_overflow(api: Api, cap: int):
    raw, idxs = corpus(api)
    mesh = api.mesh(4)
    row = [api.dset(idxs[n]).shard(mesh) for n in "ab"]
    api.fresh()
    out = api.E.intersect_sharded_batch([row, row], mesh,
                                        capacity_per_shard=cap)
    return {"truth": truth_of(raw, "ab"), "out": res(out),
            "counters": api.delta()}


def case_sharded_per_query_overflow(api: Api):
    """Only the overflowing query re-runs: a bucket of a dense query and a
    same-shape disjoint twin, at a per-shard capacity between the two."""
    raw, idxs = corpus(api)
    mesh = api.mesh(4)
    sets = {k: api.dset(v).shard(mesh) for k, v in idxs.items()}
    rng = np.random.default_rng(99)
    twin_vals = np.unique(rng.choice(1 << 24, len(raw["a"]),
                                     replace=False).astype(np.uint32))
    twin = api.partition.preprocess_prefix(
        twin_vals, w=256, m=2, family=idxs["a"].family, perm=idxs["a"].perm,
        t=idxs["a"].t)
    dtwin = api.dset(twin).shard(mesh)
    q_dense, q_sparse = [sets["a"], sets["b"]], [dtwin, sets["b"]]
    api.fresh()
    probe = api.E.intersect_sharded_batch([q_dense, q_sparse], mesh)
    cap = probe[1][1]["max_shard_survivors"] + 1
    api.delta()
    out = api.E.intersect_sharded_batch([q_dense, q_sparse], mesh,
                                        capacity_per_shard=cap)
    return {"same_tier": (dtwin.t, dtwin.gmax) == (sets["a"].t,
                                                  sets["a"].gmax),
            "probe": res(probe), "cap": cap, "out": res(out),
            "truth": [truth_of(raw, "ab"),
                      vals(np.intersect1d(twin_vals, raw["b"]))],
            "counters": api.delta()}


def case_sharded_order_invariant(api: Api):
    raw, idxs = corpus(api)
    mesh = api.mesh(4)
    row = [api.dset(idxs[n]).shard(mesh) for n in "abc"]
    api.fresh()
    one = api.E.intersect_sharded(row, mesh)
    two = api.E.intersect_sharded(row[::-1], mesh)
    return {"truth": truth_of(raw, "abc"), "out": res([one, two]),
            "counters": api.delta()}


def case_sharded_search_engine(api: Api):
    post = postings(api)
    mesh = api.mesh(4)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=4,
                             **api.kw(mesh=mesh))
    log = query_log(api, eng.index, 48, seed=11)
    plans = [sig_of(p.sig) if p.sig else p.algorithm
             for p in map(eng.plan, log)]
    api.fresh()
    got = eng.query_batch(log)
    return {"plans": plans, "served": served(got), "counters": api.delta()}


def case_sharded_query_many(api: Api):
    """``BatchedEngine.query_many`` routes through the engine's sharded
    mirrors, and ``BatchedEngine.warm`` warms what it will run."""
    post = postings(api)
    mesh = api.mesh(4)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=4,
                             **api.kw(mesh=mesh))
    terms = sorted(eng.index)[:6]
    queries = [[api.name(terms[i]), api.name(terms[j])]
               for i, j in ((0, 1), (2, 3), (0, 4), (1, 5))]
    api.fresh()
    warmed = eng.device.warm(queries, top_k=8, b_tiers=(1, 2, 4))
    warm = api.delta()
    got = eng.device.query_many(queries)
    return {"warmed": [sig_of(s) for s in warmed], "warm": warm,
            "out": res(got), "counters": api.delta()}


def case_sharded_async(api: Api):
    post = postings(api)
    mesh = api.mesh(4)
    eng = api.S.AsyncSearchEngine(post, seed=3, shard_min_g=4, flush_tier=4,
                                  result_cache=0, **api.kw(mesh=mesh))
    log = query_log(api, eng.index, 24, seed=5)
    api.fresh()
    tickets = [eng.submit(q) for q in log]
    eng.drain()
    return {"done": all(t.done for t in tickets),
            "served": served([t.value for t in tickets]),
            "counters": api.delta()}


def case_sharded_warming(api: Api):
    post = postings(api)
    mesh = api.mesh(4)
    eng = api.S.AsyncSearchEngine(post, seed=3, shard_min_g=4, flush_tier=2,
                                  result_cache=0, **api.kw(mesh=mesh))
    sample = query_log(api, eng.index, 48, seed=13)
    api.fresh()
    warmed = eng.warm(sample, top_k=32, b_tiers=(1, 2))
    warm = api.delta()
    sharded = [s for s in warmed if s.shards == 4]
    q = next(q for q in sample if eng.plan(q).sig in sharded)
    ticket = eng.submit(q)
    eng.drain()
    return {"warmed": [sig_of(s) for s in warmed], "warm": warm,
            "query": q, "served": served([ticket.value]),
            "counters": api.delta()}


def _rerun_gap_lists():
    """``tests/test_torch_admission.py``'s lists: [0, 1] fits its capacity
    and [2, 3] (two equal lists) overflows; ``(4|5|6)&7`` (one list three
    times) fits its node buffers and ``(8|9|10)&11`` (three disjoint
    lists) overflows."""
    rng = np.random.default_rng(11)

    def draw(n):
        return np.unique(rng.choice(1 << 20, size=n,
                                    replace=False)).astype(np.uint32)

    a, b, c, d, e, f, g = (draw(3000) for _ in range(7))
    return {0: a, 1: b, 2: c, 3: c.copy(), 4: d, 5: d.copy(), 6: d.copy(),
            7: c.copy(), 8: e, 9: f, 10: g, 11: c.copy()}


def rerun_gap(api: Api, **layout):
    """Warm the representatives of a flat and an expression signature, then
    serve their overflowing siblings: the warm and serve counters."""
    lists = _rerun_gap_lists()
    eng = api.S.AsyncSearchEngine(lists, seed=3, result_cache=0, flush_tier=8,
                                  shard_min_g=4, **api.kw(**layout))
    flat_rep, flat_sib = [0, 1], [2, 3]
    expr_rep, expr_sib = (api.X.parse(q) for q in ("(4|5|6)&7",
                                                   "(8|9|10)&11"))
    same = (eng.plan(flat_rep).sig == eng.plan(flat_sib).sig,
            eng.plan(expr_rep).sig == eng.plan(expr_sib).sig)
    api.fresh()
    eng.warm([flat_rep, flat_sib, expr_rep, expr_sib], top_k=2,
             b_tiers=(1, 2))
    warm = api.delta()
    tickets = [eng.submit(flat_sib), eng.submit(expr_sib)]
    eng.drain()
    return {"same_sig": same, "sigs": [sig_of(eng.plan(q).sig) for q in
                                       (flat_rep, expr_rep)],
            "warm": warm, "served": served([t.value for t in tickets]),
            "counters": api.delta()}


def case_sharded_rerun_gap(api: Api):
    return rerun_gap(api, mesh=api.mesh(4))


def case_sharded_count(api: Api):
    corpus_ = suggest_corpus(seed=6)
    mesh = api.mesh(4)
    eng = api.S.SuggestEngine(corpus_, shard_min_g=1, mesh=mesh,
                              **({"device": "cpu"} if api.port else {}))
    api.fresh()
    out = [eng.suggest(sid, 6) for sid in (0, 3, 100)]
    counters = api.delta()
    # one bucket straight through the sharded count pass: a class plan's
    # probe and candidates, the candidates in both orders
    plan = next(p for p in eng._plans_for(0, 8) if p.algorithm == "device")
    probe, *cands = [eng.device.get_mesh_set(api.name(t))
                     for t in plan.terms]
    direct = api.E.intersect_count_sharded_batch(
        [(probe, cands), (probe, cands[::-1])], 8, mesh)
    return {"oracle": [oracle_topk(corpus_, sid, 6) for sid in (0, 3, 100)],
            "suggest": [(r.suggestions, r.algorithm) for r in out],
            "counters": counters,
            "direct": [(np.asarray(p).tolist(), stats_of(s))
                       for p, s in direct],
            "direct_counters": api.delta()}


def _overlapping_leaves(api: Api, seed: int):
    """``tests/test_expr.py``'s forced-overflow leaves: three sets sharing
    250 of their elements, preprocessed at depth 4 (16 z-groups, so they
    split over 4 shards)."""
    rng = np.random.default_rng(seed)
    fam = api.hashing.random_hash_family(2, 256, seed=7)
    perm = api.hashing.default_permutation(7)
    common = rng.choice(1 << 22, 250, replace=False).astype(np.uint32)
    sets = [np.unique(np.concatenate(
        [rng.choice(1 << 22, 400, replace=False).astype(np.uint32), common]))
        for _ in range(3)]
    return sets, [api.partition.preprocess_prefix(s, w=256, m=2, family=fam,
                                                  perm=perm, t=4)
                  for s in sets]


def case_sharded_expr_overflow(api: Api, cap: int):
    mesh = api.mesh(4)
    sets, idxs = _overlapping_leaves(api, 0)
    row = [api.dset(i).shard(mesh) for i in idxs]
    eshape = ("-", ("|", "T", "T"), "T")
    api.fresh()
    out = api.E.intersect_expr_sharded_batch([row, row], eshape, mesh,
                                             capacity_per_shard=cap)
    truth = np.setdiff1d(np.union1d(sets[0], sets[1]), sets[2])
    return {"truth": vals(truth), "out": res(out), "counters": api.delta()}


def case_sharded_expr_engine(api: Api):
    post = postings(api)
    mesh = api.mesh(4)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=4, result_cache=64,
                             **api.kw(mesh=mesh))
    log = expr_log(eng.index)
    plans = [sig_of(p.sig) if p.sig else p.algorithm
             for p in map(eng.plan, log)]
    api.fresh()
    got = eng.query_batch(log)
    again = eng.query_batch(log[:2])
    return {"plans": plans, "served": served(got),
            "again": [(vals(r.doc_ids), r.algorithm) for r in again],
            "counters": api.delta()}


# -- 2-D cases ----------------------------------------------------------------------

def case_mesh2d_oracle(api: Api, layout):
    raw, idxs = corpus(api)
    topo = api.topology(*layout)
    sets = {k: api.replicated(v, topo) for k, v in idxs.items()}
    out = {}
    api.fresh()
    for names in ("ab", "bc", "abc"):
        row = [sets[n] for n in names]
        got = api.E.intersect_mesh2d_batch([row, row[::-1], row], topo)
        out[names] = (truth_of(raw, names), res(got))
    return {"out": out, "counters": api.delta()}


def case_mesh2d_spread_rows(api: Api):
    _, idxs = corpus(api)
    topo = api.topology(4, 1)
    sets = {k: api.replicated(v, topo) for k, v in idxs.items()}
    row = [sets["a"], sets["b"]]
    cap = 1 << max(sets["a"].t, sets["b"].t)
    api.fresh()
    eight = api.E.intersect_mesh2d_batch([row] * 8, topo,
                                         capacity_per_shard=cap)
    c8 = api.delta()
    one = api.E.intersect_mesh2d_batch([row], topo, capacity_per_shard=cap)
    return {"eight": res(eight), "c8": c8, "one": res(one),
            "c1": api.delta()}


def case_mesh2d_forced_overflow(api: Api, layout):
    raw, idxs = corpus(api)
    topo = api.topology(*layout)
    sets = {k: api.replicated(v, topo) for k, v in idxs.items()}
    row = [sets["a"], sets["b"]]
    api.fresh()
    out = api.E.intersect_mesh2d_batch([row] * 4, topo, capacity_per_shard=2)
    return {"truth": truth_of(raw, "ab"), "out": res(out),
            "counters": api.delta()}


def case_mesh2d_search_engine(api: Api, layout):
    post = postings(api)
    topo = api.topology(*layout)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=4,
                             **api.kw(topology=topo))
    log = query_log(api, eng.index, 32, seed=11)
    plans = [sig_of(p.sig) if p.sig else p.algorithm
             for p in map(eng.plan, log)]
    api.fresh()
    got = eng.query_batch(log)
    return {"plans": plans, "served": served(got), "counters": api.delta(),
            "loads": [d["dispatched"] for d in topo.load_snapshot()]}


def case_mesh2d_balancer_spread(api: Api):
    """The mesh threshold out of reach: every bucket is single-device and
    the balancer spreads them over the replica rows."""
    post = postings(api)
    topo = api.topology(4, 1)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=1 << 20,
                             **api.kw(topology=topo))
    log = query_log(api, eng.index, 48, seed=11)
    api.fresh()
    got = eng.query_batch(log)
    return {"served": served(got), "counters": api.delta(),
            "loads": [(d["dispatched"], d["weight"], d["in_flight"])
                      for d in topo.load_snapshot()]}


def case_mesh2d_query_many(api: Api):
    post = postings(api)
    topo = api.topology(2, 2)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=1 << 20,
                             **api.kw(topology=topo))
    names = [api.name(t) for t in sorted(eng.index)[:4]]
    queries = [[names[0], names[1]], [names[2], names[3]],
               [names[0], names[2]]]
    api.fresh()
    got = eng.device.query_many(queries)
    return {"out": res(got), "counters": api.delta()}


def case_mesh2d_async(api: Api):
    post = postings(api)
    topo = api.topology(2, 2)
    eng = api.S.AsyncSearchEngine(post, seed=3, shard_min_g=4, flush_tier=4,
                                  result_cache=0, **api.kw(topology=topo))
    log = query_log(api, eng.index, 24, seed=5)
    api.fresh()
    tickets = [eng.submit(q) for q in log]
    eng.drain()
    return {"done": all(t.done for t in tickets),
            "served": served([t.value for t in tickets]),
            "counters": api.delta()}


def case_mesh2d_warming(api: Api):
    post = postings(api)
    topo = api.topology(2, 2)
    eng = api.S.AsyncSearchEngine(post, seed=3, shard_min_g=4, flush_tier=2,
                                  result_cache=0, **api.kw(topology=topo))
    sample = query_log(api, eng.index, 48, seed=13)
    api.fresh()
    warmed = eng.warm(sample, top_k=32, b_tiers=(1, 2))
    warm = api.delta()
    mesh_warmed = [s for s in warmed if s.replicas == 2 and s.shards == 2]
    q = next(q for q in sample if eng.plan(q).sig in mesh_warmed)
    first = eng.submit(q)
    eng.drain()
    c1 = api.delta()
    second = eng.submit(q)
    eng.drain()
    return {"warmed": [sig_of(s) for s in warmed], "warm": warm, "query": q,
            "first": served([first.value]), "c1": c1,
            "second": served([second.value]), "c2": api.delta()}


def case_mesh2d_rerun_gap(api: Api):
    return rerun_gap(api, topology=api.topology(2, 2))


def _two_buckets(api: Api, eng, n: int):
    log = query_log(api, eng.index, n, seed=11)
    plans = [(i, eng.plan(q)) for i, q in enumerate(log)]
    buckets = api.B.bucket_plans([(i, p) for i, p in plans
                                  if p.algorithm == "device"])
    return log, buckets


def _routing(api: Api, eng) -> dict:
    if api.port:
        return eng.device.routing()
    dev = eng.device
    return {"mesh": dev.mesh, "shard_axis": dev.shard_axis,
            "get_sharded_set": lambda t: dev.get_mesh_set(str(t)),
            "topology": dev.topology,
            "get_replica_set": lambda r, t: dev.get_replica_set(r, str(t))}


def case_mesh2d_inflight_visible(api: Api):
    """Two dispatched, uncollected buckets hold weight on two rows; both
    collects give it back."""
    post = postings(api)
    topo = api.topology(2, 1)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=1 << 20,
                             **api.kw(topology=topo))
    log, buckets = _two_buckets(api, eng, 32)
    sigs = list(buckets)
    get_set = lambda t: eng.device.sets[api.name(t)]  # noqa: E731
    kw = _routing(api, eng)
    if api.port:
        kw["device"] = "cpu"
    api.fresh()
    a = api.B.dispatch_bucket(get_set, sigs[0], buckets[sigs[0]], **kw)
    b = api.B.dispatch_bucket(get_set, sigs[1], buckets[sigs[1]], **kw)
    busy = [d["in_flight"] for d in topo.load_snapshot()]
    got = dict(a.collect())
    got.update(b.collect())
    after = [d["in_flight"] for d in topo.load_snapshot()]
    a.collect()
    again = [d["in_flight"] for d in topo.load_snapshot()]
    return {"busy": busy, "after": after, "again": again,
            "out": {i: (vals(v), stats_of(s)) for i, (v, s) in got.items()},
            "counters": api.delta()}


def case_mesh2d_release_on_failure(api: Api):
    post = postings(api)
    topo = api.topology(2, 1)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=1 << 20,
                             **api.kw(topology=topo))
    _, buckets = _two_buckets(api, eng, 8)
    sig = next(iter(buckets))
    kw = _routing(api, eng)
    if api.port:
        kw["device"] = "cpu"

    def broken(r, t):
        raise RuntimeError("mirror build failed")

    kw["get_replica_set"] = broken
    api.fresh()
    try:
        api.B.dispatch_bucket(lambda t: eng.device.sets[api.name(t)], sig,
                              buckets[sig], **kw)
    except RuntimeError as exc:
        raised = str(exc)
    else:
        raised = None
    return {"raised": raised,
            "loads": [(d["in_flight"], d["failures"], d["dispatched"])
                      for d in topo.load_snapshot()],
            "counters": api.delta()}


def case_mesh2d_count(api: Api, layout):
    corpus_ = suggest_corpus(seed=7)
    topo = api.topology(*layout)
    eng = api.S.SuggestEngine(corpus_, shard_min_g=1, topology=topo,
                              **({"device": "cpu"} if api.port else {}))
    api.fresh()
    batch = eng.suggest_batch([(0, 6), (3, 6), (100, 6), (5, 3)])
    return {"oracle": [oracle_topk(corpus_, sid, k)
                       for sid, k in ((0, 6), (3, 6), (100, 6), (5, 3))],
            "suggest": [(r.suggestions, r.algorithm) for r in batch],
            "counters": api.delta()}


def case_mesh2d_count_balancer(api: Api):
    """Single-device count buckets on a topology of four replicas go to
    the balancer; warming runs them on every row first."""
    corpus_ = suggest_corpus(seed=7)
    topo = api.topology(4, 1)
    eng = api.S.SuggestEngine(corpus_, shard_min_g=1 << 20, topology=topo,
                              **({"device": "cpu"} if api.port else {}))
    api.fresh()
    warmed = eng.warm([0, 3, 5], 6, b_tiers=(1, 2))
    warm = api.delta()
    batch = eng.suggest_batch([(0, 6), (3, 6), (5, 6)])
    return {"warmed": [sig_of(s) for s in warmed], "warm": warm,
            "suggest": [(r.suggestions, r.algorithm) for r in batch],
            "counters": api.delta(),
            "loads": [d["dispatched"] for d in topo.load_snapshot()]}


def case_mesh2d_expr_overflow(api: Api, layout):
    topo = api.topology(*layout)
    sets, idxs = _overlapping_leaves(api, 1)
    row = [api.replicated(i, topo) for i in idxs]
    eshape = ("-", ("|", "T", "T"), "T")
    api.fresh()
    out = api.E.intersect_expr_mesh2d_batch([row, row, row], eshape, topo,
                                            capacity_per_shard=2)
    truth = np.setdiff1d(np.union1d(sets[0], sets[1]), sets[2])
    return {"truth": vals(truth), "out": res(out), "counters": api.delta()}


def case_mesh2d_expr_engine(api: Api, layout):
    post = postings(api)
    topo = api.topology(*layout)
    eng = api.S.SearchEngine(post, seed=3, shard_min_g=4, result_cache=64,
                             **api.kw(topology=topo))
    log = expr_log(eng.index)
    api.fresh()
    got = eng.query_batch(log)
    return {"served": served(got), "counters": api.delta()}


# -- running ----------------------------------------------------------------------

CASES = {
    "sharded_oracle": ("ab", "bc", "ac", "abc"),
    "sharded_forced_overflow": (1, 2, 7),
    "sharded_per_query_overflow": (None,),
    "sharded_order_invariant": (None,),
    "sharded_search_engine": (None,),
    "sharded_query_many": (None,),
    "sharded_async": (None,),
    "sharded_warming": (None,),
    "sharded_rerun_gap": (None,),
    "sharded_count": (None,),
    "sharded_expr_overflow": (2, 16),
    "sharded_expr_engine": (None,),
    "mesh2d_oracle": LAYOUTS,
    "mesh2d_spread_rows": (None,),
    "mesh2d_forced_overflow": LAYOUTS,
    "mesh2d_search_engine": LAYOUTS,
    "mesh2d_balancer_spread": (None,),
    "mesh2d_query_many": (None,),
    "mesh2d_async": (None,),
    "mesh2d_warming": (None,),
    "mesh2d_rerun_gap": (None,),
    "mesh2d_inflight_visible": (None,),
    "mesh2d_release_on_failure": (None,),
    "mesh2d_count": LAYOUTS,
    "mesh2d_count_balancer": (None,),
    "mesh2d_expr_overflow": LAYOUTS,
    "mesh2d_expr_engine": LAYOUTS,
}


def case_ids(prefix: str) -> list:
    """(case name, parameter) pairs of the cases named ``prefix*``."""
    return [(name, arg) for name, args in CASES.items()
            if name.startswith(prefix) for arg in args]


def run(api: Api, name: str, arg):
    fn = globals()["case_" + name]
    return fn(api) if arg is None else fn(api, arg)


def run_all(api: Api, prefix: str) -> dict:
    """Every ``prefix*`` case; a case that raises records its traceback."""
    out = {}
    for name, arg in case_ids(prefix):
        try:
            out[(name, arg)] = ("ok", run(api, name, arg))
        except Exception:  # reported by the test that reads the case
            out[(name, arg)] = ("error", traceback.format_exc())
    return out


# -- the tests' side ---------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent
# counter families and the counter that names each family's first sightings
TRACES = {"batch_calls": "batch_traces", "sharded_calls": "sharded_traces",
          "mesh2d_calls": "mesh2d_traces", "expr_calls": "expr_traces"}


def run_jax_cases(tmp_dir: pathlib.Path, prefix: str) -> dict:
    """Every ``prefix*`` case on the JAX package with eight forced host
    devices, in a subprocess writing under ``tmp_dir``: {(name, arg):
    (status, result)}."""
    out = tmp_dir / "results.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_cases.py"),
         str(out), prefix], env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def both(jax_results: dict, name: str, arg=None):
    """(JAX result, port result) of one case."""
    status, jax = jax_results[(name, arg)]
    assert status == "ok", jax
    return jax, run(port_api(), name, arg)


def assert_warm_differs_only_by_reruns(jax_warm: dict, port_warm: dict):
    """Warm counters equal but for the port's re-run passes: each adds one
    pass to its family's calls (and its rows to ``mesh2d_row_dispatches``)
    and at least one first sighting to the family's traces."""
    port_warm = dict(port_warm)
    reruns = port_warm.pop("port_warm_reruns", 0)
    extra = {k: port_warm.get(k, 0) - jax_warm.get(k, 0)
             for k in set(jax_warm) | set(port_warm)}
    extra = {k: v for k, v in extra.items() if v}
    assert all(v > 0 for v in extra.values()), extra
    assert set(extra) <= set(TRACES) | set(TRACES.values()) | {
        "mesh2d_row_dispatches"}, extra
    assert sum(extra.get(k, 0) for k in TRACES) == reruns, (extra, reruns)
    for calls, traces in TRACES.items():
        assert extra.get(traces, 0) >= extra.get(calls, 0), extra
    return reruns


_port = []


def port_api() -> Api:
    """The port's :class:`Api` (made on first use: the JAX subprocess that
    imports this module never loads the port)."""
    if not _port:
        _port.append(Api("torch"))
    return _port[0]


def main(argv) -> int:
    """``python _torch_mesh_cases.py OUT PREFIX``: the JAX package's
    results of every ``PREFIX*`` case, pickled to OUT.  Set
    ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and
    ``JAX_PLATFORMS=cpu`` first."""
    out_path, prefix = argv
    results = run_all(Api("jax"), prefix)
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
