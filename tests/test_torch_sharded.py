"""The port's z-sharded execution on the CPU, against the JAX package,
mirroring ``tests/test_sharded.py`` and the sharded cases of
``tests/test_expr.py`` and ``tests/test_suggest.py``.

The JAX side needs several devices, so it runs once per module in a
subprocess with eight forced host devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=8``, ``JAX_PLATFORMS=cpu``), which
runs every ``sharded_*`` case of ``tests/_torch_mesh_cases.py`` and pickles
the results.  The port runs the same cases in-process on a mesh of four
logical shards on the CPU (``make_shard_mesh(4, devices=["cpu"] * 4)``).
Values, the shared stats (``r``, ``tuples_survived``,
``max_shard_survivors``, ``capacity_per_shard``, ``n_shards``, ...) and
the counter deltas (``sharded_*``, ``batch_*``, ``count_*``, ``expr_*``)
must be equal (tolerance 0: all are integers).  The one difference is the
port's deliberate re-run warming (``warm_reruns``), stated by
:func:`test_sharded_warming_differs_from_jax_only_by_the_rerun_pass`.
Planner and capacity rules are metadata only and compare in-process.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from repro.core.engine import (
    default_capacity_per_shard as jax_capacity_per_shard,
    default_expr_capacity_per_shard as jax_expr_capacity_per_shard,
)
from repro.exec.plan import plan_query as jax_plan_query
from repro.exec.plan import plan_suggest as jax_plan_suggest
from repro.exec.expr import parse as jax_parse

from repro_torch.core.engine import (
    DeviceSet, default_capacity_per_shard, default_expr_capacity_per_shard,
    intersect_sharded_batch, make_shard_mesh,
)
from repro_torch.exec.expr import parse
from repro_torch.exec.plan import plan_query, plan_suggest

PORT = cases.port_api()
both = cases.both
assert_warm_differs_only_by_reruns = cases.assert_warm_differs_only_by_reruns


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return cases.run_jax_cases(tmp_path_factory.mktemp("jax"), "sharded")


# ---------------------------------------------------------------------------
# bucket passes against JAX and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", ["ab", "bc", "ac", "abc"])
def test_sharded_batch_matches_jax_and_oracle(jax_results, names):
    jax, port = both(jax_results, "sharded_oracle", names)
    assert port == jax
    for values, stats in port["batch"] + port["single"]:
        assert values == port["truth"]
        assert stats["r"] == len(port["truth"])
        assert stats["n_shards"] == 4
    assert port["plain"][0][0] == port["truth"]
    assert (port["single"][0][1]["tuples_survived"]
            == port["plain"][0][1]["tuples_survived"])
    counters = port["counters"]
    assert counters["sharded_calls"] == 2 + counters.get(
        "sharded_rerun_calls", 0)


def test_sharded_mixed_signature_rejected():
    _, idxs = cases.corpus(PORT)
    mesh = make_shard_mesh(4, devices=["cpu"] * 4)
    sets = {k: DeviceSet.from_host(v, "cpu").shard(mesh)
            for k, v in idxs.items()}
    with pytest.raises(ValueError, match="mixes shape signatures"):
        intersect_sharded_batch([[sets["a"], sets["b"]],
                                 [sets["a"], sets["c"]]], mesh)


@pytest.mark.parametrize("cap", [1, 2, 7])
def test_sharded_forced_overflow_rerun_is_exact(jax_results, cap):
    """Per-shard survivors past ``capacity_per_shard``: one re-run at the
    local group count, results exact, counters equal to JAX's."""
    jax, port = both(jax_results, "sharded_forced_overflow", cap)
    assert port == jax
    for values, stats in port["out"]:
        assert values == port["truth"]
        assert stats["capacity_per_shard"] > cap
    assert port["counters"]["sharded_rerun_calls"] == 1
    assert port["counters"]["sharded_calls"] == 2


def test_sharded_overflow_flags_are_per_query(jax_results):
    jax, port = both(jax_results, "sharded_per_query_overflow")
    assert port == jax
    assert port["same_tier"]
    (dense, dense_stats), (sparse, sparse_stats) = port["out"]
    assert [dense, sparse] == port["truth"]
    assert port["counters"]["sharded_rerun_calls"] == 1
    # the sparse query resolved in the 2-query pass, the dense one re-ran
    assert sparse_stats["batch_size"] == 2
    assert dense_stats["batch_size"] == 1


def test_sharded_order_invariant_and_stats_match(jax_results):
    jax, port = both(jax_results, "sharded_order_invariant")
    assert port == jax
    (v1, s1), (v2, s2) = port["out"]
    assert v1 == v2 == port["truth"]
    assert s1 == s2


# ---------------------------------------------------------------------------
# planner and capacity rules (metadata: in-process against JAX)
# ---------------------------------------------------------------------------

def test_plan_shard_routing_matches_jax():
    _, idxs = cases.corpus(PORT)
    fam, perm = idxs["a"].family, idxs["a"].perm
    tiny = PORT.partition.preprocess_prefix(
        np.arange(1, 9, dtype=np.uint32), w=256, m=2, family=fam, perm=perm,
        t=1)
    mixed = dict(idxs, tiny=tiny)
    calls = [(idxs, ["a", "b"], dict(mesh_shards=4, shard_min_g=64)),
             (idxs, ["a", "b"], dict(mesh_shards=4, shard_min_g=1 << 20)),
             (idxs, ["a", "b"], {}),
             (mixed, ["tiny", "c"], dict(hashbin_ratio=float("inf"),
                                         mesh_shards=4, shard_min_g=64))]
    sigs = []
    for index, terms, kw in calls:
        port = plan_query(index, terms, **kw).sig
        jax = jax_plan_query(index, terms, **kw).sig
        assert cases.sig_of(port) == cases.sig_of(jax)
        sigs.append(port.shards)
    assert sigs == [4, 1, 1, 1]


def test_plan_expr_and_suggest_shard_min_g_routing_matches_jax():
    """Expressions route to the mesh only when every leaf splits and the
    largest clears ``shard_min_g``; suggest rows when both z axes split and
    the deeper one clears it."""
    _, idxs = cases.corpus(PORT)
    fam, perm = idxs["a"].family, idxs["a"].perm
    idxs = dict(idxs, tiny=PORT.partition.preprocess_prefix(
        np.arange(1, 9, dtype=np.uint32), w=256, m=2, family=fam, perm=perm,
        t=1))
    routed = []
    for text in ("(a|b)&c", "(a|tiny)&c", "a-b"):
        for kw in (dict(mesh_shards=4, shard_min_g=64),
                   dict(mesh_shards=2, mesh_replicas=2, shard_min_g=64),
                   dict(mesh_shards=4, shard_min_g=1 << 20)):
            port = plan_query(idxs, parse(text), **kw)
            jax = jax_plan_query(idxs, jax_parse(text), **kw)
            assert cases.sig_of(port.sig) == cases.sig_of(jax.sig), text
            routed.append((port.sig.shards, port.sig.replicas))
    # tiny's 2 z-groups split over 2 shards, not over 4
    assert routed == [(4, 1), (2, 2), (1, 1), (1, 1), (2, 2), (1, 1),
                      (4, 1), (2, 2), (1, 1)]
    for probe, cands in (("a", ["b"]), ("c", ["a"]), ("tiny", ["a"])):
        for kw in (dict(mesh_shards=4, shard_min_g=64),
                   dict(mesh_shards=4, shard_min_g=1 << 20)):
            port = plan_suggest(idxs, probe, cands, 8, **kw)
            jax = jax_plan_suggest(idxs, probe, cands, 8, **kw)
            assert cases.sig_of(port.sig) == cases.sig_of(jax.sig)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_capacity_per_shard_matches_jax(n_shards):
    for ts in ((8, 10), (4, 4), (12,)):
        for capacity in (None, 16, 64, 4096):
            cap = default_capacity_per_shard(ts, n_shards, capacity=capacity)
            assert cap == jax_capacity_per_shard(ts, n_shards,
                                                 capacity=capacity)
            assert cap <= (1 << ts[-1]) // n_shards
        gmaxes = (8,) * len(ts)
        assert (default_expr_capacity_per_shard(ts, gmaxes, n_shards)
                == jax_expr_capacity_per_shard(ts, gmaxes, n_shards))


# ---------------------------------------------------------------------------
# shard mirrors and meshes (the port's own layout)
# ---------------------------------------------------------------------------

def test_shard_mirrors_are_views_on_a_shared_device():
    _, idxs = cases.corpus(PORT)
    ds = DeviceSet.from_host(idxs["c"], "cpu")
    mesh = make_shard_mesh(4, devices=["cpu"] * 4)
    sharded = ds.shard(mesh)
    gl = (1 << ds.t) // 4
    assert sharded.mesh is mesh and len(sharded.parts) == 4
    for s, (vals, images) in enumerate(sharded.parts):
        assert vals.data_ptr() == ds.vals[s * gl].data_ptr()
        assert images.data_ptr() == ds.images[s * gl].data_ptr()
        assert vals.is_contiguous() and vals.shape == (gl, ds.gmax)
    assert ds.place("cpu") is ds
    assert ds.shardable(4) and not ds.shardable(3)
    with pytest.raises(ValueError, match="do not split"):
        ds.shard(make_shard_mesh(3, devices=["cpu"] * 3))


def test_mesh_repeats_a_device_only_when_listed():
    mesh = make_shard_mesh(4, devices=["cpu"] * 4)
    assert mesh.shape == {"shard": 4}
    assert mesh.axis_devices("shard") == [torch.device("cpu")] * 4
    assert make_shard_mesh(devices=["cpu"]).shape == {"shard": 1}
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_shard_mesh(4, devices=["cpu"])


def test_mesh_of_cuda_devices_raises_without_gpu():
    """No fallback hides the device: a mesh over the visible CUDA devices,
    or one listing CUDA devices, raises where there is no GPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        make_shard_mesh(4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_shard_mesh(4, devices=["cuda:0"] * 4)


# ---------------------------------------------------------------------------
# engines end to end
# ---------------------------------------------------------------------------

def test_search_engine_sharded_matches_jax(jax_results):
    jax, port = both(jax_results, "sharded_search_engine")
    assert port == jax
    assert any(isinstance(p, tuple) and p[4] == 4 for p in port["plans"])
    assert any(algo == "rangroupscan/sharded"
               for _, algo, _, _ in port["served"])
    # the sharded answers equal the single-device engine's
    post = cases.postings(PORT)
    base = PORT.S.SearchEngine(post, seed=3, device="cpu")
    log = cases.query_log(PORT, base.index, 48, seed=11)
    for (values, _, _, _), want in zip(port["served"], base.query_batch(log)):
        assert values == cases.vals(want.doc_ids)


def test_query_many_and_warm_sharded_match_jax(jax_results):
    jax, port = both(jax_results, "sharded_query_many")
    port_warm = port.pop("warm")
    jax_warm = jax.pop("warm")
    assert port == jax
    assert_warm_differs_only_by_reruns(jax_warm, port_warm)
    assert "sharded_traces" not in port["counters"]


def test_async_engine_sharded_matches_jax(jax_results):
    jax, port = both(jax_results, "sharded_async")
    assert port == jax
    assert port["done"]


def test_sharded_warming_zero_traces_at_serve_time(jax_results):
    jax, port = both(jax_results, "sharded_warming")
    port_warm, jax_warm = port.pop("warm"), jax.pop("warm")
    assert port == jax
    assert_warm_differs_only_by_reruns(jax_warm, port_warm)
    assert any(sig[4] == 4 for sig in port["warmed"])
    assert port["counters"]["sharded_calls"] >= 1
    assert "sharded_traces" not in port["counters"]
    assert "batch_traces" not in port["counters"]


def test_sharded_warming_differs_from_jax_only_by_the_rerun_pass(jax_results):
    """The port's deliberate difference, on the sharded arms: warming a
    flat and an expression representative that fit their per-shard
    buffers also runs them at the re-run's capacity (the local group count,
    the local total leaf width) per tier, so serving their overflowing
    siblings traces nothing, where the JAX package traces each re-run
    once.  Answers, stats and every other counter stay equal."""
    jax, port = both(jax_results, "sharded_rerun_gap")
    assert port["same_sig"] == jax["same_sig"] == (True, True)
    assert [s[4] for s in port["sigs"]] == [4, 4]
    assert port["served"] == jax["served"]
    assert port["sigs"] == jax["sigs"]
    assert assert_warm_differs_only_by_reruns(jax["warm"], port["warm"]) == 4
    assert jax["counters"].pop("sharded_traces") == 1
    assert jax["counters"].pop("expr_traces") == 1
    assert port["counters"] == jax["counters"]
    assert port["counters"]["sharded_rerun_calls"] == 1
    assert port["counters"]["expr_rerun_calls"] == 1


def test_suggest_sharded_matches_jax_and_oracle(jax_results):
    jax, port = both(jax_results, "sharded_count")
    assert port == jax
    assert [s for s, _ in port["suggest"]] == [
        [tuple(p) for p in o] for o in port["oracle"]]
    assert {a for _, a in port["suggest"]} == {"suggest/sharded"}
    assert all(s["n_shards"] == 4 for _, s in port["direct"])


@pytest.mark.parametrize("cap", [2, 16])
def test_expr_sharded_forced_overflow_is_exact(jax_results, cap):
    jax, port = both(jax_results, "sharded_expr_overflow", cap)
    assert port == jax
    for values, stats in port["out"]:
        assert values == port["truth"]
        assert stats["r"] == len(port["truth"])
    assert port["counters"]["expr_rerun_calls"] >= 1


def test_expr_sharded_engine_matches_jax(jax_results):
    """Expression buckets z-sharded through ``query_batch``, subexpression
    values included, then the cache answering a repeat."""
    jax, port = both(jax_results, "sharded_expr_engine")
    assert port == jax
    assert {a for _, a, _, _ in port["served"]} == {"expr/sharded"}
    post = cases.postings(PORT)
    eng = PORT.S.SearchEngine(post, seed=3, device="cpu")
    for (values, _, _, _), q in zip(port["served"],
                                    cases.expr_log(eng.index)):
        want = PORT.X.eval_host(parse(q), lambda t: post[t])
        assert values == cases.vals(want)
