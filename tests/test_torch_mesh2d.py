"""The port's 2-D execution (replica rows x z-shards) on the CPU, against
the JAX package, mirroring ``tests/test_mesh2d.py``, the balancer cases of
``tests/test_async_dispatch.py`` and the 2-D cases of
``tests/test_expr.py`` and ``tests/test_suggest.py``.

As in ``tests/test_torch_sharded.py``: every ``mesh2d_*`` case of
``tests/_torch_mesh_cases.py`` runs once on the JAX package in a
subprocess with eight forced host devices, and on the port in-process
over the 1x4, 2x2 and 4x1 layouts of logical CPU devices
(``make_topology(r, s, devices=["cpu"] * (r * s))``).  Values, the shared
stats (``r``, ``tuples_survived``, ``max_shard_survivors``,
``capacity_per_shard``, ``n_shards``, ``n_replicas``, ``replica``, ...),
the counter deltas (``mesh2d_*``, ``replica_dispatches``, ``count_*``,
``expr_*``) and the balancer's accounting must be equal (tolerance 0).
The balancer and the planner are pure Python and compare in-process.
"""
import threading

import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from repro.exec.plan import plan_query as jax_plan_query
from repro.exec.topology import ReplicaBalancer as JaxReplicaBalancer

from repro_torch.core.engine import (
    ReplicatedDeviceSet, intersect_mesh2d_batch, make_mesh2d,
)
from repro_torch.exec.plan import plan_query
from repro_torch.exec.topology import ReplicaBalancer, make_topology
from repro_torch.serve.search import AsyncSearchEngine, SearchEngine

LAYOUTS = cases.LAYOUTS
PORT = cases.port_api()
both = cases.both
assert_warm_differs_only_by_reruns = cases.assert_warm_differs_only_by_reruns


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return cases.run_jax_cases(tmp_path_factory.mktemp("jax"), "mesh2d")


# ---------------------------------------------------------------------------
# replica balancer (pure Python, in-process against JAX)
# ---------------------------------------------------------------------------

def _drive_balancer(bal):
    """``tests/test_mesh2d.py``'s least-loaded script: the picks, then the
    accounting."""
    picks = [bal.acquire(10.0), bal.acquire(1.0), bal.acquire(1.0)]
    bal.release(1, 1.0)
    picks.append(bal.acquire(1.0))
    bal.release(2, 99.0)  # never below 0
    bal.release(0, 4.0, failed=True)
    return picks, bal.loads()


def test_balancer_least_loaded_pick_and_release_matches_jax():
    picks, loads = _drive_balancer(ReplicaBalancer(3))
    jax_picks, jax_loads = _drive_balancer(JaxReplicaBalancer(3))
    assert picks == jax_picks == [0, 1, 2, 1]
    assert loads == jax_loads
    assert [d["dispatched"] for d in loads] == [1, 2, 1]
    assert loads[0]["in_flight"] == 6.0 and loads[0]["failures"] == 1
    assert loads[2]["in_flight"] == 0.0


def test_balancer_idle_round_robin_matches_jax():
    """acquire -> release with nothing in flight spreads equal buckets
    evenly; unequal weights spread by cumulative weight."""
    out = []
    for bal in (ReplicaBalancer(4), JaxReplicaBalancer(4)):
        for w in [5.0] * 12 + [1.0, 64.0, 1.0, 1.0, 4096.0]:
            r = bal.acquire(w)
            bal.release(r, w)
        out.append(bal.loads())
    assert out[0] == out[1]
    assert [d["dispatched"] for d in out[0]][:4] != [0, 0, 0, 0]
    bal = ReplicaBalancer(4)
    for _ in range(12):
        bal.release(bal.acquire(5.0), 5.0)
    assert [d["dispatched"] for d in bal.loads()] == [3, 3, 3, 3]
    bal.reset()
    assert all(d["dispatched"] == 0 for d in bal.loads())


# ---------------------------------------------------------------------------
# planner routing by (shards, replicas): metadata, in-process against JAX
# ---------------------------------------------------------------------------

def test_plan_routes_by_shards_and_replicas_matches_jax():
    _, idxs = cases.corpus(PORT)
    fam, perm = idxs["a"].family, idxs["a"].perm
    tiny = PORT.partition.preprocess_prefix(
        np.arange(1, 9, dtype=np.uint32), w=256, m=2, family=fam, perm=perm,
        t=1)
    mixed = dict(idxs, tiny=tiny)
    calls = [(idxs, ["a", "b"], dict(mesh_shards=2, mesh_replicas=2,
                                     shard_min_g=64)),
             (idxs, ["a", "b"], dict(mesh_shards=1, mesh_replicas=4,
                                     shard_min_g=64)),
             (idxs, ["a", "b"], dict(mesh_shards=2, mesh_replicas=2,
                                     shard_min_g=1 << 20)),
             (mixed, ["tiny", "c"], dict(hashbin_ratio=float("inf"),
                                         mesh_shards=4, mesh_replicas=2,
                                         shard_min_g=64))]
    layouts = []
    for index, terms, kw in calls:
        port, jax = (plan_query(index, terms, **kw).sig,
                     jax_plan_query(index, terms, **kw).sig)
        assert cases.sig_of(port) == cases.sig_of(jax)
        layouts.append((port.shards, port.replicas))
    assert layouts == [(2, 2), (1, 4), (1, 1), (1, 1)]
    sigs = {plan_query(idxs, ["a", "b"], mesh_shards=s, mesh_replicas=r,
                       shard_min_g=64).sig
            for r, s in LAYOUTS + ((1, 1),)}
    assert len(sigs) == 4


# ---------------------------------------------------------------------------
# topology layout (the port's own: explicit, repeatable devices)
# ---------------------------------------------------------------------------

def test_topology_layout_and_row_meshes():
    topo = make_topology(2, 2, devices=["cpu"] * 4)
    assert (topo.replicas, topo.shards) == (2, 2)
    assert topo.describe() == "2x2"
    assert topo.row_mesh(0) is topo.row_mesh(0)
    assert topo.row_mesh(0) is not topo.row_mesh(1)
    assert topo.row_mesh(1).shape == {"shard": 2}
    assert topo.replica_device(1) == topo.replica_devices(1)[0]
    assert topo.replica_devices(0) == [torch.device("cpu")] * 2
    mesh = make_mesh2d(2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "shard": 4}


def test_mesh2d_replicas_must_be_pow2():
    with pytest.raises(ValueError, match="power of two"):
        make_mesh2d(3, 2, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="need 2x4 = 8 devices"):
        make_mesh2d(2, 4, devices=["cpu"] * 4)


def test_topology_of_cuda_devices_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        make_topology(2, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        make_topology(2, 2, devices=["cuda:0"] * 4)


def test_mesh2d_mixed_signature_rejected():
    _, idxs = cases.corpus(PORT)
    topo = make_topology(2, 2, devices=["cpu"] * 4)
    sets = {k: PORT.replicated(v, topo) for k, v in idxs.items()}
    assert isinstance(sets["a"], ReplicatedDeviceSet)
    with pytest.raises(ValueError, match="mixes shape signatures"):
        intersect_mesh2d_batch([[sets["a"], sets["b"]],
                                [sets["a"], sets["c"]]], topo)


# ---------------------------------------------------------------------------
# bucket passes against JAX and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_mesh2d_matches_jax_and_oracle(jax_results, layout):
    jax, port = both(jax_results, "mesh2d_oracle", layout)
    assert port == jax
    for names, (truth, out) in port["out"].items():
        for values, stats in out:
            assert values == truth, names
            assert stats["n_shards"] == layout[1]
            assert stats["n_replicas"] == layout[0]
        assert len({s["tuples_survived"] for _, s in out}) == 1


def test_mesh2d_spreads_batch_rows_over_replicas(jax_results):
    jax, port = both(jax_results, "mesh2d_spread_rows")
    assert port == jax
    assert [s["replica"] for _, s in port["eight"]] == [0, 0, 1, 1, 2, 2,
                                                       3, 3]
    assert port["c8"]["mesh2d_calls"] == 1
    assert port["c8"]["mesh2d_row_dispatches"] == 4
    # a 1-query bucket pads to the replica count; padding rows never run
    assert port["one"][0][1]["replica"] == 0
    assert port["c1"]["mesh2d_row_dispatches"] == 1


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_mesh2d_forced_overflow_rerun_is_exact(jax_results, layout):
    jax, port = both(jax_results, "mesh2d_forced_overflow", layout)
    assert port == jax
    for values, stats in port["out"]:
        assert values == port["truth"]
        assert stats["capacity_per_shard"] > 2
    assert port["counters"]["mesh2d_rerun_calls"] == 1
    assert port["counters"]["mesh2d_calls"] == 2


# ---------------------------------------------------------------------------
# engines end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_search_engine_topology_matches_jax(jax_results, layout):
    jax, port = both(jax_results, "mesh2d_search_engine", layout)
    assert port == jax
    assert any(isinstance(p, tuple) and (p[5], p[4]) == layout
               for p in port["plans"])
    assert any(a == "rangroupscan/mesh2d" for _, a, _, _ in port["served"])


def test_balancer_spreads_single_device_buckets(jax_results):
    jax, port = both(jax_results, "mesh2d_balancer_spread")
    assert port == jax
    counters = port["counters"]
    assert counters["replica_dispatches"] > 0
    assert "mesh2d_calls" not in counters
    dispatched = [d for d, _, _ in port["loads"]]
    assert sum(dispatched) == counters["replica_dispatches"]
    assert sum(1 for d in dispatched if d > 0) >= 3
    assert {s.get("replica") for _, _, s, _ in port["served"]} >= {0, 1, 2}


def test_query_many_balancer_path_on_2x2_topology(jax_results):
    jax, port = both(jax_results, "mesh2d_query_many")
    assert port == jax
    assert port["counters"]["replica_dispatches"] > 0


def test_async_engine_topology_matches_jax(jax_results):
    jax, port = both(jax_results, "mesh2d_async")
    assert port == jax
    assert port["done"]


def test_mesh2d_warming_zero_traces_at_serve_time(jax_results):
    jax, port = both(jax_results, "mesh2d_warming")
    port_warm, jax_warm = port.pop("warm"), jax.pop("warm")
    assert port == jax
    assert_warm_differs_only_by_reruns(jax_warm, port_warm)
    assert any(s[4] == 2 and s[5] == 2 for s in port["warmed"])
    assert port["c2"]["mesh2d_calls"] >= 1
    assert "mesh2d_traces" not in port["c2"]
    assert "batch_traces" not in port["c2"]


def test_mesh2d_warming_differs_from_jax_only_by_the_rerun_pass(jax_results):
    """The port's deliberate difference on the 2-D arms, as on the sharded
    ones: the re-run's specializations are warmed, so serving the
    overflowing siblings traces nothing, where the JAX package traces each
    re-run once."""
    jax, port = both(jax_results, "mesh2d_rerun_gap")
    assert port["same_sig"] == jax["same_sig"] == (True, True)
    assert [(s[5], s[4]) for s in port["sigs"]] == [(2, 2), (2, 2)]
    assert port["served"] == jax["served"]
    assert assert_warm_differs_only_by_reruns(jax["warm"], port["warm"]) == 4
    assert jax["counters"].pop("mesh2d_traces") == 1
    assert jax["counters"].pop("expr_traces") == 1
    assert port["counters"] == jax["counters"]


def test_balancer_inflight_visible_during_overlapping_dispatch(jax_results):
    """Two dispatched, uncollected buckets hold weight on two rows (the
    release happens at collect), and both collects give it all back,
    once."""
    jax, port = both(jax_results, "mesh2d_inflight_visible")
    assert port == jax
    assert sum(1 for x in port["busy"] if x > 0) == 2
    assert port["after"] == port["again"] == [0.0, 0.0]
    assert port["counters"]["inflight_dispatches"] == 2


def test_balancer_release_on_dispatch_failure(jax_results):
    jax, port = both(jax_results, "mesh2d_release_on_failure")
    assert port == jax
    assert port["raised"] == "mirror build failed"
    assert [load[0] for load in port["loads"]] == [0.0, 0.0]
    assert sum(load[1] for load in port["loads"]) == 1
    assert port["counters"]["dispatch_failures"] == 1


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_suggest_mesh2d_matches_jax_and_oracle(jax_results, layout):
    jax, port = both(jax_results, "mesh2d_count", layout)
    assert port == jax
    assert [s for s, _ in port["suggest"]] == [
        [tuple(p) for p in o] for o in port["oracle"]]
    assert {a for _, a in port["suggest"]} == {"suggest/mesh2d"}
    assert port["counters"]["mesh2d_row_dispatches"] == \
        port["counters"]["count_calls"]


def test_suggest_balancer_rows_after_warming(jax_results):
    jax, port = both(jax_results, "mesh2d_count_balancer")
    assert port == jax
    assert "count_traces" not in port["counters"]
    assert port["counters"]["replica_dispatches"] == sum(port["loads"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_expr_mesh2d_forced_overflow_is_exact(jax_results, layout):
    jax, port = both(jax_results, "mesh2d_expr_overflow", layout)
    assert port == jax
    for values, stats in port["out"]:
        assert values == port["truth"]
        assert stats["n_replicas"] == layout[0]
    assert port["counters"]["expr_rerun_calls"] == 1


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_expr_mesh2d_engine_matches_jax(jax_results, layout):
    jax, port = both(jax_results, "mesh2d_expr_engine", layout)
    assert port == jax
    assert {a for _, a, _, _ in port["served"]} == {"expr/mesh2d"}


# ---------------------------------------------------------------------------
# concurrent collects with the flusher on (the port's own)
# ---------------------------------------------------------------------------

def test_concurrent_submits_with_flusher_on_2x2_topology():
    """Several shards share one device: with the background flusher and
    four submitter threads, every ticket resolves to the single-device
    engine's answer, and stop() joins the flusher (no collect waits on
    another's copy forever)."""
    post = cases.postings(PORT)
    base = SearchEngine(post, seed=3, device="cpu")
    log = cases.query_log(PORT, base.index, 64, seed=7)
    want = {tuple(q): r.doc_ids for q, r in zip(log, base.query_batch(log))}
    eng = AsyncSearchEngine(post, seed=3, device="cpu", shard_min_g=4,
                            topology=make_topology(2, 2, devices=["cpu"] * 4),
                            flush_tier=4, deadline_us=500.0, result_cache=0,
                            max_inflight=4)
    tickets = [[] for _ in range(4)]

    def submit(k):
        for q in log[k::4]:
            tickets[k].append((q, eng.submit(q)))

    eng.start()
    try:
        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.stop()
    assert not eng.running
    done = [pair for per in tickets for pair in per]
    assert len(done) == len(log)
    for q, ticket in done:
        assert ticket.done and ticket.error is None, q
        assert np.array_equal(ticket.value.doc_ids, want[tuple(q)]), q
    assert any(t.value.algorithm == "rangroupscan/mesh2d" for _, t in done)
