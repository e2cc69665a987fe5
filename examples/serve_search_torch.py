"""End-to-end serving on the PyTorch port (the paper's
application): build an inverted index over a Zipf corpus, then serve a
batched conjunctive-query workload with the paper's keyword-count mix,
with online algorithm selection (RanGroupScan / HashBin per Section 3.4).

The twin of ``examples/serve_search.py``, with its flags and claims,
through ``repro_torch``; ``--torch-device`` (default ``cuda``; ``cpu``)
says where the device engine runs.  The plain mode serves through the
batched device engine (plan -> bucket -> one pass per shape signature,
through the hand-written kernels on the card), as the port's
``SearchEngine`` does by default; ``--host`` serves every query on the
host instead.  ``--device`` is accepted for the JAX script's command
lines, whose plain mode serves on the host unless it is given.

``--async-front`` serves the same log through the online front end:
single-query submits into the deadline-aware admission queue, with
warming and the result cache on.  ``--flusher`` lets the background
flusher thread own the flush cadence; ``--max-inflight N`` bounds its
overlapped dispatch window.

``--mesh RxS`` (e.g. ``--mesh 2x2``) serves over a 2-D device topology: R
replica rows x S z-shards a row, laid out over the visible CUDA devices,
each repeated as often as needed (one card carries a 2x2 layout as four
logical shards; with ``--torch-device cpu``, the CPU).

``--expr`` upgrades part of the log to boolean ∪/∩/∖ expressions in the
``parse`` surface syntax (``"(a|b)&c-d"``).

Run:  PYTHONPATH=src python examples/serve_search_torch.py [--docs 20000] [--queries 200] [--host] [--torch-device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.pipeline import inverted_index, zipf_corpus
from repro_torch.serve.search import (
    AsyncSearchEngine, SearchEngine, zipf_query_log,
)


def to_expr_log(queries):
    """Upgrade every third multi-term query to a boolean expression.

    ``[a, b, c]`` becomes ``"(a|b)&c"`` (and, with a 4th term, ``"-d"``):
    distinct roots share union bases, the shape the subexpression cache
    serves without device work."""
    out = []
    for i, q in enumerate(queries):
        if i % 3 == 0 and len(q) >= 3:
            e = f"({q[0]}|{q[1]})&{q[2]}"
            if len(q) >= 4:
                e += f"-{q[3]}"
            out.append(e)
        else:
            out.append(q)
    return out


def mesh_devices(torch_device: str, n: int) -> list:
    """``n`` devices for a topology: the CPU ``n`` times, or the visible
    CUDA devices in turn."""
    if torch.device(torch_device).type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    if not count:
        raise RuntimeError("--mesh on cuda needs a GPU; pass "
                           "--torch-device cpu")
    return [f"cuda:{i % count}" for i in range(n)]


def serve_async(postings, queries, flusher: bool = False, topology=None,
                max_inflight: int = 8, metrics_dump: str = "",
                device: str = "cuda"):
    """Submit one query at a time; flushes run on the manual pump cadence
    or, with ``flusher``, on the background flusher thread.  Returns the
    tickets."""
    from repro_torch.core.engine import EXEC_COUNTERS

    obs = None
    if metrics_dump:
        from repro_torch.obs import Obs

        obs = Obs(trace=True)
    # warm_b_tiers defaults to every pow2 tier up to flush_tier, so any
    # partial-flush size hits a warmed specialization
    engine = AsyncSearchEngine(postings, w=256, m=2, deadline_us=2000,
                               flush_tier=8, warm_queries=queries,
                               warm_top_k=64, topology=topology,
                               max_inflight=max_inflight, obs=obs,
                               device=device)
    EXEC_COUNTERS.reset()
    t0 = time.perf_counter()
    tickets = []
    if flusher:
        with engine:                      # start() ... stop() drains
            for q in queries:
                tickets.append(engine.submit(q))
            for t in tickets:
                t.wait(timeout=60.0)
    else:
        for q in queries:
            tickets.append(engine.submit(q))
            engine.pump()
        engine.drain()
    wall = time.perf_counter() - t0
    waits = np.asarray([t.wait_us for t in tickets])
    mode = "flusher" if flusher else "manual pump"
    print(f"async ({mode}): served {len(tickets)} queries in {wall:.2f}s "
          f"(cache hits {EXEC_COUNTERS['result_cache_hits']}, "
          f"device passes {EXEC_COUNTERS['batch_calls']}, "
          f"serve-time traces {EXEC_COUNTERS['batch_traces']}, "
          f"flusher wakeups {EXEC_COUNTERS['flusher_wakeups']})")
    print(f"queue wait p50={np.percentile(waits, 50):.0f}us "
          f"p99={np.percentile(waits, 99):.0f}us")
    if EXEC_COUNTERS["expr_calls"] or EXEC_COUNTERS["subexpr_cache_hits"]:
        print(f"expression passes {EXEC_COUNTERS['expr_calls']}, "
              f"subexpr cache hits {EXEC_COUNTERS['subexpr_cache_hits']}, "
              f"host merges {EXEC_COUNTERS['subexpr_host_merges']}")
    if topology is not None:
        print(f"mesh2d passes {EXEC_COUNTERS['mesh2d_calls']} "
              f"(row dispatches {EXEC_COUNTERS['mesh2d_row_dispatches']}), "
              f"balancer dispatches {EXEC_COUNTERS['replica_dispatches']} "
              f"-> {[d['dispatched'] for d in topology.load_snapshot()]}")
    if obs is not None:
        from repro_torch.obs.export import to_json, to_prometheus

        snap = obs.snapshot()
        if metrics_dump == "json":
            print(to_json(snap, indent=2))
        else:
            print(to_prometheus(snap))
        print(f"# open spans after drain: {obs.tracer.open_count()}")
        print(obs.trace_dump(limit=3))
    return tickets


def main(argv=None) -> dict:
    """Serve as the flags say; returns the postings served, the query log
    and each query's doc ids, in order (the plain mode also each query's
    executed algorithm)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--device", action="store_true",
                    help="serve through the batched device engine "
                         "(plan -> bucket -> one pass per shape); the "
                         "default, accepted for the JAX script's flags")
    ap.add_argument("--host", action="store_true",
                    help="serve every query on the host (RanGroupScan / "
                         "HashBin), with no device engine")
    ap.add_argument("--async-front", action="store_true",
                    help="serve through AsyncSearchEngine (admission queue, "
                         "deadline flushing, result cache, warming)")
    ap.add_argument("--flusher", action="store_true",
                    help="with --async-front: background flusher thread owns "
                         "the flush cadence (no manual pump calls)")
    ap.add_argument("--mesh", type=str, default=None, metavar="RxS",
                    help="serve over a 2-D topology: R replica rows x S "
                         "z-shards (e.g. 2x2)")
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="with --async-front: bound on concurrently "
                         "dispatched buckets (1 = synchronous collect)")
    ap.add_argument("--expr", action="store_true",
                    help="upgrade part of the log to boolean ∪/∩/∖ "
                         "expressions (parse syntax, e.g. '(a|b)&c-d')")
    ap.add_argument("--metrics-dump", type=str, default="", nargs="?",
                    const="prometheus", choices=["", "prometheus", "json"],
                    help="with --async-front: serve with tracing on and "
                         "print the metrics exposition (and a span-tree "
                         "sample) after the run")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the device engine runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    topology = None
    if args.mesh:
        from repro_torch.exec.topology import make_topology

        replicas, shards = (int(x) for x in args.mesh.lower().split("x"))
        topology = make_topology(replicas, shards, devices=mesh_devices(
            args.torch_device, replicas * shards))
        print(f"topology: {topology.describe()} "
              f"({topology.replicas * topology.shards} devices)")

    print(f"building corpus ({args.docs} docs) ...")
    docs = zipf_corpus(args.docs, vocab=20000, mean_len=120, seed=1)
    postings = inverted_index(docs)
    if args.async_front:
        # live-traffic shape: prune stopword/hapax terms, draw the log from
        # a finite pool so exact repeats occur (the result cache's regime)
        from repro_torch.serve.search import repeated_query_log

        kept = {t: p for t, p in postings.items()
                if 16 <= len(p) <= 0.04 * args.docs}
        queries = repeated_query_log(sorted(kept), args.queries,
                                     n_distinct=max(8, args.queries // 4),
                                     seed=2)
        if args.expr:
            queries = to_expr_log(queries)
        tickets = serve_async(kept, queries, flusher=args.flusher,
                              topology=topology,
                              max_inflight=args.max_inflight,
                              metrics_dump=args.metrics_dump,
                              device=args.torch_device)
        return {"postings": kept, "queries": queries,
                "doc_ids": [t.value.doc_ids for t in tickets]}
    if args.host and (args.device or topology is not None):
        ap.error("--host serves on the host; it excludes --device and "
                 "--mesh")
    engine = SearchEngine(postings, w=256, m=2, use_device=not args.host,
                          topology=topology, device=args.torch_device)
    print(f"index built: {len(engine.index)} terms in {engine.build_s:.2f}s")

    queries = zipf_query_log(sorted(engine.index), args.queries, seed=2)
    if args.expr:
        queries = to_expr_log(queries)
    t0 = time.perf_counter()
    results = engine.query_batch(queries)
    wall = time.perf_counter() - t0

    lat = np.asarray([r.latency_us for r in results if r.algorithm != "empty"])
    algos = {}
    for r in results:
        algos[r.algorithm] = algos.get(r.algorithm, 0) + 1
    print(f"served {len(results)} queries in {wall:.2f}s "
          f"({1e3*wall/len(results):.2f} ms/query avg)")
    print(f"latency p50={np.percentile(lat,50):.0f}us "
          f"p95={np.percentile(lat,95):.0f}us p99={np.percentile(lat,99):.0f}us")
    print(f"algorithm mix: {algos}")
    hits = sum(len(r.doc_ids) for r in results)
    print(f"total results: {hits} doc ids")
    return {"postings": postings, "queries": queries,
            "doc_ids": [r.doc_ids for r in results],
            "algorithms": [r.algorithm for r in results], "wall_s": wall}


if __name__ == "__main__":
    main()
