"""The control of a cell's check: the plain reference with its ids held as
float32 (``reference.control_intersect``), one precision below the exact ids
the configuration states, put in the program's place.  For each seed it
answers the queries a run of the cell sends, at the cell's sizes, on this
machine's CUDA card, and counts the answers that differ from the exact
reference; a run's check must find them wrong.

    python3 bench/control.py --workload skewed-batch --seeds 11,12,13 \\
        --queries 1500

Prints one JSON line per seed, and the least count over the seeds last.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if pathlib.Path(p or ".").resolve() != ROOT / "bench"]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from bench import data, harness  # noqa: E402
from bench.reference import Reference  # noqa: E402


def readings(spec, seed: int, n_queries: int, device: str) -> dict:
    postings = data.make_postings(spec["config"], seed, device=device)
    pool = data.query_pool(spec["traffic"], len(postings))
    order = data.pool_order(pool, seed)
    queries = [next(order) for _ in range(n_queries)]
    exact = Reference(postings, device=device)
    control = Reference(postings, device=device, control=True)
    wrong = sum(not np.array_equal(exact.answer(q), control.answer(q))
                for q in queries)
    return {"seed": seed, "queries": len(queries),
            "distinct": len(set(queries)), "wrong_answers": wrong}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--queries", type=int, required=True,
                    help="queries a run of the cell sends")
    args = ap.parse_args()
    spec = harness.cell_spec(args.workload)
    harness.check_card(spec)
    rows = [readings(spec, int(s), args.queries, "cuda")
            for s in args.seeds.split(",")]
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"workload": args.workload, "least_wrong_answers":
                      min(r["wrong_answers"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
