"""One run of one cell: set-up, the measured window, an optional traced
segment, the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json`` and ``bench/metrics/<metric>.py`` (a
``read(record)`` function that returns a number, or None when the run has
nothing for it to read).

The traffic mode ``closed_batch`` drives the program's batched front end:
one caller sends ``batch`` queries at a time to ``SearchEngine.query_batch``,
back to back.  The window ends at the first return after the requested
seconds.

With ``trace`` the window is followed by a segment of the same traffic under
``torch.profiler``; the per-layer metrics read the window's counters and the
segment's trace, so the profiler never perturbs what the window measured.
"""
from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bench import data
from bench.reference import Reference
from bench.devtrace import Profiled

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The cell asks for more CUDA cards than this machine has."""


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: pathlib.Path = ROOT) -> Dict:
    """The cell ``workload`` with its configuration, traffic and the
    metrics it reports, from ``BENCHMARK.json`` and the files it names."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return {
        "cell": cell,
        "config": load_json(root / configs[cell["config"]]["file"]),
        "traffic": load_json(root / "bench" / "traffic"
                             / f"{cell['traffic']}.json"),
        "end_to_end": reported(manifest, workload, "end_to_end"),
        "per_layer": reported(manifest, workload, "per_layer"),
    }


def reported(manifest: Dict, workload: str, section: str) -> List[Dict]:
    """The metrics of ``section`` that cell ``workload`` reports: those that
    list it, and those without a ``workloads`` key (an end-to-end metric in
    every cell; a per-layer one in every cell that reports its ``moves``)."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def in_cell(m: Dict) -> bool:
        if "workloads" in m:
            return workload in m["workloads"]
        if section == "per_layer":
            return in_cell(e2e[m["moves"]])
        return True

    return [m for m in manifest[section] if in_cell(m)]


def load_reader(name: str, bench: pathlib.Path = BENCH) -> Callable:
    """``read`` of ``bench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, compared by
    whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _request(terms, result=None, error=None) -> Dict:
    return {"terms": tuple(terms), "result": result, "error": error,
            "in_window": False, "in_segment": False}


def closed_batch(eng, order, batch: int, seconds: float,
                  requests: List[Dict], flag: str) -> tuple:
    """Calls of ``batch`` queries, back to back, until the first return
    after ``seconds``; returns (start, end) on the host clock."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    while True:
        qs = [next(order) for _ in range(batch)]
        try:
            with record_function("bench.query_batch"):
                got = eng.query_batch([list(q) for q in qs])
            err = None
        except Exception as exc:  # counted as unanswered, and reported
            got, err = [None] * len(qs), exc
            print(f"query_batch raised: {exc!r}", file=sys.stderr)
        c1 = time.perf_counter()
        for q, res in zip(qs, got):
            r = _request(q, res, err)
            r[flag] = True
            requests.append(r)
        if c1 - t0 >= seconds:
            return t0, c1


def check_card(spec: Dict) -> None:
    """Raise :class:`NoCard` unless this machine has the cell's cards."""
    chips = int(spec["cell"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        raise NoCard(f"{spec['cell']['name']} needs {chips} CUDA card(s); "
                     f"found {found}")


def set_up(spec: Dict, seed: int, started_at: float, device: str = "cuda",
           trace: bool = False, err=sys.stderr) -> Dict:
    """Data from the seed, the program's engine over it, one warm call of
    the cell's own traffic; each part timed and printed."""
    config, traffic = spec["config"], spec["traffic"]
    parts: Dict[str, float] = {}
    mark = started_at

    def part(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    part("start_s")
    import repro_torch.serve.search  # noqa: F401  (the program's import)
    from repro_torch.kernels import _build

    part("import_s")
    postings = data.make_postings(config, seed, device=device)
    part("data_s")
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.serve.search import SearchEngine

    eng = SearchEngine(postings, device=device, **config["engine"])
    _sync(device)
    part("engine_s")
    pool = data.query_pool(traffic, len(postings))
    warm = list(itertools.islice(data.pool_order(pool, seed + 1),
                                 int(traffic["warm"])))
    eng.query_batch([list(q) for q in warm])
    _sync(device)
    part("warm_s")
    if trace:  # the profiler's first start is slow: pay it in set-up
        with Profiled(torch):
            pass
        part("profiler_s")
    setup_s = time.perf_counter() - started_at
    print("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; index build (SearchEngine.build_s) {eng.build_s:.3f}; kernel "
          f"library build {_build.build_seconds:.3f}; total {setup_s:.3f} s",
          file=err, flush=True)
    return {"engine": eng, "postings": postings, "pool": pool,
            "lengths": [len(postings[t]) for t in sorted(postings)],
            "parts": parts, "setup_s": setup_s}


def check_answers(requests: Sequence[Dict], postings, device: str,
                  control: bool = False) -> Dict:
    """Every answer against the plain reference: counts of wrong and
    unanswered requests, and answers by route."""
    ref = Reference(postings, device=device, control=control)
    wrong = unanswered = 0
    routes: Dict[str, int] = {}
    for r in requests:
        if r["result"] is None:
            unanswered += 1
            continue
        algo = r["result"].algorithm
        routes[algo] = routes.get(algo, 0) + 1
        if not np.array_equal(np.asarray(r["result"].doc_ids),
                              ref.answer(r["terms"])):
            wrong += 1
    return {"wrong": wrong, "unanswered": unanswered, "routes": routes}


def run(spec: Dict, seed: int, seconds: float, trace: bool,
        started_at: float, device: str = "cuda", require_card: bool = True,
        err=sys.stderr) -> Dict:
    """One run of ``spec`` (see :func:`cell_spec`); returns the result line
    as a dict.  Raises :class:`NoCard` when the cell's cards are missing."""
    from repro_torch.core.engine import EXEC_COUNTERS

    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    if require_card:
        check_card(spec)
    ready = set_up(spec, seed, started_at, device=device, trace=trace,
                   err=err)
    eng, postings, pool = ready["engine"], ready["postings"], ready["pool"]
    order = data.pool_order(pool, seed)
    requests: List[Dict] = []
    counters: Dict[str, Dict] = {}
    segment_s = max(2.0, seconds / 3.0) if trace else 0.0
    segment = None
    if traffic["mode"] == "closed_batch":
        batch = int(traffic["batch"])
        counters["before"] = EXEC_COUNTERS.snapshot()
        t0, t1 = closed_batch(eng, order, batch, seconds, requests,
                              "in_window")
        counters["after"] = EXEC_COUNTERS.snapshot()
        if trace:
            with Profiled(torch) as prof:
                closed_batch(eng, order, batch, segment_s, requests,
                             "in_segment")
            segment = {"reduced": prof.reduced}
    else:
        raise ValueError(f"unknown traffic mode {traffic['mode']!r}")
    _sync(device)
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    build_s = eng.build_s
    delta = {k: counters["after"][k] - counters["before"].get(k, 0)
             for k in counters["after"]}
    del eng
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    # the check: every answer the timed path gave, against the reference
    t_ref = time.perf_counter()
    checked = check_answers(requests, postings, device)
    print(f"reference: {len(requests)} answers checked in "
          f"{time.perf_counter() - t_ref:.3f} s; routes "
          + ", ".join(f"{k} {v}" for k, v in sorted(checked["routes"].items())),
          file=err, flush=True)
    wrong, unanswered = checked["wrong"], checked["unanswered"]

    record = {
        "cell": cell, "config": config, "traffic": traffic,
        "seed": seed, "seconds": seconds, "setup": ready["parts"],
        "setup_s": ready["setup_s"], "build_s": build_s,
        "lengths": ready["lengths"],
        "window": {"t0": t0, "t1": t1, "seconds": t1 - t0,
                   "counters": delta},
        "requests": requests, "segment": segment,
    }
    section = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in section:
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name() if device.startswith("cuda")
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": wrong == 0 and unanswered == 0,
           "attempted": len(requests), "failed": unanswered,
           "metrics": metrics, "device": dev}
    if trace:
        reduced = (segment or {}).get("reduced")
        if reduced is not None:
            dev["busy_s"] = reduced["busy_s"]
            dev["window_s"] = reduced["window_s"]
            out["breakdown"] = {"device_ops": reduced["device_ops"],
                                "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = {"wrong_answers": {"value": wrong, "limit": 0},
                     "unanswered": {"value": unanswered, "limit": 0}}
    return out


def report(out: Dict, err=sys.stderr, stdout=sys.stdout) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=err)
    err.flush()
    print(json.dumps(out), file=stdout, flush=True)


def main(argv: Optional[Sequence[str]] = None, started_at: float = 0.0) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    try:
        out = run(spec, args.seed, args.seconds, bool(args.trace),
                  started_at or time.perf_counter())
    except NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print("no result: JAX or the JAX package is loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    report(out)
    return 0
