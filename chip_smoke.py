#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout, on a machine with one CUDA GPU and the
CUDA toolkit; it builds the kernels itself (``nvcc``, into ``build/``).  It
imports nothing of JAX or of the JAX package.  Phases, in order:

  1. build   — print the card and its power limit; build both CUDA kernels
               from ``src/repro_torch/csrc`` and print the build time and
               what ``ptxas`` reports (registers, spills, shared memory).
  2. bitmap_filter — the phase-1 kernel against its plain PyTorch version on
               the card, over the main path's widths and odd edge shapes;
               outputs must be bit-identical.
  3. group_match — the same for the phase-2 kernel.
  4. slice   — the paper-scale index (constants below) served through
               ``SearchEngine(postings, device="cuda").query_batch``: every
               answer must equal the numpy oracle, both kernels must have
               launched on this path, at least one overflow re-run and one
               HashBin query must occur.  A second, profiled pass gives the
               device-time breakdown.
  5. times   — both kernels held bit-identical to their plain versions on
               the main path's own data (the heaviest bucket's first pass,
               and the planted pair's overflow re-run at capacity G), then
               each kernel and its plain version timed with CUDA events on
               that first pass's inputs, beside the least time the card
               could take (``bound_ms``).

It fails (non-zero exit, no final line) if there is no GPU, a kernel does
not build, launch or agree, or any answer is wrong.  The last lines are the
kernel table as JSON and ``{"ok": true, "device": {...}}``.  ``--report``
writes a fuller JSON report (every count, time and profile row) to PATH.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# -- the slice's index: the paper's 10M-element order (fig. 5) -------------
N_TERMS = 16                 # log-uniform list lengths in [MIN_LEN, MAX_LEN]
MIN_LEN = 1 << 16            # pinned: one term has exactly MIN_LEN ...
MAX_LEN = 1 << 23            # ... and one exactly MAX_LEN (ratio 128 > 100)
UNIVERSE = 1 << 28           # doc-id universe (benchmarks/common.py)
PLANTED_LEN = 1 << 20        # two extra terms sharing half their elements,
PLANTED_SHARED = 1 << 19     # so a dense query overflows and re-runs at G
W_BITS, M_IMAGES = 256, 2    # the repo's serving defaults
N_QUERIES = 256              # zipf_query_log: 68/23/9% 2-, 3-, 4-keyword
SEED = 0

# -- the card: published H100 SXM peaks (NVIDIA data sheet, whitepaper) ----
HBM_BYTES_PER_S = 3.35e12
# int32 compares: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TIME_ITERS = 20


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# -- data -----------------------------------------------------------------

def sample_ids(rng: np.random.Generator, n: int, universe: int = UNIVERSE
               ) -> np.ndarray:
    """A uniform random n-subset of [0, universe), sorted uint32 (draw with
    replacement, dedup, then a uniform n-subset of the distinct draws)."""
    pool = np.unique(rng.integers(0, universe, size=n + n // 8 + 64))
    while len(pool) < n:
        pool = np.unique(np.concatenate(
            [pool, rng.integers(0, universe, size=n // 8 + 64)]))
    return np.sort(rng.choice(pool, n, replace=False)).astype(np.uint32)


def make_postings(seed: int = SEED, n_terms: int = N_TERMS,
                  min_len: int = MIN_LEN, max_len: int = MAX_LEN,
                  planted_len: int = PLANTED_LEN,
                  planted_shared: int = PLANTED_SHARED,
                  universe: int = UNIVERSE):
    """Terms 0..n_terms-1 with log-uniform lengths (the two ends pinned, in
    shuffled positions), plus terms n_terms and n_terms+1 sharing
    ``planted_shared`` of their ``planted_len`` elements.  Returns
    (postings, (shortest term, longest term), planted pair)."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(math.log(min_len), math.log(max_len), n_terms))
    lens = lens.astype(np.int64)
    lens[0], lens[1] = min_len, max_len
    lens = rng.permutation(lens)
    postings = {t: sample_ids(rng, int(n), universe) for t, n in enumerate(lens)}
    pool = rng.permutation(sample_ids(
        rng, planted_shared + 2 * (planted_len - planted_shared), universe))
    shared = pool[:planted_shared]
    rest = pool[planted_shared:]
    own = planted_len - planted_shared
    a, b = n_terms, n_terms + 1
    postings[a] = np.sort(np.concatenate([shared, rest[:own]]))
    postings[b] = np.sort(np.concatenate([shared, rest[own:2 * own]]))
    ends = (int(np.argmin(lens)), int(np.argmax(lens)))
    return postings, ends, (a, b)


def oracle(postings, terms) -> np.ndarray:
    """Exact answer by membership: the shortest list searched in the others."""
    lists = sorted((postings[t] for t in dict.fromkeys(terms)), key=len)
    out = lists[0]
    for other in lists[1:]:
        pos = np.searchsorted(other, out).clip(max=len(other) - 1)
        out = out[other[pos] == out]
    return out


# -- phases 2 and 3: kernels against their plain versions ------------------

def random_images(torch, gen, shape, zero_frac=0.6, device="cuda"):
    x = torch.randint(-(1 << 31), (1 << 31) - 1, shape, dtype=torch.int32,
                      generator=gen, device=device)
    x[torch.rand(shape, generator=gen, device=device) < zero_frac] = 0
    return x


def random_rows(torch, gen, shape, device="cuda"):
    x = torch.randint(0, 500, shape, dtype=torch.int32, generator=gen,
                      device=device)
    x[torch.rand(shape, generator=gen, device=device) < 0.25] = -1
    return x


def max_abs_err(torch, out, want) -> int:
    require(out.shape == want.shape and out.dtype == want.dtype,
            f"shape/dtype {tuple(out.shape)} {out.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    return int((out.to(torch.int32) - want.to(torch.int32)).abs().max().item())


def check_bitmap_filter(torch, gen, ops, ref, bitmap_filter_cuda):
    cases = []
    for k in (2, 3, 4):
        for G in (1 << 10, 1 << 19):
            for B in (1, 16):
                cases.append(("random", (B, k, G, 2, 8)))
    cases += [("random", (4, 3, 1, 2, 8)), ("random", (4, 3, 1000, 2, 8)),
              ("random", (3, 2, 4096, 2, 1)), ("random", (3, 2, 777, 3, 5)),
              ("random", (2, 1000, 2, 8)), ("ones", (2, 3, 513, 2, 8)),
              ("zeros", (2, 3, 513, 2, 8)), ("misaligned", (3, 2, 999, 2, 8))]
    worst = 0
    for kind, shape in cases:
        if kind == "ones":
            x = torch.full(shape, -1, dtype=torch.int32, device="cuda")
        elif kind == "zeros":
            x = torch.zeros(shape, dtype=torch.int32, device="cuda")
        elif kind == "misaligned":  # 4-byte offset: takes the scalar path
            flat = random_images(torch, gen, (math.prod(shape) + 1,))
            x = flat[1:].view(shape)
        else:
            x = random_images(torch, gen, shape)
        out = bitmap_filter_cuda(x)
        want = ref.bitmap_filter_ref(x)
        torch.cuda.synchronize()
        err = max_abs_err(torch, out, want)
        require(err == 0, f"bitmap_filter {kind} {shape}: max_abs_err {err}")
        if kind == "ones":
            require(bool(out.all()), "bitmap_filter all-pass case dropped tuples")
        if kind == "zeros":
            require(not bool(out.any()), "bitmap_filter all-fail case kept tuples")
        require(torch.equal(ops.bitmap_filter(x), want), "router disagrees")
        worst = max(worst, err)
    print(f"phase 2 bitmap_filter: {len(cases)} shapes bit-identical to "
          f"the plain version")
    return worst, len(cases)


def check_group_match(torch, gen, ops, ref, group_match_cuda):
    cases = [(S, ga, gb) for S in (1, 37, 1 << 16)
             for ga in (8, 16, 32, 64, 128) for gb in (8, 16, 32, 64, 128)]
    worst = 0
    for S, ga, gb in cases:
        a, b = random_rows(torch, gen, (S, ga)), random_rows(torch, gen, (S, gb))
        out = group_match_cuda(a, b)
        want = ref.group_match_ref(a, b)
        torch.cuda.synchronize()
        err = max_abs_err(torch, out, want)
        require(err == 0, f"group_match {(S, ga, gb)}: max_abs_err {err}")
        require(torch.equal(ops.group_match(a, b), want), "router disagrees")
        worst = max(worst, err)
    a = random_rows(torch, gen, (6, 333, 32))
    b = random_rows(torch, gen, (6, 333, 64))
    require(torch.equal(group_match_cuda(a, b), ref.group_match_ref(a, b)),
            "group_match batched rows disagree")
    pad = torch.full((64, 16), -1, dtype=torch.int32, device="cuda")
    require(not bool(group_match_cuda(pad, pad).any()),
            "group_match matched padding")
    print(f"phase 3 group_match: {len(cases) + 2} shapes bit-identical to "
          f"the plain version")
    return worst, len(cases) + 2


# -- phase 5: times ---------------------------------------------------------

def cuda_ms(torch, fn, iters: int = TIME_ITERS) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pass_bytes(engine, log, results) -> dict:
    """Device bytes the batch's passes make and copy, summed over first
    passes and overflow re-runs: the (B, k, G, m, W) images
    ``_aligned_images`` writes, the (B, capacity, g_i) survivor rows the
    gathers stack, and the packed (B, capacity, g_0) buffer copied to the
    host."""
    caps = {}
    for plan, res in zip(map(engine.plan, log), results):
        if plan.algorithm == "device":
            caps.setdefault(plan.sig, []).append(res.stats["capacity"])
    out = {"aligned_images": 0, "gathered_rows": 0, "packed_to_host": 0}
    for sig, got in caps.items():
        G = 1 << sig.ts[-1]
        passes = [(len(got), sig.capacity_tier)]
        reruns = sum(c != sig.capacity_tier for c in got)
        if reruns:
            passes.append((reruns, G))
        for B, cap in passes:
            out["aligned_images"] += B * sig.k * G * M_IMAGES * (W_BITS // 32) * 4
            out["gathered_rows"] += B * cap * sum(sig.gmaxes) * 4
            out["packed_to_host"] += B * cap * sig.gmaxes[0] * 4
    return out


def device_buckets(engine, log):
    """The main path's device buckets: {sig: [plans]} in dispatch order."""
    from repro_torch.exec.batch import bucket_plans

    plans = [(i, p) for i, p in enumerate(engine.plan(q) for q in log)
             if p.algorithm == "device"]
    return {sig: [p for _, p in items]
            for sig, items in bucket_plans(plans).items()}


def check_on_path(torch, engine, sig, plans, capacity, ref,
                  bitmap_filter_cuda, group_match_cuda):
    """Hold both kernels against their plain versions on the data that one
    pass of the main path gives them: bucket ``sig`` over ``plans`` at
    ``capacity``, the pipeline's own aligned images, compaction and survivor
    gathers.  Every group_match of the pass (one per set after the base) is
    checked.  Returns (bitmap_filter err, group_match err, images,
    [(base rows, set-i rows), ...])."""
    from repro_torch.core.engine import (
        _aligned_images, _first_survivors, _gather_survivor_rows,
    )

    sets = [[engine.device.sets[t] for t in p.terms] for p in plans]
    tk = sig.ts[-1]
    imgs = _aligned_images([[q[i].images for q in sets]
                            for i in range(sig.k)], sig.ts)
    passed = bitmap_filter_cuda(imgs)
    bf_err = max_abs_err(torch, passed, ref.bitmap_filter_ref(imgs))
    surv = _first_survivors(passed, capacity).clamp(max=(1 << tk) - 1)
    del passed
    base = _gather_survivor_rows([q[0].vals for q in sets], surv,
                                 tk - sig.ts[0])
    pairs, gm_err = [], 0
    for i in range(1, sig.k):
        rows = _gather_survivor_rows([q[i].vals for q in sets], surv,
                                     tk - sig.ts[i])
        gm_err = max(gm_err, max_abs_err(torch, group_match_cuda(base, rows),
                                         ref.group_match_ref(base, rows)))
        pairs.append((base, rows))
    require(bf_err == 0, f"bitmap_filter on the path {tuple(imgs.shape)}: "
                         f"max_abs_err {bf_err}")
    require(gm_err == 0, f"group_match on the path {tuple(base.shape)}: "
                         f"max_abs_err {gm_err}")
    return bf_err, gm_err, imgs, pairs


def time_kernels(torch, engine, log, results, ref, bitmap_filter_cuda,
                 group_match_cuda):
    """Check, then time, each kernel on the main path's own data at its
    heaviest shapes: the first pass of the heaviest phase-1 bucket.  The
    overflow re-run of the planted dense pair's bucket (capacity G) is
    checked as well."""
    buckets = device_buckets(engine, log)
    sig = max(buckets, key=lambda s: len(buckets[s]) * s.k * (1 << s.ts[-1]))
    plans = buckets[sig]
    B, G = len(plans), 1 << sig.ts[-1]
    bf_err, gm_err, imgs, pairs = check_on_path(
        torch, engine, sig, plans, sig.capacity_tier, ref,
        bitmap_filter_cuda, group_match_cuda)
    checked = [("first pass", list(imgs.shape),
                [list(a.shape[:-1]) + [a.shape[-1], b.shape[-1]]
                 for a, b in pairs])]
    # the re-run: the dense queries of the planted pair's bucket at G
    dense_sig = engine.plan(log[-2]).sig
    dense_G = 1 << dense_sig.ts[-1]
    rerun = [p for p, r in zip(map(engine.plan, log), results)
             if p.sig == dense_sig and r.stats["capacity"] == dense_G]
    require(rerun, "no re-run to check")
    e1, e2, r_imgs, r_pairs = check_on_path(
        torch, engine, dense_sig, rerun, dense_G, ref,
        bitmap_filter_cuda, group_match_cuda)
    checked.append(("re-run", list(r_imgs.shape),
                    [list(a.shape[:-1]) + [a.shape[-1], b.shape[-1]]
                     for a, b in r_pairs]))
    bf_err, gm_err = max(bf_err, e1), max(gm_err, e2)
    del r_imgs, r_pairs
    for what, ishape, gshapes in checked:
        print(f"phase 5 {what} on the path: bitmap_filter at {ishape} and "
              f"group_match at {gshapes} bit-identical to the plain versions")

    bf_bytes = imgs.numel() * 4 + B * G
    bf = {
        "shape": list(imgs.shape),
        "ms": cuda_ms(torch, lambda: bitmap_filter_cuda(imgs)),
        "plain_ms": cuda_ms(torch, lambda: ref.bitmap_filter_ref(imgs)),
        "bound_ms": bf_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bytes": bf_bytes,
        "max_abs_err": bf_err,
    }
    del imgs
    # phase 2 on the same pass: the base set's survivor rows against the
    # next set's, as gathered by the pipeline
    a, b = pairs[0]
    del pairs[1:]
    S, ga, gb = a.numel() // a.shape[-1], a.shape[-1], b.shape[-1]
    gm_bytes = S * (ga + gb) * 4 + S * ga
    compares = S * ga * gb
    bytes_ms = gm_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = compares / INT32_OPS_PER_S * 1e3
    gm = {
        "shape": [S, ga, gb],
        "ms": cuda_ms(torch, lambda: group_match_cuda(a, b)),
        "plain_ms": cuda_ms(torch, lambda: ref.group_match_ref(a, b)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": gm_bytes,
        "compares": compares,
        "max_abs_err": gm_err,
    }
    print(f"phase 5 bitmap_filter at {bf['shape']}: {bf['ms']:.4f} ms "
          f"(plain {bf['plain_ms']:.4f} ms), {bf_bytes} bytes, bound "
          f"{bf['bound_ms']:.4f} ms at {HBM_BYTES_PER_S:.3g} B/s")
    print(f"phase 5 group_match at {gm['shape']}: {gm['ms']:.4f} ms "
          f"(plain {gm['plain_ms']:.4f} ms), {gm_bytes} bytes, {compares} "
          f"compares, bound {gm['bound_ms']:.4f} ms ({gm['bound_by']})")
    return bf, gm


# -- phase 4: the slice -----------------------------------------------------

def serve_slice(engine, log, postings, sync=lambda: None):
    """One pass of the log through query_batch; returns (results, wall s)
    after checking every answer against the oracle."""
    sync()
    t0 = time.perf_counter()
    results = engine.query_batch(log)
    sync()
    wall = time.perf_counter() - t0
    for q, res in zip(log, results):
        want = oracle(postings, q)
        require(np.array_equal(res.doc_ids, want),
                f"query {q}: {len(res.doc_ids)} ids, oracle {len(want)}")
    return results, wall


def profile_breakdown(torch, engine, log):
    """Device time by kernel name over one more pass, and the device's busy
    share of that pass's wall time (None where the profiler saw nothing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.query_batch(log)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): an operator's row
        # repeats the device time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {
        "wall_s": wall,
        "device_busy_ms": busy_ms if rows else None,
        "device_busy_share": busy_ms / (wall * 1e3) if rows else None,
        "top": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=pathlib.Path,
                    help="write the full JSON report to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.engine import EXEC_COUNTERS
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.serve.search import SearchEngine, zipf_query_log

    report = {}
    t_start = time.perf_counter()

    # phase 1: build
    card = nvidia_smi()
    print(card)
    report["card"] = card
    t0 = time.perf_counter()
    lib = _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"phase 1 build: {build_s:.2f} s (nvcc {_build.build_seconds:.2f} s, "
          f"sm_90a) -> {pathlib.Path(lib._name).name}")
    for ln in ptxas:
        print("  ptxas:", ln)
    report["build_s"] = build_s

    # phases 2 and 3: kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bf_err, bf_cases = check_bitmap_filter(torch, gen, ops, ref,
                                           bitmap_filter_cuda)
    gm_err, gm_cases = check_group_match(torch, gen, ops, ref, group_match_cuda)
    torch.cuda.empty_cache()

    # phase 4: the slice at paper scale
    t0 = time.perf_counter()
    postings, (short_t, long_t), planted = make_postings()
    gen_s = time.perf_counter() - t0
    n_elems = sum(len(p) for p in postings.values())
    engine = SearchEngine(postings, w=W_BITS, m=M_IMAGES, seed=SEED,
                          device="cuda")
    index_bytes = sum(s.vals.numel() * 4 + s.images.numel() * 4
                      for s in engine.device.sets.values())
    log = zipf_query_log(range(N_TERMS), N_QUERIES, seed=SEED + 1)
    log += [list(planted), [short_t, long_t]]
    n_buckets = len({p.sig for p in map(engine.plan, log) if p.sig})
    print(f"phase 4 index: {len(postings)} terms, {n_elems} elements, "
          f"lengths {min(map(len, postings.values()))}.."
          f"{max(map(len, postings.values()))}; data {gen_s:.1f} s, "
          f"preprocessing {engine.build_s:.1f} s, device bytes {index_bytes}")

    torch.cuda.reset_peak_memory_stats()
    bitmap_filter_cuda.launches = 0
    group_match_cuda.launches = 0
    EXEC_COUNTERS.reset()
    results, wall = serve_slice(engine, log, postings, torch.cuda.synchronize)
    launches = {"bitmap_filter": bitmap_filter_cuda.launches,
                "group_match": group_match_cuda.launches}
    counters = EXEC_COUNTERS.snapshot()
    peak = torch.cuda.max_memory_allocated()
    algos = [r.algorithm for r in results]
    require(launches["bitmap_filter"] > 0, "bitmap_filter never launched")
    require(launches["group_match"] > 0, "group_match never launched")
    require(counters["rerun_calls"] >= 1, "no overflow re-run")
    require("hashbin" in algos, "no query took hashbin")
    require(results[-1].algorithm == "hashbin", "2^16 x 2^23 pair not hashbin")
    dense = results[-2].stats
    require(dense["capacity"] == dense["group_tuples"],
            "planted dense pair did not re-run at capacity G")
    print(f"phase 4 slice: {len(log)} queries, {n_buckets} buckets, "
          f"{counters['batch_calls']} passes, {counters['rerun_calls']} "
          f"re-runs, {algos.count('hashbin')} hashbin; wall {wall:.3f} s, "
          f"{len(log) / wall:.1f} queries/s; {counters['collect_us']} us in "
          f"collect; peak device memory {peak} bytes; all answers equal the "
          f"oracle")
    moved = pass_bytes(engine, log, results)
    print(f"phase 4 bytes: aligned images {moved['aligned_images']}, gathered "
          f"rows {moved['gathered_rows']}, packed to host "
          f"{moved['packed_to_host']}")
    _, warm_wall = serve_slice(engine, log, postings, torch.cuda.synchronize)
    print(f"phase 4 slice, second pass: wall {warm_wall:.3f} s, "
          f"{len(log) / warm_wall:.1f} queries/s")
    prof = profile_breakdown(torch, engine, log)
    print(f"phase 4 profiled pass: wall {prof['wall_s']:.3f} s, device busy "
          f"{prof['device_busy_ms']} ms, share {prof['device_busy_share']}")
    for row in prof["top"][:8]:
        print(f"  {row['ms']:10.3f} ms  {row['calls']:6d}x  {row['name'][:90]}")
    report["slice"] = {
        "terms": len(postings), "elements": n_elems, "queries": len(log),
        "buckets": n_buckets, "counters": counters, "launches": launches,
        "preprocess_s": engine.build_s, "index_device_bytes": index_bytes,
        "wall_s": wall, "qps": len(log) / wall, "second_wall_s": warm_wall,
        "second_qps": len(log) / warm_wall, "peak_device_bytes": peak,
        "profile": prof, "bytes": moved,
    }

    # phase 5: checks and times on the main path's data, heaviest shapes
    torch.cuda.empty_cache()
    bf, gm = time_kernels(torch, engine, log, results, ref,
                          bitmap_filter_cuda, group_match_cuda)
    kernels = [
        {"name": "bitmap_filter", "route": "cuda",
         "source": "src/repro_torch/csrc/bitmap_filter.cu",
         "replaces": "src/repro/kernels/bitmap_filter.py:64",
         "launches": launches["bitmap_filter"],
         "max_abs_err": max(bf_err, bf["max_abs_err"]),
         "ms": bf["ms"], "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
         "bound_by": bf["bound_by"], "library_ms": None},
        {"name": "group_match", "route": "cuda",
         "source": "src/repro_torch/csrc/group_match.cu",
         "replaces": "src/repro/kernels/group_intersect.py:46",
         "launches": launches["group_match"],
         "max_abs_err": max(gm_err, gm["max_abs_err"]),
         "ms": gm["ms"], "plain_ms": gm["plain_ms"], "bound_ms": gm["bound_ms"],
         "bound_by": gm["bound_by"], "library_ms": None},
    ]
    report["kernels"] = kernels
    report["timed_shapes"] = {"bitmap_filter": bf, "group_match": gm}
    report["checked_shapes"] = {"bitmap_filter": bf_cases,
                                "group_match": gm_cases}
    report["total_s"] = time.perf_counter() - t_start
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=2) + "\n")

    print(f"kernels: bitmap_filter={launches['bitmap_filter']} "
          f"group_match={launches['group_match']}")
    print(f"total {report['total_s']:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
