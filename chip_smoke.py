#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout, on a machine with one CUDA GPU and the
CUDA toolkit; it builds the kernels itself (``nvcc``, into ``build/``).  It
imports nothing of JAX or of the JAX package.  Phases, in order:

  1. build   — print the card and its power limit; build the CUDA kernels
               from ``src/repro_torch/csrc`` and print the build time and
               what ``ptxas`` reports (registers, spills, shared memory).
  2. bitmap_filter — the phase-1 kernel against its plain PyTorch version on
               the card, over the main path's widths and odd edge shapes;
               outputs must be bit-identical.
  3. group_match — the same for the phase-2 kernel, plus edge cases from
               a generator of their own (``EDGE_KINDS``): rows filled
               from the left with a -1 tail, rows with no -1, rows of
               only -1 on either side, repeats within a row, widths of
               1, 3, 5 and 33, and rows that start off a 16-byte
               boundary.
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
               could take (``bound_ms``), its share of it and the earlier
               design's time; for ``group_match`` also the compares of
               real elements beside the padded count.
  6. pair_count — the suggest path's count kernel against its plain version
               on the card, bit for bit: both alignment directions and equal
               depths, g tiers 8-128, (B, C) up to (16, 1024), all-sentinel
               probes, disjoint and identical sets, plus mirrors of the
               edge kinds of phase 3 at the path's tiers and odd widths.
  7. suggest — a corpus of 1024 sets (sizes log-uniform in [2^12, 2^16],
               ids uniform in [0, 2^24)) plus two copies of set 0, written
               as RSI1 records and ingested into ``SuggestEngine(...,
               device="cuda")``; the probes are warmed through
               ``SuggestEngine.warm`` at every tier up to 16 rows; 256 Zipf
               probes at k 8 in micro-batches of 16, once with the result
               cache and once with it cleared per micro-batch, then one
               batch at k 1, 20 and 100, all with no ``count_traces``.
               Every answer must equal a scipy.sparse incidence-product
               oracle, probing
               the second copy must rank set 0 before the first copy, and
               buckets of both alignment directions must run.  A profiled
               pass gives the device-time breakdown; ``pair_count`` is then
               checked on the heaviest count bucket of each alignment
               direction (its own table) and timed on the heaviest of all,
               beside the compares of real elements it needs
               (``bound_ms``), its share of it and the earlier design's
               time.
  8. small sets — 4096 sets of 4-16 elements from a shared pool, where the
               hash-bin pre-filter drops most candidates: 64 Zipf probes,
               cache cleared per micro-batch, every answer against the
               oracle.
  9. online front end — ``AsyncSearchEngine(..., device="cuda")`` over
               phase 4's index (its preprocessed lists shared, mirrors
               built anew), on a 513-query ``repeated_query_log`` (64
               distinct, plus the planted pair once):
               9a  the admission policy on a virtual clock, as
                   ``benchmarks/fig_admission_latency.py`` drives it:
                   warmed at tiers 1-8, arrivals every 250 us, flush tier
                   8, result cache on, deadlines 1000, 2000 and 5000 us;
                   per deadline every answer equals the oracle, the p99
                   wait is within the deadline (+0.5 us), no trace at
                   serve time, every ticket resolved;
               9b  the background flusher on the wall clock: the log's
                   first 256 queries, open loop from 4 submitter threads
                   (each submit stamped with its scheduled arrival) at
                   0.5x and 0.9x of what ``query_batch`` sustains on them
                   in this run; flush tier 64, deadline 2000 us, window 8,
                   cache off; every answer equals the oracle, every ticket
                   resolves and no flusher thread survives ``stop()``;
                   prints waits, end-to-end latency, overlap and flush
                   causes, and a profiled run's device busy share;
               9c  adaptive capacity: the planted pair served 8 times with
                   ``CapacityModel(min_observations=4)``: at least one
                   promotion and no re-run after it;
               9d  the window on one card: a light bucket, then phase 5's
                   heaviest first-pass bucket, then the light bucket's
                   collect, with the side-stream copy and with a plain
                   ``.cpu()`` (``plain_copy_collect``), in turns; prints
                   the light collect's time and whether the heavy bucket
                   was still running (a measurement, not a check).
 10. boolean expressions — phase 4's index again, a log of 96 ∪/∩/∖
               expressions in the shape of ``benchmarks/fig_boolean_qps.py``
               (4 union bases ``(2j | 2j+1)``, each query ``base & extra``,
               every third ``(base & extra) - cut``), 32 ``zipf_query_log``
               conjunctions and 4 expressions that normalize to
               conjunctions (``a&b``, ``(a&b)&a``):
               10a ``SearchEngine.query_batch`` of the log (parse strings
                   and term lists), cache off: every answer equals numpy's
                   ``union1d`` / ``intersect1d`` / ``setdiff1d``, expression
                   and flat buckets both run, and both phase-1 and phase-2
                   kernels launch (path ``expression log``); a union base
                   at capacity 16 through ``intersect_expr_batch`` must
                   re-run at the total leaf width and agree; prints
                   queries/s, passes, re-runs, the bytes each route's
                   collects copied to the host (read off
                   ``core.engine._to_host``) and a profiled pass (busy share,
                   the sorts, ``searchsorted`` and copies by name);
               10b ``AsyncSearchEngine`` with the result cache on, flush
                   tier 1, warmed through ``warm_from_plans`` on the log:
                   the log submitted as parse strings and drained; every
                   answer equals the oracle, no expression or flat trace
                   at serve time, at least one subexpression-cache hit and
                   one host merge; prints the routes (device / subcache /
                   cache) and the mean submit time of each, the device
                   route split into expression and flat passes.
 11. sharded and 2-D — four logical shards on the one card
               (``make_shard_mesh(4, devices=["cuda:0"] * 4)``: each
               shard's mirror is a view of the card's mirror):
               11a phase 4's log through ``SearchEngine(..., mesh=...)
                   .query_batch``, every answer equal to phase 4's (the
                   oracle's), sharded passes run; the planted pair at
                   ``capacity_per_shard`` 16 re-runs exactly once;
               11b the log's first 64 queries and the planted pair
                   through ``AsyncSearchEngine(..., topology=
                   make_topology(2, 2, devices=["cuda:0"] * 4))``, warmed
                   at tiers 1-4, ``shard_min_g`` at the median group count
                   so that 2-D passes and balancer-placed buckets both run,
                   with no trace at serve time;
               11c phase 7's first 64 probes at k 8 through
                   ``SuggestEngine(..., mesh=..., shard_min_g=1)`` on phase
                   7's preprocessed sets, against the scipy oracle;
               11d phase 10's log through the sharded ``query_batch``,
                   against numpy's set routines;
               prints queries/s and probes/s sharded against
               single-device, timed in turns on the card (a measurement,
               not a check).
 12. observability and the load harness — phase 4's index again (lists
               shared, mirrors anew), a pool of 64 ``QueryMix`` draws over
               its 16 terms (seed 0), ``AsyncSearchEngine(flush_tier=8,
               deadline_us=2000, max_inflight=8)``, cache off, warmed on
               the pool at tiers 1-8:
               12a ``calibrate_cost`` on the pool's modal signature at tier
                   8, printing the ``CostModel`` and ``capacity_qps(8)``;
               12b ``run_virtual`` at 0.5x and 1.5x of that capacity (2 s,
                   diurnal +-50% with a 1 s period, two 20-query bursts a
                   second, seed 1): every answer equals the oracle, a
                   serve-time trace only in a bucket the backlog grew past
                   the warmed tiers, burn at 1.5x above 0 and above 0.5x's;
               12c ``run_wallclock`` with 4 submitters at 0.5x for 3 s on a
                   metrics-only engine (``Obs(trace=False)``) and a traced
                   one (``Obs(trace=True)``, same mirrors), in turns
                   (metrics, traced, traced, metrics), snapshots every
                   0.25 s: every answer equals the oracle, no thread
                   survives, one closed ``request`` root per ticket and no
                   open span, every ``bucket`` span with its ``dispatch`` /
                   ``device`` / ``collect`` children, a consistent snapshot
                   through both expositions, a non-empty ring; prints
                   served against offered queries/s, waits, end-to-end
                   latency, the traced/metrics ratio of served queries/s,
                   span medians by stage and the flusher's oversleep (how
                   long after its deadline a deadline-flushed bucket was
                   picked up), all on the host clock; then one more traced
                   run at 0.1x (base and burst rate scaled by 0.2), below
                   saturation, where the oversleep is the flusher's wake;
               12d ``calibrate_from_profile`` of the traced engine's
                   profile beside 12a's model; every bucket's signature
                   has residuals;
               12e a traced ``SuggestEngine`` on phase 8's corpus and 64
                   probes: every answer equals the scipy oracle, one closed
                   root per request, ``pair_count`` launched.
 13. the host route — 13a ``SearchEngine(use_device=False)`` on phase 4's
               lists serves phase 4's first 64 queries, the planted pair and
               the HashBin pair (RanGroupScan and HashBin in numpy): every
               answer equals the oracle and phase 4's, no kernel launches,
               ``torch.cuda.memory_allocated()`` unchanged; prints host
               queries/s; 13b ``examples/quickstart.py``'s sets through
               RanGroupScan (both recoveries), RanGroup, HashBin, IntGroup
               (both recoveries) and the seven baselines, all equal to
               ``np.intersect1d``, the low-bits, gamma and delta round
               trips, and ``space_report``.
 14. constrained LM decoding — ``get_config("qwen3-1.7b")`` unreduced (28
               layers, d 2048, V 151,936; fp32 weights from a seeded
               generator on the card, bf16 activations) through
               ``build_model``, ``ConstraintSet`` and ``DecodeServer``:
               14a 4 seeded prompts of 256 tokens: ``prefill``'s
                   last-position logits and ``decode``'s at every position
                   against a float32 reference (same weights, TF32 off,
                   logits in blocks of one prompt), and decode against
                   prefill, each within ``LM_TOL`` (largest row relative L2
                   error); the same comparison with the weights rounded to
                   e4m3 must fail it;
               14b ``DecodeServer(batch_slots=4, max_seq=512)`` on 16
                   seeded requests (prompts log-uniform in 8-128,
                   ``max_new`` 16-64), half constrained by three masks (an
                   allowed set, a whitelist, a banned stop-list): every
                   constrained token in numpy's intersection, every ticket
                   resolving to its request's tokens, the mask ops
                   bit-identical to the CPU's, an all-banned row giving
                   token 0, a one-slot server equal to a greedy loop over
                   ``model.decode``, and the ticker (4 requests from 2
                   threads, ``stop()``);
               14c a decode step (B 4, cache depth 512) beside its bound
                   (the weights read once), prefill tokens/s at B 4 x S
                   512, the server's tokens/s and ms a tick, the mask ops'
                   us at V 151,936 and k 3; the three kernels' launches
                   over the phase, 0, print apart.
 15. the other LM families — whisper-base, xlstm-350m, zamba2-2.7b and
               deepseek-moe-16b, in that order, each unreduced (fp32
               weights from a seeded generator on the card, bf16
               activations) and freed before the next; deepseek's 64.7 GB
               of weights leave room for no second copy, so no e4m3
               control and no bf16 copy (phase 14 shows that ``LM_TOL``
               separates bf16 from e4m3):
               15a 4 seeded prompts of 128 tokens (whisper also (4, 1500,
                   80) frames from numpy): ``prefill``'s last-position
                   logits and ``decode``'s at every position (whisper after
                   ``encdec.prefill_cross``) against a float32 prefill and
                   a float32 decode (TF32 off), and decode against prefill,
                   within ``LM_TOL`` for whisper; xlstm, zamba2 and
                   deepseek drift past it with depth in bf16 (the JAX
                   package too), so theirs are reported and each block,
                   fed the float32 stream, is held to ``LM_TOL`` instead;
                   float32 decode against float32 prefill held (zamba2:
                   reported, the reference's shared KV cache); for
                   deepseek the (token, layer) pairs whose top-6 experts
                   differ from float32 are counted, and only if some row
                   fails are the rows whose applied experts differ left
                   out, their largest error printed;
               15b ``DecodeServer(batch_slots=4, max_seq=64)`` on 8 seeded
                   requests (prompts log-uniform in 8-32, ``max_new``
                   8-16), half constrained by phase 14's three masks
                   scaled to the vocabulary: every constrained token in
                   the intersection, a one-slot server equal to a greedy
                   loop;
               15c the decode step (B 4, cache depth 128) beside its bound
                   (every weight byte once; deepseek also its active
                   parameters'), one profiled step, prefill at B 4 x S 512
                   (whisper: ``encode`` of 4 x 1500 frames), peak memory;
                   the three kernels' launches, 0, print apart.

Each phase prints its seconds.  It fails (non-zero exit, no final line) if
there is no GPU, a kernel does not build, launch or agree, a kernel is not
launched on one of its paths, or any answer is wrong.  A path's launches
are counted with every count set to 0 just before each of its runs and
read just after it: ``query_batch`` (phase 4), ``suggest_batch`` (phase 7,
after warming), ``SuggestEngine.warm`` (phase 7), ``suggest_batch small
sets`` (phase 8), ``AsyncSearchEngine.warm`` (9a), ``async 9a virtual
clock``, ``async 9b flusher`` (its ``query_batch`` baseline excluded) and
``async 9c adaptive``, ``expression log`` (10a), ``AsyncSearchEngine.warm
expressions`` and ``async 10b expressions``, ``11a sharded query_batch``,
``AsyncSearchEngine.warm 2x2``, ``async 11b 2x2``, ``11c sharded
suggest_batch`` and ``11d sharded expressions`` (phase 11's single-device
baselines excluded), ``async 12b virtual 0.5x`` / ``1.5x``, ``async 12c
metrics`` / ``traced`` (the first run of each), ``async 12c traced low``
and ``12e traced suggest_batch``; 13a's, 14's and 15's counts, 0 for
every kernel, print apart.  The
last lines are the kernel table as JSON (each kernel's ``launches`` on
its main path, phase 4 or 7, and ``launches_by_path``) and ``{"ok": true,
"device": {...}}``.  ``--report``
writes a fuller JSON report (every count, time and profile row) to PATH.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import subprocess
import sys
import threading
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

# -- the suggest slice: a corpus of sets its users would call real ----------
SUGGEST_SETS = 1024          # log-uniform sizes in [SUGGEST_MIN_LEN, MAX_LEN]
SUGGEST_MIN_LEN = 1 << 12
SUGGEST_MAX_LEN = 1 << 16
SUGGEST_UNIVERSE = 1 << 24   # element ids (benchmarks/fig_suggest_qps.py)
SUGGEST_PROBES = 256         # Zipf(ZIPF_A) probe ids over the corpus
ZIPF_A = 1.3
SUGGEST_K = 8
SUGGEST_BATCH = 16           # requests per suggest_batch call
SUGGEST_MIXED_K = (1, 20, 100)

# -- a mix of small sets, where the hash-bin pre-filter drops candidates ------
SMALL_SETS = 4096            # sizes uniform in [SMALL_MIN_LEN, SMALL_MAX_LEN]
SMALL_MIN_LEN, SMALL_MAX_LEN = 4, 16
SMALL_POOL = 4096            # shared element pool (fig_suggest_qps.py's default)
SMALL_PROBES = 64

# -- the online front end on phase 4's index (phase 9) ------------------------
ASYNC_QUERIES = 512          # repeated_query_log(range(N_TERMS), ...) plus
ASYNC_DISTINCT = 64          # the planted pair, inserted once
ASYNC_FLUSH_TIER = 8         # 9a: virtual clock, warmed at pow2_tiers(8)
ASYNC_GAP_US = 250.0
ASYNC_DEADLINES_US = (1000.0, 2000.0, 5000.0)
ASYNC_CACHE = 1024
FLUSHER_QUERIES = 256        # 9b: the log's first 256, background flusher
FLUSHER_RATES = (0.5, 0.9)   # of the queries/s query_batch sustains on them
FLUSHER_THREADS = 4
FLUSHER_TIER, FLUSHER_DEADLINE_US, FLUSHER_INFLIGHT = 64, 2000.0, 8
FLUSHER_PROFILED = 128       # queries in 9b's profiled run
ADAPTIVE_REPEATS = 8         # 9c: serves of the planted pair

# -- boolean expressions on phase 4's index (phase 10) -------------------------
EXPR_QUERIES = 96            # shared_subtree_log: base & extra, every third
EXPR_BASES = 4               # (base & extra) - cut; bases (2j | 2j+1)
EXPR_FLAT = 32               # zipf_query_log conjunctions mixed in
EXPR_FORCED_CAP = 16         # 10a: a union base at capacity 16 must re-run
EXPR_FLUSH_TIER = 1          # 10b: each submit flushes at once, so later
EXPR_CACHE = 1024            # roots over a served base merge on the host

# -- z-sharded and 2-D execution on one card (phase 11) ------------------------
SHARDS = 4                   # 11a, 11c, 11d: make_shard_mesh(4) over the card
LAYOUT_2D = (2, 2)           # 11b: make_topology(2, 2) over the card
SHARDED_FORCED_CAP = 16      # 11a: the planted pair must re-run once
MESH_QUERIES = 64            # 11b: phase 4's first 64 queries + the planted
MESH_FLUSH_TIER = 4          # pair, warmed at tiers 1-4
MESH_PROBES = 64             # 11c: phase 7's first 64 probes

# -- observability and the load harness on phase 4's index (phase 12) ----------
OBS_POOL = 64                # QueryMix draws over phase 4's 16 terms, seed 0
OBS_FLUSH_TIER = 8           # flush tier, warmed at pow2_tiers(8)
OBS_DEADLINE_US = 2000.0
OBS_INFLIGHT = 8
OBS_VIRTUAL_RATES = (0.5, 1.5)   # 12b: of the calibrated tier-8 capacity
OBS_WALL_RATE = 0.5          # 12c: run_wallclock at 0.5x for 3 s
OBS_WALL_S = 3.0
OBS_LOW_SCALE = 0.2          # 12c: one more traced run, the shape scaled to
                             # 0.1x (base and burst rate): the flusher's wake
OBS_SUBMITTERS = 4
OBS_SNAPSHOT_S = 0.25

# -- the host route on phase 4's lists (phase 13) -------------------------------
HOST_QUERIES = 64            # 13a: phase 4's first 64 + planted + HashBin pair

# -- constrained LM decoding at qwen3-1.7b's full width (phase 14) -----------
LM_ARCH = "qwen3-1.7b"       # 28 layers, d 2048, 16/8 heads of 128, V 151,936
LM_PROMPTS, LM_PROMPT_LEN = 4, 256   # 14a: seeded prompts, every position
# 14a tolerance: the largest, over positions, of a logit row's relative L2
# error.  bf16 rounds at 2^-9, and each of 28 layers adds a few such
# roundings of unit-scale activations to the residual: CPU runs of the same
# function cut to 2 and 8 layers gave 1.1% and 1.8% against float32, and
# the same weights rounded to e4m3 (3 mantissa bits, per-tensor scale)
# 9.3% and 15%.  8% leaves bf16 about twice its projected 28-layer error
# and sits below the e4m3 control.  Decode and prefill are two bf16
# evaluations of one function, so they are held to the same bound.
LM_TOL = 0.08
LM_SLOTS, LM_MAX_SEQ = 4, 512        # 14b: DecodeServer
LM_REQUESTS = 16                     # half of them constrained
LM_PROMPT_RANGE = (8, 128)           # log-uniform prompt lengths
LM_MAX_NEW_RANGE = (16, 64)          # uniform max_new
LM_ALLOWED, LM_WHITELIST, LM_STOP = 60000, 90000, 1000   # the three masks
LM_MASK_VOCAB = 151936               # phase 15 scales them to its vocabularies
LM_TICKER_REQUESTS, LM_TICKER_THREADS = 4, 2
LM_PREFILL_LEN = 512                 # 14c: prefill timed at B 4, S 512
LM_PREFILL_ITERS = 5
LM_PROFILED_STEPS = 1                # 14c: decode steps under the profiler

# -- the moe, ssm_hybrid, xlstm and encdec families unreduced (phase 15) ------
# run in this order; deepseek-moe-16b (64.7 GB of fp32 weights) last, after
# everything before it is freed
FAM_ARCHS = ("whisper-base", "xlstm-350m", "zamba2-2.7b", "deepseek-moe-16b")
FAM_PROMPTS, FAM_PROMPT_LEN = 4, 128     # 15a: seeded prompts, every position
FAM_REQUESTS = 8                         # 15b: half of them constrained
FAM_PROMPT_RANGE = (8, 32)               # log-uniform prompt lengths
FAM_MAX_NEW_RANGE = (8, 16)              # uniform max_new
FAM_SLOTS, FAM_MAX_SEQ = 4, 64           # 15b: DecodeServer
FAM_STEP_DEPTH = 128                     # 15c: decode step, B 4, depth 128
FAM_PREFILL_LEN = 512                    # 15c: prefill B 4 x S 512 (whisper:
FAM_PREFILL_ITERS = 3                    # encode of encoder_seq frames)
FAM_STEP_ITERS = 10
# the families whose bf16 logits are held to LM_TOL end to end; in the
# others random-init depth amplifies bf16 rounding past it in the JAX
# package too (tools/lm_drift.py; PERF.md §6), so each block is held
FAM_E2E_HELD = ("whisper-base",)
# a MoE block's top-k flip between bf16 and float32 on the same input needs
# the k-th and (k+1)-th router log-probabilities this near: 16 units of
# bf16 rounding (the router's input is rounded in the block's attention,
# residual add and norm, and its logits sum d_model such errors)
FAM_NEAR_TIE = 16 * 2.0 ** -8

# -- the card: published H100 SXM peaks (NVIDIA data sheet, whitepaper) ----
HBM_BYTES_PER_S = 3.35e12
# int32 compares: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BF16_OPS_PER_S = 989e12      # dense bf16 tensor-core rate
TIME_ITERS = 20
# the earlier design's times at the same shapes (it scanned every -1 slot;
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
EARLIER_MS = {"group_match": 0.9724, "pair_count": 3.4446}
PLAIN_COUNT_ITERS = 3        # count_block_ref takes ~a second at its heaviest


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


def edge_rows(torch, gen, kind, shape, device="cuda"):
    """Rows of the edge cases, each (..., g): ``left``, a real prefix of
    random length and a -1 tail, as ``DeviceSet`` pads its mirrors;
    ``full``, no -1; ``pad``, only -1; ``dup``, values from 0-7 (repeats
    within a row) with -1 at random places; ``random``, as ``random_rows``."""
    if kind == "pad":
        return torch.full(shape, -1, dtype=torch.int32, device=device)
    hi = 8 if kind == "dup" else 500
    x = torch.randint(0, hi, shape, dtype=torch.int32, generator=gen,
                      device=device)
    if kind == "left":
        real = torch.randint(0, shape[-1] + 1, shape[:-1] + (1,),
                             generator=gen, device=device)
        x[torch.arange(shape[-1], device=device) >= real] = -1
    elif kind in ("dup", "random"):
        x[torch.rand(shape, generator=gen, device=device) < 0.25] = -1
    return x


def misaligned(torch, x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary, so the kernels take their scalar loads."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


# (a, b) kinds of the edge cases: left-filled, full, all -1 on each side and
# both, duplicates, and mixes
EDGE_KINDS = (("left", "left"), ("full", "full"), ("pad", "full"),
              ("full", "pad"), ("pad", "pad"), ("dup", "dup"),
              ("left", "dup"), ("random", "left"))


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
    n_edge = check_group_match_edges(torch, ref, group_match_cuda)
    print(f"phase 3 group_match: {len(cases) + 2} shapes and {n_edge} edge "
          f"cases bit-identical to the plain version")
    return worst, len(cases) + 2 + n_edge


def check_group_match_edges(torch, ref, group_match_cuda) -> int:
    """``group_match`` bit for bit against ``group_match_ref`` on the edge
    cases (``EDGE_KINDS`` on each side), at the path's widths and at widths
    of 1, 3, 5 and 33, plus misaligned rows.  Its own generator, so the
    seeded cases before and after draw what they always drew."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    widths = ((32, 32), (16, 64), (1, 1), (3, 5), (5, 33), (33, 3),
              (33, 33), (1, 33), (33, 1), (3, 3))
    n = 0
    for ka, kb in EDGE_KINDS + (("random", "random"),):
        for S in (37, 4099):
            for ga, gb in widths:
                a = edge_rows(torch, gen, ka, (S, ga))
                b = edge_rows(torch, gen, kb, (S, gb))
                pairs = [(a, b)]
                if (ga, gb) == (32, 32):
                    pairs.append((misaligned(torch, a), misaligned(torch, b)))
                for x, y in pairs:
                    out = group_match_cuda(x, y)
                    want = ref.group_match_ref(x, y)
                    torch.cuda.synchronize()
                    err = max_abs_err(torch, out, want)
                    require(err == 0, f"group_match edge {ka}/{kb} "
                                      f"{(S, ga, gb)}: max_abs_err {err}")
                    if "pad" in (ka, kb):
                        require(not bool(out.any()),
                                f"group_match edge {ka}/{kb} matched -1")
                    n += 1
    return n


# -- phase 6: pair_count against its plain version --------------------------

def count_mirror(torch, gen, t, g, lo=0, hi=400):
    """A (2^t, g) int32 mirror: small values (many hits) and -1 padding."""
    x = torch.randint(lo, hi, (1 << t, g), dtype=torch.int32, generator=gen,
                      device="cuda")
    x[torch.rand((1 << t, g), generator=gen, device="cuda") < 0.3] = -1
    return x


def check_count_table(torch, ref, count_block_cuda, table) -> int:
    """The kernel's (B, c_tier) counts against the plain version's."""
    out = count_block_cuda(table)
    want = ref.count_block_ref(table.probes, table.cands, table.ts,
                               c_tier=table.c_tier)
    torch.cuda.synchronize()
    return max_abs_err(torch, out, want)


def check_pair_count(torch, gen, ref, count_block_cuda, make_count_table):
    """``pair_count`` bit for bit against ``count_block_ref`` over both
    alignment directions and equal depths, g tiers 8-128, (B, C) of (1, 1),
    (1, 3) and (16, 3) (c_tier 4, rows of 1-3 candidates) and (16, 1024),
    plus all-sentinel probes, disjoint sets and identical sets."""
    worst, n = 0, 0
    for tp, tc in ((7, 4), (5, 5), (3, 6)):
        for gp, gc in ((8, 8), (16, 128), (128, 32), (64, 64), (128, 128)):
            pool = [count_mirror(torch, gen, tc, gc) for _ in range(48)]
            for B, C in ((1, 1), (1, 3), (16, 3), (16, 1024)):
                probes = [count_mirror(torch, gen, tp, gp) for _ in range(B)]
                pick = torch.randint(0, len(pool), (B, C), generator=gen,
                                     device="cuda").tolist()
                lens = [C] + [1 + (b * 7) % C for b in range(1, B)]
                cands = [[pool[i] for i in row[:ln]]
                         for row, ln in zip(pick, lens)]
                table = make_count_table(probes, cands, (tp, tc),
                                         c_tier=1 << (C - 1).bit_length())
                err = check_count_table(torch, ref, count_block_cuda, table)
                require(err == 0, f"pair_count ts {(tp, tc)} g {(gp, gc)} "
                                  f"B {B} C {C}: max_abs_err {err}")
                worst, n = max(worst, err), n + 1
    # all-sentinel probe rows and disjoint sets count 0; a set against
    # itself or its copy counts every element once
    for tp, tc in ((6, 4), (5, 5), (4, 6)):
        pad = torch.full((1 << tp, 32), -1, dtype=torch.int32, device="cuda")
        low = count_mirror(torch, gen, tp, 32, 0, 1000)
        high = count_mirror(torch, gen, tc, 64, 5000, 9000)
        table = make_count_table([pad, low], [[high], [high]], (tp, tc))
        out = count_block_cuda(table)
        require(not bool(out.any()), f"sentinel/disjoint counted {out}")
        worst = max(worst, check_count_table(torch, ref, count_block_cuda,
                                             table))
        n += 1
    for t, g in ((5, 8), (8, 64), (10, 128)):
        perm = torch.randperm(1 << (t + 7), generator=gen, device="cuda")
        s = perm[:(1 << t) * g].to(torch.int32).view(1 << t, g)
        s[torch.rand(s.shape, generator=gen, device="cuda") < 0.4] = -1
        real = int((s != -1).sum())
        table = make_count_table([s], [[s, s.clone(), s.flip(0).contiguous()]],
                                 (t, t))
        out = count_block_cuda(table)
        torch.cuda.synchronize()
        require(out[0, :2].tolist() == [real, real],
                f"identical sets counted {out[0].tolist()}, want {real}")
        worst = max(worst, check_count_table(torch, ref, count_block_cuda,
                                             table))
        n += 1
    n_edge = check_pair_count_edges(torch, ref, count_block_cuda,
                                    make_count_table)
    print(f"phase 6 pair_count: {n} tables and {n_edge} edge-case tables "
          f"bit-identical to the plain version")
    return worst, n + n_edge


def check_pair_count_edges(torch, ref, count_block_cuda, make_count_table
                           ) -> int:
    """``pair_count`` bit for bit against ``count_block_ref`` on mirrors of
    the edge kinds (``EDGE_KINDS``: probe kind, candidate kind) in both
    alignment directions and at equal depths, at the path's g tiers and at
    odd widths, plus misaligned mirrors.  Its own generator, so the seeded
    tables draw what they always drew."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    n = 0
    for tp, tc in ((7, 4), (5, 5), (3, 6)):
        for gp, gc in ((32, 32), (8, 128), (3, 5), (33, 8)):
            for kp, kc in EDGE_KINDS:
                probes = [edge_rows(torch, gen, kp, (1 << tp, gp))
                          for _ in range(4)]
                pool = [edge_rows(torch, gen, kc, (1 << tc, gc))
                        for _ in range(4)]
                tables = [([probes[b] for b in range(4)],
                           [[pool[(b + j) % 4] for j in range(3 - b % 2)]
                            for b in range(4)])]
                if (gp, gc) == (32, 32):
                    tables.append(([misaligned(torch, x) for x in probes],
                                   [[misaligned(torch, x) for x in row]
                                    for row in tables[0][1]]))
                for ps, cs in tables:
                    table = make_count_table(ps, cs, (tp, tc), c_tier=4)
                    err = check_count_table(torch, ref, count_block_cuda,
                                            table)
                    require(err == 0, f"pair_count edge {kp}/{kc} ts "
                                      f"{(tp, tc)} g {(gp, gc)}: "
                                      f"max_abs_err {err}")
                    n += 1
    return n


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
    # the compares of real elements: real A x real B, summed over the rows
    real_compares = int(((a != -1).sum(-1, dtype=torch.int64)
                         * (b != -1).sum(-1, dtype=torch.int64)).sum())
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
        "real_compares": real_compares,
        "max_abs_err": gm_err,
    }
    gm["share_of_bound"] = gm["bound_ms"] / gm["ms"]
    gm["earlier_ms"] = EARLIER_MS["group_match"]
    print(f"phase 5 bitmap_filter at {bf['shape']}: {bf['ms']:.4f} ms "
          f"(plain {bf['plain_ms']:.4f} ms), {bf_bytes} bytes, bound "
          f"{bf['bound_ms']:.4f} ms at {HBM_BYTES_PER_S:.3g} B/s")
    print(f"phase 5 group_match at {gm['shape']}: {gm['ms']:.4f} ms "
          f"(plain {gm['plain_ms']:.4f} ms; earlier design "
          f"{gm['earlier_ms']:.4f} ms), {gm_bytes} bytes, {compares} "
          f"compares at the padded tiers of which {real_compares} "
          f"({real_compares / compares:.4f}) are of real elements, bound "
          f"{gm['bound_ms']:.4f} ms ({gm['bound_by']}), "
          f"{gm['share_of_bound']:.1%} of it")
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


def profile_breakdown(torch, run,
                      groups=("bitmap_filter", "group_match", "pair_count")):
    """Device time by kernel name over one more pass (``run()``), and the
    device's busy share of that pass's wall time (None where the profiler
    saw nothing).  ``kernel_ms`` sums, for each of ``groups``, the rows
    whose name holds it (case-insensitive); a row counts once, to the first
    group that matches, so ``searchsorted`` listed before ``sort`` keeps
    its rows out of the sorts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
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
    kernel_ms = dict.fromkeys(groups, 0.0)
    for name, ms, _ in rows:
        group = next((k for k in groups if k.lower() in name.lower()), None)
        if group is not None:
            kernel_ms[group] += ms
    return {
        "wall_s": wall,
        "device_busy_ms": busy_ms if rows else None,
        "device_busy_share": busy_ms / (wall * 1e3) if rows else None,
        "top": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:12]],
        "device_calls": sum(c for _, _, c in rows),
        # each kernel's device ms over all its rows (one per template width)
        "kernel_ms": kernel_ms,
    }


# -- phase 7: the suggest slice ----------------------------------------------

def make_suggest_corpus(seed: int = SEED, n_sets: int = SUGGEST_SETS,
                        min_len: int = SUGGEST_MIN_LEN,
                        max_len: int = SUGGEST_MAX_LEN,
                        universe: int = SUGGEST_UNIVERSE):
    """Sets 0..n_sets-1 with log-uniform sizes and uniform element ids, plus
    two exact copies of set 0 as ids n_sets and n_sets+1, which force
    count ties (as ``benchmarks/fig_suggest_qps.py`` does)."""
    rng = np.random.default_rng(seed + 2)
    lens = np.exp(rng.uniform(math.log(min_len), math.log(max_len), n_sets))
    corpus = {sid: sample_ids(rng, int(n), universe)
              for sid, n in enumerate(lens.astype(np.int64))}
    corpus[n_sets] = corpus[0].copy()
    corpus[n_sets + 1] = corpus[0].copy()
    return corpus


def zipf_probe_log(set_ids, n_queries: int, seed: int, a: float = ZIPF_A):
    """Zipf-skewed probe ids, as ``benchmarks/fig_suggest_qps.py`` draws
    them: head probes repeat, which is the result cache's traffic."""
    rng = np.random.default_rng(seed)
    ids = sorted(set_ids)
    ranks = np.minimum(rng.zipf(a, size=n_queries) - 1, len(ids) - 1)
    return [ids[r] for r in ranks]


class SuggestOracle:
    """Exact top-K from a set x element incidence matrix (scipy.sparse):
    one sparse product gives every probe's count against every set; pairs
    sort by (-count, id).  Independent of the port."""

    def __init__(self, corpus):
        import scipy.sparse as sp

        self.ids = sorted(corpus)
        lens = [len(corpus[i]) for i in self.ids]
        indptr = np.concatenate([[0], np.cumsum(lens)])
        indices = np.concatenate([corpus[i] for i in self.ids]).astype(np.int64)
        self.matrix = sp.csr_matrix(
            (np.ones(len(indices), np.int32), indices, indptr),
            shape=(len(self.ids), int(indices.max()) + 1))
        self.row = {sid: r for r, sid in enumerate(self.ids)}
        self.counts = {}

    def prepare(self, probes):
        todo = sorted(set(probes) - set(self.counts))
        if todo:
            prod = (self.matrix[[self.row[p] for p in todo]]
                    @ self.matrix.T).toarray()
            for p, counts in zip(todo, prod):
                self.counts[p] = counts

    def topk(self, sid, k):
        counts = self.counts[sid]
        order = sorted((-int(n), c) for c, n in zip(self.ids, counts)
                       if c != sid and n >= 1)
        return [(c, -n) for n, c in order[:k]]


def serve_suggest(engine, log, k, batch, oracle, clear_cache=False,
                  sync=lambda: None):
    """The probe log in micro-batches of ``batch`` through
    ``suggest_batch``; returns (results, wall s) after checking every answer
    against the oracle.  ``clear_cache`` empties the result cache before
    each micro-batch, so every request runs its device passes."""
    sync()
    t0 = time.perf_counter()
    results = []
    for i in range(0, len(log), batch):
        if clear_cache:
            engine.cache.invalidate()
        results.extend(engine.suggest_batch([(s, k) for s in log[i:i + batch]]))
    sync()
    wall = time.perf_counter() - t0
    for sid, res in zip(log, results):
        want = oracle.topk(sid, k)
        require(res.suggestions == want,
                f"suggest({sid}, {k}): {res.suggestions[:4]}..., oracle "
                f"{want[:4]}...")
    return results, wall


def suggest_buckets(engine, log, k, batch):
    """The count buckets an uncached pass of the log runs: [(sig, rows)]
    per micro-batch, rows as ``dispatch_count_batch`` takes them."""
    from repro_torch.exec.batch import bucket_plans

    out = []
    for i in range(0, len(log), batch):
        plans = [p for sid in log[i:i + batch]
                 for p in engine._plans_for(sid, k) if p.algorithm == "device"]
        for sig, items in bucket_plans(enumerate(plans)).items():
            sets = engine.device.sets
            out.append((sig, [(sets[p.terms[0]], [sets[t] for t in p.terms[1:]])
                              for _, p in items]))
    return out


class PairWork:
    """The int32 compares the count function needs for one (probe,
    candidate) pair: each real element (not -1) of the deeper set's row z
    against each real element of the shallower set's row z >> d.  Rows'
    real-element counts are read once per mirror from the card; pairs are
    cached, since a Zipf log repeats them."""

    def __init__(self):
        self._rows, self._pairs = {}, {}

    def rows(self, s) -> np.ndarray:
        if id(s) not in self._rows:  # the mirror is held, so ids stay unique
            self._rows[id(s)] = (s, (s.vals != -1).sum(-1).cpu().numpy())
        return self._rows[id(s)][1]

    def __call__(self, probe, cand) -> int:
        key = (id(probe), id(cand))
        if key not in self._pairs:
            deep, shallow = (probe, cand) if probe.t >= cand.t else (cand, probe)
            nb = self.rows(shallow)
            na = self.rows(deep).reshape(len(nb), -1).sum(1)
            self._pairs[key] = int(na @ nb)
        return self._pairs[key]


def bucket_work(sig, rows, pair_work) -> dict:
    """What one count bucket needs at least: ``compares``, each real element
    of the iterated side against each real element of its aligned row
    (``PairWork``), and ``bytes``, each distinct mirror read once, the
    pointer table read and the counts written.  ``tile_compares`` is the
    work of the TPU kernel's padded tiles, G·gp·gc per pair (every -1 slot
    compared), which ``pair_count`` also scans; it is kept beside, not used
    for the bound."""
    G = 1 << max(sig.ts)
    pairs = sum(len(cands) for _, cands in rows)
    mirrors = {id(s): s for p, cands in rows for s in [p, *cands]}
    bytes_ = sum(s.vals.numel() * 4 for s in mirrors.values())
    bytes_ += len(rows) * (1 + sig.cands) * 8 + len(rows) * sig.cands * 4
    compares = sum(pair_work(p, c) for p, cands in rows for c in cands)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = compares / INT32_OPS_PER_S * 1e3
    return {"compares": compares, "bytes": bytes_,
            "tile_compares": pairs * G * sig.gmaxes[0] * sig.gmaxes[1],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def direction(sig) -> int:
    """1 when the probe iterates (tp > tc), -1 when the candidate does, 0
    for equal depths."""
    return (sig.ts[0] > sig.ts[1]) - (sig.ts[0] < sig.ts[1])


def time_pair_count(torch, ref, count_block_cuda, buckets, works):
    """Check ``pair_count`` against its plain version on the heaviest count
    bucket of each alignment direction the path ran (its own pointer
    table), then time both on the heaviest bucket of all."""
    from repro_torch.core.engine import _count_signature, _pack_count_rows

    heaviest = {}
    for i, ((sig, _), work) in enumerate(zip(buckets, works)):
        d = direction(sig)
        if d not in heaviest or work["compares"] > works[heaviest[d]]["compares"]:
            heaviest[d] = i
    def table_of(i):
        rows = buckets[i][1]
        return _pack_count_rows(rows, _count_signature(rows)[1])

    for d, i in sorted(heaviest.items()):
        sig, rows = buckets[i]
        table = table_of(i)
        err = check_count_table(torch, ref, count_block_cuda, table)
        require(err == 0, f"pair_count on the path {sig}: max_abs_err {err}")
        print(f"phase 7 pair_count on the heaviest bucket of direction {d} "
              f"(ts {sig.ts}, gmaxes {sig.gmaxes}, B {len(rows)}, c_tier "
              f"{table.c_tier}) bit-identical to the plain version")
    timed = max(heaviest.values(), key=lambda i: works[i]["compares"])
    sig, rows = buckets[timed]
    table = table_of(timed)
    work = works[timed]
    out = {
        "sig": {"ts": list(sig.ts), "gmaxes": list(sig.gmaxes),
                "c_tier": table.c_tier, "B": len(rows)},
        "checked_directions": sorted(heaviest),
        "ms": cuda_ms(torch, lambda: count_block_cuda(table)),
        "plain_ms": cuda_ms(torch, lambda: ref.count_block_ref(
            table.probes, table.cands, table.ts, c_tier=table.c_tier),
            iters=PLAIN_COUNT_ITERS),
        **work, "max_abs_err": 0,
        "earlier_ms": EARLIER_MS["pair_count"],
    }
    out["share_of_bound"] = work["bound_ms"] / out["ms"]
    print(f"phase 7 pair_count timed on ts {sig.ts}: {out['ms']:.4f} ms "
          f"(plain {out['plain_ms']:.4f} ms; earlier design "
          f"{out['earlier_ms']:.4f} ms); {work['compares']} compares of "
          f"real elements ({work['tile_compares']} at the TPU's padded "
          f"tiles), {work['bytes']} bytes, bound {work['bound_ms']:.4f} ms "
          f"({work['bound_by']}), {out['share_of_bound']:.1%} of it")
    return out


def run_suggest_slice(torch, ref, count_block_cuda, report):
    """Phase 7: build the corpus, ingest it through the port's RSI1 reader,
    serve the Zipf probe log cached and uncached and a mixed-k batch, all
    against the oracle; profile a pass; check and time ``pair_count`` on
    the heaviest bucket.  Returns (pair_count launches on the path, its
    launches while warming, kernel times, (engine, oracle, probe log)) —
    phase 11 serves the same corpus sharded."""
    from repro_torch.core.engine import EXEC_COUNTERS, pow2_tiers
    from repro_torch.data.ingest import ingest_file, write_records
    from repro_torch.serve.search import SuggestEngine

    t0 = time.perf_counter()
    corpus = make_suggest_corpus()
    n_elems = sum(len(v) for v in corpus.values())
    path = ROOT / "build" / "suggest_corpus.rsi"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_records(path, sorted(corpus.items()))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = SuggestEngine({}, w=W_BITS, m=M_IMAGES, seed=SEED, device="cuda")
    n_ingested = ingest_file(path, engine)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    path.unlink()
    require(n_ingested == len(corpus), f"ingested {n_ingested} of {len(corpus)}")
    index_bytes = sum(s.vals.numel() * 4 + s.images.numel() * 4
                      for s in engine.device.sets.values())
    classes = {}
    for s in engine.device.sets.values():
        classes[(s.t, s.gmax)] = classes.get((s.t, s.gmax), 0) + 1
    print(f"phase 7 corpus: {len(corpus)} sets, {n_elems} elements, sizes "
          f"{min(map(len, corpus.values()))}..{max(map(len, corpus.values()))};"
          f" (t, gmax tier) classes {dict(sorted(classes.items()))}; data "
          f"{gen_s:.1f} s, ingest and preprocessing {ingest_s:.1f} s, device "
          f"bytes {index_bytes}")

    log = zipf_probe_log(range(SUGGEST_SETS + 2), SUGGEST_PROBES, SEED + 3)
    dup_a, dup_b = SUGGEST_SETS, SUGGEST_SETS + 1
    mixed = [(sid, k) for k in SUGGEST_MIXED_K
             for sid in sorted(set(log))[:SUGGEST_BATCH // 2] + [dup_b]]
    t0 = time.perf_counter()
    oracle = SuggestOracle(corpus)
    oracle.prepare(log + [sid for sid, _ in mixed])
    oracle_s = time.perf_counter() - t0

    sync = torch.cuda.synchronize
    # warm what the probe log and the mixed-k batch will meet, at every
    # tier up to a micro-batch (and up to the mixed batch's rows)
    t0 = time.perf_counter()
    EXEC_COUNTERS.reset()
    count_block_cuda.launches = 0
    warmed = len(engine.warm(sorted(set(log)), SUGGEST_K,
                             b_tiers=pow2_tiers(SUGGEST_BATCH)))
    mixed_ids = sorted({sid for sid, _ in mixed})
    for k in SUGGEST_MIXED_K:
        warmed += len(engine.warm(mixed_ids, k,
                                  b_tiers=pow2_tiers(SUGGEST_BATCH)))
    sync()
    warm_s = time.perf_counter() - t0
    warm_launches = count_block_cuda.launches
    warm = EXEC_COUNTERS.snapshot()
    require(warm_launches > 0, "pair_count never launched while warming")
    print(f"phase 7 warm: {warmed} count signatures at tiers "
          f"{pow2_tiers(SUGGEST_BATCH)}, {warm['warm_executions']} warm "
          f"executions, {warm_launches} pair_count launches, "
          f"{warm['count_traces']} traces, {warm_s:.1f} s")
    count_block_cuda.launches = 0
    EXEC_COUNTERS.reset()
    cached, cached_wall = serve_suggest(engine, log, SUGGEST_K, SUGGEST_BATCH,
                                        oracle, sync=sync)
    cached_counters = EXEC_COUNTERS.snapshot()
    cached_launches = count_block_cuda.launches
    EXEC_COUNTERS.reset()
    _, wall = serve_suggest(engine, log, SUGGEST_K, SUGGEST_BATCH, oracle,
                            clear_cache=True, sync=sync)
    counters = EXEC_COUNTERS.snapshot()
    uncached_launches = count_block_cuda.launches - cached_launches
    engine.cache.invalidate()
    EXEC_COUNTERS.reset()
    sync()
    t0 = time.perf_counter()
    got = engine.suggest_batch(mixed)
    sync()
    mixed_wall = time.perf_counter() - t0
    mixed_traces = EXEC_COUNTERS["count_traces"]
    launches = count_block_cuda.launches
    serve_traces = (cached_counters["count_traces"], counters["count_traces"],
                    mixed_traces)
    require(serve_traces == (0, 0, 0),
            f"count_traces while serving after warming: {serve_traces}")
    for (sid, k), res in zip(mixed, got):
        require(res.suggestions == oracle.topk(sid, k),
                f"suggest({sid}, {k}) disagrees with the oracle")
        require(res.algorithm == "suggest/device", res.algorithm)
    require(launches > 0, "pair_count never launched")
    top = engine.suggest(dup_b, SUGGEST_K).suggestions
    require([c for c, _ in top[:2]] == [0, dup_a],
            f"probing {dup_b} ranks {top[:2]}, want 0 then {dup_a}")
    buckets = suggest_buckets(engine, log, SUGGEST_K, SUGGEST_BATCH)
    directions = {direction(s) for s, _ in buckets}
    require({1, -1} <= directions,
            f"alignment directions served: {sorted(directions)}")
    pairs = sum(len(c) for _, rows in buckets for _, c in rows)
    pair_work = PairWork()
    works = [bucket_work(sig, rows, pair_work) for sig, rows in buckets]
    compares = sum(w["compares"] for w in works)
    tile_compares = sum(w["tile_compares"] for w in works)
    pass_bound_ms = sum(w["bound_ms"] for w in works)
    hits = sum(bool(r.stats.get("cached")) for r in cached)
    selectivity = counters["suggest_prefilter_kept"] / max(
        1, counters["suggest_prefilter_in"])
    print(f"phase 7 suggest, cached: {len(log)} probes ({len(set(log))} "
          f"distinct) at k {SUGGEST_K} in micro-batches of {SUGGEST_BATCH}: "
          f"wall {cached_wall:.3f} s, "
          f"{len(log) / cached_wall:.1f} QPS, {hits} cache hits, "
          f"{cached_counters['count_calls']} count passes, {cached_launches} "
          f"pair_count launches, serve-time count_traces 0")
    print(f"phase 7 suggest, cache cleared per micro-batch: wall {wall:.3f} s, "
          f"{len(log) / wall:.1f} QPS, {counters['count_calls']} count passes, "
          f"{uncached_launches} pair_count launches, {len(buckets)} buckets "
          f"(directions {sorted(directions)}), {pairs} pairs, {compares} "
          f"compares of real elements ({tile_compares} at the TPU's padded "
          f"tiles; bound {pass_bound_ms:.4f} ms), prefilter kept "
          f"{counters['suggest_prefilter_kept']} of "
          f"{counters['suggest_prefilter_in']} ({selectivity:.4f}), "
          f"{counters['collect_us']} us in collect")
    print(f"phase 7 mixed k {SUGGEST_MIXED_K}: {len(mixed)} requests in "
          f"{mixed_wall:.3f} s; probing {dup_b} ranks 0 before {dup_a}; every "
          f"answer equals the oracle ({oracle_s:.1f} s to build it)")

    def uncached_pass():
        for i in range(0, len(log), SUGGEST_BATCH):
            engine.cache.invalidate()
            engine.suggest_batch([(s, SUGGEST_K) for s in log[i:i + SUGGEST_BATCH]])

    prof = profile_breakdown(torch, uncached_pass)
    kernel_ms = prof["kernel_ms"]["pair_count"]
    print(f"phase 7 profiled uncached pass: wall {prof['wall_s']:.3f} s, "
          f"device busy {prof['device_busy_ms']} ms, share "
          f"{prof['device_busy_share']}; pair_count {kernel_ms:.3f} ms against "
          f"the pass's bound of {pass_bound_ms:.4f} ms")
    for row in prof["top"][:8]:
        print(f"  {row['ms']:10.3f} ms  {row['calls']:6d}x  {row['name'][:90]}")
    timed = time_pair_count(torch, ref, count_block_cuda, buckets, works)
    engine.cache.invalidate()
    report["suggest"] = {
        "sets": len(corpus), "elements": n_elems, "probes": len(log),
        "k": SUGGEST_K, "batch": SUGGEST_BATCH, "data_s": gen_s,
        "ingest_s": ingest_s, "oracle_s": oracle_s,
        "index_device_bytes": index_bytes,
        "cached_wall_s": cached_wall, "cached_qps": len(log) / cached_wall,
        "cached_counters": cached_counters, "cache_hits": hits,
        "uncached_wall_s": wall, "uncached_qps": len(log) / wall,
        "uncached_counters": counters, "prefilter_selectivity": selectivity,
        "launches": {"cached": cached_launches, "uncached": uncached_launches,
                     "total": launches},
        "buckets": len(buckets), "pairs": pairs, "compares": compares,
        "tile_compares": tile_compares, "pass_bound_ms": pass_bound_ms, "profiled_pair_count_ms": kernel_ms,
        "classes": {f"{t},{g}": n for (t, g), n in sorted(classes.items())},
        "mixed_wall_s": mixed_wall, "profile": prof, "pair_count": timed,
        "warm": {"signatures": warmed, "s": warm_s, "counters": warm,
                 "launches": warm_launches},
    }
    return launches, warm_launches, timed, (engine, oracle, log)


def make_small_corpus(seed: int = SEED, n_sets: int = SMALL_SETS,
                      min_len: int = SMALL_MIN_LEN,
                      max_len: int = SMALL_MAX_LEN, pool: int = SMALL_POOL):
    """Sets of min_len..max_len elements drawn from one shared pool, as
    ``benchmarks/fig_suggest_qps.py``'s ``random_corpus`` draws them."""
    rng = np.random.default_rng(seed + 4)
    ids = rng.choice(SUGGEST_UNIVERSE, size=pool, replace=False)
    return {sid: np.sort(rng.choice(ids, size=int(n), replace=False))
            .astype(np.uint32)
            for sid, n in enumerate(rng.integers(min_len, max_len + 1, n_sets))}


def run_small_sets(torch, count_block_cuda, report) -> int:
    """Phase 8: small sets fill few of the 256 hash bins, so the pre-filter
    drops most candidates; Zipf probes served with the cache cleared per
    micro-batch must still equal the oracle.  Returns ``pair_count``'s
    launches there."""
    from repro_torch.core.engine import EXEC_COUNTERS
    from repro_torch.serve.search import SuggestEngine

    corpus = make_small_corpus()
    t0 = time.perf_counter()
    engine = SuggestEngine(corpus, w=W_BITS, m=M_IMAGES, seed=SEED,
                           device="cuda")
    build_s = time.perf_counter() - t0
    log = zipf_probe_log(corpus, SMALL_PROBES, SEED + 5)
    oracle = SuggestOracle(corpus)
    oracle.prepare(log)
    before = count_block_cuda.launches
    EXEC_COUNTERS.reset()
    results, wall = serve_suggest(engine, log, SUGGEST_K, SUGGEST_BATCH, oracle,
                                  clear_cache=True, sync=torch.cuda.synchronize)
    counters = EXEC_COUNTERS.snapshot()
    launches = count_block_cuda.launches - before
    kept, examined = (counters["suggest_prefilter_kept"],
                      counters["suggest_prefilter_in"])
    require(launches > 0, "pair_count never launched on the small sets")
    require(kept < examined / 2,
            f"the pre-filter kept {kept} of {examined} on the small sets")
    found = sum(len(r.suggestions) for r in results)
    print(f"phase 8 small sets: {len(corpus)} sets of {SMALL_MIN_LEN}-"
          f"{SMALL_MAX_LEN} elements from a pool of {SMALL_POOL} (set-up "
          f"{build_s:.1f} s); {len(log)} probes at k {SUGGEST_K}, cache "
          f"cleared per micro-batch: wall {wall:.3f} s, {len(log) / wall:.1f} "
          f"QPS, prefilter kept {kept} of {examined} "
          f"({kept / examined:.4f}), {counters['count_calls']} count passes, "
          f"{launches} pair_count launches, {found} suggestions; every answer "
          f"equals the oracle")
    report["suggest_small_sets"] = {
        "sets": len(corpus), "probes": len(log), "setup_s": build_s,
        "wall_s": wall, "qps": len(log) / wall, "counters": counters,
        "prefilter_selectivity": kept / examined, "launches": launches,
        "suggestions": found,
    }
    return launches


# -- phase 9: the online front end --------------------------------------------

class SimClock:
    """Virtual clock (seconds); the caller advances it explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def async_engine(base, device, cls=None, mirrors=None, **kw):
    """An ``AsyncSearchEngine`` (or another ``cls`` of search engine) over
    ``base``'s index.  The PrefixIndexes preprocessed in phase 4 are shared
    (preprocessing the 40.3M elements again takes about a minute); the
    device mirrors are built anew, or taken from the engine ``mirrors``."""
    from repro_torch.serve.search import AsyncSearchEngine

    eng = (cls or AsyncSearchEngine)({}, w=W_BITS, m=M_IMAGES, seed=SEED,
                                     device=device, **kw)
    for term, idx in base.index.items():
        eng.index[term] = idx
        if mirrors is None:
            eng.device.add(term, idx)
    if mirrors is not None:
        eng.device = mirrors.device
    return eng


class MemoOracle:
    """``oracle`` once per distinct query: phase 9's log repeats a few dozen
    conjunctions over lists of up to 2^23 elements."""

    def __init__(self, postings):
        self.postings, self.answers = postings, {}

    def __call__(self, q) -> np.ndarray:
        key = tuple(q)
        if key not in self.answers:
            self.answers[key] = oracle(self.postings, q)
        return self.answers[key]


def check_tickets(log, tickets, want, what: str) -> None:
    """Every ticket resolved, without error, to the oracle's answer."""
    require(len(tickets) == len(log), f"{what}: {len(tickets)} tickets")
    for q, t in zip(log, tickets):
        require(t.done and t.error is None, f"{what}: ticket of {q} "
                                            f"unresolved or failed: {t.error}")
        require(np.array_equal(t.value.doc_ids, want(q)),
                f"{what}: query {q} disagrees with the oracle")


def virtual_clock_run(eng, log, want, deadline_us: float,
                      flush_tier: int, gap_us: float) -> dict:
    """Phase 9a, one deadline: open-loop arrivals every ``gap_us`` on a
    virtual clock, pumping at each due deadline as a serving
    loop sleeping on ``next_deadline_in_us`` would (as
    ``benchmarks/fig_admission_latency.py::serve_run`` drives the JAX
    package), each bucket executed for real on the device."""
    from repro_torch.core.engine import EXEC_COUNTERS
    from repro_torch.serve.admission import AdmissionQueue

    clk = SimClock()
    eng.clock = clk
    eng.cache.clear()
    eng.admission = AdmissionQueue(flush_tier=flush_tier,
                                   deadline_us=deadline_us, clock=clk)
    EXEC_COUNTERS.reset()
    tickets = []

    def pump_until(t_target):
        while True:
            nd = eng.admission.next_deadline_in_us()
            if nd is None:
                break
            t_deadline = clk.t + nd * 1e-6
            if t_target is not None and t_deadline > t_target:
                break
            clk.t = max(clk.t, t_deadline)
            eng.pump()

    t0 = time.perf_counter()
    for i, q in enumerate(log):
        t_arrival = i * gap_us * 1e-6
        pump_until(t_arrival)
        clk.t = t_arrival
        tickets.append(eng.submit(q))
    pump_until(None)
    wall = time.perf_counter() - t0
    counters = EXEC_COUNTERS.snapshot()
    require(eng.pending() == 0, "9a: queries left in the queue")
    check_tickets(log, tickets, want, f"9a deadline {deadline_us}")
    queued = [t for t in tickets if t.value.stats.get("batch_size")
              and not t.value.stats.get("cached")]
    waits = np.asarray([t.wait_us for t in queued])
    bucket_s = sum(t.value.stats["batch_us"] for t in queued) * 1e-6
    hits, misses = (counters["result_cache_hits"],
                    counters["result_cache_misses"])
    out = {
        "deadline_us": deadline_us, "queries": len(log),
        "offered_qps": 1e6 / gap_us, "served_qps": len(log) / clk.t,
        "virtual_s": clk.t, "wall_s": wall,
        # real bucket seconds (dispatch to collect, host clock) per
        # virtual second; not a device busy share
        "bucket_wall_per_virtual_s": bucket_s / clk.t,
        "queued_queries": len(queued),
        "p50_wait_us": float(np.percentile(waits, 50)),
        "p99_wait_us": float(np.percentile(waits, 99)),
        "cache_hit_rate": hits / max(1, hits + misses),
        "passes_per_query": counters["batch_calls"] / len(log),
        "counters": counters,
    }
    require(out["p99_wait_us"] <= deadline_us + 0.5,
            f"9a: p99 wait {out['p99_wait_us']} us over {deadline_us} us")
    require(counters["batch_traces"] == 0,
            f"9a: {counters['batch_traces']} serve-time traces")
    require(counters["tickets_resolved"] == len(log),
            f"9a: {counters['tickets_resolved']} tickets resolved")
    print(f"phase 9a deadline {deadline_us:.0f} us: {len(log)} queries every "
          f"{gap_us:.0f} us (virtual), served {out['served_qps']:.1f} "
          f"queries/s (virtual; wall {wall:.3f} s), bucket wall per "
          f"virtual s {out['bucket_wall_per_virtual_s']:.4f}, p50/p99 wait "
          f"{out['p50_wait_us']:.1f}/{out['p99_wait_us']:.1f} us over "
          f"{len(queued)} queued, flushes tier {counters['tier_flushes']} "
          f"deadline {counters['deadline_flushes']}, cache hit rate "
          f"{out['cache_hit_rate']:.4f}, passes per query "
          f"{out['passes_per_query']:.4f} ({counters['batch_calls']} passes, "
          f"{counters['rerun_calls']} re-runs), serve-time traces "
          f"{counters['batch_traces']}, violations "
          f"{counters['deadline_violations']}")
    return out


def flusher_run(eng, log, want, qps: float, threads: int,
                check: bool = True) -> dict:
    """Phase 9b, one offered rate: ``threads`` submitter threads send the
    log open loop at ``qps`` (arrival i at i / qps, each submit stamped with
    its scheduled ``arrival_at``) to the background flusher; then stop() and
    check every ticket."""
    from repro_torch.core.engine import EXEC_COUNTERS

    EXEC_COUNTERS.reset()
    tickets = [None] * len(log)
    gap = 1.0 / qps
    eng.start()
    start = time.perf_counter() + 0.01

    def submitter(j: int) -> None:
        for i in range(j, len(log), threads):
            at = start + i * gap
            delay = at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            tickets[i] = eng.submit(log[i], arrival_at=at)

    workers = [threading.Thread(target=submitter, args=(j,))
               for j in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    require(not any(w.is_alive() for w in workers), "9b: submitters hung")
    for t in tickets:
        require(t.wait(timeout=120), "9b: a ticket never resolved")
    end = max(t.resolved_at for t in tickets)
    eng.stop()
    counters = EXEC_COUNTERS.snapshot()
    alive = [t for t in threading.enumerate()
             if t.name == "repro-torch-flusher" and t.is_alive()]
    require(not alive and not eng.running, "9b: a flusher thread survived")
    require(counters["inflight_dispatches"] == counters["inflight_collects"],
            "9b: dispatches and collects differ after the drain")
    if check:
        check_tickets(log, tickets, want, f"9b at {qps:.1f} queries/s")
    waits = np.asarray([t.wait_us for t in tickets])
    e2e = np.asarray([(t.resolved_at - t.submitted_at) * 1e6
                      for t in tickets])
    return {
        "offered_qps": qps, "queries": len(log),
        "served_qps": len(log) / (end - start), "wall_s": end - start,
        "p50_wait_us": float(np.percentile(waits, 50)),
        "p99_wait_us": float(np.percentile(waits, 99)),
        "p50_e2e_us": float(np.percentile(e2e, 50)),
        "p99_e2e_us": float(np.percentile(e2e, 99)),
        "counters": counters,
    }


def plain_copy_collect(torch, bucket):
    """The collect the port had before its copy stream: a blocking ``.cpu()``
    of the first pass's outputs on the current stream, which waits for every
    pass issued before the copy; the bucket's own collect then finishes."""
    for h in bucket.pending.handles:
        h.cpu()
    return bucket.collect()


def window_probe(torch, engine, log, device) -> dict:
    """Phase 9d: dispatch a light bucket, then the heaviest first-pass
    bucket (phase 5's), then collect the light one, with the side-stream
    collect and with ``plain_copy_collect``, in turns (side, plain, side,
    plain); and each bucket alone."""
    from repro_torch.exec.batch import bucket_plans, dispatch_bucket

    plans = [(i, p) for i, p in enumerate(map(engine.plan, log))
             if p.algorithm == "device"]
    buckets = bucket_plans(plans)

    def weight(sig):
        return len(buckets[sig]) * sig.k * (1 << sig.ts[-1])

    heavy_sig, light_sig = max(buckets, key=weight), min(buckets, key=weight)
    get_set = engine.device.sets.__getitem__

    def dispatch(sig):
        return dispatch_bucket(get_set, sig, buckets[sig], device=device)

    def alone(sig):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = dispatch(sig)
        b.pending.ready.synchronize()
        t1 = time.perf_counter()
        b.collect()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    out = {"light": {"ts": list(light_sig.ts), "B": len(buckets[light_sig])},
           "heavy": {"ts": list(heavy_sig.ts), "B": len(buckets[heavy_sig])},
           "runs": []}
    alone(heavy_sig)  # first touch: allocator growth
    out["heavy"]["ready_ms"], out["heavy"]["collect_ms"] = alone(heavy_sig)
    out["light"]["ready_ms"], out["light"]["collect_ms"] = alone(light_sig)
    for how in ("side stream", "plain .cpu()", "side stream", "plain .cpu()"):
        torch.cuda.synchronize()
        light = dispatch(light_sig)
        t_heavy = time.perf_counter()
        heavy = dispatch(heavy_sig)
        t0 = time.perf_counter()
        if how == "side stream":
            light.collect()
        else:
            plain_copy_collect(torch, light)
        t1 = time.perf_counter()
        running = not heavy.is_ready()
        heavy.pending.ready.synchronize()
        t2 = time.perf_counter()
        heavy.collect()
        run = {"collect": how, "light_collect_ms": (t1 - t0) * 1e3,
               "heavy_running_at_light_return": running,
               "heavy_ready_ms": (t2 - t_heavy) * 1e3,
               "heavy_dispatch_ms": (t0 - t_heavy) * 1e3}
        out["runs"].append(run)
        print(f"phase 9d {how}: light bucket (ts {light_sig.ts}, B "
              f"{out['light']['B']}) collected in "
              f"{run['light_collect_ms']:.3f} ms after the heavy bucket (ts "
              f"{heavy_sig.ts}, B {out['heavy']['B']}) was dispatched "
              f"({run['heavy_dispatch_ms']:.3f} ms of host dispatch); heavy "
              f"still running when it returned: {running}; heavy ready "
              f"{run['heavy_ready_ms']:.3f} ms after its dispatch began")
    print(f"phase 9d alone: heavy bucket ready {out['heavy']['ready_ms']:.3f} "
          f"ms after its dispatch began, its collect "
          f"{out['heavy']['collect_ms']:.3f} ms; light bucket ready "
          f"{out['light']['ready_ms']:.3f} ms, its collect "
          f"{out['light']['collect_ms']:.3f} ms")
    return out


def run_online_front_end(torch, engine, postings, planted, main_log, report,
                         device="cuda") -> dict:
    """Phase 9 on phase 4's index: 9a the admission policy on a virtual
    clock, 9b the background flusher on the wall clock, 9c adaptive
    capacity, 9d the in-flight window on one card (on ``main_log``'s
    buckets).  Returns each path's launches of the kernels: the counts are
    set to 0 just before each of its runs and read just after it, so the
    ``query_batch`` baseline and 9d count on no path here."""
    from repro_torch.core.engine import EXEC_COUNTERS, pow2_tiers
    from repro_torch.exec.adaptive import CapacityModel
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.serve.search import repeated_query_log

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    log = repeated_query_log(range(N_TERMS), ASYNC_QUERIES,
                             n_distinct=ASYNC_DISTINCT, seed=SEED + 6)
    log.insert(len(log) // 2, list(planted))
    want = MemoOracle(postings)
    out = {"queries": len(log), "distinct": len({tuple(q) for q in log}),
           "s": {}}
    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda}
    paths = {}

    def counted(path: str, run):
        """``run()`` with every launch count set to 0 just before it; the
        counts just after it are added to ``path``'s."""
        for k in kernels.values():
            k.launches = 0
        result = run()
        tally = paths.setdefault(path, dict.fromkeys(kernels, 0))
        for name, k in kernels.items():
            tally[name] += k.launches
        return result

    def done(part: str, since: float) -> float:
        out["s"][part] = time.perf_counter() - since
        print(f"phase {part}: {out['s'][part]:.1f} s")
        return time.perf_counter()

    # 9a: the policy on a virtual clock
    t_part = t0 = time.perf_counter()
    eng = async_engine(engine, device, flush_tier=ASYNC_FLUSH_TIER,
                       result_cache=ASYNC_CACHE)
    EXEC_COUNTERS.reset()
    warmed = counted("AsyncSearchEngine.warm", lambda: eng.warm(
        log, top_k=len(log), b_tiers=pow2_tiers(ASYNC_FLUSH_TIER)))
    sync()
    warm = EXEC_COUNTERS.snapshot()
    print(f"phase 9a warm: {len(warmed)} signatures at tiers "
          f"{pow2_tiers(ASYNC_FLUSH_TIER)}, {warm['warm_executions']} warm "
          f"executions and {warm['warm_reruns']} at capacity G, "
          f"{warm['batch_traces']} traces, launches "
          f"{paths['AsyncSearchEngine.warm']}, "
          f"{time.perf_counter() - t0:.1f} s with the mirrors")
    out["9a"] = {"warm_s": time.perf_counter() - t0, "warm": warm,
                 "runs": [counted("async 9a virtual clock",
                                  lambda d=d: virtual_clock_run(
                                      eng, log, want, d, ASYNC_FLUSH_TIER,
                                      ASYNC_GAP_US))
                          for d in ASYNC_DEADLINES_US]}
    del eng
    t_part = done("9a", t_part)

    # 9b: the background flusher on the wall clock
    flog = log[:FLUSHER_QUERIES]
    eng = async_engine(engine, device, flush_tier=FLUSHER_TIER,
                       deadline_us=FLUSHER_DEADLINE_US,
                       max_inflight=FLUSHER_INFLIGHT, result_cache=0)
    eng.query_batch(flog)  # allocator growth, before the timed pass
    sync()
    t0 = time.perf_counter()
    eng.query_batch(flog)
    sync()
    base_qps = len(flog) / (time.perf_counter() - t0)
    print(f"phase 9b query_batch on the {len(flog)}-query log: "
          f"{base_qps:.1f} queries/s")
    runs = []
    for rate in FLUSHER_RATES:
        run = counted("async 9b flusher", lambda: flusher_run(
            eng, flog, want, rate * base_qps, FLUSHER_THREADS))
        run["rate_of_query_batch"] = rate
        runs.append(run)
        c = run["counters"]
        print(f"phase 9b at {rate}x ({run['offered_qps']:.1f} queries/s "
              f"offered, {FLUSHER_THREADS} submitters): served "
              f"{run['served_qps']:.1f} queries/s, p50/p99 wait "
              f"{run['p50_wait_us']:.0f}/{run['p99_wait_us']:.0f} us, p50/p99 "
              f"end to end {run['p50_e2e_us']:.0f}/{run['p99_e2e_us']:.0f} us, "
              f"overlap high water {c['overlap_high_water']}, flusher wakeups "
              f"{c['flusher_wakeups']}, flushes tier {c['tier_flushes']} "
              f"deadline {c['deadline_flushes']}, collect_us "
              f"{c['collect_us']}, dispatches/collects "
              f"{c['inflight_dispatches']}/{c['inflight_collects']}, "
              f"violations {c['deadline_violations']}")
    prof = None
    if device == "cuda":
        plog = flog[:FLUSHER_PROFILED]
        prof = profile_breakdown(torch, lambda: counted(
            "async 9b flusher", lambda: flusher_run(
                eng, plog, want, FLUSHER_RATES[-1] * base_qps,
                FLUSHER_THREADS, check=False)))
        print(f"phase 9b profiled run ({len(plog)} queries at "
              f"{FLUSHER_RATES[-1]}x): wall {prof['wall_s']:.3f} s, device "
              f"busy {prof['device_busy_ms']} ms, share "
              f"{prof['device_busy_share']}")
        for row in prof["top"][:6]:
            print(f"  {row['ms']:10.3f} ms  {row['calls']:6d}x  "
                  f"{row['name'][:90]}")
    out["9b"] = {"query_batch_qps": base_qps, "runs": runs, "profile": prof}
    del eng
    t_part = done("9b", t_part)

    # 9c: adaptive capacity on the card
    model = CapacityModel(min_observations=4)
    eng = async_engine(engine, device, result_cache=0,
                       adaptive_capacity=model)
    pair = list(planted)

    def serve_pair():
        ticket = eng.submit(pair)
        eng.drain()
        return ticket

    steps = []
    for _ in range(ADAPTIVE_REPEATS):
        EXEC_COUNTERS.reset()
        ticket = counted("async 9c adaptive", serve_pair)
        require(ticket.done and ticket.error is None, "9c: ticket failed")
        require(np.array_equal(ticket.value.doc_ids, want(pair)),
                "9c: the planted pair disagrees with the oracle")
        c = EXEC_COUNTERS.snapshot()
        steps.append({"capacity": ticket.value.stats["capacity"],
                      "reruns": c["rerun_calls"],
                      "promotions": c["adaptive_promotions"],
                      "saved": c["adaptive_overflow_saved"]})
    promoted = [i for i, s in enumerate(steps) if s["promotions"]]
    require(promoted, "9c: no promotion")
    require(all(s["reruns"] == 0 for s in steps[promoted[0] + 1:]),
            f"9c: a re-run after the promotion: {steps}")
    print(f"phase 9c adaptive capacity: planted pair served "
          f"{ADAPTIVE_REPEATS} times; capacity per serve "
          f"{[s['capacity'] for s in steps]}, re-runs "
          f"{[s['reruns'] for s in steps]}, promotion at serve "
          f"{promoted[0] + 1}, saved re-runs "
          f"{sum(s['saved'] for s in steps)}; learned tiers "
          f"{list(model.learned_tiers().values())}")
    out["9c"] = {"steps": steps, "learned": list(model.learned_tiers().values())}
    del eng
    t_part = done("9c", t_part)

    # 9d: the window on one card
    if device == "cuda":
        out["9d"] = window_probe(torch, engine, main_log, device)
        done("9d", t_part)
    out["launches_by_path"] = paths
    report["online"] = out
    return paths


# -- phase 10: boolean expressions ---------------------------------------------

def shared_subtree_log(n_terms: int, n_queries: int, n_bases: int,
                       seed: int):
    """``benchmarks/fig_boolean_qps.py::shared_subtree_log`` as tuples
    ``(j, extra, cut)``: base ``j`` is ``2j | 2j+1``; each query draws a base
    and an extra term from the remaining vocabulary and is ``base & extra``,
    every third ``(base & extra) - cut`` (``cut`` None otherwise)."""
    rng = np.random.default_rng(seed)
    extras = list(range(2 * n_bases, n_terms))
    log = []
    for i in range(n_queries):
        j = int(rng.integers(n_bases))
        extra = extras[int(rng.integers(len(extras)))]
        cut = extras[int(rng.integers(len(extras)))] if i % 3 == 2 else None
        log.append((j, extra, cut))
    return log


def expr_string(q) -> str:
    """A ``shared_subtree_log`` tuple as the parse string users send."""
    j, extra, cut = q
    s = f"({2 * j}|{2 * j + 1})&{extra}"
    return s if cut is None else f"({s})-{cut}"


class ExprOracle:
    """Answers with numpy's set routines, memoized per base, (base, extra)
    and query: independent of the port's ``eval_host``.  A term list takes
    the membership ``oracle``."""

    def __init__(self, postings):
        self.postings = postings
        self.memo = {}

    def _get(self, key, make):
        if key not in self.memo:
            self.memo[key] = make()
        return self.memo[key]

    def __call__(self, q) -> np.ndarray:
        if isinstance(q, list):
            return self._get(tuple(q), lambda: oracle(self.postings, q))
        j, extra, cut = q
        p = self.postings
        base = self._get(("base", j), lambda: np.union1d(p[2 * j],
                                                         p[2 * j + 1]))
        both = self._get(("and", j, extra), lambda: np.intersect1d(
            base, p[extra], assume_unique=True))
        if cut is None:
            return both
        return self._get(q, lambda: np.setdiff1d(both, p[cut],
                                                 assume_unique=True))


class HostCopyMeter:
    """Bytes that ``core.engine._to_host`` brings to the host while the
    meter is on, by the function that asked for the copy (its qualified
    name, e.g. ``dispatch_expr_batch.<locals>.collect``): the ``nbytes`` of
    the arrays each copy returns, first passes and re-runs alike."""

    def __init__(self):
        self.bytes = {}

    def __enter__(self):
        from repro_torch.core import engine

        self._engine, self._to_host = engine, engine._to_host

        def to_host(tensors, ready):
            caller = sys._getframe(1).f_code.co_qualname
            arrays = self._to_host(tensors, ready)
            self.bytes[caller] = self.bytes.get(caller, 0) + sum(
                a.nbytes for a in arrays)
            return arrays

        engine._to_host = to_host
        return self

    def __exit__(self, *exc):
        self._engine._to_host = self._to_host

    def of(self, dispatcher: str) -> int:
        """Bytes copied for the passes of ``core.engine.<dispatcher>``."""
        return sum(n for caller, n in self.bytes.items()
                   if caller.split(".")[0] == dispatcher)


def route_of(result) -> str:
    """The route a served query took, as the JAX package's request span
    names it: ``subcache`` (merged from cached subexpressions), ``cache``
    (a root hit), else ``device`` or the host path's name."""
    if result.stats.get("subexpr_merge"):
        return "subcache"
    if result.stats.get("cached"):
        return "cache"
    return "device" if result.algorithm.endswith("/device") else \
        result.algorithm


def run_boolean_expressions(torch, engine, postings, report,
                            device="cuda") -> dict:
    """Phase 10 on phase 4's index: 10a ``query_batch`` of a mixed log
    (shared-subtree expressions, flat conjunctions, expressions that
    normalize to flat ones) with the cache off, against numpy's set
    routines, with a forced overflow re-run and a profiled pass; 10b the
    same log as parse strings through ``AsyncSearchEngine`` with the result
    cache on, after warming its signatures.  Returns each path's launches
    of the phase-1 and phase-2 kernels (counts set to 0 just before each
    run, read just after it), and the log as served with its answers (for
    phase 11)."""
    from repro_torch.core.engine import (
        EXEC_COUNTERS, expr_total_width, intersect_expr_batch,
    )
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.serve.search import zipf_query_log

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda}
    paths = {}

    def counted(path: str, run):
        for k in kernels.values():
            k.launches = 0
        result = run()
        paths[path] = {name: k.launches for name, k in kernels.items()}
        return result

    exprs = shared_subtree_log(N_TERMS, EXPR_QUERIES, EXPR_BASES, SEED + 10)
    flat = zipf_query_log(range(N_TERMS), EXPR_FLAT, seed=SEED + 11)
    pairs = [q[:2] for q in flat if len(q) >= 2][:2]
    normal = [f"{a}&{b}" for a, b in pairs] + [f"({a}&{b})&{a}"
                                               for a, b in pairs]
    # the log: an expression, then a flat conjunction, while both last
    log = []
    for i, q in enumerate(exprs):
        log.append(q)
        if i < len(flat):
            log.append(flat[i])
    log += [list(map(int, s.replace("(", "").replace(")", "").split("&")))
            for s in normal]
    served = [expr_string(q) if isinstance(q, tuple) else q for q in log]
    served[-len(normal):] = normal  # served as strings, answered as lists
    want = ExprOracle(postings)
    out = {"expressions": len(exprs), "flat": len(flat),
           "flat_normalizing": len(normal), "queries": len(log), "s": {}}

    def done(part: str, since: float) -> float:
        out["s"][part] = time.perf_counter() - since
        print(f"phase {part}: {out['s'][part]:.1f} s")
        return time.perf_counter()

    t_part = t_oracle = time.perf_counter()
    answers = [want(q) for q in log]
    out["oracle_s"] = time.perf_counter() - t_oracle
    print(f"phase 10 log: {len(exprs)} expressions over {EXPR_BASES} union "
          f"bases, {len(flat)} flat conjunctions, {len(normal)} expressions "
          f"that normalize to conjunctions ({len(log)} queries); numpy "
          f"oracle {out['oracle_s']:.1f} s")

    def check(results, what: str) -> None:
        require(len(results) == len(log), f"{what}: {len(results)} results")
        for s_, res, ans in zip(served, results, answers):
            require(np.array_equal(res.doc_ids, ans),
                    f"{what}: {s_!r} has {len(res.doc_ids)} ids, the oracle "
                    f"{len(ans)}")

    # 10a: query_batch, cache off
    plans = [engine.plan(q) for q in served]
    sigs = {p.sig for p in plans if p.sig is not None}
    n_expr_buckets = sum(sig.eshape is not None for sig in sigs)
    require(all(p.expr is None for p in plans[-len(normal):]),
            "10a: a flat-normalizing expression kept its expression plan")
    EXEC_COUNTERS.reset()
    sync()
    t0 = time.perf_counter()
    with HostCopyMeter() as meter:
        results = counted("expression log",
                          lambda: engine.query_batch(served))
        sync()
    wall = time.perf_counter() - t0
    counters = EXEC_COUNTERS.snapshot()
    check(results, "10a")
    algos = [r.algorithm for r in results]
    require(n_expr_buckets >= 1 and "expr/device" in algos,
            "10a: no expression bucket ran")
    require("rangroupscan/device" in algos, "10a: no flat bucket ran")
    for name, n in paths["expression log"].items():
        require(n > 0, f"10a: {name} never launched on the expression log")
    copied = meter.of("dispatch_expr_batch")
    flat_bytes = meter.of("dispatch_device_batch")
    require(copied > 0 and flat_bytes > 0,
            f"10a: no copy to the host seen ({meter.bytes})")
    out["10a"] = {
        "wall_s": wall, "qps": len(log) / wall, "counters": counters,
        "expr_buckets": n_expr_buckets, "buckets": len(sigs),
        "expr_bytes_to_host": copied, "flat_packed_to_host": flat_bytes,
        "algorithms": {a: algos.count(a) for a in sorted(set(algos))},
        "launches": paths["expression log"],
    }
    print(f"phase 10a query_batch: {len(log)} queries in {wall:.3f} s, "
          f"{len(log) / wall:.1f} queries/s; {len(sigs)} buckets "
          f"({n_expr_buckets} expression), {counters['expr_calls']} expression "
          f"passes + {counters['expr_rerun_calls']} re-runs, "
          f"{counters['batch_calls']} flat passes + {counters['rerun_calls']} "
          f"re-runs; {copied} bytes copied to the host by expression "
          f"collects, {flat_bytes} by flat ones; {counters['collect_us']} us "
          f"in collect; "
          f"routes {out['10a']['algorithms']}; launches "
          f"{paths['expression log']}; all answers equal the oracle")

    # the forced re-run: the cheapest union base at capacity 16
    def total_width(q) -> int:
        sig = engine.plan(expr_string(q)).sig
        return expr_total_width(sig.ts, sig.gmaxes)

    base_q = min((q for q in exprs if q[2] is None), key=total_width)
    plan = engine.plan(expr_string(base_q))
    row = [engine.device.sets[t] for t in plan.terms]
    EXEC_COUNTERS.reset()
    (res, st), = intersect_expr_batch([row], plan.sig.eshape,
                                      capacity=EXPR_FORCED_CAP, device=device)
    forced = EXEC_COUNTERS.snapshot()
    require(np.array_equal(res, want(base_q)),
            "10a: the forced re-run disagrees with the oracle")
    require(forced["expr_rerun_calls"] >= 1, "10a: no forced re-run")
    require(st["capacity"] == expr_total_width(plan.sig.ts, plan.sig.gmaxes),
            "10a: the re-run did not run at the total leaf width")
    out["10a"]["forced"] = {"query": expr_string(base_q),
                            "expr_rerun_calls": forced["expr_rerun_calls"],
                            "r": st["r"], "capacity": st["capacity"]}
    print(f"phase 10a forced overflow: {expr_string(base_q)} at capacity "
          f"{EXPR_FORCED_CAP}: {forced['expr_rerun_calls']} re-run at "
          f"{st['capacity']}, {st['r']} ids equal the oracle")

    prof = profile_breakdown(
        torch, lambda: engine.query_batch(served),
        groups=("bitmap_filter", "group_match", "searchsorted", "sort",
                "memcpy"))
    out["10a"]["profile"] = prof
    print(f"phase 10a profiled pass: wall {prof['wall_s']:.3f} s, device busy "
          f"{prof['device_busy_ms']} ms, share {prof['device_busy_share']}; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in prof["kernel_ms"].items()))
    for r in prof["top"][:8]:
        print(f"  {r['ms']:10.3f} ms  {r['calls']:6d}x  {r['name'][:90]}")
    del results
    if device == "cuda":
        torch.cuda.empty_cache()
    t_part = done("10a", t_part)

    # 10b: AsyncSearchEngine, result cache on, warmed
    clk = SimClock()
    eng = async_engine(engine, device, flush_tier=EXPR_FLUSH_TIER,
                       result_cache=EXPR_CACHE, clock=clk)
    EXEC_COUNTERS.reset()
    t0 = time.perf_counter()
    warmed = counted("AsyncSearchEngine.warm expressions", lambda: eng.warm(
        served, top_k=len(log), b_tiers=(EXPR_FLUSH_TIER,)))
    sync()
    warm = EXEC_COUNTERS.snapshot()
    warm_s = time.perf_counter() - t0
    n_expr_warmed = sum(sig.eshape is not None for sig in warmed)
    print(f"phase 10b warm: {len(warmed)} signatures ({n_expr_warmed} "
          f"expression) at tier {EXPR_FLUSH_TIER}, "
          f"{warm['warm_executions']} warm executions, {warm['warm_reruns']} "
          f"at the re-run capacity, {warm['expr_traces']} expression and "
          f"{warm['batch_traces']} flat traces, {warm_s:.1f} s")
    EXEC_COUNTERS.reset()

    submit_s = []

    def serve_async():
        tickets = []
        for i, s_ in enumerate(served):
            clk.t = i * ASYNC_GAP_US * 1e-6
            t1 = time.perf_counter()
            tickets.append(eng.submit(s_))
            submit_s.append(time.perf_counter() - t1)
        eng.drain()
        return tickets

    t0 = time.perf_counter()
    tickets = counted("async 10b expressions", serve_async)
    sync()
    wall_b = time.perf_counter() - t0
    cb = EXEC_COUNTERS.snapshot()
    require(all(t.done and t.error is None for t in tickets),
            "10b: a ticket unresolved or failed")
    check([t.value for t in tickets], "10b")
    routes = [route_of(t.value) for t in tickets]
    route_counts = {r: routes.count(r) for r in sorted(set(routes))}
    # flush tier 1: each ticket resolves inside its own submit
    route_s = {r: sum(dt for dt, rr in zip(submit_s, routes) if rr == r)
               for r in route_counts}
    # the device route apart by pass kind: expression passes vs flat ones
    by_algo = {}
    for dt, rr, t in zip(submit_s, routes, tickets):
        if rr == "device":
            n, sec = by_algo.get(t.value.algorithm, (0, 0.0))
            by_algo[t.value.algorithm] = (n + 1, sec + dt)
    device_mean_ms = {a: {"submits": n, "mean_ms": sec / n * 1e3}
                      for a, (n, sec) in sorted(by_algo.items())}
    require(cb["expr_traces"] == 0,
            f"10b: {cb['expr_traces']} serve-time expression traces")
    require(cb["batch_traces"] == 0,
            f"10b: {cb['batch_traces']} serve-time flat traces")
    require(cb["subexpr_host_merges"] >= 1, "10b: no host merge")
    require(cb["subexpr_cache_hits"] >= 1, "10b: no subexpression hit")
    out["10b"] = {"warm_s": warm_s, "warm": warm, "warmed": len(warmed),
                  "wall_s": wall_b, "qps": len(log) / wall_b, "counters": cb,
                  "routes": route_counts, "route_s": route_s,
                  "device_submit_by_algorithm": device_mean_ms,
                  "mean_submit_ms": {r: route_s[r] / route_counts[r] * 1e3
                                     for r in route_counts}}
    print(f"phase 10b async: {len(log)} parse strings at flush tier "
          f"{EXPR_FLUSH_TIER}, cache on: {wall_b:.3f} s, "
          f"{len(log) / wall_b:.2f} queries/s; routes {route_counts}, "
          f"seconds by route "
          f"{ {r: round(v, 3) for r, v in route_s.items()} }, mean ms per "
          f"submit {out['10b']['mean_submit_ms']}, device submits by pass "
          f"(count, mean ms) { {a: (d['submits'], d['mean_ms'])
                               for a, d in device_mean_ms.items()} }; "
          f"{cb['expr_calls']} expression passes, {cb['batch_calls']} flat; "
          f"subexpression cache hits {cb['subexpr_cache_hits']}, misses "
          f"{cb['subexpr_cache_misses']}, stores {cb['subexpr_cache_stores']}, "
          f"host merges {cb['subexpr_host_merges']}; serve-time traces "
          f"{cb['expr_traces']} + {cb['batch_traces']}; all answers equal "
          f"the oracle")
    del eng, tickets
    if device == "cuda":
        torch.cuda.empty_cache()
    done("10b", t_part)
    out["launches_by_path"] = paths
    report["expressions"] = out
    return paths, (served, answers)


# -- phase 11: z-sharded and 2-D execution on one card --------------------------

class EngineTimer:
    """Wall seconds spent in one ``core.engine`` function while the timer is
    on, and its calls (callers look the function up by name at each call,
    so the wrapper sees them all)."""

    def __init__(self, name: str):
        self.name, self.s, self.calls = name, 0.0, 0

    def __enter__(self):
        from repro_torch.core import engine

        self._engine, self._fn = engine, getattr(engine, self.name)

        def timed_fn(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self._fn(*args, **kw)
            finally:
                self.s += time.perf_counter() - t0
                self.calls += 1

        setattr(engine, self.name, timed_fn)
        return self

    def __exit__(self, *exc):
        setattr(self._engine, self.name, self._fn)


def mesh_devices(device: str) -> list:
    """The logical shard devices of phase 11: ``SHARDS`` repeats of the
    card (``"cuda:0"``), or of the CPU in a rehearsal."""
    return ["cuda:0" if device == "cuda" else device] * SHARDS


def timed(sync, run):
    """(result, wall s) of ``run()`` between two ``sync()``s."""
    sync()
    t0 = time.perf_counter()
    result = run()
    sync()
    return result, time.perf_counter() - t0


def run_sharded(torch, engine, results, main_log, planted, suggest,
                expr_log, report, device="cuda") -> dict:
    """Phase 11 on one card, every shard a view on it: 11a phase 4's log
    through a sharded ``SearchEngine.query_batch`` (and the planted pair at
    ``capacity_per_shard`` 16, one re-run), 11b the log's first
    ``MESH_QUERIES`` through a warmed ``AsyncSearchEngine`` on a 2x2
    topology, 11c phase 7's first ``MESH_PROBES`` probes through a sharded
    ``SuggestEngine``, 11d phase 10's log through the sharded
    ``query_batch``.  Answers must equal phase 4's (checked against the
    oracle there), the scipy oracle and numpy's set routines.  Prints
    queries/s and probes/s sharded against single-device, timed in turns
    (a measurement, not a check).  Returns each path's launches (counts
    set to 0 just before each run, read just after it)."""
    from repro_torch.core.engine import (
        EXEC_COUNTERS, intersect_sharded_batch, make_shard_mesh, pow2_tiers,
    )
    from repro_torch.exec.topology import make_topology
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.serve.search import SearchEngine, SuggestEngine

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    flat_kernels = {"bitmap_filter": bitmap_filter_cuda,
                    "group_match": group_match_cuda}
    paths = {}

    def counted(path: str, run, kernels=flat_kernels):
        for k in kernels.values():
            k.launches = 0
        result = run()
        paths[path] = {name: k.launches for name, k in kernels.items()}
        return result

    out = {"shards": SHARDS, "layout_2d": list(LAYOUT_2D), "s": {}}

    def done(part: str, since: float) -> float:
        out["s"][part] = time.perf_counter() - since
        print(f"phase {part}: {out['s'][part]:.1f} s")
        return time.perf_counter()

    want = {tuple(q): r.doc_ids for q, r in zip(main_log, results)}

    def check(log, got, what: str) -> None:
        for q, r in zip(log, got):
            require(np.array_equal(r.doc_ids, want[tuple(q)]),
                    f"{what}: query {q} disagrees with phase 4's answer")

    # 11a: the log through a sharded query_batch
    t_part = time.perf_counter()
    mesh = make_shard_mesh(SHARDS, devices=mesh_devices(device))
    eng = async_engine(engine, device, cls=SearchEngine, mesh=mesh)
    plans = [eng.plan(q) for q in main_log]
    n_sharded = sum(p.sig is not None and p.sig.shards == SHARDS
                    for p in plans)
    walls = {"single": [], "sharded": []}
    for turn in ("single", "sharded", "sharded", "single"):
        if turn == "single":
            got, wall = timed(sync, lambda: engine.query_batch(main_log))
        elif not walls["sharded"]:
            EXEC_COUNTERS.reset()
            got, wall = timed(sync, lambda: counted(
                "11a sharded query_batch",
                lambda: eng.query_batch(main_log)))
            counters = EXEC_COUNTERS.snapshot()
            algos = [r.algorithm for r in got]
        else:
            got, wall = timed(sync, lambda: eng.query_batch(main_log))
        check(main_log, got, f"11a {turn}")
        walls[turn].append(wall)
    require(counters["sharded_calls"] > 0, "11a: no sharded pass")
    require("rangroupscan/sharded" in algos, "11a: nothing served sharded")
    qps = {k: [len(main_log) / w for w in v] for k, v in walls.items()}
    pair = [eng.device.get_mesh_set(t) for t in planted]
    EXEC_COUNTERS.reset()
    (pair_vals, pair_stats), = intersect_sharded_batch(
        [pair], mesh, capacity_per_shard=SHARDED_FORCED_CAP)
    forced = EXEC_COUNTERS.snapshot()
    require((forced["sharded_calls"], forced["sharded_rerun_calls"]) == (2, 1),
            f"11a: the planted pair at capacity_per_shard "
            f"{SHARDED_FORCED_CAP} ran {forced['sharded_calls']} passes, "
            f"{forced['sharded_rerun_calls']} re-runs")
    require(np.array_equal(pair_vals, want[tuple(planted)]),
            "11a: the planted pair's forced re-run disagrees")
    out["11a"] = {"queries": len(main_log), "sharded_plans": n_sharded,
                  "walls_s": walls, "qps": qps, "counters": counters,
                  "forced": {"stats": pair_stats, "counters": forced}}
    print(f"phase 11a sharded query_batch ({SHARDS} shards on one card): "
          f"{len(main_log)} queries, {n_sharded} planned sharded; "
          f"{counters['sharded_calls']} sharded passes, "
          f"{counters['sharded_rerun_calls']} re-runs, {counters['batch_calls']}"
          f" single-device; queries/s single-device {qps['single']}, sharded "
          f"{qps['sharded']} (turns single, sharded, sharded, single); the "
          f"planted pair at capacity_per_shard {SHARDED_FORCED_CAP}: 2 passes, "
          f"1 re-run at {pair_stats['capacity_per_shard']}; all answers equal "
          f"phase 4's")
    t_part = done("11a", t_part)

    # 11b: a warmed AsyncSearchEngine on a 2x2 topology
    log_b = main_log[:MESH_QUERIES] + [list(planted)]
    sizes = sorted({1 << p.sig.ts[-1] for p in map(engine.plan, log_b)
                    if p.sig is not None})
    min_g = sizes[len(sizes) // 2]  # both routes: mesh and balancer
    topo = make_topology(*LAYOUT_2D, devices=mesh_devices(device))
    eng_b = async_engine(engine, device, topology=topo, shard_min_g=min_g,
                         flush_tier=MESH_FLUSH_TIER, result_cache=0)
    EXEC_COUNTERS.reset()
    (warmed, warm_s) = timed(sync, lambda: counted(
        "AsyncSearchEngine.warm 2x2", lambda: eng_b.warm(
            log_b, top_k=len(log_b), b_tiers=pow2_tiers(MESH_FLUSH_TIER))))
    warm = EXEC_COUNTERS.snapshot()
    EXEC_COUNTERS.reset()

    def serve_b():
        tickets = [eng_b.submit(q) for q in log_b]
        eng_b.drain()
        return tickets

    tickets, wall_b = timed(sync, lambda: counted("async 11b 2x2", serve_b))
    cb = EXEC_COUNTERS.snapshot()
    require(all(t.done and t.error is None for t in tickets),
            "11b: a ticket unresolved or failed")
    check(log_b, [t.value for t in tickets], "11b")
    require(cb["mesh2d_calls"] > 0, "11b: no 2-D pass")
    require(cb["replica_dispatches"] > 0, "11b: no balancer-placed bucket")
    require((cb["mesh2d_traces"], cb["batch_traces"]) == (0, 0),
            f"11b: serve-time traces {cb['mesh2d_traces']} 2-D, "
            f"{cb['batch_traces']} single-device")
    routes = {}
    for t in tickets:
        routes[t.value.algorithm] = routes.get(t.value.algorithm, 0) + 1
    loads = [d["dispatched"] for d in topo.load_snapshot()]
    out["11b"] = {"queries": len(log_b), "shard_min_g": min_g,
                  "warmed": len(warmed), "warm_s": warm_s, "warm": warm,
                  "wall_s": wall_b, "qps": len(log_b) / wall_b,
                  "counters": cb, "routes": routes, "balancer": loads}
    print(f"phase 11b AsyncSearchEngine on a {topo.describe()} topology "
          f"(shard_min_g {min_g}, flush tier {MESH_FLUSH_TIER}, cache off): "
          f"warmed {len(warmed)} signatures in {warm_s:.1f} s "
          f"({warm['warm_executions']} warm executions, {warm['warm_reruns']} "
          f"at the re-run capacity); {len(log_b)} queries in {wall_b:.3f} s, "
          f"{len(log_b) / wall_b:.1f} queries/s; {cb['mesh2d_calls']} 2-D "
          f"passes ({cb['mesh2d_row_dispatches']} row runs), "
          f"{cb['replica_dispatches']} balancer-placed buckets (rows {loads});"
          f" routes {routes}; serve-time traces 0; all answers equal phase 4's")
    del eng_b, tickets
    t_part = done("11b", t_part)

    # 11c: phase 7's corpus through a sharded SuggestEngine
    s_engine, s_oracle, s_log = suggest
    probes = s_log[:MESH_PROBES]
    eng_c = SuggestEngine({}, w=W_BITS, m=M_IMAGES, seed=SEED, device=device,
                          mesh=mesh, shard_min_g=1, result_cache=0)
    # phase 7's preprocessed sets and pre-filter, shared; mirrors anew
    eng_c.corpus, eng_c.index = s_engine.corpus, s_engine.index
    eng_c.prefilter = s_engine.prefilter
    for sid, idx in s_engine.index.items():
        eng_c.device.add(sid, idx)
    walls_c = {"single": [], "sharded": []}
    for turn in ("single", "sharded", "sharded", "single"):
        target = s_engine if turn == "single" else eng_c
        run = lambda: serve_suggest(target, probes, SUGGEST_K,  # noqa: E731
                                    SUGGEST_BATCH, s_oracle, clear_cache=True,
                                    sync=sync)
        if turn == "sharded" and not walls_c["sharded"]:
            EXEC_COUNTERS.reset()
            got, wall = counted("11c sharded suggest_batch", run,
                                {"pair_count": count_block_cuda})
            cc = EXEC_COUNTERS.snapshot()
            algos_c = {r.algorithm for r in got}
        else:
            _, wall = run()
        walls_c[turn].append(wall)
    require(algos_c == {"suggest/sharded"}, f"11c: routes {algos_c}")
    pps = {k: [len(probes) / w for w in v] for k, v in walls_c.items()}
    out["11c"] = {"probes": len(probes), "k": SUGGEST_K, "walls_s": walls_c,
                  "probes_per_s": pps, "counters": cc}
    print(f"phase 11c sharded suggest_batch: {len(probes)} probes at k "
          f"{SUGGEST_K}, micro-batches of {SUGGEST_BATCH}, cache cleared; "
          f"{cc['count_calls']} sharded count passes; probes/s single-device "
          f"{pps['single']}, sharded {pps['sharded']} (in turns); all answers "
          f"equal the scipy oracle")
    del eng_c
    t_part = done("11c", t_part)

    # 11d: phase 10's expression log through the sharded query_batch
    served, answers = expr_log
    plain, wall_plain = timed(sync, lambda: engine.query_batch(served))
    # the host side of every sharded expression collect: each shard's
    # segment compacted, then the segments sorted together
    with EngineTimer("_expr_shard_results") as assembly:
        got, wall_d = timed(sync, lambda: counted(
            "11d sharded expressions", lambda: eng.query_batch(served)))
    for s_, r, p, a in zip(served, got, plain, answers):
        require(np.array_equal(r.doc_ids, a), f"11d: {s_} disagrees")
        require(np.array_equal(p.doc_ids, a), f"11d: {s_} (single) disagrees")
    algos_d = {r.algorithm for r in got}
    require("expr/sharded" in algos_d, f"11d: routes {algos_d}")
    out["11d"] = {"queries": len(served), "wall_single_s": wall_plain,
                  "wall_sharded_s": wall_d, "assembly_s": assembly.s,
                  "assembly_calls": assembly.calls,
                  "qps": {"single": len(served) / wall_plain,
                          "sharded": len(served) / wall_d},
                  "routes": sorted(algos_d)}
    print(f"phase 11d sharded expressions: {len(served)} queries; queries/s "
          f"single-device {len(served) / wall_plain:.2f}, sharded "
          f"{len(served) / wall_d:.2f}; host result assembly of the sharded "
          f"expression collects {assembly.s:.3f} s in {assembly.calls} calls; "
          f"routes {sorted(algos_d)}; all answers equal numpy's")
    del eng
    if device == "cuda":
        torch.cuda.empty_cache()
    done("11d", t_part)
    out["launches_by_path"] = paths
    report["sharded"] = out
    return paths

# -- phase 12: observability and the load harness -------------------------------

def obs_shape(qps: float, duration_s: float):
    """Phase 12's open-loop traffic at ``qps``: a diurnal swing of +-50% with
    a 1 s period and two 20-query bursts a second, 20 ms wide."""
    from repro_torch.serve.loadgen import TrafficShape

    return TrafficShape(base_qps=qps, duration_s=duration_s,
                        diurnal_amplitude=0.5, diurnal_period_s=1.0,
                        burst_rate_hz=2.0, burst_size=20.0,
                        burst_width_s=0.02)


def check_snapshot(snap, n_tickets: int, what: str) -> None:
    """A registry snapshot is one consistent cut: every histogram's bucket
    counts sum to its count, every ticket waited once, every collect was
    timed once; and it survives both expositions."""
    from repro_torch.obs import (
        parse_json, parse_prometheus, to_json, to_prometheus,
    )

    hists = snap["histograms"]
    for name, h in hists.items():
        require(sum(h["counts"]) == h["count"],
                f"{what}: {name} bucket counts do not sum to its count")
    require(hists["queue_wait_us"]["count"] == n_tickets,
            f"{what}: {hists['queue_wait_us']['count']} waits for "
            f"{n_tickets} tickets")
    collects = snap["collected"]["exec_inflight_collects"]
    require(hists["collect_latency_us"]["count"] == collects,
            f"{what}: {hists['collect_latency_us']['count']} collect "
            f"latencies for {collects} collects")
    parsed = parse_prometheus(to_prometheus(snap))
    require(parsed["repro_queue_wait_us"]["count"] == n_tickets
            and parsed["repro_exec_inflight_collects"]["value"] == collects
            and parsed["repro_bucket_batch_size"]["buckets"][-1][1]
            == hists["bucket_batch_size"]["count"],
            f"{what}: the Prometheus round trip lost values")
    require(parse_json(to_json(snap)) == snap,
            f"{what}: the JSON round trip changed the snapshot")


def traced_stats(obs, entries, flush_tier: int, what: str) -> dict:
    """Checks on a traced run's spans (one closed ``request`` root per
    ticket, none open, every ``bucket`` with its three stages) and their
    medians by stage.  The flusher's oversleep: for each bucket flushed by
    its deadline (fewer rows than the flush tier), how long after the
    oldest member's deadline the flusher picked it up (the end of that
    member's ``admission`` span)."""
    tracer = obs.tracer
    roots = tracer.finished("request")
    require(tracer.open_count() == 0,
            f"{what}: {tracer.open_count()} spans left open")
    require(len(roots) == len(entries),
            f"{what}: {len(roots)} request roots for {len(entries)} tickets")
    require(all(t.span is not None and t.span.end_us is not None
                for _, t in entries), f"{what}: a ticket without a closed root")
    buckets = {s.span_id: s for s in tracer.finished("bucket")}
    stages = {}
    for s in tracer.finished():
        if s.parent_id in buckets:
            stages.setdefault(s.parent_id, set()).add(s.name)
    require(all(stages.get(b) == {"dispatch", "device", "collect"}
                for b in buckets), f"{what}: a bucket span lacks a stage")
    members = {}
    for _, t in entries:
        b = t.span.attrs.get("bucket_span")
        if b is not None:
            members.setdefault(b, []).append(t)
    oversleep = []
    for b, ts in members.items():
        if buckets[b].attrs["batch"] < flush_tier:
            oldest = min(ts, key=lambda t: t.deadline_at())
            oversleep.append(oldest.admission_span.end_us
                             - oldest.deadline_at() * 1e6)
    med = {name: float(np.median([s.duration_us
                                  for s in tracer.finished(name)]))
           for name in ("admission", "dispatch", "device", "collect")}
    return {
        "roots": len(roots), "buckets": len(buckets),
        "median_us": med, "deadline_buckets": len(oversleep),
        "oversleep_p50_us": (float(np.percentile(oversleep, 50))
                             if oversleep else None),
        "oversleep_p99_us": (float(np.percentile(oversleep, 99))
                             if oversleep else None),
        "dropped": tracer.dropped,
    }


def run_observability(torch, engine, postings, report,
                      device="cuda") -> dict:
    """Phase 12 on phase 4's index (its preprocessed lists shared, mirrors
    built anew): 12a ``calibrate_cost`` on the pool's modal signature, 12b
    ``run_virtual`` at 0.5x and 1.5x of the calibrated capacity, 12c
    ``run_wallclock`` at 0.5x with a metrics-only and a traced engine in
    turns, then the traced one at 0.1x, 12d the profile-fit cost model
    beside 12a's, 12e a traced ``SuggestEngine`` on phase 8's corpus.
    Returns each path's launches (counts set to 0 just before each run,
    read just after it)."""
    from collections import Counter

    from repro_torch.core.engine import EXEC_COUNTERS, pow2_tiers
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.obs import Obs
    from repro_torch.serve.loadgen import (
        QueryMix, attach_wall_clock, build_schedule, calibrate_cost,
        calibrate_from_profile, run_virtual, run_wallclock,
    )
    from repro_torch.serve.search import SuggestEngine

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    flat_kernels = {"bitmap_filter": bitmap_filter_cuda,
                    "group_match": group_match_cuda}
    paths = {}

    def counted(path: str, run, kernels=flat_kernels):
        for k in kernels.values():
            k.launches = 0
        result = run()
        paths.setdefault(path, {name: k.launches
                                for name, k in kernels.items()})
        return result

    out = {"s": {}}

    def done(part: str, since: float) -> float:
        out["s"][part] = time.perf_counter() - since
        print(f"phase {part}: {out['s'][part]:.1f} s")
        return time.perf_counter()

    want = MemoOracle(postings)
    pool = [tuple(q) for q in QueryMix().sample(
        range(N_TERMS), OBS_POOL, np.random.default_rng(SEED))]
    t_part = t0 = time.perf_counter()
    obs_m = Obs(trace=False)
    eng = async_engine(engine, device, flush_tier=OBS_FLUSH_TIER,
                       deadline_us=OBS_DEADLINE_US, max_inflight=OBS_INFLIGHT,
                       result_cache=0, snapshot_every_s=OBS_SNAPSHOT_S,
                       obs=obs_m)
    warmed = eng.warm([list(q) for q in pool], top_k=len(pool),
                      b_tiers=pow2_tiers(OBS_FLUSH_TIER))
    sync()
    warm_s = time.perf_counter() - t0

    # 12a: the cost model from warmed closed-loop buckets
    plans = [eng.plan(list(q)) for q in pool]
    modal_sig = Counter(p.sig for p in plans
                        if p.algorithm == "device").most_common(1)[0][0]
    modal = [list(p.terms) for p in plans if p.sig == modal_sig]
    cost = calibrate_cost(eng, (modal * OBS_FLUSH_TIER)[:OBS_FLUSH_TIER],
                          tier=OBS_FLUSH_TIER)
    capacity = cost.capacity_qps(OBS_FLUSH_TIER)
    out["12a"] = {"pool": len(pool), "distinct": len(set(pool)),
                  "warmed": len(warmed), "warm_s": warm_s,
                  "modal_sig": repr(modal_sig),
                  "per_bucket_us": cost.per_bucket_us,
                  "per_query_us": cost.per_query_us,
                  "capacity_qps": capacity}
    print(f"phase 12a pool: {len(pool)} QueryMix draws over {N_TERMS} terms "
          f"({len(set(pool))} distinct), warmed {len(warmed)} signatures at "
          f"tiers {pow2_tiers(OBS_FLUSH_TIER)} in {warm_s:.1f} s with the "
          f"mirrors; calibrate_cost on the modal signature {modal_sig.ts} "
          f"(k {modal_sig.k}) at tier {OBS_FLUSH_TIER}: {cost}, "
          f"capacity_qps({OBS_FLUSH_TIER}) {capacity:.1f}")
    t_part = done("12a", t_part)

    # 12b: the virtual-time replay below and above capacity
    virtual = {}
    for x in OBS_VIRTUAL_RATES:
        sched = build_schedule(obs_shape(x * capacity, 2.0), range(N_TERMS),
                               seed=SEED + 1, pool=pool)
        rep, entries = counted(f"async 12b virtual {x}x",
                               lambda s=sched: run_virtual(eng, s, cost))
        check_tickets(sched.queries, [t for _, t in entries], want, f"12b {x}x")
        sizes = [t.value.stats.get("batch_size", 0) for _, t in entries]
        traces = rep.counters["batch_traces"]
        # a trace at serve time is a bucket of an unwarmed tier: only
        # buckets the backlog grew past the warmed tiers may meet one
        require(traces == 0 or max(sizes) > OBS_FLUSH_TIER,
                f"12b {x}x: {traces} serve-time traces in buckets of at most "
                f"{max(sizes)} rows")
        virtual[x] = rep
        out[f"12b {x}x"] = {**rep.to_json(), "max_bucket_rows": max(sizes),
                            "launches": paths[f"async 12b virtual {x}x"]}
        print(f"phase 12b virtual {x}x: {rep.arrivals} arrivals over "
              f"{rep.duration_s:.3f} s (virtual), offered "
              f"{rep.offered_qps:.1f} served {rep.served_qps:.1f} queries/s, "
              f"burn {rep.burn_rate:.4f} ({rep.burned} of {rep.completed}), "
              f"p50/p99 wait {rep.p50_wait_us:.1f}/{rep.p99_wait_us:.1f} us, "
              f"flushes tier {rep.counters['tier_flushes']} deadline "
              f"{rep.counters['deadline_flushes']}, largest bucket "
              f"{max(sizes)} rows, serve-time traces {traces}; every answer "
              f"equals the oracle")
    lo, hi = (virtual[x].burn_rate for x in OBS_VIRTUAL_RATES)
    require(hi > 0 and hi > lo,
            f"12b: burn {hi} at {OBS_VIRTUAL_RATES[1]}x, {lo} at "
            f"{OBS_VIRTUAL_RATES[0]}x")
    t_part = done("12b", t_part)

    # 12c: the wall clock, metrics-only and traced engines in turns
    attach_wall_clock(eng)
    obs_t = Obs(trace=True, max_finished_spans=1 << 16, cost_model=cost)
    traced = async_engine(engine, device, flush_tier=OBS_FLUSH_TIER,
                          deadline_us=OBS_DEADLINE_US,
                          max_inflight=OBS_INFLIGHT, result_cache=0,
                          snapshot_every_s=OBS_SNAPSHOT_S, obs=obs_t,
                          mirrors=eng)
    sched = build_schedule(obs_shape(OBS_WALL_RATE * capacity, OBS_WALL_S),
                           range(N_TERMS), seed=SEED + 2, pool=pool)
    walls = {"metrics": [], "traced": []}
    for mode in ("metrics", "traced", "traced", "metrics"):
        target, obs = (eng, obs_m) if mode == "metrics" else (traced, obs_t)
        obs.reset()
        rep, entries = counted(
            f"async 12c {mode}", lambda: run_wallclock(
                target, sched, submitters=OBS_SUBMITTERS))
        what = f"12c {mode} run {len(walls[mode]) + 1}"
        check_tickets(sched.queries, [t for _, t in entries], want, what)
        require(rep.thread_leak == 0, f"{what}: {rep.thread_leak} threads "
                                      f"outlived the run")
        check_snapshot(obs.registry.snapshot(), len(entries), what)
        require(len(obs.ring) > 0, f"{what}: the snapshot ring is empty")
        e2e = np.asarray([(t.resolved_at - t.submitted_at) * 1e6
                          for _, t in entries])
        run = {**rep.to_json(), "ring": len(obs.ring),
               "p50_e2e_us": float(np.percentile(e2e, 50)),
               "p99_e2e_resolved_us": float(np.percentile(e2e, 99))}
        if mode == "traced":
            run["spans"] = traced_stats(obs, entries, OBS_FLUSH_TIER, what)
        else:
            require(obs.tracer.finished() == [], f"{what}: spans recorded")
        walls[mode].append(run)
        spans = run.get("spans", {})
        print(f"phase 12c {mode}: {rep.arrivals} arrivals in "
              f"{rep.duration_s:.3f} s, offered {rep.offered_qps:.1f} served "
              f"{rep.served_qps:.1f} queries/s, p50/p99 wait "
              f"{rep.p50_wait_us:.0f}/{rep.p99_wait_us:.0f} us, p50/p99 end "
              f"to end {run['p50_e2e_us']:.0f}/{run['p99_e2e_resolved_us']:.0f}"
              f" us, burn {rep.burn_rate:.4f}, ring {len(obs.ring)}"
              + (f"; spans: median us {spans['median_us']}, oversleep p50/p99 "
                 f"{spans['oversleep_p50_us']}/{spans['oversleep_p99_us']} us "
                 f"over {spans['deadline_buckets']} deadline-flushed buckets"
                 if spans else ""))
    # below saturation, so the oversleep is the flusher's wake, not a queue
    low_sched = build_schedule(
        obs_shape(OBS_WALL_RATE * capacity, OBS_WALL_S).scaled(OBS_LOW_SCALE),
        range(N_TERMS), seed=SEED + 3, pool=pool)
    obs_t.reset()
    rep, entries = counted("async 12c traced low", lambda: run_wallclock(
        traced, low_sched, submitters=OBS_SUBMITTERS))
    check_tickets(low_sched.queries, [t for _, t in entries], want, "12c traced low")
    require(rep.thread_leak == 0, "12c traced low: a thread outlived the run")
    check_snapshot(obs_t.registry.snapshot(), len(entries), "12c traced low")
    low = {**rep.to_json(),
           "spans": traced_stats(obs_t, entries, OBS_FLUSH_TIER,
                                 "12c traced low")}
    print(f"phase 12c traced low ({OBS_WALL_RATE * OBS_LOW_SCALE}x): "
          f"{rep.arrivals} arrivals, offered {rep.offered_qps:.1f} served "
          f"{rep.served_qps:.1f} queries/s, p50/p99 wait "
          f"{rep.p50_wait_us:.0f}/{rep.p99_wait_us:.0f} us, burn "
          f"{rep.burn_rate:.4f}; spans: median us {low['spans']['median_us']}"
          f", oversleep p50/p99 {low['spans']['oversleep_p50_us']}/"
          f"{low['spans']['oversleep_p99_us']} us over "
          f"{low['spans']['deadline_buckets']} deadline-flushed buckets")
    med = {m: float(np.median([r["served_qps"] for r in runs]))
           for m, runs in walls.items()}
    spans = [r["spans"] for r in walls["traced"]]
    over = [s for s in spans if s["oversleep_p50_us"] is not None]
    out["12c"] = {"runs": walls, "low": low, "served_qps_median": med,
                  "traced_over_metrics": med["traced"] / med["metrics"],
                  "schedule": {"arrivals": len(sched),
                               "offered_qps": sched.offered_qps}}
    print(f"phase 12c: served queries/s traced over metrics-only "
          f"{med['traced'] / med['metrics']:.4f} (medians {med}); span "
          f"medians (us) admission/dispatch/device/collect "
          f"{[s['median_us'] for s in spans]}; flusher oversleep past the "
          f"deadline p50/p99 (us) "
          f"{[(s['oversleep_p50_us'], s['oversleep_p99_us']) for s in over]} "
          f"(host clock, the card's name and limit printed above); every "
          f"answer equals the oracle, threads 0, spans 0 open")
    t_part = done("12c", t_part)

    # 12d: the cost model fit from the traced engine's profile
    fit = calibrate_from_profile(obs_t.profile)
    residuals = obs_t.profile.residuals()
    executed = {s.attrs["sig"] for s in obs_t.tracer.finished("bucket")}
    require(executed and executed <= set(residuals),
            f"12d: signatures without a profile: {executed - set(residuals)}")
    require(all(math.isfinite(r["residual_us"]) for r in residuals.values()),
            "12d: a residual is not finite")
    out["12d"] = {"fit": None if fit is None else
                  {"per_bucket_us": fit.per_bucket_us,
                   "per_query_us": fit.per_query_us,
                   "capacity_qps": fit.capacity_qps(OBS_FLUSH_TIER)},
                  "residuals": residuals}
    worst = max(residuals.items(), key=lambda kv: abs(kv[1]["mean_residual_us"]))
    print(f"phase 12d: calibrate_from_profile {fit} beside 12a's {cost}; "
          f"{len(residuals)} signatures profiled, every bucket's signature "
          f"among them; largest mean residual {worst[0]} "
          f"{worst[1]['mean_residual_us']:.0f} us over "
          f"{worst[1]['buckets']:.0f} buckets")
    del eng, traced
    t_part = done("12d", t_part)

    # 12e: a traced SuggestEngine on phase 8's corpus
    corpus = make_small_corpus()
    obs_s = Obs(trace=True)
    s_eng = SuggestEngine(corpus, w=W_BITS, m=M_IMAGES, seed=SEED,
                          device=device, obs=obs_s)
    log = zipf_probe_log(corpus, SMALL_PROBES, SEED + 5)
    oracle_s = SuggestOracle(corpus)
    oracle_s.prepare(log)
    results, wall = counted(
        "12e traced suggest_batch",
        lambda: serve_suggest(s_eng, log, SUGGEST_K, SUGGEST_BATCH, oracle_s,
                              clear_cache=True, sync=sync),
        {"pair_count": count_block_cuda})
    roots = obs_s.tracer.finished("request")
    require(len(roots) == len(log) and obs_s.tracer.open_count() == 0,
            f"12e: {len(roots)} closed roots for {len(log)} requests, "
            f"{obs_s.tracer.open_count()} open")
    require(all(s.attrs["kind"] == "suggest" for s in roots),
            "12e: a root is not a suggest request")
    routes = Counter(s.attrs.get("route") for s in roots)
    require(device != "cuda"
            or paths["12e traced suggest_batch"]["pair_count"] > 0,
            "12e: pair_count never launched")
    out["12e"] = {"probes": len(log), "wall_s": wall, "routes": dict(routes),
                  "buckets": len(obs_s.tracer.finished("bucket"))}
    print(f"phase 12e traced suggest_batch: {len(log)} probes at k "
          f"{SUGGEST_K} on phase 8's corpus in {wall:.3f} s, routes "
          f"{dict(routes)}, {out['12e']['buckets']} bucket spans, "
          f"{paths['12e traced suggest_batch']['pair_count']} pair_count "
          f"launches; every answer equals the scipy oracle, one closed root "
          f"per request")
    del s_eng
    done("12e", t_part)
    out["launches_by_path"] = paths
    report["observability"] = out
    return paths


# -- phase 13: the host route ----------------------------------------------------

def run_host_route(torch, engine, postings, log, results, report,
                   device="cuda") -> dict:
    """Phase 13: 13a ``SearchEngine(use_device=False)`` on phase 4's lists
    (shared) serves phase 4's first ``HOST_QUERIES`` queries, the planted
    pair and the HashBin pair: every answer equal to the oracle and to
    phase 4's device answers, no kernel launched, no device memory taken;
    13b ``examples/quickstart.py``'s sets through every host algorithm and
    baseline, against ``np.intersect1d``, and the compression round trips."""
    from collections import Counter

    from repro_torch.core import baselines, compress, intersect, partition
    from repro_torch.core.hashing import (
        default_permutation, random_hash_family,
    )
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.serve.search import SearchEngine

    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda, "pair_count": count_block_cuda}
    out = {"s": {}}
    t_part = time.perf_counter()

    # 13a: the host route on phase 4's lists
    picks = list(range(HOST_QUERIES)) + [len(log) - 2, len(log) - 1]
    hlog = [log[i] for i in picks]
    host = SearchEngine({}, w=W_BITS, m=M_IMAGES, seed=SEED, use_device=False)
    host.index = engine.index  # phase 4's preprocessed lists
    want = MemoOracle(postings)
    for q in hlog:
        want(q)
    for k in kernels.values():
        k.launches = 0
    mem_before = torch.cuda.memory_allocated() if device == "cuda" else 0
    t0 = time.perf_counter()
    got = host.query_batch(hlog)
    host_s = time.perf_counter() - t0
    mem_after = torch.cuda.memory_allocated() if device == "cuda" else 0
    launches = {name: k.launches for name, k in kernels.items()}
    require(sum(launches.values()) == 0, f"13a: kernels launched {launches}")
    require(mem_after == mem_before,
            f"13a: device memory {mem_before} -> {mem_after} bytes")
    for i, q, r in zip(picks, hlog, got):
        require(np.array_equal(r.doc_ids, want(q)),
                f"13a: query {q} disagrees with the oracle")
        require(np.array_equal(r.doc_ids, results[i].doc_ids),
                f"13a: query {q} disagrees with phase 4's device answer")
    algos = dict(Counter(r.algorithm for r in got))
    require(algos.get("rangroupscan", 0) > 0 and algos.get("hashbin", 0) > 0,
            f"13a: routes {algos}")
    out["13a"] = {"queries": len(hlog), "host_s": host_s,
                  "host_qps": len(hlog) / host_s, "routes": algos,
                  "launches": launches, "device_bytes": mem_after}
    print(f"phase 13a SearchEngine(use_device=False) on phase 4's lists: "
          f"{len(hlog)} queries in {host_s:.3f} s of host CPU time, "
          f"{len(hlog) / host_s:.2f} queries/s (host), routes {algos}; kernel "
          f"launches {launches}, device memory allocated {mem_before} -> "
          f"{mem_after} bytes; every answer equals the oracle and phase 4's")
    out["s"]["13a"] = time.perf_counter() - t_part
    print(f"phase 13a: {out['s']['13a']:.1f} s")
    t_part = time.perf_counter()

    # 13b: the quickstart's sets through every host algorithm
    rng = np.random.default_rng(0)
    universe = 1 << 26
    common = rng.choice(universe, 500, replace=False).astype(np.uint32)
    a = np.unique(np.concatenate(
        [rng.choice(universe, 40000).astype(np.uint32), common]))
    b = np.unique(np.concatenate(
        [rng.choice(universe, 90000).astype(np.uint32), common]))
    truth = np.intersect1d(a, b)
    fam, perm = random_hash_family(m=2, w=256, seed=1), default_permutation(1)
    ia, ib = (partition.preprocess_prefix(x, w=256, m=2, family=fam,
                                          perm=perm) for x in (a, b))
    f64 = random_hash_family(m=1, w=64, seed=2)
    fa, fb = (partition.preprocess_fixed(x, w=64, family=f64) for x in (a, b))
    runs = {
        "rangroupscan/searchsorted": lambda: intersect.rangroupscan([ia, ib]),
        "rangroupscan/allpairs": lambda: intersect.rangroupscan(
            [ia, ib], recovery="allpairs"),
        "rangroup": lambda: intersect.rangroup([ia, ib]),
        "hashbin": lambda: intersect.hashbin(ia, ib),
        "intgroup/searchsorted": lambda: intersect.intgroup(fa, fb),
        "intgroup/inverted": lambda: intersect.intgroup(
            fa, fb, recovery="inverted"),
        **{f"baseline {name}": (lambda fn=fn: fn([a, b]))
           for name, fn in baselines.BASELINES.items()},
    }
    host_ms = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        res, _ = run()
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        require(np.array_equal(res, truth), f"13b: {name} disagrees")
    c = compress.compress_lowbits(ib)
    require(np.array_equal(np.concatenate(
        [compress.decompress_group(c, z) for z in range(1 << ib.t)]),
        ib.g_keys), "13b: the low-bits round trip failed")
    for enc, dec in ((compress.gamma_encode, compress.gamma_decode),
                     (compress.delta_encode, compress.delta_decode)):
        require(np.array_equal(dec(*enc(truth)), truth),
                f"13b: the {enc.__name__} round trip failed")
    space = compress.space_report(ib)
    out["13b"] = {"a": len(a), "b": len(b), "r": len(truth),
                  "host_ms": host_ms, "space_bits_per_element": space}
    print(f"phase 13b quickstart sets |A| {len(a)}, |B| {len(b)}, r "
          f"{len(truth)}: {len(runs)} algorithms and baselines equal "
          f"np.intersect1d, host ms "
          f"{ {k: round(v, 1) for k, v in host_ms.items()} }; low-bits, "
          f"gamma and delta round trips; space_report (bits/element) "
          f"{ {k: round(v, 3) for k, v in space.items()} }")
    out["s"]["13b"] = time.perf_counter() - t_part
    print(f"phase 13b: {out['s']['13b']:.1f} s")
    report["host_route"] = out
    return launches


# -- phase 14: constrained LM decoding at full width ---------------------------

def lm_row_errs(got, want):
    """Each logit row's relative L2 error (over the last axis)."""
    got = got.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def lm_row_err(got, want) -> float:
    """The largest relative L2 error of a logit row (the last axis)."""
    return float(lm_row_errs(got, want).max())


def round_e4m3(torch, params):
    """A copy of ``params`` with every tensor rounded through
    ``torch.float8_e4m3fn`` at a per-tensor scale (its largest magnitude
    at e4m3's largest value, 448): 3 mantissa bits where bf16 keeps 8."""
    import copy

    out = copy.deepcopy(params)
    with torch.no_grad():
        for p in out.parameters():
            s = float(p.abs().amax()) / 448.0 or 1.0
            p.copy_((p / s).to(torch.float8_e4m3fn).to(p.dtype) * s)
    return out


def greedy_tokens(torch, model, params, prompt, max_new: int, max_seq: int,
                  mask=None) -> list:
    """The tokens a one-slot ``DecodeServer`` gives ``prompt``, by a plain
    loop over ``model.decode`` on the server's schedule: the prompt at
    positions 0..P-1, its last token again at P, then each new token at the
    next position, until ``max_new`` tokens or position ``max_seq - 1``."""
    from repro_torch.serve.constrain import apply_mask_to_logits

    cache = model.init_cache(1, max_seq)
    pos = 0

    def step(tok: int) -> int:
        nonlocal cache, pos
        logits, cache = model.decode(
            params, cache, torch.tensor([[tok]], device=model.device), pos)
        pos += 1
        if mask is not None:
            logits = apply_mask_to_logits(logits, mask, model.cfg.vocab)
        return int(torch.argmax(logits, dim=-1)[0])

    for tok in prompt.tolist():
        step(tok)
    out, last = [], int(prompt[-1])
    while True:
        last = step(last)
        out.append(last)
        if len(out) >= max_new or pos >= max_seq - 1:
            return out


def lm_requests(rng, vocab: int, n: int, packed,
                prompt_range=LM_PROMPT_RANGE, max_new_range=LM_MAX_NEW_RANGE):
    """``n`` seeded requests: prompt lengths log-uniform in
    ``prompt_range``, ``max_new`` uniform in ``max_new_range``, every
    even-numbered one constrained by ``packed``."""
    from repro_torch.serve.engine import Request

    lo, hi = np.log(prompt_range[0]), np.log(prompt_range[1])
    out = []
    for i in range(n):
        p = int(round(float(np.exp(rng.uniform(lo, hi)))))
        out.append(Request(
            prompt=rng.integers(0, vocab, p),
            max_new=int(rng.integers(max_new_range[0], max_new_range[1] + 1)),
            constraint=packed if i % 2 == 0 else None))
    return out


def time_lm(torch, model, params, cs, rng) -> dict:
    """14c: one decode step at B ``LM_SLOTS`` and cache depth ``LM_MAX_SEQ``
    beside its bound (the weights read once, the cache read, the logits
    written), prefill at B ``LM_SLOTS`` x S ``LM_PREFILL_LEN``, and the
    mask ops on ``cs``'s three masks, all with CUDA events."""
    from repro_torch.kernels import ops
    from repro_torch.serve.constrain import apply_mask_to_logits

    cfg, v = model.cfg, model.cfg.vocab
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    n_params = sum(p.numel() for p in params.parameters())
    cache = model.init_cache(LM_SLOTS, LM_MAX_SEQ)
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=model.device)
    step_ms = cuda_ms(torch, lambda: model.decode(params, cache, tok,
                                                  LM_MAX_SEQ - 1))
    prof = profile_breakdown(torch, lambda: [
        model.decode(params, cache, tok, LM_MAX_SEQ - 1)
        for _ in range(LM_PROFILED_STEPS)],
        groups=("nvjet", "bfloat16_copy"))   # cuBLAS products, weight casts
    busy_ms = (prof["device_busy_ms"] or 0.0) / LM_PROFILED_STEPS
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    del cache
    step_bytes = param_bytes + cache_bytes + LM_SLOTS * v * 2
    step_ops = 2 * n_params * LM_SLOTS
    bound_ms = max(step_bytes / HBM_BYTES_PER_S,
                   step_ops / BF16_OPS_PER_S) * 1e3
    long = torch.from_numpy(rng.integers(
        0, v, (LM_SLOTS, LM_PREFILL_LEN))).to(model.device)
    prefill_ms = cuda_ms(torch, lambda: model.prefill(params, {"tokens": long}),
                         iters=LM_PREFILL_ITERS)
    stack = torch.stack(list(cs.masks.values()))
    packed = ops.vocab_mask_and(stack)
    bools = ops.unpack_vocab_mask(packed, v)
    logits = torch.zeros((LM_SLOTS, v), dtype=cfg.activation_dtype,
                         device=model.device)
    mask_ms = {
        "vocab_mask_and": cuda_ms(torch, lambda: ops.vocab_mask_and(stack)),
        "pack_vocab_mask": cuda_ms(torch, lambda: ops.pack_vocab_mask(bools)),
        "unpack_vocab_mask": cuda_ms(
            torch, lambda: ops.unpack_vocab_mask(packed, v)),
        "apply_mask_to_logits": cuda_ms(
            torch, lambda: apply_mask_to_logits(logits, packed, v))}
    return {"card": nvidia_smi(), "decode_step_ms": step_ms,
            "profile": prof,
            "device_calls_per_step": prof["device_calls"] / LM_PROFILED_STEPS,
            "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / step_ms,
            "decode_step_bound_ms": bound_ms, "decode_step_bytes": step_bytes,
            "decode_step_ops": step_ops, "bound_share": bound_ms / step_ms,
            "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": LM_SLOTS * LM_PREFILL_LEN / prefill_ms * 1e3,
            "mask_us": {k: ms * 1e3 for k, ms in mask_ms.items()}}


def run_lm_serving(torch, report) -> dict:
    """Phase 14: ``get_config(LM_ARCH)`` unreduced (fp32 weights drawn from
    a seeded generator on the card, bf16 activations) through the port's
    ``build_model``, ``ConstraintSet`` and ``DecodeServer``:
    14a prefill's last-position logits and decode's logits at every
    position against a float32 reference (TF32 off) on the same weights,
    decode against prefill, and the same comparison failing with the
    weights rounded to e4m3; 14b the server on ``LM_REQUESTS`` seeded
    requests, half constrained by three masks, the masks bit-identical to
    the CPU's, a one-slot server equal to a greedy loop, and the ticker;
    14c times beside the decode step's bound.  Returns the three kernels'
    launches over the phase (none is on this path)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve.constrain import (
        ConstraintSet, constrained_greedy_token,
    )
    from repro_torch.serve.engine import DecodeServer, Request

    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda, "pair_count": count_block_cuda}
    for k in kernels.values():
        k.launches = 0
    cfg = get_config(LM_ARCH)
    out = {"arch": cfg.name, "s": {}}
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # 14a: agreement with a float32 reference
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(SEED)
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(SEED + 14)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN))).to(model.device)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with no_tf32(torch), torch.no_grad():
        hidden = transformer.forward(params, cfg32, tokens)
        ref = torch.stack([transformer.logits_fn(params, cfg32, h)
                           for h in hidden])   # (B, S, V), one row a block
    del hidden
    prefill = model.prefill(params, {"tokens": tokens})
    prefill_err = lm_row_err(prefill, ref[:, -1])
    cache = model.init_cache(LM_PROMPTS, LM_PROMPT_LEN)
    decode_err = 0.0
    for pos in range(LM_PROMPT_LEN):
        logits, cache = model.decode(params, cache, tokens[:, pos:pos + 1], pos)
        decode_err = max(decode_err, lm_row_err(logits, ref[:, pos]))
    decode_vs_prefill = lm_row_err(logits, prefill.float())
    del cache
    require(torch.isfinite(prefill).all() and prefill.shape == (
        LM_PROMPTS, cfg.vocab), "14a: prefill logits not finite or misshapen")
    require(prefill_err <= LM_TOL,
            f"14a: prefill vs float32 reference {prefill_err} > {LM_TOL}")
    require(decode_err <= LM_TOL,
            f"14a: decode vs float32 reference {decode_err} > {LM_TOL}")
    require(decode_vs_prefill <= LM_TOL,
            f"14a: decode vs prefill {decode_vs_prefill} > {LM_TOL}")
    rounded = round_e4m3(torch, params)
    e4m3_err = lm_row_err(model.prefill(rounded, {"tokens": tokens}),
                          ref[:, -1])
    del rounded, ref
    require(e4m3_err > LM_TOL,
            f"14a: e4m3-rounded weights pass the tolerance ({e4m3_err} <= "
            f"{LM_TOL}); it does not separate bf16 from them")
    peak_14a = torch.cuda.max_memory_allocated()
    out["14a"] = {"layers": cfg.n_layers, "params": n_params,
                  "param_bytes": param_bytes, "init_s": init_s,
                  "prompts": LM_PROMPTS, "prompt_len": LM_PROMPT_LEN,
                  "tol": LM_TOL, "prefill_err": prefill_err,
                  "decode_err": decode_err,
                  "decode_vs_prefill": decode_vs_prefill,
                  "e4m3_prefill_err": e4m3_err, "peak_bytes": peak_14a}
    print(f"phase 14a {cfg.name}: {cfg.n_layers} layers, {n_params} "
          f"parameters ({param_bytes} bytes, {cfg.param_dtype}), activations "
          f"{cfg.dtype}; build and init {init_s:.2f} s; {LM_PROMPTS} prompts "
          f"x {LM_PROMPT_LEN}: largest row relative L2 error of the logits "
          f"against float32 (TF32 off): prefill {prefill_err:.5f}, decode "
          f"(every position) {decode_err:.5f}; decode vs prefill "
          f"{decode_vs_prefill:.5f}; tolerance {LM_TOL}; weights rounded to "
          f"e4m3: {e4m3_err:.5f} (must fail)")
    out["s"]["14a"] = time.perf_counter() - t_part
    print(f"phase 14a: {out['s']['14a']:.1f} s")
    t_part = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 14b: the server
    v = cfg.vocab
    masks = {"grammar": rng.choice(v, min(LM_ALLOWED, v), replace=False),
             "retrieval": rng.choice(v, min(LM_WHITELIST, v), replace=False),
             "stoplist": np.arange(min(LM_STOP, v))}
    allowed = set(np.setdiff1d(np.intersect1d(masks["grammar"],
                                              masks["retrieval"]),
                               masks["stoplist"]).tolist())
    sets = {}
    for dev in ("cuda", "cpu"):
        cs = ConstraintSet(v, device=dev)
        cs.add_allowed("grammar", masks["grammar"])
        cs.add_allowed("retrieval", masks["retrieval"])
        cs.add_banned("stoplist", masks["stoplist"])
        sets[dev] = cs
    cs, cs_cpu = sets["cuda"], sets["cpu"]
    packed = cs.combined()
    for name in masks:
        require(torch.equal(cs.masks[name].cpu(), cs_cpu.masks[name]),
                f"14b: pack_vocab_mask of {name} differs from the CPU's")
    require(torch.equal(packed.cpu(), cs_cpu.combined()),
            "14b: vocab_mask_and differs from the CPU's")
    unpacked = ops.unpack_vocab_mask(packed, v)
    require(torch.equal(unpacked.cpu(),
                        ops.unpack_vocab_mask(cs_cpu.combined(), v)),
            "14b: unpack_vocab_mask differs from the CPU's")
    require(set(torch.nonzero(unpacked).flatten().tolist()) == allowed,
            "14b: the packed intersection is not numpy's")
    none = ConstraintSet(v)
    none.add_banned("all", np.arange(v))
    require(constrained_greedy_token(torch.zeros(2, v, device=model.device),
                                     none.combined(), v).tolist() == [0, 0],
            "14b: an all-banned row does not give token 0")

    reqs = lm_requests(rng, v, LM_REQUESTS, packed)
    srv = DecodeServer(model, params, batch_slots=LM_SLOTS,
                       max_seq=LM_MAX_SEQ)
    decode = srv._decode
    calls = [0]

    def counting(*args):
        calls[0] += 1
        return decode(*args)
    srv._decode = counting
    t0 = time.perf_counter()
    tickets = [srv.submit(r) for r in reqs]
    srv.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    generated = sum(len(r.out) for r in reqs)
    for r, t in zip(reqs, tickets):
        require(r.done and t.done and t.value == r.out,
                "14b: a ticket did not resolve to its request's tokens")
        require(len(r.out) == r.max_new, "14b: a request stopped early")
        if r.constraint is not None:
            require(set(r.out) <= allowed,
                    "14b: a constrained token lies outside the intersection")
    constrained = [t for r in reqs if r.constraint is not None for t in r.out]

    # the shortest requests (prompt plus max_new), to keep the phase short:
    # the shortest constrained and free ones against the greedy loop, the
    # LM_TICKER_REQUESTS shortest through the ticker
    by_len = sorted(reqs, key=lambda r: len(r.prompt) + r.max_new)
    one = DecodeServer(model, params, batch_slots=1, max_seq=LM_MAX_SEQ)
    firsts = [Request(prompt=r.prompt, max_new=r.max_new,
                      constraint=r.constraint)
              for r in ([r for r in by_len if r.constraint is not None][:1]
                        + [r for r in by_len if r.constraint is None][:1])]
    for r in firsts:
        one.submit(r)
    one.run_until_drained()
    for r in firsts:
        require(r.out == greedy_tokens(torch, model, params, r.prompt,
                                       r.max_new, LM_MAX_SEQ, r.constraint),
                "14b: the one-slot server differs from the greedy loop")

    ticker = DecodeServer(model, params, batch_slots=LM_SLOTS,
                          max_seq=LM_MAX_SEQ).start()
    treqs = [Request(prompt=r.prompt, max_new=r.max_new,
                     constraint=r.constraint)
             for r in by_len[:LM_TICKER_REQUESTS]]
    ttickets = [None] * len(treqs)

    def submit(idx):
        for i in idx:
            ttickets[i] = ticker.submit(treqs[i])
    threads = [threading.Thread(target=submit, args=(
        list(range(j, len(treqs), LM_TICKER_THREADS)),))
        for j in range(LM_TICKER_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        require(not t.is_alive(), "14b: a submitter thread hung")
    for t in ttickets:
        require(t.wait(timeout=600), "14b: a ticker ticket did not resolve")
    thread = ticker._ticker
    ticker.stop()
    require(not thread.is_alive(), "14b: the ticker survived stop()")
    for r, t in zip(treqs, ttickets):
        require(t.value == r.out and len(r.out) == r.max_new,
                "14b: a ticker ticket does not hold its request's tokens")
        if r.constraint is not None:
            require(set(r.out) <= allowed,
                    "14b: a ticker token lies outside the intersection")
    peak_14b = torch.cuda.max_memory_allocated()
    out["14b"] = {
        "requests": len(reqs), "constrained": len(reqs[::2]),
        "allowed": len(allowed), "prompt_tokens": sum(len(r.prompt)
                                                      for r in reqs),
        "generated": generated, "constrained_tokens": len(constrained),
        "decode_calls": calls[0], "ticks": srv.ticks, "serve_s": serve_s,
        "tokens_per_s": generated / serve_s,
        "ms_per_tick": serve_s / srv.ticks * 1e3,
        "ms_per_decode_call": serve_s / calls[0] * 1e3,
        "greedy_requests": len(firsts), "ticker_requests": len(treqs),
        "peak_bytes": peak_14b}
    print(f"phase 14b DecodeServer(batch_slots={LM_SLOTS}, "
          f"max_seq={LM_MAX_SEQ})"
          f": {len(reqs)} requests ({len(reqs[::2])} constrained, "
          f"{len(allowed)} allowed tokens), {out['14b']['prompt_tokens']} "
          f"prompt tokens, {generated} generated ({len(constrained)} "
          f"constrained, all in the intersection) in {serve_s:.2f} s: "
          f"{generated / serve_s:.2f} generated tokens/s, {srv.ticks} ticks, "
          f"{serve_s / srv.ticks * 1e3:.1f} ms a tick, {calls[0]} decode "
          f"calls ({serve_s / calls[0] * 1e3:.2f} ms each); masks "
          f"bit-identical to the CPU's; one-slot server equal to the greedy "
          f"loop on {len(firsts)} requests; ticker served {len(treqs)} "
          f"requests from {LM_TICKER_THREADS} threads; peak device memory "
          f"{peak_14b} bytes")
    out["s"]["14b"] = time.perf_counter() - t_part
    print(f"phase 14b: {out['s']['14b']:.1f} s")
    t_part = time.perf_counter()

    # 14c: times
    out["14c"] = time_lm(torch, model, params, cs, rng)
    print(f"phase 14c on {out['14c']['card']}: decode step (B {LM_SLOTS}, "
          f"cache depth {LM_MAX_SEQ}) {out['14c']['decode_step_ms']:.3f} ms "
          f"against a {out['14c']['decode_step_bound_ms']:.3f} ms bound "
          f"({out['14c']['decode_step_bytes']} bytes: the weights once, "
          f"the cache, the logits; share "
          f"{out['14c']['bound_share']:.3f}); prefill B {LM_SLOTS} x S "
          f"{LM_PREFILL_LEN} {out['14c']['prefill_ms']:.2f} ms, "
          f"{out['14c']['prefill_tokens_per_s']:.0f} tokens/s; server "
          f"{out['14b']['tokens_per_s']:.2f} generated tokens/s, "
          f"{out['14b']['ms_per_tick']:.1f} ms a tick; mask ops at V "
          f"{cfg.vocab}, k {len(cs.masks)} (us): "
          f"{ {k: round(x, 2) for k, x in out['14c']['mask_us'].items()} }")
    prof = out["14c"]["profile"]
    print(f"phase 14c profiled decode step: "
          f"{out['14c']['device_calls_per_step']:.0f} device calls, device "
          f"busy {out['14c']['device_busy_ms_per_step']:.3f} ms a step, "
          f"{out['14c']['device_busy_share']:.3f} of the unprofiled step; "
          f"cuBLAS products {prof['kernel_ms']['nvjet']:.3f} ms, bf16 "
          f"casts {prof['kernel_ms']['bfloat16_copy']:.3f} ms (over "
          f"{LM_PROFILED_STEPS} step)")
    for row in prof["top"][:8]:
        print(f"  {row['ms']:10.3f} ms  {row['calls']:6d}x  "
              f"{row['name'][:90]}")
    launches = {name: k.launches for name, k in kernels.items()}
    require(sum(launches.values()) == 0,
            f"14: the set-intersection kernels launched {launches}")
    out["launches"] = launches
    out["s"]["14c"] = time.perf_counter() - t_part
    print(f"phase 14c: {out['s']['14c']:.1f} s")
    report["lm_serving"] = out
    return launches


# -- phase 15: the moe, ssm_hybrid, xlstm and encdec families, unreduced -------

def take_routes(log: list, b: int, s: int, decode: bool):
    """Empties ``log`` (the ``moe.Route``s of one forward over (b, s)
    tokens, or of s decode steps over b) -> (top-k sets, applied sets),
    each (layers, b, s, k) and sorted along k; None if it is empty."""
    if not log:
        return None
    top, used = (np.stack([np.sort(getattr(r, f).cpu().numpy(), -1)
                           for r in log]) for f in ("topi", "applied"))
    log.clear()
    k = top.shape[-1]
    if decode:              # step-major: (s, layers, b, k)
        return tuple(x.reshape(s, -1, b, k).transpose(1, 2, 0, 3)
                     for x in (top, used))
    return tuple(x.reshape(-1, b, s, k) for x in (top, used))


def family_batch(torch, cfg, rng, b: int, s: int, device) -> dict:
    """Seeded tokens (b, s), and for the encoder-decoder family frames
    (b, encoder_seq, frontend_dim) from numpy."""
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s))).to(device)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
        ).to(device)
    return batch


def decode_logits(torch, model, params, batch, **kw):
    """``model.decode`` at every position of the batch's tokens from a new
    cache (the encoder-decoder's cross-attention KV filled by
    ``encdec.prefill_cross`` from ``encode``), float32 (B, S, V)."""
    from repro_torch.models import encdec

    cfg, tokens = model.cfg, batch["tokens"]
    b, s = tokens.shape
    cache = model.init_cache(b, s)
    if cfg.family == "encdec":
        cache = encdec.prefill_cross(
            params, cfg, encdec.encode(params, cfg, batch["frames"]), cache)
    out = torch.empty((b, s, cfg.vocab), dtype=torch.float32,
                      device=tokens.device)
    for pos in range(s):
        logits, cache = model.decode(params, cache, tokens[:, pos:pos + 1],
                                     pos, **kw)
        out[:, pos] = logits.float()
    return out


@contextlib.contextmanager
def no_tf32(torch):
    """float32 products in float32 (TF32 off) inside the block."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def prefill_logits(torch, model, params, batch, **kw):
    """Logits at every position, (B, S, V) float32, one prompt a block."""
    from repro_torch.models import transformer

    hidden = model.hidden(params, batch, **kw)
    return torch.stack([transformer.logits_fn(params, model.cfg, h).float()
                        for h in hidden])


def held_err(errs, agree, what: str, hold: bool = True) -> dict:
    """``errs`` (rows) against ``LM_TOL`` if ``hold``: all of them, unless
    some row past it has routes that differ (``agree`` False, MoE only):
    then only the rows whose routes agree are held, and the largest error
    on the others is reported."""
    errs = errs.float().cpu().numpy().reshape(-1)
    agree = np.ones_like(errs, bool) if agree is None else agree.reshape(-1)
    out = {"err": float(errs.max()), "rows": int(errs.size),
           "rows_routes_differ": int((~agree).sum()),
           "held": "all rows" if hold else "reported only"}
    if hold and out["err"] > LM_TOL and not agree.all():
        out["held"] = "rows whose routes agree"
        out["err_flipped_rows"] = float(errs[~agree].max())
        out["err"] = float(errs[agree].max()) if agree.any() else 0.0
    require(not hold or out["err"] <= LM_TOL,
            f"15a: {what} {out['err']} > {LM_TOL} ({out['held']})")
    return out


class BlockHold:
    """15a block by block: each bfloat16 block, fed the float32 stream's
    input to it rounded to bfloat16, against the float32 block: the
    largest row (token) relative L2 error of the stream after the block,
    held to ``LM_TOL``.  In a MoE block, a token whose top-k set differs
    must be a near-tie (the gap between its float32 k-th and (k+1)-th
    log-probabilities within ``FAM_NEAR_TIE``), and rows whose applied
    experts differ are left out only if some row fails; flips are
    counted."""

    def __init__(self, what: str):
        self.what = what
        self.out = {"blocks": 0, "err": 0.0, "worst_block": -1,
                    "route_flips": 0, "moe_blocks": 0, "held": "all rows",
                    "errs": [], "blocks_held_on_agreeing_rows": 0,
                    "err_rows_agree": 0.0, "err_rows_differ": 0.0,
                    "rows_differ": 0, "pairs": 0, "flip_gap": 0.0}

    def add(self, i: int, y16, y32, r16, r32) -> None:
        out, agree = self.out, None
        errs = lm_row_errs(y16, y32)
        if r32:                          # a MoE block: one route each
            (a16,), (a32,) = r16, r32
            agree = (a16.applied.sort(-1)[0] == a32.applied.sort(-1)[0]
                     ).all(-1).cpu().numpy()
            flipped = (a16.topi.sort(-1)[0] != a32.topi.sort(-1)[0]).any(-1)
            if flipped.any():
                k = a32.topi.shape[-1]
                top = a32.probs[flipped].double().log().sort(
                    -1, descending=True)[0]
                gap = float((top[:, k - 1] - top[:, k]).max())
                out["flip_gap"] = max(out["flip_gap"], gap)
                require(gap <= FAM_NEAR_TIE,
                        f"15a: {self.what} block {i}: a route flip with a "
                        f"log-gap {gap} > {FAM_NEAR_TIE}, no near-tie")
            r16.clear()
            r32.clear()
            out["route_flips"] += int(flipped.sum())
            out["moe_blocks"] += 1
            out["pairs"] += int(flipped.numel())
            errs_np = errs.float().cpu().numpy().reshape(-1)
            out["rows_differ"] += int((~agree).sum())
            out["err_rows_agree"] = max(out["err_rows_agree"],
                                        float(errs_np[agree].max()))
            if not agree.all():
                out["err_rows_differ"] = max(out["err_rows_differ"],
                                             float(errs_np[~agree].max()))
        r = held_err(errs, agree, f"{self.what} block {i}")
        out["errs"].append(r["err"])
        if r["held"] != "all rows":
            out["blocks_held_on_agreeing_rows"] += 1
        if r["err"] > out["err"]:
            out["err"], out["worst_block"], out["held"] = r["err"], i, r["held"]
        out["blocks"] += 1


def check_prefill_blocks(torch, model, model32, params, tokens, log) -> dict:
    """``BlockHold`` over the prefill's blocks (``Model.blocks``); the MoE
    blocks return (stream, aux)."""
    from repro_torch.models import transformer

    kw = {"routes": log} if model.cfg.family == "moe" else {}
    hold, log16 = BlockHold("prefill"), []
    kw16 = {"routes": log16} if kw else {}
    with no_tf32(torch), torch.no_grad():
        x = transformer._embed(params, model32.cfg, tokens)
        for i, (b16, b32) in enumerate(zip(
                model.blocks(params, tokens, **kw16),
                model32.blocks(params, tokens, **kw))):
            y32, y16 = b32(x), b16(x.to(model.cfg.activation_dtype))
            if kw:
                y32, y16 = y32[0], y16[0]
            hold.add(i, y16, y32, log16, log)
            x = y32
    return hold.out


def check_decode_blocks(torch, model, model32, params, tokens, log):
    """``BlockHold`` over the decode's blocks (``Model.decode_blocks``) at
    every position: each bfloat16 block is fed the float32 decode's input
    to it and its float32 state (the float32 cache before the step, cast
    to the bfloat16 cache's dtypes).  Returns the float32 decode's logits
    (B, S, V), which these steps compute, the record, and the float32
    decode's ``moe.Route``s (step-major)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import rmsnorm

    cfg32 = model32.cfg
    b, s = tokens.shape
    kw = {"routes": log} if cfg32.family == "moe" else {}
    hold, log16 = BlockHold("decode"), []
    kw16 = {"routes": log16} if kw else {}
    cache32 = model32.init_cache(b, s)
    dtypes = {k: v.dtype for k, v in model.init_cache(1, 1).items()}
    logits = torch.empty((b, s, cfg32.vocab), dtype=torch.float32,
                         device=tokens.device)
    routes32 = []
    with no_tf32(torch), torch.no_grad():
        for pos in range(s):
            cache16 = {k: v.to(dtypes[k], copy=True)
                       for k, v in cache32.items()}
            x = transformer._embed(params, cfg32, tokens[:, pos:pos + 1])
            for i, (b16, b32) in enumerate(zip(
                    model.decode_blocks(params, cache16, pos, **kw16),
                    model32.decode_blocks(params, cache32, pos, **kw))):
                y32, y16 = b32(x), b16(x.to(model.cfg.activation_dtype))
                routes32 += log
                hold.add(i, y16, y32, log16, log)
                x = y32
            logits[:, pos] = transformer.logits_fn(
                params, cfg32, rmsnorm(params.ln_f, x))[:, 0].float()
    return logits, hold.out, routes32


def check_family_logits(torch, model, params, batch) -> dict:
    """15a: prefill's last-position logits against a float32 prefill, and
    decode's at every position against a float32 decode, on the same
    weights (TF32 off); the float32 decode against the float32 prefill at
    every position; the bfloat16 decode against the bfloat16 prefill.  The
    bfloat16 comparisons are held to ``LM_TOL`` for ``FAM_E2E_HELD``,
    otherwise reported, and every block of the prefill and of the decode at
    every position held instead (``BlockHold``; the float32 decode is then
    the one ``check_decode_blocks`` steps through); the float32 ones are
    held (ssm_hybrid's decode against prefill: only reported, the
    reference's shared KV cache).  MoE: the decode's float32 prefill runs
    at a capacity that drops nothing (decode drops nothing at B 4), rows
    whose applied experts differ are left out only if some row fails, and
    route flips are counted."""
    import dataclasses

    from repro_torch.models.model import build_model

    cfg = model.cfg
    tokens = batch["tokens"]
    b, s = tokens.shape
    is_moe = cfg.family == "moe"
    hold = cfg.name in FAM_E2E_HELD
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32, device=model.device)
    # decode's float32 prefill: a capacity of every token, so no drops
    model32_nd = (build_model(dataclasses.replace(
        cfg32, capacity_factor=cfg.n_experts / cfg.experts_per_token),
        device=model.device) if is_moe else model32)
    log = []
    kw = {"routes": log} if is_moe else {}
    out, routes = {}, {}
    with no_tf32(torch), torch.no_grad():
        ref = prefill_logits(torch, model32, params, batch, **kw)
        routes["f32"] = take_routes(log, b, s, decode=False)
        ref_nd = (prefill_logits(torch, model32_nd, params, batch, **kw)
                  if is_moe else ref)
        routes["f32_nd"] = take_routes(log, b, s, decode=False)
        if hold:
            ref_dec, dec_routes = decode_logits(
                torch, model32, params, batch, **kw), log
    if not hold:
        out["blocks"] = check_prefill_blocks(torch, model, model32, params,
                                             tokens, log)
        ref_dec, out["decode_blocks"], dec_routes = check_decode_blocks(
            torch, model, model32, params, tokens, log)
    routes["f32_dec"] = take_routes(dec_routes, b, s, decode=True)
    with torch.no_grad():
        prefill = model.prefill(params, batch)
        if is_moe:
            model.hidden(params, batch, **kw)
        routes["bf16"] = take_routes(log, b, s, decode=False)
        dec = decode_logits(torch, model, params, batch, **kw)
        routes["bf16_dec"] = take_routes(log, b, s, decode=True)
    require(torch.isfinite(prefill).all() and prefill.shape == (
        b, cfg.vocab), "15a: prefill logits not finite or misshapen")
    require(bool(torch.isfinite(dec).all()), "15a: decode logits not finite")
    agree = dict.fromkeys(("f32_dec_vs_prefill", "bf16_dec_vs_prefill"))
    if is_moe:
        # (top-k sets, applied sets), each (layers, B, S, k)
        (t32, u32), (tnd, und), (td32, ud32), (t16, u16), (td16, ud16) = (
            routes[k] for k in ("f32", "f32_nd", "f32_dec", "bf16",
                                "bf16_dec"))
        agree = {"f32_dec_vs_prefill": (ud32 == und).all(axis=(0, 3)),
                 "bf16_dec_vs_prefill": (ud16[:, :, -1] == u16[:, :, -1])
                 .all(axis=(0, 2))}
        out["route_flips"] = {
            "bf16_vs_f32_prefill": int((t16 != t32).any(-1).sum()),
            "bf16_vs_f32_decode": int((td16 != td32).any(-1).sum()),
            "f32_decode_vs_prefill": int((td32 != tnd).any(-1).sum()),
            "pairs": int(t32.shape[0] * b * s)}
        out["pairs_dropped_f32_prefill"] = int((u32 < 0).sum())
    out["prefill"] = held_err(lm_row_errs(prefill, ref[:, -1]), None,
                              "prefill vs float32", hold)
    out["decode"] = held_err(lm_row_errs(dec, ref_dec), None,
                             "decode vs float32", hold)
    out["f32_decode_vs_prefill"] = held_err(
        lm_row_errs(ref_dec, ref_nd), agree["f32_dec_vs_prefill"],
        "float32 decode vs float32 prefill",
        cfg.family != "ssm_hybrid")
    out["decode_vs_prefill"] = held_err(
        lm_row_errs(dec[:, -1], prefill.float()),
        agree["bf16_dec_vs_prefill"], "decode vs prefill", hold)
    return out


def serve_family(torch, model, params, rng) -> dict:
    """15b: ``DecodeServer`` on ``FAM_REQUESTS`` seeded requests, half
    constrained by three ANDed masks (phase 14's, scaled to the
    vocabulary); every constrained token in numpy's intersection, every
    ticket its request's tokens, and a one-slot server on the shortest
    constrained request equal to a greedy loop over ``model.decode``."""
    from repro_torch.serve.constrain import ConstraintSet
    from repro_torch.serve.engine import DecodeServer, Request

    v = model.cfg.vocab
    n_allowed, n_white, n_stop = (max(1, round(v * n / LM_MASK_VOCAB))
                                  for n in (LM_ALLOWED, LM_WHITELIST, LM_STOP))
    masks = {"grammar": rng.choice(v, n_allowed, replace=False),
             "retrieval": rng.choice(v, n_white, replace=False),
             "stoplist": np.arange(n_stop)}
    allowed = set(np.setdiff1d(np.intersect1d(masks["grammar"],
                                              masks["retrieval"]),
                               masks["stoplist"]).tolist())
    cs = ConstraintSet(v, device=model.device)
    cs.add_allowed("grammar", masks["grammar"])
    cs.add_allowed("retrieval", masks["retrieval"])
    cs.add_banned("stoplist", masks["stoplist"])
    packed = cs.combined()
    reqs = lm_requests(rng, v, FAM_REQUESTS, packed, FAM_PROMPT_RANGE,
                       FAM_MAX_NEW_RANGE)
    srv = DecodeServer(model, params, batch_slots=FAM_SLOTS,
                       max_seq=FAM_MAX_SEQ)
    t0 = time.perf_counter()
    tickets = [srv.submit(r) for r in reqs]
    srv.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    for r, t in zip(reqs, tickets):
        require(r.done and t.done and t.value == r.out
                and len(r.out) == r.max_new,
                "15b: a ticket does not hold its request's tokens")
        if r.constraint is not None:
            require(set(r.out) <= allowed,
                    "15b: a constrained token lies outside the intersection")
    first = min((r for r in reqs if r.constraint is not None),
                key=lambda r: len(r.prompt) + r.max_new)
    one = DecodeServer(model, params, batch_slots=1, max_seq=FAM_MAX_SEQ)
    again = Request(prompt=first.prompt, max_new=first.max_new,
                    constraint=first.constraint)
    one.submit(again)
    one.run_until_drained()
    require(again.out == greedy_tokens(torch, model, params, first.prompt,
                                       first.max_new, FAM_MAX_SEQ, packed),
            "15b: the one-slot server differs from the greedy loop")
    generated = sum(len(r.out) for r in reqs)
    return {"requests": len(reqs), "allowed": len(allowed),
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "generated": generated,
            "constrained_tokens": sum(len(r.out) for r in reqs
                                      if r.constraint is not None),
            "ticks": srv.ticks, "serve_s": serve_s,
            "tokens_per_s": generated / serve_s,
            "ms_per_tick": serve_s / srv.ticks * 1e3}


def time_family(torch, model, params, rng) -> dict:
    """15c: a decode step (B ``FAM_SLOTS``, cache depth ``FAM_STEP_DEPTH``)
    with CUDA events beside its bound (every weight byte read once, the
    cache read, the logits written; for the MoE family also the active
    parameters' bytes), one profiled step (device busy time, launches),
    and prefill at B ``FAM_SLOTS`` x S ``FAM_PREFILL_LEN`` (the
    encoder-decoder family: ``encode`` of ``encoder_seq`` frames)."""
    from repro_torch.models import encdec

    cfg, v = model.cfg, model.cfg.vocab
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    n_params = sum(p.numel() for p in params.parameters())
    cache = model.init_cache(FAM_SLOTS, FAM_STEP_DEPTH)
    tok = torch.zeros((FAM_SLOTS, 1), dtype=torch.int64, device=model.device)

    def step():
        return model.decode(params, cache, tok, FAM_STEP_DEPTH - 1)
    step_ms = cuda_ms(torch, step, iters=FAM_STEP_ITERS)
    prof = profile_breakdown(torch, step, groups=("nvjet", "bfloat16_copy"))
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    del cache
    extra = cache_bytes + FAM_SLOTS * v * 2
    out = {"card": nvidia_smi(), "params": n_params,
           "param_bytes": param_bytes, "decode_step_ms": step_ms,
           "decode_step_bound_ms": max(
               (param_bytes + extra) / HBM_BYTES_PER_S,
               2 * n_params * FAM_SLOTS / BF16_OPS_PER_S) * 1e3,
           "device_busy_ms": prof["device_busy_ms"],
           "device_calls": prof["device_calls"],
           "cast_ms": prof["kernel_ms"]["bfloat16_copy"],
           "cublas_ms": prof["kernel_ms"]["nvjet"],
           "top": prof["top"][:6]}
    out["bound_share"] = out["decode_step_bound_ms"] / step_ms
    if cfg.family == "moe":
        active = cfg.active_param_count()
        out["active_params"] = active
        out["active_bound_ms"] = (active * 4 + extra) / HBM_BYTES_PER_S * 1e3
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (FAM_SLOTS, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
        ).to(model.device)
        ms = cuda_ms(torch, lambda: encdec.encode(params, cfg, frames),
                     iters=FAM_PREFILL_ITERS)
        out.update(prefill="encode", prefill_ms=ms,
                   prefill_tokens_per_s=FAM_SLOTS * cfg.encoder_seq / ms * 1e3)
    else:
        long = torch.from_numpy(rng.integers(
            0, v, (FAM_SLOTS, FAM_PREFILL_LEN))).to(model.device)
        ms = cuda_ms(torch, lambda: model.prefill(params, {"tokens": long}),
                     iters=FAM_PREFILL_ITERS)
        out.update(prefill="prefill", prefill_ms=ms,
                   prefill_tokens_per_s=FAM_SLOTS * FAM_PREFILL_LEN / ms * 1e3)
    return out


def run_lm_family(torch, cfg, report) -> None:
    """15a-15c on one architecture (see ``run_lm_families``)."""
    import gc

    from repro_torch.models.model import build_model

    name = cfg.name
    out = {"layers": cfg.n_layers, "s": {}}
    report[name] = out
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(SEED)
    params = model.init(gen)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    rng = np.random.default_rng(SEED + 15)

    batch = family_batch(torch, cfg, rng, FAM_PROMPTS, FAM_PROMPT_LEN,
                         model.device)
    a = out["15a"] = check_family_logits(torch, model, params, batch)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    def err(key):
        r = a[key]
        text = f"{r['err']:.5f} ({r['held']}"
        if "err_flipped_rows" in r:
            text += (f"; {r['rows_routes_differ']} rows whose experts "
                     f"differ, largest error there "
                     f"{r['err_flipped_rows']:.5f}")
        return text + ")"
    frames = (f" and frames {(FAM_PROMPTS, cfg.encoder_seq, cfg.frontend_dim)}"
              if cfg.family == "encdec" else "")
    print(f"phase 15a {name}: {cfg.n_layers} layers, d {cfg.d_model}, V "
          f"{cfg.vocab}, {n_params} parameters ({param_bytes} bytes, "
          f"{cfg.param_dtype}), activations {cfg.dtype}; build and init "
          f"{out['init_s']:.2f} s; {FAM_PROMPTS} prompts x {FAM_PROMPT_LEN}"
          f"{frames}: largest row relative L2 error of the logits, bf16 "
          f"against float32 (TF32 off): prefill {err('prefill')}, decode "
          f"(every position, against a float32 decode) {err('decode')}; "
          f"bf16 decode vs bf16 prefill {err('decode_vs_prefill')}; "
          f"float32 decode vs float32 prefill (every position) "
          f"{err('f32_decode_vs_prefill')}; tolerance {LM_TOL}")
    for key, what in (("blocks", "prefill"), ("decode_blocks", "decode")):
        if key not in a:
            continue
        k = a[key]
        moe_rows = ""
        if k["moe_blocks"]:
            moe_rows = (f"; in MoE blocks {k['route_flips']} of {k['pairs']}"
                        f" routes flipped (each a near-tie: largest log-gap "
                        f"{k['flip_gap']:.5f}, bound {FAM_NEAR_TIE}), rows whose "
                        f"applied experts agree {k['err_rows_agree']:.5f}, "
                        f"the {k['rows_differ']} rows whose experts differ "
                        f"{k['err_rows_differ']:.5f}; "
                        f"{k['blocks_held_on_agreeing_rows']} blocks held "
                        f"on the rows whose experts agree")
        steps = (f" at each of {FAM_PROMPT_LEN} positions"
                 if what == "decode" else "")
        print(f"phase 15a {name} {what} block by block{steps}: "
              f"{k['blocks']} blocks, each fed the float32 input"
              f"{' and state' if what == 'decode' else ''}: largest row "
              f"relative L2 error of the stream after a block {k['err']:.5f}"
              f" (block {k['worst_block']}, {k['held']}){moe_rows}; "
              f"tolerance {LM_TOL}")
    if "route_flips" in a:
        rf = a["route_flips"]
        print(f"phase 15a {name} routes end to end: (token, layer) pairs "
              f"whose top-{cfg.experts_per_token} experts differ, of "
              f"{rf['pairs']}: bf16 vs float32 prefill "
              f"{rf['bf16_vs_f32_prefill']}, bf16 vs float32 decode "
              f"{rf['bf16_vs_f32_decode']}, float32 decode vs its prefill "
              f"{rf['f32_decode_vs_prefill']}; pairs the float32 prefill "
              f"drops at capacity {a['pairs_dropped_f32_prefill']}")
    out["s"]["15a"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    b = out["15b"] = serve_family(torch, model, params, rng)
    print(f"phase 15b {name} DecodeServer(batch_slots={FAM_SLOTS}, "
          f"max_seq={FAM_MAX_SEQ}): {b['requests']} requests (half "
          f"constrained, {b['allowed']} allowed tokens), "
          f"{b['prompt_tokens']} prompt tokens, {b['generated']} generated "
          f"({b['constrained_tokens']} constrained, all in the "
          f"intersection) in {b['serve_s']:.2f} s: "
          f"{b['tokens_per_s']:.2f} generated tokens/s, {b['ticks']} ticks, "
          f"{b['ms_per_tick']:.1f} ms a tick; one-slot server equal to the "
          f"greedy loop")
    out["s"]["15b"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    c = out["15c"] = time_family(torch, model, params, rng)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    active = ""
    if "active_bound_ms" in c:
        active = (f", {c['active_bound_ms']:.3f} ms for the "
                  f"{c['active_params']} active parameters' bytes")
    print(f"phase 15c {name} on {c['card']}: decode step (B {FAM_SLOTS}, "
          f"cache depth {FAM_STEP_DEPTH}) {c['decode_step_ms']:.3f} ms "
          f"against a {c['decode_step_bound_ms']:.3f} ms bound (every "
          f"weight byte once, the cache, the logits; share "
          f"{c['bound_share']:.3f}{active}); profiled step: "
          f"{c['device_calls']} device calls, device busy "
          f"{c['device_busy_ms'] or 0.0:.3f} ms (bf16 casts "
          f"{c['cast_ms']:.3f}, cuBLAS {c['cublas_ms']:.3f}); "
          f"{c['prefill']} B {FAM_SLOTS} x "
          f"{cfg.encoder_seq if c['prefill'] == 'encode' else FAM_PREFILL_LEN}"
          f" {c['prefill_ms']:.2f} ms, {c['prefill_tokens_per_s']:.0f} "
          f"{'frames' if c['prefill'] == 'encode' else 'tokens'}/s; peak "
          f"device memory {out['peak_bytes']} bytes")
    out["s"]["15c"] = time.perf_counter() - t_part
    print(f"phase 15 {name}: {sum(out['s'].values()):.1f} s")


def run_lm_families(torch, report) -> dict:
    """Phase 15: the moe, ssm_hybrid, xlstm and encdec families through
    the port's ``build_model`` and ``DecodeServer``, each at its full width
    and depth (the ``FAM_ARCHS`` configs unreduced; fp32 weights drawn from
    a seeded generator on the card, bf16 activations),
    in ``FAM_ARCHS``' order, each freed before the next:
    15a prefill's last-position logits and decode's at every position
    against a float32 reference (TF32 off) on the same weights, and decode
    against prefill, within ``LM_TOL`` for ``FAM_E2E_HELD``, the others
    reported and every block of the prefill and of the decode at every
    position held (``BlockHold``), MoE route flips counted; 15b the server on ``FAM_REQUESTS`` requests, half
    constrained, and a one-slot server against a greedy loop; 15c the
    decode step beside its bound, one profiled step, prefill tokens/s and
    peak memory.  Returns the three kernels' launches over the phase (none
    is on this path)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda

    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda, "pair_count": count_block_cuda}
    for k in kernels.values():
        k.launches = 0
    out = report["lm_families"] = {}
    for cfg in map(get_config, FAM_ARCHS):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        print(f"phase 15 {cfg.name}: device memory allocated before its "
              f"build {before} bytes")
        run_lm_family(torch, cfg, out)
        out[cfg.name]["allocated_before_bytes"] = before
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: k.launches for name, k in kernels.items()}
    require(sum(launches.values()) == 0,
            f"15: the set-intersection kernels launched {launches}")
    out["launches"] = launches
    return launches


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
    from repro_torch.kernels.count import count_block_cuda, make_count_table
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
    phase_s = {"1 build": time.perf_counter() - t_start}

    def phase_done(name: str, since: float) -> float:
        phase_s[name] = time.perf_counter() - since
        print(f"phase {name}: {phase_s[name]:.1f} s")
        return time.perf_counter()

    # phases 2 and 3: kernels against their plain versions
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bf_err, bf_cases = check_bitmap_filter(torch, gen, ops, ref,
                                           bitmap_filter_cuda)
    t_phase = phase_done("2 bitmap_filter", t_phase)
    gm_err, gm_cases = check_group_match(torch, gen, ops, ref, group_match_cuda)
    torch.cuda.empty_cache()
    t_phase = phase_done("3 group_match", t_phase)

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
    prof = profile_breakdown(torch, lambda: engine.query_batch(log))
    print(f"phase 4 profiled pass: wall {prof['wall_s']:.3f} s, device busy "
          f"{prof['device_busy_ms']} ms, share {prof['device_busy_share']}; "
          f"bitmap_filter {prof['kernel_ms']['bitmap_filter']:.3f} ms, "
          f"group_match {prof['kernel_ms']['group_match']:.3f} ms")
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

    t_phase = phase_done("4 slice", t_phase)

    # phase 5: checks and times on the main path's data, heaviest shapes
    torch.cuda.empty_cache()
    bf, gm = time_kernels(torch, engine, log, results, ref,
                          bitmap_filter_cuda, group_match_cuda)
    torch.cuda.empty_cache()
    t_phase = phase_done("5 times", t_phase)

    # phase 6: pair_count against its plain version
    pc_err, pc_cases = check_pair_count(torch, gen, ref, count_block_cuda,
                                        make_count_table)
    torch.cuda.empty_cache()
    t_phase = phase_done("6 pair_count", t_phase)

    # phase 7: the suggest slice
    pc_launches, pc_warm_launches, pc, suggest = run_suggest_slice(
        torch, ref, count_block_cuda, report)
    launches["pair_count"] = pc_launches
    t_phase = phase_done("7 suggest", t_phase)

    # phase 8: a mix where the pre-filter drops candidates
    small_launches = run_small_sets(torch, count_block_cuda, report)
    t_phase = phase_done("8 small sets", t_phase)

    # phase 9: the online front end on phase 4's index
    async_launches = run_online_front_end(torch, engine, postings, planted,
                                          log, report)
    torch.cuda.empty_cache()
    t_phase = phase_done("9 online front end", t_phase)

    # phase 10: boolean expressions on phase 4's index
    expr_launches, expr_log = run_boolean_expressions(torch, engine,
                                                      postings, report)
    async_launches.update(expr_launches)
    torch.cuda.empty_cache()
    t_phase = phase_done("10 boolean expressions", t_phase)

    # phase 11: z-sharded and 2-D execution, four shards on the card
    async_launches.update(run_sharded(torch, engine, results, log, planted,
                                      suggest, expr_log, report))
    del suggest, expr_log
    torch.cuda.empty_cache()
    t_phase = phase_done("11 sharded and 2-D", t_phase)

    # phase 12: observability and the load harness on phase 4's index
    async_launches.update(run_observability(torch, engine, postings, report))
    torch.cuda.empty_cache()
    t_phase = phase_done("12 observability", t_phase)

    # phase 13: the host route on phase 4's lists (launches nothing)
    host_launches = run_host_route(torch, engine, postings, log, results,
                                   report)
    del engine, postings, results
    torch.cuda.empty_cache()
    t_phase = phase_done("13 host route", t_phase)

    # phase 14: constrained LM decoding at qwen3-1.7b's full width
    lm_launches = run_lm_serving(torch, report)
    torch.cuda.empty_cache()
    t_phase = phase_done("14 LM serving", t_phase)

    # phase 15: the moe, ssm_hybrid, xlstm and encdec families unreduced
    fam_launches = run_lm_families(torch, report)
    t_phase = phase_done("15 LM families", t_phase)
    paths = {
        "bitmap_filter": {"query_batch": launches["bitmap_filter"]},
        "group_match": {"query_batch": launches["group_match"]},
        "pair_count": {"suggest_batch": launches["pair_count"],
                       "SuggestEngine.warm": pc_warm_launches,
                       "suggest_batch small sets": small_launches},
    }
    for path, by_kernel in async_launches.items():
        for name, n in by_kernel.items():
            paths[name][path] = n
    for name, by_path in paths.items():
        require(all(n > 0 for n in by_path.values()),
                f"{name} never launched on a path: {by_path}")
    kernels = [
        {"name": "bitmap_filter", "route": "cuda",
         "source": "src/repro_torch/csrc/bitmap_filter.cu",
         "replaces": "src/repro/kernels/bitmap_filter.py:64",
         "launches": launches["bitmap_filter"],
         "max_abs_err": max(bf_err, bf["max_abs_err"]),
         "ms": bf["ms"], "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
         "bound_by": bf["bound_by"], "library_ms": None,
         "launches_by_path": paths["bitmap_filter"]},
        {"name": "group_match", "route": "cuda",
         "source": "src/repro_torch/csrc/group_match.cu",
         "replaces": "src/repro/kernels/group_intersect.py:46",
         "launches": launches["group_match"],
         "max_abs_err": max(gm_err, gm["max_abs_err"]),
         "ms": gm["ms"], "plain_ms": gm["plain_ms"], "bound_ms": gm["bound_ms"],
         "bound_by": gm["bound_by"], "library_ms": None,
         "launches_by_path": paths["group_match"]},
        {"name": "pair_count", "route": "cuda",
         "source": "src/repro_torch/csrc/pair_count.cu",
         "replaces": "src/repro/kernels/count.py:70",
         "launches": launches["pair_count"],
         "max_abs_err": max(pc_err, pc["max_abs_err"]),
         "ms": pc["ms"], "plain_ms": pc["plain_ms"], "bound_ms": pc["bound_ms"],
         "bound_by": pc["bound_by"], "library_ms": None,
         "launches_by_path": paths["pair_count"]},
    ]
    report["kernels"] = kernels
    report["timed_shapes"] = {"bitmap_filter": bf, "group_match": gm,
                              "pair_count": pc}
    report["checked_shapes"] = {"bitmap_filter": bf_cases,
                                "group_match": gm_cases,
                                "pair_count": pc_cases}
    report["phase_s"] = phase_s
    report["total_s"] = time.perf_counter() - t_start
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=2) + "\n")

    print(f"kernels by path: {json.dumps(paths)}; 13a host query_batch: "
          f"{json.dumps(host_launches)}; 14 LM serving: "
          f"{json.dumps(lm_launches)}; 15 LM families: "
          f"{json.dumps(fam_launches)}")
    print(f"total {report['total_s']:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
