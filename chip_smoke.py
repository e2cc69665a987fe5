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
               14b ``DecodeServer(batch_slots=4, max_seq=512)`` on 6
                   seeded requests (prompts log-uniform in 8-64,
                   ``max_new`` 8-32), half constrained by three masks (an
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
               15a 4 seeded prompts of 64 tokens (whisper also (4, 1500,
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
               15b ``DecodeServer(batch_slots=4, max_seq=64)`` on 2 seeded
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
 16. LM training — the port's ``train`` package on the card (tuning knobs
               at JAX's defaults: ``remat="full"``, ``xent_chunk`` 256;
               batches ``SyntheticLMData(vocab, 4, 512)``, AdamW
               ``lr=3e-4, warmup_steps=2, total_steps=100``):
               16a qwen3-1.7b unreduced (fp32 weights from seed 0, bf16
                   activations, fp32 AdamW state): the first step's loss
                   and gradients against a float32 step (TF32 off) on the
                   same weights and batch, loss within 1% relative, the
                   global gradient norm within 5%, every parameter's
                   gradient cosine at least 0.99; one float32 step at
                   ``microbatch`` 2 against 1 (its m within 1e-4
                   relative); then 8 steps: every loss finite and the mean
                   of the last two below the first; params, m and v bytes
                   and the peak memory;
               16b ``train.loop.train`` at ``smoke_config(qwen3-1.7b)``: 6
                   steps straight against 3, a checkpoint (the JAX
                   package's layout, under ``build/``) and a resume to 6,
                   losses within 1e-6 relative;
               16c 16a's step time (CUDA events, median of 5 after 2
                   warm-ups) beside its bound (6 N per token plus causal
                   attention at the dense bf16 peak, plus AdamW's 28 bytes
                   a parameter at the memory rate), tokens/s, and one
                   profiled step: device calls, busy share, top device ops;
               16d whisper-base (with frames), xlstm-350m and zamba2-2.7b
                   unreduced, deepseek-moe-16b at its widths with its dense
                   block and the most MoE blocks whose 16 bytes a parameter
                   fit 60 GB, in that order, each freed before the next: a
                   first step against float32 (whisper held as 16a; the
                   others' loss held end to end, their end-to-end cosines
                   reported, and each block's backward held: fed the
                   float32 stream and cotangent, every parameter's
                   gradient cosine at least 0.9 and the input cotangent
                   within 25% relative L2), then 3
                   steps with finite losses; zamba2 at 32 positions and
                   xlstm at 64 (the reference's Mamba2 and mLSTM gradients
                   are NaN past them, ``TRAIN_SSD_SEQ``); the three
                   kernels' launches, 0, print apart.
 17. LM serving over a mesh — four logical shards on the card
               (``make_local_mesh(devices=["cuda:0"] * 4)`` and a (2, 2)
               ``(data, model)`` mesh), through ``build_serve_decode`` /
               ``build_serve_prefill`` and the ``flash_decode`` knob, fp32
               weights from seed 0 and bf16 activations:
               17a qwen3-1.7b unreduced, B 4 from a seeded random 512-row
                   cache: layer 0's flash route against the dense one and
                   float32 at positions 127, 128, 255, 256 and 511 with no
                   window and a 256 window (caches bit-identical, output
                   within ``MESH_ATTN_TOL``); whole decode steps at those
                   positions against the unsharded step and float32
                   (logits within ``LM_TOL``; the cache's untouched rows
                   and layer 0's written row bit-identical, the other
                   written rows within ``LM_TOL``); a decode step's time
                   sharded and unsharded, in turns (the shard loop's
                   overhead, no gain claimed);
               17b deepseek-moe-16b at its widths, 4 of its 28 layers (1
                   dense, 3 MoE), on (1, 4) and (2, 2): a B 4 decode step
                   (the expert-parallel MoE and flash decode; no pair
                   drops) against the single-device step, and a B 4 x S
                   512 prefill in bf16 against float32 on the same mesh,
                   every position, within ``LM_TOL`` (tokens whose applied
                   experts differ left out only if some row fails, as
                   15a), each route's dropped pairs printed; the three
                   kernels' launches, 0, print apart.
 18. LM training over a mesh — logical shards on the card, through
               ``build_train_step(mesh=, fsdp=, microbatch=)``,
               ``train(mesh=)``, ``restore(shardings=)`` and
               ``elastic.remesh``, fp32 weights from seed 0 and bf16
               activations:
               18a qwen3-1.7b unreduced, B 4 x S 512: one step over (2,
                   2) at microbatch 2, FSDP off and on, against the
                   single-device step (loss, grad norm and every updated
                   parameter within what two single-device steps differ
                   by, at least 1e-6 relative), and FSDP on against off;
               18b deepseek-moe-16b at its widths, 4 of its 28 layers, B 4
                   x S 512, on (1, 4) and (2, 2): a bf16 first step's loss
                   against float32 on the same mesh (1%), each bf16
                   block's backward fed the float32 stream and cotangent
                   (as 16d), each float32 MoE layer's backward through the
                   sharded stages against the single-device dispatch on
                   each shard's token slice (applied experts equal; input
                   cotangent and router, expert and shared-expert weight
                   gradients within ``MESH_MOE_LOCAL_TOL``); then the step
                   over (2, 2) beside the single-device step (CUDA events
                   in turns), launches a step, peak memory; the
                   sharded stages run 2 times a MoE layer a step, and
                   the first sharded loss is (i)'s within 1e-4;
               18c elastic resume at the smoke configs (dense and MoE): 3
                   steps over (2, 2) through ``train``, a checkpoint,
                   ``remesh`` onto (1, 4) (state restored bit for bit), 3
                   more, against the run kept in memory (dense
                   bit-identical, MoE within 1e-6 relative);
               18d the four ``examples/*_torch.py`` at their default sizes
                   (``serve_search_torch`` in its plain mode, on the
                   card, ``train_lm_torch --steps 40``), timed, each reaching its own check; the
                   launches of ``quickstart_torch`` and
                   ``serve_search_torch`` join the kernel table's paths.
 19. the dry run against the card — ``launch/dryrun.py`` traces a step on
               the meta device under ``launch/op_analysis.py``'s recorder,
               then the card runs the same step under it:
               19a qwen3-1.7b unreduced, the train step of 16c (B 4 x S
                   512, int32 batch) on a (1, 1) mesh: the card's flops
                   equal the trace's exactly, its ops by name are listed
                   where they differ, the argument bytes equal the real
                   parameters', optimizer state's and batch's, and the
                   predicted peak (arguments plus the traced peak) is
                   within ``DRYRUN_PEAK_TOL`` of
                   ``torch.cuda.max_memory_allocated``; the roofline terms
                   (flops at the bf16 peak, bytes at the memory rate)
                   print beside 16c's measured step and its bound;
               19b deepseek-moe-16b cut to 4 layers (as 18b) on (2, 2), the
                   same: the recorded collectives equal the trace's by
                   type, in count and bytes, and the peak is held;
               19c the op log of phase 4's modal bucket
                   (``core/engine.py::bucket_op_log``), taken while phase
                   4's index lives (after phase 13): its kernel entries
                   equal the launch counters' increments (1
                   ``bitmap_filter`` and k - 1 ``group_match`` a pass, an
                   overflow re-run's launches apart), its answers the
                   oracle's; its bytes at the memory rate beside the
                   pass's measured time;
               19d ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b
                   --shape train_4k`` as a subprocess (started after phase
                   1, so its CPU-bound trace overlaps the phases between;
                   waited here): status ``ok``, its seconds.
 21. compact_rows — run after phase 3: the single-device pass's answer
               compaction against its plain version on the card, bit for
               bit (offsets and every value up to the last offset), at
               the benchmark cells' pass shapes (``COMPACT_SHAPES``) and
               on edge cases (every value -1, none, one row, overflow
               rows left out, no row taken, a single row past a tile,
               odd widths and a misaligned buffer for the scalar loads);
               at each cell's shape the kernel's time (CUDA events)
               beside its bytes at the memory rate, the plain version's
               time, and the host clock of the pageable copy of the
               whole buffer against that of the answers alone.

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
and ``12e traced suggest_batch``, ``18d quickstart_torch`` and ``18d
serve_search_torch``, ``19c bucket_op_log``; 13a's, 14's-17's and 18a-18c's counts, 0 for every
kernel, print apart.  The
last lines are the kernel table as JSON (each kernel's ``launches`` on
its main path, phase 4 or 7, and ``launches_by_path``) and ``{"ok": true,
"device": {...}}``.  ``--report``
writes a fuller JSON report (every count, time and profile row) to PATH.
"""
from __future__ import annotations

import argparse
import atexit
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
# 14b, 15a and 15b are cut to keep the script well inside its time limit
# on a slow host (the run that added phase 16 took 1082.6 s, 14b 153 s and
# 15 304 s of it; the one that added phase 17 794.6 s, 14b 83.7 s): 6
# requests here (was 16, then 8), still more than the slots, with prompts
# of 8-64 (was 8-128) and max_new 8-32 (was 16-64); 2 in 15b (was 8,
# then 4: phase 18 adds about 50 s to a script that took 742-795 s), 64
# positions in 15a (was 128)
LM_REQUESTS = 6                      # half of them constrained
LM_PROMPT_RANGE = (8, 64)            # log-uniform prompt lengths
LM_MAX_NEW_RANGE = (8, 32)           # uniform max_new
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
FAM_PROMPTS, FAM_PROMPT_LEN = 4, 64      # 15a: seeded prompts, every position
FAM_REQUESTS = 4                         # 15b: half of them constrained,
FAM_PROMPT_RANGE = (4, 16)               # one to a slot; log-uniform prompt
FAM_MAX_NEW_RANGE = (4, 8)               # lengths, uniform max_new
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

# -- LM training (phase 16) ----------------------------------------------------
TRAIN_ARCH = LM_ARCH                 # 16a, 16c: qwen3-1.7b unreduced
TRAIN_BATCH, TRAIN_SEQ = 4, 512      # SyntheticLMData(vocab, 4, 512)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
TRAIN_STEPS = 8                      # 16a: the stream must be learned
TRAIN_WARMUP, TRAIN_TIMED = 2, 5     # 16c: median of steps 3-7 (CUDA events)
# 16a/16d: a bf16 first step against a float32 one (TF32 off), same
# weights and batch.  The loss is a mean over 2048 tokens of a float32
# cross entropy of bf16 logits: bf16 rounds at 2^-9 and depth compounds it
# in the hidden states (phase 14: 2.2% row error of the logits at 28
# layers), but a mean of 2048 rows averages row errors of either sign, so
# 1% is a loose bound.  A gradient sums B*S products of two such streams
# (forward and backward): 5% on the global norm, and each parameter's
# gradient direction within 8 degrees (cosine 0.99).  CPU rehearsals at
# the smoke configs (2 and 8 layers): see PERF.md section 6.
TRAIN_LOSS_TOL = 0.01
TRAIN_GNORM_TOL = 0.05
TRAIN_COSINE = 0.99
TRAIN_MICRO_TOL = 1e-4               # microbatch 2 vs 1, float32: sum orders
TRAIN_RESUME = (3, 6)                # 16b: 3 steps + resume to 6 vs 6 straight
TRAIN_RESUME_TOL = 1e-6              # relative, per loss
TRAIN_FAM_STEPS = 3                  # 16d: steps after the held first one
# 16d: grads held end to end as 16a; the others' loss end to end and their
# gradients block by block (``grad_blocks``): random-init depth amplifies
# bf16 rounding in their backward in the JAX package as well
# (``tools/lm_drift.py --grads``; PERF.md section 6)
TRAIN_FAM_HELD = ("whisper-base",)
# 16d block by block: each bf16 block's backward, fed the float32 stream
# and cotangent, against the float32 block's.  On the CPU at full depth
# (tools/grad_drift.py; PERF.md section 6) the JAX package's bf16 blocks
# reach a parameter-gradient cosine of 0.978 (an mLSTM's gate weights
# w_if, the same in the port to four digits: their gradient sums B*S
# terms that nearly cancel, from gate pre-activations rounded to bf16 in
# both packages) and an input cotangent error of 0.125 (a zamba2 Mamba2
# block at widths / 4; the port 0.117), and the port's blocks track JAX's
# block for block.  The bounds leave 4.5x on 1 - cosine and 2x on the
# error for other draws; a wrong backward (a dropped term, a sign, a
# detached path) misses both by far more.
TRAIN_BLOCK_COSINE = 0.9
TRAIN_BLOCK_DX = 0.25
# 16d: the reference's chunked Mamba2 and mLSTM backward is NaN once a
# chunk spans enough positions (``where(causal, exp(delta), 0)``: exp
# overflows above the diagonal and its gradient there is 0 * inf; ROADMAP
# queue 3): from 128 at the smoke configs, from 64 at zamba2-2.7b's full
# width on the card (finite at 32).  The port keeps the reference's
# semantics, so zamba2 trains at 32 positions and xlstm at 64
TRAIN_SSD_SEQ = {"ssm_hybrid": 32, "xlstm": 64}
TRAIN_MOE_BYTES = 60e9               # 16d: deepseek's 16 bytes a parameter

# -- LM serving over a mesh (phase 17) -----------------------------------------
MESH_SHARDS = 4                      # logical shards, all on the one card
MESH_LM_BATCH, MESH_LM_DEPTH = 4, 512    # 17a: qwen3-1.7b, 128 rows a shard
MESH_LM_POSITIONS = (127, 128, 255, 256, 511)   # both sides of each boundary
MESH_LM_WINDOW = 256                 # 17a: a window passed to attention_decode
# 17b: deepseek-moe-16b at its widths cut to its dense block and 3 MoE
# blocks: 28 layers are 64.7 GB of fp32 weights, and phase 17 runs every
# step in bf16 and float32 on two meshes within its 90 s; 4 layers take
# every path (dense block, shared experts, expert parallelism) at full width
MESH_MOE_LAYERS = 4
MESH_MOE_SHAPES = ((1, 4), (2, 2))
MESH_MOE_DEPTH = 64                  # 17b: decode at B 4 from a 64-row cache
MESH_MOE_PREFILL = 512               # 17b: B 4 x S 512, t_loc * k = 3072 > 512
MESH_TIME_ITERS = 5
# 17b, a MoE layer's float32 output (TF32 off), sharded against the
# single-device dispatch on each shard's token slice: the same pairs, summed
# in another order (other product shapes, index_add_'s atomics), a few
# float32 units (2^-23) of a row; a wrong slot, expert, weight or a lost
# pair moves one of the k = 6 expert outputs, some tenths of the row
MESH_MOE_LOCAL_TOL = 1e-4
# 17a, one attention layer on one bf16 input: the flash route against the
# dense one, and against the float32 dense one.  The two bf16 routes
# differ only in where they round (flash rounds the scaled query, the
# exponentials and the numerator to bf16): a few units of bf16 rounding
# (2^-8 each) of the output row's norm; 0.02 is five units.  A wrong
# combine (a missing exp(mx_l - mx_g), a shard written twice, a row
# masked wrongly) moves whole softmax weights, far past it.  The logits
# of whole decode steps are held to LM_TOL, as phase 14 holds decode
# against prefill: two bf16 evaluations of one function.
MESH_ATTN_TOL = 0.02

# -- LM training over a mesh (phase 18) ----------------------------------------
# 18a: qwen3-1.7b unreduced, one bf16 step at microbatch 2 over (2, 2),
# FSDP off and on, against the single-device step.  A dense model has no
# sharded stage on one process, so the bound is what two runs of the
# single-device step differ by (index_add_'s atomics and the order of a
# threaded sum may differ between runs), at least MESH_TRAIN_FLOOR
# (relative): then it also holds when they agree exactly
MESH_TRAIN_SHAPE = (2, 2)
MESH_TRAIN_MICRO = 2
MESH_TRAIN_FLOOR = 1e-6
# 18b: deepseek at MESH_MOE_LAYERS layers on MESH_MOE_SHAPES; (iii) times
# the sharded step on MESH_TRAIN_TIMED against the single-device one, and
# holds its first loss to (i)'s bf16 loss on the same weights and batch
# (relative; the combine stage's bf16 index_add_ adds in no fixed order)
MESH_TRAIN_TIMED = (2, 2)
MESH_STEP_LOSS_TOL = 1e-4
# 18c: 3 steps on the first mesh, a checkpoint, remesh onto the second, 3
# more (TRAIN_RESUME), against the run kept in memory
MESH_TRAIN_RESUME = ((2, 2), (1, 4))
# 18d: the examples' twins at their default sizes (train_lm_torch at 40
# steps); serve_search_torch's plain mode serves through the device
# engine, so its passes launch the kernels
EXAMPLE_TRAIN_STEPS = 40

# -- the dry run against the card (phase 19) ------------------------------------
# 19a/19b: the predicted peak (argument bytes plus the meta trace's peak of
# what the step allocates) against torch.cuda.max_memory_allocated, as a
# share of the card's.  The trace counts each storage's exact bytes where
# the caching allocator rounds each block up (to 512 bytes; large blocks
# to 2 MiB segments, not counted as allocated), and the card may hold a
# workspace the trace does not see; a wrong lifetime (a saved tensor
# missed, a freed one still counted) moves gigabytes of a 30-40 GB step
DRYRUN_PEAK_TOL = 0.15
DRYRUN_MOE_MESH = (2, 2)
DRYRUN_CELL = ("qwen3-1.7b", "train_4k")     # 19d, at full width
DRYRUN_CELL_TIMEOUT = 900

# -- the seq_shard_mlp knob over a mesh (phase 20) -----------------------------
SEQ_SHARD_MESH = (1, 4)              # 20a: qwen3-1.7b, (4, 128, 2048) blocks
SEQ_SHARD_MOE_MESH = (2, 2)          # 20b: deepseek at MESH_MOE_LAYERS layers
SEQ_SHARD_TRAIN_MESH = (2, 2)        # 20c: qwen3 at MESH_TRAIN_MICRO
SEQ_SHARD_WARMUP, SEQ_SHARD_TIMED = 2, 5     # 20a: prefills in turns

# -- compact_rows (phase 21) -------------------------------------------------
# (B, capacity, g_0) of a first pass in each benchmark cell, and the share
# of its values that are answers: paper10m-batch's 32 queries over 10M
# sets at G = 2^20 (capacity G / 4, r = 100k-150k of 8.4M slots a row), and
# a 128-query bucket of skewed-batch at an assumed t_k of 16 (the cell's
# copies moved about 230 times the answer's bytes)
COMPACT_SHAPES = {"paper10m-batch": ((32, 1 << 18, 32), 0.014),
                  "skewed-batch": ((128, 1 << 14, 32), 0.0045)}

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
    gathers stack, and the packed (B, capacity, g_0) buffer that
    ``compact_rows`` reads."""
    caps = {}
    for plan, res in zip(map(engine.plan, log), results):
        if plan.algorithm == "device":
            caps.setdefault(plan.sig, []).append(res.stats["capacity"])
    out = {"aligned_images": 0, "gathered_rows": 0, "packed_rows": 0}
    for sig, got in caps.items():
        G = 1 << sig.ts[-1]
        passes = [(len(got), sig.capacity_tier)]
        reruns = sum(c != sig.capacity_tier for c in got)
        if reruns:
            passes.append((reruns, G))
        for B, cap in passes:
            out["aligned_images"] += B * sig.k * G * M_IMAGES * (W_BITS // 32) * 4
            out["gathered_rows"] += B * cap * sum(sig.gmaxes) * 4
            out["packed_rows"] += B * cap * sig.gmaxes[0] * 4
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

        def to_host(tensors, ready, times, **kw):
            caller = sys._getframe(1).f_code.co_qualname
            arrays = self._to_host(tensors, ready, times, **kw)
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
        "expr_bytes_to_host": copied, "flat_bytes_to_host": flat_bytes,
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


def held_err(errs, agree, what: str, hold: bool = True,
             phase: str = "15a") -> dict:
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
            f"{phase}: {what} {out['err']} > {LM_TOL} ({out['held']})")
    return out


def joined_route(routes):
    """One ``moe.Route`` of ``routes`` (a layer's, one a shard in token
    order), their tokens joined."""
    import torch

    if len(routes) == 1:
        return routes[0]
    return type(routes[0])(*(torch.cat(f) for f in zip(*routes)))


class BlockHold:
    """15a block by block: each bfloat16 block, fed the float32 stream's
    input to it rounded to bfloat16, against the float32 block: the
    largest row (token) relative L2 error of the stream after the block,
    held to ``LM_TOL``.  In a MoE block, a token whose top-k set differs
    must be a near-tie (the gap between its float32 k-th and (k+1)-th
    log-probabilities within ``FAM_NEAR_TIE``), and rows whose applied
    experts differ are left out only if some row fails; flips are
    counted.  A block's routes may be several (one a shard on a mesh, in
    token order): they are joined."""

    def __init__(self, what: str, phase: str = "15a"):
        self.what, self.phase = what, phase
        self.out = {"blocks": 0, "err": 0.0, "worst_block": -1,
                    "route_flips": 0, "moe_blocks": 0, "held": "all rows",
                    "errs": [], "blocks_held_on_agreeing_rows": 0,
                    "err_rows_agree": 0.0, "err_rows_differ": 0.0,
                    "rows_differ": 0, "pairs": 0, "flip_gap": 0.0}

    def add(self, i: int, y16, y32, r16, r32) -> None:
        out, agree = self.out, None
        errs = lm_row_errs(y16, y32)
        if r32:                          # a MoE block
            a16, a32 = joined_route(r16), joined_route(r32)
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
                        f"{self.phase}: {self.what} block {i}: a route "
                        f"flip with a log-gap {gap} > {FAM_NEAR_TIE}, no "
                        f"near-tie")
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
        r = held_err(errs, agree, f"{self.what} block {i}",
                     phase=self.phase)
        out["errs"].append(r["err"])
        if r["held"] != "all rows":
            out["blocks_held_on_agreeing_rows"] += 1
        if r["err"] > out["err"]:
            out["err"], out["worst_block"], out["held"] = r["err"], i, r["held"]
        out["blocks"] += 1


def check_prefill_blocks(torch, model, model32, params, tokens, log,
                         phase: str = "15a") -> dict:
    """``BlockHold`` over the prefill's blocks (``Model.blocks``); the MoE
    blocks return (stream, aux)."""
    from repro_torch.models import transformer

    kw = {"routes": log} if model.cfg.family == "moe" else {}
    hold, log16 = BlockHold("prefill", phase), []
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


# -- phase 16: LM training -----------------------------------------------------

def train_seq(cfg) -> int:
    return TRAIN_SSD_SEQ.get(cfg.family, TRAIN_SEQ)


def train_batch(torch, cfg, step: int, device) -> dict:
    """``SyntheticLMData(cfg.vocab, TRAIN_BATCH, train_seq(cfg))
    .batch_at(step)`` on ``device`` (and for the encoder-decoder family
    seeded frames)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.loop import to_device

    data = SyntheticLMData(cfg.vocab, TRAIN_BATCH, train_seq(cfg), seed=SEED)
    batch = to_device(data.batch_at(step), device)
    if cfg.family == "encdec":
        rng = np.random.default_rng(SEED + 16 + step)
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (TRAIN_BATCH, cfg.encoder_seq, cfg.frontend_dim)).astype(
                np.float32)).to(device)
    return batch


def hold_first_step(torch, model, params, batch, grads_held: bool) -> dict:
    """The bf16 model's loss and gradients on ``batch`` against a float32
    model's (TF32 off) on the same weights: the loss within
    ``TRAIN_LOSS_TOL`` (relative), and with ``grads_held`` the global
    gradient norm within ``TRAIN_GNORM_TOL`` and every parameter's
    gradient cosine at least ``TRAIN_COSINE`` (reported either way)."""
    import dataclasses

    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.step import value_and_grad

    cfg = model.cfg
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                          device=model.device)
    loss, grads = value_and_grad(model, params, batch)
    with no_tf32(torch):
        loss32, grads32 = value_and_grad(model32, params, batch)
    cos = {n: float(torch.sum(g.float() * grads32[n])
                    / (g.float().norm() * grads32[n].norm()).clamp_min(1e-30))
           for n, g in grads.items()}
    worst = min(cos, key=cos.get)
    gn, gn32 = float(global_norm(grads)), float(global_norm(grads32))
    out = {"loss": float(loss), "loss_f32": float(loss32),
           "loss_err": abs(float(loss) - float(loss32)) / abs(float(loss32)),
           "grad_norm": gn, "grad_norm_f32": gn32,
           "grad_norm_err": abs(gn - gn32) / gn32,
           "min_cosine": cos[worst], "min_cosine_param": worst,
           "params_below_cosine": sum(c < TRAIN_COSINE for c in cos.values()),
           "grads_held": grads_held}
    del grads, grads32
    what = f"16 {cfg.name}: bf16 first step vs float32"
    require(math.isfinite(out["loss"]) and math.isfinite(gn),
            f"{what}: loss or gradient not finite")
    require(out["loss_err"] <= TRAIN_LOSS_TOL,
            f"{what}: loss {out['loss']} vs {out['loss_f32']}, relative "
            f"error {out['loss_err']} > {TRAIN_LOSS_TOL}")
    if grads_held:
        require(out["grad_norm_err"] <= TRAIN_GNORM_TOL,
                f"{what}: grad norm {gn} vs {gn32} > {TRAIN_GNORM_TOL}")
        require(out["min_cosine"] >= TRAIN_COSINE,
                f"{what}: gradient cosine of {worst} {out['min_cosine']} < "
                f"{TRAIN_COSINE}")
    return out


def grad_blocks(torch, model, model32, params, batch) -> dict:
    """16d block by block, backward: the float32 model's loss on
    ``batch`` is taken apart at each block's input (``Model.blocks``);
    from the last block down, each bfloat16 block is fed the float32
    stream's input to it (rounded to bfloat16) and the float32 backward's
    cotangent of its output (rounded likewise; a MoE block's aux loss gets
    its float32 weight), and its gradients are held against the float32
    block's on the same input and cotangent: every parameter's gradient
    cosine at least ``TRAIN_BLOCK_COSINE`` and the input cotangent's
    relative L2 error at most ``TRAIN_BLOCK_DX``, as 15a holds each block's
    forward.  Runs with TF32 off and returns the worst of each."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import chunked_xent, rmsnorm

    cfg32, dt = model32.cfg, model.cfg.activation_dtype
    tokens = batch["tokens"]
    named = list(params.named_parameters())
    ps = [p for _, p in named]
    aux_ct = 0.01 / max(1, cfg32.n_layers) if cfg32.family == "moe" else None
    out = {"blocks": 0, "min_cosine": 1.0, "min_cosine_at": None,
           "dx_err": 0.0, "dx_err_block": -1, "params_held": 0}
    for p in ps:
        p.requires_grad_(True)
    try:
        with no_tf32(torch), torch.enable_grad():
            x = transformer._embed(params, cfg32, tokens).detach()
            ins, outs = [], []
            for b32 in model32.blocks(params, tokens):
                ins.append(x.requires_grad_(True))
                outs.append(b32(x))
                x = (outs[-1][0] if aux_ct else outs[-1]).detach()
            x.requires_grad_(True)
            head = chunked_xent(rmsnorm(params.ln_f, x), params.embed,
                                batch["labels"])
            dy = torch.autograd.grad(head, x)[0]
            del head
            blocks16 = model.blocks(params, tokens)

            def vjp(y, x_in, ct):
                """(d x_in, d every parameter) of ``y``'s stream under
                cotangent ``ct`` (and of a MoE block's aux loss)."""
                ys, cts = ([y[0]], [ct]) if aux_ct else ([y], [ct])
                if aux_ct and y[1].requires_grad:
                    ys.append(y[1])
                    cts.append(torch.full_like(y[1], aux_ct))
                return torch.autograd.grad(ys, [x_in] + ps, cts,
                                           allow_unused=True)

            for i in reversed(range(len(ins))):
                g32 = vjp(outs[i], ins[i], dy)
                outs[i] = None
                x16 = ins[i].detach().to(dt).requires_grad_(True)
                g16 = vjp(blocks16[i](x16), x16, dy.to(dt))
                err = float((g16[0].float() - g32[0]).norm()
                            / g32[0].norm().clamp_min(1e-30))
                if err > out["dx_err"]:
                    out["dx_err"], out["dx_err_block"] = err, i
                require(err <= TRAIN_BLOCK_DX,
                        f"16d {cfg32.name} block {i}: input cotangent "
                        f"error {err} > {TRAIN_BLOCK_DX}")
                for (n, _), a, b in zip(named, g16[1:], g32[1:]):
                    if b is None:
                        continue
                    cos = float(torch.sum(a.float() * b) / (
                        a.float().norm() * b.norm()).clamp_min(1e-30))
                    out["params_held"] += 1
                    if cos < out["min_cosine"]:
                        out["min_cosine"] = cos
                        out["min_cosine_at"] = f"block {i} {n}"
                    require(cos >= TRAIN_BLOCK_COSINE,
                            f"16d {cfg32.name} block {i}: gradient cosine "
                            f"of {n} {cos} < {TRAIN_BLOCK_COSINE}")
                dy = g32[0]
                out["blocks"] += 1
    finally:
        for p in ps:
            p.requires_grad_(False)
    return out


def timed_steps(torch, step_fn, params, state, cfg, steps, device):
    """``step_fn`` on ``steps``' batches, each timed with CUDA events and
    ended by the loss's ``.item()``; returns (params, state, losses, ms)."""
    losses, ms = [], []
    for i in steps:
        batch = train_batch(torch, cfg, i, device)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = step_fn(params, state, batch)
        end.record()
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return params, state, losses, ms


def train_bound_ms(cfg, n_params: int) -> dict:
    """16c's bound: the step's products (6 N per token, plus causal
    attention's score and value products, forward and backward) at the
    dense bf16 peak, plus AdamW's bytes (p, g, m, v read and p, m, v
    written, float32) at the memory rate."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = 3 * 2 * TRAIN_BATCH * TRAIN_SEQ ** 2 * cfg.n_heads * cfg.hd \
        * cfg.n_layers
    flops = 6 * n_params * tokens + attn
    adamw_bytes = 7 * 4 * n_params
    return {"flops": flops, "adamw_bytes": adamw_bytes,
            "compute_ms": flops / BF16_OPS_PER_S * 1e3,
            "adamw_ms": adamw_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms": (flops / BF16_OPS_PER_S
                         + adamw_bytes / HBM_BYTES_PER_S) * 1e3}


def micro_hold(torch, model, params, batch) -> float:
    """One float32 train step at ``microbatch`` 1 and 2 (lr 0, no decay,
    no clip: m after it is (1 - b1) g): the largest relative L2 error of a
    parameter's m."""
    import dataclasses

    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step

    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"),
                          device=model.device)
    opt = adamw.AdamWConfig(lr=0.0, weight_decay=0.0, grad_clip=0.0)
    ms = []
    with no_tf32(torch):
        for micro in (1, 2):
            fn, _, _ = build_train_step(model32, opt_cfg=opt,
                                        microbatch=micro)
            _, state, _ = fn(params, adamw.init(opt, params), batch)
            ms.append(state.m)
            del state
    return max(float((ms[1][n] - m).norm() / m.norm().clamp_min(1e-30))
               for n, m in ms[0].items())


def run_training_16a(torch, report) -> dict:
    """16a and 16c on ``TRAIN_ARCH`` unreduced."""
    import gc

    from repro_torch import tuning
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step

    cfg = get_config(TRAIN_ARCH)
    out = report["16a"] = {"arch": cfg.name, "layers": cfg.n_layers,
                           "remat": tuning.get("remat"),
                           "xent_chunk": tuning.get("xent_chunk")}
    require((out["remat"], out["xent_chunk"]) == ("full", 256),
            f"16a: knobs {out['remat']}, {out['xent_chunk']}")
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(SEED)
    params = model.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    batch = train_batch(torch, cfg, 0, model.device)
    torch.cuda.reset_peak_memory_stats()
    out["hold"] = hold_first_step(torch, model, params, batch, True)
    out["micro_err"] = micro_hold(torch, model, params, batch)
    require(out["micro_err"] <= TRAIN_MICRO_TOL,
            f"16a: microbatch 2 vs 1 m error {out['micro_err']} > "
            f"{TRAIN_MICRO_TOL}")
    gc.collect()
    torch.cuda.empty_cache()
    h = out["hold"]
    print(f"phase 16a {cfg.name}: {cfg.n_layers} layers, {n_params} "
          f"parameters, fp32 weights, {cfg.dtype} activations, remat "
          f"{out['remat']}, xent_chunk {out['xent_chunk']}, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}; first step bf16 vs float32 (TF32 "
          f"off): loss {h['loss']:.6f} vs {h['loss_f32']:.6f} (relative "
          f"{h['loss_err']:.2e}, tolerance {TRAIN_LOSS_TOL}), grad norm "
          f"{h['grad_norm']:.5f} vs {h['grad_norm_f32']:.5f} (relative "
          f"{h['grad_norm_err']:.2e}, tolerance {TRAIN_GNORM_TOL}), least "
          f"gradient cosine {h['min_cosine']:.5f} ({h['min_cosine_param']}, "
          f"bound {TRAIN_COSINE}); microbatch 2 vs 1 (float32) m relative "
          f"error {out['micro_err']:.2e} (tolerance {TRAIN_MICRO_TOL})")

    torch.cuda.reset_peak_memory_stats()
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    step_fn, _, _ = build_train_step(model, opt_cfg=opt)
    state = adamw.init(opt, params)
    params, state, losses, ms = timed_steps(
        torch, step_fn, params, state, cfg, range(TRAIN_STEPS), model.device)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["state_bytes"] = sum(t.numel() * t.element_size() for t in
                             list(params.parameters())
                             + list(state.m.values()) + list(state.v.values()))
    out["losses"], out["step_ms"] = losses, ms
    require(all(math.isfinite(x) for x in losses), f"16a: losses {losses}")
    require(np.mean(losses[-2:]) < losses[0],
            f"16a: the last two losses {losses[-2:]} do not fall below the "
            f"first {losses[0]}")
    print(f"phase 16a {cfg.name}: {TRAIN_STEPS} AdamW steps "
          f"({TRAIN_OPT}), losses {[round(x, 4) for x in losses]}; params, "
          f"m and v {out['state_bytes']} bytes; peak device memory "
          f"{out['peak_bytes']} bytes; {time.perf_counter() - t0:.1f} s")

    # 16c: step time beside its bound, one profiled step
    timed = sorted(ms[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED])
    step_ms = timed[len(timed) // 2]
    bound = train_bound_ms(cfg, n_params)
    batch = train_batch(torch, cfg, TRAIN_STEPS, model.device)
    prof = profile_breakdown(torch, lambda: step_fn(params, state, batch),
                             groups=("nvjet", "bfloat16_copy", "elementwise"))
    busy = prof["device_busy_ms"] or 0.0
    c = out["16c"] = {
        "card": nvidia_smi(), "step_ms": step_ms, **bound,
        "bound_share": bound["bound_ms"] / step_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
        "device_calls": prof["device_calls"], "device_busy_ms": busy,
        "device_busy_share": busy / step_ms,
        "profiled_wall_s": prof["wall_s"], "top": prof["top"][:8],
        "kernel_ms": prof["kernel_ms"]}
    print(f"phase 16c {cfg.name} on {c['card']}: train step (B "
          f"{TRAIN_BATCH} x S {TRAIN_SEQ}, remat full) {step_ms:.2f} ms "
          f"(median of {TRAIN_TIMED} after {TRAIN_WARMUP} warm-ups; steps "
          f"{[round(x, 1) for x in ms]}) against a {bound['bound_ms']:.2f} ms "
          f"bound ({bound['flops'] / 1e12:.2f} TFLOP at the dense bf16 peak "
          f"{bound['compute_ms']:.2f} ms + AdamW's {bound['adamw_bytes']} "
          f"bytes {bound['adamw_ms']:.2f} ms; share {c['bound_share']:.3f});"
          f" {c['tokens_per_s']:.0f} tokens/s; profiled step: "
          f"{c['device_calls']} device calls, device busy {busy:.2f} ms "
          f"(share of the timed step {c['device_busy_share']:.3f}; the "
          f"profiled step's wall {prof['wall_s'] * 1e3:.2f} ms)")
    for row in prof["top"][:8]:
        print(f"  {row['ms']:10.3f} ms  {row['calls']:6d}x  {row['name'][:90]}")
    del params, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_training_16b(torch, report) -> dict:
    """16b: ``train.loop.train`` at ``smoke_config(TRAIN_ARCH)`` on the
    card, straight against checkpointed and resumed."""
    import shutil

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint, loop

    cfg = smoke_config(get_config(TRAIN_ARCH))
    model = build_model(cfg)
    data = SyntheticLMData(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    root = ROOT / "build" / "ckpt16b"
    shutil.rmtree(root, ignore_errors=True)
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    mid, end = TRAIN_RESUME
    quiet = dict(opt_cfg=opt, log_fn=lambda *_: None)

    def run(name, steps, every):
        return loop.train(model, data, loop.LoopConfig(
            steps=steps, ckpt_dir=str(root / name), ckpt_every=every,
            log_every=10 ** 6), **quiet)["history"]

    straight = run("straight", end, 10 ** 6)
    first = run("split", mid, mid)
    second = run("split", end, 10 ** 6)
    got = [h["loss"] for h in first + second]
    want = [h["loss"] for h in straight]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    require([h["step"] for h in second] == list(range(mid, end)),
            "16b: the resumed run did not start at the checkpoint")
    require(checkpoint.latest_step(str(root / "split")) == end,
            "16b: no final checkpoint")
    require(err <= TRAIN_RESUME_TOL,
            f"16b: resumed losses {got} vs straight {want}: {err}")
    ckpt_bytes = sum(f.stat().st_size for f in (root / "split").rglob("*")
                     if f.is_file())
    shutil.rmtree(root, ignore_errors=True)
    out = report["16b"] = {"arch": cfg.name, "losses": want,
                           "resumed_losses": got, "max_rel_err": err,
                           "exact": got == want, "ckpt_bytes": ckpt_bytes}
    print(f"phase 16b {cfg.name} (smoke config, {cfg.dtype}) through "
          f"train.loop.train: {end} steps straight against {mid} + "
          f"checkpoint + resume to {end}: largest relative loss difference "
          f"{err:.2e} (tolerance {TRAIN_RESUME_TOL}; bit-identical: "
          f"{out['exact']}); a checkpoint {ckpt_bytes} bytes on disk")
    return out


def moe_train_config(cfg):
    """deepseek at its widths with its dense first block(s) and the most
    MoE blocks whose parameters at 16 bytes each fit ``TRAIN_MOE_BYTES``."""
    import dataclasses

    n = cfg.first_dense_layers + 1
    while n < cfg.n_layers and 16 * dataclasses.replace(
            cfg, n_layers=n + 1).param_count() <= TRAIN_MOE_BYTES:
        n += 1
    return dataclasses.replace(cfg, n_layers=n)


def run_training_16d(torch, cfg, report) -> dict:
    """16d on one architecture: a held first step (outside
    ``TRAIN_FAM_HELD`` its loss end to end and its gradients block by
    block, ``grad_blocks``), then ``TRAIN_FAM_STEPS`` AdamW steps."""
    import dataclasses
    import gc

    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(SEED)
    params = model.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    batch = train_batch(torch, cfg, 0, model.device)
    hold = hold_first_step(torch, model, params, batch,
                           cfg.name in TRAIN_FAM_HELD)
    blocks = None
    if cfg.name not in TRAIN_FAM_HELD:
        blocks = grad_blocks(torch, model, build_model(dataclasses.replace(
            cfg, dtype="float32"), device=model.device), params, batch)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    step_fn, _, _ = build_train_step(model, opt_cfg=opt)
    state = adamw.init(opt, params)
    params, state, losses, ms = timed_steps(
        torch, step_fn, params, state, cfg, range(TRAIN_FAM_STEPS),
        model.device)
    require(all(math.isfinite(x) for x in losses),
            f"16d {cfg.name}: losses {losses}")
    out = {"layers": cfg.n_layers, "params": n_params, "hold": hold,
           "grad_blocks": blocks, "seq": train_seq(cfg),
           "losses": losses, "step_ms": ms,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "s": time.perf_counter() - t0}
    held = "loss, grad norm and cosines held" if hold["grads_held"] else \
        "loss held, gradients reported"
    print(f"phase 16d {cfg.name}: {cfg.n_layers} layers, {n_params} "
          f"parameters, batch {TRAIN_BATCH} x {train_seq(cfg)}; first step bf16 vs float32 ({held}): loss "
          f"{hold['loss']:.5f} vs {hold['loss_f32']:.5f} (relative "
          f"{hold['loss_err']:.2e}), grad norm relative "
          f"{hold['grad_norm_err']:.2e}, least cosine "
          f"{hold['min_cosine']:.5f} ({hold['min_cosine_param']}; "
          f"{hold['params_below_cosine']} below {TRAIN_COSINE}); "
          f"{TRAIN_FAM_STEPS} steps, losses {[round(x, 4) for x in losses]}, "
          f"ms {[round(x, 1) for x in ms]}; peak device memory "
          f"{out['peak_bytes']} bytes; {out['s']:.1f} s")
    if blocks:
        print(f"phase 16d {cfg.name}: each bf16 block's backward fed the "
              f"float32 stream and cotangent, {blocks['blocks']} blocks: "
              f"least gradient cosine {blocks['min_cosine']:.5f} "
              f"({blocks['min_cosine_at']}; bound {TRAIN_BLOCK_COSINE}, "
              f"{blocks['params_held']} gradients), largest input "
              f"cotangent error {blocks['dx_err']:.2e} (block "
              f"{blocks['dx_err_block']}; bound {TRAIN_BLOCK_DX})")
    del params, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_lm_training(torch, report) -> dict:
    """Phase 16: LM training through the port's ``train`` package on one
    card: 16a ``TRAIN_ARCH`` unreduced (a bf16 first step held against
    float32, ``TRAIN_STEPS`` AdamW steps that must lower the loss,
    microbatch 2 against 1), 16b checkpoint and resume at the smoke config,
    16c the step beside its bound with a profiled step, 16d the other
    families' first step and ``TRAIN_FAM_STEPS`` steps each (deepseek cut
    to ``moe_train_config``).  Returns the three kernels' launches over
    the phase (none is on this path)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda

    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda, "pair_count": count_block_cuda}
    for k in kernels.values():
        k.launches = 0
    out = report["lm_training"] = {"s": {}}
    t = time.perf_counter()
    run_training_16a(torch, out)
    out["s"]["16a+c"] = time.perf_counter() - t
    t = time.perf_counter()
    run_training_16b(torch, out)
    out["s"]["16b"] = time.perf_counter() - t
    fam = out["16d"] = {}
    for name in FAM_ARCHS:
        t = time.perf_counter()
        cfg = get_config(name)
        if cfg.family == "moe":
            cfg = moe_train_config(cfg)
            print(f"phase 16d {name}: {cfg.n_layers} of "
                  f"{get_config(name).n_layers} layers ({cfg.first_dense_layers}"
                  f" dense, {cfg.n_experts} experts, top "
                  f"{cfg.experts_per_token}): the most whose 16 bytes a "
                  f"parameter fit {TRAIN_MOE_BYTES:.0f} bytes")
        fam[name] = run_training_16d(torch, cfg, out)
        out["s"][f"16d {name}"] = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    require(sum(launches.values()) == 0,
            f"16: the set-intersection kernels launched {launches}")
    out["launches"] = launches
    return launches


# -- phase 17: LM serving over a mesh ------------------------------------------

@contextlib.contextmanager
def counted_calls(module, name: str):
    """Count the calls of ``module.name`` inside the block (a list that
    grows one entry a call): the sharded routes, to show a run took them."""
    real = getattr(module, name)
    calls = []

    def wrapped(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def recorded_moe_calls(moe):
    """17b: each ``moe._moe_ffn_shardmap`` call inside the block as (the
    layer's parameters, its config, its input, its output, its aux, the
    routes it appended)."""
    real = moe._moe_ffn_shardmap
    calls = []

    def wrapped(p, cfg, x, mesh, routes=None):
        n0 = len(routes)
        out, aux = real(p, cfg, x, mesh, routes)
        calls.append((p, cfg, x, out, aux, routes[n0:]))
        return out, aux
    moe._moe_ffn_shardmap = wrapped
    try:
        yield calls
    finally:
        moe._moe_ffn_shardmap = real


def moe_vs_local_slices(torch, moe, calls, t_loc: int) -> dict:
    """17b: each recorded sharded MoE call against the single-device
    dispatch (``_moe_ffn_local``) run on each ``t_loc``-token slice that a
    shard routes, in token order: the same capacity (``t_loc * k`` > 512,
    so both are ``capacity(cfg, t_loc)``) through none of the sharded
    stages or collectives.  The applied experts must be equal, each
    output row within ``MESH_MOE_LOCAL_TOL`` (relative L2) and the aux
    within it of the slices' mean.  Float32 with TF32 off."""
    err = aux_err = 0.0
    with no_tf32(torch), torch.no_grad():
        for i, (p, cfg, x, out, aux, routes) in enumerate(calls):
            d = x.shape[-1]
            xf = x.reshape(-1, d)
            require(xf.shape[0] == t_loc * len(routes),
                    f"17b: MoE layer {i}: {len(routes)} routes of {t_loc} "
                    f"tokens for {xf.shape[0]} tokens")
            outs, auxes = [], []
            for j, r_sh in enumerate(routes):
                r = []
                o, a = moe._moe_ffn_local(
                    p, cfg, xf[j * t_loc:(j + 1) * t_loc][None], r)
                require(torch.equal(r[0].applied, r_sh.applied),
                        f"17b: MoE layer {i} slice {j}: the sharded route's "
                        f"applied experts differ from the single-device "
                        f"dispatch's")
                outs.append(o[0])
                auxes.append(a)
            want = torch.cat(outs)
            err = max(err, float(lm_row_errs(out.reshape(-1, d), want).max()))
            a_want = torch.stack(auxes).mean()
            aux_err = max(aux_err, float((aux - a_want).abs() / a_want.abs()))
    require(err <= MESH_MOE_LOCAL_TOL and aux_err <= MESH_MOE_LOCAL_TOL,
            f"17b: sharded MoE vs single-device slices: output {err}, aux "
            f"{aux_err} > {MESH_MOE_LOCAL_TOL}")
    return {"layers": len(calls), "err": err, "aux_err": aux_err}


def random_cache(torch, cache_abs, gen, device) -> dict:
    """A cache of ``cache_abs``'s shapes and dtypes filled with N(0, 1)
    from ``gen``: the past positions a decode step attends to (K after its
    norm and RoPE, and V, are of unit scale)."""
    return {k: torch.randn(tuple(v.shape), generator=gen, device=device
                           ).to(v.dtype) for k, v in cache_abs.items()}


def cache_rows_held(torch, got, want, pos: int, what: str) -> float:
    """17a: a sharded decode step's cache against the unsharded one's: every
    row but ``pos`` untouched (bit-identical), layer 0's row ``pos``
    bit-identical (both write ``_qkv`` of the same input), and the other
    layers' row ``pos`` within ``LM_TOL``: their inputs are the residual
    streams of two bf16 evaluations of one function, which differ by the
    attention's rounding in every layer before.  Returns that largest row
    error."""
    err = 0.0
    for name in want:
        diff = (got[name] != want[name]).any(dim=(0, 1, 3, 4))
        rows = diff.nonzero().flatten().tolist()
        require(rows in ([], [pos]), f"{what}: cache {name} rows {rows} "
                f"changed, only {pos} may")
        require(torch.equal(got[name][0], want[name][0]),
                f"{what}: layer 0's cache {name} differs")
        n = got[name].shape[0]
        err = max(err, lm_row_err(got[name][:, :, pos].reshape(n, -1),
                                  want[name][:, :, pos].reshape(n, -1).float()))
    require(err <= LM_TOL, f"{what}: written cache rows {err} > {LM_TOL}")
    return err


def run_mesh_dense(torch, out) -> None:
    """17a: qwen3-1.7b unreduced over a (1, 4) mesh on the card, the
    ``flash_decode`` knob on (see ``run_mesh_serving``)."""
    import dataclasses
    import gc

    from repro_torch import tuning
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import attn_spec
    from repro_torch.parallel import ctx
    from repro_torch.train.step import build_serve_decode

    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    mesh = make_local_mesh(devices=[dev] * MESH_SHARDS)
    b = MESH_LM_BATCH
    decode, _, _, cache_abs = build_serve_decode(model, mesh, b,
                                                 MESH_LM_DEPTH)
    base = random_cache(torch, cache_abs, gen, dev)
    rng = np.random.default_rng(SEED + 17)

    # one attention layer, both windows, every position: flash vs dense
    attn, spec = params.layers[0].attn, attn_spec(cfg)
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device=dev).to(
        cfg.activation_dtype)
    layer = {"err": 0.0, "err_f32": 0.0, "cases": 0}
    for window in (None, MESH_LM_WINDOW):
        for pos in MESH_LM_POSITIONS:
            kd, vd = base["k"][0].clone(), base["v"][0].clone()
            dense, _, _ = layers.attention_decode(attn, spec, x, kd, vd, pos,
                                                  window=window)
            kf, vf = base["k"][0].clone(), base["v"][0].clone()
            with ctx.activation_mesh(mesh), \
                    tuning.overrides(flash_decode=True), \
                    counted_calls(layers, "_attention_decode_flash") as calls:
                flash, _, _ = layers.attention_decode(attn, spec, x, kf, vf,
                                                      pos, window=window)
            with no_tf32(torch):
                ref, _, _ = layers.attention_decode(
                    attn, spec, x.float(), base["k"][0].float(),
                    base["v"][0].float(), pos, window=window)
            what = f"17a layer 0 at {pos}, window {window}"
            require(len(calls) == 1, f"{what}: flash route not taken")
            require(torch.equal(kd, kf) and torch.equal(vd, vf),
                    f"{what}: caches differ from the dense route's")
            e = lm_row_err(flash.reshape(b, -1), dense.reshape(b, -1).float())
            e32 = lm_row_err(flash.reshape(b, -1), ref.reshape(b, -1))
            require(e <= MESH_ATTN_TOL and e32 <= MESH_ATTN_TOL,
                    f"{what}: against dense {e}, float32 {e32} > "
                    f"{MESH_ATTN_TOL}")
            layer["err"] = max(layer["err"], e)
            layer["err_f32"] = max(layer["err_f32"], e32)
            layer["cases"] += 1
    out["17a_layer"] = layer

    # whole decode steps at every position
    steps = []
    for pos in MESH_LM_POSITIONS:
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))).to(dev)
        cu = {k: v.clone() for k, v in base.items()}
        lu, cu = model.decode(params, cu, tok, pos)
        cs = {k: v.clone() for k, v in base.items()}
        with tuning.overrides(flash_decode=True), \
                counted_calls(layers, "_attention_decode_flash") as calls:
            ls, cs = decode(params, cs, tok, pos)
        require(len(calls) == cfg.n_layers,
                f"17a at {pos}: {len(calls)} flash layers of {cfg.n_layers}")
        with no_tf32(torch):
            l32, _ = model32.decode(params, {k: v.float() for k, v in
                                             base.items()}, tok, pos)
        row = {"pos": pos, "cache_row_err": cache_rows_held(
            torch, cs, cu, pos, f"17a at {pos}"),
            "vs_unsharded": lm_row_err(ls, lu.float()),
            "vs_f32": lm_row_err(ls, l32), "unsharded_vs_f32": lm_row_err(lu, l32)}
        require(torch.isfinite(ls).all() and ls.shape == (b, cfg.vocab),
                f"17a at {pos}: logits not finite or misshapen")
        require(max(row["vs_unsharded"], row["vs_f32"],
                    row["unsharded_vs_f32"]) <= LM_TOL,
                f"17a at {pos}: {row} past {LM_TOL}")
        steps.append(row)
        del cu, cs
    out["17a_steps"] = steps

    # a decode step's time, unsharded and sharded in turns
    tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    pos = MESH_LM_DEPTH - 1

    def unsharded():
        model.decode(params, base, tok, pos)

    def sharded():
        with tuning.overrides(flash_decode=True):
            decode(params, base, tok, pos)
    runs = {"unsharded": unsharded, "sharded": sharded}
    times = {"unsharded": [], "sharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        times[name].append(cuda_ms(torch, runs[name], iters=MESH_TIME_ITERS))
    out["17a_ms"] = times
    print(f"phase 17a {cfg.name} on a {mesh.devices.shape} mesh over "
          f"{dev} (flash_decode on), B {b}, cache {MESH_LM_DEPTH}: layer 0 "
          f"flash vs dense over {layer['cases']} cases (positions "
          f"{MESH_LM_POSITIONS}, window none and {MESH_LM_WINDOW}) caches "
          f"bit-identical, output {layer['err']:.2e} (float32 "
          f"{layer['err_f32']:.2e}; bound {MESH_ATTN_TOL}); decode steps: "
          + "; ".join(f"{r['pos']}: vs unsharded {r['vs_unsharded']:.4f}, "
                      f"vs float32 {r['vs_f32']:.4f} (unsharded "
                      f"{r['unsharded_vs_f32']:.4f}), written cache rows "
                      f"{r['cache_row_err']:.2e}" for r in steps)
          + f" (bound {LM_TOL}); step ms unsharded "
          f"{[round(t, 3) for t in times['unsharded']]}, sharded "
          f"{[round(t, 3) for t in times['sharded']]} (in turns; the shard "
          f"loop's overhead, no gain claimed)")
    del params, model, model32, base
    gc.collect()
    torch.cuda.empty_cache()


def route_rows(torch, a, b, per_a: int, per_b: int, batch: int
               ) -> np.ndarray:
    """The batch rows whose tokens' applied experts agree in every MoE
    layer between two runs' route lists (``per_a`` / ``per_b`` routes a
    layer, one a shard in token order), (``batch``,) bool."""
    def per_layer(routes, n):
        return [torch.cat([r.applied for r in routes[i:i + n]])
                for i in range(0, len(routes), n)]
    la, lb = per_layer(a, per_a), per_layer(b, per_b)
    require(len(la) == len(lb), f"17b: {len(la)} vs {len(lb)} MoE layers")
    return np.logical_and.reduce([
        (x == y).all(dim=-1).reshape(batch, -1).all(dim=-1).cpu().numpy()
        for x, y in zip(la, lb)])


def run_mesh_moe(torch, out) -> None:
    """17b: deepseek-moe-16b at its widths, ``MESH_MOE_LAYERS`` layers,
    over (1, 4) and (2, 2) meshes on the card (see ``run_mesh_serving``)."""
    import dataclasses
    import gc

    from repro_torch import tuning
    from repro_torch.configs import get_config
    from repro_torch.core.engine import make_mesh2d
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.parallel import ctx
    from repro_torch.train.step import build_serve_decode, build_serve_prefill

    full = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full, n_layers=MESH_MOE_LAYERS)
    model = build_model(cfg)
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    b = MESH_LM_BATCH
    n_moe = cfg.n_layers - cfg.first_dense_layers
    rng = np.random.default_rng(SEED + 171)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))).to(dev)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, MESH_MOE_PREFILL))).to(dev)
    base = random_cache(torch, model.init_cache(b, MESH_MOE_DEPTH), gen, dev)
    pos = MESH_MOE_DEPTH - 1
    routes_u = []
    lu, _ = model.decode(params, {k: v.clone() for k, v in base.items()}, tok,
                         pos, routes=routes_u)
    rows = []
    for shape in MESH_MOE_SHAPES:
        mesh = make_mesh2d(shape[0], shape[1], data_axis="data",
                           shard_axis="model", devices=[dev] * MESH_SHARDS)
        decode = build_serve_decode(model, mesh, b, MESH_MOE_DEPTH)[0]
        routes_s = []
        with tuning.overrides(flash_decode=True), \
                counted_calls(moe, "_moe_ffn_shardmap") as calls:
            ls, _ = decode(params, {k: v.clone() for k, v in base.items()},
                           tok, pos, routes=routes_s)
        require(len(calls) == n_moe, f"17b {shape}: {len(calls)} sharded "
                f"MoE layers of {n_moe}")
        agree = route_rows(torch, routes_u, routes_s, 1,
                           len(routes_s) // n_moe, b)
        dec = held_err(lm_row_errs(ls, lu.float()), agree,
                       f"decode on {shape} vs single-device", phase="17b")
        dec["dropped"] = int(sum((r.applied == -1).sum() for r in routes_s))
        require(dec["dropped"] == 0 and all(
            (r.applied == -1).sum() == 0 for r in routes_u),
            f"17b {shape}: a decode pair dropped")
        # prefill: every position's logits in bf16 and float32 on this
        # mesh, one row a token; a token's routes agree when its applied
        # experts do in every MoE layer
        rb, rf = [], []
        with ctx.activation_mesh(mesh), \
                counted_calls(moe, "_moe_ffn_shardmap") as calls:
            lb = prefill_logits(torch, model, params, {"tokens": prompt},
                                routes=rb)
            with no_tf32(torch), recorded_moe_calls(moe) as rec:
                lf = prefill_logits(torch, model32, params,
                                    {"tokens": prompt}, routes=rf)
        require(len(calls) == 2 * n_moe, f"17b {shape}: prefill took the "
                f"sharded MoE {len(calls)} times, not {2 * n_moe}")
        # the float32 prefill's MoE layers against an independent path at
        # the same capacity: every peer routes its 1/M of a data shard
        t_loc = b // shape[0] * MESH_MOE_PREFILL // shape[1]
        require(t_loc * cfg.experts_per_token > 512,
                f"17b {shape}: {t_loc} tokens a shard drop nothing")
        vs_local = moe_vs_local_slices(torch, moe, rec, t_loc)
        del rec
        require(torch.isfinite(lb).all(), f"17b {shape}: prefill not finite")
        shards = len(rb) // n_moe
        agree = route_rows(torch, rf, rb, shards, shards, b * MESH_MOE_PREFILL)
        pre = held_err(lm_row_errs(lb, lf), agree,
                       f"prefill on {shape} bf16 vs float32", phase="17b")
        pre["vs_local"] = vs_local
        # block by block (as 15a): each bf16 block fed the float32
        # stream's input, every top-k flip a near-tie of the float32 router
        with ctx.activation_mesh(mesh):
            pre["blocks"] = check_prefill_blocks(
                torch, model, model32, params, prompt, [], phase="17b")
        pre["dropped_bf16"] = [int((r.applied == -1).sum()) for r in rb]
        pre["dropped_f32"] = [int((r.applied == -1).sum()) for r in rf]
        # the builder's prefill: the last position's logits of the same
        # evaluation (bf16 index_add_ atomics differ from run to run)
        last = build_serve_prefill(model, mesh)[0](params, {"tokens": prompt})
        pre["builder_vs_last"] = lm_row_err(last, lb[:, -1])
        require(last.shape == (b, cfg.vocab)
                and pre["builder_vs_last"] <= MESH_ATTN_TOL,
                f"17b {shape}: build_serve_prefill vs the same evaluation "
                f"{pre['builder_vs_last']} > {MESH_ATTN_TOL}")
        del lb, lf
        rows.append({"shape": shape, "decode": dec, "prefill": pre})
        bl = pre["blocks"]
        print(f"phase 17b {cfg.name} ({cfg.n_layers} of {full.n_layers} "
              f"layers, E {cfg.n_experts}, k {cfg.experts_per_token}, d "
              f"{cfg.d_model}, moe_d_ff {cfg.moe_d_ff}) on a {shape} mesh: "
              f"decode B {b} at {pos} vs single-device {dec['err']:.4f} "
              f"({dec['held']}, {dec['rows_routes_differ']} rows' routes "
              f"differ; bound {LM_TOL}), no pair dropped; prefill B {b} x S "
              f"{MESH_MOE_PREFILL} bf16 vs float32, every position, "
              f"{pre['err']:.4f} ({pre['held']}, {pre['rows_routes_differ']} "
              f"of {pre['rows']} tokens' routes differ, their largest error "
              f"{pre.get('err_flipped_rows', float('nan')):.4f}; builder's "
              f"last position {pre['builder_vs_last']:.2e}); block by block "
              f"{bl['err']:.4f} ({bl['blocks_held_on_agreeing_rows']} "
              f"blocks held on the rows whose applied experts agree, "
              f"{bl['rows_differ']} token-layers left out, their "
              f"largest error {bl['err_rows_differ']:.4f}; "
              f"{bl['route_flips']} top-k flips in "
              f"{bl['pairs']} token-layers, each a "
              f"near-tie: largest log-gap {bl['flip_gap']:.5f}, "
              f"bound {FAM_NEAR_TIE}); float32 MoE layers vs single-device "
              f"slices at capacity(cfg, {t_loc}): output "
              f"{vs_local['err']:.2e}, aux {vs_local['aux_err']:.2e} (bound "
              f"{MESH_MOE_LOCAL_TOL}), applied experts equal; dropped pairs "
              f"per route (layer-major, {shards} "
              f"shards a layer) bf16 {pre['dropped_bf16']}, float32 "
              f"{pre['dropped_f32']}")
    out["17b"] = rows
    del params, model, model32, base
    gc.collect()
    torch.cuda.empty_cache()


def run_mesh_serving(torch, report) -> dict:
    """Phase 17: LM serving over a mesh of logical shards on the one card,
    through ``launch.mesh``, ``train.step.build_serve_prefill`` /
    ``build_serve_decode`` and the ``flash_decode`` knob:
    17a qwen3-1.7b unreduced (fp32 weights from seed 0, bf16 activations)
    on a (1, 4) mesh, B 4 from a seeded random 512-row cache: layer 0's
    flash route against the dense one at positions 127, 128, 255, 256 and
    511 with no window and a 256 window (caches bit-identical, output
    within ``MESH_ATTN_TOL`` of the dense bf16 and of float32); whole
    decode steps at those positions against the unsharded step and
    float32 (logits within ``LM_TOL``, caches as ``cache_rows_held``);
    a decode step's time unsharded and sharded, in turns;
    17b deepseek-moe-16b at its widths cut to ``MESH_MOE_LAYERS`` layers on
    (1, 4) and (2, 2): a B 4 decode step (no pair drops) against the
    single-device step, and a B 4 x S 512 prefill in bf16 against float32
    on the same mesh (the capacity is the knob's: pairs drop), within
    ``LM_TOL`` (rows whose routes differ left out only if some row fails,
    as phase 15a); each route's dropped pairs printed.  Returns the three
    kernels' launches over the phase (none is on this path)."""
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda

    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda, "pair_count": count_block_cuda}
    for k in kernels.values():
        k.launches = 0
    out = report["mesh_serving"] = {"s": {}}
    t = time.perf_counter()
    run_mesh_dense(torch, out)
    out["s"]["17a"] = time.perf_counter() - t
    t = time.perf_counter()
    run_mesh_moe(torch, out)
    out["s"]["17b"] = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    require(sum(launches.values()) == 0,
            f"17: the set-intersection kernels launched {launches}")
    out["launches"] = launches
    print(f"phase 17 seconds: {json.dumps(out['s'])}; the three kernels' "
          f"launches {json.dumps(launches)}")
    return launches


# -- phase 18: LM training over a mesh -----------------------------------------

def mesh_of(shape, device):
    """A ``(data, model)`` mesh of ``shape``, every shard on ``device``."""
    from repro_torch.core.engine import make_mesh2d

    return make_mesh2d(shape[0], shape[1], data_axis="data",
                       shard_axis="model",
                       devices=[device] * (shape[0] * shape[1]))


def one_step(torch, fn, p0, opt, batch):
    """One step of ``fn`` from a copy of ``p0`` and a fresh AdamW state:
    (loss, grad norm, updated params)."""
    import copy

    from repro_torch.optim import adamw

    params = copy.deepcopy(p0)
    state = adamw.init(opt, params)
    params, state, m = fn(params, state, batch)
    out = (float(m["loss"]), float(m["grad_norm"]), params)
    del state, m
    return out


def step_diff(torch, a, b) -> float:
    """The largest relative difference of two ``one_step`` results: loss,
    grad norm, and each updated parameter's largest difference over its
    largest magnitude."""
    diff = max(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]))
    ref = dict(b[2].named_parameters())
    for n, x in a[2].named_parameters():
        y = ref[n]
        diff = max(diff, float((x - y).abs().max()
                               / y.abs().max().clamp_min(1e-30)))
    return diff


def run_mesh_train_dense(torch, out) -> None:
    """18a: qwen3-1.7b unreduced, one bf16 step over ``MESH_TRAIN_SHAPE``
    at ``MESH_TRAIN_MICRO`` against the single-device step (see
    ``run_mesh_training``)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    p0 = model.init(gen)
    batch = train_batch(torch, cfg, 0, dev)
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    mesh = mesh_of(MESH_TRAIN_SHAPE, dev)
    single = build_train_step(model, opt_cfg=opt,
                              microbatch=MESH_TRAIN_MICRO)[0]
    torch.cuda.reset_peak_memory_stats()
    ref = one_step(torch, single, p0, opt, batch)
    again = one_step(torch, single, p0, opt, batch)
    noise = step_diff(torch, again, ref)
    del again
    bound = max(noise, MESH_TRAIN_FLOOR)
    res = {"single_vs_single": noise, "bound": bound}
    runs = {}
    for fsdp in (False, True):
        fn, (p_specs, _), _ = build_train_step(
            model, mesh, opt_cfg=opt, fsdp=fsdp, microbatch=MESH_TRAIN_MICRO)
        runs[fsdp] = one_step(torch, fn, p0, opt, batch)
        res[f"fsdp_{fsdp}_vs_single"] = step_diff(torch, runs[fsdp], ref)
        res[f"fsdp_{fsdp}_sharded_dims"] = sum(
            a is not None for sp in p_specs.values() for a in sp)
        require(res[f"fsdp_{fsdp}_vs_single"] <= bound,
                f"18a: the step over {MESH_TRAIN_SHAPE} (fsdp {fsdp}) vs "
                f"the single-device step {res[f'fsdp_{fsdp}_vs_single']} > "
                f"{bound}")
    res["fsdp_on_vs_off"] = step_diff(torch, runs[True], runs[False])
    require(res["fsdp_on_vs_off"] <= bound,
            f"18a: FSDP on vs off {res['fsdp_on_vs_off']} > {bound}")
    require(math.isfinite(ref[0]) and math.isfinite(ref[1]),
            f"18a: loss {ref[0]}, grad norm {ref[1]}")
    res.update(loss=ref[0], grad_norm=ref[1],
               peak_bytes=torch.cuda.max_memory_allocated())
    out["18a"] = res
    print(f"phase 18a {cfg.name} unreduced, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, bf16, microbatch {MESH_TRAIN_MICRO}: one step over "
          f"{MESH_TRAIN_SHAPE} against the single-device step: loss "
          f"{ref[0]:.6f}, grad norm {ref[1]:.5f}; two single-device steps "
          f"differ by {noise:.3e} (bound {bound:.1e}); FSDP off "
          f"{res['fsdp_False_vs_single']:.3e}, FSDP on "
          f"{res['fsdp_True_vs_single']:.3e} (sharded dimensions in the "
          f"specs: {res['fsdp_False_sharded_dims']} off, "
          f"{res['fsdp_True_sharded_dims']} on), FSDP on vs off {res['fsdp_on_vs_off']:.3e}; peak device "
          f"memory {res['peak_bytes']} bytes")
    del ref, runs, p0
    gc.collect()
    torch.cuda.empty_cache()


def moe_grads_vs_local_slices(torch, moe, calls, mesh, t_loc: int,
                              aux_ct: float) -> dict:
    """18b (ii): each recorded float32 MoE layer's backward through the
    sharded stages (``_moe_ffn_shardmap`` under a seeded random cotangent
    of its output and ``aux_ct`` of its aux loss) against the single-device
    dispatch (``_moe_ffn_local``) run on each ``t_loc``-token slice that a
    shard routes, at the same capacity, the slices' aux losses averaged as
    the sharded ``pmean`` does.  The applied experts must be equal, and the
    input cotangent and the router, expert and shared-expert weight
    gradients (summed over the slices) within ``MESH_MOE_LOCAL_TOL``
    relative L2.  TF32 off."""
    worst = {"dx": 0.0, "router": 0.0, "experts": 0.0, "shared": 0.0}
    gen = torch.Generator(device=calls[0][2].device)
    gen.manual_seed(SEED + 18)

    def rel(a, b) -> float:
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    with no_tf32(torch), torch.enable_grad():
        for i, (p, cfg, x, _, _, _) in enumerate(calls):
            named = [(n, w) for n, w in p.named_parameters()]
            ws = [w for _, w in named]
            for w in ws:
                w.requires_grad_(True)
            try:
                d = x.shape[-1]
                ct = torch.randn(x.shape, generator=gen, device=x.device)
                xs = x.detach().clone().requires_grad_(True)
                r_sh = []
                o, a = moe._moe_ffn_shardmap(p, cfg, xs, mesh, r_sh)
                g_sh = torch.autograd.grad((o * ct).sum() + aux_ct * a,
                                           [xs] + ws)
                del o, a
                xl = x.detach().reshape(-1, d).clone().requires_grad_(True)
                ctf = ct.reshape(-1, d)
                require(xl.shape[0] == t_loc * len(r_sh),
                        f"18b: MoE layer {i}: {len(r_sh)} routes of {t_loc} "
                        f"tokens for {xl.shape[0]} tokens")
                total = 0.0
                for j, r_j in enumerate(r_sh):
                    sl = slice(j * t_loc, (j + 1) * t_loc)
                    r = []
                    o_j, a_j = moe._moe_ffn_local(p, cfg, xl[sl][None], r)
                    require(torch.equal(r[0].applied, r_j.applied),
                            f"18b: MoE layer {i} slice {j}: the sharded "
                            f"route's applied experts differ from the "
                            f"single-device dispatch's")
                    total = total + (o_j[0] * ctf[sl]).sum() \
                        + aux_ct * a_j / len(r_sh)
                g_loc = torch.autograd.grad(total, [xl] + ws)
            finally:
                for w in ws:
                    w.requires_grad_(False)
            worst["dx"] = max(worst["dx"], rel(g_sh[0].reshape(-1, d),
                                               g_loc[0]))
            for (n, _), a_g, b_g in zip(named, g_sh[1:], g_loc[1:]):
                group = ("router" if n == "router" else "shared"
                         if n.startswith("shared") else "experts")
                worst[group] = max(worst[group], rel(a_g, b_g))
            del g_sh, g_loc
    for k, v in worst.items():
        require(v <= MESH_MOE_LOCAL_TOL,
                f"18b: sharded MoE backward vs single-device slices: {k} "
                f"{v} > {MESH_MOE_LOCAL_TOL}")
    return {"layers": len(calls), **worst}


def run_mesh_train_moe(torch, out) -> None:
    """18b: deepseek-moe-16b at its widths, ``MESH_MOE_LAYERS`` layers,
    B 4 x S 512, on ``MESH_MOE_SHAPES`` (see ``run_mesh_training``)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import ctx
    from repro_torch.train.step import build_train_step

    full = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full, n_layers=MESH_MOE_LAYERS)
    model = build_model(cfg)
    dev = model.device
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                          device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    batch = train_batch(torch, cfg, 0, dev)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    aux_ct = 0.01 / cfg.n_layers
    rows = []
    for shape in MESH_MOE_SHAPES:
        mesh = mesh_of(shape, dev)
        t = time.perf_counter()
        # (i) bf16 against float32 over the mesh: the loss, then each
        # block's backward fed the float32 stream and cotangent
        with ctx.activation_mesh(mesh), \
                counted_calls(moe, "_moe_ffn_shardmap") as calls:
            hold = hold_first_step(torch, model, params, batch, False)
            blocks = grad_blocks(torch, model, model32, params, batch)
        # forward and remat recomputation, bf16 and float32, for every MoE
        # layer; then grad_blocks' float32 and bf16 block of each
        require(len(calls) == 6 * n_moe, f"18b {shape}: the sharded MoE "
                f"ran {len(calls)} times, not {6 * n_moe}")
        # (ii) each float32 MoE layer's backward against the slices
        t_loc = TRAIN_BATCH // shape[0] * TRAIN_SEQ // shape[1]
        with ctx.activation_mesh(mesh), no_tf32(torch), torch.no_grad(), \
                recorded_moe_calls(moe) as rec:
            moe.forward(params, model32.cfg, batch["tokens"], routes=[])
        vs_local = moe_grads_vs_local_slices(torch, moe, rec, mesh, t_loc,
                                             aux_ct)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        rows.append({"shape": shape, "hold": hold, "grad_blocks": blocks,
                     "vs_local": vs_local, "s": time.perf_counter() - t})
        print(f"phase 18b {cfg.name} ({cfg.n_layers} of {full.n_layers} "
              f"layers, {n_params} parameters) on a {shape} mesh, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}: bf16 vs float32 (TF32 off) loss "
              f"{hold['loss']:.5f} vs {hold['loss_f32']:.5f} (relative "
              f"{hold['loss_err']:.2e}, tolerance {TRAIN_LOSS_TOL}), grad "
              f"norm relative {hold['grad_norm_err']:.2e}, least cosine "
              f"{hold['min_cosine']:.5f} ({hold['min_cosine_param']}); each "
              f"bf16 block's backward fed the float32 stream and cotangent, "
              f"{blocks['blocks']} blocks: least gradient cosine "
              f"{blocks['min_cosine']:.5f} ({blocks['min_cosine_at']}; bound "
              f"{TRAIN_BLOCK_COSINE}), largest input cotangent error "
              f"{blocks['dx_err']:.2e} (bound {TRAIN_BLOCK_DX}); float32 MoE "
              f"backward vs single-device slices of {t_loc} tokens, "
              f"{vs_local['layers']} layers: input cotangent "
              f"{vs_local['dx']:.2e}, router {vs_local['router']:.2e}, "
              f"experts {vs_local['experts']:.2e}, shared experts "
              f"{vs_local['shared']:.2e} (bound {MESH_MOE_LOCAL_TOL}), "
              f"applied experts equal; {rows[-1]['s']:.1f} s")
    # (iii) the sharded step beside the single-device one, in turns; the
    # sharded step goes first, so its first step is (i)'s loss on the same
    # weights and batch, through the step's own mesh context
    mesh = mesh_of(MESH_TRAIN_TIMED, dev)
    held = next(r["hold"]["loss"] for r in rows
                if r["shape"] == MESH_TRAIN_TIMED)
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    fns = {"sharded": build_train_step(model, mesh, opt_cfg=opt)[0],
           "single": build_train_step(model, opt_cfg=opt)[0]}
    # the MoE layers' sharded stages a step: forward and remat's
    # recomputation under the step's mesh; none on one device
    want_calls = {"sharded": 2 * n_moe, "single": 0}
    state = adamw.init(opt, params)
    ms = {k: [] for k in fns}
    losses = {k: [] for k in fns}
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        step_batch = train_batch(torch, cfg, i, dev)
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            with counted_calls(moe, "_moe_ffn_shardmap") as calls:
                start.record()
                params, state, m = fn(params, state, step_batch)
                end.record()
            require(len(calls) == want_calls[name], f"18b (iii) {name} step "
                    f"{i}: the sharded MoE ran {len(calls)} times, not "
                    f"{want_calls[name]}")
            losses[name].append(m["loss"].item())
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for v in losses.values() for x in v),
            f"18b: losses {losses}")
    step_err = abs(losses["sharded"][0] - held) / abs(held)
    require(step_err <= MESH_STEP_LOSS_TOL, f"18b (iii): the sharded step's "
            f"first loss {losses['sharded'][0]} vs (i)'s {held} on the same "
            f"weights and batch: relative {step_err} > {MESH_STEP_LOSS_TOL}")
    timing = {"peak_bytes": peak, "mesh": MESH_TRAIN_TIMED,
              "first_loss": losses["sharded"][0], "held_loss": held,
              "first_loss_err": step_err, "moe_calls_a_step": want_calls}
    for name, fn in fns.items():
        timed = sorted(ms[name][TRAIN_WARMUP:])
        prof = profile_breakdown(torch, lambda: fn(params, state, batch),
                                 groups=())
        timing[name] = {"ms": ms[name], "median_ms": timed[len(timed) // 2],
                        "device_calls": prof["device_calls"],
                        "device_busy_ms": prof["device_busy_ms"]}
    rows.append({"timing": timing})
    print(f"phase 18b {cfg.name} step over {MESH_TRAIN_TIMED}: the sharded "
          f"MoE ran {2 * n_moe} times a step (forward and recomputation), "
          f"the single-device step's 0; first loss {losses['sharded'][0]!r} "
          f"vs (i)'s {held!r} (relative {step_err:.2e}, tolerance "
          f"{MESH_STEP_LOSS_TOL})")
    print(f"phase 18b {cfg.name} step (bf16, AdamW), in turns, "
          f"{TRAIN_WARMUP} warm-ups then {TRAIN_TIMED}: single-device "
          f"{timing['single']['median_ms']:.1f} ms (steps "
          f"{[round(x, 1) for x in ms['single']]}; {timing['single']['device_calls']}"
          f" launches a step, busy {timing['single']['device_busy_ms']:.1f} "
          f"ms), over {MESH_TRAIN_TIMED} {timing['sharded']['median_ms']:.1f} "
          f"ms (steps {[round(x, 1) for x in ms['sharded']]}; "
          f"{timing['sharded']['device_calls']} launches a step, busy "
          f"{timing['sharded']['device_busy_ms']:.1f} ms); peak device "
          f"memory {peak} bytes")
    out["18b"] = rows
    del params, state, fns, model, model32, batch
    gc.collect()
    torch.cuda.empty_cache()


def run_mesh_train_resume(torch, out) -> None:
    """18c: elastic resume at the smoke configs of qwen3-1.7b and
    deepseek-moe-16b (see ``run_mesh_training``)."""
    import shutil

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import elastic, loop
    from repro_torch.train.loop import to_device
    from repro_torch.train.step import build_train_step

    mid, end = TRAIN_RESUME
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    res = out["18c"] = {}
    for arch in (TRAIN_ARCH, "deepseek-moe-16b"):
        cfg = smoke_config(get_config(arch))
        model = build_model(cfg)
        dev = model.device
        data = SyntheticLMData(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
        m_a, m_b = (mesh_of(s, dev) for s in MESH_TRAIN_RESUME)
        root = ROOT / "build" / "ckpt18c" / arch
        shutil.rmtree(root, ignore_errors=True)
        lcfg = loop.LoopConfig(steps=mid, ckpt_dir=str(root),
                               ckpt_every=10 ** 6, log_every=10 ** 6,
                               seed=SEED)
        first = loop.train(model, data, lcfg, opt_cfg=opt,
                           log_fn=lambda *_: None, mesh=m_a)
        step, state, mesh = elastic.remesh(model, str(root), mesh=m_b,
                                           opt_cfg=opt)
        restored_equal = step == mid and all(
            torch.equal(a, b) for a, b in zip(
                state["params"].parameters(), first["params"].parameters())
        ) and all(torch.equal(state["opt"].m[n], first["opt_state"].m[n])
                  and torch.equal(state["opt"].v[n], first["opt_state"].v[n])
                  for n in state["opt"].m)
        require(restored_equal, f"18c {arch}: remesh onto "
                f"{MESH_TRAIN_RESUME[1]} did not restore the saved state")
        fn = build_train_step(model, m_b, opt_cfg=opt)[0]
        params, st = state["params"], state["opt"]
        resumed = [h["loss"] for h in first["history"]]
        for i in range(mid, end):
            params, st, m = fn(params, st, to_device(data.batch_at(i), dev))
            resumed.append(m["loss"].item())
        gen = torch.Generator(device=dev)
        gen.manual_seed(lcfg.seed)
        params = model.init(gen)
        st = adamw.init(opt, params)
        fns = [build_train_step(model, mm, opt_cfg=opt)[0] for mm in (m_a, m_b)]
        kept = []
        for i in range(end):
            params, st, m = fns[i >= mid](params, st, to_device(
                data.batch_at(i), dev))
            kept.append(m["loss"].item())
        err = max(abs(a - b) / abs(b) for a, b in zip(resumed, kept))
        exact = resumed == kept
        if cfg.family == "moe":
            require(err <= TRAIN_RESUME_TOL, f"18c {arch}: resumed losses "
                    f"{resumed} vs kept {kept}: {err} > {TRAIN_RESUME_TOL}")
        else:
            require(exact, f"18c {arch}: resumed losses {resumed} vs kept "
                    f"{kept} are not bit-identical")
        shutil.rmtree(root, ignore_errors=True)
        res[arch] = {"resumed": resumed, "kept": kept, "max_rel_err": err,
                     "exact": exact}
        print(f"phase 18c {arch} (smoke config, {cfg.dtype}): {mid} steps "
              f"over {MESH_TRAIN_RESUME[0]} through train.loop.train, a "
              f"checkpoint, remesh onto {MESH_TRAIN_RESUME[1]} (state "
              f"restored bit for bit), {end - mid} more steps, against the "
              f"run kept in memory: largest relative loss difference "
              f"{err:.2e} (bit-identical: {exact}; "
              f"{'tolerance ' + str(TRAIN_RESUME_TOL) if cfg.family == 'moe' else 'required'})")


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_answers_right(out) -> bool:
    """``serve_search_torch``'s answers against numpy intersections of its
    postings (term lists: the plain log)."""
    post = out["postings"]
    for q, got in zip(out["queries"], out["doc_ids"]):
        want = post[q[0]]
        for t in q[1:]:
            want = np.intersect1d(want, post[t])
        if not np.array_equal(np.asarray(got, dtype=np.int64),
                              want.astype(np.int64)):
            return False
    return True


def run_examples(torch, out, kernels) -> dict:
    """18d: the four twins of ``examples/`` on the card at their default
    sizes, each reaching its own check; returns the launches of each
    kernel that each made."""
    import shutil

    ckpt = ROOT / "build" / "ckpt18d"
    runs = (("quickstart_torch", []),
            ("constrained_decode_torch", []),
            ("serve_search_torch", []),
            ("train_lm_torch", ["--steps", str(EXAMPLE_TRAIN_STEPS),
                                "--ckpt", str(ckpt)]))
    res = out["18d"] = {}
    launches = {}
    for name, argv in runs:
        mod = load_example(name)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = mod.main(argv)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        launches[name] = {k: fn.launches for k, fn in kernels.items()}
        if name == "quickstart_torch":
            ok = np.array_equal(got["device_result"], got["truth"])
        elif name == "constrained_decode_torch":
            ok = all(r.done and set(r.out) <= got["allowed"]
                     for r in got["requests"] if r.constraint is not None)
        elif name == "serve_search_torch":
            ok = example_answers_right(got)
        else:
            ok = bool(got["improved"])
        require(ok, f"18d: {name} did not reach its check")
        res[name] = {"argv": argv, "s": s, "launches": launches[name]}
        print(f"phase 18d {name} {' '.join(argv)}: {s:.1f} s, its check "
              f"reached; kernel launches {json.dumps(launches[name])}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def run_mesh_training(torch, report) -> dict:
    """Phase 18: LM training over a mesh of logical shards on the one card,
    through ``train.step.build_train_step(mesh=, fsdp=, microbatch=)``,
    ``train.loop.train(mesh=)``, ``train.checkpoint.restore(shardings=)``
    and ``train.elastic.remesh``, then the examples' twins:
    18a qwen3-1.7b unreduced (fp32 weights from seed 0, bf16 activations),
    B 4 x S 512: one step over (2, 2) at microbatch 2, FSDP off and on,
    against the single-device step (loss, grad norm and every updated
    parameter within what two single-device steps differ by, or 1e-6
    relative), and FSDP on against off alike;
    18b deepseek-moe-16b at its widths cut to ``MESH_MOE_LAYERS`` layers on
    (1, 4) and (2, 2), B 4 x S 512: (i) a bf16 step's loss against float32
    (TF32 off) over the same mesh within ``TRAIN_LOSS_TOL``, and each
    bf16 block's backward fed the float32 stream and cotangent
    (``grad_blocks``); (ii) each float32 MoE layer's backward through the
    sharded stages against the single-device dispatch on each shard's
    token slice (``moe_grads_vs_local_slices``); (iii) the step over (2, 2)
    beside the single-device step, CUDA events in turns, launches a step
    and peak memory; each sharded step runs the sharded stages forward and
    in remat's recomputation (2 a MoE layer), and its first loss is (i)'s
    bf16 loss on the same weights and batch within ``MESH_STEP_LOSS_TOL``;
    18c elastic resume at the smoke configs (dense and MoE): 3 steps over
    (2, 2) through ``train``, a checkpoint, ``remesh`` onto (1, 4) (the
    state restored bit for bit), 3 more, against the run kept in memory
    (dense bit-identical, MoE within ``TRAIN_RESUME_TOL``);
    18d the four ``examples/*_torch.py`` at their default sizes, timed,
    each reaching its own check.
    Returns the kernels' launches: 0 over 18a-18c, and 18d's by twin."""
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda

    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda, "pair_count": count_block_cuda}
    for k in kernels.values():
        k.launches = 0
    out = report["mesh_training"] = {"s": {}}
    for name, fn in (("18a", run_mesh_train_dense),
                     ("18b", run_mesh_train_moe),
                     ("18c", run_mesh_train_resume)):
        t = time.perf_counter()
        fn(torch, out)
        out["s"][name] = time.perf_counter() - t
    launches = {"18a-18c": {name: k.launches for name, k in kernels.items()}}
    require(sum(launches["18a-18c"].values()) == 0,
            f"18: the set-intersection kernels launched {launches}")
    t = time.perf_counter()
    launches.update(run_examples(torch, out, kernels))
    out["s"]["18d"] = time.perf_counter() - t
    out["launches"] = launches
    print(f"phase 18 seconds: {json.dumps(out['s'])}; the three kernels' "
          f"launches {json.dumps(launches)}")
    return launches


# -- phase 19: the dry run against the card ------------------------------------

def start_dryrun_cell():
    """19d's subprocess, ``python -m repro_torch.launch.dryrun`` on
    ``DRYRUN_CELL`` (meta tensors, CPU only), started early so its trace
    overlaps the phases before 19; it writes its record under
    ``build/dryrun_torch_19d``.  Returns (process, directory, start)."""
    import os

    out = ROOT / "build" / "dryrun_torch_19d"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_CELL[0], "--shape", DRYRUN_CELL[1], "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out, time.perf_counter()


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dryrun_train_step(torch, cfg, mesh_shape, what: str) -> dict:
    """One train step of ``cfg`` at B ``TRAIN_BATCH`` x S ``TRAIN_SEQ``
    over ``mesh_shape``: the dry run's meta trace (``trace_cell``), then
    the same step on the card under the recorder, from seed-``SEED``
    weights and an int32 batch (the dtypes of ``Model.batch_spec``).
    Holds the card's flops to the trace's exactly and its collectives by
    type (count and bytes), the trace's argument bytes to the real
    tensors', and the predicted peak to ``max_memory_allocated`` within
    ``DRYRUN_PEAK_TOL``; returns both sides' numbers."""
    import gc

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import analyze_ops, record
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import (
        abstract_params, auto_microbatch, build_train_step,
    )

    n_dev = math.prod(mesh_shape)
    shape = ShapeConfig(f"train_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    t = time.perf_counter()
    meta_model = build_model(cfg, device="meta")
    meta = dryrun.trace_cell(meta_model, shape, mesh_of(mesh_shape, "meta"))
    mlog = meta.pop("log")
    trace_s = time.perf_counter() - t
    # every argument's whole bytes: the mesh's shards all live on the card
    p_meta = list(abstract_params(meta_model).parameters())
    state_meta = tensor_bytes(p_meta) * 3 + 4     # params, m, v, step
    batch_meta = tensor_bytes(meta_model.batch_spec(shape).values())
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(SEED)
    params = model.init(gen)
    mesh = mesh_of(mesh_shape, model.device)
    micro = auto_microbatch(TRAIN_BATCH, TRAIN_SEQ, mesh)
    require(micro == meta["microbatch"], f"19 {what}: microbatch {micro} vs "
            f"the trace's {meta['microbatch']}")
    fn, _, opt_cfg = build_train_step(model, mesh, microbatch=micro)
    require(opt_cfg.state_dtype == "float32", f"19 {what}: state dtype "
            f"{opt_cfg.state_dtype}")
    state = adamw.init(opt_cfg, params)
    batch = {k: v.to(torch.int32) for k, v in
             train_batch(torch, cfg, 0, model.device).items()}
    real_state = tensor_bytes(list(params.parameters())
                              + list(state.m.values())
                              + list(state.v.values()) + [state.step])
    real_batch = tensor_bytes(batch.values())
    require((real_state, real_batch) == (state_meta, batch_meta),
            f"19 {what}: arguments {real_state} + {real_batch} bytes on the "
            f"card, {state_meta} + {batch_meta} in the trace")
    if n_dev == 1:
        require(meta["memory_analysis"]["argument_bytes"]
                == real_state + real_batch,
                f"19 {what}: the trace's argument bytes "
                f"{meta['memory_analysis']['argument_bytes']} against "
                f"{real_state + real_batch} on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with record() as clog:
        params, state, metrics = fn(params, state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    measured = torch.cuda.max_memory_allocated() - base
    require(math.isfinite(loss), f"19 {what}: loss {loss}")
    card = analyze_ops(clog, default_group=n_dev, n_devices=n_dev)
    traced = meta["op_analysis"]
    require(card["flops_per_device"] == traced["flops_per_device"],
            f"19 {what}: flops {card['flops_per_device']} on the card, "
            f"{traced['flops_per_device']} traced")
    for key in ("collective_count_by_type", "collective_bytes_by_type"):
        require(card[key] == traced[key], f"19 {what}: {key} "
                f"{card[key]} on the card, {traced[key]} traced")
    by_name_card, by_name_meta = clog.counts(), mlog.counts()
    differ = {n: (by_name_meta.get(n, 0), by_name_card.get(n, 0))
              for n in set(by_name_card) | set(by_name_meta)
              if by_name_card.get(n, 0) != by_name_meta.get(n, 0)}
    predicted = real_state + real_batch + mlog.peak_bytes
    peak_err = abs(predicted - measured) / measured
    require(peak_err <= DRYRUN_PEAK_TOL, f"19 {what}: predicted peak "
            f"{predicted} bytes, the card's {measured} ({peak_err:.3f} > "
            f"{DRYRUN_PEAK_TOL})")
    out = {
        "mesh": list(mesh_shape), "microbatch": micro, "trace_s": trace_s,
        "card_step_s": card_s, "loss": loss,
        "ops": {"trace": len(mlog), "card": len(clog)},
        "ops_differing": {n: list(v) for n, v in sorted(differ.items())},
        "flops": traced["flops_per_device"] * n_dev,
        "hbm_bytes": {"trace": traced["hbm_bytes_per_device"] * n_dev,
                      "card": card["hbm_bytes_per_device"] * n_dev},
        "collectives": traced["collective_count_by_type"],
        "collective_bytes": traced["collective_bytes_by_type"],
        "argument_bytes": real_state + real_batch,
        "memory_analysis": meta["memory_analysis"],
        "traced_peak_bytes": mlog.peak_bytes,
        "card_recorded_peak_bytes": clog.peak_bytes,
        "predicted_peak_bytes": predicted, "card_peak_bytes": measured,
        "peak_err": peak_err,
    }
    del params, state, metrics, batch, fn, clog, mlog
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_dryrun_bucket(torch, engine, log, postings, report) -> dict:
    """19c: the op log of phase 4's modal bucket (the signature of two or
    more sets with the most queries) on the card, through ``bucket_op_log``, with the launch
    counts set to 0 just before it and read just after.  Returns the
    kernels' launches."""
    from repro_torch.core.engine import (
        EXEC_COUNTERS, bucket_op_log, dispatch_device_batch,
    )
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.compact import compact_rows_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda
    from repro_torch.launch.op_analysis import analyze_ops

    t0 = time.perf_counter()
    buckets = device_buckets(engine, log)
    sig = max((s for s in buckets if s.k >= 2), key=lambda s: len(buckets[s]))
    plans = buckets[sig]
    rows = [[engine.device.sets[t] for t in p.terms] for p in plans]
    dev = rows[0][0].device

    def first_pass_ms() -> float:
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        pending = dispatch_device_batch(rows, device=dev)
        end.record()
        pending.collect()
        return start.elapsed_time(end)

    first_pass_ms()
    pass_ms = float(np.median([first_pass_ms() for _ in range(5)]))
    bitmap_filter_cuda.launches = group_match_cuda.launches = 0
    compact_rows_cuda.launches = 0
    reruns = EXEC_COUNTERS["rerun_calls"]
    oplog = bucket_op_log(rows, device=dev)
    launches = {"bitmap_filter": bitmap_filter_cuda.launches,
                "group_match": group_match_cuda.launches,
                "compact_rows": compact_rows_cuda.launches}
    reruns = EXEC_COUNTERS["rerun_calls"] - reruns
    entries = oplog.counts("kernel")
    require(entries == {"bitmap_filter": 1, "group_match": sig.k - 1,
                        "compact_rows": 1},
            f"19c: kernel entries {entries} for k {sig.k}")
    require(launches == {"bitmap_filter": 1 + reruns,
                         "group_match": (sig.k - 1) * (1 + reruns),
                         "compact_rows": 1 + reruns},
            f"19c: launches {launches} against the log's {entries} and "
            f"{reruns} re-run pass(es)")
    for (vals, _), p in zip(oplog.results, plans):
        require(np.array_equal(vals, oracle(postings, p.terms)),
                f"19c: wrong answer for {p.terms}")
    ana = analyze_ops(oplog, default_group=1)
    bound_ms = ana["hbm_bytes_per_device"] / HBM_BYTES_PER_S * 1e3
    kernel_bytes = sum(math.prod(shape) * dtype.itemsize
                       for e in oplog.ops if e.kind == "kernel"
                       for shape, dtype in e.operands + e.results)
    out = report["dryrun_bucket"] = {
        "card": nvidia_smi(), "sig": {"ts": list(sig.ts), "k": sig.k},
        "queries": len(rows), "ops": len(oplog),
        "ops_by_kind": {k: sum(1 for e in oplog.ops if e.kind == k)
                        for k in ("aten", "kernel")},
        "kernel_entries": entries, "launches": launches, "reruns": reruns,
        "hbm_bytes": ana["hbm_bytes_per_device"], "kernel_bytes": kernel_bytes,
        "bytes_ms": bound_ms, "pass_ms": pass_ms,
        "s": time.perf_counter() - t0}
    print(f"phase 19c on {out['card']}: bucket_op_log of phase 4's modal "
          f"bucket (t {list(sig.ts)}, {len(rows)} queries): {len(oplog)} "
          f"ops ({out['ops_by_kind']}), kernel entries {entries} = "
          f"launches {launches} ({reruns} re-run pass(es) apart); "
          f"{ana['hbm_bytes_per_device']:.6g} bytes ({kernel_bytes} in the "
          f"kernels) at {HBM_BYTES_PER_S:.3g} B/s: {bound_ms:.4f} ms beside "
          f"the first pass's measured {pass_ms:.4f} ms (CUDA events, median "
          f"of 5); answers equal the oracle; {out['s']:.1f} s")
    return launches


def run_dryrun(torch, report, cell) -> dict:
    """Phase 19a, 19b and 19d (19c runs while phase 4's index lives)."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out = report["dryrun"] = {"card": nvidia_smi(), "s": {}}
    card = out["card"]
    t = time.perf_counter()
    a = out["19a"] = dryrun_train_step(torch, get_config(TRAIN_ARCH), (1, 1),
                                       "19a")
    out["s"]["19a"] = time.perf_counter() - t
    c16 = report.get("lm_training", {}).get("16a", {}).get("16c", {})
    flops_ms = a["flops"] / BF16_OPS_PER_S * 1e3
    bytes_ms = a["hbm_bytes"]["card"] / HBM_BYTES_PER_S * 1e3
    a["roofline_ms"] = {"flops": flops_ms, "bytes": bytes_ms}
    print(f"phase 19a on {card}: {TRAIN_ARCH} train step B {TRAIN_BATCH} x "
          f"S {TRAIN_SEQ} (microbatch {a['microbatch']}): meta trace "
          f"{a['trace_s']:.1f} s, {a['ops']['trace']} ops; the card "
          f"{a['ops']['card']} ops (differing by name: "
          f"{json.dumps(a['ops_differing'])}); flops {a['flops']:.6g} on both"
          f"; argument bytes {a['argument_bytes']} on both; peak predicted "
          f"{a['predicted_peak_bytes']} bytes (arguments + traced "
          f"{a['traced_peak_bytes']}), the card's max_memory_allocated "
          f"{a['card_peak_bytes']} (error {a['peak_err']:.4f}, tolerance "
          f"{DRYRUN_PEAK_TOL}; the card's recorder saw "
          f"{a['card_recorded_peak_bytes']}); roofline: flops at "
          f"{BF16_OPS_PER_S:.3g}/s {flops_ms:.2f} ms, bytes "
          f"{a['hbm_bytes']['card']:.6g} at {HBM_BYTES_PER_S:.3g} B/s "
          f"{bytes_ms:.2f} ms, beside 16c's measured step "
          f"{c16.get('step_ms', float('nan')):.2f} ms and its hand bound "
          f"{c16.get('bound_ms', float('nan')):.2f} ms")
    t = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              n_layers=MESH_MOE_LAYERS)
    b = out["19b"] = dryrun_train_step(torch, cfg, DRYRUN_MOE_MESH, "19b")
    out["s"]["19b"] = time.perf_counter() - t
    print(f"phase 19b on {card}: deepseek-moe-16b at {MESH_MOE_LAYERS} "
          f"layers over {DRYRUN_MOE_MESH}, train step B {TRAIN_BATCH} x S "
          f"{TRAIN_SEQ}: meta trace {b['trace_s']:.1f} s, "
          f"{b['ops']['trace']} ops, the card {b['ops']['card']} (differing:"
          f" {json.dumps(b['ops_differing'])}); collectives "
          f"{json.dumps(b['collectives'])} and bytes a device "
          f"{json.dumps(b['collective_bytes'])} on both; flops "
          f"{b['flops']:.6g} on both; peak predicted "
          f"{b['predicted_peak_bytes']}, the card's {b['card_peak_bytes']} "
          f"(error {b['peak_err']:.4f})")
    # 19d: the subprocess started after phase 1
    proc, out_dir, started = cell
    t = time.perf_counter()
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_CELL_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    tag = f"{DRYRUN_CELL[0]}__{DRYRUN_CELL[1]}__16x16"
    require(proc.returncode == 0, f"19d: the dry run exited "
            f"{proc.returncode}: {stderr[-2000:]}")
    rec = json.loads((out_dir / f"{tag}.json").read_text())
    require(rec["status"] == "ok", f"19d: {tag} {rec['status']}")
    d = out["19d"] = {
        "cell": tag, "status": rec["status"], "seconds": rec["seconds"],
        "trace_s": rec["trace_s"], "ops": rec["ops"],
        "wall_s": time.perf_counter() - started,
        "waited_s": time.perf_counter() - t,
        "memory_analysis": rec["memory_analysis"],
        "flops_per_device": rec["op_analysis"]["flops_per_device"],
        "hbm_bytes_per_device": rec["op_analysis"]["hbm_bytes_per_device"]}
    out["s"]["19d"] = d["waited_s"]
    print(f"phase 19d: python -m repro_torch.launch.dryrun --arch "
          f"{DRYRUN_CELL[0]} --shape {DRYRUN_CELL[1]}: {rec['status']} in "
          f"{rec['seconds']} s (trace {rec['trace_s']} s, {rec['ops']} ops, "
          f"on this host's CPU alongside phases 2-19), flops a device "
          f"{d['flops_per_device']:.6g}, peak estimate "
          f"{rec['memory_analysis']['peak_bytes_est']} bytes a device; "
          f"waited {d['waited_s']:.1f} s for it")
    out["s"]["19"] = time.perf_counter() - t_phase
    print(f"phase 19 seconds: {json.dumps(out['s'])}")
    return out


# -- phase 20: the seq_shard_mlp knob over a mesh ------------------------------

@contextlib.contextmanager
def recorded_layouts(module, name: str):
    """20a: each call of ``module.name`` (a staged layer) inside the block
    as its input grid's {coordinate: (shape, device)}."""
    real = getattr(module, name)
    calls = []

    def wrapped(*args, **kw):
        calls.append({c: (tuple(x.shape), x.device)
                      for c, x in args[2].items()})
        return real(*args, **kw)
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def captured_grads(adamw):
    """20c: the gradients each ``adamw.update`` call inside the block is
    given (the train step's, after the microbatch mean), one dict a call."""
    real = adamw.update
    calls = []

    def wrapped(cfg, grads, *args, **kw):
        calls.append(grads)
        return real(cfg, grads, *args, **kw)
    adamw.update = wrapped
    try:
        yield calls
    finally:
        adamw.update = real


def run_seq_shard_dense(torch, out) -> None:
    """20a: qwen3-1.7b unreduced, a prefill over ``SEQ_SHARD_MESH`` with
    the ``seq_shard_mlp`` knob on and off (see ``run_seq_shard``)."""
    import dataclasses
    import gc

    from repro_torch import tuning
    from repro_torch.configs import get_config
    from repro_torch.launch.op_analysis import record
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import ctx
    from repro_torch.train.step import build_serve_prefill

    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                          device=dev)
    mesh = mesh_of(SEQ_SHARD_MESH, dev)
    b, s = MESH_LM_BATCH, LM_PREFILL_LEN
    rng = np.random.default_rng(SEED + 20)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s))).to(dev)}
    prefill = build_serve_prefill(model, mesh)[0]

    # every position's logits: knob on (the layouts between layers
    # recorded), knob off on the same mesh, and float32 on one device
    with ctx.activation_mesh(mesh):
        with tuning.overrides(seq_shard_mlp=True), \
                recorded_layouts(transformer, "_layer_stages") as layouts:
            on = prefill_logits(torch, model, params, batch)
        off = prefill_logits(torch, model, params, batch)
    with no_tf32(torch):
        ref = prefill_logits(torch, model32, params, batch)
    dp, m = SEQ_SHARD_MESH
    want = (b // dp, s // m, cfg.d_model)
    require(len(layouts) == cfg.n_layers, f"20a: {len(layouts)} staged "
            f"layers of {cfg.n_layers}")
    for i, grid in enumerate(layouts):
        require(sorted(grid) == coll.coords(mesh) and all(
            shape == want and d == coll.device_of(mesh, c)
            for c, (shape, d) in grid.items()),
            f"20a: layer {i}'s input grid {grid}, not {want} blocks on "
            f"their devices")
    require(torch.isfinite(on).all() and on.shape == (b, s, cfg.vocab),
            "20a: knob-on logits not finite or misshapen")
    res = {"vs_f32": float(lm_row_errs(on, ref).max()),
           "vs_off": float(lm_row_errs(on, off).max()),
           "off_vs_f32": float(lm_row_errs(off, ref).max()),
           "block": want, "layers_staged": len(layouts)}
    del on, off, ref
    require(max(res["vs_f32"], res["vs_off"]) <= LM_TOL,
            f"20a: knob on vs float32 {res['vs_f32']}, vs off "
            f"{res['vs_off']} > {LM_TOL}")

    # the builder's prefill: one op log, then the two settings in turns
    with tuning.overrides(seq_shard_mlp=True), record() as log:
        last = prefill(params, batch)
    coll_counts = log.counts("collective")
    del log
    require(coll_counts == {"all-gather": 2 * cfg.n_layers,
                            "reduce-scatter": 2 * cfg.n_layers},
            f"20a: the op log's collectives {coll_counts}, not 2 "
            f"all-gathers and 2 reduce-scatters a layer")
    require(last.shape == (b, cfg.vocab) and torch.isfinite(last).all(),
            "20a: the builder's logits not finite or misshapen")
    res["collectives"] = coll_counts

    def run(knob):
        with tuning.overrides(seq_shard_mlp=knob):
            prefill(params, batch)
    ms = {"on": [], "off": []}
    peak = {"on": 0, "off": 0}
    for _ in range(SEQ_SHARD_WARMUP + SEQ_SHARD_TIMED):
        for name in ("on", "off"):
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start.record()
            run(name == "on")
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    res["ms"], res["peak_bytes"] = ms, peak
    res["median_ms"] = {k: sorted(v[SEQ_SHARD_WARMUP:])[SEQ_SHARD_TIMED // 2]
                        for k, v in ms.items()}
    res["launches"] = {k: profile_breakdown(
        torch, lambda k=k: run(k == "on"), groups=())["device_calls"]
        for k in ("on", "off")}
    out["20a"] = res
    print(f"phase 20a {cfg.name} unreduced, prefill B {b} x S {s} over a "
          f"{SEQ_SHARD_MESH} mesh on {dev}: seq_shard_mlp on, every "
          f"position's logits vs float32 (TF32 off) {res['vs_f32']:.4f}, "
          f"vs the knob off {res['vs_off']:.4f} (off vs float32 "
          f"{res['off_vs_f32']:.4f}; bound {LM_TOL}); {cfg.n_layers} layers "
          f"staged, each input a grid of {want} blocks on their devices; "
          f"the op log of one prefill {json.dumps(coll_counts)}; in turns, "
          f"{SEQ_SHARD_WARMUP} warm-ups then {SEQ_SHARD_TIMED}: on "
          f"{res['median_ms']['on']:.1f} ms ({[round(x, 1) for x in ms['on']]}"
          f"; {res['launches']['on']} launches; peak {peak['on']} bytes), off"
          f" {res['median_ms']['off']:.1f} ms ("
          f"{[round(x, 1) for x in ms['off']]}; {res['launches']['off']} "
          f"launches; peak {peak['off']} bytes)")
    del params, model, model32, last
    gc.collect()
    torch.cuda.empty_cache()


def run_seq_shard_moe(torch, out) -> None:
    """20b: deepseek-moe-16b at ``MESH_MOE_LAYERS`` layers, a prefill over
    ``SEQ_SHARD_MOE_MESH`` with the knob on and off, end to end and block
    by block (see ``run_seq_shard``)."""
    import dataclasses
    import gc

    from repro_torch import tuning
    from repro_torch.configs import get_config
    from repro_torch.models import moe, transformer
    from repro_torch.models.model import build_model
    from repro_torch.parallel import ctx

    full = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full, n_layers=MESH_MOE_LAYERS)
    model = build_model(cfg)
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    mesh = mesh_of(SEQ_SHARD_MOE_MESH, dev)
    b, s = MESH_LM_BATCH, MESH_MOE_PREFILL
    rng = np.random.default_rng(SEED + 202)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    r_on, r_off = [], []
    with ctx.activation_mesh(mesh):
        with tuning.overrides(seq_shard_mlp=True), \
                counted_calls(moe, "_moe_block_stages") as staged:
            on = prefill_logits(torch, model, params, {"tokens": tokens},
                                routes=r_on)
        off = prefill_logits(torch, model, params, {"tokens": tokens},
                             routes=r_off)
    # the reference first constrains after the first MoE block
    require(len(staged) == n_moe - 1, f"20b: {len(staged)} staged MoE "
            f"blocks of {n_moe - 1}")
    require(torch.isfinite(on).all(), "20b: knob-on logits not finite")
    require(len(r_on) == len(r_off), f"20b: {len(r_on)} routes vs "
            f"{len(r_off)}")
    shards = len(r_on) // n_moe
    agree = route_rows(torch, r_off, r_on, shards, shards, b * s)
    res = held_err(lm_row_errs(on, off), agree, "knob on vs off",
                   phase="20b")
    del on, off
    # end to end the two streams drift apart by bf16 rounding in every
    # layer (20a: as far as either from float32), so top-k flips there
    # are counted; 17b's rule holds each staged block fed the knob-off
    # stream's input against the whole block: each flip a near-tie
    flips = 0
    for i in range(n_moe):
        a_on = joined_route(r_on[i * shards:(i + 1) * shards])
        a_off = joined_route(r_off[i * shards:(i + 1) * shards])
        flips += int((a_on.topi.sort(-1)[0] != a_off.topi.sort(-1)[0]
                      ).any(-1).sum())
    res.update(route_flips_end_to_end=flips, staged_blocks=len(staged),
               dropped_on=int(sum((r.applied == -1).sum() for r in r_on)),
               dropped_off=int(sum((r.applied == -1).sum() for r in r_off)))
    del r_on, r_off
    hold, r_on, r_off = BlockHold("knob on vs off", "20b"), [], []
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
        b, s)
    with ctx.activation_mesh(mesh), torch.no_grad():
        x = transformer._embed(params, cfg, tokens)
        with tuning.overrides(seq_shard_mlp=True):
            spec = transformer.seq_spec(x.shape)
        layers = moe._layers(params)
        for i, block in enumerate(model.blocks(params, tokens,
                                               routes=r_off)):
            y_off = block(x)[0]
            if i > cfg.first_dense_layers:
                grid = moe._moe_block_stages(cfg, mesh, ctx.shard(x, spec),
                                             layers[i], positions, r_on)[0]
                hold.add(i, ctx.unshard(grid, spec), y_off.float(), r_on,
                         r_off)
            r_off.clear()
            x = y_off
    res["blocks"] = bl = hold.out
    out["20b"] = res
    print(f"phase 20b {cfg.name} ({cfg.n_layers} of {full.n_layers} layers) "
          f"prefill B {b} x S {s} over {SEQ_SHARD_MOE_MESH}: "
          f"{len(staged)} MoE blocks staged; every position, knob on vs off "
          f"{res['err']:.4f} ({res['held']}, {res['rows_routes_differ']} "
          f"of {res['rows']} tokens' routes differ; bound {LM_TOL}), "
          f"{flips} top-k flips end to end in {n_moe * b * s} token-layers; "
          f"block by block (each staged block fed the knob-off stream) "
          f"{bl['err']:.4f} over {bl['blocks']} blocks, {bl['route_flips']}"
          f" flips in {bl['pairs']} token-layers, each a near-tie: largest "
          f"log-gap {bl['flip_gap']:.5f} (bound {FAM_NEAR_TIE}); dropped "
          f"pairs on {res['dropped_on']}, off {res['dropped_off']}")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def run_seq_shard_train(torch, out) -> None:
    """20c: qwen3-1.7b unreduced, one bf16 train step over
    ``SEQ_SHARD_TRAIN_MESH`` at ``MESH_TRAIN_MICRO`` with the knob on and
    off (see ``run_seq_shard``)."""
    import copy
    import gc

    from repro_torch import tuning
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    p0 = model.init(gen)
    batch = train_batch(torch, cfg, 0, dev)
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    mesh = mesh_of(SEQ_SHARD_TRAIN_MESH, dev)
    fn = build_train_step(model, mesh, opt_cfg=opt,
                          microbatch=MESH_TRAIN_MICRO)[0]
    runs = {}
    for knob in (False, True):
        params = copy.deepcopy(p0)
        state = adamw.init(opt, params)
        gc.collect()                # the last step's state, in cycles
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with tuning.overrides(seq_shard_mlp=knob), \
                counted_calls(transformer, "_layer_stages") as staged, \
                captured_grads(adamw) as grads:
            _, _, m = fn(params, state, batch)
        torch.cuda.synchronize()
        runs[knob] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "grads": grads[0], "staged": len(staged),
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "step_peak_bytes":
                          torch.cuda.max_memory_allocated() - base}
        del params, state, m, grads
    on, off = runs[True], runs[False]
    # forward and remat's recomputation, every layer, every microbatch
    want = 2 * cfg.n_layers * MESH_TRAIN_MICRO
    require(on["staged"] == want and off["staged"] == 0,
            f"20c: {on['staged']} / {off['staged']} staged layers, not "
            f"{want} / 0")
    cos = {n: float(torch.sum(g.float() * off["grads"][n].float())
                    / (g.float().norm() * off["grads"][n].float().norm()
                       ).clamp_min(1e-30))
           for n, g in on["grads"].items()}
    worst = min(cos, key=cos.get)
    res = {k: {"loss": r["loss"], "grad_norm": r["grad_norm"],
               "peak_bytes": r["peak_bytes"], "staged": r["staged"],
               "step_peak_bytes": r["step_peak_bytes"]}
           for k, r in (("on", on), ("off", off))}
    res.update(
        loss_err=abs(on["loss"] - off["loss"]) / abs(off["loss"]),
        grad_norm_err=abs(on["grad_norm"] - off["grad_norm"])
        / off["grad_norm"], min_cosine=cos[worst], min_cosine_param=worst)
    del runs, on["grads"], off["grads"]
    require(math.isfinite(res["on"]["loss"])
            and math.isfinite(res["on"]["grad_norm"]),
            f"20c: loss {res['on']['loss']}, grad norm "
            f"{res['on']['grad_norm']}")
    require(res["loss_err"] <= TRAIN_LOSS_TOL
            and res["grad_norm_err"] <= TRAIN_GNORM_TOL
            and res["min_cosine"] >= TRAIN_COSINE,
            f"20c: knob on vs off: loss {res['loss_err']} (bound "
            f"{TRAIN_LOSS_TOL}), grad norm {res['grad_norm_err']} (bound "
            f"{TRAIN_GNORM_TOL}), least cosine {res['min_cosine']} of "
            f"{worst} (bound {TRAIN_COSINE})")
    out["20c"] = res
    print(f"phase 20c {cfg.name} unreduced, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, bf16, microbatch {MESH_TRAIN_MICRO}, one step over "
          f"{SEQ_SHARD_TRAIN_MESH}: seq_shard_mlp on ({want} staged layer "
          f"calls: forward and recomputation) vs off: loss "
          f"{res['on']['loss']:.6f} vs {res['off']['loss']:.6f} (relative "
          f"{res['loss_err']:.2e}, bound {TRAIN_LOSS_TOL}), grad norm "
          f"relative {res['grad_norm_err']:.2e} (bound {TRAIN_GNORM_TOL}), "
          f"least gradient cosine {res['min_cosine']:.5f} ({worst}; bound "
          f"{TRAIN_COSINE}); the step's peak device memory above what was "
          f"allocated before it: on {res['on']['step_peak_bytes']}, off "
          f"{res['off']['step_peak_bytes']} bytes (four logical shards on "
          f"one card hold the same bytes; peaks on "
          f"{res['on']['peak_bytes']}, off {res['off']['peak_bytes']}, the "
          f"knob-on step beside the knob-off step's kept gradients)")
    del p0, fn, batch
    gc.collect()
    torch.cuda.empty_cache()


def run_seq_shard(torch, report) -> dict:
    """Phase 20: the ``seq_shard_mlp`` knob over a mesh of logical shards
    on the one card, through ``build_serve_prefill`` and
    ``build_train_step(mesh=, microbatch=)``, fp32 weights from seed 0 and
    bf16 activations:
    20a qwen3-1.7b unreduced, B 4 x S 512 on ``SEQ_SHARD_MESH``: every
    position's logits with the knob on against float32 (TF32 off) and
    against the knob off, within ``LM_TOL``; every layer's input a grid of
    (4, 128, 2048) blocks on their devices; one prefill's op log 2
    all-gathers and 2 reduce-scatters a layer; the builder's prefill on
    and off in turns (CUDA events, ``SEQ_SHARD_TIMED`` after
    ``SEQ_SHARD_WARMUP``), launches and peak memory;
    20b deepseek-moe-16b at ``MESH_MOE_LAYERS`` layers, B 4 x S 512 on
    ``SEQ_SHARD_MOE_MESH``: every position's logits with the knob on
    against off within ``LM_TOL`` (tokens whose applied experts differ
    left out only if some row fails, as 15a), their top-k flips counted;
    each staged MoE block fed the knob-off stream's input against the
    whole block, as 17b's blocks: within ``LM_TOL``, every top-k flip a
    near-tie (``FAM_NEAR_TIE``);
    20c qwen3-1.7b unreduced, one step at microbatch ``MESH_TRAIN_MICRO``
    on ``SEQ_SHARD_TRAIN_MESH``: the knob on against off under 16a's
    bounds (loss, grad norm, every gradient's cosine) and both steps'
    peak memory.
    Returns the three kernels' launches over the phase (none is on this
    path)."""
    from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
    from repro_torch.kernels.count import count_block_cuda
    from repro_torch.kernels.group_intersect import group_match_cuda

    kernels = {"bitmap_filter": bitmap_filter_cuda,
               "group_match": group_match_cuda, "pair_count": count_block_cuda}
    for k in kernels.values():
        k.launches = 0
    out = report["seq_shard"] = {"card": nvidia_smi(), "s": {}}
    for name, fn in (("20a", run_seq_shard_dense), ("20b", run_seq_shard_moe),
                     ("20c", run_seq_shard_train)):
        t = time.perf_counter()
        fn(torch, out)
        out["s"][name] = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    require(sum(launches.values()) == 0,
            f"20: the set-intersection kernels launched {launches}")
    out["launches"] = launches
    print(f"phase 20 on {out['card']} seconds: {json.dumps(out['s'])}; the "
          f"three kernels' launches {json.dumps(launches)}")
    return launches


def compact_input(torch, gen, shape, kept: float, drop_every: int = 0):
    """Rows of ``shape``, a share ``kept`` of them answers (any int32 bit
    pattern but -1), the rest -1; ``take`` False for every
    ``drop_every``-th row (an overflow row)."""
    vals = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                         device="cuda", dtype=torch.int32)
    vals[vals == -1] = 0
    keep = torch.rand(shape, generator=gen, device="cuda") < kept
    rows = torch.where(keep, vals, -1)
    take = torch.ones(shape[0], dtype=torch.bool, device="cuda")
    if drop_every:
        take[::drop_every] = False
    return rows, take


def check_compact(torch, ops, ref, compact_rows_cuda, rows, take,
                  what: str) -> int:
    """``compact_rows`` against its plain version: offsets equal and the
    values equal up to the last offset, by the kernel and the router.
    Returns the answers."""
    want_v, want_o = ref.compact_rows_ref(rows, take)
    for route, (values, offsets) in (("kernel", compact_rows_cuda(rows, take)),
                                     ("router", ops.compact_rows(rows, take))):
        torch.cuda.synchronize()
        require(torch.equal(offsets, want_o),
                f"21 {what}: {route} offsets differ from the plain version")
        require(values.numel() >= want_v.numel() and torch.equal(
                    values[:want_v.numel()], want_v),
                f"21 {what}: {route} values differ from the plain version")
    return want_v.numel()


def host_copy_s(torch, t) -> float:
    """Host seconds of one pageable copy of ``t`` to the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.cpu()
    return time.perf_counter() - t0


def run_compact_rows(torch, report) -> dict:
    """Phase 21: ``compact_rows`` bit for bit against its plain version on
    the card, at ``COMPACT_SHAPES`` and on edge cases, then timed at each
    cell's shape.  Returns the paper10m-batch shape's times (the kernel
    table's row)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.compact import compact_rows_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    out = report["compact_rows"] = {"card": nvidia_smi(), "edges": [],
                                    "cells": {}}
    edges = [("all -1", (4, 1000, 8), 0.0, 0), ("no -1", (4, 1000, 8), 1.0, 0),
             ("one row", (1, 4096, 32), 0.3, 0),
             ("overflow rows", (9, 2048, 16), 0.1, 3),
             ("no row taken", (4, 512, 8), 0.5, 1),
             ("a row past a tile", (1, 3 * 8192 + 4), 0.2, 0),
             ("odd width", (5, 333, 3), 0.4, 2), ("width 1", (7, 1), 0.5, 0)]
    for what, shape, kept, drop in edges:
        rows, take = compact_input(torch, gen, shape, kept, drop)
        n = check_compact(torch, ops, ref, compact_rows_cuda, rows, take, what)
        out["edges"].append({"case": what, "shape": list(shape), "answers": n})
    # 4 bytes off 16: the scalar loads
    rows, take = compact_input(torch, gen, (3 * 4096 + 1,), 0.3)
    rows = rows[1:].view(3, 4096)
    check_compact(torch, ops, ref, compact_rows_cuda, rows,
                  torch.ones(3, dtype=torch.bool, device="cuda"), "misaligned")
    out["edges"].append({"case": "misaligned", "shape": [3, 4096]})
    for cell, (shape, kept) in COMPACT_SHAPES.items():
        rows, take = compact_input(torch, gen, shape, kept)
        n = check_compact(torch, ops, ref, compact_rows_cuda, rows, take, cell)
        B, L = shape[0], math.prod(shape[1:])
        ms = cuda_ms(torch, lambda: compact_rows_cuda(rows, take))
        plain_ms = cuda_ms(torch, lambda: ref.compact_rows_ref(rows, take),
                           iters=3)
        # each value read once, each answer written once, the offsets
        moved = B * L * 4 + n * 4 + (B + 1) * 8
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        values, offsets = compact_rows_cuda(rows, take)
        whole_s = host_copy_s(torch, rows)
        answers_s = host_copy_s(torch, values[:n])
        out["cells"][cell] = row = {
            "shape": list(shape), "answers": n, "bytes": moved, "ms": ms,
            "bound_ms": bound_ms, "share": bound_ms / ms,
            "plain_ms": plain_ms, "max_abs_err": 0,
            "copy_whole_s": whole_s, "copy_answers_s": answers_s}
        print(f"phase 21 compact_rows at {cell}'s {tuple(shape)} ({n} "
              f"answers): {ms:.4f} ms, bound {bound_ms:.4f} ms (bytes, "
              f"{moved} at {HBM_BYTES_PER_S:.3g} B/s), share "
              f"{row['share']:.1%}; plain {plain_ms:.4f} ms; pageable copy "
              f"of the whole buffer {whole_s * 1e3:.2f} ms against the "
              f"answers' {answers_s * 1e3:.3f} ms (host clock)")
        del rows, take, values, offsets
        torch.cuda.empty_cache()
    print(f"phase 21 on {out['card']}: {len(out['edges'])} edge cases and "
          f"{len(COMPACT_SHAPES)} cell shapes bit-identical to the plain "
          f"version")
    return out["cells"]["paper10m-batch"]


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
    from repro_torch.kernels.compact import compact_rows_cuda
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
    # 19d's dry run: CPU only, so it runs beside phases 2-18
    dryrun_cell = start_dryrun_cell()
    atexit.register(lambda: dryrun_cell[0].poll() is None
                    and dryrun_cell[0].kill())

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
    cr = run_compact_rows(torch, report)
    t_phase = phase_done("21 compact_rows", t_phase)

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
    compact_rows_cuda.launches = 0
    EXEC_COUNTERS.reset()
    results, wall = serve_slice(engine, log, postings, torch.cuda.synchronize)
    launches = {"bitmap_filter": bitmap_filter_cuda.launches,
                "group_match": group_match_cuda.launches,
                "compact_rows": compact_rows_cuda.launches}
    counters = EXEC_COUNTERS.snapshot()
    peak = torch.cuda.max_memory_allocated()
    algos = [r.algorithm for r in results]
    require(launches["bitmap_filter"] > 0, "bitmap_filter never launched")
    require(launches["group_match"] > 0, "group_match never launched")
    require(launches["compact_rows"] == counters["compact_calls"]
            == counters["batch_calls"],
            f"compact_rows launched {launches['compact_rows']} times for "
            f"{counters['batch_calls']} passes")
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
          f"rows {moved['gathered_rows']}, packed rows compacted "
          f"{moved['packed_rows']}, copied to the host {counters['d2h_bytes']}")
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
    t_phase = phase_done("13 host route", t_phase)

    # phase 19c: the op log of phase 4's modal bucket, while its index lives
    bucket_launches = run_dryrun_bucket(torch, engine, log, postings, report)
    del engine, postings, results
    torch.cuda.empty_cache()
    t_phase = phase_done("19c bucket op log", t_phase)

    # phase 14: constrained LM decoding at qwen3-1.7b's full width
    lm_launches = run_lm_serving(torch, report)
    torch.cuda.empty_cache()
    t_phase = phase_done("14 LM serving", t_phase)

    # phase 15: the moe, ssm_hybrid, xlstm and encdec families unreduced
    fam_launches = run_lm_families(torch, report)
    t_phase = phase_done("15 LM families", t_phase)

    # phase 16: LM training at qwen3-1.7b's full width, then the families
    train_launches = run_lm_training(torch, report)
    t_phase = phase_done("16 LM training", t_phase)

    # phase 17: LM serving over a mesh of logical shards on the card
    mesh_launches = run_mesh_serving(torch, report)
    t_phase = phase_done("17 LM serving over a mesh", t_phase)

    # phase 18: LM training over a mesh, then the examples' twins
    train_mesh_launches = run_mesh_training(torch, report)
    t_phase = phase_done("18 LM training over a mesh", t_phase)

    # phase 19: the dry run against the card (19c ran after phase 13)
    run_dryrun(torch, report, dryrun_cell)
    t_phase = phase_done("19 dry run", t_phase)

    # phase 20: the seq_shard_mlp knob over a mesh of logical shards
    seq_shard_launches = run_seq_shard(torch, report)
    t_phase = phase_done("20 seq_shard_mlp", t_phase)
    paths = {
        "bitmap_filter": {"query_batch": launches["bitmap_filter"]},
        "group_match": {"query_batch": launches["group_match"]},
        "compact_rows": {"query_batch": launches["compact_rows"]},
        "pair_count": {"suggest_batch": launches["pair_count"],
                       "SuggestEngine.warm": pc_warm_launches,
                       "suggest_batch small sets": small_launches},
    }
    for path, by_kernel in async_launches.items():
        for name, n in by_kernel.items():
            paths[name][path] = n
    for name, n in bucket_launches.items():
        paths[name]["19c bucket_op_log"] = n
    for twin in ("quickstart_torch", "serve_search_torch"):
        if twin in train_mesh_launches:
            for name in ("bitmap_filter", "group_match"):
                paths[name][f"18d {twin}"] = train_mesh_launches[twin][name]
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
        {"name": "compact_rows", "route": "cuda",
         "source": "src/repro_torch/csrc/compact_rows.cu", "replaces": None,
         "launches": launches["compact_rows"],
         "max_abs_err": cr["max_abs_err"], "ms": cr["ms"],
         "plain_ms": cr["plain_ms"], "bound_ms": cr["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "launches_by_path": paths["compact_rows"]},
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
          f"{json.dumps(fam_launches)}; 16 LM training: "
          f"{json.dumps(train_launches)}; 17 LM serving over a mesh: "
          f"{json.dumps(mesh_launches)}; 18 LM training over a mesh and "
          f"the examples: {json.dumps(train_mesh_launches)}; 20 "
          f"seq_shard_mlp: {json.dumps(seq_shard_launches)}")
    print(f"total {report['total_s']:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
