"""Device-resident batched intersection engine, run eagerly on a torch.device.

Pre-processed sets (``partition.PrefixIndex``) are mirrored to the device as
dense int32 tensors (:class:`DeviceSet`); a same-signature bucket of B
queries runs as one pass of two phases:

  phase 1 (filter):  prefix-aligned images, k-way AND, m-way test
                     (``kernels.ops.bitmap_filter`` — the paper's Alg. 5
                     line 3; a hand-written CUDA kernel on the card)
  compaction:        the first ``capacity`` survivor positions per query,
                     ascending, filled with G past the end (a sort)
  phase 2 (recover): exact match of the survivors' raw groups
                     (``kernels.ops.group_match``, k-1 launches per pass)

and returns one packed result buffer per bucket plus per-query overflow
flags; queries whose survivors exceed ``capacity`` are re-run once at
capacity G.  Results, stats and the ``batch_calls`` / ``rerun_calls``
counters equal the JAX package's ``repro.core.engine`` on the same index.

Dispatch is split from collection: :func:`dispatch_device_batch` enqueues
the pass on the device's stream and returns a :class:`PendingBatch`, whose
:meth:`~PendingBatch.collect` copies the results to the host, runs any
overflow re-run and assembles the per-query answers.  On the card the copy
waits for its own pass only: the host waits on the pass's ``ready`` event,
then copies on a side stream (one per device), so a collect never queues
behind passes dispatched after its own, as ``jax.device_get`` of one
bucket's buffers does not.

Eager PyTorch compiles nothing per shape, so "trace" keeps the meaning a
jit cache gives it: the first sighting in the process of a pass
specialization (shape signature, capacity, pow2 B-tier), counted in
``batch_traces`` / ``count_traces``.  :func:`warm_from_plans` runs each
hot signature's representative at every B-tier before live traffic, which
on the card also builds the kernel library and grows the caching
allocator; serving what was warmed then counts no trace.  Warming is the
one place the port differs from the JAX package on purpose: where a
representative fits its capacity, :func:`warm_from_plans` also runs it at
capacity G, the specialization an overflowing sibling's re-run needs
(counted in ``warm_reruns``; the JAX package has no such pass, so there
that sibling traces at serve time).

The boolean expression path (:func:`dispatch_expr_batch`) runs a bucket of
same-shape ∪/∩/∖ expressions as one pass of sort-merge set passes
(``kernels.setops``, torch ops: they were never Pallas), one per DAG node,
with one re-run of the overflowing queries at the total leaf width.

The count-only suggestion path (:func:`dispatch_count_batch`) runs a bucket
of (probe, candidates) rows as one pass: the (B, C) intersection counts
(``kernels.ops.count_block``, a hand-written CUDA kernel on the card that
reads the mirrors through a pointer table), then a top-K per row.  It has
no filter, no survivor buffer and no re-run.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import Device, resolve_device
from ..kernels import ops, setops
from ..kernels.count import CountTable, make_count_table
from .partition import PrefixIndex

__all__ = [
    "BatchedEngine",
    "DeviceSet",
    "EXEC_COUNTERS",
    "ExecCounters",
    "PendingBatch",
    "clear_specializations",
    "default_capacity",
    "default_expr_capacity",
    "default_k_tier",
    "dispatch_count_batch",
    "dispatch_device_batch",
    "dispatch_expr_batch",
    "expr_total_width",
    "gmax_tier",
    "intersect_count_batch",
    "intersect_device",
    "intersect_device_batch",
    "intersect_expr_batch",
    "pow2_tiers",
    "set_sort_key",
    "warm_executables",
    "warm_from_plans",
]


class ExecCounters(dict):
    """Telemetry for the batched device path and the serving front end.

    A ``dict`` subclass (``EXEC_COUNTERS["key"]`` reads and writes) with the
    keys this slice bumps, named as in the JAX package:

    - ``batch_calls``  passes of the bucketed pipeline (first passes and
      overflow re-runs);
    - ``batch_traces`` / ``count_traces``  first sightings in the process of
      a point / count pass specialization (what a jit cache would compile;
      see :func:`clear_specializations`);
    - ``rerun_calls``  overflow re-run passes (survivors > capacity);
    - ``inflight_dispatches`` / ``inflight_collects``  buckets dispatched
      through ``exec.batch.dispatch_bucket`` / torn down by their collect
      (equal after any drain);
    - ``collect_us``  cumulative microseconds in the blocking collect;
    - ``overlap_high_water``  most buckets in flight at once;
    - ``warm_executions``  (representative, B-tier) passes run by
      :func:`warm_executables` / :func:`warm_from_plans`, as in the JAX
      package;
    - ``warm_reruns``  the port's own: passes at the re-run's capacity (G,
      or an expression's total leaf width) that :func:`warm_from_plans`
      adds for that specialization;
    - ``result_cache_hits`` / ``result_cache_misses``  result-cache lookups;
    - ``tier_flushes`` / ``deadline_flushes``  admission-queue flushes by
      cause (``serve/admission.py``);
    - ``tickets_resolved`` / ``queue_wait_us`` / ``deadline_violations``
      per-ticket wait telemetry stamped at resolution (one
      :meth:`bump_many`, so a snapshot sees all three or none);
    - ``flusher_wakeups``  background flusher wake-ups;
    - ``adaptive_promotions`` / ``adaptive_demotions`` /
      ``adaptive_overflow_saved``  learned capacity-tier moves and re-runs
      a learned tier absorbed (``exec/adaptive.py``);
    - ``expr_calls`` / ``expr_traces`` / ``expr_rerun_calls``  the same
      pass / first-sighting / overflow re-run triple for the boolean
      expression path (:func:`dispatch_expr_batch`);
    - ``subexpr_cache_hits`` / ``subexpr_cache_misses``  lookups of
      canonical subexpression entries (``exec/cache.py::ResultCache.
      get_sub``); ``subexpr_cache_stores``  sub-entries stored;
      ``subexpr_host_merges``  expression queries answered on the host
      from cached subexpressions, with no device work;
    - ``count_calls``  passes of the count-only suggest path;
    - ``suggest_prefilter_in`` / ``suggest_prefilter_kept``  candidates the
      suggest pre-filter examined / kept;
    - ``dispatch_failures``  buckets whose dispatch or collect raised.

    Writes and snapshots serialize on one lock; :meth:`bump` /
    :meth:`bump_many` do the whole read-modify-write under it.
    """

    _KEYS = (
        "batch_calls", "batch_traces", "rerun_calls",
        "inflight_dispatches", "inflight_collects",
        "collect_us", "overlap_high_water",
        "warm_executions", "warm_reruns",
        "result_cache_hits", "result_cache_misses",
        "tier_flushes", "deadline_flushes",
        "tickets_resolved", "queue_wait_us", "deadline_violations",
        "flusher_wakeups",
        "adaptive_promotions", "adaptive_demotions",
        "adaptive_overflow_saved",
        "expr_calls", "expr_traces", "expr_rerun_calls",
        "subexpr_cache_hits", "subexpr_cache_misses",
        "subexpr_cache_stores", "subexpr_host_merges",
        "count_calls", "count_traces",
        "suggest_prefilter_in", "suggest_prefilter_kept",
        "dispatch_failures",
    )

    def __init__(self):
        super().__init__({k: 0 for k in self._KEYS})
        self._lock = threading.Lock()

    def __setitem__(self, key, value) -> None:
        with self._lock:
            dict.__setitem__(self, key, value)

    def bump(self, key: str, n: int = 1) -> None:
        """Atomic read-modify-write increment of one counter."""
        with self._lock:
            dict.__setitem__(self, key, dict.__getitem__(self, key) + n)

    def bump_many(self, deltas: Dict[str, int]) -> None:
        """Several increments at once: no snapshot sees a strict subset."""
        with self._lock:
            for key, n in deltas.items():
                dict.__setitem__(self, key, dict.__getitem__(self, key) + n)

    def snapshot(self) -> dict:
        """A consistent copy of every counter."""
        with self._lock:
            return {k: dict.__getitem__(self, k) for k in self._KEYS}

    def reset(self) -> None:
        with self._lock:
            for key in self._KEYS:
                dict.__setitem__(self, key, 0)


EXEC_COUNTERS = ExecCounters()

# pass specializations seen in this process, behind batch_traces /
# count_traces; counter resets leave it alone, as they would a jit cache
_seen_lock = threading.Lock()
_seen_specs: set = set()


def _batch_spec(dev: torch.device, ts: Tuple[int, ...],
                gmaxes: Tuple[int, ...], m: int, w: int, cap: int,
                n_rows: int) -> Tuple:
    """The specialization a point pass of ``n_rows`` rows runs."""
    return ("batch", str(dev), ts, gmaxes, m, w, cap, _b_tier(n_rows))


def _seen_specialization(key: Tuple) -> bool:
    with _seen_lock:
        return key in _seen_specs


def _note_specialization(counter: str, key: Tuple) -> None:
    """Bump ``counter`` on the first sighting of ``key`` in the process."""
    with _seen_lock:
        if key in _seen_specs:
            return
        _seen_specs.add(key)
    EXEC_COUNTERS.bump(counter)


def clear_specializations() -> None:
    """Forget every pass specialization seen so far (a test hook, like the
    JAX package's ``clear_exec_jit_cache``): the next pass of each counts
    a trace again."""
    with _seen_lock:
        _seen_specs.clear()


def _b_tier(n: int) -> int:
    """The pow2 batch tier a pass of ``n`` rows falls in."""
    return 1 << max(0, n - 1).bit_length()


# one side stream per device for the collects' copies to the host
_copy_lock = threading.Lock()
_copy_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _copy_stream(dev: torch.device) -> "torch.cuda.Stream":
    with _copy_lock:
        stream = _copy_streams.get(dev)
        if stream is None:
            stream = _copy_streams[dev] = torch.cuda.Stream(device=dev)
        return stream


def _record_ready(dev: torch.device) -> Optional["torch.cuda.Event"]:
    """An event after the work just issued on ``dev``'s current stream
    (``None`` on the CPU, where that work already ran)."""
    if dev.type != "cuda":
        return None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    return ready


def _to_host(tensors: Sequence[torch.Tensor],
             ready: Optional["torch.cuda.Event"]) -> List[np.ndarray]:
    """Copy one pass's outputs to the host, waiting for that pass only.

    On the card the host first waits on ``ready``, then copies on the
    device's side stream.  The side stream is shared by every collecting
    thread, so nothing is queued on it before its pass has finished: a
    copy there can queue behind another thread's copy, never behind a
    pass.  The copies are blocking, so the source tensors stay referenced
    until they are done.
    """
    if ready is None:
        return [t.numpy() for t in tensors]
    ready.synchronize()
    stream = _copy_stream(tensors[0].device)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)  # already met: orders the copy after it
        return [t.cpu().numpy() for t in tensors]


def gmax_tier(gmax: int) -> int:
    """Static-shape tier for a set's max group size: next power of two
    (>= 8).  Device mirrors pad to this, and the planner keys shape
    signatures by it, so exact gmaxes never fragment the buckets."""
    return 1 << max(3, (int(gmax) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class DeviceSet:
    """Device mirror of a PrefixIndex (sentinel-padded; mask implicit).

    ``vals`` are the original elements as int32 bit patterns (the sentinel
    0xFFFFFFFF is -1), padded to the power-of-two ``gmax`` tier; ``images``
    are the filter images as int32 bit patterns.
    """

    t: int
    gmax: int
    m: int
    w: int
    n: int
    vals: torch.Tensor     # (2^t, gmax) int32 (original values; -1 padding)
    images: torch.Tensor   # (2^t, m, W) int32 bit patterns

    @classmethod
    def from_host(cls, idx: PrefixIndex, device: Device = "cuda") -> "DeviceSet":
        dev = resolve_device(device)
        if int(idx.values.max(initial=0)) >= 0xFFFFFFFF:
            raise ValueError("element 0xFFFFFFFF collides with the sentinel")
        gmax = gmax_tier(idx.gmax)
        padded = np.pad(
            idx.padded_vals, ((0, 0), (0, gmax - idx.gmax)),
            constant_values=np.uint32(0xFFFFFFFF),
        )
        vals = torch.from_numpy(padded.view(np.int32)).to(dev)
        images = torch.from_numpy(
            np.ascontiguousarray(idx.images).view(np.int32)).to(dev)
        return cls(t=idx.t, gmax=gmax, m=idx.family.m, w=idx.w, n=idx.n,
                   vals=vals, images=images)

    @property
    def device(self) -> torch.device:
        return self.vals.device


def set_sort_key(s) -> Tuple[int, int]:
    """THE canonical set ordering key, ``(t, n)``: ascending partition depth
    (prefix alignment needs t ascending) with set size breaking ties, so the
    base set (index 0 after sorting) is the smallest."""
    return (s.t, s.n)


def default_capacity(ts: Tuple[int, ...]) -> int:
    """Survivor-buffer (capacity) tier for a query shape: G/4 with a floor
    of 64.  Phase 2 runs on ``capacity`` group tuples, not all G; dense
    queries overflow and are re-run once at capacity G."""
    return max(64, (1 << ts[-1]) // 4)


def _aligned_images(images: Sequence[Sequence[torch.Tensor]],
                    ts: Tuple[int, ...]) -> torch.Tensor:
    """Prefix-aligned images of a bucket: ``images[i][b]`` is query b's
    (2^{t_i}, m, W) images of its i-th set; returns (B, k, G, m, W) with
    G = 2^{t_k}, set i's row z_i = z >> (t_k - t_i) repeated at every z.

    Each query's images are copied straight into their slot of the output
    (one broadcast copy per set and query), so no (B, G_i, m, W) stack is
    made on the way.
    """
    tk = ts[-1]
    G = 1 << tk
    first = images[0][0]
    B = len(images[0])
    m, W = first.shape[1:]
    out = torch.empty((B, len(ts), G, m, W), dtype=first.dtype,
                      device=first.device)
    for i, (per_query, t) in enumerate(zip(images, ts)):
        g, rep = 1 << t, 1 << (tk - t)
        for b, img in enumerate(per_query):
            out[b, i].view(g, rep, m, W).copy_(img[:, None].expand(g, rep, m, W))
    return out


def _first_survivors(passed: torch.Tensor, capacity: int) -> torch.Tensor:
    """Survivor compaction of a (B, G) phase-1 mask: every row's first
    ``capacity`` survivor positions, ascending, filled with G past the end.
    A sort of the positions with non-survivors keyed G, as the JAX pipeline
    does, so overflow flags and stats stay equal to its."""
    G = passed.shape[1]
    pos = torch.where(passed, torch.arange(G, dtype=torch.int32,
                                           device=passed.device), G)
    surv = torch.sort(pos, dim=1).values
    if capacity <= G:
        return surv[:, :capacity]
    return torch.cat([surv, surv.new_full((surv.shape[0], capacity - G), G)],
                     dim=1)


def _gather_survivor_rows(per_query: Sequence[torch.Tensor],
                          surv_c: torch.Tensor, shift: int) -> torch.Tensor:
    """(B, capacity, g) rows of one set position: query b's rows
    ``surv_c[b] >> shift`` gathered from its own (2^t, g) tensor, so no
    whole mirror is ever stacked."""
    idx = (surv_c >> shift).long()
    return torch.stack([v.index_select(0, idx[b])
                        for b, v in enumerate(per_query)])


def _intersect_k_batch(
    vals: Sequence[Sequence[torch.Tensor]],
    images: Sequence[Sequence[torch.Tensor]],
    ts: Tuple[int, ...],
    capacity: int,
):
    """One pass over a same-signature bucket of B queries.

    ``vals[i][b]``: query b's (2^{t_i}, gmax_i) int32 values of its i-th set;
    ``images[i][b]``: its (2^{t_i}, m, W) images.  Returns (packed, r,
    n_surv, overflow) with a leading B axis each.

    The values are never stacked whole: each query's survivor rows
    (``surv >> (t_k - t_i)``) are gathered from its own tensor and only the
    gathered (B, capacity, g_i) rows are stacked.
    """
    tk = ts[-1]
    G = 1 << tk
    passed = ops.bitmap_filter(_aligned_images(images, ts))    # (B, G)
    n_surv = passed.sum(dim=1)
    surv = _first_survivors(passed, capacity)
    valid_row = surv < G
    surv_c = surv.clamp(max=G - 1)
    base = _gather_survivor_rows(vals[0], surv_c, tk - ts[0])  # (B, cap, g0)
    keep = valid_row[:, :, None] & (base != -1)
    for v, t in zip(vals[1:], ts[1:]):
        keep = keep & ops.group_match(
            base, _gather_survivor_rows(v, surv_c, tk - t))     # (B, cap, g0)
    r = keep.sum(dim=(1, 2))
    overflow = n_surv > capacity
    # pack values and mask into one buffer (-1 = dropped): one copy to host
    packed = torch.where(keep, base, -1)
    return packed, r, n_surv, overflow


def _signature(sets: Sequence[DeviceSet]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    return tuple(s.t for s in sets), tuple(s.gmax for s in sets)


@dataclasses.dataclass
class PendingBatch:
    """In-flight handle for one dispatched bucket pass.

    The pass is enqueued on the device's stream when dispatch returns;
    ``handles`` are its output tensors and ``ready`` a CUDA event recorded
    after it (``None`` on the CPU, where the pass ran synchronously).
    :meth:`collect` copies the results to the host (waiting on ``ready``
    only), runs any overflow re-run and returns exactly what
    :func:`intersect_device_batch` returns; it is memoized.
    """

    n_queries: int
    handles: object = None
    ready: Optional["torch.cuda.Event"] = None
    _collect: Optional[Callable[[], List[Tuple[np.ndarray, Dict]]]] = None
    _results: Optional[List[Tuple[np.ndarray, Dict]]] = None

    def is_ready(self) -> bool:
        """True when the first pass has finished on the device (a collect
        would not wait for it; an overflow re-run can still add work).
        Never blocks."""
        if self._results is not None or self.ready is None:
            return True
        return self.ready.query()

    def collect(self) -> List[Tuple[np.ndarray, Dict]]:
        """Block for the results: [(sorted values, stats), ...] in query
        order."""
        if self._results is None:
            self._results = self._collect()
            self._collect = None  # drop the captured device tensors
            self.handles = None
            self.ready = None
        return self._results


def dispatch_device_batch(
    queries: Sequence[Sequence[DeviceSet]],
    capacity: Optional[int] = None,
    device: Device = "cuda",
) -> PendingBatch:
    """Enqueue the first pass of a same-signature bucket without blocking.

    Every query is a list of DeviceSets on ``device``; all queries must
    share the shape signature ``(ts, gmaxes)`` after the (t, n)-sort (the
    exec layer's bucketing guarantees it).  ``batch_calls`` is bumped per
    pass (the first here, a re-run inside collect), ``rerun_calls`` per
    overflow pass, ``batch_traces`` per first sighting of a pass's
    (signature, capacity, pow2 B-tier).

    The batch runs at its own size B.  (The JAX package pads B to a power of
    two to bound XLA's compile cache; eager PyTorch compiles nothing per
    shape, so only the trace count keeps the tier.)
    """
    dev = resolve_device(device)
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    ordered = [sorted(q, key=set_sort_key) for q in queries]
    ts, gmaxes = _signature(ordered[0])
    for q in ordered:
        if _signature(q) != (ts, gmaxes):
            raise ValueError("bucket mixes shape signatures")
        for s in q:
            if s.device != dev:
                raise ValueError(f"set on {s.device}, bucket runs on {dev}")
    G = 1 << ts[-1]
    m, w = ordered[0][0].m, ordered[0][0].w

    def issue(active: List[int], cap: int):
        vals = [[ordered[i][j].vals for i in active] for j in range(len(ts))]
        images = [[ordered[i][j].images for i in active] for j in range(len(ts))]
        EXEC_COUNTERS.bump("batch_calls")
        _note_specialization("batch_traces", _batch_spec(
            dev, ts, gmaxes, m, w, cap, len(active)))
        handles = _intersect_k_batch(vals, images, ts, cap)
        return handles, _record_ready(dev)

    first_active = list(range(len(ordered)))
    first_cap = capacity or default_capacity(ts)
    first_handles, first_ready = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: List[Optional[Tuple[np.ndarray, Dict]]] = [None] * len(ordered)
        active, cap = first_active, first_cap
        handles, ready = first_handles, first_ready
        while True:
            packed_h, r_h, n_surv_h, over_h = _to_host(handles, ready)
            rerun = []
            for row, qi in enumerate(active):
                if over_h[row]:
                    rerun.append(qi)
                    continue
                row_vals = packed_h[row].ravel()
                out = row_vals[row_vals != -1]
                results[qi] = (
                    np.sort(out.view(np.uint32)),
                    {
                        "group_tuples": G,
                        "tuples_survived": int(n_surv_h[row]),
                        "capacity": cap,
                        "r": int(r_h[row]),
                        "batch_size": len(active),
                    },
                )
            if not rerun:
                return results  # type: ignore[return-value]
            active = rerun
            cap = G  # rare path: ONE re-run of the overflow subset at G
            EXEC_COUNTERS.bump("rerun_calls")
            handles, ready = issue(active, cap)  # the collecting thread's stream

    return PendingBatch(n_queries=len(ordered), handles=first_handles,
                        ready=first_ready, _collect=collect)


def intersect_device_batch(
    queries: Sequence[Sequence[DeviceSet]],
    capacity: Optional[int] = None,
    device: Device = "cuda",
) -> List[Tuple[np.ndarray, Dict]]:
    """Intersect B same-signature queries, one pass (plus at most one
    overflow re-run at capacity G) for the whole bucket.  Returns a list of
    (sorted uint32 result values, stats dict) in query order."""
    return dispatch_device_batch(queries, capacity=capacity,
                                 device=device).collect()


def intersect_device(sets: Sequence[DeviceSet], capacity: Optional[int] = None,
                     device: Device = "cuda"):
    """Intersect k device sets: a batch of one.  Returns (values, stats)."""
    (result, stats), = intersect_device_batch([list(sets)], capacity=capacity,
                                              device=device)
    return result, stats


# -- boolean expression path ---------------------------------------------------
#
# An expression bucket is B queries of one leaf-erased shape (``eshape``,
# ``exec.expr.expr_shape``) whose leaves share (t, gmax) position by position.
# Each leaf's (2^t, gmax) values densify to one sorted key row per query,
# and every DAG node is one set pass over its children's rows, at width
# min(capacity, natural width).  A query any node of which truncated
# (true count > width) is re-run ONCE at the total leaf width, where no
# node can truncate, so results are exact.  The pass also emits every
# composite proper subexpression's rows (postorder), which the serving
# layer stores in its subexpression cache.


def _expr_signature(row: Sequence[DeviceSet]
                    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Leaf signature in TRAVERSAL order: expression rows follow the
    expression's leaf walk (``exec.expr.leaf_terms``) and are never
    re-sorted (a position names the DAG leaf a set feeds)."""
    return tuple(s.t for s in row), tuple(s.gmax for s in row)


def expr_total_width(ts: Tuple[int, ...], gmaxes: Tuple[int, ...]) -> int:
    """Total dense width of an expression's leaves: the capacity at which
    no node can truncate (every result value comes from some leaf)."""
    return sum((1 << t) * g for t, g in zip(ts, gmaxes))


def default_expr_capacity(ts: Tuple[int, ...],
                          gmaxes: Tuple[int, ...]) -> int:
    """Node-buffer tier for expressions: total/4 on the power-of-two
    lattice, floored at 64 (the expression analogue of
    :func:`default_capacity`; an adaptive ``CapacityModel`` refines it per
    shape from observed node counts)."""
    total = expr_total_width(ts, gmaxes)
    tier = 1 << max(0, (total - 1).bit_length())
    return max(64, tier // 4)


def _count_expr_subs(eshape) -> int:
    """Number of composite proper subexpressions of a shape (the sub-row
    count :func:`_eval_expr_block` emits)."""
    if eshape == "T":
        return 0
    return sum(_count_expr_subs(c) + (c != "T") for c in eshape[1:])


def _eval_expr_block(dense: Sequence[torch.Tensor], eshape, capacity: int):
    """Evaluate one expression DAG over dense leaf rows, bottom-up.

    ``dense[i]``: (B, W_i) sorted int32 key rows of leaf i in traversal
    order (``setops.densify``).  Returns ``(root, r, max_count, overflow,
    subs)``: the root's (B, W_root) sorted SENTINEL-padded key rows, its
    true count, the largest true count over every composite node (the
    adaptive model's survivor statistic), the any-node-truncated flag per
    query, and the postorder tuple of composite proper-subexpression rows.
    """
    leaves = iter(dense)
    nodes: List[Tuple[torch.Tensor, torch.Tensor]] = []  # postorder

    def node(shape) -> torch.Tensor:
        if shape == "T":
            return next(leaves)
        kids = [node(c) for c in shape[1:]]
        if shape[0] == "-":
            out, count = setops.diff_pass(
                kids[0], kids[1], min(capacity, kids[0].shape[1]))
        elif shape[0] == "|":
            out, count = setops.union_pass(
                kids, min(capacity, sum(k.shape[1] for k in kids)))
        else:
            out, count = setops.intersect_pass(
                kids, min(capacity, kids[0].shape[1]))
        nodes.append((out, count))
        return out

    node(eshape)
    max_count = torch.stack([count for _, count in nodes]).max(dim=0).values
    overflow = torch.stack([count > out.shape[1]
                            for out, count in nodes]).any(dim=0)
    root, r = nodes[-1]  # postorder: the root comes last
    return root, r, max_count, overflow, tuple(out for out, _ in nodes[:-1])


def _eval_expr_batch(vals: Sequence[Sequence[torch.Tensor]], eshape,
                     capacity: int):
    """One pass over a same-shape bucket: ``vals[i][b]`` is query b's
    (2^t_i, gmax_i) values of leaf i.  Each leaf's B rows are stacked and
    densified, then the DAG runs (:func:`_eval_expr_block`)."""
    dense = [setops.densify(torch.stack(list(v))) for v in vals]
    return _eval_expr_block(dense, eshape, capacity)


def _expr_spec(dev: torch.device, eshape, ts: Tuple[int, ...],
               gmaxes: Tuple[int, ...], cap: int, n_rows: int) -> Tuple:
    """The specialization an expression pass of ``n_rows`` rows runs."""
    return ("expr", str(dev), eshape, ts, gmaxes, cap, _b_tier(n_rows))


def _compact_u32(row: np.ndarray) -> np.ndarray:
    """A sorted SENTINEL-padded key row -> the sorted uint32 values (the
    serving result format).  Key order is unsigned value order, so the
    real keys are already ascending."""
    flat = row.ravel()
    return setops.to_values_np(flat[flat != setops.SENTINEL])


def dispatch_expr_batch(
    queries: Sequence[Sequence[DeviceSet]],
    eshape,
    capacity: Optional[int] = None,
    sub_keys: Optional[Sequence[Sequence]] = None,
    device: Device = "cuda",
) -> PendingBatch:
    """Enqueue the first pass of a same-shape expression bucket.

    ``queries[i]`` is query i's leaf DeviceSets in the expression's
    traversal order (NOT (t, n)-sorted), all on ``device``; every query
    shares ``eshape`` and the leaf signature.  ``sub_keys[i]`` (optional)
    are query i's canonical subexpression keys, postorder: when given,
    collected stats carry ``"subexprs": [(key, sorted values), ...]`` for
    the serving layer to store.  The collect copies the root rows and every
    composite node's rows to the host.  Counters: ``expr_calls`` per pass,
    ``expr_rerun_calls`` per overflow pass, ``expr_traces`` per first
    sighting of a pass's (shape, signature, capacity, pow2 B-tier).  The
    batch runs at its own size B.
    """
    dev = resolve_device(device)
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    ordered = [list(q) for q in queries]
    ts, gmaxes = _expr_signature(ordered[0])
    for q in ordered:
        if _expr_signature(q) != (ts, gmaxes):
            raise ValueError("bucket mixes expression leaf signatures")
        for s in q:
            if s.device != dev:
                raise ValueError(f"set on {s.device}, bucket runs on {dev}")
    total = expr_total_width(ts, gmaxes)

    def issue(active: List[int], cap: int):
        vals = [[ordered[i][j].vals for i in active] for j in range(len(ts))]
        EXEC_COUNTERS.bump("expr_calls")
        _note_specialization("expr_traces", _expr_spec(
            dev, eshape, ts, gmaxes, cap, len(active)))
        root, r, max_count, overflow, subs = _eval_expr_batch(vals, eshape,
                                                               cap)
        return [root, r, max_count, overflow, *subs], _record_ready(dev)

    first_active = list(range(len(ordered)))
    first_cap = min(capacity or default_expr_capacity(ts, gmaxes), total)
    first_handles, first_ready = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: List[Optional[Tuple[np.ndarray, Dict]]] = [None] * len(ordered)
        active, cap = first_active, first_cap
        handles, ready = first_handles, first_ready
        while True:
            root_h, r_h, maxc_h, over_h, *subs_h = _to_host(handles, ready)
            rerun = []
            for row, qi in enumerate(active):
                if over_h[row]:
                    rerun.append(qi)
                    continue
                stats = {
                    "expr_width": total,
                    "tuples_survived": int(maxc_h[row]),
                    "capacity": cap,
                    "r": int(r_h[row]),
                    "batch_size": len(active),
                }
                if sub_keys is not None:
                    stats["subexprs"] = [
                        (key, _compact_u32(sub[row]))
                        for key, sub in zip(sub_keys[qi], subs_h)
                    ]
                results[qi] = (_compact_u32(root_h[row]), stats)
            if not rerun:
                return results  # type: ignore[return-value]
            active = rerun
            cap = total  # rare path: ONE re-run where no node can truncate
            EXEC_COUNTERS.bump("expr_rerun_calls")
            handles, ready = issue(active, cap)  # the collecting thread's stream

    return PendingBatch(n_queries=len(ordered), handles=first_handles,
                        ready=first_ready, _collect=collect)


def intersect_expr_batch(
    queries: Sequence[Sequence[DeviceSet]],
    eshape,
    capacity: Optional[int] = None,
    sub_keys: Optional[Sequence[Sequence]] = None,
    device: Device = "cuda",
) -> List[Tuple[np.ndarray, Dict]]:
    """A same-shape expression bucket, synchronously (dispatch + collect):
    [(sorted uint32 values, stats), ...] in query order."""
    return dispatch_expr_batch(queries, eshape, capacity=capacity,
                               sub_keys=sub_keys, device=device).collect()


# -- count-only suggestion path ----------------------------------------------
#
# A suggest bucket is B (probe, candidates) rows of one shape class: every
# probe shares (t_p, gmax_p), every candidate (t_c, gmax_c).  One pass
# computes the (B, c_tier) count matrix and each row's top min(k, c_tier)
# (slot, count) pairs under the order (-count, slot); callers list
# candidates by ascending id, so equal counts prefer the smallest id.


def default_k_tier(k: int) -> int:
    """Static top-K selection tier: next power of two, floored at 8.  The
    requested ``k`` quantizes up to a tier so nearby k values share one
    bucket signature; the host slices the top ``k_tier`` list down to k.
    Stored in ``ShapeSig.capacity_tier`` for suggest plans."""
    return 1 << max(3, (int(k) - 1).bit_length())


def _count_signature(queries) -> Tuple[Tuple[int, int], int]:
    """Validate a suggest bucket and return (ts, c_tier): every probe must
    share (t, gmax), every candidate must share (t, gmax), and the
    candidate-axis tier is the pow2 ceiling of the longest row
    (``ShapeSig.cands`` for planned buckets)."""
    probe0, cands0 = queries[0]
    if not len(cands0):
        raise ValueError("suggest rows need at least one candidate")
    tp, gp = probe0.t, probe0.gmax
    tc, gc = cands0[0].t, cands0[0].gmax
    max_c = 0
    for probe, cands in queries:
        if (probe.t, probe.gmax) != (tp, gp):
            raise ValueError("bucket mixes probe shapes")
        if not len(cands):
            raise ValueError("suggest rows need at least one candidate")
        for c in cands:
            if (c.t, c.gmax) != (tc, gc):
                raise ValueError("bucket mixes candidate shapes")
        max_c = max(max_c, len(cands))
    return (tp, tc), 1 << (max_c - 1).bit_length()


def _pack_count_rows(queries, c_tier: int) -> CountTable:
    """A bucket's pointer table: each row's probe mirror and candidate
    mirrors, the candidate axis padded to ``c_tier`` with null slots (the
    kernel skips them; the JAX package repeats candidate 0 there and masks
    it off)."""
    return make_count_table([p.vals for p, _ in queries],
                            [[c.vals for c in cands] for _, cands in queries],
                            (queries[0][0].t, queries[0][1][0].t),
                            c_tier=c_tier)


def _top_k_slots(counts: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k`` over the last axis of (B, C) counts >= -1: (B, k, 2)
    int32 (slot, count) pairs, larger counts first, equal counts by
    ascending slot.

    ``torch.topk`` breaks ties in no fixed order, so it runs on the
    composite key ``((count + 1) << 32) | (C - 1 - slot)``: the keys are
    unique, and their order is exactly (-count, slot).
    """
    C = counts.shape[-1]
    rev_slot = (C - 1) - torch.arange(C, device=counts.device)
    key = ((counts.to(torch.int64) + 1) << 32) | rev_slot
    top = torch.topk(key, k, dim=-1).values
    top_counts = (top >> 32) - 1
    top_idx = (C - 1) - (top & 0xFFFFFFFF)
    return torch.stack([top_idx, top_counts], dim=-1).to(torch.int32)


def _intersect_count_batch(table: CountTable, k_sel: int) -> torch.Tensor:
    """One pass over a packed suggest bucket: (B, k_sel, 2) int32 of
    (slot, count) pairs per row, best-first.  Padding slots carry count -1,
    so they rank after every real candidate, in slot order."""
    counts = ops.count_block(table)                            # (B, C)
    return _top_k_slots(torch.where(table.real, counts, -1), k_sel)


def _collect_count(pairs: torch.Tensor, ready, queries, k_sel: int,
                   extra_stats: Dict) -> List[Tuple[np.ndarray, Dict]]:
    """One copy of the (B, k_sel, 2) pairs to the host, split per row."""
    fetched, = _to_host([pairs], ready)
    return [
        (fetched[row], {"n_cands": len(cands), "k_sel": k_sel,
                        "batch_size": len(queries), **extra_stats})
        for row, (_, cands) in enumerate(queries)
    ]


def dispatch_count_batch(
    queries: Sequence[Tuple[DeviceSet, Sequence[DeviceSet]]],
    k: int,
    device: Device = "cuda",
) -> PendingBatch:
    """Enqueue one count-only suggest bucket without blocking.

    ``queries[i]`` is ``(probe, candidates)``, candidates ordered by
    ascending id by the caller (the tie-break contract), all on
    ``device``.  ``k`` is the selection tier (``ShapeSig.capacity_tier``
    for planned buckets); each row gets its top ``min(k, c_tier)`` (slot,
    count) pairs.  One pass per bucket, counted in ``count_calls``
    (``count_traces`` per first sighting of its specialization); the
    count path has no overflow re-run.  The batch runs at its own size B
    (the JAX package's pow2 B padding only bounded XLA's compile cache).
    """
    dev = resolve_device(device)
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    queries = [(p, list(c)) for p, c in queries]
    ts, c_tier = _count_signature(queries)
    if queries[0][0].device != dev:
        raise ValueError(f"set on {queries[0][0].device}, bucket runs on {dev}")
    k_sel = min(int(k), c_tier)
    table = _pack_count_rows(queries, c_tier)
    EXEC_COUNTERS.bump("count_calls")
    gmaxes = (queries[0][0].gmax, queries[0][1][0].gmax)
    _note_specialization("count_traces", (
        "count", str(dev), ts, gmaxes, c_tier, k_sel, _b_tier(len(queries))))
    pairs = _intersect_count_batch(table, k_sel)
    ready = _record_ready(dev)
    extra = {"c_tier": c_tier, "group_tuples": 1 << max(ts)}
    # the captured ``queries`` hold every mirror the table names until the
    # collect's copy has waited for the pass
    return PendingBatch(
        n_queries=len(queries), handles=pairs, ready=ready,
        _collect=lambda: _collect_count(pairs, ready, queries, k_sel, extra))


def intersect_count_batch(
    queries: Sequence[Tuple[DeviceSet, Sequence[DeviceSet]]],
    k: int,
    device: Device = "cuda",
) -> List[Tuple[np.ndarray, Dict]]:
    """Count-only suggest bucket, synchronously: per row a (k_sel, 2) int32
    array of (candidate index, count) pairs, best-first under (-count,
    smallest index), plus stats (``n_cands``, ``k_sel``, ``batch_size``,
    ``c_tier``, ``group_tuples``).  Padding slots carry count -1; the
    serving layer drops counts < 1."""
    return dispatch_count_batch(queries, k, device=device).collect()


def pow2_tiers(up_to: int) -> Tuple[int, ...]:
    """All power-of-two batch tiers ``(1, 2, 4, ..., up_to)``: warming
    these covers every partial-flush size in ``[1, up_to]``."""
    if up_to < 1 or up_to & (up_to - 1):
        raise ValueError("up_to must be a power of two")
    return tuple(1 << i for i in range(up_to.bit_length()))


def warm_executables(
    representatives: Sequence[Sequence[DeviceSet]],
    b_tiers: Sequence[int] = (1,),
    capacity: Optional[int] = None,
    device: Device = "cuda",
) -> int:
    """Run one query row per shape signature at every batch tier, so the
    first live bucket of up to ``b`` queries meets a specialization already
    seen (tier ``b`` covers live buckets of size in ``(b/2, b]``).  On the
    card this also builds the kernel library and grows the caching
    allocator before live traffic.  Results are discarded.  Bumps
    ``warm_executions`` once per (row, tier) and returns that count."""
    issued = 0
    for row in representatives:
        for b in b_tiers:
            if b < 1 or b & (b - 1):
                raise ValueError("b_tiers must be powers of two")
            intersect_device_batch([list(row)] * b, capacity=capacity,
                                   device=device)
            EXEC_COUNTERS.bump("warm_executions")
            issued += 1
    return issued


def _warm_rerun(row: Sequence[DeviceSet], capacity: Optional[int],
                b_tiers: Sequence[int], device: Device) -> None:
    """Run ``row`` at capacity G at each tier of ``b_tiers`` whose re-run
    specialization is still unseen, bumping ``warm_reruns`` per pass.

    A live bucket re-runs its overflowing queries at capacity G.  When the
    representative fitted its capacity, warming did not run that re-run,
    so a sibling of its signature that overflows would meet it unseen.
    (The JAX package's warming stops before this pass.)"""
    dev = resolve_device(device)
    ordered = sorted(row, key=set_sort_key)
    ts, gmaxes = _signature(ordered)
    G = 1 << ts[-1]
    if (capacity or default_capacity(ts)) >= G:
        return  # no re-run: the first pass already holds every group
    for b in b_tiers:
        if _seen_specialization(_batch_spec(dev, ts, gmaxes, ordered[0].m,
                                            ordered[0].w, G, b)):
            continue
        intersect_device_batch([list(row)] * b, capacity=G, device=device)
        EXEC_COUNTERS.bump("warm_reruns")


def _warm_expr_rerun(row: Sequence[DeviceSet], eshape,
                     capacity: Optional[int], b_tiers: Sequence[int],
                     device: Device) -> None:
    """The expression form of :func:`_warm_rerun`: run ``row`` at the total
    leaf width (an overflowing query's re-run capacity) at each tier of
    ``b_tiers`` whose re-run specialization is still unseen, bumping
    ``warm_reruns`` per pass."""
    dev = resolve_device(device)
    ts, gmaxes = _expr_signature(row)
    total = expr_total_width(ts, gmaxes)
    if min(capacity or default_expr_capacity(ts, gmaxes), total) >= total:
        return  # no re-run: the first pass already runs at the total width
    for b in b_tiers:
        if _seen_specialization(_expr_spec(dev, eshape, ts, gmaxes, total, b)):
            continue
        intersect_expr_batch([list(row)] * b, eshape, capacity=total,
                             device=device)
        EXEC_COUNTERS.bump("warm_reruns")


def warm_from_plans(plans, get_set: Callable[[object], DeviceSet],
                    top_k: int = 8, b_tiers: Sequence[int] = (1,),
                    device: Device = "cuda") -> List:
    """The warming policy over planned queries: count the device-routed
    shape signatures of ``plans`` (``exec.plan.QueryPlan``s), take the
    ``top_k`` most frequent, and run the first plan of each at every tier
    of ``b_tiers``, at the signature's own capacity tier (a learned one
    under an adaptive model), then at the re-run's capacity where that
    specialization is still unseen (:func:`_warm_rerun` /
    :func:`_warm_expr_rerun`, the port's addition).  Expression signatures
    (``sig.eshape`` set) run the expression pass on the plan's leaves in
    traversal order; count signatures (``sig.cands > 0``) run the count
    pass at their top-K tier.  ``get_set`` maps a planned term to its
    DeviceSet.  Returns the warmed signatures, most frequent first."""
    from collections import Counter

    freq = Counter(p.sig for p in plans if p.algorithm == "device")
    rep_terms: Dict = {}
    for p in plans:
        if p.algorithm == "device" and p.sig not in rep_terms:
            rep_terms[p.sig] = p.terms
    warmed = [sig for sig, _ in freq.most_common(top_k)]
    for sig in warmed:
        terms = rep_terms[sig]
        if sig.eshape is not None:
            row = [get_set(t) for t in terms]
            for b in b_tiers:
                intersect_expr_batch([row] * b, sig.eshape,
                                     capacity=sig.capacity_tier,
                                     device=device)
                EXEC_COUNTERS.bump("warm_executions")
            _warm_expr_rerun(row, sig.eshape, sig.capacity_tier, b_tiers,
                             device)
        elif sig.cands > 0:
            row = (get_set(terms[0]), [get_set(t) for t in terms[1:]])
            for b in b_tiers:
                intersect_count_batch([row] * b, sig.capacity_tier,
                                      device=device)
                EXEC_COUNTERS.bump("warm_executions")
        else:
            row = [get_set(t) for t in terms]
            warm_executables([row], b_tiers=b_tiers,
                             capacity=sig.capacity_tier, device=device)
            _warm_rerun(row, sig.capacity_tier, b_tiers, device)
    return warmed


class BatchedEngine:
    """Corpus-level engine: name -> DeviceSet, query bucketing.

    Mutation hooks (:meth:`on_mutate`) fire on every :meth:`add` so owners
    of derived state — the serving layer's result cache — can invalidate.
    """

    def __init__(self, device: Device = "cuda"):
        self.device = resolve_device(device)
        self.sets: Dict[object, DeviceSet] = {}
        self.generation = 0
        self._mutation_hooks: List[Callable[[], None]] = []

    def on_mutate(self, hook: Callable[[], None]) -> None:
        """Register a zero-arg callback fired after every index mutation."""
        self._mutation_hooks.append(hook)

    def add(self, name, idx: PrefixIndex) -> None:
        self.sets[name] = DeviceSet.from_host(idx, self.device)
        self.generation += 1
        for hook in self._mutation_hooks:
            hook()

    def query(self, names: Sequence, capacity: Optional[int] = None):
        return intersect_device([self.sets[n] for n in names],
                                capacity=capacity, device=self.device)

    def query_many(self, queries: Sequence[Sequence]):
        """Plan -> bucket by shape signature -> one pass per bucket ->
        scatter back in request order.  Returns [(values, stats), ...]."""
        from ..exec.batch import execute_name_queries

        return execute_name_queries(self.sets, queries, device=self.device)
