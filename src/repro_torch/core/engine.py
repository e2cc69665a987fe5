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
overflow re-run and assembles the per-query answers.

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
from ..kernels import ops
from ..kernels.count import CountTable, make_count_table
from .partition import PrefixIndex

__all__ = [
    "BatchedEngine",
    "DeviceSet",
    "EXEC_COUNTERS",
    "ExecCounters",
    "PendingBatch",
    "default_capacity",
    "default_k_tier",
    "dispatch_count_batch",
    "dispatch_device_batch",
    "gmax_tier",
    "intersect_count_batch",
    "intersect_device",
    "intersect_device_batch",
    "set_sort_key",
]


class ExecCounters(dict):
    """Telemetry for the batched device path and the serving front end.

    A ``dict`` subclass (``EXEC_COUNTERS["key"]`` reads and writes) with the
    keys this slice bumps, named as in the JAX package:

    - ``batch_calls``  passes of the bucketed pipeline (first passes and
      overflow re-runs);
    - ``rerun_calls``  overflow re-run passes (survivors > capacity);
    - ``inflight_dispatches`` / ``inflight_collects``  buckets dispatched
      through ``exec.batch.dispatch_bucket`` / torn down by their collect
      (equal after any drain);
    - ``collect_us``  cumulative microseconds in the blocking collect;
    - ``overlap_high_water``  most buckets in flight at once;
    - ``result_cache_hits`` / ``result_cache_misses``  result-cache lookups;
    - ``count_calls``  passes of the count-only suggest path;
    - ``suggest_prefilter_in`` / ``suggest_prefilter_kept``  candidates the
      suggest pre-filter examined / kept.

    Writes and snapshots serialize on one lock; :meth:`bump` does the whole
    read-modify-write under it.
    """

    _KEYS = (
        "batch_calls", "rerun_calls",
        "inflight_dispatches", "inflight_collects",
        "collect_us", "overlap_high_water",
        "result_cache_hits", "result_cache_misses",
        "count_calls", "suggest_prefilter_in", "suggest_prefilter_kept",
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

    def snapshot(self) -> dict:
        """A consistent copy of every counter."""
        with self._lock:
            return {k: dict.__getitem__(self, k) for k in self._KEYS}

    def reset(self) -> None:
        with self._lock:
            for key in self._KEYS:
                dict.__setitem__(self, key, 0)


EXEC_COUNTERS = ExecCounters()


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
    ``ready`` is a CUDA event recorded after it (``None`` on the CPU, where
    the pass ran synchronously).  :meth:`collect` copies the results to the
    host, runs any overflow re-run and returns exactly what
    :func:`intersect_device_batch` returns; it is memoized.
    """

    n_queries: int
    ready: Optional[torch.cuda.Event] = None
    _collect: Optional[Callable[[], List[Tuple[np.ndarray, Dict]]]] = None
    _results: Optional[List[Tuple[np.ndarray, Dict]]] = None

    def is_ready(self) -> bool:
        """True when the first pass has finished on the device (a collect
        would not wait for it; an overflow re-run can still add work)."""
        if self._results is not None or self.ready is None:
            return True
        return self.ready.query()

    def collect(self) -> List[Tuple[np.ndarray, Dict]]:
        """Block for the results: [(sorted values, stats), ...] in query
        order."""
        if self._results is None:
            self._results = self._collect()
            self._collect = None  # drop the captured device tensors
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
    overflow pass.

    The batch runs at its own size B.  (The JAX package pads B to a power of
    two to bound XLA's compile cache; eager PyTorch compiles nothing per
    shape, so there is nothing to bound.)
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

    def issue(active: List[int], cap: int):
        vals = [[ordered[i][j].vals for i in active] for j in range(len(ts))]
        images = [[ordered[i][j].images for i in active] for j in range(len(ts))]
        EXEC_COUNTERS.bump("batch_calls")
        handles = _intersect_k_batch(vals, images, ts, cap)
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        return handles, ready

    first_active = list(range(len(ordered)))
    first_cap = capacity or default_capacity(ts)
    first_handles, first_ready = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: List[Optional[Tuple[np.ndarray, Dict]]] = [None] * len(ordered)
        active, cap, handles = first_active, first_cap, first_handles
        while True:
            packed_h, r_h, n_surv_h, over_h = (h.cpu().numpy() for h in handles)
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
            handles, _ = issue(active, cap)

    return PendingBatch(n_queries=len(ordered), ready=first_ready,
                        _collect=collect)


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


def _collect_count(pairs: torch.Tensor, queries, k_sel: int,
                   extra_stats: Dict) -> List[Tuple[np.ndarray, Dict]]:
    """One copy of the (B, k_sel, 2) pairs to the host, split per row."""
    fetched = pairs.cpu().numpy()
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
    count) pairs.  One pass per bucket, counted in ``count_calls``; the
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
    pairs = _intersect_count_batch(table, k_sel)
    ready = None
    if dev.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
    extra = {"c_tier": c_tier, "group_tuples": 1 << max(ts)}
    # the captured ``queries`` hold every mirror the table names until the
    # collect's copy has waited for the pass
    return PendingBatch(
        n_queries=len(queries), ready=ready,
        _collect=lambda: _collect_count(pairs, queries, k_sel, extra))


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
