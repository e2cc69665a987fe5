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
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import Device, resolve_device
from ..kernels import ops
from .partition import PrefixIndex

__all__ = [
    "BatchedEngine",
    "DeviceSet",
    "EXEC_COUNTERS",
    "ExecCounters",
    "PendingBatch",
    "default_capacity",
    "dispatch_device_batch",
    "gmax_tier",
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
    - ``result_cache_hits`` / ``result_cache_misses``  result-cache lookups.

    Writes and snapshots serialize on one lock; :meth:`bump` does the whole
    read-modify-write under it.
    """

    _KEYS = (
        "batch_calls", "rerun_calls",
        "inflight_dispatches", "inflight_collects",
        "collect_us", "overlap_high_water",
        "result_cache_hits", "result_cache_misses",
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
