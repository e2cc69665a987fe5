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
flags (the single-device pass then compacts the buffer's answers into one
flat buffer with row offsets, ``kernels.ops.compact_rows``, a hand-written
CUDA kernel on the card); queries whose survivors exceed ``capacity`` are
re-run once at capacity G.  Results, stats and the ``batch_calls`` / ``rerun_calls``
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
``batch_traces`` / ``count_traces`` (and the sharded, 2-D and expression
families).  A sharded specialization is keyed by its :class:`Mesh` object
too, as a jit is keyed by the mesh it shard_maps over, and by its
per-shard capacity.  :func:`warm_from_plans` runs each hot signature's
representative at every B-tier before live traffic, which on the card
also builds the kernel library and grows the caching allocator; serving
what was warmed then counts no trace.  Warming is the one place the port
differs from the JAX package on purpose: where a representative fits its
capacity, :func:`warm_from_plans` also runs it at its re-run's capacity (G;
the local group count on a mesh), the specialization an overflowing
sibling's re-run needs (counted in ``warm_reruns``; the JAX package has no
such pass, so there that sibling traces at serve time).

The boolean expression path (:func:`dispatch_expr_batch`) runs a bucket of
same-shape ∪/∩/∖ expressions as one pass of sort-merge set passes
(``kernels.setops``, torch ops: they were never Pallas), one per DAG node,
with one re-run of the overflowing queries at the total leaf width.

The count-only suggestion path (:func:`dispatch_count_batch`) runs a bucket
of (probe, candidates) rows as one pass: the (B, C) intersection counts
(``kernels.ops.count_block``, a hand-written CUDA kernel on the card that
reads the mirrors through a pointer table), then a top-K per row.  It has
no filter, no survivor buffer and no re-run.

Sharding: every set is partitioned by the same permutation (Theorem 3.7's
alignment), so equal z-ranges of every set are self-contained and each
pass splits over a :class:`Mesh` of ``torch.device``s with no
communication.  A 1-D mesh (:func:`make_shard_mesh`) z-shards a bucket:
shard s runs the whole pass on its slice of every mirror
(:meth:`DeviceSet.shard` keeps one view per shard), the same kernels at
local shapes, with per-(query, shard) overflow flags and one re-run at the
local group count (:func:`dispatch_sharded_batch`; the count and expression
twins likewise).  A 2-D ``(data, shard)`` mesh (:func:`make_mesh2d`, driven
through ``exec.topology.Topology``) adds replica rows: a bucket's batch
axis splits over the rows, each row runs its slice z-sharded over its own
1-D row mesh (:func:`dispatch_mesh2d_batch`).  A mesh lists its devices
explicitly and may repeat one: shards on one device run one after another
on its current stream, shards on several devices launch under
``torch.cuda.device``, and each device's shard outputs join into one
buffer that reaches the host after that device's own ``ready`` event.
Results, stats and counters equal the JAX package's shard_map pipelines.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import Device, resolve_device
from ..kernels import ops, setops
from ..kernels.count import CountTable, make_count_table
from ..obs.trace import profiler_range
from .partition import PrefixIndex

__all__ = [
    "BatchedEngine",
    "CollectTimes",
    "DATA_AXIS",
    "DeviceSet",
    "EXEC_COUNTERS",
    "ExecCounters",
    "Mesh",
    "PendingBatch",
    "ReplicatedDeviceSet",
    "SHARD_AXIS",
    "SHARD_MIN_G",
    "clear_specializations",
    "default_capacity",
    "default_capacity_per_shard",
    "default_expr_capacity",
    "default_expr_capacity_per_shard",
    "default_k_tier",
    "dispatch_count_batch",
    "dispatch_count_mesh2d_batch",
    "dispatch_count_sharded_batch",
    "dispatch_device_batch",
    "dispatch_expr_batch",
    "dispatch_expr_mesh2d_batch",
    "dispatch_expr_sharded_batch",
    "dispatch_mesh2d_batch",
    "dispatch_sharded_batch",
    "expr_total_width",
    "gmax_tier",
    "intersect_count_batch",
    "intersect_count_mesh2d_batch",
    "intersect_count_sharded_batch",
    "intersect_device",
    "intersect_device_batch",
    "intersect_expr_batch",
    "intersect_expr_mesh2d_batch",
    "intersect_expr_sharded_batch",
    "intersect_mesh2d_batch",
    "intersect_sharded",
    "intersect_sharded_batch",
    "make_mesh2d",
    "make_shard_mesh",
    "pow2_tiers",
    "set_sort_key",
    "warm_executables",
    "warm_from_plans",
]

SHARD_AXIS = "shard"  # the name of the z-sharding mesh axis
DATA_AXIS = "data"    # the name of the data-parallel (replica) axis

# route a query z-sharded only when its largest set has at least this many
# group tuples: 2^12 groups is about a 65k-element set at w = 256, below
# which one device finishes a bucket before a mesh has dispatched it
SHARD_MIN_G = 4096


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
    - ``sharded_calls`` / ``sharded_traces`` / ``sharded_rerun_calls``  the
      same three for the z-sharded pass (:func:`dispatch_sharded_batch`);
    - ``mesh2d_calls`` / ``mesh2d_traces`` / ``mesh2d_rerun_calls``  the
      same three for the 2-D pass (:func:`dispatch_mesh2d_batch`), one
      call per bucket pass; ``mesh2d_row_dispatches`` counts the replica
      rows each pass (and each 2-D count bucket) runs;
    - ``replica_dispatches``  single-device buckets a topology's balancer
      placed on a replica row (``exec/topology.py``);
    - ``inflight_dispatches`` / ``inflight_collects``  buckets dispatched
      through ``exec.batch.dispatch_bucket`` / torn down by their collect
      (equal after any drain);
    - ``collect_us``  cumulative microseconds in the blocking collect;
    - ``collect_wait_us`` / ``collect_copy_us`` / ``collect_filter_us``
      the parts of ``collect_us`` (:class:`CollectTimes`): host
      microseconds blocked on a pass's ``ready`` event in
      :func:`_to_host`, in its copies up to the numpy arrays, and in the
      collect's loop over rows (dropping padding, the sort, the stats), in
      every pipeline (point, expression, count; single-device, sharded and
      2-D).  Their sum never exceeds ``collect_us``; the rest is re-run
      issue and Python;
    - ``d2h_bytes``  bytes of the tensors :func:`_to_host` brings to the
      host, first passes and re-runs alike (on the CPU, where the arrays
      are views, counted all the same): for the single-device pass its
      compacted answers, 4 bytes an id, and its row offsets and stats;
      for the others their whole survivor buffers;
    - ``compact_calls``  answer compactions (``kernels.ops.compact_rows``),
      one per single-device pass, first passes and re-runs;
    - ``pass_device_us``  the device-clock length of each pass: from a
      timing event recorded before its first enqueued op to its ``ready``
      event, summed over the devices it ran on (0 on the CPU).  It includes
      the stream waiting for the host's launches inside the pass, so it is
      not the kernels' busy time, which a profiler trace gives;
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
      expression path (:func:`dispatch_expr_batch` and its sharded and 2-D
      twins);
    - ``subexpr_cache_hits`` / ``subexpr_cache_misses``  lookups of
      canonical subexpression entries (``exec/cache.py::ResultCache.
      get_sub``); ``subexpr_cache_stores``  sub-entries stored;
      ``subexpr_host_merges``  expression queries answered on the host
      from cached subexpressions, with no device work;
    - ``count_calls``  passes of the count-only suggest path (its sharded
      twin included; a 2-D count bucket counts one per replica row);
    - ``suggest_prefilter_in`` / ``suggest_prefilter_kept``  candidates the
      suggest pre-filter examined / kept;
    - ``dispatch_failures``  buckets whose dispatch or collect raised;
    - ``host_plan_us``  host microseconds in
      ``SearchEngine._execute_host_plan`` (HashBin, host RanGroupScan,
      host expressions).

    ``collect_us`` and the five keys after it move once per bucket
    collected through ``exec.batch`` (``InFlightBucket.collect``), in one
    :meth:`bump_many`, so a snapshot sees all of a collect or none of it.

    Writes and snapshots serialize on one lock; :meth:`bump` /
    :meth:`bump_many` do the whole read-modify-write under it.
    """

    _KEYS = (
        "batch_calls", "batch_traces", "rerun_calls",
        "sharded_calls", "sharded_traces", "sharded_rerun_calls",
        "mesh2d_calls", "mesh2d_traces", "mesh2d_rerun_calls",
        "mesh2d_row_dispatches", "replica_dispatches",
        "inflight_dispatches", "inflight_collects",
        "collect_us", "collect_wait_us", "collect_copy_us",
        "collect_filter_us", "d2h_bytes", "pass_device_us",
        "compact_calls", "overlap_high_water",
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
        "dispatch_failures", "host_plan_us",
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


class _Ready:
    """The ready mark of one pass on one device: ``end``, a timing event
    recorded after the pass's last op (what :meth:`query` and
    :meth:`synchronize` act on), and ``start``, one recorded before its
    first."""

    __slots__ = ("start", "end")

    def __init__(self, start: "torch.cuda.Event", end: "torch.cuda.Event"):
        self.start, self.end = start, end

    def query(self) -> bool:
        return self.end.query()

    def synchronize(self) -> None:
        self.end.synchronize()

    def device_us(self) -> float:
        """Device-clock microseconds from ``start`` to ``end``, once met."""
        return self.start.elapsed_time(self.end) * 1e3


def _timing_event(dev: torch.device) -> "torch.cuda.Event":
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return event


def _record_start(dev: torch.device) -> Optional["torch.cuda.Event"]:
    """A timing event before the work about to be issued on ``dev``'s
    current stream (``None`` on the CPU)."""
    return _timing_event(dev) if dev.type == "cuda" else None


def _record_ready(dev: torch.device,
                  start: Optional["torch.cuda.Event"]) -> Optional[_Ready]:
    """The ready mark after the work issued on ``dev``'s current stream
    since ``start`` (``None`` on the CPU, where that work already ran)."""
    if dev.type != "cuda":
        return None
    return _Ready(start, _timing_event(dev))


def _record_starts(devs: Sequence[torch.device]) -> Dict:
    """:func:`_record_start` on each distinct device of ``devs``."""
    return {dev: _record_start(dev) for dev in dict.fromkeys(devs)}


class CollectTimes:
    """Where one bucket's collect went.  ``parts`` holds its host intervals
    ``(name, start_s, end_s)`` on ``time.perf_counter``: ``wait`` (blocked
    on a pass's ready event) and ``copy`` (to the numpy arrays) from
    :func:`_to_host`, and ``filter`` (the collect's loop over rows);
    ``d2h_bytes`` the bytes copied to the host, ``device_us`` the passes'
    device-clock lengths and ``passes`` the passes collected (first passes
    and re-runs)."""

    def __init__(self):
        self.parts: List[Tuple[str, float, float]] = []
        self.d2h_bytes = 0
        self.device_us = 0.0
        self.passes = 0

    @contextlib.contextmanager
    def part(self, name: str):
        """Time the block as part ``name``, inside a ``collect.<name>``
        profiler range."""
        t0 = time.perf_counter()
        with profiler_range("collect." + name):
            yield
        self.parts.append((name, t0, time.perf_counter()))

    def part_us(self, name: str) -> float:
        return sum(b - a for n, a, b in self.parts if n == name) * 1e6

    def counters(self) -> Dict[str, int]:
        """This collect's ``EXEC_COUNTERS`` increments."""
        return {"collect_wait_us": int(self.part_us("wait")),
                "collect_copy_us": int(self.part_us("copy")),
                "collect_filter_us": int(self.part_us("filter")),
                "d2h_bytes": self.d2h_bytes,
                "pass_device_us": int(self.device_us)}


def _copy(tensors: Sequence[torch.Tensor],
          ready: Optional[_Ready]) -> List[np.ndarray]:
    """Host arrays of ``tensors`` once ``ready`` is met (views on the CPU)."""
    if ready is None:
        return [t.numpy() for t in tensors]
    stream = _copy_stream(tensors[0].device)
    with torch.cuda.stream(stream):
        stream.wait_event(ready.end)  # already met: orders the copy after it
        return [t.cpu().numpy() for t in tensors]


def _to_host(tensors: Sequence[torch.Tensor], ready: Optional[_Ready],
             times: CollectTimes, compacted: bool = False) -> List[np.ndarray]:
    """Copy one pass's outputs to the host, waiting for that pass only,
    and note the wait, the copy, the bytes and the pass's device time in
    ``times``.

    On the card the host first waits on ``ready``, then copies on the
    device's side stream.  The side stream is shared by every collecting
    thread, so nothing is queued on it before its pass has finished: a
    copy there can queue behind another thread's copy, never behind a
    pass.  The copies are blocking, so the source tensors stay referenced
    until they are done.

    ``compacted``: ``tensors`` are a compacted pass's (values, offsets,
    ...) (``kernels.ops.compact_rows``); the tensors after the values are
    copied first, then the values up to the last offset, in the same part.
    """
    with times.part("wait"):
        if ready is not None:
            ready.synchronize()
    with times.part("copy"):
        if compacted:
            values, *small = tensors
            small_h = _copy(small, ready)
            host = _copy([values[:int(small_h[0][-1])]], ready) + small_h
        else:
            host = _copy(tensors, ready)
    times.d2h_bytes += sum(a.nbytes for a in host)
    if ready is not None:
        times.device_us += ready.device_us()
    return host


def gmax_tier(gmax: int) -> int:
    """Static-shape tier for a set's max group size: next power of two
    (>= 8).  Device mirrors pad to this, and the planner keys shape
    signatures by it, so exact gmaxes never fragment the buckets."""
    return 1 << max(3, (int(gmax) - 1).bit_length())


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of ``torch.device``s: the port's counterpart of a JAX
    ``Mesh``, for one process driving several devices (not
    ``torch.distributed``).  ``devices`` is a numpy object array with one
    axis per name in ``axis_names``; ``shape[axis]`` reads as in JAX.  The
    grid may repeat a device, which lays several logical shards onto it.

    Compared and hashed by identity: a pass specialization is keyed by the
    mesh object it runs over, as a jit is (``exec.topology.Topology``
    keeps one row mesh per replica row for that reason).
    """

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` of a 1-D mesh, in shard order."""
        if self.axis_names != (axis,):
            raise ValueError(f"need a 1-D mesh over {axis!r}, got axes "
                             f"{self.axis_names}")
        return list(self.devices)


def _device_grid(devices: Sequence[torch.device], shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return grid.reshape(shape)


def _mesh_devices(devices: Optional[Sequence[Device]]) -> List[torch.device]:
    """The devices a mesh may use: the caller's list, each resolved (a
    device may repeat), or every visible CUDA device.  No CPU fallback:
    a CUDA device, asked for or defaulted, raises when there is no GPU."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over the visible CUDA devices needs a GPU; pass "
            "devices=[...] to lay shards out explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_shard_mesh(n_shards: Optional[int] = None, axis: str = SHARD_AXIS,
                    devices: Optional[Sequence[Device]] = None) -> Mesh:
    """1-D mesh of ``n_shards`` devices named ``axis``: the first
    ``n_shards`` of ``devices`` (default: the visible CUDA devices; all of
    them when ``n_shards`` is None).  Raises when there are too few.  A
    device listed several times carries several shards, e.g.
    ``make_shard_mesh(4, devices=["cuda:0"] * 4)`` on a one-GPU machine."""
    devs = _mesh_devices(devices)
    n = len(devs) if n_shards is None else int(n_shards)
    if not 1 <= n <= len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(_device_grid(devs[:n], (n,)), (axis,))


def make_mesh2d(replicas: int, shards: Optional[int] = None,
                data_axis: str = DATA_AXIS, shard_axis: str = SHARD_AXIS,
                devices: Optional[Sequence[Device]] = None) -> Mesh:
    """2-D ``(data, shard)`` mesh: ``replicas`` rows of ``shards`` devices,
    laid out row-major from ``devices`` (default: the visible CUDA
    devices; ``shards`` defaults to spending all of them).  ``replicas``
    must be a power of two, so pow2 batch tiers always split evenly over
    the rows.  ``replicas = 1`` is pure z-sharding, ``shards = 1`` pure
    data parallelism."""
    devs = _mesh_devices(devices)
    replicas = int(replicas)
    if replicas < 1 or replicas & (replicas - 1):
        raise ValueError("replicas must be a power of two (batch tiers are "
                         "pow2)")
    shards = len(devs) // replicas if shards is None else int(shards)
    n = replicas * shards
    if shards < 1 or n > len(devs):
        raise ValueError(f"need {replicas}x{shards} = {n} devices, have "
                         f"{len(devs)}")
    return Mesh(_device_grid(devs[:n], (replicas, shards)),
                (data_axis, shard_axis))


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device for the work issued inside (a
    no-op on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class DeviceSet:
    """Device mirror of a PrefixIndex (sentinel-padded; mask implicit).

    ``vals`` are the original elements as int32 bit patterns (the sentinel
    0xFFFFFFFF is -1), padded to the power-of-two ``gmax`` tier; ``images``
    are the filter images as int32 bit patterns.  A z-sharded mirror
    (:meth:`shard`) also holds its ``mesh`` and, in ``parts``, shard s's
    ``(vals, images)`` z-slice on shard s's device.
    """

    t: int
    gmax: int
    m: int
    w: int
    n: int
    vals: torch.Tensor     # (2^t, gmax) int32 (original values; -1 padding)
    images: torch.Tensor   # (2^t, m, W) int32 bit patterns
    mesh: Optional[Mesh] = None
    parts: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = ()

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

    def shardable(self, n_shards: int) -> bool:
        """True when the z axis splits evenly over ``n_shards``: the
        Theorem 3.7 alignment condition (every shard holds whole z-groups
        of this set)."""
        return n_shards >= 1 and (1 << self.t) % n_shards == 0

    def shard(self, mesh: Mesh, axis: str = SHARD_AXIS) -> "DeviceSet":
        """Z-sharded mirror over the 1-D ``mesh``: shard s's rows
        ``[s * 2^t / n, (s + 1) * 2^t / n)`` of ``vals`` and ``images``,
        moved to shard s's device.  A shard on the mirror's own device is
        a contiguous view and costs no memory.  Built once at index time,
        so no pass pays a per-call split."""
        devs = mesh.axis_devices(axis)
        if not self.shardable(len(devs)):
            raise ValueError(f"2^{self.t} z-groups do not split over "
                             f"{len(devs)} shards")
        gl = (1 << self.t) // len(devs)
        parts = tuple((self.vals[s * gl:(s + 1) * gl].to(dev),
                       self.images[s * gl:(s + 1) * gl].to(dev))
                      for s, dev in enumerate(devs))
        return dataclasses.replace(self, mesh=mesh, parts=parts)

    def place(self, device: Device) -> "DeviceSet":
        """Plain mirror on ``device``: the topology's per-replica-row mirror
        for balancer-placed buckets.  On the mirror's own device it is this
        mirror, tensors and all."""
        dev = resolve_device(device)
        if dev == self.device and self.mesh is None:
            return self
        return dataclasses.replace(self, vals=self.vals.to(dev),
                                   images=self.images.to(dev), mesh=None,
                                   parts=())


def _shard_parts(ds: DeviceSet, mesh: Mesh, axis: str
                 ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """``ds``'s per-shard ``(vals, images)`` on ``mesh``: its own when it is
    a mirror sharded on that mesh, else split now (a plain mirror works,
    at a per-call split)."""
    if ds.mesh is mesh:
        return ds.parts
    return ds.shard(mesh, axis).parts


@dataclasses.dataclass(frozen=True)
class ReplicatedDeviceSet:
    """One set's mirrors on every replica row of a 2-D topology.

    ``rows[r]`` is row r's mirror: z-sharded over the row's mesh when the
    topology has ``shards > 1``, a plain mirror on the row's device
    otherwise.  Exposes row 0's ``t`` / ``gmax`` / ``n`` / ``m`` / ``w``
    (equal on every row), so the ``(t, n)`` sort and the signature checks
    treat it as a :class:`DeviceSet`.
    """

    rows: Tuple[DeviceSet, ...]

    def row(self, r: int) -> DeviceSet:
        return self.rows[r]

    @property
    def t(self) -> int:
        return self.rows[0].t

    @property
    def gmax(self) -> int:
        return self.rows[0].gmax

    @property
    def n(self) -> int:
        return self.rows[0].n

    @property
    def m(self) -> int:
        return self.rows[0].m

    @property
    def w(self) -> int:
        return self.rows[0].w


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


def default_capacity_per_shard(ts: Tuple[int, ...], n_shards: int,
                               capacity: Optional[int] = None) -> int:
    """Per-shard survivor-buffer tier of the sharded pass: the whole-query
    budget (``capacity`` when given, e.g. a learned
    ``ShapeSig.capacity_tier``, else :func:`default_capacity`) divided over
    the shards (``g`` spreads survivors evenly over z), floored at 16, and
    never past the local group count ``G / n_shards``."""
    local_g = (1 << ts[-1]) // n_shards
    whole = default_capacity(ts) if capacity is None else int(capacity)
    return min(local_g, max(16, whole // n_shards))


def _aligned_images(images: Sequence[Sequence[torch.Tensor]],
                    ts: Tuple[int, ...]) -> torch.Tensor:
    """Prefix-aligned images of a bucket: ``images[i][b]`` is query b's
    (2^{t_i}, m, W) images of its i-th set; returns (B, k, G, m, W) with
    G = 2^{t_k}, set i's row z_i = z >> (t_k - t_i) repeated at every z.
    On one shard's z-slices ((2^{t_i} / n, m, W) each) it returns that
    shard's (B, k, G / n, m, W): the shift does not depend on the shard.

    Each query's images are copied straight into their slot of the output
    (one broadcast copy per set and query), so no (B, G_i, m, W) stack is
    made on the way.
    """
    tk = ts[-1]
    first = images[0][0]
    G = first.shape[0] << (tk - ts[0])
    B = len(images[0])
    m, W = first.shape[1:]
    out = torch.empty((B, len(ts), G, m, W), dtype=first.dtype,
                      device=first.device)
    for i, (per_query, t) in enumerate(zip(images, ts)):
        rep = 1 << (tk - t)
        g = G // rep
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
    ``images[i][b]``: its (2^{t_i}, m, W) images (or one shard's z-slices of
    both, :func:`_local_shard_block`).  Returns (packed, r, n_surv,
    overflow) with a leading B axis each.

    The values are never stacked whole: each query's survivor rows
    (``surv >> (t_k - t_i)``) are gathered from its own tensor and only the
    gathered (B, capacity, g_i) rows are stacked.
    """
    tk = ts[-1]
    with profiler_range("phase1.stack"):
        stacked = _aligned_images(images, ts)
    with profiler_range("phase1.filter"):
        passed = ops.bitmap_filter(stacked)                     # (B, G)
        del stacked  # the stack is the pass's largest tensor: free it here
        n_surv = passed.sum(dim=1)
    with profiler_range("phase2"):
        G = passed.shape[1]
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
        # pack values and mask into one buffer (-1 = dropped): compacted on
        # the device by the single-device pass, copied whole by the others
        packed = torch.where(keep, base, -1)
    return packed, r, n_surv, overflow


def _signature(sets: Sequence[DeviceSet]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    return tuple(s.t for s in sets), tuple(s.gmax for s in sets)


@dataclasses.dataclass
class PendingBatch:
    """In-flight handle for one dispatched bucket pass.

    The pass is enqueued on the device's stream when dispatch returns;
    ``handles`` are its output tensors and ``ready`` a CUDA event recorded
    after it (``None`` on the CPU, where the pass ran synchronously), or a
    list of such events, one per device a sharded pass ran on.
    :meth:`collect` copies the results to the host (waiting on ``ready``
    only), runs any overflow re-run and returns exactly what
    :func:`intersect_device_batch` returns; it is memoized.  ``times``
    records where the collect went (:class:`CollectTimes`).
    """

    n_queries: int
    handles: object = None
    ready: object = None
    times: CollectTimes = dataclasses.field(default_factory=CollectTimes)
    _collect: Optional[Callable[[], List[Tuple[np.ndarray, Dict]]]] = None
    _results: Optional[List[Tuple[np.ndarray, Dict]]] = None

    def is_ready(self) -> bool:
        """True when the first pass has finished on the device (a collect
        would not wait for it; an overflow re-run can still add work).
        Never blocks."""
        if self._results is not None:
            return True
        events = self.ready if isinstance(self.ready, list) else [self.ready]
        return all(e is None or e.query() for e in events)

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
    (signature, capacity, pow2 B-tier), ``compact_calls`` per pass.

    Each pass ends with ``kernels.ops.compact_rows``: its answers, overflow
    rows left out, in one flat buffer with row offsets, so the collect
    copies the offsets and stats, then the answers alone.

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
    times = CollectTimes()

    def issue(active: List[int], cap: int):
        vals = [[ordered[i][j].vals for i in active] for j in range(len(ts))]
        images = [[ordered[i][j].images for i in active] for j in range(len(ts))]
        EXEC_COUNTERS.bump("batch_calls")
        _note_specialization("batch_traces", _batch_spec(
            dev, ts, gmaxes, m, w, cap, len(active)))
        start = _record_start(dev)
        packed, r, n_surv, overflow = _intersect_k_batch(vals, images, ts, cap)
        values, offsets = ops.compact_rows(packed, ~overflow)
        del packed  # queued: the compaction keeps its block on this stream
        EXEC_COUNTERS.bump("compact_calls")
        return (values, offsets, r, n_surv, overflow), _record_ready(dev, start)

    first_active = list(range(len(ordered)))
    first_cap = capacity or default_capacity(ts)
    first_handles, first_ready = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: List[Optional[Tuple[np.ndarray, Dict]]] = [None] * len(ordered)
        active, cap = first_active, first_cap
        handles, ready = first_handles, first_ready
        while True:
            times.passes += 1
            values_h, off_h, r_h, n_surv_h, over_h = _to_host(
                handles, ready, times, compacted=True)
            rerun = []
            with times.part("filter"):
                for row, qi in enumerate(active):
                    if over_h[row]:
                        rerun.append(qi)
                        continue
                    out = values_h[off_h[row]:off_h[row + 1]]
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
                        ready=first_ready, times=times, _collect=collect)


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


# -- z-sharded and 2-D execution -------------------------------------------------
#
# A sharded pass runs the single-device pass once per shard, on the shard's
# z-slice of every mirror, with the same kernels at local shapes: Theorem
# 3.7's alignment maps shard s's z range of the deepest set into shard s's
# range of every other set, so nothing crosses shards.  The outputs of the
# shards on one device join into one buffer per output (result rows along
# the capacity or width axis, per-shard scalars stacked on a leading shard
# axis) that reaches the host after that device's own event.  The order of
# shards in a join is immaterial: values are sorted at collect and stats
# sum, max or any over the shard axis.
#
# A 2-D pass splits a bucket's B-tier, floored at the replica count, into
# equal contiguous slices, one per replica row; a row runs its slice as a
# sharded pass over its own row mesh (or the plain pass on its device when
# the topology has one shard), and a slice of padding only is never run.
# ``topology`` is an ``exec.topology.Topology`` (``replicas``, ``shards``,
# ``shard_axis``, ``row_mesh(r)``, ``replica_device(r)``).

# join axis of each output of a flat pass: packed rows along the capacity
# axis; r, n_surv and overflow stacked on a leading shard axis
_FLAT_JOIN = (1, None, None, None)


def _join_shards(outs: Sequence[Sequence[torch.Tensor]],
                 devs: Sequence[torch.device], join: Sequence[Optional[int]],
                 starts: Dict):
    """Join per-shard outputs device by device: ``outs[s]`` are shard s's
    output tensors on ``devs[s]``; output j of one device's shards is
    concatenated along ``join[j]``, or stacked on a new leading axis where
    that is None.  Returns ``[(tensors, ready), ...]``, one per device, each
    with the ready mark recorded after its own join, timed from that
    device's event in ``starts`` (:func:`_record_starts`)."""
    by_dev: Dict[torch.device, List[int]] = {}
    for s, dev in enumerate(devs):
        by_dev.setdefault(dev, []).append(s)
    joined = []
    for dev, ids in by_dev.items():
        with _on(dev):
            tensors = [torch.stack([outs[s][j] for s in ids]) if dim is None
                       else torch.cat([outs[s][j] for s in ids], dim=dim)
                       for j, dim in enumerate(join)]
            joined.append((tensors, _record_ready(dev, starts[dev])))
    return joined


def _fetch_joined(joined, join: Sequence[Optional[int]],
                  times: CollectTimes) -> List[np.ndarray]:
    """Host copies of a sharded pass's outputs: each device's join is copied
    after its own event (:func:`_to_host`), then the devices' copies are
    concatenated along the same axes."""
    host = [_to_host(tensors, ready, times) for tensors, ready in joined]
    if len(host) == 1:
        return host[0]
    return [np.concatenate([h[j] for h in host],
                           axis=0 if dim is None else dim)
            for j, dim in enumerate(join)]


def _events(joined) -> list:
    return [ready for _, ready in joined]


def _flat_signature(ordered) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    ts, gmaxes = _signature(ordered[0])
    for q in ordered:
        if _signature(q) != (ts, gmaxes):
            raise ValueError("bucket mixes shape signatures")
    return ts, gmaxes


def _sharded_spec(counter: str, mesh: Mesh, ts, gmaxes, m: int, w: int,
                  cap: int, n_rows: int) -> Tuple:
    """The specialization a sharded point pass of ``n_rows`` rows runs on
    ``mesh`` (the counter is part of it, as a jit's ``trace_counter``)."""
    return ("sharded", counter, mesh, ts, gmaxes, m, w, cap, _b_tier(n_rows))


def _local_shard_block(vals, images, ts: Tuple[int, ...],
                       capacity_per_shard: int):
    """One shard's two-phase pass: :func:`_intersect_k_batch` on the
    shard's z-slices (``vals[i][b]`` (2^t_i / n, gmax_i), ``images[i][b]``
    (2^t_i / n, m, W)).  The caller clamps the per-shard capacity to the
    local group count, so the survivor buffer never pads."""
    g_local = images[-1][0].shape[0]
    if capacity_per_shard > g_local:
        raise ValueError(f"per-shard capacity {capacity_per_shard} exceeds "
                         f"the local group count {g_local}")
    return _intersect_k_batch(vals, images, ts, capacity_per_shard)


def _intersect_k_sharded_batch(parts, ts: Tuple[int, ...],
                               devs: Sequence[torch.device],
                               capacity_per_shard: int):
    """One z-sharded pass: ``parts[i][b]`` is query b's per-shard ``(vals,
    images)`` of set i.  Shard s runs :func:`_local_shard_block` on
    ``devs[s]`` (shards sharing a device run one after another on its
    current stream).  Returns the device joins of (packed (B, n * cap,
    g_0), r, n_surv, overflow (n, B))."""
    starts = _record_starts(devs)
    outs = []
    for s, dev in enumerate(devs):
        with _on(dev):
            outs.append(_local_shard_block(
                [[p[s][0] for p in per_query] for per_query in parts],
                [[p[s][1] for p in per_query] for per_query in parts],
                ts, capacity_per_shard))
    return _join_shards(outs, devs, _FLAT_JOIN, starts)


def _flat_shard_result(packed_row: np.ndarray, r_col: np.ndarray,
                       surv_col: np.ndarray, **stats):
    """One query's answer from a sharded pass: its values off every shard,
    sorted, and the stats summed (``r``, ``tuples_survived``) or maxed
    (``max_shard_survivors``) over the shard axis."""
    row_vals = packed_row.ravel()
    out = row_vals[row_vals != -1]
    return np.sort(out.view(np.uint32)), {
        "tuples_survived": int(surv_col.sum()),
        "max_shard_survivors": int(surv_col.max()),
        "r": int(r_col.sum()), **stats}


def dispatch_sharded_batch(
    queries: Sequence[Sequence[DeviceSet]],
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    capacity_per_shard: Optional[int] = None,
) -> PendingBatch:
    """Enqueue the first z-sharded pass of a same-signature bucket.

    The sharded twin of :func:`dispatch_device_batch` over the 1-D
    ``mesh``: the smallest set's 2^t must split over the shards, and each
    shard compacts its own survivors into a ``capacity_per_shard`` buffer
    (default :func:`default_capacity_per_shard`, clamped to the local group
    count G / n).  A query whose survivors exceed it on ANY shard re-runs
    once, in a subset pass at G / n, where no shard can overflow.  Pass
    z-sharded mirrors (:meth:`DeviceSet.shard` on ``mesh``); plain mirrors
    are split per call.  Counters: ``sharded_calls`` per pass,
    ``sharded_rerun_calls`` per re-run, ``sharded_traces`` per first
    sighting of (mesh, signature, per-shard capacity, pow2 B-tier).  Stats
    add ``max_shard_survivors``, ``capacity_per_shard`` and ``n_shards``.
    """
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    devs = mesh.axis_devices(axis)
    n_shards = len(devs)
    ordered = [sorted(q, key=set_sort_key) for q in queries]
    ts, gmaxes = _flat_signature(ordered)
    if (1 << ts[0]) % n_shards:
        raise ValueError(f"smallest set (t={ts[0]}) does not split over "
                         f"{n_shards} shards")
    G = 1 << ts[-1]
    G_local = G // n_shards
    m, w = ordered[0][0].m, ordered[0][0].w
    parts = [[_shard_parts(s, mesh, axis) for s in q] for q in ordered]
    times = CollectTimes()

    def issue(active: List[int], cap: int):
        EXEC_COUNTERS.bump("sharded_calls")
        _note_specialization("sharded_traces", _sharded_spec(
            "sharded_traces", mesh, ts, gmaxes, m, w, cap, len(active)))
        return _intersect_k_sharded_batch(
            [[parts[i][j] for i in active] for j in range(len(ts))], ts,
            devs, cap)

    first_active = list(range(len(ordered)))
    first_cap = min(capacity_per_shard
                    or default_capacity_per_shard(ts, n_shards), G_local)
    first = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: List[Optional[Tuple[np.ndarray, Dict]]] = [None] * len(ordered)
        active, cap, joined = first_active, first_cap, first
        while True:
            times.passes += 1
            packed_h, r_h, n_surv_h, over_h = _fetch_joined(joined, _FLAT_JOIN,
                                                            times)
            rerun = []
            with times.part("filter"):
                for row, qi in enumerate(active):
                    if over_h[:, row].any():
                        rerun.append(qi)
                        continue
                    results[qi] = _flat_shard_result(
                        packed_h[row], r_h[:, row], n_surv_h[:, row],
                        group_tuples=G, capacity_per_shard=cap,
                        n_shards=n_shards, batch_size=len(active))
            if not rerun:
                return results  # type: ignore[return-value]
            active = rerun
            cap = G_local  # rare path: one re-run at local G, no overflow
            EXEC_COUNTERS.bump("sharded_rerun_calls")
            joined = issue(active, cap)

    return PendingBatch(n_queries=len(ordered), handles=first,
                        ready=_events(first), times=times, _collect=collect)


def intersect_sharded_batch(
    queries: Sequence[Sequence[DeviceSet]],
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    capacity_per_shard: Optional[int] = None,
) -> List[Tuple[np.ndarray, Dict]]:
    """A same-signature bucket z-sharded over ``mesh``, synchronously:
    [(sorted uint32 values, stats), ...] in query order, equal to
    :func:`intersect_device_batch`'s values."""
    return dispatch_sharded_batch(
        queries, mesh, axis=axis,
        capacity_per_shard=capacity_per_shard).collect()


def intersect_sharded(sets: Sequence[DeviceSet], mesh: Mesh,
                      axis: str = SHARD_AXIS,
                      capacity_per_shard: Optional[int] = None):
    """Intersect k device sets z-sharded over ``mesh``: a batch of one.
    Returns (values, stats)."""
    (result, stats), = intersect_sharded_batch(
        [list(sets)], mesh, axis=axis, capacity_per_shard=capacity_per_shard)
    return result, stats


def _mesh2d_rows(n_replicas: int, n_active: int):
    """The 2-D layout of ``n_active`` queries: the pow2 B-tier, floored at
    the replica count, splits into ``n_replicas`` equal slices.  Returns
    (slice_len, [(row, lo, hi), ...]) for the rows whose slice
    ``active[lo:hi]`` holds a real query."""
    slice_len = max(n_replicas, _b_tier(n_active)) // n_replicas
    return slice_len, [(rr, rr * slice_len,
                        min(n_active, (rr + 1) * slice_len))
                       for rr in range(n_replicas)
                       if rr * slice_len < n_active]


def _mesh2d_spec(topology, rr: int, ts, gmaxes, m: int, w: int, cap: int,
                 slice_len: int) -> Tuple:
    """The specialization row ``rr`` of a 2-D point pass runs: the sharded
    pass on the row's mesh, or (one shard) the plain pass, which, as a jit
    over committed arrays, is not keyed by the row's device."""
    if topology.shards > 1:
        return _sharded_spec("mesh2d_traces", topology.row_mesh(rr), ts,
                             gmaxes, m, w, cap, slice_len)
    return ("mesh2d", ts, gmaxes, m, w, cap, slice_len)


def _row_device(topology, rr: int, sets: Sequence[DeviceSet]) -> torch.device:
    """Row ``rr``'s device, which every plain row mirror must be on."""
    dev = resolve_device(topology.replica_device(rr))
    for s in sets:
        if s.device != dev:
            raise ValueError(f"row {rr} mirror on {s.device}, row runs on "
                             f"{dev}")
    return dev


def dispatch_mesh2d_batch(
    queries: Sequence[Sequence[ReplicatedDeviceSet]],
    topology,
    capacity_per_shard: Optional[int] = None,
) -> PendingBatch:
    """Enqueue the first 2-D ``(data, shard)`` pass of a bucket.

    ``queries[i][j]`` is a :class:`ReplicatedDeviceSet`; replica row r runs
    its contiguous slice of the bucket on ``row(r)``'s mirrors, z-sharded
    over ``topology.row_mesh(r)`` (the plain pass on the row's device when
    ``shards == 1``).  Every row is issued before any is collected.
    Overflow is per (query, shard), with one re-run at the local group
    count, as in :func:`dispatch_sharded_batch`.  Counters:
    ``mesh2d_calls`` per pass, ``mesh2d_row_dispatches`` per row run,
    ``mesh2d_rerun_calls`` per re-run, ``mesh2d_traces`` per first
    sighting of a row's specialization.  Stats add ``n_replicas`` and the
    ``replica`` that ran the query.
    """
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    n_replicas, n_shards = topology.replicas, topology.shards
    axis = topology.shard_axis
    if n_replicas & (n_replicas - 1):
        raise ValueError("the data axis must be a power of two")
    ordered = [sorted(q, key=set_sort_key) for q in queries]
    ts, gmaxes = _flat_signature(ordered)
    if (1 << ts[0]) % n_shards:
        raise ValueError(f"smallest set (t={ts[0]}) does not split over "
                         f"{n_shards} shards")
    G = 1 << ts[-1]
    G_local = G // n_shards
    m, w = ordered[0][0].m, ordered[0][0].w
    times = CollectTimes()

    def issue(active: List[int], cap: int):
        slice_len, layout = _mesh2d_rows(n_replicas, len(active))
        EXEC_COUNTERS.bump("mesh2d_calls")
        handles = {}
        for rr, lo, hi in layout:
            EXEC_COUNTERS.bump("mesh2d_row_dispatches")
            _note_specialization("mesh2d_traces", _mesh2d_spec(
                topology, rr, ts, gmaxes, m, w, cap, slice_len))
            rows = [[ordered[i][j].row(rr) for i in active[lo:hi]]
                    for j in range(len(ts))]
            if n_shards > 1:
                mesh = topology.row_mesh(rr)
                handles[rr] = _intersect_k_sharded_batch(
                    [[_shard_parts(s, mesh, axis) for s in per] for per in rows],
                    ts, mesh.axis_devices(axis), cap)
            else:
                dev = _row_device(topology, rr, [s for per in rows for s in per])
                starts = _record_starts([dev])
                with _on(dev):
                    out = _intersect_k_batch(
                        [[s.vals for s in per] for per in rows],
                        [[s.images for s in per] for per in rows], ts, cap)
                handles[rr] = _join_shards([out], [dev], _FLAT_JOIN, starts)
        return handles, slice_len

    first_active = list(range(len(ordered)))
    first_cap = min(capacity_per_shard
                    or default_capacity_per_shard(ts, n_shards), G_local)
    first_handles, first_slice = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: List[Optional[Tuple[np.ndarray, Dict]]] = [None] * len(ordered)
        active, cap = first_active, first_cap
        handles, slice_len = first_handles, first_slice
        while True:
            # one collection point: every row was issued before any copy
            times.passes += 1
            rerun = []
            for rr, joined in handles.items():
                packed_h, r_h, n_surv_h, over_h = _fetch_joined(
                    joined, _FLAT_JOIN, times)
                with times.part("filter"):
                    for local in range(packed_h.shape[0]):
                        qi = active[rr * slice_len + local]
                        if over_h[:, local].any():
                            rerun.append(qi)
                            continue
                        results[qi] = _flat_shard_result(
                            packed_h[local], r_h[:, local],
                            n_surv_h[:, local], group_tuples=G,
                            capacity_per_shard=cap, n_shards=n_shards,
                            n_replicas=n_replicas, replica=rr,
                            batch_size=len(active))
            if not rerun:
                return results  # type: ignore[return-value]
            active = rerun
            cap = G_local  # rare path: one re-run at local G, no overflow
            EXEC_COUNTERS.bump("mesh2d_rerun_calls")
            handles, slice_len = issue(active, cap)

    return PendingBatch(
        n_queries=len(ordered), handles=first_handles,
        ready=[e for joined in first_handles.values() for e in _events(joined)],
        times=times, _collect=collect)


def intersect_mesh2d_batch(
    queries: Sequence[Sequence[ReplicatedDeviceSet]],
    topology,
    capacity_per_shard: Optional[int] = None,
) -> List[Tuple[np.ndarray, Dict]]:
    """A same-signature bucket over a 2-D topology, synchronously:
    [(sorted uint32 values, stats), ...] in query order (see
    :func:`dispatch_mesh2d_batch`)."""
    return dispatch_mesh2d_batch(
        queries, topology, capacity_per_shard=capacity_per_shard).collect()


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


def default_expr_capacity_per_shard(ts: Tuple[int, ...],
                                    gmaxes: Tuple[int, ...], n_shards: int,
                                    capacity: Optional[int] = None) -> int:
    """Per-shard node-buffer tier of the sharded expression pass: the
    expression analogue of :func:`default_capacity_per_shard` (the whole
    budget over the shards, floored at 16, never past the local total leaf
    width)."""
    local_total = expr_total_width(ts, gmaxes) // n_shards
    whole = (default_expr_capacity(ts, gmaxes) if capacity is None
             else int(capacity))
    return min(local_total, max(16, whole // n_shards))


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
    times = CollectTimes()

    def issue(active: List[int], cap: int):
        vals = [[ordered[i][j].vals for i in active] for j in range(len(ts))]
        EXEC_COUNTERS.bump("expr_calls")
        _note_specialization("expr_traces", _expr_spec(
            dev, eshape, ts, gmaxes, cap, len(active)))
        start = _record_start(dev)
        root, r, max_count, overflow, subs = _eval_expr_batch(vals, eshape,
                                                               cap)
        return ([root, r, max_count, overflow, *subs],
                _record_ready(dev, start))

    first_active = list(range(len(ordered)))
    first_cap = min(capacity or default_expr_capacity(ts, gmaxes), total)
    first_handles, first_ready = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: List[Optional[Tuple[np.ndarray, Dict]]] = [None] * len(ordered)
        active, cap = first_active, first_cap
        handles, ready = first_handles, first_ready
        while True:
            times.passes += 1
            root_h, r_h, maxc_h, over_h, *subs_h = _to_host(handles, ready,
                                                            times)
            rerun = []
            with times.part("filter"):
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
                        ready=first_ready, times=times, _collect=collect)


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


def _expr_join(n_outputs: int) -> Tuple[Optional[int], ...]:
    """Join axis of each output of an expression pass: root and sub rows
    along the width axis; r, max count and overflow stacked per shard."""
    return (1, None, None, None) + (1,) * (n_outputs - 4)


def _expr_sharded_spec(mesh: Mesh, eshape, ts, gmaxes, cap: int,
                       n_rows: int) -> Tuple:
    """The specialization a sharded expression pass runs on ``mesh``."""
    return ("expr-sharded", mesh, eshape, ts, gmaxes, cap, _b_tier(n_rows))


def _eval_expr_sharded_batch(parts, eshape, devs: Sequence[torch.device],
                             capacity_per_shard: int):
    """One z-sharded expression pass: ``parts[i][b]`` is query b's
    per-shard ``(vals, images)`` of leaf i; shard s evaluates the whole DAG
    on its z-slices (``g`` aligns every leaf, so ∪/∩/∖ distribute over
    z-ranges).  Returns the device joins of (root, r, max_count, overflow,
    *subs)."""
    starts = _record_starts(devs)
    outs = []
    for s, dev in enumerate(devs):
        with _on(dev):
            root, r, maxc, over, subs = _eval_expr_batch(
                [[p[s][0] for p in per_query] for per_query in parts],
                eshape, capacity_per_shard)
            outs.append((root, r, maxc, over, *subs))
    return _join_shards(outs, devs, _expr_join(len(outs[0])), starts)


def _expr_shard_results(fetched, rows, sub_keys, **stats):
    """Per-query answers of a sharded expression pass: ``fetched`` are the
    host copies of (root, r, max_count, overflow, *subs), ``rows`` the
    (row, query) pairs to read.  Returns (results by query, queries to
    re-run).  Shard segments are each sorted, so the values sort again."""
    root_h, r_h, maxc_h, over_h, *subs_h = fetched
    out, rerun = {}, []
    for row, qi in rows:
        if over_h[:, row].any():
            rerun.append(qi)
            continue
        st = {"tuples_survived": int(maxc_h[:, row].sum()),
              "max_shard_survivors": int(maxc_h[:, row].max()),
              "r": int(r_h[:, row].sum()), **stats}
        if sub_keys is not None:
            st["subexprs"] = [(key, np.sort(_compact_u32(sub[row])))
                              for key, sub in zip(sub_keys[qi], subs_h)]
        out[qi] = (np.sort(_compact_u32(root_h[row])), st)
    return out, rerun


def _expr_mesh_signature(ordered, n_shards: int):
    ts, gmaxes = _expr_signature(ordered[0])
    for q in ordered:
        if _expr_signature(q) != (ts, gmaxes):
            raise ValueError("bucket mixes expression leaf signatures")
    if any((1 << t) % n_shards for t in ts):
        raise ValueError(f"every leaf must split over {n_shards} shards")
    return ts, gmaxes


def dispatch_expr_sharded_batch(
    queries: Sequence[Sequence[DeviceSet]],
    eshape,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    capacity_per_shard: Optional[int] = None,
    sub_keys: Optional[Sequence[Sequence]] = None,
) -> PendingBatch:
    """Enqueue the first z-sharded pass of an expression bucket: the
    expression twin of :func:`dispatch_sharded_batch`.  Every leaf's 2^t
    must split over ``mesh``; overflow is per (query, shard), with one
    re-run at the local total leaf width.  Counters as
    :func:`dispatch_expr_batch`'s; stats add ``max_shard_survivors``,
    ``capacity_per_shard`` and ``n_shards``."""
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    devs = mesh.axis_devices(axis)
    n_shards = len(devs)
    ordered = [list(q) for q in queries]
    ts, gmaxes = _expr_mesh_signature(ordered, n_shards)
    total = expr_total_width(ts, gmaxes)
    local_total = total // n_shards
    parts = [[_shard_parts(s, mesh, axis) for s in q] for q in ordered]
    times = CollectTimes()

    def issue(active: List[int], cap: int):
        EXEC_COUNTERS.bump("expr_calls")
        _note_specialization("expr_traces", _expr_sharded_spec(
            mesh, eshape, ts, gmaxes, cap, len(active)))
        return _eval_expr_sharded_batch(
            [[parts[i][j] for i in active] for j in range(len(ts))], eshape,
            devs, cap)

    first_active = list(range(len(ordered)))
    first_cap = min(capacity_per_shard or default_expr_capacity_per_shard(
        ts, gmaxes, n_shards), local_total)
    first = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: Dict[int, Tuple[np.ndarray, Dict]] = {}
        active, cap, joined = first_active, first_cap, first
        while True:
            times.passes += 1
            fetched = _fetch_joined(joined, _expr_join(len(joined[0][0])),
                                    times)
            with times.part("filter"):
                out, rerun = _expr_shard_results(
                    fetched, list(enumerate(active)), sub_keys,
                    expr_width=total, capacity_per_shard=cap,
                    n_shards=n_shards, batch_size=len(active))
            results.update(out)
            if not rerun:
                return [results[qi] for qi in range(len(ordered))]
            active = rerun
            cap = local_total  # one re-run at the local total: no overflow
            EXEC_COUNTERS.bump("expr_rerun_calls")
            joined = issue(active, cap)

    return PendingBatch(n_queries=len(ordered), handles=first,
                        ready=_events(first), times=times, _collect=collect)


def dispatch_expr_mesh2d_batch(
    queries: Sequence[Sequence[ReplicatedDeviceSet]],
    eshape,
    topology,
    capacity_per_shard: Optional[int] = None,
    sub_keys: Optional[Sequence[Sequence]] = None,
) -> PendingBatch:
    """Enqueue the first 2-D pass of an expression bucket: the expression
    twin of :func:`dispatch_mesh2d_batch` (each replica row runs its slice
    z-sharded over its row mesh, or the plain pass on its device when
    ``shards == 1``).  ``expr_calls`` counts one per pass; stats add
    ``n_replicas`` and ``replica``."""
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    n_replicas, n_shards = topology.replicas, topology.shards
    axis = topology.shard_axis
    if n_replicas & (n_replicas - 1):
        raise ValueError("the data axis must be a power of two")
    ordered = [list(q) for q in queries]
    ts, gmaxes = _expr_mesh_signature(ordered, n_shards)
    total = expr_total_width(ts, gmaxes)
    local_total = total // n_shards
    times = CollectTimes()

    def issue(active: List[int], cap: int):
        slice_len, layout = _mesh2d_rows(n_replicas, len(active))
        EXEC_COUNTERS.bump("expr_calls")
        handles = {}
        for rr, lo, hi in layout:
            rows = [[ordered[i][j].row(rr) for i in active[lo:hi]]
                    for j in range(len(ts))]
            if n_shards > 1:
                mesh = topology.row_mesh(rr)
                _note_specialization("expr_traces", _expr_sharded_spec(
                    mesh, eshape, ts, gmaxes, cap, slice_len))
                handles[rr] = _eval_expr_sharded_batch(
                    [[_shard_parts(s, mesh, axis) for s in per] for per in rows],
                    eshape, mesh.axis_devices(axis), cap)
            else:
                dev = _row_device(topology, rr, [s for per in rows for s in per])
                _note_specialization("expr_traces", _expr_spec(
                    dev, eshape, ts, gmaxes, cap, slice_len))
                starts = _record_starts([dev])
                with _on(dev):
                    root, r, maxc, over, subs = _eval_expr_batch(
                        [[s.vals for s in per] for per in rows], eshape, cap)
                out = (root, r, maxc, over, *subs)
                handles[rr] = _join_shards([out], [dev], _expr_join(len(out)),
                                           starts)
        return handles, slice_len

    first_active = list(range(len(ordered)))
    first_cap = min(capacity_per_shard or default_expr_capacity_per_shard(
        ts, gmaxes, n_shards), local_total)
    first_handles, first_slice = issue(first_active, first_cap)

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        results: Dict[int, Tuple[np.ndarray, Dict]] = {}
        active, cap = first_active, first_cap
        handles, slice_len = first_handles, first_slice
        while True:
            times.passes += 1
            rerun = []
            for rr, joined in handles.items():
                fetched = _fetch_joined(joined, _expr_join(len(joined[0][0])),
                                        times)
                lo = rr * slice_len
                rows = [(local, active[lo + local])
                        for local in range(fetched[0].shape[0])]
                with times.part("filter"):
                    out, more = _expr_shard_results(
                        fetched, rows, sub_keys, expr_width=total,
                        capacity_per_shard=cap, n_shards=n_shards,
                        n_replicas=n_replicas, replica=rr,
                        batch_size=len(active))
                results.update(out)
                rerun += more
            if not rerun:
                return [results[qi] for qi in range(len(ordered))]
            active = rerun
            cap = local_total  # one re-run at the local total: no overflow
            EXEC_COUNTERS.bump("expr_rerun_calls")
            handles, slice_len = issue(active, cap)

    return PendingBatch(
        n_queries=len(ordered), handles=first_handles,
        ready=[e for joined in first_handles.values() for e in _events(joined)],
        times=times, _collect=collect)


def intersect_expr_sharded_batch(queries, eshape, mesh: Mesh,
                                 axis: str = SHARD_AXIS,
                                 capacity_per_shard: Optional[int] = None,
                                 sub_keys: Optional[Sequence[Sequence]] = None
                                 ) -> List[Tuple[np.ndarray, Dict]]:
    """A z-sharded expression bucket, synchronously."""
    return dispatch_expr_sharded_batch(
        queries, eshape, mesh, axis=axis,
        capacity_per_shard=capacity_per_shard, sub_keys=sub_keys).collect()


def intersect_expr_mesh2d_batch(queries, eshape, topology,
                                capacity_per_shard: Optional[int] = None,
                                sub_keys: Optional[Sequence[Sequence]] = None
                                ) -> List[Tuple[np.ndarray, Dict]]:
    """A 2-D expression bucket, synchronously."""
    return dispatch_expr_mesh2d_batch(
        queries, eshape, topology, capacity_per_shard=capacity_per_shard,
        sub_keys=sub_keys).collect()


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
                   extra_stats: Dict,
                   times: CollectTimes) -> List[Tuple[np.ndarray, Dict]]:
    """One copy of the (B, k_sel, 2) pairs to the host, split per row."""
    times.passes += 1
    fetched, = _to_host([pairs], ready, times)
    with times.part("filter"):
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
    start = _record_start(dev)
    table = _pack_count_rows(queries, c_tier)
    EXEC_COUNTERS.bump("count_calls")
    _note_specialization("count_traces", _count_spec(
        dev, ts, _count_gmaxes(queries), c_tier, k_sel, len(queries)))
    pairs = _intersect_count_batch(table, k_sel)
    ready = _record_ready(dev, start)
    extra = {"c_tier": c_tier, "group_tuples": 1 << max(ts)}
    times = CollectTimes()
    # the captured ``queries`` hold every mirror the table names until the
    # collect's copy has waited for the pass
    return PendingBatch(
        n_queries=len(queries), handles=pairs, ready=ready, times=times,
        _collect=lambda: _collect_count(pairs, ready, queries, k_sel, extra,
                                        times))


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


def _count_spec(dev: torch.device, ts, gmaxes, c_tier: int, k_sel: int,
                n_rows: int) -> Tuple:
    """The specialization a count pass of ``n_rows`` rows runs."""
    return ("count", str(dev), ts, gmaxes, c_tier, k_sel, _b_tier(n_rows))


def _count_gmaxes(queries) -> Tuple[int, int]:
    return queries[0][0].gmax, queries[0][1][0].gmax


def _sum_shard_counts(queries, ts: Tuple[int, int], c_tier: int, mesh: Mesh,
                      axis: str):
    """A suggest bucket's (B, c_tier) counts summed over the shards of
    ``mesh``, with each row's real-slot mask.  Shard s counts its z-slices
    through a pointer table of local mirrors at depths ``t - log2(n)``
    (``make_count_table`` wants 2^t rows; the alignment shift ``tc - tp``
    is unchanged), and the partial counts sum on shard 0's device: counts
    are additive over disjoint z-ranges.  Returns (counts, real, tables);
    the tables hold the local mirrors until the pass is collected."""
    devs = mesh.axis_devices(axis)
    shift = len(devs).bit_length() - 1  # n divides 2^t: a power of two
    local_ts = (ts[0] - shift, ts[1] - shift)
    parts = [(_shard_parts(p, mesh, axis),
              [_shard_parts(c, mesh, axis) for c in cands])
             for p, cands in queries]
    total, tables = None, []
    for s, dev in enumerate(devs):
        with _on(dev):
            table = make_count_table(
                [pp[s][0] for pp, _ in parts],
                [[cp[s][0] for cp in cps] for _, cps in parts], local_ts,
                c_tier=c_tier)
            part = ops.count_block(table).to(devs[0])
        tables.append(table)
        total = part if total is None else total + part
    return total, tables[0].real, tables


def _sharded_count_pass(queries, ts, c_tier: int, k_sel: int, mesh: Mesh,
                        axis: str):
    """Counts summed over ``mesh``'s shards, then the top-K per row on shard
    0's device: ((B, k_sel, 2) pairs, their ready event, the tables)."""
    start = _record_start(mesh.axis_devices(axis)[0])
    counts, real, tables = _sum_shard_counts(queries, ts, c_tier, mesh, axis)
    dev = counts.device
    with _on(dev):
        pairs = _top_k_slots(torch.where(real, counts, -1), k_sel)
        return pairs, _record_ready(dev, start), tables


def dispatch_count_sharded_batch(
    queries: Sequence[Tuple[DeviceSet, Sequence[DeviceSet]]],
    k: int,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
) -> PendingBatch:
    """Enqueue one count-only suggest bucket z-sharded over ``mesh``: the
    twin of :func:`dispatch_count_batch`, equal to it bit for bit.  Both
    the probes' and the candidates' 2^t must split over the shards (the
    planner's routing rule guarantees it).  Counters: ``count_calls`` per
    pass, ``count_traces`` per first sighting of its specialization on
    ``mesh``; stats add ``n_shards``."""
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    n_shards = len(mesh.axis_devices(axis))
    queries = [(p, list(c)) for p, c in queries]
    ts, c_tier = _count_signature(queries)
    if (1 << ts[0]) % n_shards or (1 << ts[1]) % n_shards:
        raise ValueError(f"both z axes (t={ts}) must split over {n_shards} "
                         "shards")
    k_sel = min(int(k), c_tier)
    EXEC_COUNTERS.bump("count_calls")
    _note_specialization("count_traces", (
        "count-sharded", mesh, ts, _count_gmaxes(queries), c_tier, k_sel,
        _b_tier(len(queries))))
    pairs, ready, tables = _sharded_count_pass(queries, ts, c_tier, k_sel,
                                               mesh, axis)
    extra = {"c_tier": c_tier, "group_tuples": 1 << max(ts),
             "n_shards": n_shards}
    times = CollectTimes()
    return PendingBatch(
        n_queries=len(queries), handles=(pairs, tables), ready=ready,
        times=times,
        _collect=lambda: _collect_count(pairs, ready, queries, k_sel, extra,
                                        times))


def intersect_count_sharded_batch(
    queries: Sequence[Tuple[DeviceSet, Sequence[DeviceSet]]],
    k: int,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
) -> List[Tuple[np.ndarray, Dict]]:
    """A z-sharded suggest bucket, synchronously (see
    :func:`intersect_count_batch`)."""
    return dispatch_count_sharded_batch(queries, k, mesh, axis=axis).collect()


def dispatch_count_mesh2d_batch(
    queries: Sequence[Tuple[ReplicatedDeviceSet,
                            Sequence[ReplicatedDeviceSet]]],
    k: int,
    topology,
) -> PendingBatch:
    """Enqueue one suggest bucket over a 2-D topology: the count twin of
    :func:`dispatch_mesh2d_batch`.  Each replica row runs its contiguous
    slice, z-sharded over its row mesh (the plain count pass on its device
    when ``shards == 1``), every row issued before any is collected.
    Counters: ``count_calls`` and ``mesh2d_row_dispatches`` per row run;
    stats add ``n_shards``, ``n_replicas`` and ``replica``."""
    if not len(queries):
        return PendingBatch(n_queries=0, _collect=lambda: [])
    n_replicas, n_shards = topology.replicas, topology.shards
    axis = topology.shard_axis
    queries = [(p, list(c)) for p, c in queries]
    ts, c_tier = _count_signature(queries)
    if (1 << ts[0]) % n_shards or (1 << ts[1]) % n_shards:
        raise ValueError(f"both z axes (t={ts}) must split over {n_shards} "
                         "shards")
    k_sel = min(int(k), c_tier)
    gmaxes = _count_gmaxes(queries)
    slice_len, layout = _mesh2d_rows(n_replicas, len(queries))
    handles = {}
    for rr, lo, hi in layout:
        rows = [(p.row(rr), [c.row(rr) for c in cands])
                for p, cands in queries[lo:hi]]
        EXEC_COUNTERS.bump_many({"count_calls": 1, "mesh2d_row_dispatches": 1})
        if n_shards > 1:
            mesh = topology.row_mesh(rr)
            _note_specialization("count_traces", (
                "count-sharded", mesh, ts, gmaxes, c_tier, k_sel, slice_len))
            handles[rr] = _sharded_count_pass(rows, ts, c_tier, k_sel, mesh,
                                              axis)
        else:
            dev = _row_device(topology, rr, [s for p, cands in rows
                                             for s in (p, *cands)])
            _note_specialization("count_traces", _count_spec(
                dev, ts, gmaxes, c_tier, k_sel, slice_len))
            start = _record_start(dev)
            with _on(dev):
                table = _pack_count_rows(rows, c_tier)
                pairs = _intersect_count_batch(table, k_sel)
                handles[rr] = (pairs, _record_ready(dev, start), [table])
    extra = {"c_tier": c_tier, "group_tuples": 1 << max(ts),
             "n_shards": n_shards, "n_replicas": n_replicas}
    times = CollectTimes()

    def collect() -> List[Tuple[np.ndarray, Dict]]:
        times.passes += 1
        fetched = {rr: _to_host([pairs], ready, times)[0]
                   for rr, (pairs, ready, _) in handles.items()}
        with times.part("filter"):
            out = []
            for qi, (_, cands) in enumerate(queries):
                rr, row = divmod(qi, slice_len)
                out.append((fetched[rr][row], {
                    "n_cands": len(cands), "k_sel": k_sel,
                    "batch_size": len(queries), **extra, "replica": rr}))
        return out

    return PendingBatch(n_queries=len(queries), handles=handles,
                        ready=[ready for _, ready, _ in handles.values()],
                        times=times, _collect=collect)


def intersect_count_mesh2d_batch(
    queries: Sequence[Tuple[ReplicatedDeviceSet,
                            Sequence[ReplicatedDeviceSet]]],
    k: int,
    topology,
) -> List[Tuple[np.ndarray, Dict]]:
    """A 2-D suggest bucket, synchronously."""
    return dispatch_count_mesh2d_batch(queries, k, topology).collect()


def pow2_tiers(up_to: int) -> Tuple[int, ...]:
    """All power-of-two batch tiers ``(1, 2, 4, ..., up_to)``: warming
    these covers every partial-flush size in ``[1, up_to]``."""
    if up_to < 1 or up_to & (up_to - 1):
        raise ValueError("up_to must be a power of two")
    return tuple(1 << i for i in range(up_to.bit_length()))


def bucket_op_log(
    queries: Sequence[Sequence[DeviceSet]],
    capacity: Optional[int] = None,
    device: Device = "cuda",
):
    """The op log (``launch/op_analysis.py::OpLog``) of one pass of a
    same-signature bucket: the counterpart of the JAX package's
    ``bucket_hlo_text``, and the input ``analyze_ops`` reads.

    Checks that the bucket has one signature, then runs its first pass
    under the recorder exactly as :func:`dispatch_device_batch` runs it
    (the port's own B with no pow2 padding, the default capacity unless
    ``capacity`` is given): one ``bitmap_filter``, k - 1 ``group_match``
    and one ``compact_rows`` kernel entries, beside the aten ops around
    them.  Eager PyTorch has no
    lower-only step, so the pass executes and bumps the counters as a
    dispatch does; it is then collected outside the recorder (with any
    overflow re-run, as a dispatch's collect), and the log's ``results``
    holds what :func:`intersect_device_batch` would return.
    """
    from ..launch.op_analysis import record

    if not len(queries):
        raise ValueError("need at least one query row to record")
    sigs = {_signature(sorted(q, key=set_sort_key)) for q in queries}
    if len(sigs) > 1:
        raise ValueError("bucket mixes shape signatures")
    with record() as log:
        pending = dispatch_device_batch(queries, capacity=capacity,
                                        device=device)
    log.results = pending.collect()
    return log


def warm_executables(
    representatives: Sequence[Sequence[DeviceSet]],
    b_tiers: Sequence[int] = (1,),
    capacity: Optional[int] = None,
    device: Device = "cuda",
    mesh: Optional[Mesh] = None,
    axis: str = SHARD_AXIS,
    topology=None,
) -> int:
    """Run one query row per shape signature at every batch tier, so the
    first live bucket of up to ``b`` queries meets a specialization already
    seen (tier ``b`` covers live buckets of size in ``(b/2, b]``).  On the
    card this also builds the kernel library and grows the caching
    allocator before live traffic.  With ``mesh`` the rows (z-sharded
    mirrors) run the sharded pass, with ``topology`` the 2-D pass
    (:class:`ReplicatedDeviceSet` rows; one run covers every replica row it
    dispatches), ``capacity`` then being the per-shard capacity.  Results
    are discarded.  Bumps ``warm_executions`` once per (row, tier) and
    returns that count."""
    issued = 0
    for row in representatives:
        for b in b_tiers:
            if b < 1 or b & (b - 1):
                raise ValueError("b_tiers must be powers of two")
            _run_flat([list(row)] * b, capacity, device, mesh=mesh,
                      axis=axis, topology=topology)
            EXEC_COUNTERS.bump("warm_executions")
            issued += 1
    return issued


def _run_flat(rows, capacity: Optional[int], device: Device,
              mesh: Optional[Mesh] = None, axis: str = SHARD_AXIS,
              topology=None) -> None:
    """One point bucket through the pass its layout routes to."""
    if topology is not None:
        intersect_mesh2d_batch(rows, topology, capacity_per_shard=capacity)
    elif mesh is not None:
        intersect_sharded_batch(rows, mesh, axis=axis,
                                capacity_per_shard=capacity)
    else:
        intersect_device_batch(rows, capacity=capacity, device=device)


def _warm_rerun(row: Sequence[DeviceSet], capacity: Optional[int],
                b_tiers: Sequence[int], device: Device,
                mesh: Optional[Mesh] = None, axis: str = SHARD_AXIS,
                topology=None) -> None:
    """Run ``row`` at its re-run's capacity (G; the local group count
    G / n on a mesh, ``capacity`` then being per shard) at each tier of
    ``b_tiers`` whose re-run specializations are not all seen yet, bumping
    ``warm_reruns`` per pass.

    A live bucket re-runs its overflowing queries at that capacity.  When
    the representative fitted its capacity, warming did not run the
    re-run, so a sibling of its signature that overflows would meet it
    unseen.  (The JAX package's warming stops before this pass.)"""
    ordered = sorted(row, key=set_sort_key)
    ts, gmaxes = _signature(ordered)
    m, w = ordered[0].m, ordered[0].w
    if topology is not None:
        n_shards = topology.shards
    else:
        n_shards = 1 if mesh is None else len(mesh.axis_devices(axis))
    g_rerun = (1 << ts[-1]) // n_shards
    if mesh is None and topology is None:
        dev = resolve_device(device)
        first = capacity or default_capacity(ts)
    else:
        first = min(capacity or default_capacity_per_shard(ts, n_shards),
                    g_rerun)
    if first >= g_rerun:
        return  # no re-run: the first pass already holds every group
    for b in b_tiers:
        if topology is not None:
            slice_len, layout = _mesh2d_rows(topology.replicas, b)
            specs = [_mesh2d_spec(topology, rr, ts, gmaxes, m, w, g_rerun,
                                  slice_len) for rr, _, _ in layout]
        elif mesh is not None:
            specs = [_sharded_spec("sharded_traces", mesh, ts, gmaxes, m, w,
                                   g_rerun, b)]
        else:
            specs = [_batch_spec(dev, ts, gmaxes, m, w, g_rerun, b)]
        if all(map(_seen_specialization, specs)):
            continue
        _run_flat([list(row)] * b, g_rerun, device, mesh=mesh, axis=axis,
                  topology=topology)
        EXEC_COUNTERS.bump("warm_reruns")


def _warm_expr_rerun(row: Sequence[DeviceSet], eshape,
                     capacity: Optional[int], b_tiers: Sequence[int],
                     device: Device, mesh: Optional[Mesh] = None,
                     axis: str = SHARD_AXIS, topology=None) -> None:
    """The expression form of :func:`_warm_rerun`: run ``row`` at the total
    leaf width (its local share on a mesh), an overflowing query's re-run
    capacity, at each tier of ``b_tiers`` whose re-run specializations are
    not all seen yet, bumping ``warm_reruns`` per pass."""
    ts, gmaxes = _expr_signature(row)
    if topology is not None:
        n_shards = topology.shards
    else:
        n_shards = 1 if mesh is None else len(mesh.axis_devices(axis))
    total = expr_total_width(ts, gmaxes) // n_shards
    if mesh is None and topology is None:
        dev = resolve_device(device)
        first = min(capacity or default_expr_capacity(ts, gmaxes), total)
    else:
        first = min(capacity or default_expr_capacity_per_shard(
            ts, gmaxes, n_shards), total)
    if first >= total:
        return  # no re-run: the first pass already runs at the total width
    for b in b_tiers:
        if topology is not None:
            slice_len, layout = _mesh2d_rows(topology.replicas, b)
            specs = [_expr_sharded_spec(topology.row_mesh(rr), eshape, ts,
                                        gmaxes, total, slice_len)
                     if n_shards > 1 else
                     _expr_spec(resolve_device(topology.replica_device(rr)),
                                eshape, ts, gmaxes, total, slice_len)
                     for rr, _, _ in layout]
        elif mesh is not None:
            specs = [_expr_sharded_spec(mesh, eshape, ts, gmaxes, total, b)]
        else:
            specs = [_expr_spec(dev, eshape, ts, gmaxes, total, b)]
        if all(map(_seen_specialization, specs)):
            continue
        _run_expr([list(row)] * b, eshape, total, device, mesh=mesh,
                  axis=axis, topology=topology)
        EXEC_COUNTERS.bump("warm_reruns")


def _run_expr(rows, eshape, capacity: Optional[int], device: Device,
              mesh: Optional[Mesh] = None, axis: str = SHARD_AXIS,
              topology=None) -> None:
    """One expression bucket through the pass its layout routes to
    (``capacity`` per shard on a mesh)."""
    if topology is not None:
        intersect_expr_mesh2d_batch(rows, eshape, topology,
                                    capacity_per_shard=capacity)
    elif mesh is not None:
        intersect_expr_sharded_batch(rows, eshape, mesh, axis=axis,
                                     capacity_per_shard=capacity)
    else:
        intersect_expr_batch(rows, eshape, capacity=capacity, device=device)


def warm_from_plans(plans, get_set: Callable[[object], DeviceSet],
                    top_k: int = 8, b_tiers: Sequence[int] = (1,),
                    device: Device = "cuda", mesh: Optional[Mesh] = None,
                    axis: str = SHARD_AXIS,
                    get_sharded_set: Optional[Callable] = None,
                    topology=None,
                    get_replica_set: Optional[Callable] = None) -> List:
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
    DeviceSet.

    Mesh-routed signatures (``sig.shards > 1``, or ``sig.replicas > 1``
    with a ``topology``) resolve through ``get_sharded_set`` (falling back
    to ``get_set``) and run the sharded pass on ``mesh`` or the 2-D pass on
    ``topology``, at the per-shard capacity the executor derives.  With a
    topology of several replicas, a single-device signature runs on every
    replica row (``get_replica_set(r, term)``), since the balancer may
    place a live bucket on any of them.  Returns the warmed signatures,
    most frequent first."""
    from collections import Counter

    freq = Counter(p.sig for p in plans if p.algorithm == "device")
    rep_terms: Dict = {}
    for p in plans:
        if p.algorithm == "device" and p.sig not in rep_terms:
            rep_terms[p.sig] = p.terms
    warmed = [sig for sig, _ in freq.most_common(top_k)]
    resolve = get_sharded_set or get_set
    if (topology is not None and topology.replicas > 1
            and get_replica_set is not None):
        # one (resolver, device) per replica row
        placed = [(lambda t, r=r: get_replica_set(r, t),
                   topology.replica_device(r))
                  for r in range(topology.replicas)]
    else:
        placed = [(get_set, device)]
    layout = {"mesh": mesh if topology is None else None, "axis": axis,
              "topology": topology}
    for sig in warmed:
        terms = rep_terms[sig]
        mesh_routed = sig.shards > 1 or (topology is not None
                                         and sig.replicas > 1)
        if sig.eshape is not None:
            if mesh_routed:
                cap = default_expr_capacity_per_shard(
                    sig.ts, sig.gmaxes, sig.shards, capacity=sig.capacity_tier)
                runs = [([resolve(t) for t in terms], device, layout)]
            else:
                cap = sig.capacity_tier
                runs = [([get(t) for t in terms], dev, {})
                        for get, dev in placed]
            for b in b_tiers:
                for row, dev, where in runs:
                    _run_expr([row] * b, sig.eshape, cap, dev, **where)
                EXEC_COUNTERS.bump("warm_executions")
            for row, dev, where in runs:
                _warm_expr_rerun(row, sig.eshape, cap, b_tiers, dev, **where)
        elif sig.cands > 0:
            if mesh_routed:
                rows = [((resolve(terms[0]), [resolve(t) for t in terms[1:]]),
                         device)]
            else:
                rows = [((get(terms[0]), [get(t) for t in terms[1:]]), dev)
                        for get, dev in placed]
            for b in b_tiers:
                for row, dev in rows:
                    if mesh_routed and topology is not None:
                        intersect_count_mesh2d_batch([row] * b,
                                                     sig.capacity_tier,
                                                     topology)
                    elif mesh_routed:
                        intersect_count_sharded_batch([row] * b,
                                                      sig.capacity_tier, mesh,
                                                      axis=axis)
                    else:
                        intersect_count_batch([row] * b, sig.capacity_tier,
                                              device=dev)
                EXEC_COUNTERS.bump("warm_executions")
        elif mesh_routed:
            row = [resolve(t) for t in terms]
            cap = default_capacity_per_shard(sig.ts, sig.shards,
                                             capacity=sig.capacity_tier)
            warm_executables([row], b_tiers=b_tiers, capacity=cap, **layout)
            _warm_rerun(row, cap, b_tiers, device, **layout)
        else:
            for get, dev in placed:
                row = [get(t) for t in terms]
                warm_executables([row], b_tiers=b_tiers,
                                 capacity=sig.capacity_tier, device=dev)
                _warm_rerun(row, sig.capacity_tier, b_tiers, dev)
    return warmed


class BatchedEngine:
    """Corpus-level engine: name -> DeviceSet, query bucketing.

    With a 1-D ``mesh``, :meth:`add` also builds a z-sharded mirror of
    every shardable set (views when the shards share the mirrors' device),
    and the planner routes queries whose largest set has at least
    ``shard_min_g`` group tuples through the sharded pass; smaller ones
    stay on ``device``.  With a 2-D ``topology`` (``exec.topology.
    Topology``; exclusive with ``mesh``) those queries run the 2-D pass,
    and single-device buckets go to the least-loaded replica row; the
    per-row mirrors are built lazily, on first dispatch
    (:meth:`get_replica_set`, :meth:`get_mesh_set`).

    Mutation hooks (:meth:`on_mutate`) fire on every :meth:`add` so owners
    of derived state — the serving layer's result cache — can invalidate.
    """

    def __init__(self, device: Device = "cuda", mesh: Optional[Mesh] = None,
                 shard_axis: str = SHARD_AXIS, shard_min_g: int = SHARD_MIN_G,
                 topology=None):
        if mesh is not None and topology is not None:
            raise ValueError("pass a 1-D mesh or a 2-D topology, not both")
        self.device = resolve_device(device)
        self.sets: Dict[object, DeviceSet] = {}
        self.sharded_sets: Dict[object, object] = {}
        self.mesh = mesh
        self.topology = topology
        self.shard_axis = (topology.shard_axis if topology is not None
                           else shard_axis)
        self.shard_min_g = shard_min_g
        # one plain-mirror dict per replica row (none for a single replica,
        # whose buckets run on ``sets``)
        self.replica_sets: List[Dict[object, DeviceSet]] = (
            [{} for _ in range(topology.replicas)]
            if topology is not None and topology.replicas > 1 else [])
        self.generation = 0
        self._mutation_hooks: List[Callable[[], None]] = []

    @property
    def n_shards(self) -> int:
        if self.topology is not None:
            return self.topology.shards
        return self.mesh.shape[self.shard_axis] if self.mesh is not None else 1

    @property
    def n_replicas(self) -> int:
        return self.topology.replicas if self.topology is not None else 1

    def on_mutate(self, hook: Callable[[], None]) -> None:
        """Register a zero-arg callback fired after every index mutation."""
        self._mutation_hooks.append(hook)

    def add(self, name, idx: PrefixIndex) -> None:
        ds = DeviceSet.from_host(idx, self.device)
        self.sets[name] = ds
        # a replaced term drops its stale mesh and replica mirrors
        self.sharded_sets.pop(name, None)
        for mirrors in self.replica_sets:
            mirrors.pop(name, None)
        if self.mesh is not None and ds.shardable(self.n_shards):
            self.sharded_sets[name] = ds.shard(self.mesh, self.shard_axis)
        self.generation += 1
        for hook in self._mutation_hooks:
            hook()

    def query(self, names: Sequence, capacity: Optional[int] = None):
        return intersect_device([self.sets[n] for n in names],
                                capacity=capacity, device=self.device)

    def query_many(self, queries: Sequence[Sequence]):
        """Plan -> bucket by shape signature -> one pass per bucket ->
        scatter back in request order.  Returns [(values, stats), ...].
        With a mesh, large buckets run z-sharded; with a topology they run
        2-D and small buckets spread over the replicas."""
        from ..exec.batch import execute_name_queries

        return execute_name_queries(
            self.sets, queries, device=self.device, mesh=self.mesh,
            shard_axis=self.shard_axis, shard_min_g=self.shard_min_g,
            get_sharded_set=self.get_mesh_set, topology=self.topology,
            get_replica_set=self.get_replica_set)

    def get_replica_set(self, r: int, name) -> DeviceSet:
        """``name``'s plain mirror on replica row ``r``'s device, built on
        first use (only terms that reach a replica pay the copy; on the
        mirror's own device it is the mirror itself).  The default mirror
        when the topology has one replica."""
        if not self.replica_sets:
            return self.sets[name]
        mirrors = self.replica_sets[r]
        if name not in mirrors:
            mirrors[name] = self.sets[name].place(
                self.topology.replica_device(r))
        return mirrors[name]

    def get_mesh_set(self, name):
        """``name``'s mesh mirror: the z-sharded mirror (``mesh=`` engines,
        built at :meth:`add`) or the :class:`ReplicatedDeviceSet` (topology
        engines, built here on first use: one z-sharded mirror per replica
        row, or the rows' plain mirrors when ``shards == 1``)."""
        if self.topology is None:
            return self.sharded_sets[name]
        if name not in self.sharded_sets:
            ds = self.sets[name]
            if not ds.shardable(self.n_shards):
                raise ValueError(
                    f"{name!r}: 2^{ds.t} z-groups do not split over "
                    f"{self.n_shards} shards (the planner never mesh-routes "
                    "such a set)")
            if self.n_shards > 1:
                rows = tuple(ds.shard(self.topology.row_mesh(r),
                                      self.shard_axis)
                             for r in range(self.n_replicas))
            else:
                rows = tuple(self.get_replica_set(r, name)
                             for r in range(self.n_replicas))
            self.sharded_sets[name] = ReplicatedDeviceSet(rows)
        return self.sharded_sets[name]

    def routing(self) -> Dict:
        """The keyword arguments that route a bucket through this engine's
        layout (``exec.batch.dispatch_bucket``, ``execute_plan_buckets``)."""
        return {"mesh": self.mesh, "shard_axis": self.shard_axis,
                "get_sharded_set": self.get_mesh_set,
                "topology": self.topology,
                "get_replica_set": self.get_replica_set}

    def warm_plans(self, plans, top_k: int = 8,
                   b_tiers: Sequence[int] = (1,)) -> List:
        """:func:`warm_from_plans` over this engine's mirrors and layout."""
        return warm_from_plans(
            plans, self.sets.__getitem__, top_k=top_k, b_tiers=b_tiers,
            device=self.device, mesh=self.mesh, axis=self.shard_axis,
            get_sharded_set=self.get_mesh_set, topology=self.topology,
            get_replica_set=self.get_replica_set)

    def warm(self, sample_queries: Sequence, top_k: int = 8,
             b_tiers: Sequence[int] = (1,)) -> List:
        """Run the hot signatures of a name-keyed sample workload before
        live traffic: plans the sample with this engine's routing and warms
        it (:meth:`warm_plans`).  Returns the warmed signatures, most
        frequent first."""
        from ..exec.plan import plan_query

        plans = [plan_query(self.sets, q, hashbin_ratio=float("inf"),
                            mesh_shards=self.n_shards,
                            mesh_replicas=self.n_replicas,
                            shard_min_g=self.shard_min_g)
                 for q in sample_queries]
        return self.warm_plans(plans, top_k=top_k, b_tiers=b_tiers)
