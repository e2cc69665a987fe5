"""Observability for the port's serving stack: tracing, typed metrics, export.

One :class:`Obs` bundles the four pieces every layer reports through:

- ``obs.registry``: a :class:`~repro_torch.obs.registry.MetricsRegistry`
  with the standard instruments below, and the port's ``EXEC_COUNTERS`` as
  a collector under the ``exec_`` prefix, so one
  ``obs.registry.snapshot()`` is a consistent cut of all telemetry;
- ``obs.tracer``: a :class:`~repro_torch.obs.trace.Tracer`, disabled by
  default (``Obs(trace=True)`` or ``obs.tracer.enabled = True``);
- ``obs.profile``: a :class:`~repro_torch.obs.profile.ProfileStore`, fed
  one ``(ShapeSig, batch, measured_us)`` record per collected bucket;
- ``obs.ring``: a :class:`~repro_torch.obs.export.SnapshotRing`, filled by
  the async flusher every ``snapshot_every_s``.

Standard instruments, as in the JAX package:

==========================  =========  =================================
name                        type       what
==========================  =========  =================================
``queue_wait_us``           Histogram  ticket submit -> flush pickup
``collect_latency_us``      Histogram  bucket dispatch -> collect return
``bucket_batch_size``       Histogram  rows per executed bucket (pow2)
``bucket_survivors``        Histogram  survivors per query row (pow2)
``dispatch_failures``       Counter    buckets whose dispatch/collect
                                       raised (balancer weight released)
``inflight_buckets``        Gauge      dispatched, not yet collected
``inflight_high_water``     Gauge      max of the above since reset
==========================  =========  =================================

Engines default to the process-global instance (:func:`get_obs`); pass
``obs=Obs(...)`` to an engine for an isolated one.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .export import (SnapshotRing, parse_json, parse_prometheus, to_json,
                     to_prometheus)
from .profile import ProfileStore, sig_label
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       default_latency_buckets, pow2_buckets)
from .trace import (NULL_SPAN, NullSpan, Span, Tracer, format_trace,
                    profiler_range)

__all__ = [
    "Obs", "get_obs", "set_obs", "reset_obs",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "default_latency_buckets", "pow2_buckets",
    "Tracer", "Span", "NullSpan", "NULL_SPAN", "format_trace",
    "profiler_range",
    "ProfileStore", "sig_label",
    "SnapshotRing", "to_prometheus", "to_json", "parse_prometheus",
    "parse_json",
]


def _exec_collector() -> Dict[str, float]:
    """The port's ``EXEC_COUNTERS`` as one atomic snapshot, keyed under
    ``exec_`` for the typed exposition.  Imported here, as
    ``core.engine`` imports this package's tracer."""
    from ..core.engine import EXEC_COUNTERS

    return {f"exec_{k}": float(v)
            for k, v in EXEC_COUNTERS.snapshot().items()}


class Obs:
    """Bundle of registry, tracer, profile store and snapshot ring."""

    def __init__(self, trace: bool = False, max_finished_spans: int = 8192,
                 ring_size: int = 64, cost_model=None):
        self.registry = MetricsRegistry()
        self.tracer = Tracer(enabled=trace,
                             max_finished=max_finished_spans)
        self.profile = ProfileStore(cost_model=cost_model)
        self.ring = SnapshotRing(maxlen=ring_size)
        self.registry.register_collector(_exec_collector)
        r = self.registry
        self.queue_wait = r.histogram(
            "queue_wait_us", "ticket submit -> flush pickup, us")
        self.collect_latency = r.histogram(
            "collect_latency_us", "bucket dispatch -> collect return, us")
        self.batch_size = r.histogram(
            "bucket_batch_size", "query rows per executed bucket",
            buckets=pow2_buckets(1, 1 << 14))
        self.survivors = r.histogram(
            "bucket_survivors", "survivors per query row",
            buckets=pow2_buckets(1, 1 << 20))
        self.dispatch_failures = r.counter(
            "dispatch_failures",
            "buckets whose dispatch or collect raised")
        self.inflight = r.gauge(
            "inflight_buckets", "dispatched, not yet collected")
        self.inflight_high_water = r.gauge(
            "inflight_high_water", "max concurrent in-flight since reset",
            track_max=True)

    def snapshot(self) -> Dict:
        return self.registry.snapshot()

    def trace_dump(self, trace_id: Optional[int] = None,
                   limit: int = 50) -> str:
        """Span trees as text: the surface for debugging a stuck flight."""
        return self.tracer.dump(trace_id=trace_id, limit=limit)

    def reset(self) -> None:
        """Zero the registry's metrics, spans, profile samples and the ring.
        ``EXEC_COUNTERS`` is left alone (it has its own reset)."""
        self.registry.reset()
        self.tracer.reset()
        self.profile.reset()
        self.ring.clear()


_global_lock = threading.Lock()
_global_obs: Optional[Obs] = None


def get_obs() -> Obs:
    """The process-global default ``Obs`` (tracer disabled), made on first
    use."""
    global _global_obs
    with _global_lock:
        if _global_obs is None:
            _global_obs = Obs(trace=False)
        return _global_obs


def set_obs(obs: Obs) -> Obs:
    """Replace the process-global default."""
    global _global_obs
    with _global_lock:
        _global_obs = obs
        return obs


def reset_obs() -> None:
    """Reset the process-global instance and drop any :func:`set_obs`
    override: the next :func:`get_obs` returns a fresh default.  Engines
    built before keep their own reference.  The port's tests call it
    beside ``EXEC_COUNTERS.reset()``."""
    global _global_obs
    with _global_lock:
        obs = _global_obs
        _global_obs = None
    if obs is not None:
        obs.reset()
