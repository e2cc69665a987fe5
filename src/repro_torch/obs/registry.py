"""Typed metrics registry: Counter / Gauge / Histogram with atomic snapshots.

``core.engine.EXEC_COUNTERS`` counts; this module adds the typed half:

- :class:`Counter`: a monotonic accumulator.
- :class:`Gauge`: the last written value, or with ``track_max`` the largest
  since the last reset (the high-water idiom).
- :class:`Histogram`: a bucketed distribution.  The default lattice
  (:func:`default_latency_buckets`) is log-spaced 1-2-5 over microseconds,
  so one shape covers queue waits and whole-bucket collect latencies.

Every metric of one :class:`MetricsRegistry` shares the registry's lock, so
:meth:`MetricsRegistry.snapshot` is a consistent cut: no metric advances
while it is copied, and a histogram's ``sum`` / ``count`` pair never tears.
Metrics are updated per bucket and per ticket, never per element, so the
lock is uncontended.

A registry also takes **collectors**, callbacks returning a flat ``{name:
value}`` dict read under the lock at snapshot time.  The default
:class:`~repro_torch.obs.Obs` registers ``EXEC_COUNTERS.snapshot`` as one,
so every counter appears in the typed snapshot (and in the Prometheus and
JSON expositions) under the ``exec_`` prefix.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_latency_buckets", "pow2_buckets",
]


def default_latency_buckets(lo_us: float = 1.0,
                            hi_us: float = 1e7) -> List[float]:
    """Log-spaced 1-2-5 upper bounds in us (1, 2, 5, 10, ... up to
    ``hi_us``); +Inf is implicit."""
    out: List[float] = []
    decade = lo_us
    while decade <= hi_us:
        for mult in (1.0, 2.0, 5.0):
            bound = decade * mult
            if lo_us <= bound <= hi_us:
                out.append(bound)
        decade *= 10.0
    return out


def pow2_buckets(lo: int = 1, hi: int = 1 << 20) -> List[float]:
    """Power-of-two upper bounds: the lattice of batch sizes and survivor
    counts (the executor's B-tiers and capacity tiers are pow2)."""
    out: List[float] = []
    b = lo
    while b <= hi:
        out.append(float(b))
        b <<= 1
    return out


class _Metric:
    """Base: a named metric bound to its registry's shared lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 lock: Optional[threading.Lock] = None):
        self.name = name
        self.help = help
        self._lock = lock if lock is not None else threading.Lock()


class Counter(_Metric):
    """Monotonic accumulator; ``inc(n)`` with ``n < 0`` raises."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", lock=None):
        super().__init__(name, help, lock)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("Counter.inc is monotonic; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _read(self) -> float:  # caller holds the lock (snapshot path)
        return self._value

    def _reset(self) -> None:  # caller holds the lock
        self._value = 0.0


class Gauge(_Metric):
    """Last-written value; with ``track_max`` the largest value :meth:`set`
    since the last reset."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", lock=None,
                 track_max: bool = False):
        super().__init__(name, help, lock)
        self.track_max = track_max
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            if self.track_max:
                self._value = max(self._value, v)
            else:
                self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _read(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Histogram(_Metric):
    """Fixed-bucket distribution with ``sum`` / ``count``: the Prometheus
    histogram model, kept as per-bucket counts and cumulated by the
    exposition writer.  ``buckets`` are strictly ascending upper bounds
    (``le``); an observation above the last lands in the +Inf bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", lock=None,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, lock)
        bounds = list(buckets if buckets is not None
                      else default_latency_buckets())
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be strictly ascending")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Approximate quantile as a bucket upper bound (the true value is
        at most the returned bound)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must lie in [0, 1]")
        with self._lock:
            if self._count == 0:
                return 0.0
            target = q * self._count
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target and c:
                    return (self.bounds[i] if i < len(self.bounds)
                            else float("inf"))
            return float("inf")

    def _read(self) -> Dict:
        return {
            "buckets": list(self.bounds),
            "counts": list(self._counts),
            "sum": self._sum,
            "count": self._count,
        }

    def _reset(self) -> None:
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0


class MetricsRegistry:
    """Named metrics and collectors behind ONE lock; atomic snapshots.

    ``counter`` / ``gauge`` / ``histogram`` get or create (the same name
    and kind returns the same metric; a kind clash raises).  Collectors may
    take their own locks (``ExecCounters`` does); nothing here calls back
    into a registry from under a metric lock, so lock order is acyclic.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], Dict[str, float]]] = []

    def _get_or_make(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            metric = cls(name, help, lock=self._lock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              track_max: bool = False) -> Gauge:
        return self._get_or_make(Gauge, name, help, track_max=track_max)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_make(Histogram, name, help, buckets=buckets)

    def register_collector(self,
                           fn: Callable[[], Dict[str, float]]) -> None:
        """Register a ``() -> {name: value}`` callback, read under the
        registry lock at snapshot time (its values export as gauges)."""
        with self._lock:
            self._collectors.append(fn)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict:
        """One consistent cut: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}, "collected": {...}}``, taken under the
        registry lock."""
        with self._lock:
            snap: Dict = {"counters": {}, "gauges": {}, "histograms": {},
                          "collected": {}}
            for name, m in self._metrics.items():
                if isinstance(m, Counter):
                    snap["counters"][name] = m._read()
                elif isinstance(m, Histogram):
                    snap["histograms"][name] = m._read()
                else:
                    snap["gauges"][name] = m._read()
            for fn in self._collectors:
                snap["collected"].update(fn())
            return snap

    def reset(self) -> None:
        """Zero every metric; collectors own their reset
        (``EXEC_COUNTERS.reset()`` is separate)."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()
