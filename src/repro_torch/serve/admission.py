"""Async admission and micro-batching front-end primitives.

The batched executor (``repro_torch.exec``) wants signature-coherent
``(B, ...)`` buckets; live traffic arrives as single queries from many
concurrent callers.  An :class:`AdmissionQueue` accumulates submissions into
per-key micro-batches (the key is a :class:`~repro_torch.exec.plan.
ShapeSig` in the search front end, but the queue is generic) and hands a
bucket back for execution on

- **tier flush**: the bucket reaches the power-of-two ``flush_tier``, or
- **deadline flush**: the bucket's earliest deadline (default budget 2 ms
  after submission) expires, bounding what a query can lose waiting for
  batch-mates,

whichever comes first, counted in ``EXEC_COUNTERS["tier_flushes"]`` /
``["deadline_flushes"]``.

Each submission returns a :class:`Ticket`, a minimal single-shot future
that also carries the queue wait (``wait_us``, the quantity the deadline
budget bounds).

The queue does no execution and holds no device state; an engine
(``serve.search.AsyncSearchEngine``) drives it.  Its lock guards only the
bucket dict, never ticket resolution or execution, so ``submit`` cannot
block behind a flush.  Every ``take_*`` removes whole buckets atomically
under the lock, so a (ticket, item) pair leaves the queue exactly once
however ``take_full`` / ``take_due`` / ``take_all`` interleave across
threads: that is what makes a drain idempotent and safe beside a flusher.
``next_deadline_in_us`` reports 0 while a bucket is full, so a flusher that
sleeps until the next deadline also wakes for tier flushes.  The clock is
injectable so tests and virtual-time callers fire deadlines
deterministically.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from ..core.engine import EXEC_COUNTERS

__all__ = ["Ticket", "AdmissionQueue"]


@dataclasses.dataclass
class Ticket:
    """Minimal future for one admitted request.

    ``submitted_at`` (engine-clock seconds) and ``deadline_us`` define the
    flush budget.  After resolution ``value`` holds the engine's result,
    ``wait_us`` the time the request sat in the queue (0 for requests
    answered at submit time, such as result-cache hits), ``resolved_at``
    the host ``time.perf_counter()`` of resolution, and ``done`` is True.
    Reading ``value`` before resolution raises.  A ticket whose bucket
    failed resolves with the error: ``done`` is True, ``error`` holds the
    exception and ``value`` re-raises it, so no caller hangs on a failed
    bucket.

    Resolution is published through a ``threading.Event`` after the payload
    is written, so a thread that sees ``done`` (or returns from
    :meth:`wait`) sees the value.  It is single-shot: a second ``resolve``
    or ``resolve_error`` raises instead of clobbering a delivered result.
    """

    submitted_at: float
    deadline_us: float
    wait_us: float = 0.0
    error: Optional[BaseException] = None
    resolved_at: Optional[float] = None
    _value: Any = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    @property
    def done(self) -> bool:
        """True once resolved (value or error); safe to poll from any
        thread."""
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved (or ``timeout`` seconds); returns ``done``."""
        return self._done.wait(timeout)

    @property
    def value(self) -> Any:
        if not self._done.is_set():
            raise RuntimeError("ticket not resolved yet — flush/drain first")
        if self.error is not None:
            raise self.error
        return self._value

    def _record_wait(self, wait_us: float) -> None:
        """Per-ticket wait telemetry, once per ticket: ``tickets_resolved``,
        ``queue_wait_us`` (integer microseconds) and ``deadline_violations``
        (a wait more than 0.5 us, the virtual clock's float epsilon, past
        this ticket's own budget; a ticket with no budget cannot violate),
        in one ``bump_many``."""
        violated = (self.deadline_us > 0
                    and wait_us > self.deadline_us + 0.5)
        EXEC_COUNTERS.bump_many({
            "tickets_resolved": 1,
            "queue_wait_us": int(wait_us),
            "deadline_violations": int(violated),
        })

    def _publish(self, wait_us: float) -> None:
        self.wait_us = wait_us
        self.resolved_at = time.perf_counter()
        self._record_wait(wait_us)
        self._done.set()  # publish AFTER the payload writes

    def resolve(self, value: Any, wait_us: float = 0.0) -> None:
        if self._done.is_set():
            raise RuntimeError("ticket already resolved — single-shot")
        self._value = value
        self._publish(wait_us)

    def resolve_error(self, exc: BaseException, wait_us: float = 0.0) -> None:
        if self._done.is_set():
            raise RuntimeError("ticket already resolved — single-shot")
        self.error = exc
        self._publish(wait_us)

    def deadline_at(self) -> float:
        """Absolute clock time at which this ticket forces a flush."""
        return self.submitted_at + self.deadline_us * 1e-6


class AdmissionQueue:
    """Deadline-aware per-key micro-batch accumulator (execution-free).

    Buckets are keyed by any hashable and keep insertion order; a bucket's
    binding deadline is its *earliest* entry deadline, normally the oldest
    entry's unless a later submission carried a tighter budget.
    Thread-safe.
    """

    def __init__(self, flush_tier: int = 64, deadline_us: float = 2000.0,
                 clock: Callable[[], float] = time.perf_counter):
        if flush_tier < 1 or flush_tier & (flush_tier - 1):
            raise ValueError("flush_tier must be a power of two")
        self.flush_tier = flush_tier
        self.deadline_us = float(deadline_us)
        self.clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[Hashable, List[Tuple[Ticket, Any]]] = {}

    def submit(self, key: Hashable, item: Any,
               deadline_us: Optional[float] = None,
               submitted_at: Optional[float] = None) -> Ticket:
        """Queue ``item`` under ``key``; returns its unresolved Ticket.

        ``deadline_us`` overrides the queue's default budget.
        ``submitted_at`` (engine-clock seconds) back-stamps the arrival: an
        open-loop load generator passes the *scheduled* arrival, so a submitter
        that ran late still charges its lateness to the wait and the
        budget.  Submission never flushes by itself.
        """
        ticket = Ticket(
            submitted_at=(self.clock() if submitted_at is None
                          else float(submitted_at)),
            deadline_us=(self.deadline_us if deadline_us is None
                         else float(deadline_us)),
        )
        with self._lock:
            self._buckets.setdefault(key, []).append((ticket, item))
        return ticket

    def take_full(self) -> List[Tuple[Hashable, List[Tuple[Ticket, Any]]]]:
        """Remove and return buckets that reached the flush tier."""
        out = []
        with self._lock:
            for key in [k for k, b in self._buckets.items()
                        if len(b) >= self.flush_tier]:
                out.append((key, self._buckets.pop(key)))
                EXEC_COUNTERS.bump("tier_flushes")
        return out

    @staticmethod
    def _bucket_deadline(bucket) -> float:
        """Earliest absolute deadline in a bucket."""
        return min(t.deadline_at() for t, _ in bucket)

    def take_due(self, now: Optional[float] = None
                 ) -> List[Tuple[Hashable, List[Tuple[Ticket, Any]]]]:
        """Remove and return buckets whose earliest deadline has expired,
        and full ones (counted as tier flushes), so a caller that only
        calls ``take_due`` still flushes correctly."""
        now = self.clock() if now is None else now
        out = []
        with self._lock:
            for key in list(self._buckets):
                bucket = self._buckets[key]
                if len(bucket) >= self.flush_tier:
                    out.append((key, self._buckets.pop(key)))
                    EXEC_COUNTERS.bump("tier_flushes")
                elif bucket and self._bucket_deadline(bucket) <= now:
                    out.append((key, self._buckets.pop(key)))
                    EXEC_COUNTERS.bump("deadline_flushes")
        return out

    def take_all(self) -> List[Tuple[Hashable, List[Tuple[Ticket, Any]]]]:
        """Remove and return every pending bucket (the drain path): a
        partial bucket counts as a deadline flush, a full one as a tier
        flush."""
        out = []
        with self._lock:
            for key in list(self._buckets):
                bucket = self._buckets.pop(key)
                EXEC_COUNTERS.bump("tier_flushes"
                                   if len(bucket) >= self.flush_tier
                                   else "deadline_flushes")
                out.append((key, bucket))
        return out

    def pending(self) -> int:
        """Number of queued, not-yet-flushed submissions."""
        with self._lock:
            return sum(len(b) for b in self._buckets.values())

    def next_deadline_in_us(self, now: Optional[float] = None
                            ) -> Optional[float]:
        """Microseconds until the next flush is due (<= 0: overdue; 0 while
        any bucket is full); None when nothing is queued."""
        now = self.clock() if now is None else now
        with self._lock:
            if not self._buckets:
                return None
            if any(len(b) >= self.flush_tier for b in self._buckets.values()):
                return 0.0
            soonest = min(self._bucket_deadline(b)
                          for b in self._buckets.values() if b)
            return (soonest - now) * 1e6
