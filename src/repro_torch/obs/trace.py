"""Request tracing: per-request trace ids, lifecycle spans, span-tree dump.

The async serving path is concurrent three ways at once: tickets queue per
signature, the flusher dispatches buckets into an overlapped window, and the
card runs a bucket's passes while the host moves on until collect waits for
them.  Counters cannot show where one request's time went; spans can.

- A **trace** is one request: one ``submit()`` or one suggest request gets
  a fresh ``trace_id``.  A bucket is a root trace of its own (it serves
  many requests), recording its members' trace ids as an attribute.
- A **span** is a named interval with attributes, in a tree by
  ``parent_id``.  The serving stack's taxonomy: request -> {plan,
  admission}; bucket -> {dispatch, device, collect}.
- The clock is ``time.perf_counter`` in microseconds (injectable).

Where a ``torch.profiler`` is recording, :func:`profiler_range` opens a
``record_function`` range at the program's own sites (``search.*``,
``bucket.dispatch``, ``phase1.*``, ``phase2``, ``collect.*``,
``host_plan``), so they sit in the profiler's trace beside the kernels;
with no profiler recording it opens nothing.

The disabled tracer (the default) returns the shared :data:`NULL_SPAN` from
every call: no allocation, no lock, no record.  The enabled tracer takes one
lock per span start and one per end; finished spans go into a bounded ring.
Open spans are held by id, so :meth:`Tracer.open_count` finds leaks.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["Span", "NullSpan", "NULL_SPAN", "Tracer", "format_trace",
           "profiler_range"]

_ids = itertools.count(1)


class Span:
    """One named interval.  ``end()`` is idempotent (the first call wins),
    so a single-shot resolve path closes each span exactly once."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start_us", "end_us", "attrs")

    enabled = True

    def __init__(self, tracer: "Tracer", trace_id: int, span_id: int,
                 parent_id: Optional[int], name: str, start_us: float):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_us = start_us
        self.end_us: Optional[float] = None
        self.attrs: Dict = {}

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def child(self, name: str, **attrs) -> "Span":
        return self.tracer.start(name, parent=self, **attrs)

    def end(self, **attrs) -> None:
        if self.end_us is not None:
            return
        if attrs:
            self.attrs.update(attrs)
        self.tracer._finish(self)

    @property
    def duration_us(self) -> float:
        if self.end_us is None:
            return 0.0
        return self.end_us - self.start_us

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and "error" not in self.attrs:
            self.attrs["error"] = repr(exc)
        self.end()

    def __repr__(self) -> str:
        state = (f"{self.duration_us:.0f}us" if self.end_us is not None
                 else "open")
        return (f"Span({self.name!r} trace={self.trace_id} "
                f"id={self.span_id} {state})")


class NullSpan:
    """The disabled-mode sentinel: every operation is a no-op returning the
    sentinel, so instrumentation sites never branch on the mode."""

    __slots__ = ()

    enabled = False
    trace_id = 0
    span_id = 0
    parent_id = None
    name = ""
    start_us = 0.0
    end_us = 0.0
    duration_us = 0.0
    attrs: Dict = {}

    def set(self, **attrs) -> "NullSpan":
        return self

    def child(self, name: str, **attrs) -> "NullSpan":
        return self

    def end(self, **attrs) -> None:
        return None

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def __repr__(self) -> str:
        return "NullSpan()"


NULL_SPAN = NullSpan()

_NO_RANGE = contextlib.nullcontext()


def profiler_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler is recording, so that the site shows in its trace (with a
    ``gpu_user_annotation`` twin on the device timeline); otherwise a
    shared no-op context, and no range is opened.  The profiler's state is
    read once a call."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


class Tracer:
    """Span factory and bounded finished-span store.

    ``enabled=False`` makes every ``start()`` / ``span_at()`` return
    :data:`NULL_SPAN`.  Finished spans live in a ring of ``max_finished``
    (``dropped`` counts the evicted); open spans are held by id until
    ended, and ``open_count()`` after a drained workload must be 0.
    """

    def __init__(self, enabled: bool = True, max_finished: int = 8192,
                 clock=time.perf_counter):
        self.enabled = enabled
        self.max_finished = max(1, int(max_finished))
        self._clock = clock
        self._lock = threading.Lock()
        self._open: Dict[int, Span] = {}
        self._finished: List[Span] = []
        self._dropped = 0

    def _now_us(self) -> float:
        return self._clock() * 1e6

    def new_trace_id(self) -> int:
        return next(_ids)

    def start(self, name: str, parent: Optional[Span] = None,
              trace_id: Optional[int] = None,
              start_us: Optional[float] = None, **attrs):
        """Open a span: with ``parent`` it joins the parent's trace, else
        it is the root of a fresh (or the given) trace.  ``start_us``
        backdates it to work that began before the span could be made (a
        bucket span opened after the dispatch it covers)."""
        if not self.enabled:
            return NULL_SPAN
        if parent is not None and parent.enabled:
            tid, pid = parent.trace_id, parent.span_id
        else:
            tid, pid = (trace_id if trace_id is not None
                        else self.new_trace_id()), None
        span = Span(self, tid, next(_ids), pid, name,
                    self._now_us() if start_us is None else start_us)
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._open[span.span_id] = span
        return span

    def span_at(self, name: str, start_us: float, end_us: float,
                parent: Optional[Span] = None, **attrs):
        """Record an interval that already elapsed as a closed span: a
        stage whose bounds are known only afterwards (the ``device`` span
        runs from dispatch end to collect entered)."""
        if not self.enabled:
            return NULL_SPAN
        if parent is not None and parent.enabled:
            tid, pid = parent.trace_id, parent.span_id
        else:
            tid, pid = self.new_trace_id(), None
        span = Span(self, tid, next(_ids), pid, name, start_us)
        span.end_us = end_us
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._store(span)
        return span

    def _store(self, span: Span) -> None:  # caller holds the lock
        self._finished.append(span)
        if len(self._finished) > self.max_finished:
            drop = len(self._finished) - self.max_finished
            del self._finished[:drop]
            self._dropped += drop

    def _finish(self, span: Span) -> None:
        span.end_us = self._now_us()
        with self._lock:
            self._open.pop(span.span_id, None)
            self._store(span)

    def finished(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._finished)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._open.clear()
            self._finished.clear()
            self._dropped = 0

    def dump(self, trace_id: Optional[int] = None, limit: int = 50) -> str:
        """Span trees of the most recent ``limit`` traces (or of one
        trace), open spans flagged ``[open]``."""
        with self._lock:
            spans = list(self._finished) + list(self._open.values())
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return format_trace(spans, limit=limit)


def format_trace(spans: List[Span], limit: int = 50) -> str:
    """Render spans grouped by trace as indented trees, oldest first.  A
    child whose parent left the ring prints at root level with a
    ``parent=#id`` note."""
    by_trace: Dict[int, List[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    trace_ids = sorted(by_trace,
                       key=lambda t: min(s.start_us for s in by_trace[t]))
    if limit and len(trace_ids) > limit:
        trace_ids = trace_ids[-limit:]
    lines: List[str] = []
    for tid in trace_ids:
        members = sorted(by_trace[tid], key=lambda s: s.start_us)
        ids = {s.span_id for s in members}
        children: Dict[Optional[int], List[Span]] = {}
        for s in members:
            key = s.parent_id if s.parent_id in ids else None
            children.setdefault(key, []).append(s)
        lines.append(f"trace {tid}:")

        def walk(parent_key: Optional[int], depth: int) -> None:
            for s in children.get(parent_key, []):
                dur = (f"{s.duration_us:.0f}us" if s.end_us is not None
                       else "[open]")
                extra = ""
                if parent_key is None and s.parent_id is not None:
                    extra = f" parent=#{s.parent_id}"
                attrs = ""
                if s.attrs:
                    pairs = ", ".join(f"{k}={v!r}"
                                      for k, v in sorted(s.attrs.items()))
                    attrs = f"  {{{pairs}}}"
                lines.append("  " * (depth + 1)
                             + f"{s.name} #{s.span_id} {dur}{extra}{attrs}")
                walk(s.span_id, depth + 1)

        walk(None, 0)
    return "\n".join(lines)
