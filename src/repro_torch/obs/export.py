"""Exposition writers and parsers: Prometheus text format and JSON.

``to_prometheus`` / ``to_json`` serialize a ``MetricsRegistry.snapshot()``
dict; ``parse_prometheus`` / ``parse_json`` read them back, strictly enough
to reject a malformed exposition without a Prometheus binary.  The default
metric prefix is ``repro_``, as in the JAX package, so one dashboard reads
either package.

Histograms follow the Prometheus data model: cumulative ``_bucket{le=}``
series, then ``_sum`` and ``_count``.  Collector values (the
``EXEC_COUNTERS`` shim) export as gauges under their collected names.

:class:`SnapshotRing` is the buffer the async flusher feeds: a bounded deque
of ``(t_monotonic, snapshot)`` pairs, so the last N consistent cuts survive
for a post-mortem (and rates follow from adjacent entries).
"""
from __future__ import annotations

import json
import re
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["to_prometheus", "to_json", "parse_prometheus", "parse_json",
           "SnapshotRing"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LINE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'          # metric name
    r'(?:\{([^}]*)\})?'                     # optional labels
    r'\s+([+-]?(?:[0-9.eE+-]+|[Ii]nf|NaN))$')  # value


def _sanitize(name: str) -> str:
    """Prometheus metric names are [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = _NAME_RE.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def to_prometheus(snapshot: Dict, prefix: str = "repro_") -> str:
    """Render a registry snapshot as Prometheus text exposition v0.0.4."""
    lines: List[str] = []

    def emit(name: str, kind: str, value: float,
             labels: Optional[str] = None, typed: bool = True) -> None:
        full = _sanitize(prefix + name)
        if typed:
            lines.append(f"# TYPE {full} {kind}")
        lines.append(f"{full}{{{labels}}} {_fmt(value)}" if labels
                     else f"{full} {_fmt(value)}")

    for name in sorted(snapshot.get("counters", {})):
        emit(name, "counter", snapshot["counters"][name])
    for name in sorted(snapshot.get("gauges", {})):
        emit(name, "gauge", snapshot["gauges"][name])
    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name]
        full = _sanitize(prefix + name)
        lines.append(f"# TYPE {full} histogram")
        cum = 0
        for bound, c in zip(h["buckets"], h["counts"]):
            cum += c
            lines.append(f'{full}_bucket{{le="{_fmt(bound)}"}} {cum}')
        cum += h["counts"][len(h["buckets"])]
        lines.append(f'{full}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{full}_sum {_fmt(h['sum'])}")
        lines.append(f"{full}_count {h['count']}")
    for name in sorted(snapshot.get("collected", {})):
        emit(name, "gauge", snapshot["collected"][name])
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict]:
    """Parse a text exposition back to
    ``{name: {"type": str, "value": float}}`` for scalar series and
    ``{name: {"type": "histogram", "buckets": [(le, cum)], "sum", "count"}}``
    for histograms; a malformed line raises ValueError."""
    types: Dict[str, str] = {}
    out: Dict[str, Dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {raw!r}")
        name, labels, value_s = m.group(1), m.group(2), m.group(3)
        value = float(value_s.replace("Inf", "inf"))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(name[:-len(suffix)]) \
                    == "histogram":
                base = name[:-len(suffix)]
                break
        if types.get(base) == "histogram":
            h = out.setdefault(base, {"type": "histogram", "buckets": [],
                                      "sum": 0.0, "count": 0})
            if name.endswith("_bucket"):
                le_m = re.search(r'le="([^"]+)"', labels or "")
                if le_m is None:
                    raise ValueError(f"histogram bucket without le: {raw!r}")
                le = float(le_m.group(1).replace("+Inf", "inf"))
                h["buckets"].append((le, value))
            elif name.endswith("_sum"):
                h["sum"] = value
            else:
                h["count"] = int(value)
        else:
            out[name] = {"type": types.get(name, "untyped"),
                         "value": value}
    for h in out.values():
        if h.get("type") == "histogram":
            les = [le for le, _ in h["buckets"]]
            cums = [c for _, c in h["buckets"]]
            if les != sorted(les) or cums != sorted(cums):
                raise ValueError("histogram buckets not cumulative")
    return out


def to_json(snapshot: Dict, indent: Optional[int] = None) -> str:
    """JSON exposition: the snapshot dict is already JSON-shaped."""
    return json.dumps(snapshot, indent=indent, sort_keys=True)


def parse_json(text: str) -> Dict:
    snap = json.loads(text)
    for section in ("counters", "gauges", "histograms", "collected"):
        if section not in snap:
            raise ValueError(f"snapshot missing section {section!r}")
    for name, h in snap["histograms"].items():
        if len(h["counts"]) != len(h["buckets"]) + 1:
            raise ValueError(f"histogram {name!r}: counts/buckets mismatch")
        if sum(h["counts"]) != h["count"]:
            raise ValueError(f"histogram {name!r}: count != sum(counts)")
    return snap


class SnapshotRing:
    """Bounded ring of ``(t, snapshot)`` pairs: the flusher pushes one
    consistent cut every ``snapshot_every_s`` while serving."""

    def __init__(self, maxlen: int = 64):
        self._ring: deque = deque(maxlen=max(1, int(maxlen)))
        self._lock = threading.Lock()

    def push(self, t: float, snapshot: Dict) -> None:
        with self._lock:
            self._ring.append((t, snapshot))

    def entries(self) -> List[Tuple[float, Dict]]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> Optional[Tuple[float, Dict]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
