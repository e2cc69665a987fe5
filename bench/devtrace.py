"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
metrics read: device busy time, kernel time by name, the device operations
that took most time, and the longest idle gaps named by what the host was
doing.

The trace is the profiler's Chrome trace (``export_chrome_trace``): device
activity has the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``;
host activity ``cpu_op``, ``cuda_runtime``, ``cuda_driver``,
``python_function`` and ``user_annotation``.  The measured window is the
span of the harness's own ``bench.segment`` annotation.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")
SEGMENT = "bench.segment"
TOP = 10
# a breakdown names an operation by this many characters of its name
NAME_CHARS = 120


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


def _label(gap: Tuple[float, float], host: Sequence[Dict]) -> str:
    """What the host did in ``gap``: the shortest host event that covers at
    least half of it, else the one that overlaps it most; the harness's own
    ``bench.*`` annotations only where nothing else overlaps."""
    lo, hi = gap
    best, best_key = None, None
    for ev in host:
        a, b = ev["ts"], ev["ts"] + ev["dur"]
        overlap = min(b, hi) - max(a, lo)
        if overlap <= 0:
            continue
        own = ev["name"].startswith("bench.")
        covers = overlap >= 0.5 * (hi - lo)
        key = (own, not covers, ev["dur"] if covers else -overlap)
        if best_key is None or key < best_key:
            best, best_key = ev, key
    if best is None:
        return "host outside any traced call"
    if best_key[0]:
        return f"{best['name']}: host Python or NumPy, no torch call"
    return best["name"]


def reduce_trace(trace: Dict) -> Optional[Dict]:
    """Busy seconds, window seconds, device seconds by operation name and the
    idle gaps of a Chrome trace; None when it holds no ``bench.segment``
    annotation."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    seg = [e for e in events if e.get("name") == SEGMENT]
    if not seg:
        return None
    lo = min(e["ts"] for e in seg)
    hi = max(e["ts"] + e["dur"] for e in seg)
    device, by_name = [], {}
    for e in events:
        if e.get("cat", "").lower() not in DEVICE_CATS:
            continue
        a, b = max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])
        if b <= a:
            continue
        device.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(device)
    gaps, edge = [], lo
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    host = [e for e in events if e.get("cat", "").lower() in HOST_CATS
            and e.get("name") != SEGMENT]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_s": by_name,
        "device_ops": sorted(([n[:NAME_CHARS], s] for n, s in by_name.items()),
                             key=lambda r: -r[1])[:TOP],
        "idle_gaps": [[_label(g, host)[:NAME_CHARS], (g[1] - g[0]) * 1e-6]
                      for g in longest],
    }


def kernel_seconds(reduced: Dict, names: Sequence[str]) -> float:
    """Device seconds of the operations whose name holds any of ``names``
    (case-insensitive)."""
    keys = [n.lower() for n in names]
    return sum(s for op, s in reduced["device_s"].items()
               if any(k in op.lower() for k in keys))


class Profiled:
    """``with Profiled(torch) as p:`` profiles the block, host and device,
    inside a ``bench.segment`` annotation; afterwards ``p.reduced`` holds
    :func:`reduce_trace`'s numbers.  The Chrome trace goes to a temporary
    file under ``TMPDIR`` and is deleted once read."""

    def __init__(self, torch):
        self.torch = torch
        self.reduced: Optional[Dict] = None
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "Profiled":
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            self.torch.cuda.synchronize()
        self.prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(record_function(SEGMENT))
        return self

    def __exit__(self, *exc) -> bool:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._stack.close()
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    self.reduced = reduce_trace(json.load(f))
            finally:
                os.unlink(path)
        return False
