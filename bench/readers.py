"""What the metric files under ``bench/metrics/`` share: the requests of the
window or the traced segment, and the two phases' work over the segment.

A run's record (``bench/harness.py``) holds ``requests`` (each with its
``terms``, the program's ``result`` or an ``error``, and whether it falls in
the window or the segment), the window's host-clock span and counter deltas,
and the segment's reduced trace.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from bench import arith
from bench.devtrace import kernel_seconds

DEVICE_ROUTE = "rangroupscan/device"


def window(record: Dict) -> List[Dict]:
    return [r for r in record["requests"] if r["in_window"]]


def answered(requests: Sequence[Dict]) -> List[Dict]:
    return [r for r in requests if r["result"] is not None]


def device_routed(requests: Sequence[Dict]) -> List[Dict]:
    return [r for r in answered(requests)
            if r["result"].algorithm == DEVICE_ROUTE]


def counter(record: Dict, name: str) -> int:
    return record["window"]["counters"].get(name, 0)


def idle_percent(record: Dict) -> Optional[float]:
    reduced = (record.get("segment") or {}).get("reduced")
    if not reduced or reduced["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])


def roofline(record: Dict, kernels: Sequence[str], work) -> Optional[float]:
    """Share of the peak memory rate that ``work(ns, w, m, stats)`` bytes,
    summed over the segment's device-routed queries, reach in the device
    time of the kernels named ``kernels``."""
    reduced = (record.get("segment") or {}).get("reduced")
    if not reduced:
        return None
    eng = record["config"]["engine"]
    w, m = int(eng.get("w", 256)), int(eng.get("m", 2))
    lengths = record["lengths"]
    seg = [r for r in record["requests"] if r["in_segment"]]
    total = sum(work([lengths[t] for t in r["terms"]], w, m, r["result"].stats)
                for r in device_routed(seg))
    return arith.roofline_percent(total, kernel_seconds(reduced, kernels))


def phase1_work(ns, w: int, m: int, stats: Dict) -> float:
    return arith.phase1_bytes(ns, w, m)


def phase2_work(ns, w: int, m: int, stats: Dict) -> float:
    """Over the survivors the answering pass kept: all of them, since an
    answer that came back covered every survivor (an overflow re-run is
    the implementation's, and not credited)."""
    kept = min(int(stats["tuples_survived"]), int(stats["capacity"]))
    return arith.phase2_bytes(ns, w, kept)
