"""The trace reduction on a hand-made Chrome trace: busy time is the union of
device intervals inside the segment, gaps are named by the host, and kernel
time is summed by name."""
import pytest

from bench import devtrace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    ev("bench.segment", "user_annotation", 1000, 1000),
    ev("bench.query_batch", "user_annotation", 1000, 1000),
    ev("bitmap_filter_w8(...)", "kernel", 900, 200),      # 100 inside
    ev("group_match_kernel(...)", "kernel", 1150, 100),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1200, 300),
    ev("group_match_kernel(...)", "kernel", 1700, 50),
    ev("cudaEventSynchronize", "cuda_runtime", 1500, 180),
    ev("aten::index_select", "cpu_op", 1690, 5),
    ev("outside", "kernel", 2500, 10),
    {"ph": "i", "name": "marker", "ts": 1100},
]}


def test_reduce_trace_busy_gaps_and_names():
    red = devtrace.reduce_trace(TRACE)
    assert red["window_s"] == pytest.approx(1000e-6)
    # [1000, 1100] + [1150, 1500] + [1700, 1750]
    assert red["busy_s"] == pytest.approx(500e-6)
    assert red["device_s"]["bitmap_filter_w8(...)"] == pytest.approx(100e-6)
    assert red["device_s"]["group_match_kernel(...)"] == pytest.approx(150e-6)
    assert "outside" not in red["device_s"]
    gaps = dict((round(s * 1e6), name) for name, s in red["idle_gaps"])
    assert gaps[250] == "bench.query_batch: host Python or NumPy, no torch call"
    assert gaps[200] == "cudaEventSynchronize"
    assert gaps[50].startswith("bench.query_batch")
    assert red["device_ops"][0][0] == "Memcpy DtoH (Device -> Pageable)"


def test_kernel_seconds_by_name():
    red = devtrace.reduce_trace(TRACE)
    assert devtrace.kernel_seconds(red, ("group_match",)) == pytest.approx(150e-6)
    assert devtrace.kernel_seconds(red, ("BITMAP_FILTER",)) == pytest.approx(100e-6)
    assert devtrace.kernel_seconds(red, ("pair_count",)) == 0


def test_no_segment_no_reading():
    assert devtrace.reduce_trace({"traceEvents": []}) is None


def test_profiled_on_the_host():
    import torch

    with devtrace.Profiled(torch) as prof:
        torch.ones(1000).cumsum(0)
    assert prof.reduced is not None
    assert prof.reduced["window_s"] > 0
