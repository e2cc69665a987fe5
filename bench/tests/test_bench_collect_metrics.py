"""The readers of the collect's parts, the bytes copied to the host, host
plans and the passes' device time: each on a hand-made record (its value,
and no reading when its counter did not move, as on a program that lacks
the counter), then a tiny traced run of each cell on the CPU."""
import time
from types import SimpleNamespace

import pytest

from bench import harness
from bench.readers import DEVICE_ROUTE

SHARES = {  # metric: the EXEC_COUNTERS key it reads over the window
    "collect_wait_share.batch": "collect_wait_us",
    "collect_copy_share.batch": "collect_copy_us",
    "collect_filter_share.batch": "collect_filter_us",
    "host_plan_share.batch": "host_plan_us",
    "pass_device_share.batch": "pass_device_us",
}


def request(algorithm, n_ids, in_window=True):
    result = SimpleNamespace(algorithm=algorithm, doc_ids=list(range(n_ids)))
    return {"terms": (1, 2), "result": result, "error": None,
            "in_window": in_window, "in_segment": not in_window}


def record(counters):
    return {"window": {"t0": 0.0, "t1": 2.0, "seconds": 2.0,
                       "counters": counters},
            "requests": [request("rangroupscan/device", 100),
                         request("rangroupscan/device", 50),
                         request("hashbin", 1000),
                         request("rangroupscan/device", 7000, False)]}


@pytest.mark.parametrize("name", sorted(SHARES))
def test_share_reads_its_counter_over_the_window(name):
    read = harness.load_reader(name)
    assert read(record({SHARES[name]: 500_000})) == pytest.approx(25.0)
    assert read(record({SHARES[name]: 0})) is None
    assert read(record({})) is None


def test_copy_amplification_over_the_device_answers_of_the_window():
    read = harness.load_reader("copy_amplification.batch")
    # 150 ids answered on the device in the window: 600 bytes
    assert read(record({"d2h_bytes": 6000})) == pytest.approx(10.0)
    assert read(record({"d2h_bytes": 0})) is None
    assert read(record({})) is None
    empty = record({"d2h_bytes": 6000})
    empty["requests"] = [request("rangroupscan/device", 0)]
    assert read(empty) is None


@pytest.mark.parametrize("cell", ["skewed-batch", "paper10m-batch"])
def test_traced_tiny_run_reads_the_new_metrics(cell, tiny_spec, monkeypatch):
    """Every new metric the cell reports reads a number exactly when its
    counter moved in the window; the filter and the bytes always move on
    the CPU (no ready event to wait on there, and no device clock)."""
    records = []
    real = harness.load_reader

    def spied(name, *args):
        read = real(name, *args)

        def reading(record):
            records.append(record)
            return read(record)

        return reading

    monkeypatch.setattr(harness, "load_reader", spied)
    spec = tiny_spec(cell)
    out = harness.run(spec, 2 ** 31 + 91, 0.6, trace=True,
                      started_at=time.perf_counter(), device="cpu",
                      require_card=False)
    assert out["correct"], out["checks"]
    counters = records[0]["window"]["counters"]
    assert counters["collect_filter_us"] > 0 and counters["d2h_bytes"] > 0
    assert counters["pass_device_us"] == 0
    moved = {name for name, key in SHARES.items() if counters.get(key)}
    if sum(len(r["result"].doc_ids) for r in records[0]["requests"]
           if r["in_window"] and r["result"].algorithm == DEVICE_ROUTE):
        moved.add("copy_amplification.batch")
    reported = {m["name"] for m in spec["per_layer"]}
    new = (set(SHARES) | {"copy_amplification.batch"}) & reported
    assert "collect_filter_share.batch" in new
    assert {n for n in new if n in out["metrics"]} == moved & new
    for name in moved & new:
        assert out["metrics"][name]["value"] > 0, name
