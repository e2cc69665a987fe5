"""The benchmark's arithmetic on hand-worked cases: the window rule,
spreads, the two phases' bytes, and the readers over a run's record."""
import pytest

from bench import arith, harness, readers


def test_window_qps_counts_the_last_call():
    # three calls of 128 answered in 3.2 s: the last return ends the window
    assert arith.window_qps(384, 10.0, 13.2) == pytest.approx(120.0)
    with pytest.raises(ValueError):
        arith.window_qps(1, 2.0, 2.0)


def test_spread_is_quartile_distance_over_median():
    assert arith.spread([10, 10, 10, 10]) == 0.0
    assert arith.spread([8, 9, 10, 11, 12]) == pytest.approx(3.0 / 10.0)


def test_choose_t_is_the_papers():
    assert arith.choose_t(10_000_000, 256) == 20   # 625,000 groups' worth
    assert arith.choose_t(4096, 256) == 8
    assert arith.choose_t(16, 256) == 0
    assert arith.choose_t(1, 256) == 0


def test_phase1_bytes_hand_worked():
    # n = 4096 and 65,536 at w 256: t = 8 and 12; 2^t groups x m 2 x 32 B,
    # plus one flag byte per group tuple at t = 12
    assert arith.phase1_bytes([4096, 65536], 256, 2) == (
        256 * 64 + 4096 * 64 + 4096)
    # equal sets: the (k, G) stack the program builds equals the work
    assert arith.phase1_bytes([10_000_000] * 3, 256, 2) == (
        3 * (1 << 20) * 64 + (1 << 20))


def test_phase2_bytes_hand_worked():
    # 1000 survivors; groups of 4096 / 256 = 16 and 65,536 / 4096 = 16 ids,
    # 4 B each, read once; one flag per base id (the t = 8 set's 16)
    assert arith.phase2_bytes([65536, 4096], 256, 1000) == (
        1000 * 16 * 4 * 2 + 1000 * 16)
    # 10M over 2^20 groups: 9.5367 ids a group
    g = 10_000_000 / (1 << 20)
    assert arith.phase2_bytes([10_000_000] * 2, 256, 200_000) == (
        pytest.approx(200_000 * g * 4 * 2 + 200_000 * g))


def test_phase2_work_credits_the_survivors_once():
    stats = {"tuples_survived": 300_000, "capacity": 1 << 20}   # a re-run
    assert readers.phase2_work([10_000_000] * 2, 256, 2, stats) == (
        arith.phase2_bytes([10_000_000] * 2, 256, 300_000))
    stats = {"tuples_survived": 100_000, "capacity": 1 << 18}
    assert readers.phase2_work([10_000_000] * 2, 256, 2, stats) == (
        arith.phase2_bytes([10_000_000] * 2, 256, 100_000))


def test_roofline_percent():
    # 3.35e9 bytes in 2 ms: 1 ms at the peak, 50%
    assert arith.roofline_percent(3.35e9, 2e-3) == pytest.approx(50.0)
    assert arith.roofline_percent(1e9, 0.0) is None
    assert arith.roofline_percent(0, 1.0) is None


def test_roofline_reads_the_segment_only():
    class Res:
        algorithm = readers.DEVICE_ROUTE
        stats = {"tuples_survived": 10, "capacity": 64}

    def req(in_segment):
        return {"terms": (0, 1), "result": Res(), "in_segment": in_segment,
                "in_window": not in_segment}

    record = {"config": {"engine": {"w": 256, "m": 2}},
              "lengths": [4096, 65536],
              "requests": [req(True), req(False), req(True)],
              "segment": {"reduced": {"device_s": {"bitmap_filter_w8": 1e-3,
                                                    "group_match_kernel": 1e-3,
                                                    "elementwise": 5.0}}}}
    want = 2 * arith.phase1_bytes([4096, 65536], 256, 2)
    got = readers.roofline(record, ("bitmap_filter",), readers.phase1_work)
    assert got == pytest.approx(arith.roofline_percent(want, 1e-3))


@pytest.mark.parametrize("name", ["phase1_roofline.batch",
                                  "phase2_roofline.batch",
                                  "device_idle_share.batch"])
def test_trace_readers_read_nothing_without_a_segment(name):
    # a run without a trace has nothing for them: no number, never 0
    record = {"config": {"engine": {"w": 256, "m": 2}}, "lengths": [4096],
              "requests": [], "segment": None}
    assert harness.load_reader(name)(record) is None


def test_counter_readers_read_nothing_from_an_idle_window():
    record = {"requests": [], "window": {"seconds": 1.0, "counters": {}}}
    assert harness.load_reader("collect_share.batch")(record) is None
    assert harness.load_reader("passes_per_query.batch")(record) is None
