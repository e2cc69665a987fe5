"""A whole run of each cell on the CPU at a tiny size, past the look for a
card: sound, it is correct; with the timed path broken underneath, or with
the float32 control in the program's place, ``correct`` comes out false.

The faults are planted in the program's own functions for the length of a
test (``monkeypatch``): an answer altered where the device pass produces it,
half of a bucket's rows left out, and an answer of the host HashBin route
altered."""
import time

import numpy as np
import pytest
import torch

from bench import harness, reference


def run(spec, seed=2 ** 31 + 77, seconds=0.6):
    return harness.run(spec, seed, seconds, trace=False,
                       started_at=time.perf_counter(), device="cpu",
                       require_card=False)


def altered_pass(engine, how):
    real = engine._intersect_k_batch

    def broken(vals, images, ts, capacity):
        packed, r, n_surv, overflow = real(vals, images, ts, capacity)
        packed = packed.clone()
        if how == "alter":
            row = packed[0]
            row[row >= 0] = row[row >= 0] ^ 1
        else:  # half of the bucket's rows left out
            packed[packed.shape[0] // 2:] = -1
        return packed, r, n_surv, overflow

    return broken


CELLS = ["skewed-batch", "paper10m-batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_spec):
    out = run(tiny_spec(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = set(out["metrics"])
    assert "setup_s" in names and len(names) >= 2


def test_an_unknown_traffic_mode_is_refused(tiny_spec):
    spec = tiny_spec("paper10m-batch")
    spec["traffic"]["mode"] = "open_poisson"
    with pytest.raises(ValueError, match="traffic mode"):
        run(spec)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("how", ["alter", "half"])
def test_broken_device_pass_is_not_correct(cell, how, tiny_spec, monkeypatch):
    from repro_torch.core import engine

    monkeypatch.setattr(engine, "_intersect_k_batch", altered_pass(engine, how))
    out = run(tiny_spec(cell))
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_broken_hashbin_route_is_not_correct(tiny_spec, monkeypatch):
    from repro_torch.serve import search

    real = search.hashbin

    def broken(a, b):
        res, stats = real(a, b)
        return (res[1:] if len(res) else np.asarray([7], np.uint32)), stats

    monkeypatch.setattr(search, "hashbin", broken)
    spec = tiny_spec("skewed-batch")
    # skewed pairs, so the planner sends most pairs to HashBin
    spec["config"]["lengths"] = [64, 80000, 64, 90000, 70, 100000, 72, 110000]
    out = run(spec)
    assert not out["correct"]


def test_float32_control_in_the_programs_place_is_not_correct(tiny_spec,
                                                               monkeypatch):
    from repro_torch.serve import search

    spec = tiny_spec("skewed-batch")
    spec["config"]["universe_bits"] = 25   # ids past 2^24, as configured

    def control_batch(self, queries):
        lists = {t: torch.from_numpy(np.sort(idx.values).astype(np.int64))
                 for t, idx in self.index.items()}
        out = []
        for q in queries:
            got = reference.control_intersect([lists[t] for t in set(q)])
            out.append(search.QueryResult(got.numpy().astype(np.uint32), 0.0,
                                          "control", {}))
        return out

    monkeypatch.setattr(search.SearchEngine, "query_batch", control_batch)
    out = run(spec)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0
