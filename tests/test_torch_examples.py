"""The port's runnable examples, ``examples/*_torch.py``, on the CPU.

Each twin's ``main`` runs in this process with ``--torch-device cpu`` at
small flags and must reach its own check: every answer equals the oracle
(numpy set routines over the postings), every constrained token lies in
the intersection of the constraint sets, and the loss after the restart
is below the first.  ``train_lm_torch``'s resumed losses also equal, bit
for bit, its first run's carried on in memory.
"""
import argparse
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.train.loop import to_device
from repro_torch.train.step import build_train_step

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
EXPR = re.compile(r"^\((\d+)\|(\d+)\)&(\d+)(?:-(\d+))?$")


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def oracle(postings, query) -> np.ndarray:
    """A term list's intersection, or ``to_expr_log``'s ``(a|b)&c[-d]``."""
    if isinstance(query, str):
        a, b, c, d = EXPR.match(query).groups()
        out = np.intersect1d(np.union1d(postings[int(a)], postings[int(b)]),
                             postings[int(c)])
        return out if d is None else np.setdiff1d(out, postings[int(d)])
    out = postings[query[0]]
    for t in query[1:]:
        out = np.intersect1d(out, postings[t])
    return out


def test_quickstart_torch_matches_the_oracle(capsys):
    out = load("quickstart_torch").main(["--torch-device", "cpu"])
    assert np.array_equal(out["device_result"], out["truth"])
    assert out["device_stats"]["r"] == len(out["truth"]) == 558
    assert "all results match the oracle ✓" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    [], ["--host"], ["--async-front"], ["--expr", "--device"],
    ["--mesh", "2x2"],
], ids=["plain", "host", "async_front", "expr_device", "mesh_2x2"])
def test_serve_search_torch_answers_equal_the_oracle(flags):
    out = load("serve_search_torch").main(
        ["--docs", "2000", "--queries", "50", "--torch-device", "cpu"] + flags)
    assert len(out["doc_ids"]) == len(out["queries"]) == 50
    if "--expr" in flags:
        assert any(isinstance(q, str) for q in out["queries"])
    if "--async-front" not in flags:
        on_device = [a for a in out["algorithms"] if "/" in a]
        # the plain mode serves through the device engine unless --host
        assert bool(on_device) == ("--host" not in flags), out["algorithms"]
    for q, got in zip(out["queries"], out["doc_ids"]):
        want = oracle(out["postings"], q)
        np.testing.assert_array_equal(np.asarray(got, dtype=np.int64),
                                      want.astype(np.int64), err_msg=str(q))


def test_constrained_decode_torch_keeps_to_the_intersection(capsys):
    out = load("constrained_decode_torch").main(["--torch-device", "cpu"])
    reqs, allowed = out["requests"], out["allowed"]
    assert len(allowed) == 110
    assert all(r.done and len(r.out) == 8 for r in reqs)
    for r in reqs[:2]:
        assert set(r.out) <= allowed
    assert reqs[2].constraint is None
    assert "respected the bitmap intersection ✓" in capsys.readouterr().out


@pytest.fixture
def one_thread():
    """One intra-op thread: with several, the CPU's float32 products may
    split their sums differently from run to run (the demo model's are
    large enough to be threaded), and bit-for-bit equality between two
    runs would depend on the split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_lm_torch_resumes_bit_for_bit_and_learns(tmp_path, capsys,
                                                       one_thread):
    """20 steps: 10, a "crash", a restart from the checkpoint, 10 more.  The
    loss falls, and the restarted half's losses equal, bit for bit, those
    of the first run carried on in memory (the same step function over the
    same mesh, with no checkpoint between)."""
    mod = load("train_lm_torch")
    out = mod.main(["--torch-device", "cpu", "--steps", "20", "--ckpt",
                    str(tmp_path / "split")])
    assert out["improved"] and "improved ✓" in capsys.readouterr().out
    first, second = out["first"], out["second"]
    assert [h["step"] for h in first["history"] + second["history"]] == \
        list(range(20))
    model, mesh, data, opt, _, steps = mod.setup(argparse.Namespace(
        full=False, steps=20, ckpt=str(tmp_path / "unused"),
        torch_device="cpu"))
    assert mesh.devices.shape == (1, 1)
    fn, _, _ = build_train_step(model, mesh, opt_cfg=opt)
    params, state, straight = first["params"], first["opt_state"], []
    for i in range(first["final_step"], steps):
        params, state, m = fn(params, state, to_device(data.batch_at(i),
                                                       "cpu"))
        straight.append(m["loss"].item())
    assert [h["loss"] for h in second["history"]] == straight
