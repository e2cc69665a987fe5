"""The port's ``DecodeServer`` against the JAX package's, on the CPU.

Both servers get the same model (JAX's ``init(PRNGKey(0))`` weights,
carried across through ``params_from_jax``), the same constraint sets and
the same requests; every ``_decode`` call's logits are recorded in both.
The logits must agree within ``FP32_TOL`` 1e-5 of their largest magnitude
(float32 through two layers summed in other orders; see
``test_torch_lm_models.py``), call for call, and the generated tokens must
be equal.  Scripts: ``examples/constrained_decode.py``,
``tests/test_substrate.py::test_decode_server_constrained``, the JAX
server's cross-slot cache writes (a request's tokens depend on what shares
its batch; the port keeps that), a prompt longer than ``max_seq`` (the
cache write clamps to the last row), and the background ticker.
"""
import threading

import numpy as np
import pytest
import torch

from repro.serve.engine import DecodeServer as JaxDecodeServer
from repro.serve.engine import Request as JaxRequest

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import EXEC_COUNTERS
from repro_torch.models.model import build_model
from repro_torch.serve.engine import DecodeServer, Request

from _torch_lm import (
    CPU, FP32_TOL, assert_same_run, make_pair, serve_both,
)

# examples/constrained_decode.py's model and tests/test_substrate.py's TINY
DEMO = dict(name="demo-tiny", family="dense", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, dtype="float32",
            param_dtype="float32")
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, dtype="float32",
            param_dtype="float32")


@pytest.fixture(autouse=True)
def _reset_port_counters():
    EXEC_COUNTERS.reset()
    yield


def test_constrained_decode_example_matches_jax():
    """``examples/constrained_decode.py``: three masks (two allowed sets and
    a stop-list) ANDed; two constrained requests and a free one."""
    rng = np.random.default_rng(0)
    grammar = rng.choice(512, 200, replace=False)
    whitelist = rng.choice(512, 300, replace=False)
    allowed = set(np.intersect1d(grammar, whitelist).tolist()) - set(range(10))
    out, jout, calls, jcalls, _, _ = serve_both(
        make_pair(DEMO),
        [([1, 2, 3], 8, "c"), ([4, 5], 8, "c"), ([7, 8, 9], 8, None)],
        batch_slots=2, max_seq=64,
        constraints={"c": ([grammar, whitelist], [np.arange(10)])})
    assert_same_run(out, jout, calls, jcalls)
    assert all(len(o) == 8 for o in out)
    assert set(out[0] + out[1]) <= allowed


def test_decode_server_constrained_script_matches_jax():
    """``tests/test_substrate.py::test_decode_server_constrained``."""
    allowed = np.arange(10, 40)
    out, jout, calls, jcalls, _, _ = serve_both(
        make_pair(TINY), [([1, 2], 4, "only"), ([3], 4, None)],
        batch_slots=2, max_seq=32, constraints={"only": ([allowed], [])})
    assert_same_run(out, jout, calls, jcalls)
    assert len(out[0]) == 4 and set(out[0]) <= set(allowed.tolist())
    assert len(out[1]) == 4


def test_decode_server_cross_slot_writes_match_jax():
    """The JAX server decodes the whole batch at one slot's position, so
    every row writes its K/V there: request [1, 2] decodes other tokens
    beside [3, 4, 5] than alone.  The port reproduces both runs."""
    pair = make_pair(arch="qwen3-1.7b")
    alone = serve_both(pair, [([1, 2], 6, None)], batch_slots=2, max_seq=32)
    beside = serve_both(pair, [([1, 2], 6, None), ([3, 4, 5], 6, None)],
                        batch_slots=2, max_seq=32)
    for out, jout, calls, jcalls, _, _ in (alone, beside):
        assert_same_run(out, jout, calls, jcalls)
    assert alone[0][0] != beside[0][0]


@pytest.mark.parametrize("prompt_len,max_seq", [(24, 16), (16, 16), (15, 16)])
def test_prompt_longer_than_max_seq_clamps_as_jax(prompt_len, max_seq):
    """``_admit`` feeds the whole prompt, so positions pass ``max_seq``;
    JAX's ``dynamic_update_slice`` writes them at the last row."""
    prompt = np.random.default_rng(prompt_len).integers(0, 256, prompt_len)
    out, jout, calls, jcalls, srv, jsrv = serve_both(
        make_pair(TINY), [(prompt, 4, None), ([5, 6], 3, None)],
        batch_slots=2, max_seq=max_seq)
    assert_same_run(out, jout, calls, jcalls)
    for name in ("k", "v"):
        got, want = srv.cache[name].numpy(), np.asarray(jsrv.cache[name])
        assert np.abs(got - want).max() <= FP32_TOL * np.abs(want).max()
    assert srv.ticks == jsrv.ticks


def test_ticker_matches_jax():
    """``start()``, four requests submitted from two threads, wait on the
    tickets, ``stop()``.  One slot, so a request's tokens do not depend on
    the order the threads submit in (each starts at position 0 and the
    rows past its position are masked)."""
    pair = make_pair(TINY)
    rng = np.random.default_rng(11)
    scripts = [(rng.integers(0, 256, n), m, None)
               for n, m in ((3, 5), (1, 4), (6, 3), (2, 6))]
    _, jout, _, _, _, _ = serve_both(pair, scripts, batch_slots=1, max_seq=32)
    EXEC_COUNTERS.reset()
    srv = DecodeServer(pair.model, pair.params, batch_slots=1,
                       max_seq=32).start()
    reqs = [Request(prompt=np.asarray(p), max_new=m) for p, m, _ in scripts]
    tickets = [None] * len(reqs)

    def submit(idx):
        for i in idx:
            tickets[i] = srv.submit(reqs[i])
    threads = [threading.Thread(target=submit, args=(idx,))
               for idx in ([0, 2], [1, 3])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for t in tickets:
        assert t.wait(timeout=120)
    ticker = srv._ticker
    srv.stop()
    assert not ticker.is_alive()
    assert [t.value for t in tickets] == [r.out for r in reqs] == jout
    assert EXEC_COUNTERS["tickets_resolved"] == len(reqs)


def test_run_until_drained_raises_as_jax():
    pair = make_pair(TINY)
    srv = DecodeServer(pair.model, pair.params, batch_slots=1, max_seq=32)
    jsrv = JaxDecodeServer(pair.jmodel, pair.jparams, batch_slots=1,
                           max_seq=32)
    for s, req in ((srv, Request), (jsrv, JaxRequest)):
        s.submit(req(prompt=np.array([1]), max_new=10))
        with pytest.raises(RuntimeError, match="did not drain"):
            s.run_until_drained(max_ticks=3)
    assert srv.ticks == jsrv.ticks == 4


def test_decode_server_on_cuda_without_gpu_raises(monkeypatch):
    """The server serves on its model's device; a model on the card comes
    only from ``build_model``, which raises without a GPU."""
    pair = make_pair(TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(ArchConfig(**TINY))
    assert DecodeServer(pair.model, pair.params).device == torch.device(CPU)
