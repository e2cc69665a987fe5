"""The port's checkpoints and training loop against the JAX package's, on
the CPU.

Checkpoints: the port writes the JAX package's layout, so each package
restores the other's (parameters and AdamW state of xlstm-350m's smoke
config, whose mLSTM blocks stack on two axes), equal leaf for leaf; a
write goes through a ``tmp.*`` directory and one rename; ``gc_old`` keeps
the newest; a misshapen or missing leaf raises.  The loop: the port's run
of 6 steps against 3 steps, a checkpoint and a resume to 6, losses bit
for bit; the port's loss history against ``repro.train.loop.train`` (on a
1 x 1 mesh of ``Auto`` axes) from one shared step-0 checkpoint written by
JAX, within ``FP32_TOL``; a SIGTERM mid-run saves and stops.
"""
import os
import pathlib
import signal

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticLMData as JaxSyntheticLMData
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.train import checkpoint as jax_ckpt
from repro.train import loop as jax_loop

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.convert import named_to_numpy, params_to_numpy
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, loop, step

from _torch_lm import FP32_TOL, assert_tree_close, auto_mesh, pair

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
QUIET = dict(log_fn=lambda *_: None)


def jax_state(jparams):
    return {"params": jparams,
            "opt": jax_adamw.init(jax_adamw.AdamWConfig(), jparams)}


def assert_same_state(port, jax_tree):
    assert_tree_close(params_to_numpy(port["params"]), jax_tree["params"], 0)
    opt = port["opt"]
    assert int(opt.step) == int(jax_tree["opt"].step)
    assert_tree_close(named_to_numpy(opt.m.items()), jax_tree["opt"].m, 0)
    assert_tree_close(named_to_numpy(opt.v.items()), jax_tree["opt"].v, 0)


def bumped(jtree, step):
    """A JAX state with m, v and step moved off their zeros."""
    opt = jtree["opt"]
    bump = lambda t, c: jax.tree_util.tree_map(lambda a: a + c, t)  # noqa: E731
    return {"params": jtree["params"], "opt": jax_adamw.AdamWState(
        step=opt.step + step, m=bump(opt.m, 0.25), v=bump(opt.v, 0.5))}


def test_port_restores_jax_checkpoints(tmp_path):
    _, jmodel, jparams, cfg, model, _ = pair("xlstm-350m")
    jtree = bumped(jax_state(jparams), 7)
    jax_ckpt.save(str(tmp_path), 7, jtree, extra={"data_step": 7})
    like = {"params": step.abstract_params(model),
            "opt": adamw.init(adamw.AdamWConfig(),
                              step.abstract_params(model))}
    at, got, extra = checkpoint.restore(str(tmp_path), like, device="cpu")
    assert (at, extra) == (7, {"data_step": 7})
    assert got["params"].embed.device.type == "cpu"
    assert all(p.device.type == "meta" for p in like["params"].parameters())
    assert_same_state(got, jtree)


def test_jax_restores_port_checkpoints(tmp_path):
    _, jmodel, jparams, cfg, model, params = pair("xlstm-350m")
    opt = adamw.init(adamw.AdamWConfig(), params)
    for t in list(opt.m.values()) + list(opt.v.values()):
        t.add_(torch.rand(t.shape, generator=torch.Generator().manual_seed(1)))
    opt = adamw.AdamWState(opt.step + 4, opt.m, opt.v)
    path = checkpoint.save(str(tmp_path), 4, {"params": params, "opt": opt})
    assert pathlib.Path(path).name == "step_00000004"
    with np.load(pathlib.Path(path) / "opt.npz") as z:
        keys = set(z.files)
        assert z[".step"].dtype == np.int32 and z[".step"].shape == ()
    jtree = jax_state(jparams)
    assert keys == set(jax_ckpt._flatten(jtree["opt"]))
    at, out, _ = jax_ckpt.restore(str(tmp_path), jtree)
    assert at == 4
    assert_same_state({"params": params, "opt": opt}, out)


def test_save_is_atomic_and_gc_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.arange(3.0), "y": [np.ones((2, 2)), torch.zeros(1)]}
    (tmp_path / "tmp.9.1.deadbeef").mkdir()     # a crash mid-write
    assert checkpoint.latest_step(d) is None
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(d, s, {"state": tree})
    assert not any(p.name.startswith("tmp.") and p.name != "tmp.9.1.deadbeef"
                   for p in tmp_path.iterdir())
    checkpoint.gc_old(d, keep=2)
    assert checkpoint.latest_step(d) == 5
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_")) == [
        "step_00000004", "step_00000005"]
    at, out, _ = checkpoint.restore(d, {"state": tree}, step=4, device="cpu")
    assert at == 4 and torch.equal(out["state"]["x"], tree["x"])
    np.testing.assert_array_equal(out["state"]["y"][0], np.ones((2, 2)))
    # the JAX package reads the same tree
    _, jout, _ = jax_ckpt.restore(d, {"state": {
        "x": np.zeros(3), "y": [np.zeros((2, 2)), np.zeros(1)]}})
    np.testing.assert_array_equal(jout["state"]["x"], [0.0, 1.0, 2.0])


def test_restore_refuses_a_misshapen_or_missing_leaf(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"state": {"x": torch.ones(3)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(d, {"state": {"x": torch.ones(4)}}, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(d, {"state": {"z": torch.ones(3)}}, device="cpu")
    _, _, _, _, model, params = pair("qwen3-1.7b")
    checkpoint.save(d, 2, {"params": params})
    wide = build_model(smoke_config(get_config("starcoder2-3b")),
                       device="cpu")
    with pytest.raises((KeyError, ValueError)):
        checkpoint.restore(d, {"params": step.abstract_params(wide)},
                           device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), {}, device="cpu")


def tiny():
    cfg = smoke_config(get_config("qwen3-1.7b"))
    data = SyntheticLMData(vocab=cfg.vocab, batch=2, seq=16, seed=0)
    return cfg, build_model(cfg, device="cpu"), data


def test_resumed_run_is_bit_identical(tmp_path):
    _, model, data = tiny()
    opt = adamw.AdamWConfig(**OPT)
    full = loop.train(model, data, loop.LoopConfig(
        steps=6, ckpt_dir=str(tmp_path / "full"), ckpt_every=100,
        log_every=100), opt_cfg=opt, **QUIET)
    d = str(tmp_path / "split")
    first = loop.train(model, data, loop.LoopConfig(
        steps=3, ckpt_dir=d, ckpt_every=3, log_every=100), opt_cfg=opt,
        **QUIET)
    lines = []
    second = loop.train(model, data, loop.LoopConfig(
        steps=6, ckpt_dir=d, ckpt_every=100, log_every=1), opt_cfg=opt,
        log_fn=lines.append)
    assert lines[0] == f"[resume] restored step 3 from {d}"
    assert lines[1].startswith("step     3 loss ")
    assert [h["step"] for h in second["history"]] == [3, 4, 5]
    losses = [h["loss"] for h in first["history"] + second["history"]]
    assert losses == [h["loss"] for h in full["history"]]
    assert second["final_step"] == 6 and checkpoint.latest_step(d) == 6
    for a, b in zip(full["params"].parameters(),
                    second["params"].parameters()):
        assert torch.equal(a, b)
    assert all(np.isfinite(losses))


def test_history_matches_the_jax_loop(tmp_path):
    """Both loops resume from one step-0 checkpoint of JAX's weights."""
    jcfg = jax_smoke_config(jax_get_config("qwen3-1.7b"))
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    opt = dict(OPT)
    for name in ("jax", "port"):
        jax_ckpt.save(str(tmp_path / name), 0, {
            "params": jparams,
            "opt": jax_adamw.init(jax_adamw.AdamWConfig(**opt), jparams)})
    cfg_kw = dict(steps=5, ckpt_every=100, log_every=100)
    jout = jax_loop.train(
        jmodel, auto_mesh(), JaxSyntheticLMData(jcfg.vocab, 2, 16, 0),
        jax_loop.LoopConfig(ckpt_dir=str(tmp_path / "jax"), **cfg_kw),
        opt_cfg=jax_adamw.AdamWConfig(**opt), **QUIET)
    cfg, model, data = tiny()
    out = loop.train(model, data, loop.LoopConfig(
        ckpt_dir=str(tmp_path / "port"), **cfg_kw),
        opt_cfg=adamw.AdamWConfig(**opt), **QUIET)
    got = np.array([h["loss"] for h in out["history"]])
    want = np.array([h["loss"] for h in jout["history"]])
    assert [h["step"] for h in out["history"]] == list(range(5))
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=0)
    assert out["final_step"] == jout["final_step"] == 5


def test_sigterm_saves_and_stops(tmp_path):
    _, model, data = tiny()
    d = str(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    lines = []

    def log(line):
        lines.append(line)
        if line.startswith("step     1 "):
            os.kill(os.getpid(), signal.SIGTERM)

    out = loop.train(model, data, loop.LoopConfig(
        steps=10, ckpt_dir=d, ckpt_every=100, log_every=1),
        opt_cfg=adamw.AdamWConfig(**OPT), log_fn=log)
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert "[preempt] SIGTERM at step 1; saving and exiting" in lines
    _, _, extra = checkpoint.restore(d, {}, device="cpu")
    assert extra == {"data_step": 2, "preempted": True}
    assert checkpoint.latest_step(d) == 2
    assert signal.getsignal(signal.SIGTERM) == before


def test_async_saves_every_ckpt_every(tmp_path):
    _, model, data = tiny()
    out = loop.train(model, data, loop.LoopConfig(
        steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100,
        keep=2), opt_cfg=adamw.AdamWConfig(**OPT), **QUIET)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
    _, got, _ = checkpoint.restore(str(tmp_path), {
        "params": step.abstract_params(model)}, step=4, device="cpu")
    for a, b in zip(got["params"].parameters(), out["params"].parameters()):
        assert torch.equal(a, b)
