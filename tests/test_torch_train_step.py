"""The port's train step against the JAX package's, on the CPU.

``build_train_step`` against JAX's, jitted on a 1 x 1 mesh of ``Auto``
axes (``tests/_torch_lm.py::auto_mesh``), for three steps at
``microbatch`` 1 and 2 on the same seeded batches: loss, grad norm and
learning rate, the AdamW step, ``m``, ``v`` and the parameters.  A MoE
model under JAX's mesh takes the expert-parallel dispatch, so the step is
compared on a dense config here (``tests/test_torch_train_mesh.py`` holds
the MoE step over a mesh).  Also the microbatch split, and
``abstract_params``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.train import step as jax_step

from repro_torch.configs import get_config, smoke_config
from repro_torch.models.convert import named_to_numpy, params_to_numpy
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import step

from _torch_lm import (
    FP32_TOL, assert_close, assert_tree_close, auto_mesh, pair, train_batches,
)

S = 32
# m and v are linear in the gradients: held as the gradients are in
# tests/test_torch_train_loss.py
FP32_GRAD_TOL = 1e-4


STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# AdamW's first steps move an element by lr * g / (|g| + eps): where |g|
# is near eps (1e-8) a float32 rounding difference in g (the packages sum
# in other orders) moves the element by a visible share of lr.  The
# parameters are held to a tenth of lr a step, absolute (the largest seen,
# 2.8e-5 after three steps).
PARAM_TOL = 0.1 * STEP_OPT["lr"]


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(microbatch):
    jcfg, jmodel, jparams, cfg, model, params = pair("qwen3-1.7b")
    mesh = auto_mesh()
    jfn, _, jopt = jax_step.build_train_step(
        jmodel, mesh, opt_cfg=jax_adamw.AdamWConfig(**STEP_OPT),
        microbatch=microbatch)
    fn, _, opt = step.build_train_step(model, opt_cfg=adamw.AdamWConfig(
        **STEP_OPT), microbatch=microbatch)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    state = adamw.init(opt, params)
    with mesh:
        jstep = jax.jit(jfn)
        jstate = jax_adamw.init(jopt, jparams)
        for i in range(3):
            jb, tb = train_batches(cfg, 4, S, seed=10 + i)
            jparams, jstate, jm = jstep(jparams, jstate, jb)
            params, state, m = fn(params, state, tb)
            for k in ("loss", "grad_norm", "lr"):
                assert_close(m[k], jm[k], FP32_TOL)
            assert int(state.step) == int(jstate.step) == i + 1
            assert_tree_close(named_to_numpy(state.m.items()), jstate.m,
                              FP32_GRAD_TOL)
            assert_tree_close(named_to_numpy(state.v.items()), jstate.v,
                              FP32_GRAD_TOL)
            got = jax.tree_util.tree_leaves(params_to_numpy(params))
            want = jax.tree_util.tree_leaves(jparams)
            for a, w in zip(got, want):
                assert np.abs(a - np.asarray(w)).max() <= PARAM_TOL * (i + 1)
    assert all(not p.requires_grad for p in params.parameters())


def test_microbatches_are_contiguous_row_blocks():
    """``microbatch=2`` gives the mean of the two half batches' losses and
    the float32 mean of their gradients."""
    cfg = smoke_config(get_config("qwen3-1.7b"))
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    _, tb = train_batches(cfg, 4, 16)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in tb.items()}
              for i in range(2)]
    parts = [step.value_and_grad(model, params, h) for h in halves]
    opt = adamw.AdamWConfig(lr=0.0, weight_decay=0.0)
    fn, _, _ = step.build_train_step(model, opt_cfg=opt, microbatch=2)
    _, state, m = fn(params, adamw.init(opt, params), tb)
    assert torch.equal(m["loss"], torch.stack([l for l, _ in parts]).mean())
    want = adamw.global_norm({n: (parts[0][1][n].float() + parts[1][1][n])
                              / 2 for n in parts[0][1]})
    assert torch.equal(m["grad_norm"], want)
    with pytest.raises(ValueError, match="microbatches"):
        step.build_train_step(model, opt_cfg=opt, microbatch=3)[0](
            params, state, tb)


def test_abstract_params_match_jax():
    jmodel = pair("xlstm-350m")[1]
    model = build_model(smoke_config(get_config("xlstm-350m")), device="cpu")
    p_abs = step.abstract_params(model)
    assert all(p.device.type == "meta" for p in p_abs.parameters())
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, named_to_numpy(
            (n, torch.zeros(p.shape)) for n, p in p_abs.named_parameters()))
    assert shapes == jax.tree_util.tree_map(
        lambda a: a.shape, jax_step.abstract_params(jmodel))
