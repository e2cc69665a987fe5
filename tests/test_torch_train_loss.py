"""The port's training objective against the JAX package's, on the CPU.

``Model.loss`` and its gradient with respect to every parameter (mapped to
the JAX tree through ``models/convert.py::named_to_numpy``) for all ten
configs at ``smoke_config``, on the same seeded tokens and labels (and
frames / patch embeddings): in float32 the loss within ``FP32_TOL`` and
each gradient leaf within ``FP32_GRAD_TOL`` of JAX's largest magnitude; in
bfloat16 the loss within ``BF16_TOL`` and each leaf's relative L2 error
within ``BF16_GRAD_TOL``.  A MoE config in bfloat16 follows
``test_torch_lm_moe.py``'s route rule: a token whose applied experts differ
from JAX's must be a near-tie (or a capacity rank such a flip moved), at
most 5% of them, and the gradients are then compared on a cross entropy
over the tokens whose experts agree (the MoE block is the last at the
smoke config, so those tokens' losses do not see the others' experts).
Each ``remat`` mode's gradients equal JAX's under the same mode; an
expert overflowing its capacity (slot ``cap - 1`` clobbered in the
reference) gives JAX's gradients.  The loss takes JAX's int32 labels and
gives the int64 loss bit for bit.  The chunked Mamba2 and mLSTM blocks'
backward over several chunks (chunk 16, 64 positions: the gradient
through the inter-chunk state scan) equals JAX's ``vjp``.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.configs import ARCH_IDS
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.models import xlstm as jax_xlstm
from repro.models.model import build_model as jax_build_model

from repro_torch import tuning
from repro_torch.models import moe, ssm, xlstm
from repro_torch.models.convert import named_to_numpy, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.train import step

from _torch_lm import (
    BF16_TOL, FP32_TOL, assert_close, assert_tree_close, pair, train_batches,
)
from test_torch_lm_moe import Routes

B, S = 2, 32
# float32 gradients: each leaf sums B*S products through two layers and
# their backward, in another order in each package: 1e-4 of the leaf's
# largest magnitude (the largest seen is 5e-6)
FP32_GRAD_TOL = 1e-4
# bfloat16 gradients: the backward chain is about twice the forward's
# rounding sites, and each package rounds at its own (XLA keeps fused
# elementwise chains in float32), so twice the forward's BF16_TOL, as a
# relative L2 error per leaf (the largest seen, zamba2's dt_bias, 0.06)
BF16_GRAD_TOL = 2 * BF16_TOL
MODES = {"fp32": "float32", "bf16": "bfloat16"}


@functools.lru_cache(maxsize=None)
def _float32_pair(arch: str):
    return pair(arch)


def pair_of(arch: str, dtype: str):
    """``pair(arch, dtype)`` with one JAX initialisation per arch: the
    weights are float32 in both modes (``param_dtype``)."""
    jcfg, jmodel, jparams, cfg, model, _ = _float32_pair(arch)
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def jax_grads(jmodel, jparams, jb):
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jb)
    return loss, grads


def port_grads(model, params, tb):
    loss, grads = step.value_and_grad(model, params, tb)
    return loss, named_to_numpy(grads.items())


def assert_tree_l2(port_tree, jax_tree, tol: float) -> None:
    got = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), jax_tree))
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, (jax.tree_util.keystr(path), err)


def masked_xent_jax(jcfg, keep):
    def loss(params, batch):
        hidden, _ = jax_moe.forward(params, jcfg, batch["tokens"])
        logits = (hidden @ params["embed"].astype(hidden.dtype).T).astype(
            jnp.float32)
        lse = jax.nn.logsumexp(logits, axis=-1)
        true = jnp.take_along_axis(logits, batch["labels"][..., None],
                                   axis=-1)[..., 0]
        per = lse - true + 1e-4 * lse * lse
        return jnp.sum(jnp.where(keep, per, 0.0)) / keep.sum()
    return loss


def masked_xent_port(cfg, keep):
    def loss(params, batch):
        hidden, _ = moe.forward(params, cfg, batch["tokens"])
        logits = (hidden @ params.embed.to(hidden.dtype).T).float()
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.take_along_dim(logits, batch["labels"][..., None],
                                    dim=-1)[..., 0]
        per = lse - true + 1e-4 * lse * lse
        return torch.where(keep, per, 0.0).sum() / keep.sum()
    return loss


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch, mode, monkeypatch):
    dtype = MODES[mode]
    jcfg, jmodel, jparams, cfg, model, params = pair_of(arch, dtype)
    jb, tb = train_batches(cfg, B, S)
    jloss, jg = jax_grads(jmodel, jparams, jb)
    loss, g = port_grads(model, params, tb)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert all(not p.requires_grad for p in params.parameters())
    if dtype == "float32":
        assert_close(loss, jloss, FP32_TOL)
        assert_tree_close(g, jg, FP32_GRAD_TOL)
        return
    assert_close(loss, jloss, BF16_TOL)
    if cfg.family != "moe":
        assert_tree_l2(g, jg, BF16_GRAD_TOL)
        return
    routes = Routes(monkeypatch, cfg)
    jax.jit(lambda p, t: jax_moe.forward(p, jcfg, t))(jparams, jb["tokens"])
    with torch.no_grad():
        moe.forward(params, cfg, tb["tokens"], routes.port)
    keep = routes.agree().reshape(B, S)
    assert (~keep).sum() <= max(1, keep.size // 20)
    if keep.all():
        assert_tree_l2(g, jg, BF16_GRAD_TOL)
        return
    monkeypatch.undo()
    jm = types.SimpleNamespace(loss=masked_xent_jax(jcfg, jnp.asarray(keep)))
    m = types.SimpleNamespace(loss=masked_xent_port(cfg, torch.from_numpy(keep)))
    _, jg = jax_grads(jm, jparams, jb)
    _, g = port_grads(m, params, tb)
    assert_tree_l2(g, jg, BF16_GRAD_TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_int32_labels_give_the_int64_loss(arch):
    """JAX's batches are int32 (``batch_spec``, ``SyntheticLMData``): the
    loss takes int32 tokens and labels, equals the int64 loss and gradients
    bit for bit, and JAX's loss within ``FP32_TOL``."""
    jcfg, jmodel, jparams, cfg, model, params = pair_of(arch, "float32")
    jb, tb = train_batches(cfg, B, S)
    t32 = {k: v.to(torch.int32) for k, v in tb.items()}
    assert t32["labels"].dtype == torch.int32 and jb["labels"].dtype == jnp.int32
    loss64, g64 = step.value_and_grad(model, params, tb)
    loss32, g32 = step.value_and_grad(model, params, t32)
    assert torch.equal(loss32, loss64)
    assert all(torch.equal(g32[n], g64[n]) for n in g64)
    assert_close(loss32, jax.jit(jmodel.loss)(jparams, jb), FP32_TOL)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_remat_modes_match_jax(remat):
    """deepseek's smoke config (a dense block, then a MoE block), float32:
    each mode's loss and gradients against JAX's under the same mode."""
    jcfg, jmodel, jparams, cfg, model, params = pair_of("deepseek-moe-16b",
                                                        "float32")
    jb, tb = train_batches(cfg, B, S, seed=3)
    with jax_tuning.overrides(remat=remat), tuning.overrides(remat=remat):
        jloss, jg = jax_grads(jmodel, jparams, jb)
        loss, g = port_grads(model, params, tb)
    assert_close(loss, jloss, FP32_TOL)
    assert_tree_close(g, jg, FP32_GRAD_TOL)


def test_routes_collected_once_under_remat():
    """The backward pass recomputes each checkpointed MoE block; ``routes``
    still holds one ``Route`` per MoE layer call."""
    _, _, _, cfg, model, params = pair("deepseek-moe-16b",
                                       n_layers=3, first_dense_layers=1)
    _, tb = train_batches(cfg, B, S)
    for p in params.parameters():
        p.requires_grad_(True)
    routes = []
    hidden, aux = moe.forward(params, cfg, tb["tokens"], routes)
    (hidden.float().square().mean() + aux).backward()
    assert len(routes) == cfg.n_layers - cfg.first_dense_layers == 2
    assert params.moe_layers[1].moe.router.grad is not None


def test_moe_overflow_grads_match_jax():
    """A capacity factor of 0.25 overflows experts; JAX's scatter drops the
    clobbered slot's cotangent and the port never writes that slot."""
    jcfg, jmodel, jparams, cfg, model, params = pair(
        "deepseek-moe-16b", capacity_factor=0.25)
    jb, tb = train_batches(cfg, B, S, seed=4)
    with torch.no_grad():
        routes = []
        moe.forward(params, cfg, tb["tokens"], routes)
    cap = moe.capacity(cfg, B * S)
    counts = torch.bincount(routes[0].topi.reshape(-1),
                            minlength=cfg.n_experts)
    assert (counts > cap).any()
    assert (routes[0].applied < 0).any()
    jloss, jg = jax_grads(jmodel, jparams, jb)
    loss, g = port_grads(model, params, tb)
    assert_close(loss, jloss, FP32_TOL)
    assert_tree_close(g, jg, FP32_GRAD_TOL)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_ssd_gradients_are_nan_from_128_positions_as_in_jax(arch):
    """A reference defect, ported unchanged (ROADMAP queue 3): the chunked
    Mamba2 and mLSTM forms mask ``exp(delta)`` above the diagonal with a
    ``where``; there exp overflows to inf and the where's gradient is
    0 * inf, NaN, once a chunk spans enough positions (128 at the smoke
    configs).  The loss stays finite in both packages; the same leaves'
    gradients are not; at 64 positions all are finite."""
    jcfg, jmodel, jparams, cfg, model, params = pair_of(arch, "float32")
    for s, finite in ((64, True), (128, False)):
        jb, tb = train_batches(cfg, 1, s)
        jloss, jg = jax_grads(jmodel, jparams, jb)
        loss, g = port_grads(model, params, tb)
        assert np.isfinite(float(jloss)) and torch.isfinite(loss)
        jfin = [bool(np.isfinite(np.asarray(x)).all())
                for x in jax.tree_util.tree_leaves(jg)]
        fin = [bool(np.isfinite(x).all()) for x in jax.tree_util.tree_leaves(g)]
        assert fin == jfin
        assert all(fin) == finite


SSD_CHUNK, SSD_S = 16, 64       # four chunks


def chunked_block(block: str, dtype: str):
    """(JAX function of (params, x), JAX params, port function of x, port
    block, config) for the first Mamba2 or mLSTM block, at chunk 16."""
    if block == "mamba":
        from test_torch_lm_ssm import mamba_pair
        jcfg, jp, cfg, p = mamba_pair(dtype=dtype)
        return (lambda p_, x_: jax_ssm.mamba_forward(p_, jcfg, x_, SSD_CHUNK),
                jp, lambda x: ssm.mamba_forward(p, cfg, x, chunk=SSD_CHUNK),
                p, cfg)
    from test_torch_lm_xlstm import block_pair
    jcfg, jp, cfg, p = block_pair("m", dtype)
    return (lambda p_, x_: jax_xlstm.mlstm_forward(p_, jcfg, x_, SSD_CHUNK),
            jp, lambda x: xlstm.mlstm_forward(p, cfg, x, chunk=SSD_CHUNK),
            p, cfg)


@pytest.mark.parametrize("cotangent", ["all", "last_chunk"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", ["mamba", "mlstm"])
def test_multi_chunk_gradients_match_jax(block, mode, cotangent):
    """The block's vector-Jacobian product over four chunks of 16 against
    JAX's ``jax.vjp``, for the input and every parameter: float32 within
    ``FP32_GRAD_TOL`` of JAX's largest magnitude, bfloat16 within
    ``BF16_GRAD_TOL`` relative L2 a leaf.  With the cotangent on the last
    chunk only, the gradient reaching the first three chunks' inputs
    passes through the inter-chunk state scan (``_states_entering``)
    alone, and must not vanish."""
    dtype = MODES[mode]
    jfn, jp, fn, p, cfg = chunked_block(block, dtype)
    rng = np.random.default_rng(SSD_S)
    x = rng.standard_normal((B, SSD_S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    if cotangent == "last_chunk":
        ct[:, :-SSD_CHUNK] = 0.0
    jdt = jnp.dtype(cfg.dtype)
    jy, vjp = jax.vjp(jax.jit(jfn), jp, jnp.asarray(x, dtype=jdt))
    jgp, jgx = vjp(jnp.asarray(ct, dtype=jdt))
    named = list(p.named_parameters())
    tx = torch.from_numpy(x).to(cfg.activation_dtype).requires_grad_(True)
    for _, t in named:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            y = fn(tx)
            grads = torch.autograd.grad(
                y, [tx] + [t for _, t in named],
                torch.from_numpy(ct).to(y.dtype))
    finally:
        for _, t in named:
            t.requires_grad_(False)
    got = {"x": grads[0].float().numpy(),
           "p": named_to_numpy(zip([n for n, _ in named], grads[1:]))}
    want = {"x": jgx, "p": jgp}
    assert all(np.isfinite(g).all() for g in jax.tree_util.tree_leaves(got))
    if dtype == "float32":
        assert_close(y.detach(), jy, FP32_TOL)
        assert_tree_close(got, want, FP32_GRAD_TOL)
    else:
        assert_tree_l2(got, want, BF16_GRAD_TOL)
    if cotangent == "last_chunk":
        assert np.abs(got["x"][:, :-SSD_CHUNK]).max() > 0
