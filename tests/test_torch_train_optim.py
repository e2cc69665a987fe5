"""The port's AdamW, gradient compression and synthetic LM data against the
JAX package's, on the CPU.

AdamW: qwen3-1.7b's smoke parameters (JAX's PRNGKey(0) weights in both)
and seeded float32 gradients, four ``update`` steps with the clip active
and idle, weight decay on, in float32 and bfloat16 state: parameters,
``m``, ``v``, the step, the grad norm and the learning rate within
``UPDATE_TOL`` of JAX's.  Weight decay follows the JAX tree's ranks: the
per-layer norm scales, (L, d) there, are decayed, ``ln_f.scale`` is not.
The schedule at warmup, middle and end.  Compression: ``quantize``,
``dequantize`` and the error-feedback tree functions bit-identical to
JAX's, ties at half a step included.  ``SyntheticLMData``: equal arrays
for several (seed, step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMData as JaxSyntheticLMData
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress

from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.convert import load_named_, named_to_numpy
from repro_torch.optim import adamw, compress

from _torch_lm import assert_tree_close, pair

# float32 elementwise math in another order (XLA may fuse b1*m + (1-b1)*g)
# and pow/cos/sqrt of each library: a few ulps of the update, 1e-6 of a
# leaf's largest magnitude.  bfloat16 state: a float32 difference of an
# ulp can round m or v to the neighbouring bf16 value, one bf16 ulp, up to
# 2^-7 of the leaf's largest magnitude; two such steps over four updates.
UPDATE_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -6}


def grads_for(params, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy((rng.standard_normal(tuple(p.shape))
                                 * scale).astype(np.float32))
            for n, p in params.named_parameters()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 1e6], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(clip, state_dtype):
    _, _, jparams, _, _, params = pair("qwen3-1.7b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=clip,
              weight_decay=0.1, state_dtype=state_dtype)
    jcfg, cfg = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jstate, state = jax_adamw.init(jcfg, jparams), adamw.init(cfg, params)
    assert all(m.dtype == getattr(torch, state_dtype)
               for m in state.m.values())
    jupdate = jax.jit(lambda g, s, p: jax_adamw.update(jcfg, g, s, p))
    tol = UPDATE_TOL[state_dtype]
    for i in range(4):
        g = grads_for(params, i, 0.05)
        jg = jax.tree_util.tree_map(jnp.asarray, named_to_numpy(g.items()))
        jparams, jstate, jm = jupdate(jg, jstate, jparams)
        params, state, m = adamw.update(cfg, g, state, params)
        assert int(state.step) == int(jstate.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
        assert (float(m["grad_norm"]) > clip) == (clip < 1)
        assert_tree_close(named_to_numpy(params.named_parameters()), jparams,
                          tol)
        assert_tree_close(named_to_numpy(state.m.items()), jstate.m, tol)
        assert_tree_close(named_to_numpy(state.v.items()), jstate.v, tol)


def test_weight_decay_follows_the_stacked_rank():
    """Zero gradients: only decay moves a parameter.  Per-layer norm
    scales (stacked (L, d) in JAX) shrink by lr * wd; ``ln_f.scale``
    (an unstacked vector) does not move."""
    _, _, _, _, _, params = pair("qwen3-1.7b")
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                            weight_decay=0.5)
    zero = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    params, _, m = adamw.update(cfg, zero, adamw.init(cfg, params), params)
    lr = float(m["lr"])
    assert torch.all(params.ln_f.scale == 1.0)
    for layer in params.layers:
        for norm in (layer.ln1, layer.ln2, layer.attn.q_norm):
            torch.testing.assert_close(
                norm.scale, torch.full_like(norm.scale, 1 - lr * 0.5),
                rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 550, 1000, 1500])
def test_schedule_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000, min_lr_frac=0.1)
    got = adamw.schedule(adamw.AdamWConfig(**cfg),
                         torch.tensor(float(step)))
    want = jax_adamw.schedule(jax_adamw.AdamWConfig(**cfg),
                              jnp.float32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def compress_inputs():
    rng = np.random.default_rng(7)
    g = rng.standard_normal((6, 4, 5)).astype(np.float32)
    # a row whose values sit exactly half a quantization step apart:
    # round half to even in both
    g[0, 0] = np.array([0.5, 1.5, 2.5, -0.5, 127.0], np.float32)
    v = rng.standard_normal(9).astype(np.float32)
    return {"w": g, "b": {"v": v}}


def test_quantize_matches_jax_bit_for_bit():
    for arr in jax.tree_util.tree_leaves(compress_inputs()):
        q, s = compress.quantize(torch.from_numpy(arr))
        jq, js = jax_compress.quantize(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            compress.dequantize(q, s).numpy(),
            np.asarray(jax_compress.dequantize(jq, js)))


def test_error_feedback_tree_matches_jax_bit_for_bit():
    tree = compress_inputs()
    grads = jax.tree_util.tree_map(torch.from_numpy, tree)
    jgrads = jax.tree_util.tree_map(jnp.asarray, tree)
    res, jres = compress.zero_residuals(grads), jax_compress.zero_residuals(
        jgrads)
    for _ in range(3):
        qs, ss, res = compress.compress_tree(grads, res)
        jqs, jss, jres = jax_compress.compress_tree(jgrads, jres)
        for got, want in ((qs, jqs), (ss, jss), (res, jres),
                          (compress.decompress_tree(qs, ss),
                           jax_compress.decompress_tree(jqs, jss))):
            for a, b in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert compress.compression_ratio(grads) == \
        jax_compress.compression_ratio(jgrads)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 10), (9, 123456)])
def test_synthetic_lm_data_matches_jax(seed, step):
    for vocab, batch, seq in ((100, 4, 16), (151936, 2, 40)):
        got = SyntheticLMData(vocab, batch, seq, seed).batch_at(step)
        want = JaxSyntheticLMData(vocab, batch, seq, seed).batch_at(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_load_named_round_trips_optimizer_state():
    """``m`` / ``v`` carry across in the JAX layout like the parameters."""
    _, _, jparams, _, _, params = pair("xlstm-350m")
    state = adamw.init(adamw.AdamWConfig(), params)
    jstate = jax_adamw.init(jax_adamw.AdamWConfig(), jparams)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) + 1.0, jstate.m)
    load_named_(state.m.items(), tree)
    assert_tree_close(named_to_numpy(state.m.items()), tree, 0.0)
    bad = dict(tree, extra=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="does not have"):
        load_named_(state.v.items(), bad)
