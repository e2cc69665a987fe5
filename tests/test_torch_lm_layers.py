"""The port's LM building blocks against the JAX package's, on the CPU.

The same seeded numpy inputs and parameters go through
``repro.models.layers`` and ``repro_torch.models.layers``: ``rmsnorm``,
``rope``, ``mlp`` (SwiGLU and GeLU, with and without the ``act_bf16``
knob), ``attention`` (causal, windowed, query-chunked, cross) and
``attention_decode`` at several positions, one past the cache's end (JAX's
``dynamic_update_slice`` clamps it to the last row).

Tolerances, as a share of the largest magnitude of the JAX output:
``FP32_TOL`` 1e-5 — float32 rounds at 2^-24 relative, and the two packages
sum in other orders and use their own ``exp`` / ``cos`` / ``tanh``, a few
ulps over sums of up to a few hundred terms; ``BF16_TOL`` 2e-2 — bf16
rounds at 2^-9 relative, XLA keeps f32 across fused elementwise ops where
torch rounds after each op, so a few bf16 roundings apart.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.models import layers as jl

from repro_torch import tuning
from repro_torch.models import layers

FP32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, FP32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def assert_close(port: torch.Tensor, ref, tol: float) -> None:
    want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = port.float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, np.abs(want).max())


def load(module: torch.nn.Module, tree) -> None:
    """Copy a JAX parameter dict (numpy leaves) into a port module."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for k in name.split("."):
                leaf = leaf[k]
            p.copy_(torch.from_numpy(np.array(leaf, dtype=np.float32)))


def inputs(rng, shape, jdt, tdt):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def jax_rmsnorm_params(rng, d):
    return {"scale": jnp.asarray(1.0 + 0.1 * rng.standard_normal(d),
                                 jnp.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act_bf16", [False, True])
def test_rmsnorm_matches_jax(dtype, act_bf16):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    jp = jax_rmsnorm_params(rng, 64)
    tp = layers.RMSNorm(64, torch.float32, "cpu")
    load(tp, jp)
    jx, tx = inputs(rng, (2, 5, 64), jdt, tdt)
    with jax_tuning.overrides(act_bf16=act_bf16), \
            tuning.overrides(act_bf16=act_bf16):
        got = layers.rmsnorm(tp, tx)
        want = jl.rmsnorm(jp, jx)
    assert got.dtype == tdt
    assert_close(got, want, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(dtype, theta):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    jx, tx = inputs(rng, (2, 7, 3, 32), jdt, tdt)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    got = layers.rope(tx, torch.from_numpy(pos), theta)
    want = jl.rope(jx, jnp.asarray(pos), theta)
    assert got.dtype == tdt
    assert_close(got, want, tol)


@pytest.mark.parametrize("variant", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act_bf16", [False, True])
def test_mlp_matches_jax(variant, dtype, act_bf16):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    jp = jl.mlp_init(jax.random.PRNGKey(3), 64, 128, jnp.float32, variant)
    tp = layers.MLP(64, 128, torch.float32, "cpu", variant)
    load(tp, jax.tree_util.tree_map(np.asarray, jp))
    jx, tx = inputs(rng, (2, 5, 64), jdt, tdt)
    with jax_tuning.overrides(act_bf16=act_bf16), \
            tuning.overrides(act_bf16=act_bf16):
        got = layers.mlp(tp, tx)
        want = jl.mlp(jp, jx)
    assert got.dtype == tdt
    assert_close(got, want, tol)


def attn_pair(spec, seed=4):
    jp = jl.attn_init(jax.random.PRNGKey(seed), spec, jnp.float32)
    if spec.qk_norm:   # non-unit norm scales, so a swapped norm shows
        rng = np.random.default_rng(seed)
        jp["q_norm"] = jax_rmsnorm_params(rng, spec.head_dim)
        jp["k_norm"] = jax_rmsnorm_params(rng, spec.head_dim)
    tp = layers.Attention(spec, torch.float32, "cpu")
    load(tp, jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


SPECS = {
    "gqa_qknorm": layers.AttnSpec(64, 4, 2, 16, qk_norm=True, rope_theta=1e6),
    "mha": layers.AttnSpec(64, 4, 4, 16),
    "mqa": layers.AttnSpec(64, 4, 1, 16),
}


def jax_spec(spec):
    return jl.AttnSpec(**{f: getattr(spec, f) for f in (
        "d_model", "n_heads", "n_kv", "head_dim", "qk_norm", "rope_theta",
        "causal", "window")})


@pytest.mark.parametrize("spec_name", SPECS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,q_chunk", [(None, 512), (5, 512), (5, 4),
                                            (None, 7)])
def test_attention_matches_jax(spec_name, dtype, window, q_chunk):
    spec = SPECS[spec_name]
    jdt, tdt, tol = DTYPES[dtype]
    jp, tp = attn_pair(spec)
    rng = np.random.default_rng(5)
    jx, tx = inputs(rng, (2, 16, 64), jdt, tdt)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    got = layers.attention(tp, spec, tx, torch.from_numpy(pos.copy()),
                           window=window, q_chunk=q_chunk)
    want = jl.attention(jp, jax_spec(spec), jx, jnp.asarray(pos),
                        window=window, q_chunk=q_chunk)
    assert_close(got, want, tol)


def test_window_changes_attention():
    """The windowed case is not the full one in disguise."""
    spec = SPECS["mha"]
    _, tp = attn_pair(spec)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 16, 64)).astype(np.float32))
    pos = torch.arange(16)[None]
    full = layers.attention(tp, spec, x, pos)
    local = layers.attention(tp, spec, x, pos, window=5)
    assert torch.equal(full[:, :5], local[:, :5])
    assert not torch.allclose(full[:, 5:], local[:, 5:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(dtype):
    spec = SPECS["gqa_qknorm"]
    jdt, tdt, tol = DTYPES[dtype]
    jp, tp = attn_pair(spec)
    rng = np.random.default_rng(7)
    jx, tx = inputs(rng, (2, 6, 64), jdt, tdt)
    jk, tk = inputs(rng, (2, 9, 2, 16), jdt, tdt)
    jv, tv = inputs(rng, (2, 9, 2, 16), jdt, tdt)
    pos = np.zeros((2, 6), np.int32)
    got = layers.attention(tp, spec, tx, torch.from_numpy(pos),
                           cross_kv=(tk, tv))
    want = jl.attention(jp, jax_spec(spec), jx, jnp.asarray(pos),
                        cross_kv=(jk, jv))
    assert_close(got, want, tol)


@pytest.mark.parametrize("spec_name", SPECS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [0, 3, 11, 15, 21])
@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_matches_jax(spec_name, dtype, pos, window):
    """One decode step against a filled cache of 16 rows; ``pos`` 21 lies
    past the end, where JAX writes the last row."""
    spec = SPECS[spec_name]
    jdt, tdt, tol = DTYPES[dtype]
    jp, tp = attn_pair(spec)
    rng = np.random.default_rng(8 + pos)
    jx, tx = inputs(rng, (2, 1, 64), jdt, tdt)
    jck, tck = inputs(rng, (2, 16, spec.n_kv, 16), jdt, tdt)
    jcv, tcv = inputs(rng, (2, 16, spec.n_kv, 16), jdt, tdt)
    got, gk, gv = layers.attention_decode(tp, spec, tx, tck, tcv, pos,
                                          window=window)
    want, wk, wv = jl.attention_decode(jp, jax_spec(spec), jx, jck, jcv,
                                       jnp.int32(pos), window=window)
    assert_close(got, want, tol)
    assert_close(gk, wk, tol)
    assert_close(gv, wv, tol)
    row = min(pos, 15)   # the row written; every other row is untouched
    keep = [i for i in range(16) if i != row]
    np.testing.assert_array_equal(gk[:, keep].float().numpy(),
                                  np.asarray(jck.astype(jnp.float32))[:, keep])


def test_repeat_kv_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 3, 2, 4)).astype(
        np.float32)
    for groups in (1, 2, 3):
        np.testing.assert_array_equal(
            layers._repeat_kv(torch.from_numpy(x), groups).numpy(),
            np.asarray(jl._repeat_kv(jnp.asarray(x), groups)))


def test_dense_init_scale():
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(512, 256)
    layers.dense_init_(w, 512, gen)
    assert abs(float(w.std()) * math.sqrt(512) - 1.0) < 0.02
