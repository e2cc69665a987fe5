"""The port's Mamba2 hybrid family (zamba2-2.7b) against the JAX package's,
on the CPU.

At ``smoke_config`` (two Mamba2 blocks of 8 heads of 32, state 16, then
the shared attention block), JAX's ``init(PRNGKey(0))`` weights are
carried across through ``params_from_jax``; the same seeded tokens then go
through both packages: ``forward``'s hidden states, ``prefill``'s logits,
and eight ``decode_step`` logits with the caches they leave, in the modes
and tolerances of ``tests/_torch_lm.py``.  ``mamba_forward`` is held to
JAX's with the sequence a multiple of the chunk and not (one chunk), and
to the port's own token-by-token ``mamba_decode``.  The reference's shared
KV cache is pinned: decode equals JAX's decode, and JAX's decode differs
from its prefill after position 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer

from repro_torch import tuning
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import _chunks

from _torch_lm import (
    FP32_TOL, MODES, assert_close, assert_constrained_serving,
    assert_init_shapes, assert_round_trip, assert_state_carries_over,
    batches, decode_both, make_pair, pair,
)

ARCH = "zamba2-2.7b"
B, S, DECODE_STEPS, MAX_SEQ = 2, 80, 8, 16


@pytest.mark.parametrize("mode", MODES)
def test_forward_prefill_and_decode_match_jax(mode):
    dtype, knobs, tol = MODES[mode]
    jcfg, jmodel, jparams, cfg, model, params = pair(ARCH, dtype)
    jb, tb = batches(cfg, B, S)
    with jax_tuning.overrides(**knobs), tuning.overrides(**knobs):
        jhidden = jax.jit(lambda p, t: jax_ssm.forward(p, jcfg, t))(
            jparams, jb["tokens"])
        hidden = ssm.forward(params, cfg, tb["tokens"])
        assert hidden.dtype == cfg.activation_dtype
        assert_close(hidden, jhidden, tol)
        logits = model.prefill(params, tb)
        assert logits.shape == (B, cfg.vocab)
        assert_close(logits, jax.jit(jmodel.prefill)(jparams, jb), tol)
        decode_both(jmodel, jparams, jmodel.init_cache(B, MAX_SEQ), model,
                    params, model.init_cache(B, MAX_SEQ), jb["tokens"],
                    tb["tokens"], DECODE_STEPS, tol)


def test_without_shared_attention_matches_jax():
    """``attn_every`` 0: the stack is Mamba2 blocks only and the cache has
    no KV."""
    jcfg, jmodel, jparams, cfg, model, params = pair(ARCH, attn_every=0)
    assert ssm._chunk_layout(cfg) == (0, cfg.n_layers)
    jb, tb = batches(cfg, B, S)
    assert_close(model.prefill(params, tb),
                 jax.jit(jmodel.prefill)(jparams, jb), FP32_TOL)
    cache = model.init_cache(B, MAX_SEQ)
    assert set(cache) == {"ssm", "conv"}
    decode_both(jmodel, jparams, jmodel.init_cache(B, MAX_SEQ), model,
                params, cache, jb["tokens"], tb["tokens"], DECODE_STEPS,
                FP32_TOL)


def test_shared_kv_cache_decode_differs_from_prefill_as_jax():
    """Every application of the shared block writes the one KV cache at
    the same position, so from position 1 on decode attends over the last
    application's keys where prefill gives each its own: JAX's decode
    logits differ from its prefill's there (and agree at position 0), and
    the port's decode equals JAX's decode.  Four blocks, so the shared
    block runs twice (at the smoke config's two, once, and nothing is
    overwritten)."""
    jcfg, jmodel, jparams, cfg, model, params = pair(ARCH, n_layers=4)
    assert ssm._chunk_layout(cfg) == (2, 2)
    jb, tb = batches(cfg, B, S)
    prefill = np.asarray(jax.jit(lambda p, t: jax_transformer.logits_fn(
        p, jcfg, jax_ssm.forward(p, jcfg, t)))(
            jparams, jb["tokens"][:, :DECODE_STEPS]))
    jdecode = jax.jit(jmodel.decode)
    jcache = jmodel.init_cache(B, MAX_SEQ)
    cache = model.init_cache(B, MAX_SEQ)
    for pos in range(DECODE_STEPS):
        jlogits, jcache = jdecode(jparams, jcache,
                                  jb["tokens"][:, pos:pos + 1], jnp.int32(pos))
        logits, cache = model.decode(params, cache,
                                     tb["tokens"][:, pos:pos + 1], pos)
        assert_close(logits, jlogits, FP32_TOL)
        gap = np.abs(np.asarray(jlogits) - prefill[:, pos]).max()
        scale = np.abs(prefill[:, pos]).max()
        if pos == 0:
            assert gap <= FP32_TOL * scale
        else:
            assert gap > 1e-2 * scale, (pos, gap)
    assert tuple(cache["k"].shape) == (B, MAX_SEQ, cfg.n_kv_heads, cfg.hd)


def mamba_pair(**fields):
    jcfg, _, jparams, cfg, _, params = pair(ARCH, **fields)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])["mamba"]
    return jcfg, jp, cfg, params.layers[0].mamba


@pytest.mark.parametrize("s", [64, 72], ids=["multiple", "one_chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_matches_jax(s, dtype):
    """Chunk 16: S 64 runs four chunks through the inter-chunk scan, S 72
    (not a multiple) one chunk of 72."""
    jcfg, jp, cfg, p = mamba_pair(dtype=dtype)
    assert _chunks(s, 16) == ((16, 4) if s == 64 else (72, 1))
    x = np.random.default_rng(s).standard_normal((B, s, cfg.d_model))
    x = x.astype(np.float32)
    tol = MODES["fp32" if dtype == "float32" else "bf16"][2]
    got = ssm.mamba_forward(p, cfg, torch.from_numpy(x).to(
        cfg.activation_dtype), chunk=16)
    want = jax.jit(lambda p_, x_: jax_ssm.mamba_forward(p_, jcfg, x_, 16))(
        jp, jnp.asarray(x, dtype=jcfg.activation_dtype))
    assert_close(got, want, tol)


def test_mamba_forward_equals_its_recurrence():
    """The chunked SSD form and the O(1) recurrent step compute the same
    function: token-by-token ``mamba_decode`` from a zero state gives
    ``mamba_forward``'s outputs, with A_log and dt_bias drawn away from 0
    so the decay matters."""
    _, _, cfg, p = mamba_pair()
    gen = torch.Generator().manual_seed(7)
    p.A_log.copy_(torch.randn(p.A_log.shape, generator=gen))
    p.dt_bias.copy_(torch.randn(p.dt_bias.shape, generator=gen))
    x = torch.randn((B, 48, cfg.d_model), generator=gen)
    full = ssm.mamba_forward(p, cfg, x, chunk=16)
    d_in, nh, ns = ssm.mamba_dims(cfg)
    state = torch.zeros((B, nh, ns, d_in // nh))
    conv = torch.zeros((B, 4, d_in))
    steps = []
    for t in range(x.shape[1]):
        y, state, conv = ssm.mamba_decode(p, cfg, x[:, t:t + 1], state, conv)
        steps.append(y)
    assert_close(torch.cat(steps, dim=1), full.numpy(), 1e-4)


def test_params_round_trip():
    _, _, jparams, _, _, params = pair(ARCH)
    assert_round_trip(jparams, params)
    assert params.layers[0].mamba.A_log.dtype == torch.float32


def test_port_init_has_the_jax_tree_shapes():
    _, _, jparams, _, model, _ = pair(ARCH)
    assert_init_shapes(model, jparams)


def test_params_from_jax_names_the_bad_path():
    _, _, jparams, cfg, _, _ = pair(ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    layers = tree["layers"]
    bad = dict(tree, layers=dict(layers, mamba=dict(
        layers["mamba"], conv=layers["mamba"]["conv"][:, :3])))
    with pytest.raises(ValueError, match="layers/mamba/conv"):
        params_from_jax(cfg, bad, "cpu")
    missing = {k: v for k, v in tree.items() if k != "shared_ln2"}
    with pytest.raises(KeyError, match="shared_ln2/scale"):
        params_from_jax(cfg, missing, "cpu")
    extra = dict(tree, shared_mlp=dict(tree["shared_mlp"],
                                       w_extra=tree["embed"]))
    with pytest.raises(ValueError, match="shared_mlp/w_extra"):
        params_from_jax(cfg, extra, "cpu")


def test_decode_server_matches_jax():
    """``DecodeServer`` with the shared block applied twice (four blocks),
    so the shared KV cache's overwrites are in the run."""
    assert_constrained_serving(make_pair(arch=ARCH, n_layers=4))


def test_decode_server_carries_recurrent_state_as_jax():
    """The SSM and conv states (and the shared KV cache) are never reset
    between requests; the port keeps that."""
    assert_state_carries_over(ARCH)
