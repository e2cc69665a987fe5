"""The port's encoder-decoder family (whisper-base) against the JAX
package's, on the CPU.

At ``smoke_config`` (two encoder and two decoder layers, 32 encoder
frames of 64 features), JAX's ``init(PRNGKey(0))`` weights are carried
across through ``params_from_jax``; the same seeded tokens and frames then
go through both packages: ``encode``'s output, ``decode_train``'s hidden
states, ``prefill``'s logits, ``prefill_cross``'s cross-attention KV, and
eight ``decode_step`` logits with the caches they leave, in the modes and
tolerances of ``tests/_torch_lm.py``.  The reference's serving defect is
pinned: its ``Model`` facade never fills the cross-attention KV, so decode
from ``init_cache`` attends over zeros and the cross branch adds 0.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.models import encdec as jax_encdec

from repro_torch import tuning
from repro_torch.models import encdec
from repro_torch.models.convert import params_from_jax

from _torch_lm import (
    FP32_TOL, MODES, assert_close, assert_constrained_serving,
    assert_init_shapes, assert_round_trip, batches, decode_both, make_pair,
    pair,
)

ARCH = "whisper-base"
B, S, DECODE_STEPS, MAX_SEQ = 2, 80, 8, 16


@pytest.mark.parametrize("mode", MODES)
def test_encode_prefill_and_decode_match_jax(mode):
    dtype, knobs, tol = MODES[mode]
    jcfg, jmodel, jparams, cfg, model, params = pair(ARCH, dtype)
    jb, tb = batches(cfg, B, S)
    assert tb["frames"].shape == (B, cfg.encoder_seq, cfg.frontend_dim)
    with jax_tuning.overrides(**knobs), tuning.overrides(**knobs):
        jenc = jax.jit(lambda p, f: jax_encdec.encode(p, jcfg, f))(
            jparams, jb["frames"])
        enc = encdec.encode(params, cfg, tb["frames"])
        assert enc.dtype == cfg.activation_dtype
        assert_close(enc, jenc, tol)
        jhidden = jax.jit(lambda p, t, e: jax_encdec.decode_train(
            p, jcfg, t, e))(jparams, jb["tokens"], jenc)
        assert_close(encdec.decode_train(params, cfg, tb["tokens"], enc),
                     jhidden, tol)
        logits = model.prefill(params, tb)
        assert logits.shape == (B, cfg.vocab)
        assert_close(logits, jax.jit(jmodel.prefill)(jparams, jb), tol)

        jcache = jax_encdec.prefill_cross(jparams, jcfg, jenc,
                                          jmodel.init_cache(B, MAX_SEQ))
        cache = encdec.prefill_cross(params, cfg, enc,
                                     model.init_cache(B, MAX_SEQ))
        decode_both(jmodel, jparams, jcache, model, params, cache,
                    jb["tokens"], tb["tokens"], DECODE_STEPS, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_prefill_cross_match_jax(dtype):
    """``encode`` (bidirectional, RoPE) over the frames and the
    cross-attention K/V that ``prefill_cross`` writes into every decoder
    layer's slot of the cache, in place."""
    tol = MODES["fp32" if dtype == "float32" else "bf16"][2]
    jcfg, jmodel, jparams, cfg, model, params = pair(ARCH, dtype)
    jb, tb = batches(cfg, B, 4, seed=2)
    jenc = jax_encdec.encode(jparams, jcfg, jb["frames"])
    enc = encdec.encode(params, cfg, tb["frames"])
    assert_close(enc, jenc, tol)
    jcache = jax_encdec.prefill_cross(jparams, jcfg, jenc,
                                      jmodel.init_cache(B, MAX_SEQ))
    cache = model.init_cache(B, MAX_SEQ)
    xk = cache["xk"]
    assert encdec.prefill_cross(params, cfg, enc, cache) is cache
    assert cache["xk"] is xk
    for name in ("xk", "xv"):
        assert cache[name].shape == (cfg.n_layers, B, cfg.encoder_seq,
                                     cfg.n_kv_heads, cfg.hd)
        assert_close(cache[name], jcache[name], tol)
    assert not cache["k"].any() and not cache["v"].any()


def test_decode_after_prefill_cross_follows_prefill():
    """With the cross-attention KV filled, decode at each position gives
    prefill's logits there (float32)."""
    _, _, _, cfg, model, params = pair(ARCH)
    _, tb = batches(cfg, B, DECODE_STEPS)
    enc = encdec.encode(params, cfg, tb["frames"])
    hidden = encdec.decode_train(params, cfg, tb["tokens"], enc)
    want = (hidden @ params.embed.T).numpy()
    cache = encdec.prefill_cross(params, cfg, enc,
                                 model.init_cache(B, MAX_SEQ))
    for pos in range(DECODE_STEPS):
        logits, cache = model.decode(params, cache,
                                     tb["tokens"][:, pos:pos + 1], pos)
        assert_close(logits, want[:, pos], FP32_TOL)


def test_serving_decode_attends_to_a_zero_cross_kv_as_jax():
    """The pin: decode from ``init_cache`` (what ``DecodeServer`` runs,
    in both packages) equals JAX's, and equals decode with the cross
    branch switched off (``xattn.wo`` zeroed, the KV filled): over a zero
    KV every score is 0, the average of zero values is 0."""
    jcfg, jmodel, jparams, cfg, model, params = pair(ARCH)
    jb, tb = batches(cfg, B, DECODE_STEPS)
    decode_both(jmodel, jparams, jmodel.init_cache(B, MAX_SEQ), model,
                params, model.init_cache(B, MAX_SEQ), jb["tokens"],
                tb["tokens"], DECODE_STEPS, FP32_TOL)
    off = copy.deepcopy(params)
    for lp in off.dec_layers:
        lp.xattn.wo.zero_()
    enc = encdec.encode(params, cfg, tb["frames"])
    zero = model.init_cache(B, MAX_SEQ)
    filled = encdec.prefill_cross(off, cfg, enc, model.init_cache(B, MAX_SEQ))
    assert filled["xk"].abs().max() > 0
    for pos in range(DECODE_STEPS):
        tok = tb["tokens"][:, pos:pos + 1]
        got, zero = model.decode(params, zero, tok, pos)
        want, filled = model.decode(off, filled, tok, pos)
        assert torch.equal(got, want)
    assert not zero["xk"].any() and not zero["xv"].any()


def test_params_round_trip():
    _, _, jparams, _, _, params = pair(ARCH)
    assert_round_trip(jparams, params)
    assert len(params.enc_layers) == len(params.dec_layers) == 2


def test_port_init_has_the_jax_tree_shapes():
    _, _, jparams, _, model, _ = pair(ARCH)
    assert_init_shapes(model, jparams)


def test_params_from_jax_names_the_bad_path():
    _, _, jparams, cfg, _, _ = pair(ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    dec = tree["dec_layers"]
    bad = dict(tree, dec_layers=dict(dec, xattn=dict(
        dec["xattn"], wo=dec["xattn"]["wo"][:, :, :3])))
    with pytest.raises(ValueError, match="dec_layers/xattn/wo"):
        params_from_jax(cfg, bad, "cpu")
    short = dict(tree, enc_layers=jax.tree_util.tree_map(
        lambda a: a[:1], tree["enc_layers"]))
    with pytest.raises(ValueError, match=r"enc_layers/.*\(2,\) layers"):
        params_from_jax(cfg, short, "cpu")
    missing = {k: v for k, v in tree.items() if k != "frontend_proj"}
    with pytest.raises(KeyError, match="frontend_proj"):
        params_from_jax(cfg, missing, "cpu")


def test_decode_server_matches_jax_over_a_zero_cross_kv():
    """Neither server fills the cross-attention KV: after serving, both
    caches' ``xk`` / ``xv`` are still zero."""
    srv, jsrv = assert_constrained_serving(make_pair(arch=ARCH))
    for name in ("xk", "xv"):
        assert not srv.cache[name].any()
        assert not np.asarray(jsrv.cache[name]).any()
