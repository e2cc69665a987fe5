"""The port's dense-family LM against the JAX package's, on the CPU.

For the five dense-family architectures at ``smoke_config`` (qwen3-1.7b,
starcoder2-3b, starcoder2-15b, gemma3-12b, phi-3-vision-4.2b), JAX's
``init(PRNGKey(0))`` weights are carried across through
``params_from_jax``; the same seeded tokens (and patch embeddings) then go
through both packages: ``forward``'s hidden states, ``prefill``'s logits,
and eight ``decode_step`` logits with the caches they leave.  The
sequence (80 tokens) is longer than gemma3's 64-token smoke window.
qwen3-1.7b also runs at its own widths, one layer and a 4096-token
vocabulary, the widths ``chip_smoke.py`` phase 14 runs on the card
(measured: float32 6.9e-7, bfloat16 9.7e-3 of the largest magnitude).

Modes and tolerances are ``tests/_torch_lm.py``'s: float32 within 1e-5
and bfloat16 (default knobs, and ``KNOBS``) within 5e-2 of the largest
magnitude of the JAX output; measured below 1e-6 and up to 1.5e-2 here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.models import transformer as jax_transformer

from repro_torch import tuning
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import encdec, moe, ssm, transformer, xlstm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import rmsnorm
from repro_torch.models.model import build_model

from _torch_lm import (
    MODES, assert_close, assert_init_shapes, assert_round_trip, batches,
    pair,
)

DENSE = ("qwen3-1.7b", "starcoder2-3b", "starcoder2-15b", "gemma3-12b",
         "phi-3-vision-4.2b")
B, S, DECODE_STEPS, MAX_SEQ = 2, 80, 8, 16


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("mode", MODES)
def test_forward_prefill_and_decode_match_jax(arch, mode):
    check_against_jax(arch, mode)


@pytest.mark.parametrize("mode", MODES)
def test_qwen3_full_width_matches_jax(mode):
    """qwen3-1.7b at its own widths (d 2048, 16 query and 8 KV heads of
    128, d_ff 6144, qk-norm, tied embeddings), one layer, the vocabulary
    cut to ``FULL_WIDTH_VOCAB``: the widths the card runs, against JAX."""
    check_against_jax("qwen3-1.7b", mode, full_width=True)


def check_against_jax(arch: str, mode: str, full_width: bool = False):
    dtype, knobs, tol = MODES[mode]
    jcfg, jmodel, jparams, cfg, model, params = pair(arch, dtype, full_width)
    jb, tb = batches(cfg, B, S)
    with jax_tuning.overrides(**knobs), tuning.overrides(**knobs):
        jfwd = jax.jit(lambda p, b: jax_transformer.forward(
            p, jcfg, b["tokens"], b.get("patch_embeds")))
        hidden = transformer.forward(params, cfg, tb["tokens"],
                                     tb.get("patch_embeds"))
        assert hidden.dtype == cfg.activation_dtype
        assert_close(hidden, jfwd(jparams, jb), tol)
        logits = model.prefill(params, tb)
        assert logits.shape == (B, cfg.vocab)
        assert_close(logits, jax.jit(jmodel.prefill)(jparams, jb), tol)

        jcache = jmodel.init_cache(B, MAX_SEQ)
        cache = model.init_cache(B, MAX_SEQ)
        assert cache["k"].shape == tuple(jcache["k"].shape)
        assert cache["k"].dtype == cfg.activation_dtype
        jdecode = jax.jit(jmodel.decode)
        for pos in range(DECODE_STEPS):
            jlogits, jcache = jdecode(jparams, jcache,
                                      jb["tokens"][:, pos:pos + 1],
                                      jnp.int32(pos))
            logits, cache = model.decode(params, cache,
                                         tb["tokens"][:, pos:pos + 1], pos)
            assert_close(logits, jlogits, tol)
            assert_close(cache["k"], jcache["k"], tol)
            assert_close(cache["v"], jcache["v"], tol)


def test_gemma3_window_shapes_the_output():
    """gemma3's smoke layers are both local (window 64); beyond position 64
    its hidden states differ from the same weights with full attention."""
    _, _, _, cfg, _, params = pair("gemma3-12b")
    _, tb = batches(cfg, B, S)
    local = transformer.forward(params, cfg, tb["tokens"])
    full = transformer.forward(
        params, dataclasses.replace(cfg, sliding_window=None), tb["tokens"])
    assert torch.equal(local[:, :64], full[:, :64])
    assert not torch.allclose(local[:, 64:], full[:, 64:])


@pytest.mark.parametrize("arch", DENSE)
def test_params_round_trip(arch):
    _, _, jparams, _, _, params = pair(arch)
    assert_round_trip(jparams, params)


def test_params_from_jax_names_the_bad_path():
    jcfg, _, jparams, cfg, _, _ = pair("qwen3-1.7b")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bad = dict(tree, layers=dict(tree["layers"], attn=dict(
        tree["layers"]["attn"], wk=tree["layers"]["attn"]["wk"][:, :, :1])))
    with pytest.raises(ValueError, match="layers/attn/wk"):
        params_from_jax(cfg, bad, "cpu")
    missing = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(KeyError, match="ln_f/scale"):
        params_from_jax(cfg, missing, "cpu")
    extra = dict(tree, unembed=tree["embed"])
    with pytest.raises(ValueError, match="unembed"):
        params_from_jax(cfg, extra, "cpu")
    short = dict(tree, layers=jax.tree_util.tree_map(lambda x: x[:1],
                                                     tree["layers"]))
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(cfg, short, "cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_port_init_has_the_jax_tree_shapes(arch):
    _, _, jparams, cfg, model, _ = pair(arch)
    assert_init_shapes(model, jparams)
    params = model.init(torch.Generator().manual_seed(0))
    _, tb = batches(cfg, B, S)
    assert torch.isfinite(model.prefill(params, tb)).all()


def test_build_model_on_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(cfg, {}, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_params(torch.Generator(), cfg, "cuda")
    for arch, module in (("deepseek-moe-16b", moe), ("zamba2-2.7b", ssm),
                         ("xlstm-350m", xlstm), ("whisper-base", encdec)):
        cfg = smoke_config(get_config(arch))
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            module.init_params(torch.Generator(), cfg, "cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            module.init_cache(cfg, 1, 8)


@pytest.mark.parametrize("arch", ("deepseek-moe-16b", "zamba2-2.7b",
                                  "xlstm-350m"))
def test_blocks_compose_to_hidden_and_decode(arch):
    """``Model.blocks`` and ``Model.decode_blocks``, run in turn over the
    embedded tokens, give ``Model.hidden`` and ``Model.decode`` and their
    caches exactly: the lists ``chip_smoke.py`` holds block by block are
    the stack that serves."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, tb = batches(cfg, B, 16)
    tokens = tb["tokens"]
    x = transformer._embed(params, cfg, tokens)
    for block in model.blocks(params, tokens):
        x = block(x)
        x = x[0] if isinstance(x, tuple) else x     # MoE: (stream, aux)
    assert torch.equal(rmsnorm(params.ln_f, x), model.hidden(params, tb))
    served, stepped = model.init_cache(B, 16), model.init_cache(B, 16)
    for pos in range(4):
        tok = tokens[:, pos:pos + 1]
        want, served = model.decode(params, served, tok, pos)
        x = transformer._embed(params, cfg, tok)
        for block in model.decode_blocks(params, stepped, pos):
            x = block(x)
        got = transformer.logits_fn(params, cfg, rmsnorm(params.ln_f, x))
        assert torch.equal(got[:, 0], want)
    for name in served:
        assert torch.equal(served[name], stepped[name])


def test_routes_only_on_the_moe_family():
    """``routes=`` is the MoE family's (one ``moe.Route`` per MoE layer
    call); every other family refuses it, and only the families held block
    by block have block lists."""
    for arch in ("qwen3-1.7b", "whisper-base", "zamba2-2.7b", "xlstm-350m",
                 "deepseek-moe-16b"):
        cfg = smoke_config(get_config(arch))
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        _, tb = batches(cfg, B, 8)
        log = []
        if cfg.family != "moe":
            with pytest.raises(TypeError, match="routes"):
                model.hidden(params, tb, routes=log)
            assert (model.blocks is None) == (cfg.family in ("dense",
                                                              "encdec"))
            continue
        model.hidden(params, tb, routes=log)
        assert len(log) == cfg.n_layers - cfg.first_dense_layers
        k = cfg.experts_per_token
        for r in log:
            assert r.probs.shape == (B * 8, cfg.n_experts)
            assert r.topi.shape == r.applied.shape == (B * 8, k)
            assert ((r.applied == r.topi) | (r.applied == -1)).all()
