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

Modes and tolerances, as a share of the largest magnitude of the JAX
output: float32, ``FP32_TOL`` 1e-5 (float32 rounds at 2^-24; the two
packages sum in other orders and use their own transcendentals, a few ulps
through two layers; measured below 1e-6); bfloat16, with the default knobs
and with ``q_chunk=16, scores_dtype="bf16", gqa_native=True,
act_bf16=True``, ``BF16_TOL`` 5e-2 (bf16 rounds at 2^-9; XLA keeps f32
across fused elementwise ops where torch rounds after each op, and two
layers of about ten rounding sites each compound that; measured up to
1.5e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as jax_transformer
from repro.models.model import build_model as jax_build_model

from repro_torch import tuning
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model

DENSE = ("qwen3-1.7b", "starcoder2-3b", "starcoder2-15b", "gemma3-12b",
         "phi-3-vision-4.2b")
UNPORTED = tuple(a for a in ARCH_IDS if a not in DENSE)
FP32_TOL = 1e-5
BF16_TOL = 5e-2
KNOBS = dict(q_chunk=16, scores_dtype="bf16", gqa_native=True, act_bf16=True)
MODES = {"fp32": ("float32", {}, FP32_TOL),
         "bf16": ("bfloat16", {}, BF16_TOL),
         "bf16_knobs": ("bfloat16", KNOBS, BF16_TOL)}
B, S, DECODE_STEPS, MAX_SEQ = 2, 80, 8, 16
FULL_WIDTH_VOCAB = 4096


def assert_close(port: torch.Tensor, ref, tol: float) -> None:
    want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = port.float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, np.abs(want).max())


def pair(arch: str, dtype: str = "float32", full_width: bool = False):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    at the smoke config, or at the arch's own widths with one layer and a
    ``FULL_WIDTH_VOCAB``-token vocabulary; JAX's PRNGKey(0) weights in
    both."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if full_width:
        jcfg, cfg = (dataclasses.replace(c, n_layers=1, vocab=FULL_WIDTH_VOCAB)
                     for c in (jcfg, cfg))
    else:
        jcfg, cfg = jax_smoke_config(jcfg), smoke_config(cfg)
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


def batches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    if cfg.frontend == "patch":
        pe = rng.standard_normal(
            (B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        jb["patch_embeds"] = jnp.asarray(pe)
        tb["patch_embeds"] = torch.from_numpy(pe)
    return jb, tb


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
    jb, tb = batches(cfg)
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
    _, tb = batches(cfg)
    local = transformer.forward(params, cfg, tb["tokens"])
    full = transformer.forward(
        params, dataclasses.replace(cfg, sliding_window=None), tb["tokens"])
    assert torch.equal(local[:, :64], full[:, :64])
    assert not torch.allclose(local[:, 64:], full[:, 64:])


@pytest.mark.parametrize("arch", DENSE)
def test_params_round_trip(arch):
    jcfg, _, jparams, cfg, _, params = pair(arch)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, want)
    assert sum(p.numel() for p in params.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(tree))
    assert all(not p.requires_grad for p in params.parameters())


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
    jcfg, _, jparams, cfg, model, _ = pair(arch)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    tree = params_to_numpy(params)
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(np.shape, jparams)
    np.testing.assert_array_equal(tree["ln_f"]["scale"], 1.0)
    again = params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    np.testing.assert_array_equal(again["embed"], tree["embed"])
    _, tb = batches(cfg)
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


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    cfg = smoke_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="11b"):
        build_model(cfg, device="cpu")
