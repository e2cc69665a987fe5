"""The port's xLSTM family (xlstm-350m) against the JAX package's, on the
CPU.

Two configs: ``smoke_config`` (two mLSTM blocks, no sLSTM, since its
``slstm_every`` 4 exceeds the two layers) and the same with four layers and
``slstm_every`` 2 (two rounds of one mLSTM and one sLSTM block, so the
mLSTM parameters stack on two axes, rounds x blocks).  JAX's
``init(PRNGKey(0))`` weights are carried across through ``params_from_jax``;
the same seeded tokens then go through both packages: ``forward``'s hidden
states, ``prefill``'s logits, and eight ``decode_step`` logits with the
recurrent states they leave, in the modes and tolerances of
``tests/_torch_lm.py``.  ``mlstm_forward`` is held to JAX's with the
sequence a multiple of the chunk and not (one chunk), ``slstm_forward`` to
JAX's, and both to the port's own token-by-token decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.models import xlstm as jax_xlstm

from repro_torch import tuning
from repro_torch.models import xlstm
from repro_torch.models.convert import params_from_jax

from _torch_lm import (
    FP32_TOL, MODES, assert_close, assert_constrained_serving,
    assert_init_shapes, assert_round_trip, assert_state_carries_over,
    batches, decode_both, make_pair, pair,
)

ARCH = "xlstm-350m"
CONFIGS = {"smoke": {}, "with_slstm": dict(n_layers=4, slstm_every=2)}
B, S, DECODE_STEPS, MAX_SEQ = 2, 80, 8, 16


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("mode", MODES)
def test_forward_prefill_and_decode_match_jax(mode, config):
    dtype, knobs, tol = MODES[mode]
    jcfg, jmodel, jparams, cfg, model, params = pair(ARCH, dtype,
                                                     **CONFIGS[config])
    assert hasattr(params, "slstm") == (config == "with_slstm")
    jb, tb = batches(cfg, B, S)
    with jax_tuning.overrides(**knobs), tuning.overrides(**knobs):
        jhidden = jax.jit(lambda p, t: jax_xlstm.forward(p, jcfg, t))(
            jparams, jb["tokens"])
        hidden = xlstm.forward(params, cfg, tb["tokens"])
        assert hidden.dtype == cfg.activation_dtype
        assert_close(hidden, jhidden, tol)
        logits = model.prefill(params, tb)
        assert logits.shape == (B, cfg.vocab)
        assert_close(logits, jax.jit(jmodel.prefill)(jparams, jb), tol)
        decode_both(jmodel, jparams, jmodel.init_cache(B, MAX_SEQ), model,
                    params, model.init_cache(B, MAX_SEQ), jb["tokens"],
                    tb["tokens"], DECODE_STEPS, tol)


def block_pair(kind: str, dtype: str = "float32"):
    """(jax cfg, JAX block params, port cfg, port block) of the first
    mLSTM or sLSTM block of the four-layer config."""
    jcfg, _, jparams, cfg, _, params = pair(ARCH, dtype,
                                            **CONFIGS["with_slstm"])
    if kind == "m":
        jp = jax.tree_util.tree_map(lambda a: a[0, 0], jparams["mlstm"])
        return jcfg, jp, cfg, params.mlstm[0][0]
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["slstm"])
    return jcfg, jp, cfg, params.slstm[0]


def inputs(cfg, s: int, seed: int):
    x = np.random.default_rng(seed).standard_normal((B, s, cfg.d_model))
    x = x.astype(np.float32)
    return (torch.from_numpy(x).to(cfg.activation_dtype),
            jnp.asarray(x, dtype=jnp.dtype(cfg.dtype)))


@pytest.mark.parametrize("s", [64, 72], ids=["multiple", "one_chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_forward_matches_jax(s, dtype):
    """Chunk 16: S 64 runs four chunks through the inter-chunk state, S 72
    (not a multiple) one chunk of 72.  Head size 2d/H = 64 here."""
    jcfg, jp, cfg, p = block_pair("m", dtype)
    assert xlstm._dims(cfg) == (256, 4, 64)
    x, jx = inputs(cfg, s, s)
    tol = MODES["fp32" if dtype == "float32" else "bf16"][2]
    want = jax.jit(lambda p_, x_: jax_xlstm.mlstm_forward(p_, jcfg, x_, 16))(
        jp, jx)
    assert_close(xlstm.mlstm_forward(p, cfg, x, chunk=16), want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_matches_jax(dtype):
    """The serial scan over 48 steps; head size d/H = 32 here."""
    jcfg, jp, cfg, p = block_pair("s", dtype)
    x, jx = inputs(cfg, 48, 1)
    tol = MODES["fp32" if dtype == "float32" else "bf16"][2]
    want = jax.jit(lambda p_, x_: jax_xlstm.slstm_forward(p_, jcfg, x_))(
        jp, jx)
    assert_close(xlstm.slstm_forward(p, cfg, x), want, tol)


def test_blocks_equal_their_recurrences():
    """The chunked mLSTM and the sLSTM scan equal their O(1) decode steps
    run token by token from zero states (float32), with the forget gates
    drawn so the decay matters."""
    _, _, cfg, mp = block_pair("m")
    _, _, _, sp = block_pair("s")
    gen = torch.Generator().manual_seed(3)
    mp.w_if.mul_(4.0)
    x = torch.randn((B, 48, cfg.d_model), generator=gen)
    _, nh, hd = xlstm._dims(cfg)
    state = torch.zeros((B, nh, hd, hd))
    h = c = torch.zeros((B, nh, cfg.d_model // nh))
    m_steps, s_steps = [], []
    for t in range(x.shape[1]):
        y, state = xlstm.mlstm_decode(mp, cfg, x[:, t:t + 1], state)
        m_steps.append(y)
        y, h, c = xlstm.slstm_decode(sp, cfg, x[:, t:t + 1], h, c)
        s_steps.append(y)
    assert_close(torch.cat(m_steps, dim=1),
                 xlstm.mlstm_forward(mp, cfg, x, chunk=16).numpy(), 1e-4)
    assert_close(torch.cat(s_steps, dim=1),
                 xlstm.slstm_forward(sp, cfg, x).numpy(), FP32_TOL)


def test_rounds_match_jax():
    for n_layers, every in ((24, 4), (2, 4), (4, 2), (6, 3), (5, 0)):
        jcfg, _, _, cfg, _, _ = pair(ARCH, n_layers=n_layers,
                                     slstm_every=every)
        assert xlstm.rounds_of(cfg) == jax_xlstm.rounds_of(jcfg)


@pytest.mark.parametrize("config", CONFIGS)
def test_params_round_trip(config):
    _, _, jparams, _, _, params = pair(ARCH, **CONFIGS[config])
    assert_round_trip(jparams, params)


@pytest.mark.parametrize("config", CONFIGS)
def test_port_init_has_the_jax_tree_shapes(config):
    _, _, jparams, _, model, _ = pair(ARCH, **CONFIGS[config])
    assert_init_shapes(model, jparams)


def test_params_from_jax_names_the_bad_path():
    """The mLSTM stack is checked on both of its axes."""
    _, _, jparams, cfg, _, _ = pair(ARCH, **CONFIGS["with_slstm"])
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    m = tree["mlstm"]
    short = dict(tree, mlstm=jax.tree_util.tree_map(lambda a: a[:, :0], m))
    with pytest.raises(ValueError, match=r"mlstm/.*\(2, 1\) layers"):
        params_from_jax(cfg, short, "cpu")
    bad = dict(tree, slstm=dict(tree["slstm"],
                                w_h=tree["slstm"]["w_h"][..., :5]))
    with pytest.raises(ValueError, match="slstm/w_h"):
        params_from_jax(cfg, bad, "cpu")
    missing = {k: v for k, v in tree.items() if k != "slstm"}
    with pytest.raises(KeyError, match="slstm/w_x"):
        params_from_jax(cfg, missing, "cpu")


def test_decode_server_matches_jax():
    assert_constrained_serving(make_pair(arch=ARCH,
                                         **CONFIGS["with_slstm"]))


def test_decode_server_carries_recurrent_state_as_jax():
    """The mLSTM and sLSTM states are never reset between requests; the
    port keeps that."""
    assert_state_carries_over(ARCH, **CONFIGS["with_slstm"])
