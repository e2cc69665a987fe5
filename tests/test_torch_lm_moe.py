"""The port's MoE family (deepseek-moe-16b, kimi-k2-1t-a32b) against the JAX
package's, on the CPU.

At ``smoke_config`` (one dense block, one MoE block of 8 experts, top-2,
one shared expert), JAX's ``init(PRNGKey(0))`` weights are carried across
through ``params_from_jax``; the same seeded tokens then go through both
packages: ``forward``'s hidden states and aux loss, ``prefill``'s logits,
and eight ``decode_step`` logits with the caches they leave, in the modes
and tolerances of ``tests/_torch_lm.py``.  ``moe_ffn`` is held to JAX's
with and without an expert overflowing its capacity; on overflow the
reference's slot ``cap - 1`` holds zeros (its dropped pairs are written
there last), and a plain per-token loop pins that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import tuning as jax_tuning
from repro.models import moe as jax_moe

from repro_torch import tuning
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import mlp

from _torch_lm import (
    FP32_TOL, MODES, assert_close, assert_constrained_serving,
    assert_init_shapes, assert_round_trip, batches, make_pair, pair,
)

ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
B, S, DECODE_STEPS, MAX_SEQ = 2, 80, 8, 16


# bfloat16 carries 8 significant bits; the router's input reaches it
# through the embedding, a dense block and an attention rounded in each
# package, which moves its log-probabilities apart by up to about 8 units
# of it (0.03 at the smoke configs): a top-k flip needs a gap below that
BF16_EPS = 2.0 ** -8
NEAR_TIE = 8 * BF16_EPS


class Routes:
    """Both packages' routes, one MoE layer call at a time: the port's
    ``moe.Route``s (appended to ``port`` by the ``routes=`` argument) and
    JAX's router probabilities, sent by ``jax.debug.callback`` from beside
    JAX's ``moe_ffn`` (one MoE layer at the smoke config, so one call per
    forward or decode step)."""

    def __init__(self, monkeypatch, cfg):
        self.cfg = cfg
        self.port, self.jax = [], []
        jax_ffn = jax_moe.moe_ffn

        def jax_moe_ffn(p, cfg, x):
            xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            probs = jax.nn.softmax(xf @ p["router"], axis=-1)
            jax.debug.callback(lambda t: self.jax.append(np.asarray(t)),
                               probs)
            return jax_ffn(p, cfg, x)

        monkeypatch.setattr(jax_moe, "moe_ffn", jax_moe_ffn)

    def agree(self) -> np.ndarray:
        """Per token of the call since the last ``agree``: True where both
        packages applied the same experts.  A token whose top-k set
        differs must be a near-tie: the log-gap between JAX's k-th and
        (k+1)-th probabilities within ``NEAR_TIE``.  Every other token whose applied experts
        differ must be one whose capacity rank those flips moved: the
        reference's dispatch of JAX's routes, with the flipped tokens'
        routes taken from the port, applies the port's experts."""
        assert len(self.port) == len(self.jax) == 1
        got, jprobs = self.port.pop(), torch.from_numpy(self.jax.pop().copy())
        k, e = self.cfg.experts_per_token, self.cfg.n_experts
        cap = moe.capacity(self.cfg, jprobs.shape[0])
        jtopi = torch.sort(jprobs, dim=-1, descending=True,
                           stable=True)[1][:, :k]
        flipped = (torch.sort(got.topi, -1)[0]
                   != torch.sort(jtopi, -1)[0]).any(-1)
        if flipped.any():
            top = torch.sort(torch.log(jprobs[flipped].double()), -1,
                             descending=True)[0]
            gap = top[:, k - 1] - top[:, k]
            assert (gap <= NEAR_TIE).all(), gap
        hybrid = torch.where(flipped[:, None], got.topi, jtopi)
        moved = moe.applied_experts(hybrid, cap, e)
        assert torch.equal(torch.sort(moved, -1)[0],
                           torch.sort(got.applied, -1)[0])
        want = moe.applied_experts(jtopi, cap, e)
        return (torch.sort(got.applied, -1)[0]
                == torch.sort(want, -1)[0]).all(-1).numpy()


def check_rows(port, ref, agree, tol, exact: bool):
    """``port`` within ``tol`` of ``ref`` on the rows whose applied experts
    agree; in float32 (``exact``) every row must agree.  Returns the
    number of rows that differ."""
    flips = int((~agree).sum())
    if exact:
        assert flips == 0
    # a flip sends a token through other experts, so its row differs by
    # the experts' output, not by rounding; few tokens sit that near a tie
    assert flips <= max(1, agree.size // 20), flips
    assert_close(port[torch.from_numpy(agree)], np.asarray(ref)[agree], tol)
    return flips


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_forward_prefill_and_decode_match_jax(arch, mode, monkeypatch):
    """In bfloat16 the two packages' router inputs differ by rounding, so a
    token whose k-th and (k+1)-th expert probabilities nearly tie can pick
    another expert set in each: ``Routes.agree`` proves each such token a
    near-tie and every other differing token a capacity rank it moved;
    those rows must be few and are left out of the comparison; in float32
    every route must agree and every row is compared."""
    dtype, knobs, tol = MODES[mode]
    exact = dtype == "float32"
    jcfg, jmodel, jparams, cfg, model, params = pair(arch, dtype)
    jb, tb = batches(cfg, B, S)
    routes = Routes(monkeypatch, cfg)
    with jax_tuning.overrides(**knobs), tuning.overrides(**knobs):
        jhidden, jaux = jax.jit(lambda p, t: jax_moe.forward(p, jcfg, t))(
            jparams, jb["tokens"])
        hidden, aux = moe.forward(params, cfg, tb["tokens"], routes.port)
        assert hidden.dtype == cfg.activation_dtype
        agree = routes.agree().reshape(B, S)
        check_rows(hidden, jhidden, agree, tol, exact)
        if exact:
            assert_close(aux, jaux, tol)
        # prefill routes as forward did (the same tokens, the same ops)
        logits = model.prefill(params, tb)
        assert logits.shape == (B, cfg.vocab)
        jlogits = jax.jit(jmodel.prefill)(jparams, jb)
        routes.jax.clear()
        check_rows(logits, jlogits, agree[:, -1], tol, exact)

        jcache = jmodel.init_cache(B, MAX_SEQ)
        cache = model.init_cache(B, MAX_SEQ)
        jdecode = jax.jit(jmodel.decode)
        for pos in range(DECODE_STEPS):
            jlogits, jcache = jdecode(jparams, jcache,
                                      jb["tokens"][:, pos:pos + 1],
                                      jnp.int32(pos))
            logits, cache = model.decode(params, cache,
                                         tb["tokens"][:, pos:pos + 1], pos,
                                         routes=routes.port)
            check_rows(logits, jlogits, routes.agree(), tol, exact)
            # the MoE block is the last, so its routes reach no cache
            for name in ("k", "v"):
                assert cache[name].dtype == cfg.activation_dtype
                assert_close(cache[name], jcache[name], tol)


def ffn_pair(arch="deepseek-moe-16b", **fields):
    jcfg, _, jparams, cfg, _, params = pair(arch, **fields)
    return jcfg, jparams["moe_layers"], cfg, params.moe_layers[0].moe


def layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def overflowing(cfg, topi: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.bincount(topi.reshape(-1), minlength=cfg.n_experts) > cap


def plain_moe(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """The reference's single-device result, token by token: each (token,
    expert) pair in token order takes the next slot of its expert; a pair
    past the capacity is dropped, and on an expert that overflowed so is
    the pair in its last slot."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    cap = moe.capacity(cfg, t)
    _, topv, topi = moe.route(p, cfg, xf)
    over = overflowing(cfg, topi, cap)
    seen = [0] * cfg.n_experts
    out = mlp(p.shared, xf) if hasattr(p, "shared") else torch.zeros_like(xf)
    for tok in range(t):
        for slot in range(cfg.experts_per_token):
            e = int(topi[tok, slot])
            rank, seen[e] = seen[e], seen[e] + 1
            if rank >= cap or (over[e] and rank == cap - 1):
                continue
            h = F.silu(xf[tok] @ p.w_gate[e]) * (xf[tok] @ p.w_up[e])
            out[tok] = out[tok] + topv[tok, slot] * (h @ p.w_down[e])
    return out.reshape(b, s, d)


@pytest.mark.parametrize("capacity_factor,overflow",
                         [(1.25, False), (0.25, True)],
                         ids=["fits", "overflows"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_and_aux_match_jax(arch, capacity_factor, overflow):
    """(4, 64) tokens: at the configs' factor 1.25 every pair fits (128
    pairs over 8 experts, capacity 24); at 0.25 the capacity is 8 and
    experts overflow.  Output and aux equal JAX's, and the plain loop's
    (which drops the overflowing experts' last slot)."""
    jcfg, jp, cfg, p = ffn_pair(arch, capacity_factor=capacity_factor)
    x = np.random.default_rng(3).standard_normal((4, 64, cfg.d_model))
    x = x.astype(np.float32)
    jout, jaux = jax.jit(lambda p_, x_: jax_moe.moe_ffn(p_, jcfg, x_))(
        layer0(jp)["moe"], jnp.asarray(x))
    xt = torch.from_numpy(x)
    out, aux = moe.moe_ffn(p, cfg, xt)
    assert_close(out, jout, FP32_TOL)
    assert_close(aux, jaux, FP32_TOL)
    _, _, topi = moe.route(p, cfg, xt.reshape(-1, cfg.d_model))
    cap = moe.capacity(cfg, 4 * 64)
    assert bool(overflowing(cfg, topi, cap).any()) == overflow
    assert_close(out, np.asarray(plain_moe(p, cfg, xt)), FP32_TOL)


def test_overflow_clobbers_the_last_kept_slot():
    """The pin itself: on an overflowing expert the token JAX kept at rank
    ``cap - 1`` gets none of that expert's output.  A capacity of one
    slot more restores it, and JAX's output moves with it."""
    jcfg, jp, cfg, p = ffn_pair(capacity_factor=0.25)
    x = np.random.default_rng(3).standard_normal((4, 64, cfg.d_model))
    xt = torch.from_numpy(x.astype(np.float32))
    xf = xt.reshape(-1, cfg.d_model)
    cap = moe.capacity(cfg, xf.shape[0])
    _, _, topi = moe.route(p, cfg, xf)
    e = int(torch.nonzero(overflowing(cfg, topi, cap))[0, 0])
    pairs = torch.nonzero(topi.reshape(-1) == e).flatten()
    victim = int(pairs[cap - 1]) // cfg.experts_per_token
    routes = []
    out, _ = moe.moe_ffn(p, cfg, xt, routes)
    jout, _ = jax_moe.moe_ffn(layer0(jp)["moe"], jcfg, jnp.asarray(xt.numpy()))
    assert_close(out, jout, FP32_TOL)
    (r,) = routes
    assert torch.equal(r.topi, topi)
    assert e in r.topi[victim] and e not in r.applied[victim]
    assert torch.equal(r.applied, moe.applied_experts(topi, cap,
                                                      cfg.n_experts))
    wider = dataclasses.replace(cfg, capacity_factor=0.25 * (cap + 8) / cap)
    assert moe.capacity(wider, xf.shape[0]) == cap + 8
    out2, _ = moe.moe_ffn(p, wider, xt)
    jwider = dataclasses.replace(jcfg, capacity_factor=wider.capacity_factor)
    jout2, _ = jax_moe.moe_ffn(layer0(jp)["moe"], jwider,
                               jnp.asarray(xt.numpy()))
    assert_close(out2, jout2, FP32_TOL)
    row = out.reshape(-1, cfg.d_model)[victim]
    row2 = out2.reshape(-1, cfg.d_model)[victim]
    assert not torch.allclose(row, row2)


def test_top_k_ties_go_to_the_lower_expert():
    """``lax.top_k`` takes the lowest index among equal probabilities: with
    experts 4-7 copies of 0-3, each token's top two are an expert and its
    copy, the original first."""
    jcfg, jp, cfg, p = ffn_pair()
    router = p.router.clone()
    p.router[:, 4:] = router[:, :4]          # experts 4-7 copy 0-3
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    _, _, topi = moe.route(p, cfg, x.reshape(8, -1))
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(8, -1).numpy())
                            @ jnp.asarray(p.router.numpy()), axis=-1)
    _, jtopi = jax.lax.top_k(jprobs, cfg.experts_per_token)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    assert (topi[:, 0] < 4).all() and (topi[:, 1] == topi[:, 0] + 4).all()


def test_decode_capacity_never_drops():
    """A decode batch of B <= 8 tokens fits: the capacity is at least 8
    and a token picks an expert at most once."""
    _, _, _, cfg, _, _ = pair("deepseek-moe-16b")
    for b in range(1, 9):
        assert moe.capacity(cfg, b) >= 8 >= b
    # ceil(512 * 2 / 8 * 1.25) = 160, a multiple of 8
    assert moe.capacity(cfg, 4 * 128) == 160


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    _, model, jparams, _, _, params = pair(arch)
    assert_round_trip(jparams, params)
    assert len(params.dense_layers) == 1 and len(params.moe_layers) == 1
    assert params.moe_layers[0].moe.router.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_jax_tree_shapes(arch):
    _, _, jparams, cfg, model, _ = pair(arch)
    assert_init_shapes(model, jparams)


def test_params_from_jax_names_the_bad_path():
    _, _, jparams, cfg, _, _ = pair("deepseek-moe-16b")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    moe_l = tree["moe_layers"]
    bad = dict(tree, moe_layers=dict(moe_l, moe=dict(
        moe_l["moe"], w_up=moe_l["moe"]["w_up"][:, :3])))
    with pytest.raises(ValueError, match="moe_layers/moe/w_up"):
        params_from_jax(cfg, bad, "cpu")
    missing = dict(tree, dense_layers={k: v for k, v in
                                       tree["dense_layers"].items()
                                       if k != "ln2"})
    with pytest.raises(KeyError, match="dense_layers/ln2/scale"):
        params_from_jax(cfg, missing, "cpu")
    extra = dict(tree, unembed=tree["embed"])
    with pytest.raises(ValueError, match="unembed"):
        params_from_jax(cfg, extra, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_server_matches_jax(arch):
    """``DecodeServer`` on the smoke config: the reference's cross-slot
    cache writes included, every route agrees in float32."""
    assert_constrained_serving(make_pair(arch=arch))


@pytest.mark.parametrize("mesh_shape", [None, (2, 4)],
                         ids=["single_device", "2x4"])
def test_dispatch_traces_on_the_meta_device(mesh_shape, monkeypatch):
    """The capacity dispatch has fixed shapes (expert loads by
    ``scatter_add_``, lost pairs written to a spare row that is sliced
    off), so deepseek's smoke train step (forward, remat's recomputation
    and backward) runs on the meta device, which has no ``bincount`` and
    no data for a boolean mask: single-device through ``_moe_ffn_local``
    and over (2, 4) through ``_moe_ffn_shardmap``, with no torch flag."""
    from repro_torch.configs import ShapeConfig, get_config, smoke_config
    from repro_torch.core.engine import make_mesh2d
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import abstract_params, build_train_step

    routes = []
    for name in ("_moe_ffn_local", "_moe_ffn_shardmap"):
        real = getattr(moe, name)

        def counted(*a, _real=real, _name=name, **kw):
            routes.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(moe, name, counted)
    model = build_model(smoke_config(get_config("deepseek-moe-16b")),
                        device="meta")
    mesh = None if mesh_shape is None else make_mesh2d(
        *mesh_shape, data_axis="data", shard_axis="model",
        devices=["meta"] * (mesh_shape[0] * mesh_shape[1]))
    params = abstract_params(model)
    fn, _, opt = build_train_step(model, mesh)
    batch = model.batch_spec(ShapeConfig("train_smoke", 32, 8, "train"))
    _, _, metrics = fn(params, adamw.init(opt, params), batch)
    assert metrics["loss"].device.type == "meta"
    assert metrics["loss"].shape == ()
    want = "_moe_ffn_local" if mesh is None else "_moe_ffn_shardmap"
    assert routes == [want] * 2          # the forward and its recomputation
