"""Shared set-up of the port's LM tests against the JAX package, on the CPU.

``pair`` builds one architecture in both packages from JAX's
``init(PRNGKey(0))`` weights, carried across through ``params_from_jax``;
``batches`` draws the same seeded inputs for both; ``assert_close`` holds
a port tensor to a JAX array as a share of the JAX array's largest
magnitude; ``serve_both`` runs the same requests through both packages'
``DecodeServer``, recording every decode call's logits.  For training:
``train_batches`` adds seeded ``labels``, ``auto_mesh`` is the 1 x 1 mesh
whose axes are ``Auto`` (``repro.launch.mesh.make_local_mesh`` gives
``Explicit`` axes under jax 0.9, which the reference's sharding constraints
refuse), and ``assert_tree_close`` holds a port tree (JAX layout, from
``named_to_numpy``) to a JAX tree leaf by leaf.

Modes and tolerances: float32, ``FP32_TOL`` 1e-5 (float32 rounds at
2^-24; the two packages sum in other orders and use their own
transcendentals, a few ulps through two layers); bfloat16, with the
default knobs and with ``KNOBS``, ``BF16_TOL`` 5e-2 (bf16 rounds at 2^-9;
XLA keeps f32 across fused elementwise ops where torch rounds after each
op, and two layers of about ten rounding sites each compound that).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models.model import build_model as jax_build_model
from repro.parallel import ctx as jax_ctx
from repro.serve.constrain import ConstraintSet as JaxConstraintSet
from repro.serve.engine import DecodeServer as JaxDecodeServer
from repro.serve.engine import Request as JaxRequest

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model
from repro_torch.parallel import ctx
from repro_torch.serve.constrain import ConstraintSet
from repro_torch.serve.engine import DecodeServer, Request

FP32_TOL = 1e-5
BF16_TOL = 5e-2
KNOBS = dict(q_chunk=16, scores_dtype="bf16", gqa_native=True, act_bf16=True)
MODES = {"fp32": ("float32", {}, FP32_TOL),
         "bf16": ("bfloat16", {}, BF16_TOL),
         "bf16_knobs": ("bfloat16", KNOBS, BF16_TOL)}
FULL_WIDTH_VOCAB = 4096


def assert_close(port: torch.Tensor, ref, tol: float) -> None:
    want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = port.float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, np.abs(want).max())


def pair(arch: str, dtype: str = "float32", full_width: bool = False,
         **fields):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    at the smoke config, or at the arch's own widths with one layer and a
    ``FULL_WIDTH_VOCAB``-token vocabulary, with ``fields`` replaced in
    both; JAX's PRNGKey(0) weights in both."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if full_width:
        jcfg, cfg = (dataclasses.replace(c, n_layers=1, vocab=FULL_WIDTH_VOCAB)
                     for c in (jcfg, cfg))
    else:
        jcfg, cfg = jax_smoke_config(jcfg), smoke_config(cfg)
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype, **fields)
                 for c in (jcfg, cfg))
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


def batches(cfg, b: int, s: int, seed: int = 0):
    """The same seeded (JAX, port) batches: ``tokens``, and
    ``patch_embeds`` / ``frames`` where the architecture takes them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    extra = {}
    if cfg.frontend == "patch":
        extra["patch_embeds"] = (b, cfg.num_patches, cfg.frontend_dim)
    if cfg.family == "encdec":
        extra["frames"] = (b, cfg.encoder_seq, cfg.frontend_dim)
    for name, shape in extra.items():
        x = rng.standard_normal(shape).astype(np.float32)
        jb[name], tb[name] = jnp.asarray(x), torch.from_numpy(x)
    return jb, tb


def train_batches(cfg, b: int, s: int, seed: int = 0):
    """``batches`` plus the same seeded ``labels`` (B, S) in both."""
    jb, tb = batches(cfg, b, s, seed)
    labels = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels.astype(np.int64))
    return jb, tb


def auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def assert_tree_close(port_tree, jax_tree, tol: float) -> None:
    """Every leaf of ``port_tree`` (numpy, JAX layout) within ``tol`` of
    JAX's leaf at the same path, as a share of its largest magnitude."""
    got = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jax_tree))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), (
            jax.tree_util.keystr(path), err, float(np.abs(w).max()))


def assert_round_trip(jparams, params) -> None:
    """``params_to_numpy`` gives back JAX's tree, leaf for leaf."""
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


def assert_init_shapes(model, jparams) -> None:
    """The port's own initialisation has JAX's tree shapes, is seeded, and
    draws norms at one."""
    params = model.init(torch.Generator().manual_seed(0))
    tree = params_to_numpy(params)
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(np.shape, jparams)
    np.testing.assert_array_equal(tree["ln_f"]["scale"], 1.0)
    again = params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    np.testing.assert_array_equal(again["embed"], tree["embed"])


def decode_both(jmodel, jparams, jcache, model, params, cache, jtokens,
                tokens, steps: int, tol: float) -> None:
    """``steps`` decode steps in both packages from position 0, the logits
    and every cache entry held within ``tol`` after each."""
    jdecode = jax.jit(jmodel.decode)
    assert set(cache) == set(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == tuple(jcache[name].shape), name
    for pos in range(steps):
        jlogits, jcache = jdecode(jparams, jcache,
                                  jtokens[:, pos:pos + 1], jnp.int32(pos))
        logits, cache = model.decode(params, cache,
                                     tokens[:, pos:pos + 1], pos)
        assert_close(logits, jlogits, tol)
        for name in cache:
            assert cache[name].dtype == getattr(
                torch, jnp.dtype(jcache[name].dtype).name), name
            assert_close(cache[name], jcache[name], tol)


# ------------------------------------------------------------------ servers

CPU = "cpu"


@dataclasses.dataclass
class Pair:
    jmodel: object
    jparams: object
    model: object
    params: object

    @property
    def vocab(self):
        return self.model.cfg.vocab


def make_pair(fields=None, arch=None, **replace) -> Pair:
    """Both packages' model of the ``ArchConfig`` ``fields``, or of
    ``arch``'s smoke config with ``replace`` applied, JAX's PRNGKey(0)
    weights in both."""
    if arch is not None:
        jcfg = jax_smoke_config(jax_get_config(arch))
        cfg = smoke_config(get_config(arch))
        jcfg, cfg = (dataclasses.replace(c, **replace) for c in (jcfg, cfg))
    else:
        jcfg, cfg = JaxArchConfig(**fields), ArchConfig(**fields)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    return Pair(jmodel, jparams, build_model(cfg, device=CPU), params)


def record(server, to_numpy):
    calls = []
    decode = server._decode

    def recorded(params, cache, tokens, pos):
        logits, cache = decode(params, cache, tokens, pos)
        calls.append(to_numpy(logits))
        return logits, cache
    server._decode = recorded
    return calls


def serve_both(pair: Pair, scripts, batch_slots: int, max_seq: int,
               constraints=None):
    """``scripts``: (prompt, max_new, constraint name or None) triples;
    ``constraints``: name -> (allowed sets, banned sets).  Returns the
    port's and JAX's outputs and recorded logits."""
    jsrv = JaxDecodeServer(pair.jmodel, pair.jparams, batch_slots=batch_slots,
                           max_seq=max_seq)
    srv = DecodeServer(pair.model, pair.params, batch_slots=batch_slots,
                       max_seq=max_seq)
    jcalls = record(jsrv, lambda x: np.asarray(x))
    calls = record(srv, lambda x: x.numpy().copy())
    masks, jmasks = {}, {}
    for name, (allowed, banned) in (constraints or {}).items():
        cs, jcs = ConstraintSet(pair.vocab, device=CPU), JaxConstraintSet(
            pair.vocab)
        for i, ids in enumerate(allowed):
            cs.add_allowed(f"a{i}", ids)
            jcs.add_allowed(f"a{i}", ids)
        for i, ids in enumerate(banned):
            cs.add_banned(f"b{i}", ids)
            jcs.add_banned(f"b{i}", ids)
        masks[name], jmasks[name] = cs.combined(), jcs.combined()
    reqs, jreqs, tickets, jtickets = [], [], [], []
    for prompt, max_new, c in scripts:
        prompt = np.asarray(prompt)
        reqs.append(Request(prompt=prompt, max_new=max_new,
                            constraint=masks.get(c)))
        jreqs.append(JaxRequest(prompt=prompt, max_new=max_new,
                                constraint=jmasks.get(c)))
        tickets.append(srv.submit(reqs[-1]))
        jtickets.append(jsrv.submit(jreqs[-1]))
    srv.run_until_drained()
    jsrv.run_until_drained()
    for r, t, jr, jt in zip(reqs, tickets, jreqs, jtickets):
        assert r.done and jr.done
        assert t.done and t.value == r.out and jt.value == jr.out
    return ([r.out for r in reqs], [r.out for r in jreqs], calls, jcalls,
            srv, jsrv)


def assert_same_run(out, jout, calls, jcalls):
    assert out == jout
    assert len(calls) == len(jcalls)
    for got, want in zip(calls, jcalls):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= FP32_TOL * np.abs(want).max()


def assert_state_carries_over(arch: str, **replace) -> None:
    """The reference's ``_admit`` resets only a slot's position, and every
    decode call steps every row: a recurrent family's state carries the
    previous request and the other slots' token-0 steps.  Request [3, 4]'s
    first decode call gives other logits after [1, 2] on one slot (call 6,
    after 2 prompt and 4 generated calls) and in slot 1 beside it (call 2,
    after slot 0's prompt stepped slot 1 twice with token 0) than alone;
    each run equals JAX's."""
    pair = make_pair(arch=arch, **replace)
    first, second = ([1, 2], 4, None), ([3, 4], 6, None)
    after = serve_both(pair, [first, second], batch_slots=1, max_seq=32)
    alone = serve_both(pair, [second], batch_slots=1, max_seq=32)
    beside = serve_both(pair, [first, second], batch_slots=2, max_seq=32)
    for out, jout, calls, jcalls, _, _ in (after, alone, beside):
        assert_same_run(out, jout, calls, jcalls)
    clean = alone[2][0][0]
    assert not np.allclose(after[2][6][0], clean, rtol=1e-3, atol=0)
    assert not np.allclose(beside[2][2][1], clean, rtol=1e-3, atol=0)


def assert_constrained_serving(pair: Pair):
    """A request constrained to [120, 400) (an allowed set and a banned
    stop-list, ANDed) and a free one on two slots: tokens and every decode
    call's logits equal JAX's, the constrained tokens inside the
    intersection.  Returns the (port, JAX) servers."""
    out, jout, calls, jcalls, srv, jsrv = serve_both(
        pair, [([1, 2, 3], 6, "c"), ([4, 5], 6, None)], batch_slots=2,
        max_seq=32, constraints={"c": ([np.arange(100, 400)],
                                       [np.arange(100, 120)])})
    assert_same_run(out, jout, calls, jcalls)
    assert all(len(o) == 6 for o in out)
    assert set(out[0]) <= set(range(120, 400))
    return srv, jsrv


# ------------------------------------------------------ sharding constraints

def jax_constrain_sites(fn) -> set:
    """The (shape, resolved spec) pairs the JAX package's
    ``ctx.constrain`` hands to ``with_sharding_constraint`` while ``fn()``
    runs (each call returns its input instead)."""
    sites = set()
    real = jax.lax.with_sharding_constraint

    def spy(x, sharding):
        sites.add((tuple(x.shape), tuple(sharding.spec)))
        return x
    jax.lax.with_sharding_constraint = spy
    try:
        fn()
    finally:
        jax.lax.with_sharding_constraint = real
    return sites


def port_constrain_sites(fn) -> set:
    """The (shape, resolved spec) pairs the port's ``ctx.constrain``
    resolves while ``fn()`` runs."""
    sites = set()
    real = ctx.resolve

    def spy(shape, spec, mesh):
        out = real(shape, spec, mesh)
        sites.add((tuple(shape), tuple(out)))
        return out
    ctx.resolve = spy
    try:
        fn()
    finally:
        ctx.resolve = real
    return sites


def cpu_mesh(shape, distinct: bool = False):
    """The port's ``(data, model)`` mesh of ``shape`` over logical CPU
    devices: ``"cpu"`` repeated, or ``cpu:0``, ``cpu:1``, ... (distinct
    devices: a move between two of them copies)."""
    from repro_torch.core.engine import make_mesh2d

    n = shape[0] * shape[1]
    devices = [torch.device("cpu", i) for i in range(n)] if distinct \
        else ["cpu"] * n
    return make_mesh2d(shape[0], shape[1], data_axis="data",
                       shard_axis="model", devices=devices)


def constrain_sites_both(arch, mesh_shape, step):
    """Every (shape, resolved spec) of one prefill (B 2 x S 8) or decode
    step (B 2, cache 8) of ``arch``'s smoke config under a ``(data,
    model)`` mesh of ``mesh_shape``: (JAX's, the port's).  JAX traces
    (``eval_shape``) on an ``AbstractMesh``; the port runs."""
    jcfg = jax_smoke_config(jax_get_config(arch))
    jmodel = jax_build_model(jcfg)
    jp = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    cfg = smoke_config(get_config(arch))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    jb, tb = batches(cfg, 2, 8)
    jmesh = jax.sharding.AbstractMesh(mesh_shape, ("data", "model"))
    mesh = cpu_mesh(mesh_shape)

    def jax_run():
        if step == "prefill":
            jax.eval_shape(jmodel.prefill, jp, jb)
        else:
            jax.eval_shape(jmodel.decode, jp, jmodel.init_cache(2, 8),
                           jb["tokens"][:, :1], jnp.int32(3))

    def port_run():
        if step == "prefill":
            model.prefill(params, tb)
        else:
            model.decode(params, model.init_cache(2, 8), tb["tokens"][:, :1], 3)

    with jax_ctx.activation_mesh(jmesh):
        want = jax_constrain_sites(jax_run)
    with ctx.activation_mesh(mesh):
        got = port_constrain_sites(port_run)
    return want, got
