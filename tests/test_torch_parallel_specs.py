"""The port's sharding rules, meshes, activation context and collectives
against the JAX package's, on the CPU.

(a) Specs: for all ten configs at full size, every parameter's spec (FSDP
off and on), AdamW's ``m`` / ``v``, the cache's from ``init_cache(4,
1024)`` and the batch's (``tokens``, ``labels``, whisper's ``frames``,
phi-3-vision's ``patch_embeds``, at B 4 and the long-context B 1) equal
JAX's ``PartitionSpec`` on meshes (1, 1), (2, 4), (16, 16) and (2, 16,
16), with the leading ``None``s of JAX's stacked layer axes dropped.  The
JAX side runs on ``jax.sharding.AbstractMesh`` and ``jax.eval_shape``; the
port's on ``launch.mesh`` meshes of logical CPU devices and meta tensors.
Exact equality.

(b) Context: ``constrain`` returns its input and resolves the spec JAX's
hands to ``with_sharding_constraint`` (captured by replacing it), for
random shapes and specs and at every call site of a prefill and a decode
step; ``activation_mesh`` nests.

(c) Collectives: each against its whole-tensor formula, on grids of
repeated and of distinct CPU devices, exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.parallel import ctx as jax_ctx
from repro.parallel import sharding as jax_sharding

from _torch_lm import (
    constrain_sites_both, cpu_mesh, jax_constrain_sites, port_constrain_sites,
)
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.convert import _jax_path
from repro_torch.models.model import _MODULES, build_model
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx, sharding
from repro_torch.train.step import abstract_params, needs_fsdp

ARCHS = sorted(ARCH_IDS)
MESH_SHAPES = {"1x1": ((1, 1), ("data", "model")),
               "2x4": ((2, 4), ("data", "model")),
               "16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def port_mesh(name):
    shape, axes = MESH_SHAPES[name]
    if name == "16x16":
        return make_production_mesh(devices=["cpu"] * 256)
    if name == "2x16x16":
        return make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    if name == "1x1":
        return make_local_mesh(devices=["cpu"])
    return cpu_mesh(shape)


@functools.lru_cache(maxsize=None)
def jax_trees(arch):
    """JAX's abstract params, AdamW state and (4, 1024) cache of ``arch``."""
    model = jax_build_model(jax_get_config(arch))
    p = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(lambda p: jax_adamw.init(jax_adamw.AdamWConfig(), p),
                         p)
    cache = jax.eval_shape(lambda: model.init_cache(4, 1024))
    return p, opt, cache


def jax_by_port_name(tree, names):
    """JAX's leaf for each port name (``layers.3.attn.wq`` ->
    ``tree["layers"]["attn"]["wq"]``), stacked axes still on."""
    out = {}
    for name in names:
        leaf = tree
        for k in _jax_path(name)[0]:
            leaf = leaf[k]
        out[name] = leaf
    return out


def unstacked(spec: JaxP, name: str):
    """JAX's spec of a port parameter: the stacked axes' entries dropped
    (they must be None)."""
    n = len(_jax_path(name)[1])
    entries = tuple(spec) + (None,) * 8
    assert all(e is None for e in entries[:n]), (name, spec)
    return tuple(spec)[n:]


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("mesh_name", sorted(MESH_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, mesh_name):
    shape, axes = MESH_SHAPES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    mesh = port_mesh(mesh_name)
    assert mesh.shape == dict(jmesh.shape)
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    params = abstract_params(model)
    names = [n for n, _ in params.named_parameters()]
    jp, jopt, jcache = jax_trees(arch)
    for fsdp in (False, True):
        want = jax_sharding.param_pspecs(jp, jmesh, fsdp=fsdp)
        got = sharding.param_pspecs(params, mesh, fsdp=fsdp)
        assert list(got) == names
        by_name = jax_by_port_name(want, names)
        for name, p in params.named_parameters():
            assert padded(got[name], p.ndim) == padded(
                unstacked(by_name[name], name), p.ndim), name
    # AdamW m / v, keyed by the same names, on the meta device
    opt = adamw.init(adamw.AdamWConfig(), params)
    for field in ("m", "v"):
        want = jax_by_port_name(jax_sharding.param_pspecs(
            getattr(jopt, field), jmesh, fsdp=True), names)
        got = sharding.param_pspecs(getattr(opt, field), mesh, fsdp=True)
        for name, t in getattr(opt, field).items():
            assert padded(got[name], t.ndim) == padded(
                unstacked(want[name], name), t.ndim), (field, name)
    # caches, in JAX's layout on the port too
    cache = _MODULES[cfg.family].init_cache(cfg, 4, 1024, device="meta")
    want = jax_sharding.cache_pspecs(jcache, jmesh)
    got = sharding.cache_pspecs(cache, mesh)
    assert set(got) == set(want)
    for name, t in cache.items():
        assert tuple(t.shape) == tuple(jcache[name].shape), name
        assert padded(got[name], t.ndim) == padded(want[name], t.ndim), name
    # batches at B 4 and the long-context B 1
    for b in (4, 1):
        batch = {"tokens": (b, 1024), "labels": (b, 1024)}
        if cfg.family == "encdec":
            batch["frames"] = (b, cfg.encoder_seq, cfg.frontend_dim)
        if cfg.frontend == "patch":
            batch["patch_embeds"] = (b, cfg.num_patches, cfg.frontend_dim)
        want = jax_sharding.batch_pspecs(
            {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in batch.items()},
            jmesh)
        got = sharding.batch_pspecs(
            {k: torch.empty(s, device="meta") for k, s in batch.items()}, mesh)
        for k, s in batch.items():
            assert padded(got[k], len(s)) == padded(want[k], len(s)), (b, k)
    assert sharding.dp_axes(mesh) == jax_sharding.dp_axes(jmesh)
    assert sharding.tp_axis(mesh) == "model"
    assert needs_fsdp(model) == (cfg.param_count() > 3e9)
    shards = sharding.shardings_of(cache, got_cache := sharding.cache_pspecs(
        cache, mesh), mesh)
    assert {k: (s.mesh, s.spec) for k, s in shards.items()} == {
        k: (mesh, got_cache[k]) for k in cache}


def test_assign_spec_matches_jax_on_random_shapes():
    """Random shapes (dims of 1-64 and multiples of 16) and preference
    lists (axis names, tuples, None, dims past the rank) on all four
    meshes: the same spec as JAX's ``assign_spec``."""
    rng = np.random.default_rng(0)
    choices = ["data", "model", "pod", ("pod", "data"), ("data", "model"),
               ("model", "pod", "data"), None]
    for mesh_name, (shape, axes) in MESH_SHAPES.items():
        jmesh, mesh = AbstractMesh(shape, axes), port_mesh(mesh_name)
        for _ in range(300):
            ndim = int(rng.integers(0, 5))
            dims = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 16, 32, 48, 64,
                                         256, 512]))
                         for _ in range(ndim))
            prefs = [(choices[int(rng.integers(len(choices)))],
                      -int(rng.integers(1, 6)))
                     for _ in range(int(rng.integers(0, 4)))]
            want = jax_sharding.assign_spec(dims, prefs, jmesh)
            got = sharding.assign_spec(dims, prefs, mesh)
            assert padded(got, ndim) == padded(want, ndim), (dims, prefs)


def test_meshes_need_their_devices():
    """Production meshes hold exactly 256 / 512 devices; without
    ``devices=`` the builders take the visible CUDA devices and raise
    with none, never falling back to the CPU."""
    m = make_production_mesh(devices=["cpu"] * 256)
    assert m.axis_names == ("data", "model") and m.devices.shape == (16, 16)
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 256)
    local = make_local_mesh(devices=["cpu"] * 4)
    assert local.shape == {"data": 1, "model": 4}
    if not torch.cuda.is_available():
        for build in (make_local_mesh, make_production_mesh):
            with pytest.raises(RuntimeError, match="needs a GPU"):
                build()


# ------------------------------------------------------------------ (b)

SPEC_ENTRIES = ["data", "model", "pod", ctx.DP, None, ("data", "model"),
                ("pod", "data")]


def test_constrain_resolves_as_jax():
    """Random shapes and specs (``DP``, tuples, None, axes that do not
    divide) on (2, 4), (16, 16) and (2, 16, 16): the port's ``resolve``
    gives the spec the reference hands to ``with_sharding_constraint``,
    and ``constrain`` returns its input itself."""
    rng = np.random.default_rng(1)
    for mesh_name in ("2x4", "16x16", "2x16x16"):
        shape, axes = MESH_SHAPES[mesh_name]
        jmesh, mesh = AbstractMesh(shape, axes), port_mesh(mesh_name)
        for _ in range(120):
            ndim = int(rng.integers(1, 4))
            dims = tuple(int(rng.choice([1, 2, 4, 6, 16, 32, 48]))
                         for _ in range(ndim))
            spec, used = [], set()
            for _ in range(ndim):     # no mesh axis twice in one spec
                e = SPEC_ENTRIES[int(rng.integers(len(SPEC_ENTRIES)))]
                names = set(axes[:-1]) if e == ctx.DP else \
                    {e} if isinstance(e, str) else set(e or ())
                if names - set(axes) or names & used:
                    e, names = None, set()
                used |= names
                spec.append(e)
            spec = tuple(spec)
            x = jax.ShapeDtypeStruct(dims, jnp.float32)
            with jax_ctx.activation_mesh(jmesh):
                want = jax_constrain_sites(lambda: jax_ctx.constrain(x, spec))
            t = torch.zeros(dims)
            with ctx.activation_mesh(mesh):
                got = port_constrain_sites(
                    lambda: ctx.constrain(t, spec) is t or pytest.fail())
            assert got == want, (dims, spec)
    t = torch.ones(3)
    assert ctx.constrain(t, ("model",)) is t       # no mesh: nothing resolved


def test_activation_mesh_nests():
    a, b = cpu_mesh((1, 2)), cpu_mesh((2, 2))
    assert ctx.current_mesh() is None
    with ctx.activation_mesh(a):
        assert ctx.current_mesh() is a
        with ctx.activation_mesh(b):
            assert ctx.current_mesh() is b
            with ctx.activation_mesh(None):
                assert ctx.current_mesh() is None
            assert ctx.current_mesh() is b
        assert ctx.current_mesh() is a
    assert ctx.current_mesh() is None
    with pytest.raises(KeyError):
        with ctx.activation_mesh(a):
            ctx.resolve((4,), ("pod",), a)
    assert ctx.current_mesh() is None


# arch -> (mesh shape, steps compared): the MoE config on a model axis of
# 3, which does not divide its 8 experts, so both packages take the local
# dispatch, whose constraints are the ones compared here
SITE_CASES = {"qwen3-1.7b": ((2, 4), ("prefill", "decode")),
              "gemma3-12b": ((2, 4), ("prefill", "decode")),
              "deepseek-moe-16b": ((2, 3), ("prefill", "decode")),
              "zamba2-2.7b": ((2, 4), ("prefill", "decode")),
              "xlstm-350m": ((2, 4), ("prefill",)),
              "whisper-base": ((2, 4), ("prefill", "decode"))}


@pytest.mark.parametrize("arch", sorted(SITE_CASES))
def test_constrain_call_sites_match_jax(arch):
    """A prefill and a decode step constrain the same (shape, spec) pairs
    in both packages (xlstm: prefill only; the port's decode shares the
    forward's projections and names them too)."""
    mesh_shape, steps = SITE_CASES[arch]
    for step in steps:
        want, got = constrain_sites_both(arch, mesh_shape, step)
        assert want, (arch, step)
        assert got == want, (arch, step, got ^ want)


# ------------------------------------------------------------------ (c)

GRIDS = {"repeated": False, "distinct": True}


def grid_of(mesh, make):
    return {c: make(c).to(coll.device_of(mesh, c)) for c in coll.coords(mesh)}


@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_collectives_match_whole_tensor_formulas(kind):
    """On a (2, 4) grid: ``psum`` / ``pmax`` / ``pmean`` over ``model``,
    ``data`` and both equal the reductions of the stacked blocks;
    ``all_gather`` their concatenation; ``all_to_all`` the transpose of
    the (sender, receiver) block matrix; each result on its coordinate's
    device and, on distinct devices, a copy."""
    mesh = cpu_mesh((2, 4), distinct=GRIDS[kind])
    gen = torch.Generator().manual_seed(3)
    base = torch.randn((2, 4, 4, 3, 5), generator=gen)   # [d, m, peer, ...]
    blocks = grid_of(mesh, lambda c: base[c].clone())
    whole = base
    for axes, dims in ((("model",), (1,)), (("data",), (0,)),
                       (("data", "model"), (0, 1))):
        name = axes[0] if len(axes) == 1 else axes
        s = coll.psum(mesh, blocks, name)
        mx = coll.pmax(mesh, blocks, name)
        mean = coll.pmean(mesh, blocks, name)
        for c in coll.coords(mesh):
            idx = tuple(slice(None) if i in dims else c[i] for i in range(2))
            group = whole[idx].reshape(-1, *whole.shape[2:])
            assert torch.allclose(s[c], group.sum(0), rtol=0, atol=1e-6)
            assert torch.equal(mx[c], group.amax(0))
            assert torch.allclose(mean[c], group.mean(0), rtol=0, atol=1e-6)
    gathered = coll.all_gather(mesh, blocks, "model", dim=1)
    exchanged = coll.all_to_all(mesh, blocks, "model")
    for c in coll.coords(mesh):
        d, m = c
        assert torch.equal(gathered[c], torch.cat(list(whole[d]), dim=1))
        # receiver m's slot j holds sender j's slot m
        assert torch.equal(exchanged[c], whole[d, :, m])
        for out in (gathered[c], exchanged[c]):
            assert out.device == torch.device("cpu")
    if GRIDS[kind]:
        moved = coll.psum(mesh, {c: b for c, b in blocks.items()}, "model")
        assert all(moved[c].data_ptr() != blocks[c].data_ptr()
                   for c in blocks)
    with pytest.raises(ValueError, match="split axis of size"):
        coll.all_to_all(mesh, {c: b[:2] for c, b in blocks.items()}, "model")
    assert [coll.index_along(mesh, c, ("data", "model"))
            for c in coll.coords(mesh)] == list(range(8))


def test_run_stage_gives_grids():
    mesh = cpu_mesh((1, 2))
    a, b = coll.run(mesh, lambda c, dev: (torch.tensor(c[1]),
                                           torch.tensor(-c[1])))
    assert {c: int(v) for c, v in a.items()} == {(0, 0): 0, (0, 1): 1}
    assert {c: int(v) for c, v in b.items()} == {(0, 0): 0, (0, 1): -1}
    doubled = coll.run(mesh, lambda c, dev, x: 2 * x, a)
    assert {c: int(v) for c, v in doubled.items()} == {(0, 0): 0, (0, 1): 2}


def test_serve_builders_give_specs_and_meta_cache():
    """The builders' specs are the rule tables' (FSDP by ``needs_fsdp``),
    the cache stand-ins lie on the meta device with ``init_cache``'s
    shapes, and each step enters the mesh only for its call."""
    from repro_torch.train.step import build_serve_decode, build_serve_prefill

    cfg = smoke_config(get_config("qwen3-1.7b"))
    model = build_model(cfg, device="cpu")
    mesh = cpu_mesh((2, 4))
    prefill, p_specs = build_serve_prefill(model, mesh)
    assert p_specs == sharding.param_pspecs(abstract_params(model), mesh)
    decode, p_specs2, c_specs, cache_abs = build_serve_decode(model, mesh, 4, 16)
    assert p_specs2 == p_specs
    assert {k: (tuple(v.shape), v.device.type) for k, v in cache_abs.items()} \
        == {k: (tuple(v.shape), "meta")
            for k, v in model.init_cache(4, 16).items()}
    assert c_specs == sharding.cache_pspecs(cache_abs, mesh)
    seen = []
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((4, 8), dtype=torch.long)
    sites = port_constrain_sites(lambda: seen.append(
        prefill(params, {"tokens": tokens})))
    assert sites and ctx.current_mesh() is None
    assert seen[0].shape == (4, cfg.vocab)
