"""The port's sharded LM paths against the JAX package's, on the CPU.

The JAX side (``tests/_torch_parallel_cases.py``) runs once per module in
two subprocesses side by side, each with eight forced host devices, over
``(data, model)`` meshes of ``Auto`` axes, (1, 4) and (2, 4), and counts
how often its sharded routes were traced, which proves the reference took
them.  The port runs the same seeded inputs with JAX's ``PRNGKey(0)``
weights (carried across by ``params_from_jax``) over meshes of logical
CPU devices: ``"cpu"`` repeated for (1, 4), eight distinct ``cpu:i`` for
(2, 4), so its collectives copy between them.

(d) The expert-parallel MoE (deepseek's smoke MoE layer): output, aux and
routes, at decode and prefill token counts and where pairs drop.
(e) Flash decode (qwen3's and gemma3's first attention layer): output and
both caches at positions on both sides of each 32-row shard boundary,
with and without a window.
(f) ``build_serve_prefill`` / ``build_serve_decode`` (qwen3 and deepseek,
``flash_decode`` on): prefill logits, ten decode
steps' logits across an 8-row shard boundary, the final cache, and the
builders' specs.
The mesh knobs: each of ``capacity_factor`` and ``flash_decode`` is read
and changes what its reader does, as in JAX.

Tolerance: float32, ``FP32_TOL`` (1e-5 of JAX's largest magnitude);
routes' expert ids and the specs exactly.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro import tuning as jax_tuning
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jax_moe

import _torch_parallel_cases as cases
from _torch_lm import FP32_TOL, assert_close, cpu_mesh
from repro_torch import tuning
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers, moe
from repro_torch.models.convert import _jax_path, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.models.transformer import attn_spec
from repro_torch.parallel import ctx
from repro_torch.train.step import build_serve_decode, build_serve_prefill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_lm")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    procs = {g: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parallel_cases.py"),
         str(d / f"{g}.pkl"), g], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for g in ("layers", "serve")}
    out = {}
    for g, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with open(d / f"{g}.pkl", "rb") as f:
            part = pickle.load(f)
        for k, v in part.items():
            out.setdefault(k, {}).update(v)
    return out


@pytest.fixture(scope="module")
def meshes():
    return {"1x4": make_local_mesh(devices=["cpu"] * 4),
            "2x4": cpu_mesh((2, 4), distinct=True)}


def port_params(jax_results, arch):
    cfg = smoke_config(get_config(arch))
    return cfg, params_from_jax(cfg, jax_results["params"][arch], "cpu")


def counting(monkeypatch, module, name):
    """Count calls of ``module.name`` (the port's sharded routes)."""
    calls = []
    real = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return calls


# ------------------------------------------------------------ (d) the MoE

MOE_IDS = [(c, m) for c, spec in cases.MOE_CASES.items() for m in spec[3]]


def run_moe(jax_results, mesh, case, monkeypatch):
    """The port's MoE layer on ``case``'s input under ``mesh``: (out, aux,
    routes, calls of ``_moe_ffn_shardmap``)."""
    cfg, params = port_params(jax_results, "deepseek-moe-16b")
    b, s, cf, _ = cases.MOE_CASES[case]
    x = torch.from_numpy(cases.moe_input(cfg.d_model, b, s))
    calls = counting(monkeypatch, moe, "_moe_ffn_shardmap")
    routes = []
    with ctx.activation_mesh(mesh), tuning.overrides(capacity_factor=cf):
        out, aux = moe.moe_ffn(params.moe_layers[0].moe, cfg, x, routes)
    return out, aux, routes, len(calls)


@pytest.mark.parametrize("case,mesh_name", MOE_IDS)
def test_moe_matches_jax_shardmap(jax_results, meshes, monkeypatch, case,
                                  mesh_name):
    """Output and aux within ``FP32_TOL`` of JAX's ``_moe_ffn_shardmap``
    (traced, so taken); one route a shard that routes its own tokens, in
    token order: the router's probabilities within ``FP32_TOL`` and the
    top-k ids equal to JAX's; pairs lost only where the capacity is the
    knob's (t_loc * k > 512), and some at ``capacity_factor`` 1.0."""
    want = jax_results["moe"][case, mesh_name]
    out, aux, routes, calls = run_moe(jax_results, meshes[mesh_name], case,
                                      monkeypatch)
    assert calls == 1 and want["traced"] >= 1
    assert_close(out, want["out"], FP32_TOL)
    assert abs(float(aux) - float(want["aux"])) <= FP32_TOL * abs(
        float(want["aux"]))
    probs, topi = jax_results["routes"][case]
    b, s, _, _ = cases.MOE_CASES[case]
    mesh = meshes[mesh_name]
    shards = mesh.shape["data"] * (mesh.shape["model"] if (
        b // mesh.shape["data"] * s) % mesh.shape["model"] == 0 else 1)
    assert len(routes) == shards
    assert_close(torch.cat([r.probs for r in routes]), probs, FP32_TOL)
    got_topi = torch.cat([r.topi for r in routes]).numpy()
    np.testing.assert_array_equal(got_topi, topi)
    applied = torch.cat([r.applied for r in routes]).numpy()
    lost = applied == -1
    np.testing.assert_array_equal(applied[~lost], topi[~lost])
    if case == "drop":
        assert lost.any()
    elif not case.startswith("drop"):
        assert not lost.any(), int(lost.sum())


# ---------------------------------------------------------- (e) flash decode

FLASH_IDS = [(c, m) for c, spec in cases.FLASH_CASES.items() for m in spec[3]]


def run_flash(jax_results, mesh, case, monkeypatch):
    """The port's ``attention_decode`` at every position of
    ``FLASH_POSITIONS``, each from the case's random cache: [(out, k, v)]
    and the calls of ``_attention_decode_flash``."""
    arch, window, flash, _ = cases.FLASH_CASES[case]
    cfg, params = port_params(jax_results, arch)
    x, ck, cv = map(torch.from_numpy, cases.flash_input(cfg, len(case)))
    calls = counting(monkeypatch, layers, "_attention_decode_flash")
    res = []
    with ctx.activation_mesh(mesh), tuning.overrides(flash_decode=flash):
        for pos in cases.FLASH_POSITIONS:
            res.append(layers.attention_decode(
                params.layers[0].attn, attn_spec(cfg), x, ck.clone(),
                cv.clone(), pos, window=window))
    return res, len(calls)


@pytest.mark.parametrize("case,mesh_name", FLASH_IDS)
def test_flash_decode_matches_jax(jax_results, meshes, monkeypatch, case,
                                  mesh_name):
    """Output and both caches within ``FP32_TOL`` of JAX's at positions
    31/32, 63/64 and 127 (shard boundaries at 32, 64 and 96); the flash
    route taken by both packages exactly when the knob is on."""
    want = jax_results["flash"][case, mesh_name]
    got, calls = run_flash(jax_results, meshes[mesh_name], case, monkeypatch)
    flash = cases.FLASH_CASES[case][2]
    assert calls == (len(cases.FLASH_POSITIONS) if flash else 0)
    assert (want["traced"] >= 1) == flash
    for pos, g, w in zip(cases.FLASH_POSITIONS, got, want["steps"]):
        for a, b in zip(g, w):
            assert_close(a, b, FP32_TOL)
        # only row `pos` of the cache changed
        _, ck, _ = map(torch.from_numpy, cases.flash_input(
            smoke_config(get_config(cases.FLASH_CASES[case][0])), len(case)))
        changed = (g[1] != ck).any(dim=(0, 2, 3)).nonzero().flatten()
        assert changed.tolist() == [pos], pos


# --------------------------------------------------------- (f) serve builders

SERVE_IDS = [(a, m) for a in cases.SERVE_ARCHS for m in cases.MESHES]


def jax_spec_of(tree, name):
    leaf = tree
    for k in _jax_path(name)[0]:
        leaf = leaf[k]
    return tuple(leaf)[len(_jax_path(name)[1]):]


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("arch,mesh_name", SERVE_IDS)
def test_serve_builders_match_jax(jax_results, meshes, monkeypatch, arch,
                                  mesh_name):
    """Prefill logits, every decode step's logits and the final cache
    within ``FP32_TOL`` of JAX's builders' (``flash_decode`` on), both
    packages on their sharded routes; the
    parameter and cache specs equal."""
    want = jax_results["serve"][arch, mesh_name]
    mesh = meshes[mesh_name]
    cfg, params = port_params(jax_results, arch)
    model = build_model(cfg, device="cpu")
    tokens = torch.from_numpy(cases.serve_tokens(cfg.vocab).astype(np.int64))
    flash = counting(monkeypatch, layers, "_attention_decode_flash")
    shard = counting(monkeypatch, moe, "_moe_ffn_shardmap")
    with tuning.overrides(flash_decode=True):
        prefill, p_specs = build_serve_prefill(model, mesh)
        assert ctx.current_mesh() is None
        assert_close(prefill(params, {"tokens": tokens}), want["prefill"],
                     FP32_TOL)
        decode, _, c_specs, cache_abs = build_serve_decode(
            model, mesh, cases.SERVE_BATCH, cases.SERVE_MAX_SEQ)
        cache = model.init_cache(cases.SERVE_BATCH, cases.SERVE_MAX_SEQ)
        for pos in range(cases.SERVE_STEPS):
            logits, cache = decode(params, cache, tokens[:, pos:pos + 1], pos)
            assert_close(logits, want["decode"][pos], FP32_TOL)
    for name in want["cache"]:
        assert_close(cache[name], want["cache"][name], FP32_TOL)
    assert c_specs == {k: padded(v, cache_abs[k].ndim)
                       for k, v in want["c_specs"].items()}
    for name, p in params.named_parameters():
        assert padded(p_specs[name], p.ndim) == padded(
            jax_spec_of(want["p_specs"], name), p.ndim), name
    n_layers = cfg.n_layers
    assert len(flash) == n_layers * cases.SERVE_STEPS
    assert want["traced"][1] >= 1
    if cfg.family == "moe":
        assert len(shard) == (n_layers - cfg.first_dense_layers) * (
            1 + cases.SERVE_STEPS)
        assert want["traced"][0] >= 1


# ---------------------------------------------------------------- the knobs

@pytest.mark.parametrize("knob", ["capacity_factor", "flash_decode"])
def test_mesh_knobs_are_read_as_jax(jax_results, meshes, monkeypatch, knob):
    """Each mesh knob has its reader in the port, and setting it changes
    what the reader does, as in JAX:
    ``capacity_factor`` 1.0 against 2.0 on a prefill past the no-drop
    size changes the sharded MoE's capacity (fewer pairs lost at 2.0) and
    output, each equal to JAX's, and without a mesh it changes nothing;
    ``flash_decode`` on a (2, 4) mesh sends ``attention_decode`` down the
    flash route only when on, each result equal to JAX's."""
    if knob == "capacity_factor":
        runs = {}
        for case in ("drop", "drop_cf2"):
            out, _, routes, calls = run_moe(jax_results, meshes["1x4"], case,
                                            monkeypatch)
            assert_close(out, jax_results["moe"][case, "1x4"]["out"],
                         FP32_TOL)
            lost = int(sum((r.applied == -1).sum() for r in routes))
            runs[case] = out, lost
        assert runs["drop"][1] > runs["drop_cf2"][1]
        assert not torch.allclose(runs["drop"][0], runs["drop_cf2"][0])
        # without a mesh neither package reads it: the single-device
        # dispatch keeps the config's factor
        cfg, params = port_params(jax_results, "deepseek-moe-16b")
        jp = jax.tree_util.tree_map(lambda a: a[0], jax_results["params"][
            "deepseek-moe-16b"]["moe_layers"])["moe"]
        x = cases.moe_input(cfg.d_model, 2, 32)
        plain, _ = moe.moe_ffn(params.moe_layers[0].moe, cfg,
                               torch.from_numpy(x))
        with tuning.overrides(capacity_factor=0.5):
            out, _ = moe.moe_ffn(params.moe_layers[0].moe, cfg,
                                 torch.from_numpy(x))
        with jax_tuning.overrides(capacity_factor=0.5):
            jout, _ = jax_moe.moe_ffn(
                jp, jax_smoke_config(jax_get_config("deepseek-moe-16b")),
                jnp.asarray(x))
        assert torch.equal(out, plain)
        assert_close(out, jout, FP32_TOL)
    else:
        calls = {}
        for case in ("qwen3", "qwen3_dense"):
            got, calls[case] = run_flash(jax_results, meshes["2x4"], case,
                                         monkeypatch)
            for g, w in zip(got, jax_results["flash"][case, "2x4"]["steps"]):
                for a, b in zip(g, w):
                    assert_close(a, b, FP32_TOL)
        assert calls == {"qwen3": len(cases.FLASH_POSITIONS),
                         "qwen3_dense": 0}
        assert jax_results["flash"]["qwen3", "2x4"]["traced"] >= 1
        assert jax_results["flash"]["qwen3_dense", "2x4"]["traced"] == 0
