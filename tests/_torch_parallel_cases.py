"""The JAX package's sharded LM paths, for ``tests/test_torch_parallel_lm.py``.

Run as a script (``main``) in a subprocess with eight forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), it drives the
reference's expert-parallel MoE (``moe._moe_ffn_shardmap``), its flash
decode (``layers._attention_decode_flash``) and its serve builders
(``train/step.py::build_serve_prefill`` / ``build_serve_decode``) over
``(data, model)`` meshes of ``Auto`` axes, (1, 4) and (2, 4), and pickles
the results as numpy arrays, with the weights it used and how many times
each sharded route was traced.

JAX reads the mesh and the knobs when it traces, so every case traces a
fresh closure inside ``activation_mesh`` and ``tuning.overrides``.  The
inputs are seeded numpy data (``moe_input``, ``flash_input``,
``serve_tokens``), made the same way by the test for the port.
"""
import os
import pickle
import sys

import numpy as np

MESHES = {"1x4": (1, 4), "2x4": (2, 4)}
ARCHS = ("qwen3-1.7b", "gemma3-12b", "deepseek-moe-16b")

# MoE: name -> (B, S, capacity_factor knob, meshes); the smoke config's E
# 8, k 2.  decode8 slices its tokens over `model`, decode2 does not on
# (2, 4); drop and drop_cf2 have t_loc * k > 512, so the knob sets the
# capacity and pairs drop.
MOE_CASES = {"decode8": (8, 1, 0.0, ("1x4", "2x4")),
             "decode2": (2, 1, 0.0, ("2x4",)),
             "prefill": (4, 64, 0.0, ("1x4", "2x4")),
             "drop": (4, 1024, 1.0, ("1x4", "2x4")),
             "drop_cf2": (4, 1024, 2.0, ("1x4",))}

# flash decode: name -> (arch, window passed to attention_decode, knob on,
# meshes)
FLASH_CASES = {"qwen3": ("qwen3-1.7b", None, True, ("1x4", "2x4")),
               "qwen3_window": ("qwen3-1.7b", 48, True, ("1x4", "2x4")),
               "gemma3": ("gemma3-12b", 64, True, ("1x4", "2x4")),
               "qwen3_dense": ("qwen3-1.7b", None, False, ("2x4",))}
FLASH_BATCH = 4
FLASH_DEPTH = 128              # 32 rows a shard on a model axis of 4
FLASH_POSITIONS = (31, 32, 63, 64, 127)

SERVE_ARCHS = ("qwen3-1.7b", "deepseek-moe-16b")
SERVE_BATCH = 4
SERVE_PROMPT = 32
SERVE_MAX_SEQ = 32             # 8 rows a shard
SERVE_STEPS = 10               # decode positions 0-9, across a boundary


def moe_input(d: int, b: int, s: int) -> np.ndarray:
    return np.random.default_rng(b * 7919 + s).standard_normal(
        (b, s, d)).astype(np.float32)


def flash_input(cfg, seed: int):
    """x (B, 1, d) and a random cache (B, depth, Kv, D) for K and V."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((FLASH_BATCH, 1, cfg.d_model)).astype(np.float32)
    shape = (FLASH_BATCH, FLASH_DEPTH, cfg.n_kv_heads, cfg.hd)
    return (x, rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def serve_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(21).integers(
        0, vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)


def _counted(module, name: str, counts: dict) -> None:
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kw)
    setattr(module, name, wrapped)


def run_jax(group: str) -> dict:
    """``group`` "layers" (the MoE and flash-decode cases) or "serve" (the
    serve builders); the test runs the two in processes side by side."""
    import jax
    from jax.sharding import AxisType, Mesh

    from repro.configs import get_config, smoke_config
    from repro.models import layers, moe
    from repro.models.model import build_model

    assert len(jax.devices()) >= 8, jax.devices()
    counts: dict = {}
    _counted(moe, "_moe_ffn_shardmap", counts)
    _counted(layers, "_attention_decode_flash", counts)
    meshes = {name: Mesh(np.array(jax.devices()[:shape[0] * shape[1]])
                         .reshape(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
              for name, shape in MESHES.items()}
    archs = SERVE_ARCHS if group == "serve" else ARCHS
    cfgs = {a: smoke_config(get_config(a)) for a in archs}
    models = {a: build_model(c) for a, c in cfgs.items()}
    params = {a: m.init(jax.random.PRNGKey(0)) for a, m in models.items()}
    out = {"params": {a: jax.tree_util.tree_map(np.asarray, p)
                      for a, p in params.items()},
           "moe": {}, "flash": {}, "serve": {}, "routes": {}}

    def traced(name):
        return counts.get(name, 0)

    if group == "serve":
        _serve(out, models, params, cfgs, meshes, traced)
    else:
        _layers(out, params, cfgs, meshes, traced)
    return out


def _layers(out, params, cfgs, meshes, traced) -> None:
    import jax
    import jax.numpy as jnp

    from repro import tuning
    from repro.models import layers, moe
    from repro.models.transformer import attn_spec
    from repro.parallel import ctx

    # ---- expert-parallel MoE, the first MoE layer
    cfg = cfgs["deepseek-moe-16b"]
    p_moe = jax.tree_util.tree_map(lambda a: a[0],
                                   params["deepseek-moe-16b"]["moe_layers"])["moe"]
    for case, (b, s, cf, mesh_names) in MOE_CASES.items():
        x = jnp.asarray(moe_input(cfg.d_model, b, s))
        probs = jax.nn.softmax(
            x.reshape(b * s, -1).astype(jnp.float32) @ p_moe["router"], axis=-1)
        out["routes"][case] = (np.asarray(probs), np.asarray(
            jax.lax.top_k(probs, cfg.experts_per_token)[1]))
        for mname in mesh_names:
            mesh = meshes[mname]
            before = traced("_moe_ffn_shardmap")

            def fn(p, x, mesh=mesh):
                with ctx.activation_mesh(mesh):
                    return moe.moe_ffn(p, cfg, x)
            with tuning.overrides(capacity_factor=cf):
                o, aux = jax.jit(fn)(p_moe, x)
            out["moe"][case, mname] = {
                "out": np.asarray(o), "aux": np.asarray(aux),
                "traced": traced("_moe_ffn_shardmap") - before}

    # ---- flash decode, the first layer's attention
    for case, (arch, window, flash, mesh_names) in FLASH_CASES.items():
        cfg = cfgs[arch]
        spec = attn_spec(cfg)
        p_attn = jax.tree_util.tree_map(lambda a: a[0],
                                        params[arch]["layers"])["attn"]
        x, ck, cv = map(jnp.asarray, flash_input(cfg, len(case)))
        for mname in mesh_names:
            mesh = meshes[mname]
            before = traced("_attention_decode_flash")

            def fn(p, x, ck, cv, pos, mesh=mesh, window=window):
                with ctx.activation_mesh(mesh):
                    return layers.attention_decode(p, spec, x, ck, cv, pos,
                                                   window=window)
            res = []
            with tuning.overrides(flash_decode=flash):
                step = jax.jit(fn)
                for pos in FLASH_POSITIONS:
                    res.append(tuple(np.asarray(a) for a in step(
                        p_attn, x, ck, cv, jnp.int32(pos))))
            out["flash"][case, mname] = {
                "steps": res,
                "traced": traced("_attention_decode_flash") - before}


def _serve(out, models, params, cfgs, meshes, traced) -> None:
    """The serve builders, flash_decode on."""
    import jax
    import jax.numpy as jnp

    from repro import tuning
    from repro.train.step import build_serve_decode, build_serve_prefill

    for arch in SERVE_ARCHS:
        model, p = models[arch], params[arch]
        tokens = jnp.asarray(serve_tokens(cfgs[arch].vocab))
        for mname, mesh in meshes.items():
            before = (traced("_moe_ffn_shardmap"),
                      traced("_attention_decode_flash"))
            with tuning.overrides(flash_decode=True):
                prefill, p_specs = build_serve_prefill(model, mesh)
                logits = np.asarray(jax.jit(prefill)(p, {"tokens": tokens}))
                decode, _, c_specs, _ = build_serve_decode(
                    model, mesh, SERVE_BATCH, SERVE_MAX_SEQ)
                step = jax.jit(decode)
                cache = model.init_cache(SERVE_BATCH, SERVE_MAX_SEQ)
                steps = []
                for pos in range(SERVE_STEPS):
                    lg, cache = step(p, cache, tokens[:, pos:pos + 1],
                                     jnp.int32(pos))
                    steps.append(np.asarray(lg))
            out["serve"][arch, mname] = {
                "prefill": logits, "decode": steps,
                "cache": {k: np.asarray(v) for k, v in cache.items()},
                "p_specs": jax.tree_util.tree_map(
                    tuple, p_specs,
                    is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)),
                "c_specs": {k: tuple(v) for k, v in c_specs.items()},
                "traced": (traced("_moe_ffn_shardmap") - before[0],
                           traced("_attention_decode_flash") - before[1])}


def main(argv) -> int:
    result = run_jax(argv[1])
    with open(argv[0], "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
