"""The JAX package's dry-run lowering at the smoke configs, for
``tests/test_torch_dryrun.py``.

Run as a script (``main``) in a subprocess with eight forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), it lowers and
compiles each case's step as ``repro.launch.dryrun.run_cell`` does (the
same builders, specs, shardings and donation), but at a smoke config and
shape over a ``(data, model)`` mesh of ``Auto`` axes: the reference's
``make_production_mesh`` gives ``Explicit`` axes, which its own
``parallel/ctx.py::constrain`` refuses under jax 0.9 (ROADMAP queue 3).
It pickles each case's ``memory_analysis``, ``analyze_hlo``'s flops, the
microbatch, and each argument leaf's shape and dtype.

Cases: ``ARCHS`` x ``KINDS`` x ``MESHES``; the processes the test runs
side by side each take one architecture.
"""
import os
import pickle
import sys

ARCHS = ("qwen3-1.7b", "deepseek-moe-16b")
KINDS = ("train", "prefill", "decode")
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}
# smoke shapes: (seq_len, global_batch) a kind
SHAPES = {"train": (32, 8), "prefill": (32, 8), "decode": (32, 8)}
# knobs on both sides: two cross-entropy chunks, as every real shape has
# (train_4k: 16).  With one, XLA inlines the one-trip loop and merges the
# recomputed chunk logits with the forward's, a product the port computes
# (its checkpointed chunk recomputes them, as XLA's loop does at 2+ chunks)
KNOBS = {"xent_chunk": 16}


def smoke_shape(kind: str, shape_cls):
    seq, batch = SHAPES[kind]
    return shape_cls(f"{kind}_smoke", seq, batch, kind)


def _mesh(shape):
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh

    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _leaves(tree) -> list:
    import jax

    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def lower_case(arch: str, kind: str, mesh_name: str) -> dict:
    """``run_cell``'s lowering of one case, compiled."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import tuning
    from repro.configs import ShapeConfig, get_config, smoke_config
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models.model import build_model
    from repro.optim import adamw
    from repro.parallel.sharding import (
        assign_spec, batch_pspecs, dp_axes, shardings_of,
    )
    from repro.train.step import (
        abstract_params, auto_microbatch, build_serve_decode,
        build_serve_prefill, build_train_step,
    )

    cfg = smoke_config(get_config(arch))
    shape = smoke_shape(kind, ShapeConfig)
    mesh = _mesh(MESHES[mesh_name])
    model = build_model(cfg)
    out = {}
    with mesh, tuning.overrides(**KNOBS):
        p_abs = abstract_params(model)
        logits_sh = NamedSharding(mesh, assign_spec(
            (shape.global_batch, cfg.vocab),
            [(dp_axes(mesh), -2), ("model", -1)], mesh))
        if kind == "train":
            micro = auto_microbatch(shape.global_batch, shape.seq_len, mesh)
            out["microbatch"] = micro
            step, (p_specs, o_specs), opt_cfg = build_train_step(
                model, mesh, microbatch=micro)
            batch_abs = model.batch_spec(shape)
            o_abs = jax.eval_shape(lambda p: adamw.init(opt_cfg, p), p_abs)
            in_sh = (shardings_of(p_abs, p_specs, mesh),
                     jax.tree_util.tree_map(
                         lambda _, s: NamedSharding(mesh, s), o_abs, o_specs),
                     shardings_of(batch_abs, batch_pspecs(batch_abs, mesh),
                                  mesh))
            metrics_sh = {k: NamedSharding(mesh, P()) for k in
                          ("grad_norm", "lr", "loss")}
            jitted = jax.jit(step, in_shardings=in_sh,
                             out_shardings=(in_sh[0], in_sh[1], metrics_sh),
                             donate_argnums=(0, 1))
            lowered = jitted.lower(p_abs, o_abs, batch_abs)
            args = {"params": p_abs, "opt": o_abs, "batch": batch_abs}
        elif kind == "prefill":
            fn, p_specs = build_serve_prefill(model, mesh)
            batch_abs = model.batch_spec(shape)
            jitted = jax.jit(fn, in_shardings=(
                shardings_of(p_abs, p_specs, mesh),
                shardings_of(batch_abs, batch_pspecs(batch_abs, mesh), mesh)),
                out_shardings=logits_sh)
            lowered = jitted.lower(p_abs, batch_abs)
            args = {"params": p_abs, "batch": batch_abs}
        else:
            fn, p_specs, c_specs, cache_abs = build_serve_decode(
                model, mesh, shape.global_batch, shape.seq_len)
            batch_abs = model.batch_spec(shape)
            tok_abs, pos_abs = batch_abs["tokens"], batch_abs["pos"]
            tok_spec = batch_pspecs({"tokens": tok_abs}, mesh)["tokens"]
            c_sh = shardings_of(cache_abs, c_specs, mesh)
            jitted = jax.jit(fn, in_shardings=(
                shardings_of(p_abs, p_specs, mesh), c_sh,
                NamedSharding(mesh, tok_spec), NamedSharding(mesh, P())),
                out_shardings=(logits_sh, c_sh), donate_argnums=(1,))
            lowered = jitted.lower(p_abs, cache_abs, tok_abs, pos_abs)
            args = {"params": p_abs, "cache": cache_abs, "batch": batch_abs}
        compiled = lowered.compile()
        mem = compiled.memory_analysis()
        out["memory_analysis"] = {
            "argument_bytes": int(mem.argument_size_in_bytes),
            "output_bytes": int(mem.output_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "alias_bytes": int(mem.alias_size_in_bytes),
        }
        hlo = analyze_hlo(compiled.as_text(), default_group=mesh.devices.size)
        out["flops_per_device"] = hlo["flops_per_device"]
        out["leaves"] = {k: _leaves(v) for k, v in args.items()}
    return out


def run(arch: str) -> dict:
    return {(arch, kind, m): lower_case(arch, kind, m)
            for kind in KINDS for m in MESHES}


def main(argv) -> None:
    out_path, arch = argv
    assert "--xla_force_host_platform_device_count=8" in os.environ.get(
        "XLA_FLAGS", ""), "run with eight forced host devices"
    with open(out_path, "wb") as f:
        pickle.dump(run(arch), f)


if __name__ == "__main__":
    main(sys.argv[1:])
