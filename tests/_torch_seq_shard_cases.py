"""The JAX package's ``seq_shard_mlp`` knob, for ``tests/test_torch_seq_shard.py``.

Run as a script (``main``) in a subprocess with eight forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), it traces the
reference with the knob on over ``(data, model)`` meshes of ``Auto`` axes
and pickles the results as numpy arrays, with the ``init(PRNGKey(0))``
weights it used.  JAX reads the knob and the mesh when it traces, so every
case traces a fresh closure inside ``tuning.overrides``.

Groups, run by the test in four processes side by side (``GROUPS``):
  * ``dense`` and ``moe``: ``build_serve_prefill``'s last-position logits
    of that architecture's smoke config (``ARCHS``) on (1, 4) and (2, 4)
    at B ``BATCH`` x S ``SEQ``; ``dense`` also at S ``ODD_SEQ`` on (1, 4),
    where the sequence does not split over ``model``;
  * ``train1`` and ``train2``: ``TRAIN_STEPS`` steps of the dense train
    step on (2, 4) at microbatch 1 or 2 (``_torch_train_mesh_cases``'
    data, optimizer and jitting).
The weights are ``init`` jitted, which compiles faster than it runs
eagerly; the port takes the same arrays.  Compiling takes most of each
group's time, so the test asks XLA for its cheapest optimisation level
(``XLA_FLAGS``).
"""
import os
import pickle
import sys

import numpy as np

import _torch_train_mesh_cases as mesh_cases

DENSE, MOE = "qwen3-1.7b", "deepseek-moe-16b"
# the MoE smoke config has one dense and one MoE block; the reference
# first constrains the stream after the first MoE block, so a third block
# is what runs on the sharded stream
ARCHS = {DENSE: None, MOE: 3}          # arch -> n_layers (None: the smoke's)
PREFILL_MESHES = ("1x4", "2x4")
BATCH, SEQ = 4, 32
ODD_SEQ = 30                           # 30 % 4 != 0: `model` is dropped
TRAIN_MESH = "2x4"
TRAIN_MICRO = (1, 2)
TRAIN_STEPS = 2
GROUPS = {"dense": DENSE, "moe": MOE,
          **{f"train{m}": DENSE for m in TRAIN_MICRO}}
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")


def config(arch, smoke_config, get_config):
    """``arch``'s smoke config, cut to ``ARCHS[arch]`` layers."""
    import dataclasses

    cfg = smoke_config(get_config(arch))
    if ARCHS[arch] is not None:
        cfg = dataclasses.replace(cfg, n_layers=ARCHS[arch])
    return cfg


def tokens(vocab: int, seq: int) -> np.ndarray:
    return np.random.default_rng(seq).integers(
        0, vocab, (BATCH, seq)).astype(np.int32)


def run_jax(group: str) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import tuning
    from repro.configs import get_config, smoke_config
    from repro.data.pipeline import SyntheticLMData
    from repro.models.model import build_model
    from repro.optim import adamw
    from repro.train.step import build_serve_prefill, build_train_step

    assert len(jax.devices()) >= 8, jax.devices()
    meshes = {name: jax.sharding.Mesh(
        np.array(jax.devices()[:4 * rows]).reshape(rows, 4),
        ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for name, rows in (("1x4", 1), ("2x4", 2))}
    arch = GROUPS[group]
    model = build_model(config(arch, smoke_config, get_config))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    out = {"params": {arch: jax.tree_util.tree_map(np.asarray, params)},
           "prefill": {}, "steps": {}}
    with tuning.overrides(seq_shard_mlp=True):
        if not group.startswith("train"):
            cases = [(m, SEQ) for m in PREFILL_MESHES]
            if arch == DENSE:
                cases.append(("1x4", ODD_SEQ))
            for mname, seq in cases:
                fn, _ = build_serve_prefill(model, meshes[mname])
                batch = {"tokens": jnp.asarray(tokens(model.cfg.vocab, seq))}
                out["prefill"][arch, mname, seq] = np.asarray(
                    jax.jit(fn)(params, batch))
            return out
        opt = adamw.AdamWConfig(**mesh_cases.STEP_OPT)
        mesh = meshes[TRAIN_MESH]
        data = SyntheticLMData(model.cfg.vocab, mesh_cases.BATCH,
                               mesh_cases.SEQ, seed=0)
        micro = int(group[len("train"):])
        fn, specs, _ = build_train_step(model, mesh, opt_cfg=opt,
                                        microbatch=micro)
        out["steps"][micro] = mesh_cases._steps(
            fn, specs, mesh, params, adamw.init(opt, params), data,
            range(TRAIN_STEPS))[2]
    return out


def main(argv) -> int:
    result = run_jax(argv[1])
    with open(argv[0], "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
