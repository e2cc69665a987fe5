"""The JAX package's training over a mesh, for ``tests/test_torch_train_mesh.py``.

Run as a script (``main``) in a subprocess with eight forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), it drives the
reference's ``train/step.py::build_train_step``, ``train/checkpoint.py``
and ``train/elastic.py::remesh`` over ``(data, model)`` meshes of ``Auto``
axes, (2, 4) and (1, 8), and pickles the results as numpy arrays, with the
initial weights it used and how many times ``moe._moe_ffn_shardmap`` was
traced (which proves the MoE took the expert-parallel route).

Groups, run by the test in three processes side by side:
  * ``dense`` and ``moe``: ``STEPS`` steps of ``build_train_step`` on (2, 4)
    from ``init(PRNGKey(0))`` on ``SyntheticLMData`` batches: the dense
    smoke config at microbatch 1, with FSDP off and on, and the MoE smoke
    config at microbatch 1 and 2; each step's metrics, ``m``, ``v`` and
    params.
  * ``elastic``: the MoE smoke config on (2, 4) to step ``RESUME[0]``, a
    checkpoint, ``remesh`` onto (1, 8), and on to ``RESUME[1]``, a
    checkpoint: the losses, the final state and the checkpoint directory.

Each step is jitted once, onto the shardings of the specs that
``build_train_step`` returns (as its docstring intends): JAX reads the mesh
when it traces, so each case traces a fresh closure.
"""
import os
import pickle
import shutil
import sys

import numpy as np

MESHES = {"2x4": (2, 4), "1x8": (1, 8)}
DENSE, MOE = "qwen3-1.7b", "deepseek-moe-16b"
BATCH, SEQ = 4, 32
STEPS = 3
RESUME = (3, 6)
STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

# name -> (arch, mesh, microbatch, fsdp)
STEP_CASES = {"dense": (DENSE, "2x4", 1, False),
              "dense_fsdp": (DENSE, "2x4", 1, True),
              "moe": (MOE, "2x4", 1, False),
              "moe_micro2": (MOE, "2x4", 2, False)}
# the groups the test runs in processes side by side -> their architecture
GROUPS = {"dense": DENSE, "moe": MOE, "elastic": MOE}


def jax_meshes():
    import jax
    from jax.sharding import AxisType, Mesh

    assert len(jax.devices()) >= 8, jax.devices()
    return {name: Mesh(np.array(jax.devices()[:shape[0] * shape[1]])
                       .reshape(shape), ("data", "model"),
                       axis_types=(AxisType.Auto,) * 2)
            for name, shape in MESHES.items()}


def _shardings(mesh, specs):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, PartitionSpec))


def _steps(fn, specs, mesh, p, state, data, steps):
    """``fn`` jitted onto its own specs over ``mesh`` (one compile), run on
    ``data``'s batches ``steps``: (params, state, [per-step records])."""
    import jax

    from repro.parallel.sharding import batch_pspecs

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    shard = _shardings(mesh, specs)
    b_shard = _shardings(mesh, batch_pspecs(data.batch_at(0), mesh))
    records = []
    with mesh:
        step = jax.jit(fn, in_shardings=(*shard, b_shard),
                       out_shardings=(*shard, None))
        for i in steps:
            p, state, m = step(p, state, data.batch_at(i))
            records.append({"metrics": host(m), "m": host(state.m),
                            "v": host(state.v), "step": int(state.step),
                            "params": host(p)})
    return p, state, records


def run_jax(group: str, out_dir: str) -> dict:
    """``group`` "dense" or "moe" (that architecture's step cases), or
    "elastic"."""
    import jax

    from repro.configs import get_config, smoke_config
    from repro.data.pipeline import SyntheticLMData
    from repro.models import moe
    from repro.models.model import build_model
    from repro.optim import adamw
    from repro.train import checkpoint, elastic
    from repro.train.step import build_train_step

    counts = {"n": 0}
    real = moe._moe_ffn_shardmap

    def counted(*args, **kw):
        counts["n"] += 1
        return real(*args, **kw)
    moe._moe_ffn_shardmap = counted

    meshes = jax_meshes()
    arch = GROUPS[group]
    models = {arch: build_model(smoke_config(get_config(arch)))}
    params = {a: m.init(jax.random.PRNGKey(0)) for a, m in models.items()}
    opt = adamw.AdamWConfig(**STEP_OPT)
    out = {"params": {a: jax.tree_util.tree_map(np.asarray, p)
                      for a, p in params.items()},
           "steps": {}, "traced": {}}

    if group != "elastic":
        for case, (arch, mname, micro, fsdp) in STEP_CASES.items():
            if arch != GROUPS[group]:
                continue
            model, mesh = models[arch], meshes[mname]
            data = SyntheticLMData(model.cfg.vocab, BATCH, SEQ, seed=0)
            before = counts["n"]
            fn, specs, _ = build_train_step(model, mesh, opt_cfg=opt,
                                            fsdp=fsdp, microbatch=micro)
            out["steps"][case] = _steps(
                fn, specs, mesh, params[arch], adamw.init(opt, params[arch]),
                data, range(STEPS))[2]
            out["traced"][case] = counts["n"] - before
        return out

    # elastic: (2, 4) to RESUME[0], a checkpoint, ``remesh`` onto (1, 8),
    # on to RESUME[1], a checkpoint
    model = models[MOE]
    data = SyntheticLMData(model.cfg.vocab, BATCH, SEQ, seed=0)
    ckpt_dir = os.path.join(out_dir, "jax_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    before = counts["n"]
    p, state = params[MOE], adamw.init(opt, params[MOE])
    losses = []
    for mname, (lo, hi) in zip(("2x4", "1x8"), ((0, RESUME[0]), RESUME)):
        if lo:
            step, restored, mesh = elastic.remesh(
                model, ckpt_dir, mesh=meshes[mname], opt_cfg=opt)
            assert step == lo and mesh is meshes[mname]
            p, state = restored["params"], restored["opt"]
        fn, specs, _ = build_train_step(model, meshes[mname], opt_cfg=opt)
        p, state, records = _steps(fn, specs, meshes[mname], p, state, data,
                                   range(lo, hi))
        losses.append([float(r["metrics"]["loss"]) for r in records])
        checkpoint.save(ckpt_dir, hi, {"params": p, "opt": state})
    out["elastic"] = {"losses": losses, "ckpt_dir": ckpt_dir,
                      **{k: records[-1][k] for k in ("params", "m", "v",
                                                     "step")}}
    out["traced"]["elastic"] = counts["n"] - before
    return out


def main(argv) -> int:
    result = run_jax(argv[1], argv[2])
    with open(argv[0], "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
