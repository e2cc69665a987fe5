"""The port's training over a mesh against the JAX package's, on the CPU.

The JAX side (``tests/_torch_train_mesh_cases.py``) runs once per module in
three subprocesses side by side, each with eight forced host devices, over
``(data, model)`` meshes of ``Auto`` axes, and counts how often its
expert-parallel MoE was traced, which proves the reference took it.  The
port runs the same ``init(PRNGKey(0))`` weights (``params_from_jax``) on
the same ``SyntheticLMData`` batches (B 4, S 32) over meshes of eight
distinct logical CPU devices, so its collectives copy between them.

1. Dense (2, 4): three steps of ``build_train_step`` against JAX's; the
   mesh step equals the port's own single-device step bit for bit (a
   dense model has no sharded stages on one process).
2. MoE (2, 4) at microbatch 1 and 2: both packages take the
   expert-parallel route, forward and (under remat) backward.
3. FSDP changes the specs, not the values; ``(p_specs, o_specs)`` equal
   JAX's for all ten configs at full size on (2, 4) and (1, 8).
4. Elastic resume: 3 steps on (2, 4) through ``train``, a checkpoint,
   ``remesh`` onto (1, 8) and (1, 1) bit for bit, and ``train`` on (1, 8)
   to step 6: bit for bit the in-memory run, within ``FP32_TOL`` of JAX's;
   JAX's checkpoint restores through the port's ``remesh``.
5. ``restore(shardings=)`` refuses a spec that cannot lay out its leaf.

Tolerances, as ``tests/test_torch_train_step.py``: ``FP32_TOL`` on the
loss, grad norm and lr, ``FP32_GRAD_TOL`` on ``m`` and ``v``,
``PARAM_TOL`` (0.1 lr a step, absolute) on the parameters.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.train import step as jax_step

import _torch_train_mesh_cases as cases
from _torch_lm import FP32_TOL, assert_close, assert_tree_close, cpu_mesh
from test_torch_parallel_specs import jax_by_port_name, padded, unstacked
from test_torch_train_step import FP32_GRAD_TOL, PARAM_TOL
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe
from repro_torch.models.convert import (
    named_to_numpy, params_from_jax, params_to_numpy,
)
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import NamedSharding, PartitionSpec
from repro_torch.train import checkpoint, elastic, loop, step
from repro_torch.train.loop import to_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("dense", "moe", "elastic")
OPT = adamw.AdamWConfig(**cases.STEP_OPT)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    procs = {g: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_train_mesh_cases.py"),
         str(d / f"{g}.pkl"), g, str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for g in GROUPS}
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
    return {"2x4": cpu_mesh((2, 4), distinct=True),
            "1x8": cpu_mesh((1, 8), distinct=True),
            "1x1": make_local_mesh(devices=["cpu"])}


def port_model(jax_results, arch):
    cfg = smoke_config(get_config(arch))
    return build_model(cfg, device="cpu"), params_from_jax(
        cfg, jax_results["params"][arch], "cpu")


def data_for(model):
    return SyntheticLMData(model.cfg.vocab, cases.BATCH, cases.SEQ, seed=0)


def record(params, state, metrics) -> dict:
    """A copy of one step's results (the step updates the state in place,
    and an unstacked leaf's numpy array shares its tensor's memory)."""
    def copied(tree):
        return jax.tree_util.tree_map(np.array, tree)

    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "m": copied(named_to_numpy(state.m.items())),
            "v": copied(named_to_numpy(state.v.items())),
            "step": int(state.step),
            "params": copied(params_to_numpy(params))}


def port_steps(model, params, mesh, steps, fsdp=None, microbatch=1,
               state=None):
    """``build_train_step`` over ``mesh`` on ``steps``' batches: (params,
    state, [per-step records])."""
    fn, _, _ = step.build_train_step(model, mesh, opt_cfg=OPT, fsdp=fsdp,
                                     microbatch=microbatch)
    state = adamw.init(OPT, params) if state is None else state
    data, out = data_for(model), []
    for i in steps:
        params, state, m = fn(params, state, to_device(data.batch_at(i),
                                                       "cpu"))
        out.append(record(params, state, m))
    return params, state, out


def assert_steps_match(got, want) -> None:
    """Each step's records within the module's tolerances of JAX's."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "lr"):
            assert_close(g["metrics"][k], w["metrics"][k], FP32_TOL)
        assert g["step"] == w["step"] == i + 1
        assert_tree_close(g["m"], w["m"], FP32_GRAD_TOL)
        assert_tree_close(g["v"], w["v"], FP32_GRAD_TOL)
        for a, b in zip(jax.tree_util.tree_leaves(g["params"]),
                        jax.tree_util.tree_leaves(w["params"])):
            assert np.abs(a - np.asarray(b)).max() <= PARAM_TOL * (i + 1)


def assert_records_equal(got, want) -> None:
    """Bit for bit: metrics, m, v and params."""
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(g["metrics"][k], w["metrics"][k]), k
        for k in ("m", "v", "params"):
            for a, b in zip(jax.tree_util.tree_leaves(g[k]),
                            jax.tree_util.tree_leaves(w[k])):
                np.testing.assert_array_equal(a, b)


def counting(monkeypatch):
    """Count calls of the port's ``moe._moe_ffn_shardmap``."""
    calls = []
    real = moe._moe_ffn_shardmap

    def wrapped(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(moe, "_moe_ffn_shardmap", wrapped)
    return calls


# ------------------------------------------------------------ 1. dense

def test_dense_step_matches_jax_and_the_single_device_step(jax_results,
                                                           meshes):
    model, params = port_model(jax_results, cases.DENSE)
    _, _, got = port_steps(model, params, meshes["2x4"], range(cases.STEPS))
    assert jax_results["traced"]["dense"] == 0
    assert_steps_match(got, jax_results["steps"]["dense"])
    _, params = port_model(jax_results, cases.DENSE)
    _, _, alone = port_steps(model, params, None, range(cases.STEPS))
    assert_records_equal(got, alone)


# -------------------------------------------------------------- 2. MoE

@pytest.mark.parametrize("microbatch", [1, 2])
def test_moe_step_matches_jax_on_the_expert_parallel_route(
        jax_results, meshes, monkeypatch, microbatch):
    """Both packages route through the sharded MoE: JAX traced it, and the
    port ran it for every MoE layer in every microbatch, in the forward
    and again in the backward's recomputation (remat full)."""
    case = "moe" if microbatch == 1 else f"moe_micro{microbatch}"
    model, params = port_model(jax_results, cases.MOE)
    calls = counting(monkeypatch)
    _, _, got = port_steps(model, params, meshes["2x4"], range(cases.STEPS),
                           microbatch=microbatch)
    n_moe = model.cfg.n_layers - model.cfg.first_dense_layers
    assert len(calls) == 2 * n_moe * microbatch * cases.STEPS
    assert jax_results["traced"][case] >= 1
    assert_steps_match(got, jax_results["steps"][case])


# ------------------------------------------------------------- 3. FSDP

def test_fsdp_changes_the_specs_not_the_values(jax_results, meshes):
    model, params = port_model(jax_results, cases.DENSE)
    _, _, on = port_steps(model, params, meshes["2x4"], range(cases.STEPS),
                          fsdp=True)
    _, params = port_model(jax_results, cases.DENSE)
    _, _, off = port_steps(model, params, meshes["2x4"], range(cases.STEPS),
                           fsdp=False)
    assert_records_equal(on, off)
    assert_steps_match(on, jax_results["steps"]["dense_fsdp"])


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_train_specs_match_jax(arch, shape):
    """``build_train_step``'s ``(p_specs, o_specs)`` and default optimizer
    config at full size, FSDP off and on (and ``needs_fsdp``'s choice),
    equal JAX's on an ``AbstractMesh``, the stacked axes' entries
    dropped."""
    jmesh = AbstractMesh(shape, ("data", "model"))
    mesh = cpu_mesh(shape)
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch), device="cpu")
    for fsdp in (False, True, None):
        _, (jp, jo), jopt = jax_step.build_train_step(jmodel, jmesh,
                                                      fsdp=fsdp)
        _, (p_specs, o_specs), opt = step.build_train_step(model, mesh,
                                                           fsdp=fsdp)
        assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
        assert tuple(o_specs.step) == tuple(jo.step) == ()
        abstract = dict(step.abstract_params(model).named_parameters())
        names = list(abstract)
        assert list(p_specs) == list(o_specs.m) == list(o_specs.v) == names
        for got, want in ((p_specs, jp), (o_specs.m, jo.m),
                          (o_specs.v, jo.v)):
            want = jax_by_port_name(want, names)
            for name, p in abstract.items():
                assert padded(got[name], p.ndim) == padded(
                    unstacked(want[name], name), p.ndim), (fsdp, name)


# ----------------------------------------------------------- 4. elastic

def losses_of(history):
    return [h["loss"] for h in history]


def assert_state_equal(got, params, opt_state) -> None:
    """A restored {"params", "opt"} equal to ``params`` / ``opt_state``
    bit for bit."""
    for (n, a), (_, b) in zip(got["params"].named_parameters(),
                              params.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(got["opt"].step, opt_state.step)
    for field in ("m", "v"):
        for n, a in getattr(got["opt"], field).items():
            assert torch.equal(a, getattr(opt_state, field)[n]), (field, n)


def test_elastic_resume_is_exact_and_matches_jax(jax_results, meshes,
                                                 tmp_path, monkeypatch):
    """``train`` on (2, 4) from JAX's weights (a step-0 checkpoint) to step
    3; ``remesh`` onto (1, 8) and (1, 1) restores the saved state bit for
    bit; ``train`` on (1, 8) resumes to step 6.  Its losses equal the
    in-memory run's (3 steps on (2, 4), 3 on (1, 8)) bit for bit and
    JAX's (``remesh`` between the meshes) within ``FP32_TOL``."""
    mid, end = cases.RESUME
    model, params = port_model(jax_results, cases.MOE)
    ckpt_dir = str(tmp_path / "ckpt")
    checkpoint.save(ckpt_dir, 0, {"params": params,
                                  "opt": adamw.init(OPT, params)})
    quiet = dict(opt_cfg=OPT, log_fn=lambda *_: None)
    calls = counting(monkeypatch)

    def run(steps, mesh):
        return loop.train(model, data_for(model), loop.LoopConfig(
            steps=steps, ckpt_dir=ckpt_dir, ckpt_every=10 ** 6,
            log_every=10 ** 6), mesh=mesh, **quiet)

    first = run(mid, meshes["2x4"])
    assert first["final_step"] == mid and len(calls) > 0
    for name in ("1x8", "1x1"):
        got_step, state, mesh = elastic.remesh(model, ckpt_dir,
                                               mesh=meshes[name], opt_cfg=OPT)
        assert got_step == mid and mesh is meshes[name]
        assert_state_equal(state, first["params"], first["opt_state"])
    second = run(end, meshes["1x8"])
    assert [h["step"] for h in second["history"]] == list(range(mid, end))
    resumed = losses_of(first["history"]) + losses_of(second["history"])

    _, params = port_model(jax_results, cases.MOE)
    params, state, a = port_steps(model, params, meshes["2x4"], range(mid))
    _, _, b = port_steps(model, params, meshes["1x8"], range(mid, end),
                         state=state)
    assert resumed == [float(r["metrics"]["loss"]) for r in a + b]
    want = jax_results["elastic"]
    assert jax_results["traced"]["elastic"] >= 2
    assert_close(torch.tensor(resumed), np.concatenate(want["losses"]),
                 FP32_TOL)


def test_jax_checkpoint_restores_through_remesh(jax_results, meshes):
    """``remesh`` of the checkpoint JAX wrote on (1, 8) at step 6 gives
    JAX's arrays exactly, on the port's (1, 8) mesh."""
    want = jax_results["elastic"]
    model = build_model(smoke_config(get_config(cases.MOE)), device="cpu")
    got_step, state, _ = elastic.remesh(model, want["ckpt_dir"],
                                        mesh=meshes["1x8"], opt_cfg=OPT)
    assert got_step == want["step"] == cases.RESUME[1]
    assert int(state["opt"].step) == want["step"]
    for got, ref in ((params_to_numpy(state["params"]), want["params"]),
                     (named_to_numpy(state["opt"].m.items()), want["m"]),
                     (named_to_numpy(state["opt"].v.items()), want["v"])):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------- 5. spec refusals

@pytest.mark.parametrize("spec,match", [
    (PartitionSpec(None, "model"), "splits a dimension"),
    (PartitionSpec("pod"), "lacks"),
    (PartitionSpec("data", "data"), "twice"),
], ids=["not_dividing", "unknown_axis", "axis_twice"])
def test_restore_refuses_a_spec_that_cannot_lay_out_its_leaf(
        tmp_path, spec, match):
    """As ``jax.device_put`` refuses such a ``NamedSharding``: the smoke
    config's ``embed`` (512, 128) on a (2, 3) mesh, whose ``model`` axis
    of 3 divides neither dimension."""
    cfg = smoke_config(get_config(cases.DENSE))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    checkpoint.save(str(tmp_path), 1, {"params": params})
    mesh = cpu_mesh((2, 3))
    like = {"params": step.abstract_params(model)}
    shard = {n: NamedSharding(mesh, PartitionSpec())
             for n, _ in params.named_parameters()}
    _, got, _ = checkpoint.restore(str(tmp_path), like,
                                   shardings={"params": shard})
    assert torch.equal(got["params"].embed, params.embed)
    shard["embed"] = NamedSharding(mesh, spec)
    with pytest.raises(ValueError, match=match):
        checkpoint.restore(str(tmp_path), like, shardings={"params": shard})


def test_restore_refuses_shardings_of_other_trees(tmp_path):
    """Shardings place a module's parameters or an ``AdamWState``; a
    tree of another kind, or shardings not keyed by the leaves' names,
    raise ``ValueError``."""
    checkpoint.save(str(tmp_path), 1, {"extra": {"a": np.zeros(4)}})
    mesh = cpu_mesh((1, 1))
    with pytest.raises(ValueError, match="not a dict"):
        checkpoint.restore(str(tmp_path), {"extra": {"a": np.zeros(4)}},
                           shardings={"extra": {"a": NamedSharding(
                               mesh, PartitionSpec())}})
    cfg = smoke_config(get_config(cases.DENSE))
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="not keyed"):
        checkpoint.restore(str(tmp_path),
                           {"params": step.abstract_params(model)},
                           shardings={"params": {}})


def test_remesh_without_a_gpu_names_the_gpu(tmp_path):
    """``remesh``'s default mesh is every visible CUDA device; with none
    it raises as every mesh over them does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the refusal is for hosts without one")
    model = build_model(smoke_config(get_config(cases.DENSE)), device="cpu")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        elastic.remesh(model, str(tmp_path))


def test_best_mesh_for_factors_as_jax():
    """``model`` is the first of 16, 8, 4, 2, 1 dividing the count, over
    the first ``n`` of the devices given; too few devices raise, and
    without ``devices`` the visible CUDA devices are used (none here)."""
    devs = [torch.device("cpu", i) for i in range(48)]
    for n, shape in ((1, (1, 1)), (6, (3, 2)), (7, (7, 1)), (8, (1, 8)),
                     (12, (3, 4)), (48, (3, 16))):
        mesh = elastic.best_mesh_for(n, devices=devs)
        assert mesh.axis_names == ("data", "model")
        assert mesh.devices.shape == shape
        assert list(mesh.devices.flat) == devs[:n]
    with pytest.raises(ValueError, match="need 9 devices"):
        elastic.best_mesh_for(9, devices=devs[:8])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            elastic.best_mesh_for(1)
