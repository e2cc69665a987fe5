"""The port's ``seq_shard_mlp`` knob against the JAX package's, on the CPU.

With the knob on and a mesh active, the port keeps the residual stream
between layers as a grid of (B/dp, S/M, d) sequence blocks, one a mesh
coordinate on its device, and runs each layer tensor parallel over
``model`` as stages between an all-gather and a reduce-scatter
(``models/transformer.py``), where JAX constrains the stream to ``(DP,
"model", None)`` and leaves the rest to GSPMD.

The JAX side (``tests/_torch_seq_shard_cases.py``) runs once per module in
four subprocesses with eight forced host devices, started before the
first test so that they run beside the port-only checks.  The port runs
JAX's ``init(PRNGKey(0))`` weights (``params_from_jax``) over meshes of
logical CPU devices: ``"cpu"`` repeated for (1, 4), eight distinct
``cpu:i`` for (2, 4), so its collectives copy between them.

Port only:
(c) between layers the stream is a grid of (B/dp, S/M, d) blocks, each on
    its coordinate's device (dense and MoE);
(d) one dense layer's forward logs 2 all-gathers and 2 reduce-scatters
    over ``model``, and equals the layer on the whole stream;
(f) ``collectives.psum_scatter`` is a sum and a slice, its backward an
    all-gather of the cotangent, and both are named in the op log;
    ``ctx.shard`` and ``ctx.unshard`` are inverse;
(g) the families that do not read the knob (zamba2, xlstm, whisper) and
    the decode step give the same values with it on.
Against JAX, knob on in both:
(a) ``build_serve_prefill``'s logits of qwen3 and deepseek (the smoke
    config with a third block: the reference first constrains the stream
    after the first MoE block, so the third is the one that runs on the
    grid) on (1, 4) and (2, 4);
(b) the dense train step on (2, 4) at microbatch 1 and 2: loss, gradient
    norm, AdamW state and updated parameters (``test_torch_train_mesh``'s
    tolerances);
(e) at S % M != 0 the stream stays whole, no collective is logged, and
    the logits still equal JAX's.

Tolerance: float32, ``FP32_TOL`` (1e-5 of JAX's largest magnitude).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_seq_shard_cases as cases
from _torch_lm import FP32_TOL, assert_close, cpu_mesh
from test_torch_train_mesh import assert_steps_match, port_steps
from repro_torch import tuning
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.op_analysis import record
from repro_torch.models import moe, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx
from repro_torch.train.step import build_serve_prefill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_procs(tmp_path_factory):
    """The JAX groups' processes, started with the module's first test."""
    d = tmp_path_factory.mktemp("seq_shard")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=cases.XLA_FLAGS,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    procs = {g: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_seq_shard_cases.py"),
         str(d / f"{g}.pkl"), g], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for g in cases.GROUPS}
    yield d, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def jax_results(jax_procs):
    d, procs = jax_procs
    out = {}
    for g, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with open(d / f"{g}.pkl", "rb") as f:
            for k, v in pickle.load(f).items():
                out.setdefault(k, {}).update(v)
    return out


@pytest.fixture(scope="module")
def meshes():
    return {"1x4": make_local_mesh(devices=["cpu"] * 4),
            "2x4": cpu_mesh((2, 4), distinct=True)}


def port_model(arch, jax_results=None):
    """The case's config and model, with JAX's weights or the port's own
    seeded ones."""
    cfg = cases.config(arch, smoke_config, get_config)
    model = build_model(cfg, device="cpu")
    if jax_results is None:
        return model, model.init(torch.Generator().manual_seed(0))
    return model, params_from_jax(cfg, jax_results["params"][arch], "cpu")


def batch_of(model, seq=cases.SEQ):
    return {"tokens": torch.from_numpy(
        cases.tokens(model.cfg.vocab, seq).astype(np.int64))}


def recorded_grids(monkeypatch, module, name):
    """Each call of ``module.name`` (a staged layer): its input grid."""
    calls = []
    real = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(args[2])
        return real(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def on(block: torch.Tensor, device) -> bool:
    """``block`` lies on ``device`` (as torch names it: a CPU tensor's
    device carries no index)."""
    return block.device == torch.empty(0, device=device).device


def collectives(log):
    return [(e.name, e.results[0][0], e.group) for e in log.ops
            if e.kind == "collective"]


# ------------------------------------------------------- (f) collectives

GRID_AXES = {"model": "model", "data": "data", "both": ("data", "model")}


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("axes", sorted(GRID_AXES))
def test_psum_scatter_is_a_sum_and_a_slice(axes, dim):
    """On a (2, 4) grid of one repeated CPU device: peer i's block is the
    i-th slice along ``dim`` of its group's sum, added in peer order; the
    gradient of each block is the all-gather of its group's cotangents."""
    mesh = cpu_mesh((2, 4))
    axes = GRID_AXES[axes]
    gen = torch.Generator().manual_seed(1)
    grid = {c: torch.randn(8, 16, generator=gen, requires_grad=True)
            for c in coll.coords(mesh)}
    out = coll.psum_scatter(mesh, grid, axes, dim)
    group = len(coll._peers(mesh, (0, 0), axes))
    for c in coll.coords(mesh):
        peers = coll._peers(mesh, c, axes)
        want = grid[peers[0]]
        for p in peers[1:]:
            want = want + grid[p]
        step = 16 // group if dim else 8 // group
        i = coll.index_along(mesh, c, axes)
        assert torch.equal(out[c], want.narrow(dim, i * step, step))
    ct = {c: torch.randn(out[c].shape, generator=gen) for c in out}
    grads = torch.autograd.grad([out[c] for c in out], [grid[c] for c in out],
                                [ct[c] for c in out])
    gathered = coll.all_gather(mesh, ct, axes, dim)
    for c, g in zip(out, grads):
        assert torch.equal(g, gathered[c])
    with pytest.raises(ValueError, match="psum_scatter over 8 peers"):
        coll.psum_scatter(mesh, {c: torch.ones(4, 4) for c in grid},
                          ("data", "model"), 0)


def test_a_reduce_scatter_and_its_backward_in_the_op_log():
    """A reduce-scatter whose result takes a gradient is one
    ``reduce-scatter`` entry (the result block, the group), and its
    backward one ``all-gather`` entry of the source block's shape."""
    mesh = cpu_mesh((1, 4))
    grid = {c: torch.ones(8, 16, requires_grad=True)
            for c in coll.coords(mesh)}
    with record() as log:
        out = coll.psum_scatter(mesh, grid, "model", dim=1)
        sum(x.sum() for x in out.values()).backward()
    assert collectives(log) == [("reduce-scatter", (8, 4), 4),
                                ("all-gather", (8, 16), 4)]
    assert all(torch.equal(g.grad, torch.ones(8, 16)) for g in grid.values())


SHARD_SPECS = {"dp_model": (ctx.DP, "model", None),
               "joint": (None, ("data", "model"), None),
               "model_data": ("model", None, "data")}


@pytest.mark.parametrize("spec", sorted(SHARD_SPECS))
def test_shard_and_unshard_are_inverse(meshes, spec):
    """``ctx.shard`` cuts a tensor into its resolved spec's blocks, each on
    its coordinate's device (a dimension split over two axes in row-major
    peer order); ``ctx.unshard`` joins them back bit for bit."""
    mesh = meshes["2x4"]
    x = torch.randn(8, 16, 6, generator=torch.Generator().manual_seed(2))
    with ctx.activation_mesh(mesh):
        resolved = ctx.resolve(x.shape, SHARD_SPECS[spec], mesh)
        grid = ctx.shard(x, resolved)
        for c, block in grid.items():
            assert on(block, coll.device_of(mesh, c))
            want = x
            for d, axes in enumerate(resolved):
                if axes is not None:
                    n = x.shape[d] // (8 if isinstance(axes, tuple)
                                       else mesh.shape[axes])
                    i = coll.index_along(mesh, c, axes)
                    want = want.narrow(d, i * n, n)
            assert torch.equal(block, want)
        assert torch.equal(ctx.unshard(grid, resolved), x)


# ------------------------------------------------------------ (c), (d)

@pytest.mark.parametrize("mesh_name", ["1x4", "2x4"])
@pytest.mark.parametrize("arch", sorted(cases.ARCHS))
def test_stream_between_layers_is_a_grid_of_sequence_blocks(
        meshes, monkeypatch, arch, mesh_name):
    """Every staged layer's input is a grid of (B/dp, S/M, d) blocks, one a
    coordinate on its device: each dense layer's, and each MoE block's
    after the first MoE block, where the reference first constrains."""
    mesh = meshes[mesh_name]
    model, params = port_model(arch)
    dense = recorded_grids(monkeypatch, transformer, "_layer_stages")
    staged_moe = recorded_grids(monkeypatch, moe, "_moe_block_stages")
    with tuning.overrides(seq_shard_mlp=True):
        build_serve_prefill(model, mesh)[0](params, batch_of(model))
    cfg = model.cfg
    want_calls = {"dense": cfg.n_layers, "moe": 0} if cfg.family == "dense" \
        else {"dense": 0, "moe": cfg.n_layers - cfg.first_dense_layers - 1}
    assert (len(dense), len(staged_moe)) == (want_calls["dense"],
                                             want_calls["moe"])
    dp, m = mesh.devices.shape
    for grid in dense + staged_moe:
        assert sorted(grid) == coll.coords(mesh)
        for c, block in grid.items():
            assert tuple(block.shape) == (cases.BATCH // dp, cases.SEQ // m,
                                          cfg.d_model)
            assert on(block, coll.device_of(mesh, c))


@pytest.mark.parametrize("mesh_name", ["1x4", "2x4"])
def test_one_dense_layer_logs_two_all_gathers_and_two_reduce_scatters(
        meshes, mesh_name):
    """One layer's forward on the grid: an all-gather of (B/dp, S, d)
    blocks and a reduce-scatter back to (B/dp, S/M, d) for each half,
    over the ``model`` axis's M peers, and nothing else; the joined result
    equals the layer on the whole stream."""
    mesh = meshes[mesh_name]
    model, params = port_model(cases.DENSE)
    cfg = model.cfg
    b, s = cases.BATCH, cases.SEQ
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(3))
    positions = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    layer = params.layers[0]
    dp, m = mesh.devices.shape
    with ctx.activation_mesh(mesh), tuning.overrides(seq_shard_mlp=True):
        spec = transformer.seq_spec(x.shape)
        grid = ctx.shard(x, spec)
        with record() as log:
            out = transformer._layer_stages(cfg, mesh, grid, layer, 0,
                                            positions)
        got = ctx.unshard(out, spec)
    whole, part = (b // dp, s, cfg.d_model), (b // dp, s // m, cfg.d_model)
    assert collectives(log) == [("all-gather", whole, m),
                                ("reduce-scatter", part, m)] * 2
    want = transformer._layer_fwd(cfg, x, layer, 0, positions)
    assert float((got - want).abs().max()) <= FP32_TOL * float(
        want.abs().max())


# ------------------------------------------------------------------- (g)

@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-350m",
                                  "zamba2-2.7b"])
def test_families_without_a_reader_are_unchanged(meshes, arch):
    """The ssm_hybrid, xlstm and encdec families do not read the knob, in
    JAX or in the port: their prefill on (1, 4) is the same with it on,
    and runs no sequence-parallel collective."""
    from _torch_lm import batches

    cfg = smoke_config(get_config(arch))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = batches(cfg, 4, 32)[1]
    fn = build_serve_prefill(model, meshes["1x4"])[0]
    off = fn(params, batch)
    with tuning.overrides(seq_shard_mlp=True), record() as log:
        on = fn(params, batch)
    assert torch.equal(on, off)
    assert not {"all-gather", "reduce-scatter"} & set(log.counts("collective"))


def test_decode_does_not_read_the_knob(meshes):
    """Decode steps do not read the knob: the dense decode step on (1, 4)
    is the same with it on."""
    from repro_torch.train.step import build_serve_decode

    model, params = port_model(cases.DENSE)
    tok = batch_of(model)["tokens"][:, :1]
    decode = build_serve_decode(model, meshes["1x4"], cases.BATCH, 8)[0]
    off, _ = decode(params, model.init_cache(cases.BATCH, 8), tok, 3)
    with tuning.overrides(seq_shard_mlp=True), record() as log:
        on, _ = decode(params, model.init_cache(cases.BATCH, 8), tok, 3)
    assert torch.equal(on, off)
    assert not log.counts("collective")


# ------------------------------------------------------ against JAX: (a)

@pytest.mark.parametrize("mesh_name", cases.PREFILL_MESHES)
@pytest.mark.parametrize("arch", sorted(cases.ARCHS))
def test_prefill_matches_jax(jax_results, meshes, monkeypatch, arch,
                             mesh_name):
    model, params = port_model(arch, jax_results)
    staged = recorded_grids(
        monkeypatch, *((transformer, "_layer_stages") if arch == cases.DENSE
                       else (moe, "_moe_block_stages")))
    with tuning.overrides(seq_shard_mlp=True):
        got = build_serve_prefill(model, meshes[mesh_name])[0](
            params, batch_of(model))
    assert staged, "the sequence-parallel route was not taken"
    assert_close(got, jax_results["prefill"][arch, mesh_name, cases.SEQ],
                 FP32_TOL)


# ------------------------------------------------------------------- (e)

def test_indivisible_sequence_keeps_the_stream_whole(jax_results, meshes,
                                                     monkeypatch):
    """S 30 on a ``model`` axis of 4: ``resolve`` drops the axis, as JAX's
    ``constrain`` does, so the layers run on the whole stream: no layer
    stage, no collective, and JAX's logits."""
    model, params = port_model(cases.DENSE, jax_results)
    staged = recorded_grids(monkeypatch, transformer, "_layer_stages")
    with tuning.overrides(seq_shard_mlp=True), record() as log:
        got = build_serve_prefill(model, meshes["1x4"])[0](
            params, batch_of(model, cases.ODD_SEQ))
    assert not staged and not log.counts("collective")
    assert_close(got, jax_results["prefill"][cases.DENSE, "1x4",
                                             cases.ODD_SEQ], FP32_TOL)


# ------------------------------------------------------------------- (b)

@pytest.mark.parametrize("microbatch", cases.TRAIN_MICRO)
def test_train_step_matches_jax(jax_results, meshes, monkeypatch,
                                microbatch):
    """The dense step on (2, 4): every layer runs on the grid in the
    forward and again in remat's recomputation, every microbatch, and the
    steps equal JAX's."""
    model, params = port_model(cases.DENSE, jax_results)
    staged = recorded_grids(monkeypatch, transformer, "_layer_stages")
    with tuning.overrides(seq_shard_mlp=True):
        _, _, got = port_steps(model, params, meshes["2x4"],
                               range(cases.TRAIN_STEPS),
                               microbatch=microbatch)
    assert len(staged) == (2 * model.cfg.n_layers * microbatch
                           * cases.TRAIN_STEPS)
    assert_steps_match(got, jax_results["steps"][microbatch])
