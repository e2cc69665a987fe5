"""The port's dry-run tools against the JAX package's, on the CPU.

``Model.batch_spec`` and ``train/step.py::auto_microbatch`` equal JAX's on
every config, shape and grid point.  The op log's counting rules
(``launch/op_analysis.py``) mirror ``tests/test_hlo_analysis.py``'s cases
for ``analyze_hlo``.  ``launch/dryrun.py::trace_cell``, the core of
``run_cell``, traces the smoke configs of a dense and a MoE model on the
meta device over (1, 1) and (2, 4) meshes; ``tests/_torch_dryrun_cases.py``
lowers and compiles the same steps in JAX (two subprocesses side by side,
eight forced host devices, ``Auto`` axes).  Argument, output and alias
bytes per device must equal XLA's ``memory_analysis`` exactly, and the
train step's flops on (1, 1) must be within 3% of ``analyze_hlo``'s.  A
full-width cell runs through ``run_cell`` with no torch flag set, and
``core/engine.py::bucket_op_log`` on the CPU gives what a dispatch gives.
"""
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.train.step import auto_microbatch as jax_auto_microbatch

from repro_torch import tuning
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.configs import smoke_config
from repro_torch.core import hashing, partition
from repro_torch.core.engine import (
    EXEC_COUNTERS, DeviceSet, bucket_op_log, clear_specializations,
    dispatch_device_batch, make_mesh2d,
)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import analyze_ops, record
from repro_torch.models.convert import _jax_path
from repro_torch.models.model import build_model
from repro_torch.parallel import collectives as coll
from repro_torch.train.step import abstract_params, auto_microbatch

import _torch_dryrun_cases as cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per-host batches batch_spec is asked for besides the global one
PER_HOST = (None, 4)


@pytest.fixture(autouse=True)
def _reset_port_counters():
    EXEC_COUNTERS.reset()
    yield


def meta_mesh(shape):
    """A mesh of ``shape`` over meta devices, as the dry run lays them."""
    n = int(np.prod(shape))
    if shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3,
                                    devices=["meta"] * n)
    return make_mesh2d(shape[0], shape[1], data_axis="data",
                       shard_axis="model", devices=["meta"] * n)


# -- batch_spec and auto_microbatch ------------------------------------------

def test_the_registries_match_jax():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind) for s in JAX_SHAPES]
    assert dryrun.ALL_SHAPES == tuple(s.name for s in JAX_SHAPES)


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_spec_matches_jax(arch, shape):
    """Names, shapes and dtypes of every input stand-in, global and per
    host; the port's are meta tensors."""
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch), device="meta")
    jshape = next(s for s in JAX_SHAPES if s.name == shape)
    pshape = next(s for s in SHAPES if s.name == shape)
    for per_host in PER_HOST:
        want = jmodel.batch_spec(jshape, per_host)
        got = model.batch_spec(pshape, per_host)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k


MICRO_MESHES = [(1, 1), (2, 4), (16, 16), (2, 16, 16)]


def jax_mesh_like(mesh):
    """What JAX's ``auto_microbatch`` reads of a mesh: its axis names and
    shape (a 256- or 512-device JAX mesh is not needed for the formula)."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 shape=dict(mesh.shape))


@pytest.mark.parametrize("micro_tokens", [None, 2048, 65536])
@pytest.mark.parametrize("mesh_shape", MICRO_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_auto_microbatch_matches_jax(mesh_shape, micro_tokens):
    """JAX's formula on the grid global batch {1, 8, 256} x seq {512,
    4096, 32768}, at ``micro_tokens``'s default and two other settings
    (read through the knob on both sides)."""
    mesh = meta_mesh(mesh_shape)
    knobs = {} if micro_tokens is None else {"micro_tokens": micro_tokens}
    seen = set()
    with tuning.overrides(**knobs), jax_tuning.overrides(**knobs):
        for gb in (1, 8, 256):
            for seq in (512, 4096, 32768):
                got = auto_microbatch(gb, seq, mesh)
                assert got == jax_auto_microbatch(gb, seq,
                                                  jax_mesh_like(mesh))
                assert got == auto_microbatch(
                    gb, seq, mesh, tuning.get("micro_tokens"))
                seen.add(got)
    assert len(seen) > 1


# -- the op log's counting rules (tests/test_hlo_analysis.py's cases) --------

def test_a_loop_of_matmuls_counts_every_iteration():
    d, layers = 64, 7
    x = torch.zeros(32, d, device="meta")
    w = torch.zeros(d, d, device="meta")
    with record() as log:
        for _ in range(layers):
            x = x @ w
    got = analyze_ops(log, default_group=1)
    assert got["flops_per_device"] == 2 * 32 * d * d * layers
    assert log.counts("aten") == {"aten.mm.default": layers}
    # each product reads x and w and writes x: no fusion to hide it
    assert got["hbm_bytes_per_device"] == layers * 4 * (2 * 32 * d + d * d)


def test_an_in_place_slice_update_counts_the_update_not_the_buffer():
    buf = torch.zeros(4096, 128)
    idx = torch.arange(8)
    upd = torch.ones(8, 128)
    with record() as log:
        buf[idx] = upd
        buf.index_add_(0, idx, upd)
    got = analyze_ops(log, default_group=1)
    # read the update and write its rows, plus the indices; twice
    assert got["hbm_bytes_per_device"] == 2 * (2 * upd.numel() * 4
                                               + idx.numel() * 8)
    assert got["hbm_bytes_per_device"] < buf.numel() * 4


def test_a_chain_of_views_moves_no_bytes():
    x = torch.zeros(8, 16, 32)
    with record() as log:
        y = x.view(8, 512).transpose(0, 1)[3:7].unsqueeze(0).expand(2, 4, 8)
        y = y.reshape(2, 4, 8)      # a view: the expand is not copied
    assert [e.name.split(".")[1] for e in log.ops] == [
        "view", "transpose", "slice", "unsqueeze", "expand", "view"]
    assert all(e.view for e in log.ops)
    got = analyze_ops(log, default_group=1)
    assert got["hbm_bytes_per_device"] == 0
    assert log.peak_bytes == 0


def test_an_explicit_psum_in_a_loop_counts_each_call():
    layers, group = 5, 4
    mesh = meta_mesh((1, group))
    grid = {c: torch.zeros(64, 32, device="meta")
            for c in coll.coords(mesh)}
    with record() as log:
        for _ in range(layers):
            grid = coll.psum(mesh, grid, "model")
    got = analyze_ops(log, default_group=1)
    assert got["collective_count_by_type"] == {"all-reduce": layers}
    # one group: its sum is made once (g - 1 adds), not once a peer
    assert log.counts("aten") == {"aten.add.Tensor": layers * (group - 1)}
    ring = 64 * 32 * 4 * (group - 1) / group * 2
    assert got["collective_bytes_by_type"]["all-reduce"] == ring * layers
    assert got["wire_bytes_per_device"] == ring * layers


def test_a_collective_backward_is_its_transpose():
    """autograd through an all_gather runs the reverse copies: one
    reduce-scatter entry of the source block's size."""
    mesh = make_mesh2d(1, 4, data_axis="data", shard_axis="model",
                       devices=["cpu"] * 4)
    grid = {c: torch.ones(8, 16, requires_grad=True)
            for c in coll.coords(mesh)}
    with record() as log:
        out = coll.all_gather(mesh, grid, "model", dim=0)
        sum(x.sum() for x in out.values()).backward()
    entries = [e for e in log.ops if e.kind == "collective"]
    assert [(e.name, e.results[0][0], e.group) for e in entries] == [
        ("all-gather", (32, 16), 4), ("reduce-scatter", (8, 16), 4)]


def test_a_routed_kernel_is_one_entry():
    """The router's call is one kernel entry (the plain version's ops on
    the CPU are not logged beside it): operands plus results, no flops."""
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 3, 16, 2, 4),
                           generator=gen, dtype=torch.int32)
    with record() as log:
        out = ops.bitmap_filter(images)
    assert [(e.kind, e.name) for e in log.ops] == [("kernel", "bitmap_filter")]
    got = analyze_ops(log, default_group=1)
    assert got["flops_per_device"] == 0
    assert got["hbm_bytes_per_device"] == images.numel() * 4 + out.numel()
    assert log.peak_bytes == out.untyped_storage().nbytes()


def test_peak_counts_what_autograd_saves():
    """Peak live bytes: a storage counts from the op that makes it until
    it dies, and a tensor saved for the backward lives until it runs."""
    x = torch.ones(1024, requires_grad=True)
    with record() as log:
        y = torch.sin(x * 2)        # sin's backward saves x * 2
        assert log.live_bytes == log.peak_bytes == 2 * 4096
        y.sum().backward()
        del y
        assert log.live_bytes == 4096        # x.grad
    assert log.peak_bytes >= 2 * 4096


# -- run_cell's core against JAX's lowering ----------------------------------

@pytest.fixture(scope="module")
def jax_lowered(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    procs = {a: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_dryrun_cases.py"),
         str(d / f"{a}.pkl"), a], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for a in cases.ARCHS}
    out = {}
    for a, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with open(d / f"{a}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def port_traced():
    out = {}
    for arch in cases.ARCHS:
        model = build_model(smoke_config(get_config(arch)), device="meta")
        for kind in cases.KINDS:
            for m, shape in cases.MESHES.items():
                with tuning.overrides(**cases.KNOBS):
                    out[arch, kind, m] = dryrun.trace_cell(
                        model, cases.smoke_shape(kind, ShapeConfig),
                        meta_mesh(shape))
    return out


def port_param_dtypes(arch):
    """The dtypes of the port's parameters, by JAX leaf name."""
    model = build_model(smoke_config(get_config(arch)), device="meta")
    return {".".join(_jax_path(n)[0]): str(p.dtype).replace("torch.", "")
            for n, p in abstract_params(model).named_parameters()}


# leaves whose dtype the port documents as different from the JAX
# package's; at the smoke configs (float32 throughout) there is none
DTYPE_DIFFERENCES: dict = {}


@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("kind", cases.KINDS)
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_memory_analysis_matches_jax(jax_lowered, port_traced, arch, kind,
                                     mesh):
    """Argument, output and alias bytes per device equal XLA's exactly:
    shard shapes ceil-divided from the same specs, donation of the
    parameters, optimizer state and cache, and the output tuple's table."""
    want = jax_lowered[arch, kind, mesh]
    got = port_traced[arch, kind, mesh]
    jleaves = {k.strip("[]'").replace("']['", "."): dt
               for k, _, dt in want["leaves"]["params"]}
    differs = {k for k, dt in port_param_dtypes(arch).items()
               if jleaves[k] != dt}
    assert differs == set(DTYPE_DIFFERENCES)
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert got["memory_analysis"][key] == want["memory_analysis"][key], \
            key
    if kind == "train":
        assert got["microbatch"] == want["microbatch"]
    assert got["n_devices"] == int(np.prod(cases.MESHES[mesh]))
    if arch == "deepseek-moe-16b" and mesh == "2x4":
        assert got["collectives_static"]["count_by_type"]["all-to-all"] > 0


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_train_flops_match_analyze_hlo(jax_lowered, port_traced, arch):
    """The train step's flops on (1, 1) within 3% of ``analyze_hlo``'s
    count of XLA's dots (forward, remat's recomputation and backward)."""
    want = jax_lowered[arch, "train", "1x1"]["flops_per_device"]
    got = port_traced[arch, "train", "1x1"]["op_analysis"]["flops_per_device"]
    assert abs(got - want) <= 0.03 * want, (got, want)


def test_the_seq_shard_mlp_cell_logs_its_collectives(port_traced):
    """qwen3's train cell on (2, 4) with ``seq_shard_mlp`` on, as
    ``--variant seq_shard_mlp=1`` runs it: a layer's forward logs 2
    all-gathers and 2 reduce-scatters over ``model``; remat's
    recomputation 2 and 1 (it stops after the last tensor the backward
    needs, before the MLP's reduce-scatter); the backward 2 and 2 (each
    one's transpose) — in every microbatch, and no other collective.  The
    argument bytes are the knob-off cell's: the specs are the same."""
    arch = "qwen3-1.7b"
    model = build_model(smoke_config(get_config(arch)), device="meta")
    with tuning.overrides(seq_shard_mlp=True, **cases.KNOBS):
        on = dryrun.trace_cell(model, cases.smoke_shape("train", ShapeConfig),
                               meta_mesh(cases.MESHES["2x4"]))
    off = port_traced[arch, "train", "2x4"]
    n = model.cfg.n_layers * on["microbatch"]
    assert on["collectives_static"]["count_by_type"] == {
        "all-gather": 6 * n, "reduce-scatter": 5 * n}
    assert off["collectives_static"]["count_by_type"] == {}
    assert {e.group for e in on["log"].ops if e.kind == "collective"} == {4}
    assert on["memory_analysis"]["argument_bytes"] == \
        off["memory_analysis"]["argument_bytes"]
    assert on["microbatch"] == off["microbatch"]


def test_a_full_width_cell_runs_with_no_torch_flag():
    """``run_cell`` at qwen3-1.7b's full width on the 16 x 16 mesh of meta
    devices (decode at depth 32768, B 128), as the sweep runs it, and a
    ``long_500k`` cell of a full-attention arch skipped as JAX skips it."""
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", multi_pod=False)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["op_analysis"]["flops_per_device"] > 0
    assert rec["memory_analysis"]["argument_bytes"] > 0
    assert "log" not in rec
    skip = dryrun.run_cell("qwen3-1.7b", "long_500k", multi_pod=False)
    assert skip["status"] == "skip"


# -- bucket_op_log -----------------------------------------------------------

@pytest.fixture(scope="module")
def bucket_sets():
    rng = np.random.default_rng(5)
    fam = hashing.random_hash_family(2, 256, seed=5)
    perm = hashing.default_permutation(5)
    common = rng.choice(1 << 24, 60, replace=False).astype(np.uint32)
    sets = {}
    for name, n in [("a", 1000), ("b", 1100), ("c", 4000), ("d", 4200)]:
        s = np.unique(np.concatenate(
            [rng.choice(1 << 24, n, replace=False).astype(np.uint32), common]))
        sets[name] = DeviceSet.from_host(partition.preprocess_prefix(
            s, w=256, m=2, family=fam, perm=perm), device="cpu")
    return sets


@pytest.mark.parametrize("names", ["ac", "abd"])
def test_bucket_op_log_runs_the_bucket_as_a_dispatch(bucket_sets, names):
    """Same answers and counter bumps as ``dispatch_device_batch`` and its
    collect; the log holds one ``bitmap_filter``, k - 1 ``group_match`` and
    one ``compact_rows`` entries of the first pass."""
    row = [bucket_sets[n] for n in names]
    bucket = [row, row[::-1], row]
    clear_specializations()
    before = EXEC_COUNTERS.snapshot()
    want = dispatch_device_batch(bucket, device="cpu").collect()
    mid = EXEC_COUNTERS.snapshot()
    clear_specializations()         # a first sighting again: one trace
    log = bucket_op_log(bucket, device="cpu")
    after = EXEC_COUNTERS.snapshot()
    assert len(log.results) == len(want)
    for (gv, gs), (wv, ws) in zip(log.results, want):
        assert np.array_equal(gv, wv) and gs == ws
    assert {k: mid[k] - before.get(k, 0) for k in mid} == \
        {k: after[k] - mid.get(k, 0) for k in after}
    assert log.counts("kernel") == {"bitmap_filter": 1,
                                    "group_match": len(names) - 1,
                                    "compact_rows": 1}
    got = analyze_ops(log, default_group=1)
    assert got["hbm_bytes_per_device"] > 0 and got["flops_per_device"] == 0


def test_bucket_op_log_refuses_a_mixed_bucket(bucket_sets):
    s = bucket_sets
    with pytest.raises(ValueError, match="signatures"):
        bucket_op_log([[s["a"], s["b"]], [s["a"], s["c"]]], device="cpu")
    with pytest.raises(ValueError):
        bucket_op_log([], device="cpu")
