"""Dry run: one step of every (arch x shape x mesh) cell on the meta device.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  JAX
lowers and compiles each cell for forced host devices; PyTorch has no
compiler to ask, so the port runs the cell's step once on ``device="meta"``
(shapes and dtypes, no storage, no GPU) under the op recorder of
``launch/op_analysis.py``, over ``make_production_mesh`` laid on meta
devices.  For each cell this gives, without allocating:

  * proof that the configuration, shape and mesh are coherent (the step
    runs: every shape check and every sharded stage);
  * per-device memory: argument bytes exactly from the specs (each
    leaf's shard, ceil-divided as XLA pads), output and alias bytes from
    the donation of parameters, optimizer state and cache, and temp bytes
    from the traced peak of what the step allocates, over the devices (an
    estimate from even sharding);
  * per-device flops and HBM bytes (``analyze_ops``, the twin of
    ``analyze_hlo``), and collective bytes by type from the explicit
    stages' collectives (with ``--variant seq_shard_mlp=1``, the
    sequence-parallel layers' too).

Keys with no twin: ``compile_s`` and XLA's ``cost_analysis`` (nothing is
compiled); ``lower_s`` becomes ``trace_s`` and ``hlo_lines`` becomes
``ops``.  Results are JSON under ``build/dryrun_torch/``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \
      --variant seq_shard_mlp=1
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import torch

from ..models.convert import _jax_path

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3]
             / "build" / "dryrun_torch")

ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

NOTES = (
    "argument bytes: each leaf's shard shape from its spec, ceil-divided",
    "temp bytes: the traced peak of the storages the step allocates, over "
    "the devices (an estimate from even sharding); it includes the "
    "outputs the step makes anew, so peak_bytes_est is argument + temp",
    "collectives: the explicit stages' (the sharded MoE, flash decode) "
    "and, with the seq_shard_mlp knob, the sequence-parallel layers' "
    "all-gathers and reduce-scatters; the others GSPMD would imply for "
    "the specs have no twin",
    "no twin: compile_s, cost_analysis (nothing is compiled)",
)


def shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's shard of ``t`` laid out by ``spec`` on
    ``mesh``: each dimension ceil-divided by its axes' product."""
    n = t.dtype.itemsize
    for i, d in enumerate(t.shape):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            n *= d
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        n *= -(-d // math.prod(mesh.shape[a] for a in axes))
    return n


def tree_shard_bytes(tree: Mapping[str, torch.Tensor],
                     specs: Mapping[str, Any], mesh) -> int:
    return sum(shard_bytes(t, specs[k], mesh) for k, t in tree.items())


def _tuple_table(n_leaves: int) -> int:
    """XLA's output bytes for a step that returns a tuple: a table of one
    8-byte pointer a leaf of the JAX tree, beside the leaves."""
    return 8 * n_leaves


def _jax_leaves(names) -> int:
    """Leaves of the JAX tree of the port's parameter names (each layer
    list is one stacked leaf a path)."""
    return len({_jax_path(n)[0] for n in names})


def trace_cell(model, shape, mesh, fsdp: Optional[bool] = None
               ) -> Dict[str, Any]:
    """One step of ``model`` (built on the meta device) at ``shape`` over
    ``mesh`` under the op recorder: the record's ``microbatch`` (train),
    ``memory_analysis``, ``op_analysis``, ``collectives_static``,
    ``trace_s``, ``ops`` and ``n_devices``, plus the op log itself under
    ``"log"`` (the caller drops it before writing JSON)."""
    from ..optim import adamw
    from ..parallel.ctx import PartitionSpec as P, dp_axes
    from ..parallel.sharding import assign_spec, batch_pspecs
    from ..train.step import (
        abstract_params, auto_microbatch, build_serve_decode,
        build_serve_prefill, build_train_step,
    )
    from .op_analysis import analyze_ops, record

    cfg = model.cfg
    n_dev = int(mesh.devices.size)
    rec: Dict[str, Any] = {}
    t0 = time.time()
    params = abstract_params(model)
    p_named = dict(params.named_parameters())
    batch = model.batch_spec(shape)
    logits_spec = assign_spec((shape.global_batch, cfg.vocab),
                              [(dp_axes(mesh), -2), ("model", -1)], mesh)
    if shape.kind == "train":
        micro = auto_microbatch(shape.global_batch, shape.seq_len, mesh)
        rec["microbatch"] = micro
        step, (p_specs, o_specs), opt_cfg = build_train_step(
            model, mesh, fsdp=fsdp, microbatch=micro)
        opt = adamw.init(opt_cfg, params)
        state = (tree_shard_bytes(p_named, p_specs, mesh)
                 + shard_bytes(opt.step, o_specs.step, mesh)
                 + tree_shard_bytes(opt.m, o_specs.m, mesh)
                 + tree_shard_bytes(opt.v, o_specs.v, mesh))
        args = state + tree_shard_bytes(batch, batch_pspecs(batch, mesh),
                                        mesh)
        with record() as log:
            _, _, metrics = step(params, opt, batch)
        n_p = _jax_leaves(p_named)
        outs = state + sum(m.dtype.itemsize * m.numel()
                           for m in metrics.values()) + _tuple_table(
            3 * n_p + 1 + len(metrics))         # params, m, v, step, metrics
        alias = state
    elif shape.kind == "prefill":
        fn, p_specs = build_serve_prefill(model, mesh)
        args = (tree_shard_bytes(p_named, p_specs, mesh)
                + tree_shard_bytes(batch, batch_pspecs(batch, mesh), mesh))
        with record() as log:
            out = fn(params, batch)
        outs = shard_bytes(out, logits_spec, mesh)
        alias = 0
    else:  # decode, at the deepest position (Model.batch_spec)
        fn, p_specs, c_specs, cache = build_serve_decode(
            model, mesh, shape.global_batch, shape.seq_len)
        tok = batch["tokens"]
        cache_b = tree_shard_bytes(cache, c_specs, mesh)
        args = (tree_shard_bytes(p_named, p_specs, mesh) + cache_b
                + shard_bytes(tok, batch_pspecs({"tokens": tok}, mesh)
                              ["tokens"], mesh)
                + shard_bytes(batch["pos"], P(), mesh))
        with record() as log:
            out, _ = fn(params, cache, tok, shape.seq_len - 1)
        outs = (shard_bytes(out, logits_spec, mesh) + cache_b
                + _tuple_table(1 + len(cache)))
        alias = cache_b
    rec["trace_s"] = round(time.time() - t0, 2)
    temp = -(-log.peak_bytes // n_dev)
    rec["memory_analysis"] = {
        "argument_bytes": int(args),
        "output_bytes": int(outs),
        "temp_bytes": int(temp),
        "alias_bytes": int(alias),
        "peak_bytes_est": int(args + temp),
    }
    ana = analyze_ops(log, default_group=n_dev, n_devices=n_dev)
    rec["op_analysis"] = ana
    rec["collectives_static"] = {
        "bytes_by_type": ana["collective_bytes_by_type"],
        "count_by_type": ana["collective_count_by_type"],
        "wire_bytes_per_device": ana["wire_bytes_per_device"],
    }
    rec["ops"] = len(log)
    rec["n_devices"] = n_dev
    rec["notes"] = list(NOTES)
    rec["log"] = log
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fsdp: Optional[bool] = None, remat: bool = True,
             variant: str = "baseline") -> Dict[str, Any]:
    """The record of one cell on the production mesh of meta devices
    (16x16, or 2x16x16 with ``multi_pod``).  ``variant`` sets tuning knobs
    (``"q_chunk=1024;remat=dots"``); ``remat=False`` sets the ``remat``
    knob to ``"none"`` unless the variant names it."""
    from .. import tuning
    from ..configs import get_config, shape_by_name
    from ..models.model import build_model
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "variant": variant,
        "params_B": cfg.param_count() / 1e9,
        "active_params_B": cfg.active_param_count() / 1e9,
    }
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec["status"] = "skip"
        rec["reason"] = ("pure full-attention arch: 524k dense decode is the "
                         "quadratic regime excluded by the shape suite")
        return rec
    knobs = tuning.parse(variant)
    if not remat:
        knobs.setdefault("remat", "none")
    rec["tuning"] = knobs
    model = build_model(cfg, device="meta")
    with tuning.overrides(**knobs):
        rec.update(trace_cell(model, shape, mesh, fsdp=fsdp))
    rec.pop("log")
    rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fsdp", default=None, choices=(None, "on", "off"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=str(ARTIFACTS),
                    help="directory for the JSON records")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS

    archs = ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = ALL_SHAPES if args.all or not args.shape else (args.shape,)
    meshes = (False, True) if (args.both_meshes or args.all) else (args.multi_pod,)
    fsdp = None if args.fsdp is None else (args.fsdp == "on")

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch}__{shape}__{mesh_name}"
                if args.variant != "baseline":
                    safe = args.variant.replace("=", "").replace(";", "_")
                    tag += f"__{safe}"
                out = out_dir / f"{tag}.json"
                if args.skip_existing and out.exists():
                    prev = json.loads(out.read_text())
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[skip-existing] {tag}")
                        continue
                print(f"[dryrun] {tag} ...", flush=True)
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mp, fsdp=fsdp,
                                   variant=args.variant)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                rec["seconds"] = round(time.time() - t0, 2)
                out.write_text(json.dumps(rec, indent=2))
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    ma = rec["memory_analysis"]
                    oa = rec["op_analysis"]
                    extra = (f" mem/dev={ma['peak_bytes_est']/2**30:.2f}GiB"
                             f" flops/dev={oa['flops_per_device']:.3g}"
                             f" hbm/dev={oa['hbm_bytes_per_device']:.3g}B"
                             f" wire/dev={oa['wire_bytes_per_device']:.3g}B"
                             f" ops={rec['ops']} trace={rec['trace_s']}s")
                print(f"[dryrun] {tag}: {status}{extra}"
                      f" ({rec['seconds']}s)", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
