"""Elastic scaling: restart a checkpoint onto a different mesh.

The port's copy of the JAX package's ``train/elastic.py``.  Runbook:
  1. the cluster controller detects a failed or preempted host group;
  2. the surviving hosts hold the latest async checkpoint (npz a tree plus
     manifest, written atomically: ``train/checkpoint.py``);
  3. the controller relaunches with the new device count; ``remesh``
     rebuilds the mesh from the devices there are, re-derives every spec
     (rules over names, not device counts: ``parallel/sharding.py``) and
     restores the checkpoint through the new ``NamedSharding``s;
  4. the data pipeline resumes from the manifest's step: batches are
     index-addressable, so no data is skipped or repeated;
  5. the loop's straggler counter (``train/loop.py``) feeds the same
     controller.

Every rule is checked for divisibility against the live mesh, so going
from 8-way to 4-way model parallelism changes the layout, never the
math.  On the port a spec is a description and ``restore`` places each
tree whole on the mesh's first device (``train/checkpoint.py``).  A mesh
is the port's one-process ``Mesh``; a device may repeat, which lays
several logical shards on it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from ..core.engine import Mesh, _device_grid, _mesh_devices
from ..device import Device
from ..models.model import Model
from ..optim import adamw
from ..parallel.sharding import NamedSharding, shardings_of
from . import checkpoint as ckpt
from .step import abstract_params, needs_fsdp, train_pspecs


def best_mesh_for(n_devices: int,
                  devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_devices`` of
    ``devices`` (default: the visible CUDA devices; no CPU fallback), with
    ``model`` the first of 16, 8, 4, 2, 1 that divides ``n_devices`` (TP
    islands stay within one fast interconnect domain).  Raises when there
    are too few devices."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, not {n_devices}")
    model = next(c for c in (16, 8, 4, 2, 1) if n_devices % c == 0)
    devs = _mesh_devices(devices)
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    return Mesh(_device_grid(devs[:n_devices], (n_devices // model, model)),
                ("data", "model"))


def remesh(model: Model, ckpt_dir: str, mesh: Optional[Mesh] = None,
           opt_cfg: Optional[adamw.AdamWConfig] = None
           ) -> Tuple[int, Dict[str, Any], Mesh]:
    """Restore the latest checkpoint in ``ckpt_dir`` onto ``mesh``
    (default: ``best_mesh_for`` every visible CUDA device): the specs of
    the params and the AdamW state (``opt_cfg``'s, default
    ``AdamWConfig()``) with ``needs_fsdp(model)``.  Returns (step,
    {"params", "opt"}, mesh)."""
    if mesh is None:
        devs = _mesh_devices(None)
        mesh = best_mesh_for(len(devs), devs)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    p_abs = abstract_params(model)
    o_abs = adamw.init(opt_cfg, p_abs)
    p_specs, o_specs = train_pspecs(model, mesh, opt_cfg, needs_fsdp(model))
    shardings = {
        "params": shardings_of(p_specs, p_specs, mesh),
        "opt": adamw.AdamWState(NamedSharding(mesh, o_specs.step),
                                shardings_of(o_specs.m, o_specs.m, mesh),
                                shardings_of(o_specs.v, o_specs.v, mesh)),
    }
    step, state, _ = ckpt.restore(ckpt_dir, {"params": p_abs, "opt": o_abs},
                                  shardings=shardings)
    return step, state, mesh
