"""Production and local meshes over the port's one-process ``Mesh``.

The port's copy of the JAX package's ``launch/mesh.py``.  A mesh here is a
named grid of ``torch.device``s (``core/engine.py::Mesh``), driven from one
process; a device may repeat, which lays several logical shards on it
(``make_local_mesh(devices=["cuda:0"] * 4)`` on a one-card machine).
Without ``devices=`` both builders take the visible CUDA devices and raise
when there is no GPU: there is no CPU fallback.

One deliberate difference from the reference: JAX's ``make_mesh`` gives
``Explicit`` axes under jax 0.9, which the reference's own
``parallel/ctx.py::constrain`` refuses (ROADMAP queue 3).  The port has no
axis types, and its ``constrain`` never refuses.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from ..core.engine import Mesh, _device_grid, _mesh_devices
from ..device import Device


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[Device]] = None) -> Mesh:
    """16x16 ``(data, model)`` (one pod, 256 devices) or 2x16x16 ``(pod,
    data, model)`` (two pods, 512 devices), laid out row-major from
    ``devices`` (default: the visible CUDA devices), which must hold
    exactly that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _mesh_devices(devices)
    if len(devs) != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                         f"have {len(devs)}")
    return Mesh(_device_grid(devs, shape), axes)


def make_local_mesh(devices: Optional[Sequence[Device]] = None) -> Mesh:
    """Every device of ``devices`` (default: the visible CUDA devices) as
    a ``(data, model)`` mesh of shape (1, n)."""
    devs = _mesh_devices(devices)
    return Mesh(_device_grid(devs, (1, len(devs))), ("data", "model"))
