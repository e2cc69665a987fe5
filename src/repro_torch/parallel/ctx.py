"""Activation-sharding context: lets model code name sharding constraints
without carrying a mesh through every call signature.

The port's copy of the JAX package's ``parallel/ctx.py``.  Model code
calls ``constrain(x, ("model", DP, None))``; ``DP`` stands for the mesh's
data-parallel axes (``("pod", "data")`` on the multi-pod mesh).  The serve
builders (``train/step.py``) enter ``activation_mesh`` for each call, and
the sharded paths (``moe._moe_ffn_shardmap``,
``layers._attention_decode_flash``) read ``current_mesh``.

The port has no GSPMD partitioner to hand a constraint to, so a spec is a
description: ``constrain`` resolves it exactly as the reference does
(``DP`` expanded, axes that do not divide their dimension dropped) and
returns its input unchanged.  What runs shard by shard places its tensors
itself: the code the reference writes as a ``shard_map``, and the
residual stream under the ``seq_shard_mlp`` knob, which ``shard`` cuts
into a grid of blocks on the mesh's devices (``parallel/collectives.py``)
and ``unshard`` joins again.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from . import collectives as coll

DP = "__dp__"

_STATE = {"mesh": None}


@contextlib.contextmanager
def activation_mesh(mesh):
    """``mesh`` (a ``Mesh``, or None for none) is the active mesh inside
    the block; the one before it is restored after, so contexts nest."""
    old = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = old


def current_mesh():
    return _STATE["mesh"]


class PartitionSpec(tuple):
    """A tensor's layout over a mesh, one entry a dimension: a mesh axis
    name, a tuple of names (the dimension split over their product), or
    None (replicated)."""

    def __new__(cls, *parts) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def dp_axes(mesh) -> Tuple[str, ...]:
    """``mesh``'s data-parallel axes, outermost first: ``pod`` and
    ``data``, those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _expand(mesh, axes) -> Any:
    if axes == DP:
        dp = dp_axes(mesh)
        return dp if len(dp) > 1 else (dp[0] if dp else None)
    return axes


def resolve(shape: Sequence[int], spec: Sequence[Any],
            mesh) -> PartitionSpec:
    """The spec the reference's ``constrain`` hands to
    ``with_sharding_constraint`` for a tensor of ``shape`` on ``mesh``:
    ``DP`` expanded, and each entry whose axes' product does not divide
    its dimension replaced by None."""
    resolved = []
    for dim, axes in zip(shape, spec):
        axes = _expand(mesh, axes)
        if axes is None:
            resolved.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        size = 1
        for a in tup:
            size *= mesh.shape[a]
        resolved.append(axes if dim % size == 0 else None)
    return PartitionSpec(*resolved)


def constrain(x: torch.Tensor, spec: Sequence[Any]) -> torch.Tensor:
    """``x`` itself.  With a mesh active, ``spec`` is first resolved
    against it (``resolve``), as the reference does before it constrains;
    entries may be axis names, tuples, None, or the ``DP`` placeholder."""
    mesh: Optional[Any] = _STATE["mesh"]
    if mesh is not None:
        resolve(x.shape, spec, mesh)
    return x


def _split(spec) -> list:
    """(dimension, axes tuple) of each entry of a resolved ``spec`` that
    names axes."""
    return [(d, (a,) if isinstance(a, str) else tuple(a))
            for d, a in enumerate(spec) if a is not None]


def shard(x: torch.Tensor, spec: PartitionSpec) -> coll.Grid:
    """``x`` cut into the grid of a resolved ``spec`` (``resolve``'s
    output) over the active mesh: each coordinate's block of ``x`` on its
    device, a dimension split over several axes cut in row-major peer
    order (``collectives.index_along``), an axis the spec does not name
    replicated."""
    mesh = _STATE["mesh"]
    out = {}
    for c in coll.coords(mesh):
        block = x
        for d, axes in _split(spec):
            n = x.shape[d] // math.prod(mesh.shape[a] for a in axes)
            block = block.narrow(d, coll.index_along(mesh, c, axes) * n, n)
        out[c] = block.to(coll.device_of(mesh, c))
    return out


def unshard(grid: coll.Grid, spec: PartitionSpec) -> torch.Tensor:
    """The inverse of ``shard``: the blocks of a grid laid out by
    ``spec`` over the active mesh joined into one tensor on the mesh's
    first device (an axis the spec does not name read at index 0)."""
    mesh = _STATE["mesh"]
    dev = coll.device_of(mesh, coll.coords(mesh)[0])
    split = _split(spec)

    def join(level: int, at: dict) -> torch.Tensor:
        if level == len(split):
            c = tuple(at.get(a, 0) for a in mesh.axis_names)
            return grid[c].to(dev)
        d, axes = split[level]
        parts = []
        for i in range(math.prod(mesh.shape[a] for a in axes)):
            idx = {}
            for a in reversed(axes):
                i, idx[a] = divmod(i, mesh.shape[a])
            parts.append(join(level + 1, {**at, **idx}))
        return torch.cat(parts, dim=d)

    return join(0, {})
