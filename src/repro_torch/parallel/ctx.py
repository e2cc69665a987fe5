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
returns its input unchanged.  Only the code the reference writes as a
``shard_map`` runs shard by shard.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence, Tuple

import torch

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
