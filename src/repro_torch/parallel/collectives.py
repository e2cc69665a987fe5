"""Collectives over a grid of per-shard blocks, for the sharded LM paths.

Port-only: the JAX package writes its sharded paths as ``shard_map``
bodies with collectives in their middle (``all_to_all``, ``all_gather``,
``psum``, ``pmax``, ``pmean`` over named axes).  PyTorch has no such
construct for one process driving several devices, so the port writes
each body as stages between collectives: a stage runs once per mesh
coordinate, on that coordinate's device (``run``), and the collectives
below take the stage's blocks and move them between coordinates with
``.to(device)``.

A grid is a dict from mesh coordinate (a tuple of indices, one per axis of
``mesh.axis_names``) to that coordinate's tensor.  A collective over axes
``A`` acts within each group of coordinates that differ only along ``A``;
a group's peers are ordered row-major over ``A`` in the order given, as
JAX orders ``axis_index`` over a tuple of axes.  Each result block lies on
its coordinate's device.  The collectives are the same whether the mesh's
devices repeat (logical shards on one card) or differ.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

Coord = Tuple[int, ...]
Grid = Dict[Coord, torch.Tensor]
AxisNames = Union[str, Sequence[str]]


def coords(mesh) -> List[Coord]:
    """Every coordinate of ``mesh``, row-major."""
    return list(itertools.product(*(range(n) for n in mesh.devices.shape)))


def device_of(mesh, c: Coord) -> torch.device:
    return mesh.devices[c]


def index_along(mesh, c: Coord, axes: AxisNames) -> int:
    """``c``'s linear index over ``axes`` (row-major in the order given):
    JAX's ``axis_index`` of that tuple of axes."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    i = 0
    for a in axes:
        k = mesh.axis_names.index(a)
        i = i * mesh.devices.shape[k] + c[k]
    return i


def _peers(mesh, c: Coord, axes: AxisNames) -> List[Coord]:
    """The coordinates of ``c``'s group over ``axes``, in peer order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    ks = [mesh.axis_names.index(a) for a in axes]
    out = []
    for idx in itertools.product(*(range(mesh.devices.shape[k]) for k in ks)):
        p = list(c)
        for k, i in zip(ks, idx):
            p[k] = i
        out.append(tuple(p))
    return out


def run(mesh, fn: Callable[..., torch.Tensor], *grids: Grid) -> Grid:
    """One stage: ``fn(coord, device, *blocks)`` at every coordinate, each
    block taken from ``grids`` at that coordinate.  ``fn`` may return a
    tuple, then the result is a tuple of grids."""
    out = {c: fn(c, device_of(mesh, c), *(g[c] for g in grids))
           for c in coords(mesh)}
    first = next(iter(out.values()))
    if isinstance(first, tuple):
        return tuple({c: v[i] for c, v in out.items()}
                     for i in range(len(first)))
    return out


def _reduce(mesh, grid: Grid, axes: AxisNames,
            op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> Grid:
    out = {}
    for c in grid:
        dev = device_of(mesh, c)
        acc = None
        for p in _peers(mesh, c, axes):
            x = grid[p].to(dev)
            acc = x if acc is None else op(acc, x)
        out[c] = acc
    return out


def psum(mesh, grid: Grid, axes: AxisNames) -> Grid:
    """Every block replaced by the sum over its group, added in peer order
    in the blocks' dtype."""
    return _reduce(mesh, grid, axes, torch.add)


def pmax(mesh, grid: Grid, axes: AxisNames) -> Grid:
    return _reduce(mesh, grid, axes, torch.maximum)


def pmean(mesh, grid: Grid, axes: AxisNames) -> Grid:
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes_t:
        n *= mesh.shape[a]
    return {c: x / n for c, x in psum(mesh, grid, axes).items()}


def all_gather(mesh, grid: Grid, axes: AxisNames, dim: int = 0) -> Grid:
    """Every block replaced by its group's blocks concatenated along
    ``dim`` in peer order (JAX's ``all_gather(..., tiled=True)``)."""
    dev = {c: device_of(mesh, c) for c in grid}
    return {c: torch.cat([grid[p].to(dev[c]) for p in _peers(mesh, c, axes)],
                         dim=dim) for c in grid}


def all_to_all(mesh, grid: Grid, axes: AxisNames, split_axis: int = 0,
               concat_axis: int = 0) -> Grid:
    """JAX's ``all_to_all(..., tiled=False)``: every block's ``split_axis``
    has one entry per peer; peer i receives entry i of every peer's block,
    stacked along a new ``concat_axis`` in peer order (with both axes 0:
    ``out_i[j] = in_j[i]``)."""
    out = {}
    for c in grid:
        peers = _peers(mesh, c, axes)
        if grid[c].shape[split_axis] != len(peers):
            raise ValueError(f"all_to_all over {len(peers)} peers: split "
                             f"axis of size {grid[c].shape[split_axis]}")
        i = peers.index(c)
        dev = device_of(mesh, c)
        parts = [grid[p].select(split_axis, i).to(dev) for p in peers]
        out[c] = torch.stack(parts, dim=concat_axis)
    return out
