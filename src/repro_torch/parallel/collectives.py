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

Under ``launch.op_analysis.record`` each collective is one entry of the op
log, under its HLO name (``psum``, ``pmax`` and ``pmean`` are
``all-reduce``, ``psum_scatter`` is ``reduce-scatter``), with one
coordinate's result block and the group size; its backward, when
autograd runs one, is another.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from ..launch import op_analysis

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


def _combined(mesh, grid: Grid, axes: AxisNames,
              op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """Each group of ``grid`` once: (its peers in peer order, their blocks
    combined in that order on the first peer's device).  A group of g
    peers costs g - 1 ops, not g of them each."""
    seen = set()
    for c in grid:
        if c in seen:
            continue
        peers = _peers(mesh, c, axes)
        seen.update(peers)
        dev = device_of(mesh, peers[0])
        acc = None
        for p in peers:
            x = grid[p].to(dev)
            acc = x if acc is None else op(acc, x)
        yield peers, acc


def _reduce(mesh, grid: Grid, axes: AxisNames,
            op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
            divisor: int = 1) -> Grid:
    """Each group's blocks combined once (``_combined``), divided by
    ``divisor``, and the result handed to every peer on its own device:
    peers that share a device share one tensor."""
    out = {}
    for peers, acc in _combined(mesh, grid, axes, op):
        if divisor != 1:
            acc = acc / divisor
        for p in peers:
            out[p] = acc.to(device_of(mesh, p))
    return {c: out[c] for c in grid}


def _noted(op: str, mesh, source: Grid, grid: Grid, axes: AxisNames
           ) -> Grid:
    first = next(iter(grid))
    op_analysis.note_collective(op, source[first], grid[first],
                                len(_peers(mesh, first, axes)))
    return grid


def psum(mesh, grid: Grid, axes: AxisNames) -> Grid:
    """Every block replaced by the sum over its group, added in peer order
    in the blocks' dtype."""
    return _noted("all-reduce", mesh, grid,
                  _reduce(mesh, grid, axes, torch.add), axes)


def pmax(mesh, grid: Grid, axes: AxisNames) -> Grid:
    return _noted("all-reduce", mesh, grid,
                  _reduce(mesh, grid, axes, torch.maximum), axes)


def pmean(mesh, grid: Grid, axes: AxisNames) -> Grid:
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes_t:
        n *= mesh.shape[a]
    return _noted("all-reduce", mesh, grid,
                  _reduce(mesh, grid, axes, torch.add, n), axes)


def all_gather(mesh, grid: Grid, axes: AxisNames, dim: int = 0) -> Grid:
    """Every block replaced by its group's blocks concatenated along
    ``dim`` in peer order (JAX's ``all_gather(..., tiled=True)``)."""
    dev = {c: device_of(mesh, c) for c in grid}
    return _noted("all-gather", mesh, grid, {
        c: torch.cat([grid[p].to(dev[c]) for p in _peers(mesh, c, axes)],
                     dim=dim) for c in grid}, axes)


def psum_scatter(mesh, grid: Grid, axes: AxisNames, dim: int) -> Grid:
    """Peer i's block replaced by the i-th of ``dim``'s equal slices of its
    group's sum (JAX's ``psum_scatter(..., tiled=True)``).  Each group is
    summed once, in peer order in the blocks' dtype, on the first peer's
    device (``_combined``, as ``psum``), and each peer's slice is moved to
    its device.  Autograd's backward amounts to an all-gather of the
    cotangent."""
    out = {}
    for peers, acc in _combined(mesh, grid, axes, torch.add):
        n = acc.shape[dim]
        if n % len(peers):
            raise ValueError(f"psum_scatter over {len(peers)} peers: "
                             f"dimension {dim} of size {n}")
        step = n // len(peers)
        for i, p in enumerate(peers):
            out[p] = acc.narrow(dim, i * step, step).to(device_of(mesh, p))
    return _noted("reduce-scatter", mesh, grid, {c: out[c] for c in grid},
                  axes)


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
    return _noted("all-to-all", mesh, grid, out, axes)
