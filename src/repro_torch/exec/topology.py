"""2-D topology: data-parallel replica rows composed with z-sharding.

A copy of the JAX package's ``exec/topology.py`` for the port, over
``core.engine.Mesh`` grids of ``torch.device``s (one process driving every
device, as the JAX package does; not ``torch.distributed``).

The online stage is parallel along two independent axes: across queries
(every intersection is independent) and across the universe (Theorem 3.7:
partitioning every set by the same permutation makes equal z-ranges
self-contained).  A ``(data, shard)`` mesh of ``replicas`` rows by
``shards`` columns uses both:

- each **row** is one replica, holding its own mirror of every set,
  z-sharded over the row's ``shards`` devices as on a 1-D mesh;
- mesh-routed buckets (large G) split their **batch axis** over the rows
  (``core.engine.dispatch_mesh2d_batch``);
- single-device buckets (small G) are **spread over the rows** by the
  :class:`ReplicaBalancer`, each on its row's plain mirrors.

:class:`Topology` owns the mesh, the axis names, each row's device and row
mesh, and the balancer; engines take ``topology=`` and thread it through
the planner (``ShapeSig.replicas``), the bucket executor and warming.  On a
machine with one GPU the caller lists the grid's devices explicitly, with
repeats: ``make_topology(2, 2, devices=["cuda:0"] * 4)``.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.engine import DATA_AXIS, SHARD_AXIS, Mesh, make_mesh2d
from ..device import Device

__all__ = ["DATA_AXIS", "SHARD_AXIS", "ReplicaBalancer", "Topology",
           "make_topology"]


class ReplicaBalancer:
    """Least-loaded replica selection with per-replica load accounting.

    Pure bookkeeping, no device state, thread-safe.  The executor
    :meth:`acquire`\\ s at dispatch and :meth:`release`\\ s at collect
    (``InFlightBucket._finish``), so a dispatched, uncollected bucket keeps
    its weight visible for the whole time it occupies a device and
    overlapping dispatches spread over rows.  ``weight`` is the bucket's
    estimated cost (the executor uses ``B * G``, the phase-1 row count).
    :meth:`acquire` picks the replica with the least in-flight weight, ties
    broken by the least cumulative weight (an idle, synchronous loop is
    then a weighted round robin), then by replica id.  A dispatch that
    fails releases at once, flagged as a failure.

    :meth:`loads` snapshots ``in_flight`` weight, ``dispatched`` buckets,
    cumulative ``weight``, ``failures`` and a per-row ``queued_weight``
    histogram (power-of-two bounds over per-bucket weight).
    """

    # pow2 upper bounds of the per-row acquired-weight histogram (weight is
    # B * G); the last bucket is the +Inf overflow
    WEIGHT_BUCKETS = tuple(float(1 << i) for i in range(0, 32, 2))

    def __init__(self, n_replicas: int):
        if n_replicas < 1:
            raise ValueError("a balancer needs at least one replica")
        self.n_replicas = int(n_replicas)
        self._lock = threading.Lock()
        self.reset()

    def acquire(self, weight: float = 1.0) -> int:
        """Pick the least-loaded replica and account ``weight`` to it."""
        weight = float(weight)
        b = bisect.bisect_left(self.WEIGHT_BUCKETS, weight)
        with self._lock:
            r = min(range(self.n_replicas),
                    key=lambda i: (self._in_flight[i], self._weight[i], i))
            self._in_flight[r] += weight
            self._dispatched[r] += 1
            self._weight[r] += weight
            self._weight_hist[r][b] += 1
            return r

    def release(self, replica: int, weight: float = 1.0,
                failed: bool = False) -> None:
        """Return ``weight`` of in-flight load on ``replica`` (never below
        0).  ``failed=True`` marks a dispatch or collect that raised: the
        weight comes back either way, and the failure is counted."""
        with self._lock:
            self._in_flight[replica] = max(
                0.0, self._in_flight[replica] - float(weight))
            if failed:
                self._failures[replica] += 1

    def loads(self) -> List[Dict[str, object]]:
        """Per-replica accounting, taken in one pass under the lock.
        ``queued_weight["counts"][i]`` is the number of buckets of weight
        at most ``buckets[i]`` (the trailing count: above the last bound)."""
        with self._lock:
            out = []
            for r in range(self.n_replicas):
                cumulative, total = [], 0
                for c in self._weight_hist[r]:
                    total += c
                    cumulative.append(total)
                out.append({
                    "in_flight": self._in_flight[r],
                    "dispatched": self._dispatched[r],
                    "weight": self._weight[r],
                    "failures": self._failures[r],
                    "queued_weight": {"buckets": list(self.WEIGHT_BUCKETS),
                                      "counts": cumulative},
                })
            return out

    def reset(self) -> None:
        """Zero all accounting.  Never while buckets are in flight: their
        release would subtract from the zeroed state."""
        with self._lock:
            self._in_flight = [0.0] * self.n_replicas
            self._dispatched = [0] * self.n_replicas
            self._weight = [0.0] * self.n_replicas
            self._failures = [0] * self.n_replicas
            self._weight_hist = [[0] * (len(self.WEIGHT_BUCKETS) + 1)
                                 for _ in range(self.n_replicas)]


class Topology:
    """A 2-D ``(data, shard)`` mesh with replica-aware placement.

    - ``replicas`` / ``shards``: the mesh shape, which the planner stamps
      into ``ShapeSig``, so 2-D buckets never mix with others;
    - :meth:`replica_device`: row r's device (column 0), where its plain
      mirrors live and its single-device buckets run;
    - :meth:`row_mesh`: row r's 1-D shard mesh, one object per row for the
      topology's lifetime (a pass specialization is keyed by its mesh);
    - ``balancer``: the :class:`ReplicaBalancer` spreading single-device
      buckets.
    """

    def __init__(self, mesh: Mesh, data_axis: str = DATA_AXIS,
                 shard_axis: str = SHARD_AXIS):
        if data_axis not in mesh.shape or shard_axis not in mesh.shape:
            raise ValueError(f"mesh axes {mesh.axis_names} must include "
                             f"{data_axis!r} and {shard_axis!r}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.shard_axis = shard_axis
        self.balancer = ReplicaBalancer(self.replicas)
        self._row_meshes = []
        for r in range(self.replicas):
            devs = self.replica_devices(r)
            grid = np.empty(len(devs), dtype=object)
            grid[:] = devs
            self._row_meshes.append(Mesh(grid, (shard_axis,)))

    @property
    def replicas(self) -> int:
        return self.mesh.shape[self.data_axis]

    @property
    def shards(self) -> int:
        return self.mesh.shape[self.shard_axis]

    def replica_device(self, r: int) -> torch.device:
        """Replica row ``r``'s anchor device (column 0)."""
        return self.replica_devices(r)[0]

    def replica_devices(self, r: int) -> List[torch.device]:
        """All devices of replica row ``r``, in shard order."""
        devices = self.mesh.devices
        if self.mesh.axis_names.index(self.data_axis) == 0:
            return list(devices[r])
        return list(devices[:, r])

    def row_mesh(self, r: int) -> Mesh:
        """Replica row ``r``'s 1-D z-sharding mesh (always the same
        object)."""
        return self._row_meshes[r]

    def describe(self) -> str:
        """The ``"RxS"`` layout label, e.g. ``"2x2"``."""
        return f"{self.replicas}x{self.shards}"

    def load_snapshot(self) -> List[Dict[str, object]]:
        """The balancer's per-replica accounting."""
        return self.balancer.loads()


def make_topology(replicas: int, shards: Optional[int] = None,
                  data_axis: str = DATA_AXIS, shard_axis: str = SHARD_AXIS,
                  devices: Optional[Sequence[Device]] = None) -> Topology:
    """A :class:`Topology` over ``replicas * shards`` devices
    (``core.engine.make_mesh2d``): the visible CUDA devices by default,
    else the caller's ``devices``, which may repeat a device (one GPU
    carrying a 2x2 layout: ``devices=["cuda:0"] * 4``)."""
    return Topology(make_mesh2d(replicas, shards, data_axis=data_axis,
                                shard_axis=shard_axis, devices=devices),
                    data_axis=data_axis, shard_axis=shard_axis)
