"""Count kernel wrapper: a suggest bucket's per-pair intersection counts as
one hand-written CUDA kernel (``csrc/pair_count.cu``).

Replaces the TPU kernel ``repro.kernels.count.pair_count_pallas``, fused
with the alignment gather, probe broadcast and G-sum of
``repro.core.engine._count_block`` around it.  The kernel reads every mirror
in place through a :class:`CountTable` of device pointers, so no candidate
stack and no (B, C, G, g) broadcast is ever made.  The CUDA source says what
bounds it and how its design answers that.  The plain version is
``kernels.ref.count_block_ref``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["CountTable", "make_count_table", "count_block_cuda"]


@dataclasses.dataclass(frozen=True)
class CountTable:
    """One suggest bucket packed for the count kernel.

    ``probes[b]`` is row b's (2^tp, gp) int32 probe mirror and ``cands[b]``
    its candidate mirrors, each (2^tc, gc); ``ts`` = (tp, tc).  ``ptrs`` is
    the (B, 1 + c_tier) int64 table on the mirrors' device: column 0 holds
    the probe's ``data_ptr()``, column 1 + c candidate c's, and 0 marks a
    padding slot (c >= ``len(cands[b])``).  The table holds Python
    references to every mirror it names, so they outlive any launch that
    reads them while the table is alive.
    """

    probes: List[torch.Tensor]
    cands: List[List[torch.Tensor]]
    ts: Tuple[int, int]
    ptrs: torch.Tensor

    @property
    def c_tier(self) -> int:
        return self.ptrs.shape[1] - 1

    @property
    def real(self) -> torch.Tensor:
        """(B, c_tier) bool on the table's device: the slots that hold a
        candidate."""
        return self.ptrs[:, 1:] != 0


def make_count_table(probes: Sequence[torch.Tensor],
                     cands: Sequence[Sequence[torch.Tensor]],
                     ts: Tuple[int, int],
                     c_tier: Optional[int] = None) -> CountTable:
    """Pack a bucket: B probe mirrors and each row's candidate mirrors.

    Every probe must be a contiguous int32 (2^tp, gp) tensor and every
    candidate a contiguous int32 (2^tc, gc) one, all on one device; every
    row needs at least one candidate.  Only the first probe and the first
    candidate are checked: the rest must match them, as the mirrors of one
    bucket signature do (``DeviceSet`` makes every mirror contiguous int32
    on its device, and ``_count_signature`` checks the shape classes).
    ``c_tier`` (default: the longest row) is the table's candidate width.
    The table is built on the host and copied to a CUDA device from pinned
    memory without blocking.
    """
    tp, tc = (int(t) for t in ts)
    if not len(probes) or len(probes) != len(cands):
        raise ValueError(f"{len(probes)} probes for {len(cands)} candidate rows")
    width = max(len(row) for row in cands)
    C = width if c_tier is None else int(c_tier)
    if min(len(row) for row in cands) < 1 or C < width:
        raise ValueError(f"rows of {[len(r) for r in cands]} candidates "
                         f"for c_tier {C}")
    dev = probes[0].device
    for x, t in ((probes[0], tp), (cands[0][0], tc)):
        if x.dtype != torch.int32 or x.device != dev or not x.is_contiguous() \
                or x.dim() != 2 or x.shape[0] != 1 << t:
            raise ValueError(f"mirror {tuple(x.shape)} {x.dtype} on {x.device}"
                             f": need a contiguous int32 (2^{t}, g) on {dev}")
    ptrs = np.zeros((len(probes), 1 + C), dtype=np.int64)
    for b, (probe, row) in enumerate(zip(probes, cands)):
        ptrs[b, :1 + len(row)] = [x.data_ptr() for x in (probe, *row)]
    table = torch.from_numpy(ptrs)
    if dev.type == "cuda":
        table = table.pin_memory().to(dev, non_blocking=True)
    return CountTable(probes=list(probes), cands=[list(r) for r in cands],
                      ts=(tp, tc), ptrs=table)


def count_block_cuda(table: CountTable) -> torch.Tensor:
    """A bucket's (B, c_tier) int32 counts on the card; padding slots count
    0.  Launches on the current stream without synchronizing.  Raises if
    the table is not on a CUDA device, is not int64, or the launch fails
    (``make_count_table`` has checked the bucket's dtype, device and
    shapes).  ``count_block_cuda.launches`` counts launches.
    """
    ptrs = table.ptrs
    if not ptrs.is_cuda:
        raise ValueError("count_block_cuda takes a table on a CUDA device; "
                         "use kernels.ops.count_block for CPU mirrors")
    if ptrs.dtype != torch.int64 or not ptrs.is_contiguous():
        raise TypeError(f"pointer table must be contiguous int64, got "
                        f"{ptrs.dtype}")
    B, C = ptrs.shape[0], table.c_tier
    tp, tc = table.ts
    gp, gc = table.probes[0].shape[-1], table.cands[0][0].shape[-1]
    out = torch.zeros((B, C), dtype=torch.int32, device=ptrs.device)
    with torch.cuda.device(ptrs.device):
        stream = torch.cuda.current_stream(ptrs.device).cuda_stream
        rc = _build.library().repro_pair_count(
            ptrs.data_ptr(), out.data_ptr(), B, C, tp, tc, gp, gc, stream)
    _build.check(rc, "pair_count")
    count_block_cuda.launches += 1
    return out


count_block_cuda.launches = 0
