"""Answer compaction wrapper: a pass's kept values, row by row, into one
flat buffer with row offsets, as a hand-written CUDA kernel
(``csrc/compact_rows.cu``).

Replaces no TPU kernel: the JAX package copies the whole survivor buffer
to the host.  The CUDA source says why it was added, what bounds it
(bytes) and how its design answers that.  The plain version is
``kernels.ref.compact_rows_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["compact_rows_cuda"]


def compact_rows_cuda(packed: torch.Tensor, take: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, ...) int32 CUDA rows (-1 = dropped) and a (B,) bool take flag ->
    (values, offsets): row b's values other than -1, in position order, at
    ``values[offsets[b]:offsets[b + 1]]`` (an empty slice where ``take[b]``
    is False), ``offsets`` (B + 1,) int64.

    ``values`` is allocated at its worst case, every value of every row,
    so the launch never waits to learn the total; past ``offsets[B]`` it
    holds nothing.  Launches on the current stream without synchronizing.
    Raises on CPU tensors, another dtype than int32 / bool, a
    non-contiguous tensor, mismatched or empty shapes, or a failed launch.
    ``compact_rows_cuda.launches`` counts launches.
    """
    if not (packed.is_cuda and take.is_cuda):
        raise ValueError("compact_rows_cuda takes CUDA tensors; "
                         "use kernels.ops.compact_rows for CPU tensors")
    if packed.device != take.device:
        raise ValueError(f"rows on {packed.device}, take on {take.device}")
    if packed.dtype != torch.int32 or take.dtype != torch.bool:
        raise TypeError(f"need int32 rows and a bool take flag, got "
                        f"{packed.dtype}, {take.dtype}")
    if packed.dim() < 2 or take.shape != packed.shape[:1]:
        raise ValueError(f"mismatched rows {tuple(packed.shape)} and take "
                         f"{tuple(take.shape)}")
    if not (packed.is_contiguous() and take.is_contiguous()):
        raise ValueError("rows and take must be contiguous")
    B = packed.shape[0]
    L = packed[0].numel() if B else 0
    if min(B, L) == 0:
        raise ValueError(f"empty axis in rows {tuple(packed.shape)}")
    lib = _build.library()
    values = torch.empty(B * L, dtype=torch.int32, device=packed.device)
    offsets = torch.empty(B + 1, dtype=torch.int64, device=packed.device)
    scratch = torch.empty(lib.repro_compact_rows_scratch(B, L),
                          dtype=torch.int64, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = lib.repro_compact_rows(
            packed.data_ptr(), take.data_ptr(), values.data_ptr(),
            offsets.data_ptr(), scratch.data_ptr(), B, L, stream)
    _build.check(rc, "compact_rows")
    compact_rows_cuda.launches += 1
    return values, offsets


compact_rows_cuda.launches = 0
