"""Phase-2 kernel wrapper: all-pairs match of the survivor groups as a
hand-written CUDA kernel (``csrc/group_match.cu``).

Replaces the TPU kernel ``repro.kernels.group_intersect.group_match_pallas``.
The CUDA source says what bounds it and how its design answers that.  The
plain version is ``kernels.ref.group_match_ref``.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["group_match_cuda"]


def group_match_cuda(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """(S, ga) x (S, gb) int32 CUDA rows -> (S, ga) bool membership.

    A leading batch axis ((B, S, ga) x (B, S, gb) -> (B, S, ga)) folds onto
    the rows: every row is an independent tuple.  Launches on the current
    stream without synchronizing.  Raises on CPU tensors, another dtype than
    int32, non-contiguous or mismatched shapes, or a failed launch.
    ``group_match_cuda.launches`` counts launches.
    """
    if not (a_vals.is_cuda and b_vals.is_cuda):
        raise ValueError("group_match_cuda takes CUDA tensors; "
                         "use kernels.ops.group_match for CPU tensors")
    if a_vals.device != b_vals.device:
        raise ValueError(f"a on {a_vals.device}, b on {b_vals.device}")
    if a_vals.dtype != torch.int32 or b_vals.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {a_vals.dtype}, {b_vals.dtype}")
    if a_vals.dim() not in (2, 3) or a_vals.shape[:-1] != b_vals.shape[:-1] \
            or a_vals.dim() != b_vals.dim():
        raise ValueError(f"mismatched rows {tuple(a_vals.shape)} x "
                         f"{tuple(b_vals.shape)}")
    if not (a_vals.is_contiguous() and b_vals.is_contiguous()):
        raise ValueError("rows must be contiguous")
    ga, gb = a_vals.shape[-1], b_vals.shape[-1]
    S = a_vals.numel() // ga if ga else 0
    if min(S, ga, gb) == 0:
        raise ValueError(f"empty axis in {tuple(a_vals.shape)} x "
                         f"{tuple(b_vals.shape)}")
    out = torch.empty(a_vals.shape, dtype=torch.uint8, device=a_vals.device)
    with torch.cuda.device(a_vals.device):
        stream = torch.cuda.current_stream(a_vals.device).cuda_stream
        rc = _build.library().repro_group_match(
            a_vals.data_ptr(), b_vals.data_ptr(), out.data_ptr(), S, ga, gb,
            stream)
    _build.check(rc, "group_match")
    group_match_cuda.launches += 1
    return out.view(torch.bool)


group_match_cuda.launches = 0
