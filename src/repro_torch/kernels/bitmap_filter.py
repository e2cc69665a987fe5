"""Phase-1 kernel wrapper: the batched word-representation AND filter
(Alg. 5 line 3) as a hand-written CUDA kernel (``csrc/bitmap_filter.cu``).

Replaces the TPU kernel ``repro.kernels.bitmap_filter.bitmap_filter_pallas``.
The CUDA source says what bounds it (bytes) and how its design answers
that.  The plain version is ``kernels.ref.bitmap_filter_ref``.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["bitmap_filter_cuda"]


def bitmap_filter_cuda(images: torch.Tensor) -> torch.Tensor:
    """(k, G, m, W) or (B, k, G, m, W) int32 CUDA images -> (G,) / (B, G)
    bool survivor mask.

    Launches on the current stream without synchronizing.  Raises on a CPU
    tensor, on another dtype than int32, on a non-contiguous tensor, on an
    empty axis, or if the launch fails.  ``bitmap_filter_cuda.launches``
    counts launches.
    """
    if not images.is_cuda:
        raise ValueError("bitmap_filter_cuda takes a CUDA tensor; "
                         "use kernels.ops.bitmap_filter for CPU tensors")
    if images.dtype != torch.int32:
        raise TypeError(f"images must be int32, got {images.dtype}")
    if images.dim() not in (4, 5):
        raise ValueError(f"images must be (B,) k, G, m, W; got {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    batched = images.dim() == 5
    x = images if batched else images.unsqueeze(0)
    B, k, G, m, W = x.shape
    if min(B, k, G, m, W) == 0:
        raise ValueError(f"empty axis in images {tuple(images.shape)}")
    out = torch.empty((B, G), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.library().repro_bitmap_filter(
            x.data_ptr(), out.data_ptr(), B, k, G, m, W, stream)
    _build.check(rc, "bitmap_filter")
    bitmap_filter_cuda.launches += 1
    mask = out.view(torch.bool)
    return mask if batched else mask[0]


bitmap_filter_cuda.launches = 0
