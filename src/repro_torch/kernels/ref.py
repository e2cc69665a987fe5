"""Plain PyTorch versions of the two kernels.

They define the semantics the CUDA kernels must match bit for bit, and they
are the CPU path: the router (``kernels.ops``) sends CPU tensors here.  The
arithmetic is that of the JAX package's ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

SENTINEL32 = -1  # 0xFFFFFFFF viewed as int32 — padding sentinel


def bitmap_filter_ref(images: torch.Tensor) -> torch.Tensor:
    """Word-representation AND filter (Alg. 5 line 3), batched over groups.

    Args:
      images: (k, G, m, W) or (B, k, G, m, W) int32 — for each of the k sets,
        the m packed hash images of the group aligned to each of the G
        tuples; an optional leading batch axis runs B independent queries.

    Returns:
      (G,) / (B, G) bool — True where the tuple SURVIVES the filter, i.e. for
      every j in [m] the k-way AND of the j-th images is non-zero.
    """
    k_axis = images.dim() - 4                   # 0 unbatched, 1 batched
    h = images.select(k_axis, 0)
    for i in range(1, images.shape[k_axis]):
        h = h & images.select(k_axis, i)        # (..., G, m, W)
    nonzero = (h != 0).any(dim=-1)              # (..., G, m)
    return nonzero.all(dim=-1)                  # (..., G)


def group_match_ref(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """All-pairs small-group intersection: which elements of ``a`` occur in
    ``b``.

    Args:
      a_vals: (S, ga) int32 — survivor groups of set A, sentinel-padded (-1).
      b_vals: (S, gb) int32 — aligned survivor groups of set B.
        Both accept an optional leading batch axis: (B, S, ga) x (B, S, gb).

    Returns:
      (S, ga) / (B, S, ga) bool — True where a real element of ``a`` is
      present in ``b``.  The ``a != -1`` mask keeps padding of ``a`` from
      matching padding of ``b``.
    """
    eq = a_vals[..., :, None] == b_vals[..., None, :]
    return eq.any(dim=-1) & (a_vals != SENTINEL32)
