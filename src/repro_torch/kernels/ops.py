"""Router over the kernels, keyed on the tensor's device.

A CUDA tensor launches the hand-written kernel (and raises if it cannot);
a CPU tensor takes the plain PyTorch version.  Nothing falls back: the
plain version runs only for a tensor that already lies on the CPU.
"""
from __future__ import annotations

import torch

from . import ref
from .bitmap_filter import bitmap_filter_cuda
from .count import CountTable, count_block_cuda
from .group_intersect import group_match_cuda

__all__ = ["bitmap_filter", "count_block", "group_match"]


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for tensors on {t.device}")
    return t.device.type


def bitmap_filter(images: torch.Tensor) -> torch.Tensor:
    """(k, G, m, W) stacked int32 images -> (G,) survivor mask (bool); a
    leading batch axis — (B, k, G, m, W) -> (B, G) — runs B queries of one
    shape in one call."""
    if _route(images) == "cuda":
        return bitmap_filter_cuda(images)
    return ref.bitmap_filter_ref(images)


def group_match(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """(S, ga), (S, gb) sentinel-padded int32 -> (S, ga) membership mask
    (bool); leading batch axis supported: (B, S, ga) x (B, S, gb)."""
    if _route(a_vals) == "cuda":
        return group_match_cuda(a_vals, b_vals)
    return ref.group_match_ref(a_vals, b_vals)


def count_block(table: CountTable) -> torch.Tensor:
    """A packed suggest bucket (``kernels.count.make_count_table``) ->
    (B, c_tier) int32 intersection counts of every probe with each of its
    candidates; padding slots count 0."""
    if _route(table.ptrs) == "cuda":
        return count_block_cuda(table)
    return ref.count_block_ref(table.probes, table.cands, table.ts,
                               c_tier=table.c_tier)
