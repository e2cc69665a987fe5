"""Router over the kernels, keyed on the tensor's device.

A CUDA tensor launches the hand-written kernel (and raises if it cannot);
a CPU tensor takes the plain PyTorch version.  Nothing falls back: the
plain version runs only for a tensor that already lies on the CPU.  Under
``launch.op_analysis.record`` each call is one kernel entry of the op log,
on either route.

The vocab-mask functions of constrained decoding were never kernels (plain
``jnp`` in the JAX package) and are torch ops on any device.  Their packed
words are int32 bit patterns of the JAX package's uint32 words (torch has
no ``>>`` for uint32 on the CPU), as ``kernels/setops.py`` keeps its keys:
``words.numpy().view(np.uint32)`` gives JAX's words.
"""
from __future__ import annotations

import torch

from ..launch import op_analysis
from . import ref
from .bitmap_filter import bitmap_filter_cuda
from .compact import compact_rows_cuda
from .count import CountTable, count_block_cuda
from .group_intersect import group_match_cuda

__all__ = ["bitmap_filter", "compact_rows", "count_block", "group_match",
           "pack_vocab_mask", "unpack_vocab_mask", "vocab_mask_and"]


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for tensors on {t.device}")
    return t.device.type


def bitmap_filter(images: torch.Tensor) -> torch.Tensor:
    """(k, G, m, W) stacked int32 images -> (G,) survivor mask (bool); a
    leading batch axis — (B, k, G, m, W) -> (B, G) — runs B queries of one
    shape in one call."""
    with op_analysis.kernel("bitmap_filter", images) as outs:
        if _route(images) == "cuda":
            outs.append(bitmap_filter_cuda(images))
        else:
            outs.append(ref.bitmap_filter_ref(images))
    return outs[0]


def group_match(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """(S, ga), (S, gb) sentinel-padded int32 -> (S, ga) membership mask
    (bool); leading batch axis supported: (B, S, ga) x (B, S, gb)."""
    with op_analysis.kernel("group_match", a_vals, b_vals) as outs:
        if _route(a_vals) == "cuda":
            outs.append(group_match_cuda(a_vals, b_vals))
        else:
            outs.append(ref.group_match_ref(a_vals, b_vals))
    return outs[0]


def compact_rows(packed: torch.Tensor, take: torch.Tensor):
    """(B, ...) int32 rows (-1 = dropped) and a (B,) bool take flag ->
    (values, offsets): row b's kept values in position order at
    ``values[offsets[b]:offsets[b + 1]]``, empty where ``take[b]`` is False;
    ``offsets`` (B + 1,) int64.  On the card ``values`` is allocated at its
    worst case and holds nothing past ``offsets[B]``."""
    with op_analysis.kernel("compact_rows", packed, take) as outs:
        if _route(packed) == "cuda":
            outs.extend(compact_rows_cuda(packed, take))
        else:
            outs.extend(ref.compact_rows_ref(packed, take))
    return outs[0], outs[1]


def count_block(table: CountTable) -> torch.Tensor:
    """A packed suggest bucket (``kernels.count.make_count_table``) ->
    (B, c_tier) int32 intersection counts of every probe with each of its
    candidates; padding slots count 0."""
    mirrors = [*table.probes, *(c for row in table.cands for c in row)]
    with op_analysis.kernel("pair_count", table.ptrs, *mirrors) as outs:
        if _route(table.ptrs) == "cuda":
            outs.append(count_block_cuda(table))
        else:
            outs.append(ref.count_block_ref(table.probes, table.cands,
                                            table.ts, c_tier=table.c_tier))
    return outs[0]


def vocab_mask_and(masks: torch.Tensor) -> torch.Tensor:
    """Constrained-decoding mask intersection: (k, ceil(V/32)) int32 packed
    allowed-token bitmaps -> (ceil(V/32),) packed AND.

    Algorithm 2 line 1 at vocabulary scale: one group of size V, word
    representation of width V bits, in the same packed-lane layout as the
    filter's images.
    """
    out = masks[0]
    for i in range(1, masks.shape[0]):
        out = out & masks[i]
    return out


def unpack_vocab_mask(packed: torch.Tensor, vocab: int) -> torch.Tensor:
    """(ceil(V/32),) packed int32 -> (V,) bool allowed mask (lowest bit
    first).  The shift is arithmetic, so a word with bit 31 set (negative)
    still yields each bit after ``& 1``."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[:vocab].to(torch.bool)


def pack_vocab_mask(allowed: torch.Tensor) -> torch.Tensor:
    """(V,) bool -> (ceil(V/32),) packed int32 (the uint32 word's bits)."""
    v = allowed.shape[0]
    vp = -(-v // 32) * 32
    a = torch.nn.functional.pad(allowed.to(torch.int64), (0, vp - v))
    shifts = torch.arange(32, dtype=torch.int64, device=allowed.device)
    words = (a.reshape(-1, 32) << shifts).sum(dim=1)   # in [0, 2^32)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)
