"""Plain PyTorch versions of the kernels.

They define the semantics the CUDA kernels must match bit for bit, and they
are the CPU path: the router (``kernels.ops``) sends CPU tensors here.  The
arithmetic is that of the JAX package's ``repro.kernels.ref``,
``repro.kernels.count.pair_count_ref`` and ``repro.core.engine._count_block``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

SENTINEL32 = -1  # 0xFFFFFFFF viewed as int32 — padding sentinel
# the (B, Cc, G, ga, gb) compare tensor count_block_ref makes per chunk
COUNT_CHUNK_BYTES = 1 << 30


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


def compact_rows_ref(packed: torch.Tensor, take: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pass's answers compacted: every value other than -1 of every taken
    row, in row-major position order.

    Args:
      packed: (B, ...) int32 — each row's values, -1 where dropped.
      take: (B,) bool — False for a row whose answer is not wanted (an
        overflow row that is re-run).

    Returns:
      (values, offsets): ``values`` (offsets[B],) int32, row b's slice
      ``values[offsets[b]:offsets[b + 1]]`` is ``row[row != -1]`` (empty
      where ``take[b]`` is False); ``offsets`` (B + 1,) int64, the exclusive
      scan of the rows' kept counts.
    """
    rows = packed.reshape(packed.shape[0], -1)
    keep = (rows != SENTINEL32) & take[:, None]
    offsets = torch.nn.functional.pad(keep.sum(dim=1).cumsum(dim=0), (1, 0))
    return rows[keep], offsets


def pair_count_ref(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """Per-row count of real ``a`` elements present in ``b``.

    Args:
      a_vals: (..., S, ga) int32, sentinel-padded (-1) groups.
      b_vals: (..., S, gb) int32, the aligned groups of the other set.

    Returns:
      (..., S) int32 — exact |a ∩ b| per row when each row's real elements
      are duplicate-free (group rows of a preprocessed set always are).
    """
    eq = a_vals[..., :, None] == b_vals[..., None, :]
    hit = eq.any(dim=-1) & (a_vals != SENTINEL32)
    return hit.sum(dim=-1, dtype=torch.int32)


def _count_block_stacked(pv: torch.Tensor, cv: torch.Tensor,
                         ts: Tuple[int, int]) -> torch.Tensor:
    """(B, Gp, gp) probes x (B, C, Gc, gc) candidates -> (B, C) counts,
    with the roles of ``_count_block``: the deeper set supplies the G
    iterated tuples (``a``), the shallower set's row ``z >> |tp - tc|`` is
    gathered against each (``b``)."""
    tp, tc = ts
    B, C = cv.shape[:2]
    if tp >= tc:
        G = pv.shape[1]
        a = pv[:, None].expand((B, C) + pv.shape[1:])
        if tp == tc:
            b = cv
        else:
            idx = torch.arange(G, device=pv.device) >> (tp - tc)
            b = cv[:, :, idx]
    else:
        G = cv.shape[2]
        idx = torch.arange(G, device=pv.device) >> (tc - tp)
        a = cv
        b = pv[:, idx][:, None].expand(B, C, G, pv.shape[-1])
    return pair_count_ref(a, b).sum(dim=-1, dtype=torch.int32)


def count_block_ref(probes: Sequence[torch.Tensor],
                    cands: Sequence[Sequence[torch.Tensor]],
                    ts: Tuple[int, int],
                    c_tier: Optional[int] = None) -> torch.Tensor:
    """A bucket's (B, c_tier) intersection counts: row b's probe mirror
    ``probes[b]`` (2^tp, gp) against each of its candidate mirrors
    ``cands[b][c]`` (2^tc, gc).  Slots at or past ``len(cands[b])`` count 0.

    The candidates are stacked ``Cc`` slots at a time (short rows padded
    with their candidate 0, whose counts are then zeroed), so the
    (B, Cc, G, ga, gb) compare tensor stays near ``COUNT_CHUNK_BYTES``.
    """
    B = len(probes)
    n_cands = [len(row) for row in cands]
    C = c_tier or max(n_cands)
    dev = probes[0].device
    pv = torch.stack(list(probes))
    g_c = cands[0][0].shape[-1]
    G = 1 << max(ts)
    chunk = max(1, COUNT_CHUNK_BYTES // (B * G * pv.shape[-1] * g_c))
    out = torch.zeros((B, C), dtype=torch.int32, device=dev)
    for c0 in range(0, max(n_cands), chunk):
        c1 = min(C, c0 + chunk)
        cv = torch.stack([
            torch.stack([row[c] if c < len(row) else row[0]
                         for c in range(c0, c1)])
            for row in cands])
        out[:, c0:c1] = _count_block_stacked(pv, cv, ts)
    slot = torch.arange(C, device=dev)
    real = slot[None, :] < torch.tensor(n_cands, device=dev)[:, None]
    return torch.where(real, out, 0)
