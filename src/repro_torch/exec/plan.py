"""Query planner: normalize a raw query into a shape-keyed QueryPlan.

A query arrives as a bag of terms.  Planning does, in order:

  1. **Normalize** — drop duplicate terms (``[t, t]`` is ``[t]``), resolve
     terms against the index, and sort the survivors by ``(t, n, term)`` so
     prefix alignment (ascending t) and the base-set choice (smallest set
     first) are deterministic.
  2. **Algorithm selection** — the paper's §3.4 online policy: two sets with
     an extreme size ratio go to HashBin on the host; everything else runs
     RanGroupScan on the device.
  3. **Shape signature** — device-bound plans are keyed by
     ``ShapeSig(k, ts, gmaxes, capacity_tier)``.  Two queries with the same
     signature stack into the same ``(B, …)`` pass.

The planner reads only per-set metadata (``t``, ``gmax``, ``n``), so it works
the same over host ``PrefixIndex`` objects and device ``DeviceSet`` mirrors,
and it equals the JAX package's planner on flat conjunctions.

:func:`plan_suggest` plans the count-only suggestion path: one probe against
one ``(t, gmax_tier)`` class of candidates, keyed by a signature with
``cands > 0``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

from ..core.engine import (
    default_capacity, default_k_tier, gmax_tier, set_sort_key,
)
from .adaptive import adaptive_key_parts

__all__ = ["ShapeSig", "QueryPlan", "plan_query", "plan_suggest"]


@dataclasses.dataclass(frozen=True)
class ShapeSig:
    """Static shape signature of a device pass — the bucketing key.

    ``cands`` is 0 for point queries and the power-of-two candidate-axis
    tier (> 0) for count-only suggest plans.  For those, ``ts`` / ``gmaxes``
    are the ``(probe, candidate class)`` pair in that order (the alignment
    is direction-aware) and ``capacity_tier`` holds the top-K selection
    tier (``core.engine.default_k_tier``): the count path has no survivor
    buffer.
    """

    k: int
    ts: Tuple[int, ...]
    gmaxes: Tuple[int, ...]
    capacity_tier: int
    cands: int = 0


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A normalized, routed query.

    ``terms`` are deduped and (t, n, term)-sorted; ``algorithm`` is one of
    ``"device"`` (bucketed batch path), ``"hashbin"`` / ``"host"`` (host
    execution), or ``"empty"`` (a term has no postings).  ``sig`` is set iff
    ``algorithm == "device"``.
    """

    terms: Tuple
    algorithm: str
    sig: Optional[ShapeSig] = None

    def cache_key(self) -> Tuple[str, Tuple]:
        """Result-cache key: every surface form of one conjunction (``[a,
        b]``, ``[b, a]``, ``[a, a, b]``) normalizes to the same ``terms``.
        The routing algorithm is part of the key so an entry never outlives
        a routing change.  Suggest plans key apart, with their selection
        tier, so ``suggest(id, 8)`` never serves ``suggest(id, 64)``."""
        if self.sig is not None and self.sig.cands:
            return ("suggest", (self.terms, self.sig.capacity_tier))
        return (self.algorithm, self.terms)

    def query_spec(self):
        """What to re-plan to reproduce this plan: the flat term list.  The
        async flusher re-plans it at dispatch to find plans an index
        mutation made stale."""
        return list(self.terms)


def plan_query(
    index: Mapping,
    terms: Sequence,
    hashbin_ratio: float = 100.0,
    capacity_model=None,
) -> QueryPlan:
    """Plan one query against ``index`` (term -> set with .t/.gmax/.n).

    Pure metadata work: touches no arrays and runs no device code.  For
    device-routed plans ``sig.gmaxes`` are power-of-two tiers and
    ``sig.capacity_tier`` is ``default_capacity(ts)``, the static shapes
    the executor will stack; with a ``capacity_model``
    (``exec.adaptive.CapacityModel``) it is the model's learned tier for
    the signature's adaptive key, the static rule while the key is cold.
    """
    uniq = []
    seen = set()
    for term in terms:
        if term in seen:
            continue
        seen.add(term)
        uniq.append(term)
    if not uniq or any(t not in index for t in uniq):
        return QueryPlan(terms=tuple(uniq), algorithm="empty")
    # the shared (t, n) set ordering, with the term itself as a final
    # tie-break so equal-(t, n) sets still order deterministically
    uniq.sort(key=lambda t: (*set_sort_key(index[t]), t))
    ns = [index[t].n for t in uniq]
    if len(uniq) == 2 and max(ns) / max(1, min(ns)) > hashbin_ratio:
        return QueryPlan(terms=tuple(uniq), algorithm="hashbin")
    ts = tuple(index[t].t for t in uniq)
    gmaxes = tuple(gmax_tier(index[t].gmax) for t in uniq)
    capacity = default_capacity(ts)
    if capacity_model is not None:
        capacity = capacity_model.capacity_for(
            adaptive_key_parts(len(uniq), ts, gmaxes, 1), capacity)
    sig = ShapeSig(k=len(uniq), ts=ts, gmaxes=gmaxes, capacity_tier=capacity)
    return QueryPlan(terms=tuple(uniq), algorithm="device", sig=sig)


def plan_suggest(
    index: Mapping,
    probe,
    candidates: Sequence,
    k: int,
    device: bool = True,
) -> QueryPlan:
    """Plan one count-only suggest bucket row: ``probe`` scored against a
    class of ``candidates`` that share one ``(t, gmax_tier)`` shape (a
    bucket's count pass needs uniform candidate shapes; the serving layer
    splits a request's candidates into classes and merges their top lists).

    ``terms`` are ``(probe, *candidates)`` with the candidates deduped and
    sorted ascending — the tie-break contract: equal counts prefer the
    lowest slot, so the smallest id wins.  ``sig.ts`` / ``sig.gmaxes`` are
    the ``(probe, candidate)`` pair, ``sig.cands`` the pow2 candidate-axis
    tier and ``sig.capacity_tier`` the pow2 top-K selection tier.  An
    unknown probe or candidate, or no candidates, plans ``"empty"``;
    ``device=False`` plans ``"host"``.  Mixed candidate classes raise
    ``ValueError``.
    """
    if probe not in index or not candidates:
        return QueryPlan(terms=(probe, *candidates), algorithm="empty")
    cands = sorted(set(candidates))
    if any(c not in index for c in cands):
        return QueryPlan(terms=(probe, *cands), algorithm="empty")
    tp, gp = index[probe].t, gmax_tier(index[probe].gmax)
    tc, gc = index[cands[0]].t, gmax_tier(index[cands[0]].gmax)
    for c in cands[1:]:
        if (index[c].t, gmax_tier(index[c].gmax)) != (tc, gc):
            raise ValueError("plan_suggest candidates must share one "
                             "(t, gmax_tier) class")
    if not device:
        return QueryPlan(terms=(probe, *cands), algorithm="host")
    sig = ShapeSig(
        k=2, ts=(tp, tc), gmaxes=(gp, gc),
        capacity_tier=default_k_tier(k),
        cands=1 << max(0, (len(cands) - 1).bit_length()),
    )
    return QueryPlan(terms=(probe, *cands), algorithm="device", sig=sig)
