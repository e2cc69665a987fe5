"""Query planner: normalize a raw query into a shape-keyed QueryPlan.

A query arrives as a bag of terms, an ``exec.expr.Expr`` over ∩/∪/∖, or
a ``exec.expr.parse`` string (``"(1|2)&3-4"``).  Planning a bag of terms
does, in order:

  1. **Normalize** — drop duplicate terms (``[t, t]`` is ``[t]``), resolve
     terms against the index, and sort the survivors by ``(t, n, term)`` so
     prefix alignment (ascending t) and the base-set choice (smallest set
     first) are deterministic.
  2. **Algorithm selection** — the paper's §3.4 online policy: two sets with
     an extreme size ratio go to HashBin on the host; everything else runs
     RanGroupScan on the device.
  3. **Shape signature** — device-bound plans are keyed by
     ``ShapeSig(k, ts, gmaxes, capacity_tier, shards, replicas)``.  Two
     queries with the same signature stack into the same ``(B, …)`` pass.
  4. **Mesh routing** — with a mesh attached (``mesh_shards > 1`` or
     ``mesh_replicas > 1``), a query whose largest set has ``2^t_k >=
     shard_min_g`` group tuples and whose smallest set splits evenly over
     the shards (``2^t_0 % mesh_shards == 0``, the alignment
     precondition) gets ``sig.shards = mesh_shards`` and ``sig.replicas =
     mesh_replicas`` and runs on the mesh; smaller queries stay on one
     device (on a topology of several replicas the executor places their
     buckets on a replica row, which is placement, not shape).

An expression is canonicalized first (``exec.expr.canonicalize``).  One that
normalizes to a bare conjunction (``a & b``, ``(a&b)&a``) plans exactly as
its term list; any other becomes a device plan with ``sig.eshape`` set and
``plan.expr`` holding the canonical DAG.

The planner reads only per-set metadata (``t``, ``gmax``, ``n``), so it works
the same over host ``PrefixIndex`` objects and device ``DeviceSet`` mirrors,
and it equals the JAX package's device planner.

:func:`plan_suggest` plans the count-only suggestion path: one probe against
one ``(t, gmax_tier)`` class of candidates, keyed by a signature with
``cands > 0``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

from ..core.engine import (
    SHARD_MIN_G, default_capacity, default_expr_capacity, default_k_tier,
    gmax_tier, set_sort_key,
)
from .adaptive import adaptive_key_parts
from .expr import (
    EMPTY, Expr, canonicalize, expr_key, expr_shape, flat_terms, leaf_terms,
    parse,
)

__all__ = ["SHARD_MIN_G", "ShapeSig", "QueryPlan", "plan_query",
           "plan_suggest"]


@dataclasses.dataclass(frozen=True)
class ShapeSig:
    """Static shape signature of a device pass — the bucketing key.

    ``shards`` is 1 for single-device buckets and the z-axis width for
    mesh-routed ones; ``replicas`` is 1 except on a 2-D topology, where a
    mesh-routed bucket splits its batch axis over that many rows.  Both
    key the signature: each layout is its own pass.

    ``cands`` is 0 for point queries and the power-of-two candidate-axis
    tier (> 0) for count-only suggest plans.  For those, ``ts`` / ``gmaxes``
    are the ``(probe, candidate class)`` pair in that order (the alignment
    is direction-aware) and ``capacity_tier`` holds the top-K selection
    tier (``core.engine.default_k_tier``): the count path has no survivor
    buffer.

    ``eshape`` is ``None`` for flat conjunctions (their signatures are
    unchanged) and the leaf-erased expression shape
    (``exec.expr.expr_shape``) for expression plans, whose ``ts`` /
    ``gmaxes`` follow the expression's leaf traversal order, unsorted.
    """

    k: int
    ts: Tuple[int, ...]
    gmaxes: Tuple[int, ...]
    capacity_tier: int
    shards: int = 1
    replicas: int = 1
    cands: int = 0
    eshape: Optional[Tuple] = None


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A normalized, routed query.

    ``terms`` are deduped and (t, n, term)-sorted for flat conjunctions,
    and the canonical expression's leaf terms (traversal order, with
    repeats) when ``expr`` is set; ``algorithm`` is one of ``"device"``
    (bucketed batch path), ``"hashbin"`` / ``"host"`` (host execution), or
    ``"empty"`` (a term has no postings, or the expression canonicalizes
    to ∅).  ``sig`` is set iff ``algorithm == "device"``.  ``expr`` is the
    canonical :class:`~repro_torch.exec.expr.Expr` of an expression plan,
    ``None`` for flat conjunctions (and for expressions that normalize to
    one).
    """

    terms: Tuple
    algorithm: str
    sig: Optional[ShapeSig] = None
    expr: Optional[Expr] = None

    def cache_key(self) -> Tuple[str, Tuple]:
        """Result-cache key: every surface form of one conjunction (``[a,
        b]``, ``[b, a]``, ``[a, a, b]``) normalizes to the same ``terms``,
        and expression plans key on ``expr_key`` of the canonical
        expression, so ``(b|a)&c`` and ``c&(a|b)`` share an entry.  The
        routing algorithm is part of the key so an entry never outlives a
        routing change.  Suggest plans key apart, with their selection
        tier, so ``suggest(id, 8)`` never serves ``suggest(id, 64)``."""
        if self.sig is not None and self.sig.cands:
            return ("suggest", (self.terms, self.sig.capacity_tier))
        if self.expr is not None:
            return (self.algorithm, expr_key(self.expr))
        return (self.algorithm, self.terms)

    def query_spec(self):
        """What to re-plan to reproduce this plan: the canonical expression
        when one is set, else the flat term list.  The async flusher
        re-plans it at dispatch to find plans an index mutation made
        stale."""
        return self.expr if self.expr is not None else list(self.terms)


def _mesh_layout(mesh_shards: int, mesh_replicas: int, shard_min_g: int,
                 deepest: int, ts: Sequence[int]) -> Tuple[int, int]:
    """(shards, replicas) of a plan: the mesh's when one is attached, the
    largest set has at least ``shard_min_g`` group tuples and every set in
    ``ts`` splits evenly over the shards; else (1, 1)."""
    if ((mesh_shards > 1 or mesh_replicas > 1)
            and (1 << deepest) >= shard_min_g
            and all((1 << t) % mesh_shards == 0 for t in ts)):
        return mesh_shards, mesh_replicas
    return 1, 1


def plan_query(
    index: Mapping,
    terms,
    hashbin_ratio: float = 100.0,
    capacity_model=None,
    mesh_shards: int = 1,
    mesh_replicas: int = 1,
    shard_min_g: int = SHARD_MIN_G,
    device: bool = True,
) -> QueryPlan:
    """Plan one query against ``index`` (term -> set with .t/.gmax/.n).

    ``terms`` is a term sequence (a flat conjunction), an
    :class:`~repro_torch.exec.expr.Expr` or a
    :func:`~repro_torch.exec.expr.parse` string.  Pure metadata work:
    touches no arrays and runs no device code.  For device-routed plans
    ``sig.gmaxes`` are power-of-two tiers and ``sig.capacity_tier`` is
    ``default_capacity(ts)`` (``default_expr_capacity(ts, gmaxes)`` for an
    expression), the static shapes the executor will stack; with a
    ``capacity_model`` (``exec.adaptive.CapacityModel``) it is the model's
    learned tier for the signature's adaptive key, the static rule while
    the key is cold.  With ``mesh_shards > 1`` and/or ``mesh_replicas >
    1`` (the mesh's z-axis width and, on a 2-D topology, its replica
    rows), a query whose largest set has ``2^t_k >= shard_min_g`` group
    tuples and whose sets split over the shards is stamped with both and
    runs on the mesh.  With ``device=False`` (an engine without a device)
    a conjunction the §3.4 policy does not send to HashBin plans
    ``"host"`` (RanGroupScan on the host), and an expression plans
    ``"host"`` with its canonical ``expr`` (evaluated on the host).
    """
    if isinstance(terms, str):
        terms = parse(terms)
    if isinstance(terms, Expr):
        return _plan_expr(index, terms, hashbin_ratio=hashbin_ratio,
                          capacity_model=capacity_model,
                          mesh_shards=mesh_shards,
                          mesh_replicas=mesh_replicas,
                          shard_min_g=shard_min_g, device=device)
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
    if not device:
        return QueryPlan(terms=tuple(uniq), algorithm="host")
    ts = tuple(index[t].t for t in uniq)
    gmaxes = tuple(gmax_tier(index[t].gmax) for t in uniq)
    # sets are t-ascending: the smallest splits iff every one does
    shards, replicas = _mesh_layout(mesh_shards, mesh_replicas, shard_min_g,
                                    ts[-1], ts[:1])
    capacity = default_capacity(ts)
    if capacity_model is not None:
        capacity = capacity_model.capacity_for(
            adaptive_key_parts(len(uniq), ts, gmaxes, shards,
                               replicas=replicas), capacity)
    sig = ShapeSig(k=len(uniq), ts=ts, gmaxes=gmaxes, capacity_tier=capacity,
                   shards=shards, replicas=replicas)
    return QueryPlan(terms=tuple(uniq), algorithm="device", sig=sig)


def _plan_expr(index: Mapping, raw: Expr, hashbin_ratio: float,
               capacity_model, mesh_shards: int, mesh_replicas: int,
               shard_min_g: int, device: bool) -> QueryPlan:
    """Expression arm of :func:`plan_query`.  Canonicalization runs against
    the index (unknown terms become ∅ and propagate), so every leaf of a
    plan resolves.  The §3.4 HashBin policy never applies to an expression
    (it is a two-term conjunction rule).  Mesh routing holds every leaf to
    the split rule (each leaf's z axis splits on its own) and gates on the
    largest leaf."""
    can = canonicalize(raw, index)
    if can is EMPTY:
        return QueryPlan(terms=(), algorithm="empty")
    flat = flat_terms(can)
    if flat is not None:
        # a bare conjunction after normalization: plan the term list, so
        # the plan (and its cache entry) equals the term list's
        return plan_query(index, list(flat), hashbin_ratio=hashbin_ratio,
                          capacity_model=capacity_model,
                          mesh_shards=mesh_shards,
                          mesh_replicas=mesh_replicas,
                          shard_min_g=shard_min_g, device=device)
    leaves = leaf_terms(can)
    if not device:
        return QueryPlan(terms=leaves, algorithm="host", expr=can)
    ts = tuple(index[t].t for t in leaves)
    gmaxes = tuple(gmax_tier(index[t].gmax) for t in leaves)
    eshape = expr_shape(can)
    shards, replicas = _mesh_layout(mesh_shards, mesh_replicas, shard_min_g,
                                    max(ts), ts)
    capacity = default_expr_capacity(ts, gmaxes)
    if capacity_model is not None:
        capacity = capacity_model.capacity_for(
            adaptive_key_parts(len(leaves), ts, gmaxes, shards,
                               replicas=replicas, eshape=eshape), capacity)
    sig = ShapeSig(k=len(leaves), ts=ts, gmaxes=gmaxes,
                   capacity_tier=capacity, shards=shards, replicas=replicas,
                   eshape=eshape)
    return QueryPlan(terms=leaves, algorithm="device", sig=sig, expr=can)


def plan_suggest(
    index: Mapping,
    probe,
    candidates: Sequence,
    k: int,
    device: bool = True,
    mesh_shards: int = 1,
    mesh_replicas: int = 1,
    shard_min_g: int = SHARD_MIN_G,
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
    ``ValueError``.  Mesh routing holds both the probe's and the
    candidates' z axes to the split rule and gates on the deeper of the
    two.
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
    shards, replicas = _mesh_layout(mesh_shards, mesh_replicas, shard_min_g,
                                    max(tp, tc), (tp, tc))
    sig = ShapeSig(
        k=2, ts=(tp, tc), gmaxes=(gp, gc),
        capacity_tier=default_k_tier(k), shards=shards, replicas=replicas,
        cands=1 << max(0, (len(cands) - 1).bit_length()),
    )
    return QueryPlan(terms=(probe, *cands), algorithm="device", sig=sig)
