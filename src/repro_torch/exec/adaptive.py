"""Telemetry-driven adaptive capacity and deadline tuning.

A copy of the JAX package's ``exec/adaptive.py`` for the port (it imports
nothing of the JAX package).  Two small controllers fed from execution
telemetry:

- :class:`CapacityModel` records a per-signature window of observed
  survivor counts (``tuples_survived`` from the bucket stats) and learns a
  per-signature capacity tier: a high quantile of the window times a
  safety margin, rounded up to a power of two and clamped to ``[floor,
  G]``.  ``plan_query`` consults it and falls back to the static G/4 rule
  while a signature is cold (fewer than ``min_observations`` samples).  A
  tier that grows counts ``adaptive_promotions``, one that shrinks
  ``adaptive_demotions``; both fire the registered change hooks (the
  serving layer invalidates its result cache and re-warms the new
  specialization).  Samples older than ``decay_s`` are pruned before the
  tier re-evaluates, so a tier inflated by a burst shrinks back.
- :class:`AdaptiveDeadline` shrinks per-signature flush budgets when the
  observed arrival rate (an EWMA of inter-arrival gaps) cannot fill a
  bucket within the default budget.

Keys: both are keyed by :func:`adaptive_key`, the signature minus its
capacity tier (the tier is the model's output).  The key tuple keeps the
JAX package's layout, ``(k, ts, gmaxes, shards, replicas, cands,
eshape)``, so learned tiers compare equal across the two packages; the
port's signatures are single-device, so shards and replicas are 1, and
``eshape`` is ``None`` for flat conjunctions.  Expression signatures learn
against the DAG's dense widths: the prior is ``default_expr_capacity``
and the ceiling ``expr_total_width``.

Thread-safety: state is lock-protected; change hooks fire outside the
lock (they re-plan and run device work).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Hashable, List, Optional, Tuple

from ..core.engine import (
    EXEC_COUNTERS, default_capacity, default_expr_capacity, expr_total_width,
)

__all__ = ["adaptive_key", "adaptive_key_parts", "CapacityModel",
           "AdaptiveDeadline"]


def adaptive_key_parts(k: int, ts: Tuple[int, ...],
                       gmaxes: Tuple[int, ...], shards: int,
                       replicas: int = 1, eshape: Optional[Tuple] = None,
                       cands: int = 0) -> Tuple:
    """THE adaptive learning key, from raw signature parts.  Single source
    of truth: the planner builds the key from parts before a ``ShapeSig``
    exists, the model builds it from the executed sig — both MUST agree or
    learned tiers are consulted under a key nothing ever writes.
    ``replicas`` (the 2-D topology's data-parallel width) is part of the
    key: mesh-routed and single-device executions of the same shapes are
    different executables, so their survivor histories must not mix.
    ``eshape`` (the leaf-erased expression shape; ``None`` for flat
    conjunctions) is part of the key for the same reason — ``(a∪b)∩c``
    and ``(a∩b)∩c`` over the same leaves have very different survivor
    distributions, and each expression shape is its own executable.
    ``cands`` (the suggest candidate-axis tier; 0 otherwise) keeps
    count-only signatures out of the point-query keyspace — they have no
    survivor buffer, so the model never learns for them, but a shared key
    would let their (absent) history shadow a real one.  ``eshape`` stays
    the LAST element (tests and telemetry tooling read ``key[-1]``), so
    ``cands`` slots in before it."""
    return (k, ts, gmaxes, shards, replicas, cands, eshape)


def adaptive_key(sig) -> Tuple:
    """The learning key of a shape signature: everything *except* the
    capacity tier (which is what the model outputs).  Accepts any object
    with ``k`` / ``ts`` / ``gmaxes`` / ``shards`` (i.e. ``ShapeSig``)."""
    return adaptive_key_parts(sig.k, sig.ts, sig.gmaxes,
                              getattr(sig, "shards", 1),
                              replicas=getattr(sig, "replicas", 1),
                              eshape=getattr(sig, "eshape", None),
                              cands=getattr(sig, "cands", 0))


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


class CapacityModel:
    """Learn per-signature survivor-buffer (capacity) tiers from telemetry.

    ``observe_bucket(sig, stats_list)`` feeds one executed bucket's
    per-query stats; ``capacity_for(key, default)`` answers the planner.
    A signature stays on ``default`` (the static G/4 rule) until
    ``min_observations`` samples accumulate — the cold-start fallback —
    then gets ``pow2_ceil(quantile * margin)`` clamped to
    ``[64, G]``.  Tiers can move in both directions: *up* to absorb
    survivors the static rule overflowed on (eliminating re-runs), *down*
    when real survivor counts sit far below G/4 (shrinking the phase-2
    all-pairs work toward the paper's E[survivors] ideal).

    Every tier *increase* counts as one ``adaptive_promotions``, every
    *decrease* as one ``adaptive_demotions``; both fire the registered
    change hooks with ``(key, old_tier, new_tier)`` — demotion is fully
    symmetric to promotion (cache invalidation, re-warming) because a
    shrunk tier is just as much a new executable as a grown one.  An
    execution whose survivors exceeded the static default but fit the
    learned tier counts as ``adaptive_overflow_saved`` (a re-run the model
    eliminated).

    Drift handling is two-fold: the histogram is a bounded window
    (``window`` most recent samples per key) AND each sample carries a
    timestamp — samples older than ``decay_s`` are pruned before every
    tier re-evaluation, so a tier inflated by a past burst demotes once
    fresh traffic shows smaller survivors, even at arrival rates too low
    to push the burst out of the count window.  A key whose pruned window
    drops below ``min_observations`` keeps its current learned tier (no
    flapping back to the static rule on a traffic lull); the next
    ``min_observations`` fresh samples re-evaluate it.
    """

    def __init__(self, min_observations: int = 32, quantile: float = 0.99,
                 margin: float = 1.25, window: int = 1024,
                 floor: int = 64, decay_s: Optional[float] = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        assert 0.0 < quantile <= 1.0 and margin >= 1.0
        assert decay_s is None or decay_s > 0.0
        self.min_observations = int(min_observations)
        self.quantile = float(quantile)
        self.margin = float(margin)
        self.window = int(window)
        self.floor = int(floor)
        self.decay_s = None if decay_s is None else float(decay_s)
        self.clock = clock
        self._lock = threading.Lock()
        # per-key deque of (timestamp, survivors) pairs
        self._survivors: Dict[Hashable, deque] = {}
        self._learned: Dict[Hashable, int] = {}
        self._hooks: List[Callable[[Hashable, int, int], None]] = []

    def on_promotion(self, hook: Callable[[Hashable, int, int], None]) -> None:
        """Register a callback fired (outside the model lock) after every
        learned-tier change — promotions AND demotions — with
        ``(key, old_tier, new_tier)``.  The serving layer hangs cache
        invalidation and re-warming here."""
        self._hooks.append(hook)

    def capacity_for(self, key: Hashable, default: int) -> int:
        """The capacity tier the planner should use for ``key``: the
        learned tier when warm, ``default`` (the static rule) when cold."""
        with self._lock:
            return self._learned.get(key, default)

    def observations(self, key: Hashable) -> int:
        with self._lock:
            window = self._survivors.get(key)
            if window is None:
                return 0
            self._prune(window, self.clock())
            return len(window)

    def learned_tiers(self) -> Dict[Hashable, int]:
        """Snapshot of every learned (non-cold) tier, for telemetry."""
        with self._lock:
            return dict(self._learned)

    @staticmethod
    def _effective_survivors(sig, stats: Dict) -> Optional[int]:
        """Whole-query-equivalent survivor count of one executed query.

        Sharded stats report ``max_shard_survivors``; the per-shard buffer
        is ``capacity_tier // n_shards``, so the binding whole-query
        requirement is ``max_shard_survivors * n_shards`` (the margin also
        covers shard imbalance).  Single-device stats report
        ``tuples_survived`` directly.
        """
        n_shards = stats.get("n_shards", 1)
        if n_shards > 1 and "max_shard_survivors" in stats:
            return int(stats["max_shard_survivors"]) * int(n_shards)
        if "tuples_survived" in stats:
            return int(stats["tuples_survived"])
        return None

    def _prune(self, window: deque, now: float) -> None:
        """Drop samples older than the decay horizon (caller holds the
        lock).  The time decay is what lets tiers *demote* after workload
        drift: without it a burst of huge survivors pins the quantile until
        sheer traffic volume pushes it out of the count window."""
        if self.decay_s is None:
            return
        horizon = now - self.decay_s
        while window and window[0][0] < horizon:
            window.popleft()

    def observe_bucket(self, sig, stats_list) -> None:
        """Feed one executed bucket's per-query stats dicts.

        Records each query's effective survivor count under
        ``adaptive_key(sig)``, credits ``adaptive_overflow_saved`` when the
        learned tier absorbed a would-be static overflow, prunes decayed
        samples, and re-evaluates the learned tier — promoting or demoting
        as the fresh window dictates.  Hooks fire after the lock is
        released.
        """
        if getattr(sig, "cands", 0):
            # count-only (suggest) buckets have no survivor buffer to size:
            # their capacity_tier is the top-K selection tier, fixed by the
            # request's k — nothing to learn, nothing to observe
            return
        key = adaptive_key(sig)
        if getattr(sig, "eshape", None) is not None:
            # expression buckets: the static prior and the hard ceiling are
            # the DAG's dense widths, not the largest leaf's group count
            static_cap = default_expr_capacity(sig.ts, sig.gmaxes)
            g = expr_total_width(sig.ts, sig.gmaxes)
        else:
            static_cap = default_capacity(sig.ts)
            g = 1 << sig.ts[-1]
        now = self.clock()
        changes: List[Tuple[Hashable, int, int]] = []
        with self._lock:
            window = self._survivors.setdefault(
                key, deque(maxlen=self.window))
            for stats in stats_list:
                surv = self._effective_survivors(sig, stats)
                if surv is None:
                    continue
                window.append((now, surv))
                if (sig.capacity_tier != static_cap
                        and static_cap < surv <= sig.capacity_tier):
                    EXEC_COUNTERS.bump("adaptive_overflow_saved")
            self._prune(window, now)
            if len(window) >= self.min_observations:
                tier = self._tier_from_window(window, g)
                old = self._learned.get(key, static_cap)
                if tier != self._learned.get(key):
                    self._learned[key] = tier
                    if tier > old:
                        EXEC_COUNTERS.bump("adaptive_promotions")
                        changes.append((key, old, tier))
                    elif tier < old:
                        EXEC_COUNTERS.bump("adaptive_demotions")
                        changes.append((key, old, tier))
        for change in changes:
            for hook in self._hooks:
                hook(*change)

    def _tier_from_window(self, window, g: int) -> int:
        """quantile * margin, power-of-two ceiling, clamped to [floor, G]."""
        ordered = sorted(surv for _, surv in window)
        idx = min(len(ordered) - 1,
                  int(round(self.quantile * (len(ordered) - 1))))
        target = int(ordered[idx] * self.margin)
        return max(self.floor, min(g, _pow2_ceil(max(1, target))))

    def telemetry(self) -> Dict[str, Dict]:
        """One consistent snapshot of the model's learned state, keyed by
        ``str(adaptive_key)`` (registry collectors and exposition want
        string keys).  Per key: live (pruned) observation count, the
        learned tier if warm, and the current survivor-window max —
        enough to see *why* a tier is what it is without holding the
        lock yourself."""
        now = self.clock()
        with self._lock:
            out: Dict[str, Dict] = {}
            for key, window in self._survivors.items():
                self._prune(window, now)
                out[str(key)] = {
                    "observations": len(window),
                    "learned_tier": self._learned.get(key),
                    "window_max": (max(s for _, s in window)
                                   if window else None),
                }
            # learned tiers whose windows fully decayed still serve plans
            for key, tier in self._learned.items():
                out.setdefault(str(key), {
                    "observations": 0, "learned_tier": tier,
                    "window_max": None,
                })
            return out


class AdaptiveDeadline:
    """Learn per-signature flush budgets from observed bucket-fill rates.

    ``observe(key, now)`` records a submission (EWMA of inter-arrival
    gaps); ``budget_for(key, default_us)`` answers the admission path.  The
    policy: the default budget is worth waiting only if batch-mates are
    likely to arrive within it.  With an observed mean gap ``g`` the
    expected number of mates inside the budget is ``default / g``; when
    that falls below 1 the budget shrinks proportionally (clamped to
    ``min_fraction * default``), so a cold signature's lone query stops
    paying the full budget for padding it will never batch with.  Hot
    signatures (``default / g >= 1``) keep the full budget — their tier
    flush fires before the deadline anyway, so shrinking would only cut
    batching.

    Like :class:`CapacityModel`, cold keys (fewer than ``min_observations``
    gaps) use the default unchanged.
    """

    def __init__(self, min_observations: int = 8, alpha: float = 0.2,
                 min_fraction: float = 0.125):
        assert 0.0 < alpha <= 1.0 and 0.0 < min_fraction <= 1.0
        self.min_observations = int(min_observations)
        self.alpha = float(alpha)
        self.min_fraction = float(min_fraction)
        self._lock = threading.Lock()
        self._last_at: Dict[Hashable, float] = {}
        self._gap_ewma_us: Dict[Hashable, float] = {}
        self._counts: Dict[Hashable, int] = {}

    def observe(self, key: Hashable, now: float) -> None:
        """Record one submission of ``key`` at clock time ``now`` (s)."""
        with self._lock:
            last = self._last_at.get(key)
            self._last_at[key] = now
            if last is None:
                return
            gap_us = max(0.0, (now - last) * 1e6)
            prev = self._gap_ewma_us.get(key)
            self._gap_ewma_us[key] = (
                gap_us if prev is None
                else (1.0 - self.alpha) * prev + self.alpha * gap_us)
            self._counts[key] = self._counts.get(key, 0) + 1

    def expected_gap_us(self, key: Hashable) -> Optional[float]:
        with self._lock:
            if self._counts.get(key, 0) < self.min_observations:
                return None
            return self._gap_ewma_us.get(key)

    def budget_for(self, key: Hashable, default_us: float) -> float:
        """The flush budget the admission path should use for ``key``."""
        gap = self.expected_gap_us(key)
        if gap is None or gap <= 0.0:
            return default_us
        expected_mates = default_us / gap
        if expected_mates >= 1.0:
            return default_us
        return max(self.min_fraction * default_us,
                   default_us * expected_mates)

    def telemetry(self) -> Dict[str, Dict]:
        """Per-key arrival-rate state (``str(key)``-keyed): gap EWMA in
        µs, number of recorded gaps, and whether the key is warm enough
        (``>= min_observations``) for :meth:`budget_for` to shrink its
        budget."""
        with self._lock:
            return {
                str(key): {
                    "gap_ewma_us": self._gap_ewma_us.get(key),
                    "gaps": n,
                    "warm": n >= self.min_observations,
                }
                for key, n in self._counts.items()
            }
