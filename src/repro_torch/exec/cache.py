"""LRU result cache keyed on the normalized plan.

Real query logs repeat themselves, so the cheapest execution of all is
remembering the answer.  The key is :meth:`~repro_torch.exec.plan.QueryPlan.
cache_key` (routing algorithm + the deduped, deterministically sorted term
tuple), so every surface form of a repeated query hits the same entry.
Lookups count into ``EXEC_COUNTERS`` (``result_cache_hits`` /
``result_cache_misses``).

Index mutation safety: owners of a mutable index bump the cache's
**generation** on every mutation (:meth:`ResultCache.bump_generation`, the
serving layer registers it as a ``BatchedEngine.on_mutate`` hook); entries
stamped with an older generation read as misses and are evicted lazily.
Stored values are treated as immutable.

Subexpression entries (:meth:`ResultCache.get_sub` / :meth:`ResultCache.
put_sub`) hold the values of canonical subexpressions, keyed on raw
``exec.expr.expr_key`` tuples under a ``"subexpr"`` namespace, so a subtree
shared across queries (``a∪b`` inside both ``(a∪b)∩c`` and ``(a∪b)∖d``)
resolves on the host without device work.  They share the LRU budget and
the generation stamps with plan entries and count apart
(``subexpr_cache_hits`` / ``subexpr_cache_misses`` /
``subexpr_cache_stores``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple

from ..core.engine import EXEC_COUNTERS
from .plan import QueryPlan

__all__ = ["ResultCache"]


class ResultCache:
    """Bounded LRU mapping ``QueryPlan.cache_key() -> result`` with a
    generation stamp per entry.  A ``capacity`` of 0 disables it (every
    ``get`` is a silent miss that touches no counter).  All methods
    serialize on an internal lock."""

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self.generation = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, plan: QueryPlan) -> Optional[Any]:
        """The cached result for ``plan``, or None (a counted miss).
        Entries from an older generation are evicted and count as misses."""
        if self.capacity <= 0:
            return None
        key = plan.cache_key()
        with self._lock:
            if key in self._entries:
                gen, value = self._entries[key]
                if gen != self.generation:
                    del self._entries[key]
                else:
                    self._entries.move_to_end(key)
                    EXEC_COUNTERS.bump("result_cache_hits")
                    return value
            EXEC_COUNTERS.bump("result_cache_misses")
            return None

    def put(self, plan: QueryPlan, value: Any,
            generation: Optional[int] = None) -> None:
        """Insert or refresh ``plan``'s result; evict LRU past capacity.

        ``generation`` is the generation the result was computed against;
        a result computed before a :meth:`bump_generation` is rejected.
        ``None`` means "computed just now".
        """
        if self.capacity <= 0:
            return
        key = plan.cache_key()
        with self._lock:
            stamp = self.generation if generation is None else generation
            if stamp != self.generation:
                return  # computed against a mutated-away index: never cache
            self._entries[key] = (stamp, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    # -- subexpression entries: same LRU and generations, own counters -----

    @staticmethod
    def _sub_key(key) -> Tuple[str, Any]:
        # a namespace, so a sub-entry never collides with a plan entry
        return ("subexpr", key)

    def get_sub(self, key) -> Optional[Any]:
        """The cached value of canonical subexpression ``key`` (a raw
        ``expr_key`` tuple), or None.  Counts ``subexpr_cache_hits`` /
        ``subexpr_cache_misses``; stale entries evict as misses."""
        if self.capacity <= 0:
            return None
        skey = self._sub_key(key)
        with self._lock:
            if skey in self._entries:
                gen, value = self._entries[skey]
                if gen != self.generation:
                    del self._entries[skey]
                else:
                    self._entries.move_to_end(skey)
                    EXEC_COUNTERS.bump("subexpr_cache_hits")
                    return value
            EXEC_COUNTERS.bump("subexpr_cache_misses")
            return None

    def put_sub(self, key, value: Any,
                generation: Optional[int] = None) -> None:
        """Insert or refresh a canonical subexpression's value, under the
        generation contract of :meth:`put`.  Counts
        ``subexpr_cache_stores``."""
        if self.capacity <= 0:
            return
        skey = self._sub_key(key)
        with self._lock:
            stamp = self.generation if generation is None else generation
            if stamp != self.generation:
                return
            self._entries[skey] = (stamp, value)
            self._entries.move_to_end(skey)
            EXEC_COUNTERS.bump("subexpr_cache_stores")
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def bump_generation(self) -> None:
        """Mark every current entry stale (index mutated); O(1)."""
        with self._lock:
            self.generation += 1

    def invalidate(self) -> None:
        """Drop everything now and advance the generation (also fired on
        adaptive capacity-tier changes)."""
        with self._lock:
            self.generation += 1
            self._entries.clear()

    def clear(self) -> None:
        """Drop every entry; the generation stays."""
        with self._lock:
            self._entries.clear()
