"""Open-loop load generation for the port's async serving stack, with
SLO-burn reporting.

Closed-loop benchmarks (submit, wait, repeat) hide queueing: a slow server
slows its own offered load.  Production traffic is open loop: arrivals are
scheduled by the outside world.  This module generates that traffic and
drives :class:`~repro_torch.serve.search.AsyncSearchEngine` with it,
reporting **SLO burn**, the share of completed queries whose queue wait
exceeded the deadline budget, beside p50/p99 waits and a windowed burn
curve.  It is the JAX package's ``serve/loadgen.py`` over the port's engine
and ``EXEC_COUNTERS``; the same seed gives the same schedule in both.

- **Traffic synthesis**: :class:`TrafficShape` (base rate, a diurnal
  sinusoid, Poisson burst clumps) and :class:`QueryMix` (the paper's
  keyword-count mix, Pareto-skewed term popularity, an optional finite
  distinct pool) -> :func:`build_schedule` -> an :class:`ArrivalSchedule`.
  Arrivals come from Lewis–Shedler thinning against the diurnal envelope,
  deterministic from the seed (numpy ``default_rng``).
- **Virtual-time replay** (:func:`run_virtual`): a deterministic
  discrete-event replay.  The engine's clock and admission queue are
  rebound to a :class:`VirtualClock`; the replay advances to the next
  arrival (submitting with ``arrival_at``) or to the next flush, where it
  pumps as the background flusher would.  Each pump's cost is charged to a
  single server's ``busy_until`` horizon through a :class:`CostModel`, so
  load beyond its capacity queues and burns.  The buckets still run for
  real on the engine's device, so the answers are real.
- **Wall-clock replay** (:func:`run_wallclock`): the same schedule replayed
  in real time by N submitter threads against the real background flusher,
  each submit stamped with its scheduled arrival (the coordinated-omission
  correction); the report counts threads that outlive the run.

Burn: a completed query burns when its wait exceeds its budget by more
than ``BURN_EPS_US`` (0.5 us, the virtual clock's float error).  A
deadline-flushed bucket's oldest query waits exactly its budget, so burn
measures overload, not the policy's own use of the budget.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import EXEC_COUNTERS
from .admission import AdmissionQueue, Ticket
from .search import AsyncSearchEngine

__all__ = [
    "BURN_EPS_US",
    "TrafficShape",
    "QueryMix",
    "ArrivalSchedule",
    "build_schedule",
    "VirtualClock",
    "attach_virtual_clock",
    "attach_wall_clock",
    "CostModel",
    "calibrate_cost",
    "calibrate_from_profile",
    "LoadReport",
    "run_virtual",
    "run_wallclock",
]

# virtual-time float epsilon: a wait this close to the budget is the
# deadline-flush policy doing its job, not a violation
BURN_EPS_US = 0.5


# ----------------------------------------------------------------------
# traffic synthesis
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficShape:
    """Open-loop arrival process: diurnal base rate + Poisson bursts.

    ``base_qps`` is the mean arrival rate; the instantaneous rate follows
    a sinusoid with relative amplitude ``diurnal_amplitude`` and period
    ``diurnal_period_s`` (a compressed day — benchmarks use a few seconds
    per "day").  On top of the smooth process, burst events arrive as a
    Poisson process at ``burst_rate_hz``; each event injects
    ``~Poisson(burst_size)`` extra queries spread uniformly over
    ``burst_width_s`` — the thundering-herd clumps that deadline-flush
    policies must absorb.
    """

    base_qps: float = 500.0
    duration_s: float = 4.0
    diurnal_amplitude: float = 0.5     # 0 disables; rate swings ±50%
    diurnal_period_s: float = 2.0
    burst_rate_hz: float = 1.0         # burst events per second
    burst_size: float = 20.0           # mean queries per burst event
    burst_width_s: float = 0.02        # clump spread

    def rate_at(self, t: float) -> float:
        """Instantaneous smooth arrival rate (queries/s) at time ``t``."""
        phase = 2.0 * np.pi * t / max(self.diurnal_period_s, 1e-9)
        return max(
            0.0, self.base_qps * (1.0 + self.diurnal_amplitude * np.sin(phase))
        )

    def scaled(self, factor: float) -> "TrafficShape":
        """The same shape at ``factor`` times the base (and burst) rate —
        how a benchmark sweeps offered load against a fixed capacity."""
        return dataclasses.replace(
            self,
            base_qps=self.base_qps * factor,
            burst_rate_hz=self.burst_rate_hz * factor,
        )


@dataclasses.dataclass(frozen=True)
class QueryMix:
    """What each arrival asks: k-term mix and term popularity skew.

    ``kw_dist`` is the paper's keyword-count distribution (68% 2-word,
    23% 3-word, 9% 4-word by default); term ids are drawn Pareto-skewed
    toward the low (frequent-under-Zipf) ids with tail index
    ``pareto_a`` and spread ``pareto_scale``.  A finite ``distinct_pool``
    first materializes that many distinct conjunctions and then draws
    arrivals Zipf-style from the pool — the live-traffic regime where
    exact repeats occur and the result cache pays.
    """

    kw_dist: Tuple[Tuple[int, float], ...] = ((2, 0.68), (3, 0.23), (4, 0.09))
    pareto_a: float = 1.0
    pareto_scale: float = 10.0
    distinct_pool: Optional[int] = None

    def _draw(self, terms: np.ndarray, rng: np.random.Generator) -> List[int]:
        ks, ps = zip(*self.kw_dist)
        k = int(rng.choice(ks, p=np.asarray(ps) / sum(ps)))
        idx = np.minimum(
            len(terms) - 1,
            (rng.pareto(self.pareto_a, size=k) * self.pareto_scale).astype(int),
        )
        return sorted(set(terms[idx].tolist())) or [int(terms[0])]

    def sample(self, index_terms: Sequence[int], n: int,
               rng: np.random.Generator) -> List[List[int]]:
        """Draw ``n`` queries over ``index_terms`` (deterministic in rng)."""
        terms = np.asarray(sorted(index_terms))
        if self.distinct_pool is None:
            return [self._draw(terms, rng) for _ in range(n)]
        pool = [self._draw(terms, rng) for _ in range(self.distinct_pool)]
        return _zipf_from_pool(pool, n, rng)


def _zipf_from_pool(pool: Sequence[Sequence[int]], n: int,
                    rng: np.random.Generator) -> List[List[int]]:
    """Draw ``n`` queries Zipf-by-rank from a finite pool of conjunctions
    (pool order = popularity rank)."""
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    return [list(pool[i]) for i in rng.choice(len(pool), size=n, p=p)]


@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """A realized open-loop run: sorted arrival times + the query per slot."""

    times: np.ndarray            # (N,) float seconds, sorted ascending
    queries: Tuple[Tuple[int, ...], ...]
    duration_s: float

    def __len__(self) -> int:
        return len(self.times)

    @property
    def offered_qps(self) -> float:
        """Mean offered load over the whole run (arrivals / duration) —
        the open-loop rate the replays must absorb, independent of how
        fast the engine serves."""
        return len(self.times) / max(self.duration_s, 1e-12)


def build_schedule(shape: TrafficShape, index_terms: Sequence[int],
                   mix: QueryMix = QueryMix(), seed: int = 0,
                   pool: Optional[Sequence[Sequence[int]]] = None
                   ) -> ArrivalSchedule:
    """Materialize one deterministic open-loop schedule.

    Smooth arrivals come from Lewis–Shedler thinning: candidate arrivals
    are drawn from a homogeneous Poisson process at the rate envelope
    ``base_qps * (1 + |amplitude|)`` and kept with probability
    ``rate_at(t) / envelope`` — an exact sampler for the nonhomogeneous
    process, and deterministic given the seed.  Burst clumps are laid on
    top, then everything is merged, sorted, and truncated to the duration.

    An explicit ``pool`` pins the query universe: arrivals draw Zipf-by-
    rank from it instead of ``mix`` drawing its own — benchmarks pass one
    pool to every schedule so warming (and the oracle memo) covers
    every run from one place.
    """
    rng = np.random.default_rng(seed)
    envelope = shape.base_qps * (1.0 + abs(shape.diurnal_amplitude))
    arrivals: List[float] = []
    if envelope > 0:
        t = 0.0
        while True:
            t += rng.exponential(1.0 / envelope)
            if t >= shape.duration_s:
                break
            if rng.uniform() * envelope <= shape.rate_at(t):
                arrivals.append(t)
    n_bursts = rng.poisson(shape.burst_rate_hz * shape.duration_s)
    for _ in range(n_bursts):
        t_burst = rng.uniform(0.0, shape.duration_s)
        for _ in range(rng.poisson(shape.burst_size)):
            arrivals.append(t_burst + rng.uniform(0.0, shape.burst_width_s))
    times = np.sort(np.asarray(
        [a for a in arrivals if a < shape.duration_s], dtype=np.float64))
    if pool is not None:
        queries = _zipf_from_pool(pool, len(times), rng)
    else:
        queries = mix.sample(index_terms, len(times), rng)
    return ArrivalSchedule(
        times=times,
        queries=tuple(tuple(q) for q in queries),
        duration_s=shape.duration_s,
    )


# ----------------------------------------------------------------------
# virtual time
# ----------------------------------------------------------------------


class VirtualClock:
    """Virtual clock (seconds); only the replay advances it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _require_idle(eng: AsyncSearchEngine) -> None:
    """The clock attach guards: no running flusher, nothing queued, nothing
    in flight (a queue swap would orphan pending tickets)."""
    if eng.running:
        raise RuntimeError("stop the background flusher before rebinding")
    if eng.pending() or eng._inflight_count():
        raise RuntimeError(
            "cannot swap the admission queue with work in flight")


def attach_virtual_clock(eng: AsyncSearchEngine,
                         clock: Optional[VirtualClock] = None) -> VirtualClock:
    """Rebind ``eng`` onto a virtual clock (fresh admission queue, same
    flush parameters).  The engine must be idle — no running flusher, no
    queued submissions, no in-flight buckets — because pending tickets
    would be orphaned by the queue swap."""
    _require_idle(eng)
    clock = clock or VirtualClock()
    eng.clock = clock
    eng.admission = AdmissionQueue(flush_tier=eng.admission.flush_tier,
                                   deadline_us=eng.admission.deadline_us,
                                   clock=clock)
    return clock


def attach_wall_clock(eng: AsyncSearchEngine) -> None:
    """Undo :func:`attach_virtual_clock`: back onto ``time.perf_counter``
    (fresh admission queue, same flush parameters, same idle requirement).
    """
    _require_idle(eng)
    eng.clock = time.perf_counter
    eng.admission = AdmissionQueue(flush_tier=eng.admission.flush_tier,
                                   deadline_us=eng.admission.deadline_us,
                                   clock=time.perf_counter)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Affine service cost charged to the virtual clock per flush.

    ``per_bucket_us`` is the fixed dispatch+collect overhead of one bucket
    execution; ``per_query_us`` the marginal cost per batched query.  The
    single-server capacity at a given flush tier follows directly — it is
    the rate at which back-to-back full-tier buckets drain.
    """

    per_bucket_us: float
    per_query_us: float

    def flush_cost_us(self, n_buckets: int, n_queries: int) -> float:
        """Modeled wall time of one flush: fixed dispatch cost per bucket
        plus marginal cost per batched query.  ``run_virtual`` charges
        this to the single server's ``busy_until`` horizon per pump."""
        return n_buckets * self.per_bucket_us + n_queries * self.per_query_us

    def capacity_qps(self, tier: int) -> float:
        """Sustainable queries/s when every flush is a full ``tier``."""
        return tier / (self.flush_cost_us(1, tier) * 1e-6)


def calibrate_cost(eng, queries: Sequence[Sequence[int]],
                   tier: Optional[int] = None, passes: int = 3) -> CostModel:
    """Fit the affine cost model from real warmed bucket executions.

    Measures the median closed-loop wall of a 1-query bucket and a
    ``tier``-query bucket (``queries`` must share one shape signature so
    each batch is a single bucket) and solves the two-point affine fit.
    Run *before* rebinding the engine to a virtual clock, on a warmed
    engine — the fit should capture steady-state execution, not first
    sightings of a specialization.
    """
    tier = tier or eng.admission.flush_tier
    qs = [list(q) for q in queries]
    if len(qs) < tier:
        raise ValueError("need at least `tier` same-signature queries")

    def wall_us(batch) -> float:
        eng.cache.clear()
        t0 = time.perf_counter()
        eng.query_batch(batch)
        return (time.perf_counter() - t0) * 1e6

    w1 = float(np.median([wall_us([qs[0]]) for _ in range(passes)]))
    wt = float(np.median([wall_us(qs[:tier]) for _ in range(passes)]))
    per_query = max(0.0, (wt - w1) / max(1, tier - 1))
    per_bucket = max(1.0, w1 - per_query)
    return CostModel(per_bucket_us=per_bucket, per_query_us=per_query)


def calibrate_from_profile(profile) -> Optional[CostModel]:
    """Fit a :class:`CostModel` from production execution profiles.

    ``profile`` is an ``obs.profile.ProfileStore`` (anything with
    ``fit_cost()``); its samples come from *live* collected buckets, so
    unlike :func:`calibrate_cost` no synthetic probe traffic is needed —
    this is the ROADMAP calibration loop closed: serve → profile →
    refit → re-run the virtual-clock harness with the refreshed model.
    Returns ``None`` while the profile can't identify both coefficients
    (fewer than two distinct batch sizes observed).
    """
    fit = profile.fit_cost()
    if fit is None:
        return None
    per_bucket, per_query = fit
    return CostModel(per_bucket_us=max(1.0, per_bucket),
                     per_query_us=per_query)


# ----------------------------------------------------------------------
# reports
# ----------------------------------------------------------------------


@dataclasses.dataclass
class LoadReport:
    """Outcome of one open-loop run, centered on SLO burn.

    ``burn_rate`` is burned/completed over the whole run; ``burn_curve``
    is the same fraction per arrival-time window (the shape of an
    overload: a diurnal peak burns in its window, a steady overload burns
    everywhere).  Waits are reported for all completed queries and for the
    device-queued subset (cache hits and host paths are ~0-wait and would
    flatter the percentiles).  ``thread_leak`` is the wall-clock replay's
    hygiene check (always 0 in virtual mode).
    """

    mode: str
    deadline_us: float
    arrivals: int
    completed: int
    errors: int
    burned: int
    burn_rate: float
    p50_wait_us: float
    p99_wait_us: float
    p99_e2e_us: float
    queued_queries: int
    p50_queued_wait_us: float
    p99_queued_wait_us: float
    duration_s: float
    offered_qps: float
    served_qps: float
    burn_curve: List[Dict]
    thread_leak: int
    counters: Dict[str, int]

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _budget_us(ticket: Ticket, default_us: float) -> float:
    """A ticket's burn budget: its own deadline when it queued, the run's
    deadline for resolved-at-submit paths (whose ``deadline_us`` is 0)."""
    return ticket.deadline_us if ticket.deadline_us > 0 else default_us


def _make_report(mode: str, entries: List[Tuple[float, Ticket]],
                 deadline_us: float, duration_s: float,
                 windows: int = 10, thread_leak: int = 0) -> LoadReport:
    done = [(t_arr, t) for t_arr, t in entries if t.done]
    ok = [(t_arr, t) for t_arr, t in done if t.error is None]
    errors = len(done) - len(ok)
    waits = np.asarray([t.wait_us for _, t in ok], dtype=np.float64)
    burned_flags = [t.wait_us > _budget_us(t, deadline_us) + BURN_EPS_US
                    for _, t in ok]
    burned = int(sum(burned_flags))
    e2e = np.asarray([t.wait_us + t.value.latency_us for _, t in ok])
    queued = np.asarray([t.wait_us for _, t in ok
                         if t.value.stats.get("batch_size")
                         and not t.value.stats.get("cached")])

    horizon = max(duration_s, 1e-9)
    edges = np.linspace(0.0, horizon, windows + 1)
    curve = []
    for w in range(windows):
        lo, hi = edges[w], edges[w + 1]
        in_w = [(b, t_arr) for (t_arr, _), b in zip(ok, burned_flags)
                if lo <= t_arr < hi or (w == windows - 1 and t_arr >= hi)]
        n_w = len(in_w)
        b_w = sum(b for b, _ in in_w)
        curve.append({
            "t0_s": float(lo), "t1_s": float(hi),
            "completed": n_w, "burned": int(b_w),
            "burn_rate": (b_w / n_w) if n_w else 0.0,
        })

    counters = EXEC_COUNTERS.snapshot()

    def pct(arr, q):
        return float(np.percentile(arr, q)) if len(arr) else 0.0

    return LoadReport(
        mode=mode,
        deadline_us=deadline_us,
        arrivals=len(entries),
        completed=len(ok),
        errors=errors,
        burned=burned,
        burn_rate=burned / max(1, len(ok)),
        p50_wait_us=pct(waits, 50),
        p99_wait_us=pct(waits, 99),
        p99_e2e_us=pct(e2e, 99),
        queued_queries=int(len(queued)),
        p50_queued_wait_us=pct(queued, 50),
        p99_queued_wait_us=pct(queued, 99),
        duration_s=duration_s,
        offered_qps=len(entries) / max(duration_s, 1e-9),
        served_qps=len(ok) / max(duration_s, 1e-9),
        burn_curve=curve,
        thread_leak=thread_leak,
        counters={k: counters[k] for k in (
            "inflight_dispatches", "inflight_collects",
            "tier_flushes", "deadline_flushes",
            "tickets_resolved", "deadline_violations",
            "rerun_calls", "batch_traces",
        )},
    )


# ----------------------------------------------------------------------
# replays
# ----------------------------------------------------------------------


def run_virtual(eng: AsyncSearchEngine, schedule: ArrivalSchedule,
                cost: CostModel, windows: int = 10,
                ) -> Tuple[LoadReport, List[Tuple[float, Ticket]]]:
    """Deterministic discrete-event replay of ``schedule`` on ``eng``.

    The replay owns time: it repeatedly picks the earlier of (a) the next
    scheduled arrival and (b) the next *effective* flush — the admission
    queue's next deadline hint (0 for full tiers) pushed back to the
    single server's ``busy_until`` horizon — advances the virtual clock
    there, and either submits (with ``arrival_at`` back-stamping) or
    pumps.  Each pump's cost is charged to ``busy_until`` through the
    calibrated model, so offered load beyond capacity queues up and waits
    grow exactly as a serial flusher's would.  Ticket waits are therefore
    deterministic functions of the schedule, the policy, and the cost
    model; bucket executions still run for real, so the results (and any
    oracle comparison) are real.  Returns ``(report, entries)`` where
    ``entries`` is the ``(arrival_s, ticket)`` list for identity checks.
    """
    if eng.running:
        raise RuntimeError("virtual mode owns flush timing; stop the flusher")
    clk = attach_virtual_clock(eng)
    inline_before = eng.inline_tier_flush
    eng.inline_tier_flush = False  # the replay is the only flush owner
    EXEC_COUNTERS.reset()
    busy_until = 0.0
    entries: List[Tuple[float, Ticket]] = []
    i, n = 0, len(schedule)
    try:
        while i < n or eng.pending():
            nd = eng.admission.next_deadline_in_us()
            t_flush = (None if nd is None
                       else max(clk.t + max(0.0, nd) * 1e-6, busy_until))
            t_arr = float(schedule.times[i]) if i < n else None
            if t_flush is not None and (t_arr is None or t_flush <= t_arr):
                clk.t = max(clk.t, t_flush)
                before = eng.pending()
                n_buckets = eng.pump()
                n_queries = before - eng.pending()
                if n_buckets:
                    busy_until = max(busy_until, clk.t) + (
                        cost.flush_cost_us(n_buckets, n_queries) * 1e-6)
            else:
                clk.t = max(clk.t, t_arr)
                ticket = eng.submit(list(schedule.queries[i]),
                                    arrival_at=t_arr)
                entries.append((t_arr, ticket))
                i += 1
    finally:
        eng.inline_tier_flush = inline_before
    if eng.pending() or not all(t.done for _, t in entries):
        raise RuntimeError("virtual replay ended with unresolved tickets")
    duration = max(clk.t, schedule.duration_s)
    report = _make_report("virtual", entries, eng.admission.deadline_us,
                          duration, windows=windows)
    return report, entries


def run_wallclock(eng: AsyncSearchEngine, schedule: ArrivalSchedule,
                  submitters: int = 2, windows: int = 10,
                  timeout_s: float = 120.0,
                  ) -> Tuple[LoadReport, List[Tuple[float, Ticket]]]:
    """Replay ``schedule`` in real time against the real background flusher.

    ``submitters`` threads split the schedule round-robin; each sleeps
    until an arrival's scheduled wall time and submits with ``arrival_at``
    stamped to the schedule, so late thread wakeups charge the measured
    wait rather than silently stretching the run (open-loop discipline).
    The engine's flusher is started and stopped here; the report's
    ``thread_leak`` counts threads that survived the run (submitters and
    flusher must all be gone).  Requires the engine's default wall clock.
    """
    if eng.running:
        raise RuntimeError("run_wallclock owns the flusher lifecycle")
    if eng.clock is not time.perf_counter:
        raise ValueError("wall-clock mode needs the engine on "
                         "time.perf_counter")
    EXEC_COUNTERS.reset()
    threads_before = set(threading.enumerate())
    tickets: List[Optional[Ticket]] = [None] * len(schedule)
    eng.start()
    t0 = time.perf_counter() + 0.05  # small lead so slot 0 isn't late

    def submit_slice(offset: int) -> None:
        for j in range(offset, len(schedule), submitters):
            t_sched = t0 + float(schedule.times[j])
            delay = t_sched - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            tickets[j] = eng.submit(list(schedule.queries[j]),
                                    arrival_at=t_sched)

    workers = [threading.Thread(target=submit_slice, args=(k,),
                                name=f"loadgen-submit-{k}", daemon=True)
               for k in range(submitters)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    for t in tickets:
        if t is None or not t.wait(timeout=timeout_s):
            raise RuntimeError("ticket unresolved past timeout — flusher hung?")
    duration = time.perf_counter() - t0
    eng.stop()
    leaked = [th for th in threading.enumerate()
              if th not in threads_before and th.is_alive()]
    entries = [(float(schedule.times[j]), tickets[j])
               for j in range(len(schedule))]
    report = _make_report("wallclock", entries, eng.admission.deadline_us,
                          duration, windows=windows,
                          thread_leak=len(leaked))
    return report, entries
