"""Per-signature execution profiles: cost-model residual attribution.

The load harness's ``CostModel(per_bucket_us, per_query_us)`` predicts what
a bucket costs; the card disagrees, and the disagreement (the residual) is
what retunes the model.  Every collected ``InFlightBucket`` reports
``(ShapeSig, batch_size, measured_us)`` here, and with a cost model attached
the predicted cost and the residual are kept per signature.

``fit_cost()`` closes the loop: a least-squares affine fit over the samples
gives fresh ``(per_bucket_us, per_query_us)``, which
``serve.loadgen.calibrate_from_profile`` turns back into a ``CostModel``,
from the buckets the live workload ran instead of a synthetic probe.

Samples are bounded per signature: the most recent ``max_samples`` win.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["ProfileStore", "sig_label"]


def sig_label(sig) -> str:
    """Compact stable text key of a ``ShapeSig``, the JAX package's label
    letter for letter: the span attribute and the JSON key."""
    parts = [f"k{sig.k}", f"t{'x'.join(str(t) for t in sig.ts)}",
             f"cap{sig.capacity_tier}"]
    if sig.shards > 1:
        parts.append(f"s{sig.shards}")
    if sig.replicas > 1:
        parts.append(f"r{sig.replicas}")
    if sig.eshape:
        parts.append("expr")
    if sig.cands:
        parts.append(f"c{sig.cands}")
    return "/".join(parts)


class _SigProfile:
    """Samples of one signature (guarded by the owning store's lock)."""

    __slots__ = ("samples", "total_us", "total_queries", "buckets",
                 "pred_us")

    def __init__(self):
        self.samples: List[Tuple[int, float]] = []  # (batch, measured_us)
        self.total_us = 0.0
        self.total_queries = 0
        self.buckets = 0
        self.pred_us = 0.0


class ProfileStore:
    """Thread-safe per-``ShapeSig`` (batch, measured_us) accumulator.

    ``cost_model`` is anything with ``flush_cost_us(n_buckets, n_queries)``
    (``serve.loadgen.CostModel``); each bucket is predicted as
    ``flush_cost_us(1, n_queries)`` with the model current at observe time,
    so it may be attached or swapped at any time.
    """

    def __init__(self, max_samples: int = 256, cost_model=None):
        self.max_samples = max(1, int(max_samples))
        self.cost_model = cost_model
        self._lock = threading.Lock()
        self._sigs: Dict = {}

    def observe(self, sig, n_queries: int, measured_us: float) -> None:
        """Record one executed bucket: ``n_queries`` rows took
        ``measured_us`` from dispatch to collect."""
        model = self.cost_model
        pred = (float(model.flush_cost_us(1, n_queries))
                if model is not None else 0.0)
        with self._lock:
            prof = self._sigs.get(sig)
            if prof is None:
                prof = self._sigs[sig] = _SigProfile()
            prof.samples.append((int(n_queries), float(measured_us)))
            if len(prof.samples) > self.max_samples:
                del prof.samples[0]
            prof.total_us += float(measured_us)
            prof.total_queries += int(n_queries)
            prof.buckets += 1
            prof.pred_us += pred

    def signatures(self) -> List:
        with self._lock:
            return list(self._sigs)

    def residuals(self) -> Dict[str, Dict[str, float]]:
        """Per signature (keyed by :func:`sig_label`): measured and
        predicted totals and the mean residual per bucket; a positive
        ``residual_us`` means the model underestimates the signature."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for sig, prof in self._sigs.items():
                n = prof.buckets
                out[sig_label(sig)] = {
                    "buckets": float(n),
                    "queries": float(prof.total_queries),
                    "measured_us": prof.total_us,
                    "predicted_us": prof.pred_us,
                    "residual_us": prof.total_us - prof.pred_us,
                    "mean_residual_us": (
                        (prof.total_us - prof.pred_us) / n if n else 0.0),
                }
            return out

    def fit_cost(self) -> Optional[Tuple[float, float]]:
        """Least-squares fit ``us ~ per_bucket + per_query * B`` over all
        samples, pooled across signatures: ``(per_bucket_us,
        per_query_us)`` clamped at 0, or None with fewer than two distinct
        batch sizes (one operating point cannot split fixed from marginal
        cost)."""
        with self._lock:
            pts = [s for prof in self._sigs.values() for s in prof.samples]
        if not pts:
            return None
        xs = [float(b) for b, _ in pts]
        ys = [us for _, us in pts]
        n = float(len(pts))
        if len(set(xs)) < 2:
            return None
        mean_x = sum(xs) / n
        mean_y = sum(ys) / n
        var_x = sum((x - mean_x) ** 2 for x in xs)
        cov = sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, ys))
        per_query = cov / var_x
        per_bucket = mean_y - per_query * mean_x
        return (max(0.0, per_bucket), max(0.0, per_query))

    def reset(self) -> None:
        with self._lock:
            self._sigs.clear()
