"""Batched multi-query execution: :mod:`plan` normalizes raw queries into
shape-keyed plans, :mod:`batch` groups plans by signature and runs one pass
per bucket through ``core.engine`` (:func:`~repro_torch.exec.batch.
dispatch_bucket` / :class:`~repro_torch.exec.batch.InFlightBucket` split a
bucket into dispatch now and collect later, which the async front end
overlaps), :mod:`cache` remembers the results of repeated normalized plans,
and :mod:`adaptive` learns capacity tiers from observed survivor counts and
flush budgets from observed arrival rates."""
from .plan import QueryPlan, ShapeSig, plan_query, plan_suggest
from .adaptive import AdaptiveDeadline, CapacityModel, adaptive_key
from .batch import (
    InFlightBucket,
    bucket_plans,
    dispatch_bucket,
    execute_bucket,
    execute_name_queries,
    execute_plan_buckets,
)
from .cache import ResultCache

__all__ = [
    "QueryPlan",
    "ShapeSig",
    "plan_query",
    "plan_suggest",
    "AdaptiveDeadline",
    "CapacityModel",
    "adaptive_key",
    "InFlightBucket",
    "bucket_plans",
    "dispatch_bucket",
    "execute_bucket",
    "execute_name_queries",
    "execute_plan_buckets",
    "ResultCache",
]
