"""Batched multi-query execution: :mod:`expr` holds the ∪/∩/∖ expression
algebra (canonicalizer, parser, numpy oracle), :mod:`plan` normalizes raw
queries (term lists, expressions, expression strings) into
shape-keyed plans, :mod:`batch` groups plans by signature and runs one pass
per bucket through ``core.engine`` (:func:`~repro_torch.exec.batch.
dispatch_bucket` / :class:`~repro_torch.exec.batch.InFlightBucket` split a
bucket into dispatch now and collect later, which the async front end
overlaps), :mod:`cache` remembers the results of repeated normalized plans,
:mod:`adaptive` learns capacity tiers from observed survivor counts and
flush budgets from observed arrival rates, and :mod:`topology` owns the 2-D
``(data, shard)`` layout: replica placement and the per-replica load
balancer that the planner's ``(shards, replicas)`` routing targets."""
from .expr import (
    EMPTY, And, Diff, Expr, Or, Term, canonicalize, eval_host, expr_key,
    expr_shape, flat_terms, leaf_terms, parse, subexpr_keys,
)
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
from .topology import ReplicaBalancer, Topology, make_topology

__all__ = [
    "EMPTY",
    "And",
    "Diff",
    "Expr",
    "Or",
    "Term",
    "canonicalize",
    "eval_host",
    "expr_key",
    "expr_shape",
    "flat_terms",
    "leaf_terms",
    "parse",
    "subexpr_keys",
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
    "ReplicaBalancer",
    "Topology",
    "make_topology",
]
