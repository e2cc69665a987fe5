"""Boolean expression DAG over preprocessed sets: ∩ / ∪ / ∖.

The port's own copy of the JAX package's ``exec/expr.py`` (it imports
nothing of the JAX package; ``tests/test_torch_expr.py`` holds the two
equal).  Bille–Pagh–Pagh ("Fast evaluation of union-intersection
expressions", arxiv 0708.3259) shows the linear-space set representations
the paper builds support worst-case-efficient evaluation of arbitrary ∪/∩
expression trees; this module is the front half of that: a small
expression algebra, a **canonicalizer**, a **numpy oracle** and a parser.
The back half (batched device evaluation) lives in ``kernels/setops.py``
and ``core/engine.py``; the glue (planning, bucketing, caching, serving)
in the rest of ``exec/`` and ``serve/``.

Node types
----------

``Term(t)`` — a leaf naming a preprocessed set; ``And(children)`` /
``Or(children)`` — n-ary ∩ / ∪; ``Diff(left, right)`` — ∖; plus the
``EMPTY`` sentinel (the ∅ result of an unresolvable or self-cancelling
expression).  All nodes are frozen and hashable, so canonical expressions
serve directly as cache keys.

Canonical form
--------------

:func:`canonicalize` rewrites a raw expression into a unique normal form
(per index: child ordering uses each leaf set's ``(t, n)`` metadata):

1. unknown terms become ``EMPTY``; ∅ propagates (``x∩∅ = ∅``,
   ``x∪∅ = x``, ``∅∖x = ∅``, ``x∖∅ = x``, ``x∖x = ∅``);
2. associative ops flatten (``(a∩b)∩c → a∩b∩c``), singletons collapse;
3. children sort by ``(t, n, term)`` for leaves / structural key for
   composites, then dedup, which absorbs ``x∩x → x`` and ``x∪x → x``;
4. differences push **down** through unions
   (``(a∪b)∖s → (a∖s)∪(b∖s)``) and hoist **out** of intersections
   (``(a∖s)∩b → (a∩b)∖s``), and cascades merge
   (``(a∖s)∖u → a∖(s∪u)``), so in canonical form a ``Diff``'s left
   operand is always a ``Term`` or ``And``.

A canonical form that is a bare ``Term`` or an ``And`` of ``Term``s *is* a
flat conjunction: the planner detects that (:func:`flat_terms`) and plans
it exactly as the term list, so flat workloads keep their signatures,
passes, counters and results.

Structural shape
----------------

:func:`expr_shape` erases leaf identities to a nested tuple (the
``ShapeSig.eshape`` component): two expressions with the same shape stack
into one ``(B, …)`` bucket, as flat conjunctions with equal ``(k, ts,
gmaxes)`` do.  Leaf *sizes* (``ts`` / ``gmaxes``) ride in the signature's
tuple fields, in :func:`leaf_terms` traversal order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "Expr", "Term", "And", "Or", "Diff", "EMPTY",
    "canonicalize", "flat_terms", "leaf_terms", "expr_key", "expr_shape",
    "subexpr_keys", "composite_subexprs", "eval_host", "parse",
]


class Expr:
    """Base class for expression nodes (leaf ``Term`` or composite)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Term(Expr):
    """A leaf: the postings set of one term."""

    term: Any


@dataclasses.dataclass(frozen=True)
class And(Expr):
    """n-ary intersection of ``children``."""

    children: Tuple[Expr, ...]


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    """n-ary union of ``children``."""

    children: Tuple[Expr, ...]


@dataclasses.dataclass(frozen=True)
class Diff(Expr):
    """Set difference ``left ∖ right``."""

    left: Expr
    right: Expr


@dataclasses.dataclass(frozen=True)
class _Empty(Expr):
    """The ∅ sentinel (singleton ``EMPTY``)."""


EMPTY = _Empty()


# ---------------------------------------------------------------------------
# structural keys / shapes
# ---------------------------------------------------------------------------

def expr_key(e: Expr) -> Tuple:
    """Hashable structural identity of a *canonical* expression.  Used as
    the (sub)expression result-cache key: two queries containing the same
    canonical subtree probe the same entry."""
    if isinstance(e, Term):
        return ("t", e.term)
    if isinstance(e, And):
        return ("and",) + tuple(expr_key(c) for c in e.children)
    if isinstance(e, Or):
        return ("or",) + tuple(expr_key(c) for c in e.children)
    if isinstance(e, Diff):
        return ("diff", expr_key(e.left), expr_key(e.right))
    return ("empty",)


def expr_shape(e: Expr) -> Tuple:
    """Leaf-erased structure (the ``ShapeSig.eshape`` component): leaves
    become ``"T"``; composites keep their operator and arity.  Leaf sizes
    live in the signature's ``ts`` / ``gmaxes``, in :func:`leaf_terms`
    order, so (shape, ts, gmaxes) fully keys the compiled evaluator."""
    if isinstance(e, Term):
        return "T"
    if isinstance(e, And):
        return ("&",) + tuple(expr_shape(c) for c in e.children)
    if isinstance(e, Or):
        return ("|",) + tuple(expr_shape(c) for c in e.children)
    if isinstance(e, Diff):
        return ("-", expr_shape(e.left), expr_shape(e.right))
    raise ValueError("EMPTY has no executable shape")


def leaf_terms(e: Expr) -> Tuple:
    """Leaf terms in deterministic preorder — THE traversal order shared
    by ``ShapeSig.ts`` / ``gmaxes``, plan ``terms``, and the evaluator's
    stacked leaf arrays.  Repeated terms appear once per occurrence."""
    out: List = []

    def walk(n: Expr) -> None:
        if isinstance(n, Term):
            out.append(n.term)
        elif isinstance(n, (And, Or)):
            for c in n.children:
                walk(c)
        elif isinstance(n, Diff):
            walk(n.left)
            walk(n.right)
        else:
            raise ValueError("EMPTY has no leaves")

    walk(e)
    return tuple(out)


def composite_subexprs(e: Expr) -> Tuple[Expr, ...]:
    """All composite *proper* subexpressions of a canonical expression, in
    **postorder, one entry per position** (duplicates retained — the
    device evaluator walks the leaf-erased shape and cannot dedup by
    identity; a repeated subtree just stores its identical value twice).
    These are the shareable units: the executor emits their value buffers
    in this exact order and the serving layer stores them in the result
    cache under :func:`expr_key`, so a later query containing the same
    subtree (``a∪b`` inside many queries) resolves host-side."""
    out: List[Expr] = []

    def walk(n: Expr, root: bool) -> None:
        if isinstance(n, Term) or isinstance(n, _Empty):
            return
        kids = (n.children if isinstance(n, (And, Or))
                else (n.left, n.right))
        for c in kids:
            walk(c, False)
        if not root:
            out.append(n)

    walk(e, True)
    return tuple(out)


def subexpr_keys(e: Expr) -> Tuple[Tuple, ...]:
    """``expr_key`` of every composite proper subexpression (postorder,
    per position) — the store/lookup keys for subexpression caching, in
    the exact order the device evaluator emits sub-buffers."""
    return tuple(expr_key(s) for s in composite_subexprs(e))


def flat_terms(e: Expr) -> Optional[Tuple]:
    """If a canonical expression is a flat conjunction — a bare ``Term``
    or an ``And`` of ``Term``s — return its term tuple, else None.  The
    planner routes these through the *legacy* flat path unchanged (same
    plans, signatures, executables, cache keys)."""
    if isinstance(e, Term):
        return (e.term,)
    if isinstance(e, And) and all(isinstance(c, Term) for c in e.children):
        return tuple(c.term for c in e.children)
    return None


# ---------------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------------

def _sort_key(e: Expr, index: Mapping) -> Tuple:
    """Deterministic child ordering: leaves by the shared ``(t, n, term)``
    set ordering (smallest set first — the same rule the flat planner
    uses), composites after leaves by structural key."""
    if isinstance(e, Term):
        s = index[e.term]
        return (0, s.t, s.n, repr(e.term))
    if isinstance(e, And):
        return (1, tuple(_sort_key(c, index) for c in e.children))
    if isinstance(e, Or):
        return (2, tuple(_sort_key(c, index) for c in e.children))
    return (3, _sort_key(e.left, index), _sort_key(e.right, index))


def _sorted_unique(kids: List[Expr], index: Mapping) -> List[Expr]:
    """Sort children canonically and drop structural duplicates — the
    ``x∩x → x`` / ``x∪x → x`` absorption."""
    kids = sorted(kids, key=lambda c: _sort_key(c, index))
    out: List[Expr] = []
    seen = set()
    for c in kids:
        k = expr_key(c)
        if k not in seen:
            seen.add(k)
            out.append(c)
    return out


def _make_or(kids: List[Expr], index: Mapping) -> Expr:
    """Canonical ∪ of already-canonical children: drop ∅, flatten nested
    ∪, sort + dedup, collapse singletons."""
    flat: List[Expr] = []
    for c in kids:
        if isinstance(c, _Empty):
            continue
        flat.extend(c.children if isinstance(c, Or) else [c])
    flat = _sorted_unique(flat, index)
    if not flat:
        return EMPTY
    if len(flat) == 1:
        return flat[0]
    return Or(tuple(flat))


def _make_diff(left: Expr, right: Expr, index: Mapping) -> Expr:
    """Canonical ``left ∖ right`` of already-canonical operands.

    Applies the ∖ normal-form rules: ``x∖x → ∅``; cascade merge
    ``(a∖s)∖u → a∖(s∪u)``; push-down ``(a∪b)∖s → (a∖s)∪(b∖s)``.  The
    result's ``Diff`` nodes (if any) have ``Term``/``And`` left operands.
    """
    if isinstance(left, _Empty):
        return EMPTY
    if isinstance(right, _Empty):
        return left
    if expr_key(left) == expr_key(right):
        return EMPTY
    if isinstance(left, Diff):
        return _make_diff(left.left, _make_or([left.right, right], index),
                          index)
    if isinstance(left, Or):
        return _make_or([_make_diff(c, right, index) for c in left.children],
                        index)
    if isinstance(right, Or) and any(expr_key(left) == expr_key(c)
                                     for c in right.children):
        return EMPTY  # a ∖ (… ∪ a ∪ …) = ∅
    return Diff(left, right)


def _make_and(kids: List[Expr], index: Mapping) -> Expr:
    """Canonical ∩ of already-canonical children: ∅ annihilates, nested ∩
    flatten, ∖ children hoist out (``(a∖s)∩b → (a∩b)∖s``, subtrahends
    merge via ∪), sort + dedup, collapse singletons."""
    flat: List[Expr] = []
    subtrahends: List[Expr] = []
    queue = list(kids)
    while queue:
        c = queue.pop(0)
        if isinstance(c, _Empty):
            return EMPTY
        if isinstance(c, And):
            queue[:0] = list(c.children)
        elif isinstance(c, Diff):
            subtrahends.append(c.right)
            queue[:0] = [c.left]
        else:
            flat.append(c)
    flat = _sorted_unique(flat, index)
    if not flat:
        return EMPTY
    base = flat[0] if len(flat) == 1 else And(tuple(flat))
    if subtrahends:
        return _make_diff(base, _make_or(subtrahends, index), index)
    return base


def canonicalize(e: Expr, index: Mapping) -> Expr:
    """Rewrite ``e`` into its canonical form against ``index`` (term ->
    set metadata with ``.t`` / ``.n``).  Idempotent: canonicalizing a
    canonical expression returns it unchanged (structurally).  Returns
    ``EMPTY`` when the expression is provably ∅ (unknown term under ∩,
    ``x∖x``, …)."""
    if isinstance(e, Term):
        return e if e.term in index else EMPTY
    if isinstance(e, _Empty):
        return EMPTY
    if isinstance(e, And):
        return _make_and([canonicalize(c, index) for c in e.children], index)
    if isinstance(e, Or):
        return _make_or([canonicalize(c, index) for c in e.children], index)
    if isinstance(e, Diff):
        return _make_diff(canonicalize(e.left, index),
                          canonicalize(e.right, index), index)
    raise TypeError(f"not an Expr: {e!r}")


# ---------------------------------------------------------------------------
# host numpy oracle
# ---------------------------------------------------------------------------

def eval_host(e: Expr, resolve: Callable[[Any], np.ndarray],
              _memo: Optional[Dict] = None) -> np.ndarray:
    """Exact host evaluation: sorted unique uint32 doc ids for every node
    type.  ``resolve(term)`` returns a term's postings (any order; dtype
    uint32).  This is THE oracle the device evaluator must match
    bit-for-bit — np.intersect1d / union1d / setdiff1d semantics."""
    memo: Dict = {} if _memo is None else _memo
    k = expr_key(e)
    if k in memo:
        return memo[k]
    if isinstance(e, _Empty):
        out = np.empty(0, dtype=np.uint32)
    elif isinstance(e, Term):
        out = np.unique(np.asarray(resolve(e.term), dtype=np.uint32))
    elif isinstance(e, And):
        out = eval_host(e.children[0], resolve, memo)
        for c in e.children[1:]:
            out = np.intersect1d(out, eval_host(c, resolve, memo))
    elif isinstance(e, Or):
        out = eval_host(e.children[0], resolve, memo)
        for c in e.children[1:]:
            out = np.union1d(out, eval_host(c, resolve, memo))
    elif isinstance(e, Diff):
        out = np.setdiff1d(eval_host(e.left, resolve, memo),
                           eval_host(e.right, resolve, memo))
    else:
        raise TypeError(f"not an Expr: {e!r}")
    out = out.astype(np.uint32)
    memo[k] = out
    return out


# ---------------------------------------------------------------------------
# parser: "(a | b) & (c | d) - e"  (also ∪ ∩ ∖)
# ---------------------------------------------------------------------------

_OPS = {"|": "|", "∪": "|", "&": "&", "∩": "&", "-": "-", "∖": "-"}


def _tokenize(s: str) -> List[str]:
    toks: List[str] = []
    i = 0
    while i < len(s):
        ch = s[i]
        if ch.isspace():
            i += 1
        elif ch in "()":
            toks.append(ch)
            i += 1
        elif ch in _OPS:
            toks.append(_OPS[ch])
            i += 1
        else:
            j = i
            while j < len(s) and not (s[j].isspace() or s[j] in "()"
                                      or s[j] in _OPS):
                j += 1
            toks.append(s[i:j])
            i = j
    return toks


def parse(s: str) -> Expr:
    """Parse ``"(a | b) & (c | d) - e"`` into a raw (un-canonicalized)
    expression.  Operators: ``|``/``∪`` (union), ``&``/``∩``
    (intersection), ``-``/``∖`` (difference); precedence ``- < | < &``
    with left associativity, parens override.  Bare integer tokens become
    int terms (the serving layer's term type), others stay strings."""
    toks = _tokenize(s)
    pos = [0]

    def peek() -> Optional[str]:
        return toks[pos[0]] if pos[0] < len(toks) else None

    def eat(tok: str) -> None:
        if peek() != tok:
            raise ValueError(f"expected {tok!r} at {pos[0]} in {toks}")
        pos[0] += 1

    def atom() -> Expr:
        t = peek()
        if t == "(":
            eat("(")
            e = diff_expr()
            eat(")")
            return e
        if t is None or t in ("|", "&", "-", ")"):
            raise ValueError(f"expected a term at {pos[0]} in {toks}")
        pos[0] += 1
        try:
            return Term(int(t))
        except ValueError:
            return Term(t)

    def and_expr() -> Expr:
        kids = [atom()]
        while peek() == "&":
            eat("&")
            kids.append(atom())
        return kids[0] if len(kids) == 1 else And(tuple(kids))

    def or_expr() -> Expr:
        kids = [and_expr()]
        while peek() == "|":
            eat("|")
            kids.append(and_expr())
        return kids[0] if len(kids) == 1 else Or(tuple(kids))

    def diff_expr() -> Expr:
        e = or_expr()
        while peek() == "-":
            eat("-")
            e = Diff(e, or_expr())
        return e

    e = diff_expr()
    if pos[0] != len(toks):
        raise ValueError(f"trailing tokens {toks[pos[0]:]} in {s!r}")
    return e
