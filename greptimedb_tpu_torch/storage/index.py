"""Tag predicates of a scan (counterpart of the predicate half of
greptimedb_tpu/storage/index.py).

`extract_tag_predicates` pulls conservative tag constraints out of a
WHERE clause; the region turns the equality/IN ones into an exact row
filter (storage/region.py::_tag_inset_mask) and keys its scan cache with
`predicates_cache_key`. The inverted index itself (puffin blobs over SST
row segments) waits for durable storage in a later slice.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Union

# ---- predicates ------------------------------------------------------------


@dataclass(frozen=True)
class InSet:
    """value ∈ {…} — from ``tag = 'v'`` and ``tag IN (…)``."""

    values: tuple[str, ...]  # sorted

    @staticmethod
    def of(values) -> "InSet":
        return InSet(tuple(sorted(str(v) for v in values)))


@dataclass(frozen=True)
class Range:
    """lo (<|<=) value (<|<=) hi over the tag's string ordering — from
    comparisons and BETWEEN on tag columns. Either bound may be None."""

    lo: Optional[str]
    hi: Optional[str]
    lo_inc: bool = True
    hi_inc: bool = True


@dataclass(frozen=True)
class Regex:
    """value matches an anchored regular expression — from LIKE and
    PromQL ``=~`` matchers."""

    pattern: str


Predicate = Union[InSet, Range, Regex]

# A predicate map is tag name -> tuple of Predicates (ANDed), but a plain
# set of values (the historical form, still produced by callers like
# metric_engine and the Flight wire) is accepted anywhere and treated as
# one InSet.
PredicateMap = dict[str, object]


def _norm_preds(v) -> tuple[Predicate, ...]:
    if isinstance(v, (set, frozenset, list)) and not isinstance(v, tuple):
        return (InSet.of(v),)
    if isinstance(v, (InSet, Range, Regex)):
        return (v,)
    out = []
    for p in v:
        out.extend(_norm_preds(p))
    return tuple(out)


def normalize_predicates(preds: Optional[PredicateMap]) \
        -> dict[str, tuple[Predicate, ...]]:
    if not preds:
        return {}
    return {k: _norm_preds(v) for k, v in preds.items()}


def predicates_cache_key(preds: Optional[PredicateMap]):
    """Hashable, order-independent key for scan caches."""
    if not preds:
        return None
    return tuple(sorted(
        (k, tuple(sorted(map(repr, v))))
        for k, v in normalize_predicates(preds).items()
    ))



def _sql_like_to_regex(pat: str) -> str:
    # inline (?is): the query-side LIKE filter compiles with
    # re.IGNORECASE | re.DOTALL (query/expr.py _like_to_regex) — index
    # pruning must never be stricter than the filter it serves
    out = ["(?is)"]
    for ch in pat:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def extract_tag_predicates(where, schema) -> dict[str, tuple]:
    """Conservatively extract tag constraints from the top-level
    conjunction of a raw (pre-bind) WHERE AST: `tag = 'v'`, `tag IN (…)`,
    `tag  (<|<=|>|>=)  'v'`, `tag BETWEEN a AND b`, `tag LIKE 'p%'`.
    Anything not provably restrictive is ignored — pruning must never
    drop rows."""
    from greptimedb_tpu_torch.sql import ast

    tags = {c.name for c in schema.tag_columns}
    out: dict[str, list] = {}

    def add(name: str, pred: Predicate):
        out.setdefault(name, []).append(pred)

    def tag_lit(e):
        """(column, literal) if e is `tag OP literal` in either order,
        plus whether the operands were swapped."""
        l, r = e.left, e.right
        swapped = False
        if isinstance(r, ast.Column) and isinstance(l, ast.Literal):
            l, r, swapped = r, l, True
        if isinstance(l, ast.Column) and l.name in tags \
                and isinstance(r, ast.Literal) and r.value is not None:
            return l.name, str(r.value), swapped
        return None

    def walk(e):
        if isinstance(e, ast.BinaryOp) and e.op == "and":
            walk(e.left)
            walk(e.right)
            return
        if isinstance(e, ast.BinaryOp) and e.op == "=":
            hit = tag_lit(e)
            if hit:
                add(hit[0], InSet.of([hit[1]]))
            return
        if isinstance(e, ast.BinaryOp) and e.op in ("<", "<=", ">", ">="):
            hit = tag_lit(e)
            if hit:
                name, v, swapped = hit
                op = e.op
                if swapped:  # 'v' < tag  ==  tag > 'v'
                    op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
                if op in ("<", "<="):
                    add(name, Range(None, v, hi_inc=(op == "<=")))
                else:
                    add(name, Range(v, None, lo_inc=(op == ">=")))
            return
        if isinstance(e, ast.BinaryOp) and e.op == "like":
            if isinstance(e.left, ast.Column) and e.left.name in tags \
                    and isinstance(e.right, ast.Literal) \
                    and e.right.value is not None:
                add(e.left.name, Regex(_sql_like_to_regex(str(e.right.value))))
            return
        if (
            isinstance(e, ast.Between)
            and not getattr(e, "negated", False)
            and isinstance(e.expr, ast.Column)
            and e.expr.name in tags
            and isinstance(e.low, ast.Literal)
            and isinstance(e.high, ast.Literal)
            and e.low.value is not None
            and e.high.value is not None
        ):
            add(e.expr.name, Range(str(e.low.value), str(e.high.value)))
            return
        if (
            isinstance(e, ast.InList)
            and not e.negated
            and isinstance(e.expr, ast.Column)
            and e.expr.name in tags
            and all(isinstance(i, ast.Literal) for i in e.items)
        ):
            add(e.expr.name,
                InSet.of([str(i.value) for i in e.items
                          if i.value is not None]))

    if where is not None:
        walk(where)
    return {k: tuple(v) for k, v in out.items()}
