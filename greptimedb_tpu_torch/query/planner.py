"""SQL SELECT -> logical plan (mirrors reference DfLogicalPlanner +
the optimizer's pushdown rules: projection pruning and time-predicate
extraction happen here at plan build, SURVEY.md §2.2).
"""

from __future__ import annotations

from typing import Optional

from greptimedb_tpu_torch.catalog.catalog import TableInfo
from greptimedb_tpu_torch.query import logical as lp
from greptimedb_tpu_torch.query.expr import (
    AGG_FUNCS,
    PlanError,
    collect_aggregates,
    collect_columns,
    extract_ts_bounds,
    has_aggregate,
)
from greptimedb_tpu_torch.sql import ast

_FUNC_CANON = {
    "avg": "avg", "mean": "avg", "sum": "sum", "count": "count",
    "min": "min", "max": "max",
    "first": "first", "first_value": "first",
    "last": "last", "last_value": "last",
    "stddev": "stddev", "variance": "variance",
    # order-statistic UDAFs (reference common/function scalars/aggregate)
    "argmax": "argmax", "argmin": "argmin", "median": "median",
    "percentile": "percentile", "approx_percentile_cont": "percentile",
    "polyval": "polyval",
}

#: funcs taking a literal parameter after the column arg
_PARAM_AGGS = {"percentile", "polyval"}


def plan_select(sel: ast.Select, table: TableInfo) -> lp.LogicalPlan:
    schema = table.schema
    # 1. expand stars, name items
    items: list[tuple[str, ast.Expr]] = []
    for it in sel.items:
        if isinstance(it.expr, ast.Star):
            for c in schema.columns:
                items.append((c.name, ast.Column(c.name)))
        else:
            items.append((it.alias or _default_name(it.expr), it.expr))

    alias_map = {name: expr for name, expr in items}

    # 2. resolve group-by ordinals and aliases
    group_exprs: list[ast.Expr] = []
    for g in sel.group_by:
        group_exprs.append(_resolve_group_expr(g, items, alias_map))

    # DISTINCT == group by all items with no aggregates
    if sel.distinct and not group_exprs and not any(has_aggregate(e) for _, e in items):
        group_exprs = [e for _, e in items]

    order_keys = [
        ast.OrderByItem(_resolve_group_expr(o.expr, items, alias_map), o.asc, o.nulls_first)
        for o in sel.order_by
    ]
    having = _substitute_aliases(sel.having, alias_map) if sel.having else None

    # 3. aggregates across select/having/order
    agg_calls: list[ast.FuncCall] = []
    for _, e in items:
        collect_aggregates(e, agg_calls)
    collect_aggregates(having, agg_calls)
    for o in order_keys:
        collect_aggregates(o.expr, agg_calls)
    is_agg = bool(agg_calls) or bool(group_exprs)

    # 4. referenced storage columns
    needed: set[str] = set()
    for _, e in items:
        collect_columns(e, needed)
    collect_columns(sel.where, needed)
    for g in group_exprs:
        collect_columns(g, needed)
    collect_columns(having, needed)
    for o in order_keys:
        collect_columns(o.expr, needed)
    unknown = needed - set(schema.names) - set(alias_map)
    if unknown:
        raise PlanError(f"unknown column(s) {sorted(unknown)} in table {table.name}")
    storage_cols = [n for n in schema.names if n in needed]

    ts_col = schema.time_index
    ts_range = extract_ts_bounds(sel.where, ts_col.name, ts_col.dtype)

    plan: lp.LogicalPlan = lp.Scan(table, columns=storage_cols or None, ts_range=ts_range)
    if sel.where is not None:
        plan = lp.Filter(plan, sel.where)

    if is_agg:
        keys = [(_key_name(g, items), g) for g in group_exprs]
        specs = []
        for call in agg_calls:
            func = _FUNC_CANON.get(call.name)
            if func is None:
                raise PlanError(f"unsupported aggregate {call.name!r}")
            if call.distinct:
                # COUNT(DISTINCT x) needs the full value multiset per
                # group → host pass (reference: DataFusion distinct agg)
                if func != "count":
                    raise PlanError(
                        "DISTINCT is only supported for COUNT(DISTINCT x)")
                func = "count_distinct"
            arg: Optional[ast.Expr]
            if len(call.args) == 1 and isinstance(call.args[0], ast.Star):
                if func != "count":
                    raise PlanError(f"{func}(*) is not valid")
                func, arg = "rows", None
            elif len(call.args) == 0:
                raise PlanError(f"{call.name} needs an argument")
            else:
                arg = call.args[0]
            extra: tuple = ()
            if func in _PARAM_AGGS:
                if len(call.args) != 2 or not isinstance(call.args[1], ast.Literal):
                    raise PlanError(
                        f"{call.name} needs (column, <numeric literal>)")
                try:
                    p = float(call.args[1].value)
                except (TypeError, ValueError) as exc:
                    raise PlanError(
                        f"{call.name} parameter must be numeric, got "
                        f"{call.args[1].value!r}") from exc
                if call.name == "approx_percentile_cont":
                    # standard signature takes a FRACTION in [0, 1]
                    if not 0.0 <= p <= 1.0:
                        raise PlanError(
                            "approx_percentile_cont fraction must be in [0, 1]")
                    p *= 100.0
                extra = (p,)
            if call.order_within is not None:
                oexpr, asc = call.order_within
                if func not in ("first", "last"):
                    raise PlanError(
                        f"ORDER BY inside {call.name}() is only supported "
                        "for first_value/last_value")
                if not (isinstance(oexpr, ast.Column)
                        and oexpr.table in (None, table.name)
                        and oexpr.name == schema.time_index.name):
                    raise PlanError(
                        f"{call.name}(... ORDER BY x): only the time "
                        f"index {schema.time_index.name!r} is supported")
                if not asc:
                    # last-by-descending-time IS the chronological first
                    func = "first" if func == "last" else "last"
            specs.append(lp.AggSpec(_default_name(call), func, arg, call,
                                    extra_args=extra))
        plan = lp.Aggregate(plan, keys, specs)
        _validate_agg_items(items, group_exprs, agg_calls)
        if having is not None:
            plan = lp.Having(plan, having)
    plan = lp.Project(plan, items)
    if order_keys:
        plan = lp.Sort(plan, order_keys)
    if sel.limit is not None or sel.offset:
        plan = lp.Limit(plan, sel.limit, sel.offset or 0)
    return plan


def _default_name(e: ast.Expr) -> str:
    if isinstance(e, ast.Column):
        return e.name
    if isinstance(e, ast.FuncCall):
        args = ",".join(_default_name(a) for a in e.args)
        if e.order_within is not None:
            # the ORDER BY variant must not share a name with (and thus
            # silently shadow) the plain aggregate in the projection
            oexpr, asc = e.order_within
            direction = "" if asc else " desc"
            return (f"{e.name}({args} order by "
                    f"{_default_name(oexpr)}{direction})")
        return f"{e.name}({args})"
    if isinstance(e, ast.Literal):
        return str(e.value)
    if isinstance(e, ast.Star):
        return "*"
    if isinstance(e, ast.BinaryOp):
        return f"{_default_name(e.left)} {e.op} {_default_name(e.right)}"
    if isinstance(e, ast.Interval):
        return f"interval '{e.text}'"
    if isinstance(e, ast.Cast):
        return _default_name(e.expr)
    return type(e).__name__.lower()


def _resolve_group_expr(g: ast.Expr, items, alias_map) -> ast.Expr:
    # ordinal: GROUP BY 1
    if isinstance(g, ast.Literal) and isinstance(g.value, int) and not isinstance(g.value, bool):
        idx = g.value - 1
        if 0 <= idx < len(items):
            return items[idx][1]
        raise PlanError(f"GROUP BY position {g.value} out of range")
    # alias of a select item
    if isinstance(g, ast.Column) and g.name in alias_map:
        return alias_map[g.name]
    return g


def _substitute_aliases(e: Optional[ast.Expr], alias_map) -> Optional[ast.Expr]:
    if e is None:
        return None
    if isinstance(e, ast.Column) and e.name in alias_map and not isinstance(alias_map[e.name], ast.Column):
        return alias_map[e.name]
    if isinstance(e, ast.BinaryOp):
        return ast.BinaryOp(e.op, _substitute_aliases(e.left, alias_map),
                            _substitute_aliases(e.right, alias_map))
    if isinstance(e, ast.UnaryOp):
        return ast.UnaryOp(e.op, _substitute_aliases(e.operand, alias_map))
    if isinstance(e, ast.FuncCall):
        return ast.FuncCall(e.name, tuple(_substitute_aliases(a, alias_map) for a in e.args),
                            e.distinct, order_within=e.order_within)
    if isinstance(e, ast.Between):
        return ast.Between(_substitute_aliases(e.expr, alias_map),
                           _substitute_aliases(e.low, alias_map),
                           _substitute_aliases(e.high, alias_map), e.negated)
    return e


def _key_name(g: ast.Expr, items) -> str:
    for name, expr in items:
        if expr == g:
            return name
    return _default_name(g)


def _validate_agg_items(items, group_exprs, agg_calls):
    """Every select item must be derivable from group keys + aggregates."""
    group_set = set(group_exprs)

    def ok(e: ast.Expr) -> bool:
        if e in group_set:
            return True
        if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS:
            return True
        if isinstance(e, ast.Literal) or isinstance(e, ast.Interval):
            return True
        if isinstance(e, ast.Column):
            return False
        if isinstance(e, ast.BinaryOp):
            return ok(e.left) and ok(e.right)
        if isinstance(e, ast.UnaryOp):
            return ok(e.operand)
        if isinstance(e, ast.FuncCall):
            return all(ok(a) for a in e.args)
        if isinstance(e, ast.Cast):
            return ok(e.expr)
        return False

    for name, e in items:
        if not ok(e):
            raise PlanError(
                f"select item {name!r} is neither a group key nor an aggregate"
            )
