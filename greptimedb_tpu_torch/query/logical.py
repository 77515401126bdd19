"""Logical plan algebra (mirrors reference DataFusion LogicalPlan usage in
src/query; deliberately minimal — single-table chains for round 1).

Both the SQL planner and the PromQL compiler lower into this algebra
(reference parser.rs:46-48 — one engine, two frontends).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from greptimedb_tpu_torch.catalog.catalog import TableInfo
from greptimedb_tpu_torch.sql import ast


@dataclass
class LogicalPlan:
    pass


@dataclass
class Scan(LogicalPlan):
    table: TableInfo
    columns: Optional[list[str]] = None  # projection pushdown
    ts_range: Optional[tuple[Optional[int], Optional[int]]] = None  # pushdown


@dataclass
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: ast.Expr


@dataclass
class AggSpec:
    name: str  # output name
    func: str  # sum|count|avg|min|max|first|last|stddev|variance|rows|host aggs
    arg: Optional[ast.Expr]  # None for count(*)
    call: ast.FuncCall  # original node (env key for post-agg exprs)
    extra_args: tuple = ()  # literal params (percentile p, polyval x)


@dataclass
class Aggregate(LogicalPlan):
    input: LogicalPlan
    keys: list[tuple[str, ast.Expr]]  # (output name, key expr)
    aggs: list[AggSpec]


@dataclass
class Having(LogicalPlan):
    input: LogicalPlan
    predicate: ast.Expr


@dataclass
class Project(LogicalPlan):
    input: LogicalPlan
    items: list[tuple[str, ast.Expr]]


@dataclass
class Sort(LogicalPlan):
    input: LogicalPlan
    keys: list[ast.OrderByItem]


@dataclass
class Limit(LogicalPlan):
    input: LogicalPlan
    limit: Optional[int]
    offset: int = 0


def explain_plan(plan: LogicalPlan, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(plan, Scan):
        return (f"{pad}Scan: {plan.table.db}.{plan.table.name} "
                f"columns={plan.columns} ts_range={plan.ts_range}")
    if isinstance(plan, Filter):
        return f"{pad}Filter: {plan.predicate}\n" + explain_plan(plan.input, indent + 1)
    if isinstance(plan, Aggregate):
        keys = ", ".join(n for n, _ in plan.keys)
        aggs = ", ".join(f"{a.func}({a.name})" for a in plan.aggs)
        return f"{pad}Aggregate: keys=[{keys}] aggs=[{aggs}]\n" + explain_plan(plan.input, indent + 1)
    if isinstance(plan, Having):
        return f"{pad}Having: {plan.predicate}\n" + explain_plan(plan.input, indent + 1)
    if isinstance(plan, Project):
        return f"{pad}Project: {[n for n, _ in plan.items]}\n" + explain_plan(plan.input, indent + 1)
    if isinstance(plan, Sort):
        return f"{pad}Sort: {len(plan.keys)} keys\n" + explain_plan(plan.input, indent + 1)
    if isinstance(plan, Limit):
        return f"{pad}Limit: {plan.limit} offset {plan.offset}\n" + explain_plan(plan.input, indent + 1)
    return f"{pad}{type(plan).__name__}"
