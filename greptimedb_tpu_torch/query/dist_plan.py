"""Commutativity classification of the plan prefix for distributed
execution, the dist_plan analyzer analog (counterpart of
greptimedb_tpu/query/dist_plan.py).

The reference walks the optimized plan bottom-up, classifies every node
(Commutative / PartialCommutative / ConditionalCommutative /
NonCommutative) and pushes the whole commutative prefix below MergeScan
(query/src/dist_plan/analyzer.rs:35, commutativity.rs:27-52). The same
taxonomy here, over this engine's plan parts:

| node            | class                 | region side        | frontend |
|-----------------|-----------------------|--------------------|----------|
| Filter (WHERE)  | Commutative           | filter stage       | nothing  |
| Projection      | Commutative (columns) | prune stage        | exprs    |
| Sort + Limit    | PartialCommutative    | sort+limit to k    | re-sort  |
| bare Limit      | PartialCommutative    | limit to k         | re-limit |
| Aggregate       | Partial/Final split   | partial_agg planes | combine  |
| Sort w/o Limit  | NonCommutative        | (filter/prune only)| sort     |
| host aggs       | input Commutative     | filter+prune rows  | full agg |

`classify_prefix` returns (PlanFragment, mode) — mode tells the
frontend which Final step to run over what comes back: "agg" combines
partial planes, "topk" re-sorts candidate rows, "rows" treats the union
of filtered rows as the scan relation, "rows_agg" re-enters the device
aggregation over the filtered-row union (non-decomposable aggregates
whose input still commutes). None means nothing pushes and the caller
gathers scans (MergeScan fallback)."""

from __future__ import annotations

from typing import Optional

from greptimedb_tpu_torch.query.expr import collect_columns, current_session_tz
from greptimedb_tpu_torch.query.plan_ser import PlanFragment
from greptimedb_tpu_torch.sql import ast


def classify_prefix(table, where, agg, project, sort, limit, offset,
                    ts_range, scan_node,
                    needs_host_agg, infer_dtype,
                    primitives) -> Optional[tuple[PlanFragment, str]]:
    """Build the largest region-side-executable PlanFragment for this
    plan, or None when only a raw gather works. `needs_host_agg` /
    `infer_dtype` / `primitives` come from the physical layer (shared
    with single-node planning so eligibility matches exactly)."""
    tz = current_session_tz()
    base = dict(ts_range=ts_range, append_mode=table.append_mode, tz=tz)
    stages: list = []
    if where is not None:
        stages.append({"op": "filter", "expr": where})

    if agg is not None:
        decomposable = not any(needs_host_agg(s, table.schema)
                               for s in agg.aggs)
        if decomposable:
            for spec in agg.aggs:
                if spec.arg is None:
                    continue
                dt = infer_dtype(spec.arg, table.schema)
                if dt is not None and not (dt.is_numeric or dt.is_timestamp):
                    # string argument: only count() decomposes into the
                    # validity plane; everything else needs raw values
                    if spec.func not in ("count", "rows"):
                        decomposable = False
                        break
        if decomposable:
            arg_exprs: list[ast.Expr] = []
            for spec in agg.aggs:
                if spec.arg is not None and spec.arg not in arg_exprs:
                    arg_exprs.append(spec.arg)
            ops: set = {"rows"}
            for spec in agg.aggs:
                ops.update(primitives[spec.func])
            stages.append({"op": "partial_agg", "keys": list(agg.keys),
                           "args": arg_exprs, "ops": sorted(ops)})
            return PlanFragment(stages=stages, **base), "agg"
        # Non-decomposable aggregates (order statistics / string args):
        # the aggregate itself is NonCommutative, but its INPUT still
        # commutes — push filter + projection-to-needed-columns and
        # re-enter the normal device aggregation over the row union at
        # the frontend (round-4 verdict #7; the reference ships the
        # same shape as MergeScan below a frontend-only aggregate,
        # commutativity.rs:27-52). Without a WHERE the gather path's
        # scan caches win, except when the projection drops columns —
        # then the wire saving still pays.
        needed: set = {table.schema.time_index.name}
        for _, kexpr in agg.keys:
            collect_columns(kexpr, needed)
        for spec in agg.aggs:
            if spec.arg is not None:
                collect_columns(spec.arg, needed)
        cols = sorted(c for c in needed if c in table.schema.names)
        if where is None and len(cols) >= len(table.schema.names):
            return None
        stages.append({"op": "prune", "columns": cols})
        return PlanFragment(stages=stages, **base), "rows_agg"

    # non-aggregate scans: prune to the referenced columns
    columns = scan_node.columns
    if columns is not None:
        stages.append({"op": "prune", "columns": list(columns)})

    if sort is not None and limit is not None:
        sort_keys = []
        needed: set = set()
        for ob in sort.keys:
            if ob.nulls_first is not None:
                return None  # NULLS FIRST/LAST isn't replicated region-side
            sort_keys.append((ob.expr, ob.asc))
            collect_columns(ob.expr, needed)
        if not all(c in table.schema.names for c in needed):
            return None  # sort key references a projection alias
        stages.append({"op": "sort", "keys": sort_keys})
        stages.append({"op": "limit", "k": int(limit) + int(offset or 0)})
        return PlanFragment(stages=stages, **base), "topk"

    if limit is not None and sort is None:
        # bare LIMIT: any k rows per region satisfy it
        stages.append({"op": "limit", "k": int(limit) + int(offset or 0)})
        return PlanFragment(stages=stages, **base), "rows"

    if where is not None:
        # filter+prune-only fragment: ship the filtered rows, not the
        # scan. Without a WHERE there is nothing to reduce region-side —
        # the gather path (with its scan caches) is strictly better.
        return PlanFragment(stages=stages, **base), "rows"
    return None
