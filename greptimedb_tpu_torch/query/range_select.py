"""RANGE ... ALIGN execution: time-windowed aggregation with overlap
(counterpart of greptimedb_tpu/query/range_select.py).

An output point at aligned timestamp T aggregates the rows with
`T <= ts < T + range`; points step every ALIGN interval; series are keyed
by the ALIGN BY expressions (by default the table's primary-key tags).
RANGE may exceed ALIGN (overlapping sliding windows).

Each row is replicated over `S = max(range) / align` slots: slot j
assigns it to the window starting j aligns before its own. One masked
segment reduction over the [S·N] replicated rows per distinct RANGE
(`ops/segment.py::segment_agg_fused`, one K2 call; first/last through
segment_agg's torch code) gives every window's primitives. Values are
float64 on the device, as the JAX module computes them under x64. The
slot grid, the series factorization and the FILL policies are host
numpy; the slot index is integer arithmetic, never a float division.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from greptimedb_tpu_torch import config
from greptimedb_tpu_torch.catalog.catalog import TableInfo
from greptimedb_tpu_torch.datatypes.vector import DictVector
from greptimedb_tpu_torch.ops.segment import segment_agg_fused
from greptimedb_tpu_torch.query import logical as lp
from greptimedb_tpu_torch.query.dist_agg import _factorize_with_null
from greptimedb_tpu_torch.query.expr import (
    BindContext,
    PlanError,
    _interval_in_col_unit,
    bind_expr,
    collect_aggregates,
    collect_columns,
    eval_host,
    extract_ts_bounds,
)
from greptimedb_tpu_torch.query.physical import (
    _PRIMITIVES,
    _closed_range,
    _finalize_agg,
)
from greptimedb_tpu_torch.query.planner import _default_name
from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.storage.index import extract_tag_predicates
from greptimedb_tpu_torch.storage.merge_scan import merge_scans
from greptimedb_tpu_torch.utils import tracing


@dataclass
class RangeAgg:
    func: str               # canonical primitive-decomposable aggregate
    arg: Optional[ast.Expr]
    key: ast.Expr           # unique marker node — the env key: the same
    #                         FuncCall may appear with different RANGEs
    range_steps: int        # window width, in align steps (>= 1)
    fill: Optional[object]  # None | 'null' | 'prev' | 'linear' | float


@dataclass
class RangePlan:
    table: TableInfo
    where: Optional[ast.Expr]
    align_step: int         # in ts-column units
    origin: int             # ALIGN TO, in ts-column units
    by: list[ast.Expr]
    aggs: list[RangeAgg]
    items: list[tuple[str, ast.Expr]]
    order_keys: list[ast.OrderByItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0


_RANGE_FUNCS = {
    "avg": "avg", "mean": "avg", "sum": "sum", "count": "count",
    "min": "min", "max": "max", "first": "first", "last": "last",
    "first_value": "first", "last_value": "last",
    "stddev": "stddev", "variance": "variance",
}


def is_range_select(sel: ast.Select) -> bool:
    return sel.align is not None or any(
        getattr(it, "range_interval", None) is not None for it in sel.items
    )


def plan_range_select(sel: ast.Select, table: TableInfo) -> RangePlan:
    """Validate + lower a RANGE select (reference plan_rewrite.rs
    RangePlanRewriter)."""
    schema = table.schema
    ts_col = schema.time_index
    ts_expr = ast.Column(ts_col.name)
    if sel.align is None:
        raise PlanError("RANGE aggregates need an ALIGN clause")
    # clauses the range path does not implement are rejected, not
    # silently dropped (reference range_select has the same restrictions)
    if sel.group_by:
        raise PlanError(
            "GROUP BY is not valid in a RANGE query; series are keyed by "
            "the ALIGN BY clause")
    if sel.having is not None:
        raise PlanError("HAVING is not supported in RANGE queries")
    if sel.distinct:
        raise PlanError("DISTINCT is not supported in RANGE queries")
    align_step = _interval_in_col_unit(sel.align, ts_expr, schema)
    origin = 0
    if sel.align_to is not None:
        if not (isinstance(sel.align_to, ast.Literal)
                and isinstance(sel.align_to.value, (int, float))):
            raise PlanError("ALIGN TO expects a numeric timestamp literal")
        origin = int(sel.align_to.value)
    by = list(sel.align_by) if sel.align_by else [
        ast.Column(c.name) for c in schema.tag_columns
    ]
    default_fill = sel.range_fill

    items: list[tuple[str, ast.Expr]] = []
    aggs: list[RangeAgg] = []
    # dedupe aggregates by (call, range, fill) — the SAME avg(v) node with
    # two different RANGEs is two different computations, so each gets a
    # unique marker column that replaces it inside that item's expression
    marker_of: dict[tuple, ast.Column] = {}
    for it in sel.items:
        if isinstance(it.expr, ast.Star):
            raise PlanError("SELECT * is not valid in a RANGE query")
        name = it.alias or _default_name(it.expr)
        calls: list[ast.FuncCall] = []
        collect_aggregates(it.expr, calls)
        rng = it.range_interval
        steps = align_step if rng is None else \
            _interval_in_col_unit(rng, ts_expr, schema)
        if steps % align_step:
            raise PlanError(
                f"RANGE ({steps}) must be a multiple of ALIGN ({align_step})")
        range_steps = max(steps // align_step, 1)
        fill = it.fill if it.fill is not None else default_fill
        subst: dict[ast.FuncCall, ast.Column] = {}
        for call in calls:
            dedup_key = (call, range_steps, fill)
            marker = marker_of.get(dedup_key)
            if marker is None:
                func = _RANGE_FUNCS.get(call.name)
                if func is None:
                    raise PlanError(
                        f"aggregate {call.name!r} is not supported in "
                        "RANGE queries")
                arg: Optional[ast.Expr]
                if len(call.args) == 1 and isinstance(call.args[0], ast.Star):
                    if func != "count":
                        raise PlanError(f"{func}(*) is not valid")
                    func, arg = "rows", None
                elif len(call.args) != 1:
                    raise PlanError(f"{call.name} takes one argument")
                else:
                    arg = call.args[0]
                marker = ast.Column(f"__range_agg_{len(aggs)}")
                marker_of[dedup_key] = marker
                aggs.append(RangeAgg(func, arg, marker, range_steps, fill))
            subst[call] = marker
        items.append((name, _subst_calls(it.expr, subst)))
    if not aggs:
        raise PlanError("a RANGE query needs at least one aggregate")

    # every non-aggregate column reference must be the time index or a BY key
    allowed = {ts_col.name}
    for b in by:
        collect_columns(b, allowed)
    outside: set[str] = set()
    for _, e in items:
        _collect_nonagg_columns(e, outside)
    bad = {c for c in outside - allowed if not c.startswith("__range_agg_")}
    if bad:
        raise PlanError(
            f"column(s) {sorted(bad)} must appear in the ALIGN BY clause")

    return RangePlan(
        table=table, where=sel.where, align_step=align_step, origin=origin,
        by=by, aggs=aggs, items=items, order_keys=list(sel.order_by),
        limit=sel.limit, offset=sel.offset or 0,
    )


def _subst_calls(e: ast.Expr, subst: dict) -> ast.Expr:
    """Structurally replace aggregate FuncCalls with their marker columns."""
    if isinstance(e, ast.FuncCall) and e in subst:
        return subst[e]
    if isinstance(e, ast.BinaryOp):
        return ast.BinaryOp(e.op, _subst_calls(e.left, subst),
                            _subst_calls(e.right, subst))
    if isinstance(e, ast.UnaryOp):
        return ast.UnaryOp(e.op, _subst_calls(e.operand, subst))
    if isinstance(e, ast.FuncCall):
        return ast.FuncCall(
            e.name, tuple(_subst_calls(a, subst) for a in e.args),
            e.distinct, order_within=e.order_within)
    if isinstance(e, ast.Cast):
        return ast.Cast(_subst_calls(e.expr, subst), e.type_name)
    return e


def _collect_nonagg_columns(e: ast.Expr, out: set) -> None:
    if isinstance(e, ast.FuncCall) and e.name in _RANGE_FUNCS:
        return
    if isinstance(e, ast.Column):
        out.add(e.name)
        return
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, ast.Expr):
            _collect_nonagg_columns(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, ast.Expr):
                    _collect_nonagg_columns(x, out)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _plain_tag(b: ast.Expr, scan) -> bool:
    return isinstance(b, ast.Column) and b.name in scan.tag_dicts


def _factorize(b, scan, idx, host, schema, n):
    """(sorted unique values, int64 codes [n]) of one BY expression over
    the surviving rows: np.unique's answer, with NULL as a group of its
    own after every value (as GROUP BY groups it; the JAX np.unique
    raises on a NULL tag, ROADMAP C R16). A plain tag column without
    NULLs factorizes its dictionary codes and decodes only the uniques;
    anything else evaluates on the decoded host columns."""
    if _plain_tag(b, scan):
        codes = scan.columns[b.name][idx]
        values = scan.tag_dicts[b.name]
        if (codes < 0).any():
            vals = DictVector(codes, values).decode()
        else:
            used = np.flatnonzero(np.bincount(codes, minlength=len(values)))
            decoded = values[used]
            order = np.argsort(decoded, kind="stable")
            rank = np.empty(len(values), dtype=np.int64)
            rank[used[order]] = np.arange(len(used))
            return decoded[order], rank[codes]
    else:
        vals = np.asarray(eval_host(b, host, schema))
        if vals.ndim == 0:
            vals = np.broadcast_to(vals, (n,))
    if vals.dtype == object:
        return _factorize_with_null(vals)
    return np.unique(vals, return_inverse=True)


def execute_range_select(executor, rp: RangePlan):
    """Run a RangePlan through the executor's storage and device."""
    table = rp.table
    schema = table.schema
    ts_name = schema.time_index.name
    ts_range = _closed_range(
        extract_ts_bounds(rp.where, ts_name, schema.time_index.dtype))
    tag_preds = extract_tag_predicates(rp.where, schema) or None

    # projection pruning: only ts, WHERE, BY, and aggregate-arg columns
    needed: set[str] = {ts_name}
    collect_columns(rp.where, needed)
    for b in rp.by:
        collect_columns(b, needed)
    for a in rp.aggs:
        collect_columns(a.arg, needed)
    proj_cols = [c for c in schema.names if c in needed]

    with tracing.span("scan", table=table.name,
                      regions=len(table.region_ids)):
        if len(table.region_ids) == 1:
            scan = executor.engine.scan(table.region_ids[0], ts_range,
                                        proj_cols, tag_preds)
        else:
            # a partitioned table: gather every region's scan (MergeScan)
            scan = merge_scans([
                executor.engine.scan(rid, ts_range, proj_cols, tag_preds)
                for rid in table.region_ids])
    project = lp.Project(None, rp.items)
    sort = lp.Sort(None, rp.order_keys) if rp.order_keys else None

    def empty_result():
        # zero windows: every projected expression still needs a binding
        env0: dict = {ast.Column(ts_name): np.empty(0, dtype=np.int64)}
        for b in rp.by:
            env0[b] = np.empty(0, dtype=object)
        for a in rp.aggs:
            env0[a.key] = np.empty(0, dtype=np.float64)
        return executor._post_process(env0, None, None, project, sort,
                                      rp.limit, rp.offset, table, 0)

    if scan is None or scan.num_rows == 0:
        return empty_result()

    ctx = BindContext(schema, scan.tag_dicts)
    bound_where = bind_expr(rp.where, ctx) if rp.where is not None else None
    idx = executor._filtered_row_indices(scan, table, ctx, bound_where,
                                         where_unbound=rp.where)
    if len(idx) == 0:
        return empty_result()

    # host gather of the surviving rows: the columns the aggregate
    # arguments and the non-tag BY expressions read, tags decoded
    host_names: set[str] = set()
    for b in rp.by:
        if not _plain_tag(b, scan):
            collect_columns(b, host_names)
    for a in rp.aggs:
        collect_columns(a.arg, host_names)
    host: dict[str, np.ndarray] = {}
    for name in host_names:
        taken = scan.columns[name][idx]
        if name in scan.tag_dicts:
            taken = DictVector(taken, scan.tag_dicts[name]).decode()
        host[name] = taken
    ts = scan.columns[ts_name][idx].astype(np.int64)
    n = len(ts)

    # BY-key factorization -> one dense series code
    by_values: list[np.ndarray] = []
    by_codes = np.zeros(n, dtype=np.int64)
    for b in rp.by:
        uniq, codes = _factorize(b, scan, idx, host, schema, n)
        by_values.append(uniq)
        by_codes = by_codes * len(uniq) + codes
    # compact the combined code (the cross product may have holes); one
    # key's codes are already compact
    if len(rp.by) > 1:
        series_uniq, series_code = np.unique(by_codes, return_inverse=True)
    elif rp.by:
        series_uniq, series_code = np.arange(len(by_values[0])), by_codes
    else:
        series_uniq = np.zeros(1, dtype=np.int64)
        series_code = np.zeros(n, dtype=np.int64)

    align, origin = rp.align_step, rp.origin
    base_slot = (ts - origin) // align
    n_slots = max(a.range_steps for a in rp.aggs)
    # the grid extends n_slots-1 below the earliest data slot: a window
    # starting before the first row still covers it when range > align
    # (reference emits those leading partial windows)
    slot_lo = int(base_slot.min()) - (n_slots - 1)
    slot_span = int(base_slot.max()) - slot_lo + 1
    cap_buckets = _pow2(slot_span)
    cap_series = _pow2(len(series_uniq))
    num_groups = cap_series * cap_buckets
    if num_groups > config.dense_groups_max() * 4:
        raise PlanError(
            f"RANGE query group space {num_groups} too large; narrow the "
            "time window or coarsen ALIGN")
    if n * n_slots >= 2 ** 31:
        raise PlanError(
            f"RANGE query replicates {n} rows over {n_slots} slots, past "
            "the int32 row ids; narrow the time window or shorten RANGE")

    # aggregate value planes
    arg_exprs: list[Optional[ast.Expr]] = []
    slots: list[Optional[int]] = []
    for a in rp.aggs:
        if a.arg is None:
            slots.append(None)
            continue
        if a.arg not in arg_exprs:
            arg_exprs.append(a.arg)
        slots.append(arg_exprs.index(a.arg))
    if arg_exprs:
        planes = [
            np.asarray(eval_host(e, host, schema), dtype=np.float64)
            for e in arg_exprs
        ]
        vals = np.stack([np.broadcast_to(p, (n,)) for p in planes], axis=1)
    else:
        vals = np.zeros((n, 1), dtype=np.float64)

    ops: set = {"rows"}
    for a in rp.aggs:
        ops.update(_PRIMITIVES[a.func])
    ranges = tuple(sorted({a.range_steps for a in rp.aggs}))
    need_ts = bool({"first", "last"} & ops)

    dev = executor.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the span closes after the planes' pull to the host, which waits
    # for the K2 calls: its time covers them on the card
    with tracing.span("range_agg", rows=n, slots=n_slots,
                      groups=num_groups):
        accs = _range_kernel(
            up(ts), up(series_code.astype(np.int32)), up(vals),
            up(base_slot - slot_lo), n_slots=n_slots,
            cap_buckets=cap_buckets, num_groups=num_groups, ranges=ranges,
            ops=tuple(sorted(ops)), need_ts=need_ts)
        accs = {r: {k: v.cpu().numpy() for k, v in acc.items()}
                for r, acc in accs.items()}

    # windows observed by ANY aggregate's range
    present_mask = np.zeros(num_groups, dtype=bool)
    for r in ranges:
        rows_r = accs[r]["rows"]
        rows_r = rows_r[:, 0] if rows_r.ndim == 2 else rows_r
        present_mask |= rows_r > 0
    present = np.flatnonzero(present_mask)

    env: dict = {}
    series_idx = present // cap_buckets
    bucket_idx = present % cap_buckets
    align_ts = (bucket_idx + slot_lo) * align + origin
    env[ast.Column(ts_name)] = align_ts
    # decode BY values for the present windows
    gcodes = series_uniq[series_idx] if rp.by else series_idx
    for b, uniq in zip(reversed(rp.by), reversed(by_values)):
        env[b] = uniq[gcodes % len(uniq)]
        gcodes = gcodes // len(uniq)
    for a, slot in zip(rp.aggs, slots):
        env[a.key] = _finalize_agg(a.func, accs[a.range_steps], slot,
                                    present)

    nrows = len(present)
    env, nrows = _apply_fill(rp, env, series_idx, bucket_idx, align_ts,
                             slot_lo, align, origin, ts_name, nrows)
    return executor._post_process(env, None, None, project, sort, rp.limit,
                                  rp.offset, table, nrows)


def _range_kernel(ts, series_code, vals, rel_slot, *, n_slots, cap_buckets,
                  num_groups, ranges, ops, need_ts) -> dict:
    """One masked segment reduction over slot-replicated rows per
    distinct range (the JAX module's `_range_kernel_jit`, XLA there):
    row i in slot j belongs to window rel_slot[i] - j of its series, and
    to a range r's window iff j < r. Rows off the grid or outside a
    range go to the dead segment. Returns {range_steps: {op: [G(,F)]}}
    with segment_agg's planes; each range is one K2 call."""
    n, f = vals.shape
    j = torch.arange(n_slots, dtype=torch.int64,
                     device=vals.device)[:, None]                  # [S, 1]
    cand = rel_slot[None, :] - j                                   # [S, N]
    in_grid = (cand >= 0) & (cand < cap_buckets)
    gid = (series_code.to(torch.int64)[None, :] * cap_buckets
           + cand.clamp(0, cap_buckets - 1)).reshape(-1).to(torch.int32)
    del cand
    vals_rep = vals.repeat(n_slots, 1)                             # [S·N, F]
    ts_rep = ts.repeat(n_slots) if need_ts else None
    out = {}
    for r in ranges:
        valid = (in_grid & (j < r)).reshape(-1)
        out[r] = segment_agg_fused(vals_rep, gid, valid, num_groups,
                                   ops=ops, ts=ts_rep)
    return out


def _apply_fill(rp, env, series_idx, bucket_idx, align_ts, slot_lo, align,
                origin, ts_name, nrows):
    """FILL NULL/PREV/LINEAR/<const> densify the per-series time grid
    between the globally observed first and last windows
    (reference range_select FILL, plan.rs RangeFn::fill)."""
    if not any(a.fill is not None for a in rp.aggs) or nrows == 0:
        return env, nrows
    b_lo, b_hi = int(bucket_idx.min()), int(bucket_idx.max())
    span = b_hi - b_lo + 1
    series = np.unique(series_idx)
    dense_n = len(series) * span
    # position of each present window in the dense grid
    s_pos = np.searchsorted(series, series_idx)
    pos = s_pos * span + (bucket_idx - b_lo)
    out_env: dict = {}
    dense_buckets = np.tile(np.arange(b_lo, b_hi + 1), len(series))
    new_align_ts = (dense_buckets + slot_lo) * align + origin
    for key, arr in env.items():
        if arr is align_ts:
            out_env[key] = new_align_ts
            continue
        if key in rp.by:
            continue  # densified from the series blocks below
        if np.issubdtype(np.asarray(arr).dtype, np.number):
            dense = np.full(dense_n, np.nan)
        else:
            dense = np.empty(dense_n, dtype=object)
        dense[pos] = arr
        out_env[key] = dense
    # BY columns must be total on the dense grid: each series block gets
    # its decoded value
    for b in rp.by:
        arr = env[b]
        per_series = {}
        for sp, v in zip(s_pos, arr):
            per_series.setdefault(sp, v)
        col = np.empty(dense_n, dtype=object)
        for k in range(len(series)):
            col[k * span:(k + 1) * span] = per_series.get(k)
        out_env[b] = col
    # per-aggregate fill policies
    have = np.zeros(dense_n, dtype=bool)
    have[pos] = True
    for a in rp.aggs:
        arr = out_env[a.key]
        if a.fill in (None, "null"):
            continue
        if isinstance(a.fill, float):
            arr = np.where(have, arr, a.fill)
        elif a.fill == "prev":
            arr = arr.copy()
            for k in range(len(series)):
                seg = arr[k * span:(k + 1) * span]
                for i in range(1, span):
                    if not have[k * span + i]:
                        seg[i] = seg[i - 1]
        elif a.fill == "linear":
            arr = arr.copy()
            for k in range(len(series)):
                seg = arr[k * span:(k + 1) * span]
                hs = have[k * span:(k + 1) * span]
                xs = np.flatnonzero(hs)
                if len(xs) >= 2:
                    miss = np.flatnonzero(~hs)
                    seg[miss] = np.interp(miss, xs,
                                          seg[xs].astype(np.float64))
        out_env[a.key] = arr
    return out_env, dense_n
