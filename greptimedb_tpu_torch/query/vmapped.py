"""Vmapped multi-query execution: a batch of parameter-sibling queries as
ONE K2 launch (counterpart of greptimedb_tpu/query/vmapped.py).

The cross-query batcher (concurrency/batcher.py) collects SELECTs that
share a plan shape but differ in parameter literals — which host, which
datacenter, which time window. The members' parameters become a stacked
member axis: the scan, group ids, value planes and the shared-WHERE
mask are built once (they are member-invariant), each member contributes
only its per-row parameter mask, and the members' (member, group) cells
are segments of one reduction.

The JAX package maps its masked `segment_agg` over the member axis with
`jax.vmap` (XLA, not a Pallas kernel). Here the member axis is flattened
into the segment axis, as RANGE ... ALIGN carries its slots through K2:

1. each parameter is stacked as an [M] tensor on the device;
2. group ids, value planes and the shared mask are computed once, over
   the scan's blocks, and concatenated;
3. the [M, N] member mask is `shared & (col[None, :] op pv[:, None])`
   for every parameter conjunct;
4. one `nonzero` gathers the selected (member, row) pairs — the rows the
   M serial runs would read, and one host sync — and each pair's segment
   is `m * G + gid`;
5. one `segment_agg_fused` call reduces them: ONE K2 launch over
   M * G + 1 segments (the last the dead one). first/last pair values
   with their timestamps in segment_agg's torch code, block by block and
   folded with `_combine_partials`, the tie rule of the serial routes.

Replicating every row M times instead (M x N rows into K2) would read
92 M rows for 64 dash members over a 1.44 M-row table; the gather reads
the Σ member rows a serial run reads, which for dashboards is a few
hundred rows a member.

Parity with serial execution: counts, rows, min, max, first and last
are bit for bit (each member's segment sees exactly its serial rows);
sums go through K2's atomics on the card in another order than the
serial route's, so they match to rounding (the JAX package's result is
bit for bit there). The eligibility rules are the JAX package's, with
its texts, so both packages take the same route: `run_vmapped` raises
`VmapIneligible` (the batcher turns to the IN-list rewrite or serial
execution) when

- the plan is not Project <- Aggregate <- Filter <- Scan, an aggregate
  runs on the host, or the table has several regions (the region-partial
  and fragment variants come with the cluster slice, ROADMAP.md A10);
- the serial path would stream the scan;
- a scan part spans several device blocks (the fold-association gate);
- a parameter does not bind through `bind_expr` to `column op int`;
- the stacked accumulator exceeds the group budget (padded width x G).

Window-union batching falls out: members with different time windows
share one scan of the union range and differ only in their ts
parameters; multi-tag selectors are several tag parameters. Past the
dense envelope the members ride the sparse twin: one sort-compact over
the member-invariant rows, then the same gather and one K2 call over
M * U + 1 segments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from greptimedb_tpu_torch import config
from greptimedb_tpu_torch.ops import sparse_segment as sparse_ops
from greptimedb_tpu_torch.ops.blocks import block_size_for
from greptimedb_tpu_torch.ops.segment import segment_agg, segment_agg_fused
from greptimedb_tpu_torch.query import logical as lp
from greptimedb_tpu_torch.query import physical as ph
from greptimedb_tpu_torch.query.expr import (
    BindContext,
    bind_expr,
    extract_ts_bounds,
    split_conjuncts,
)
from greptimedb_tpu_torch.sql import ast


class VmapIneligible(Exception):
    """This batch group cannot ride the stacked member axis with the
    serial route's semantics — the batcher falls back to the IN-list and
    serial paths."""


#: member-axis widths of the JAX package's compiled executables; the
#: group budget is checked against the padded width so both packages
#: accept the same batches (the port launches at the real width)
_WIDTH_BUCKETS = (2, 4, 8, 16, 32, 64, 128)


def _pad_width(m: int) -> int:
    for b in _WIDTH_BUCKETS:
        if m <= b:
            return b
    return m


def _rebuild_conjunction(conjuncts: list) -> Optional[ast.Expr]:
    if not conjuncts:
        return None
    e = conjuncts[0]
    for c in conjuncts[1:]:
        e = ast.BinaryOp("and", e, c)
    return e


def _member_masks(shared: torch.Tensor, param_cols: list, ops: list,
                  params: list) -> torch.Tensor:
    """[M, N] row masks: the shared mask and every member's stacked
    parameter comparisons (`params[j]` is the [M] tensor of conjunct j)."""
    mask = shared[None, :]
    for col, op, pv in zip(param_cols, ops, params):
        c, p = col[None, :], pv[:, None]
        if op == "=":
            mask = mask & (c == p)
        elif op == "<":
            mask = mask & (c < p)
        elif op == "<=":
            mask = mask & (c <= p)
        elif op == ">":
            mask = mask & (c > p)
        else:  # ">="
            mask = mask & (c >= p)
    return mask


def _stacked_agg(vals, gid, member_mask, num_segments: int, ops: tuple,
                 ts=None, blk=None, n_blocks: int = 1) -> dict:
    """The batch's reduction: gather the (member, row) pairs of
    `member_mask` [M, N] and reduce them by segment `m * G + gid` in
    one K2 call over M * G + 1 segments. first/last fold block by block
    (`blk` is each row's block) so ties resolve as on the serial
    routes: the highest row of a block, the earliest block. Returns
    segment_agg's dict over M * G segments."""
    m_idx, r_idx = member_mask.nonzero(as_tuple=True)
    ids = (m_idx * num_segments + gid[r_idx].to(torch.int64)).to(torch.int32)
    v = vals[r_idx]
    m = member_mask.shape[0]
    live = torch.ones(ids.shape[0], dtype=torch.bool, device=ids.device)
    k2_ops = tuple(o for o in ops if o not in ("first", "last"))
    out = segment_agg_fused(v, ids, live, m * num_segments, ops=k2_ops)
    fl_ops = tuple(o for o in ops if o in ("first", "last"))
    if fl_ops:
        t = ts[r_idx]
        b = blk[r_idx] if blk is not None else None
        acc = None
        for i in range(n_blocks):
            if b is None:
                sel_v, sel_ids, sel_t = v, ids, t
            else:
                keep = b == i
                sel_v, sel_ids, sel_t = v[keep], ids[keep], t[keep]
            part = segment_agg(sel_v, sel_ids,
                               torch.ones(sel_ids.shape[0], dtype=torch.bool,
                                          device=ids.device),
                               m * num_segments, ops=fl_ops, ts=sel_t)
            acc = ph._combine_partials(acc, part)
        out.update(acc)
    return out


def _pack(out: dict, float_ops: tuple, pack_dtype) -> torch.Tensor:
    parts = []
    for k in float_ops:
        v = out[k]
        if v.dim() == 1:
            v = v[:, None]
        parts.append(v.to(pack_dtype))
    return torch.cat(parts, dim=1)


def _member_acc(host: np.ndarray, lo: int, hi: int, float_ops: tuple,
                widths: dict) -> dict:
    """One member's host planes: rows [lo, hi) of the packed matrix."""
    acc: dict = {}
    off = 0
    for k in float_ops:
        w = widths[k]
        sl = host[lo:hi, off:off + w]
        off += w
        if k in ("count", "rows"):
            sl = sl.astype(np.int64)
        acc[k] = sl
    return acc


def _bind_param(pspec, value, bctx) -> tuple:
    """One member's value for one parameter conjunct, bound through the
    engine's own literal coercion. Returns (device column name, op,
    bound int). Tag equality binds to a dictionary code, time-index
    comparisons coerce to storage units — identical to what the serial
    path's bound WHERE would compare against."""
    conj = ast.BinaryOp(pspec.op, ast.Column(pspec.col), ast.Literal(value))
    bound = bind_expr(conj, bctx)
    if not (isinstance(bound, ast.BinaryOp)
            and isinstance(bound.left, ast.Column)
            and isinstance(bound.right, ast.Literal)
            and isinstance(bound.right.value, (int, np.integer))
            and not isinstance(bound.right.value, bool)):
        raise VmapIneligible(f"unbindable parameter {pspec.col} {pspec.op}")
    return bound.left.name, bound.op, int(bound.right.value)


def run_vmapped(executor, sel: ast.Select, info, pspecs,
                member_values: list) -> list:
    """Execute `sel`'s shape once for every member value tuple; returns
    QueryResults aligned with `member_values`. Raises VmapIneligible
    when the shape or the scan falls outside the JAX package's rules."""
    from greptimedb_tpu_torch.query.planner import plan_select

    plan = plan_select(sel, info)
    node = plan
    if not isinstance(node, lp.Project):
        raise VmapIneligible("plan root is not a projection")
    project = node
    node = node.input
    if not isinstance(node, lp.Aggregate):
        raise VmapIneligible("not an aggregate shape")
    agg = node
    node = node.input
    if not isinstance(node, lp.Filter):
        raise VmapIneligible("no predicate to parameterize")
    template_where = node.predicate
    node = node.input
    if not isinstance(node, lp.Scan):
        raise VmapIneligible("unexpected scan node")
    scan_node = node
    table = scan_node.table
    schema = table.schema
    ts_name = schema.time_index.name

    if any(ph._needs_host_agg(spec, schema) for spec in agg.aggs):
        raise VmapIneligible("host-side aggregate in batch shape")
    if len(table.region_ids) != 1:
        raise VmapIneligible("multi-region scans gather via fragments")

    # split the predicate: parameter conjuncts out, shared rest stays.
    # plan_select passes sel.where through by reference, so the
    # batcher-identified conjunct objects are found by identity.
    param_ids = {id(p.conjunct) for p in pspecs}
    shared = [c for c in split_conjuncts(template_where)
              if id(c) not in param_ids]
    if len(shared) + len(pspecs) != len(split_conjuncts(template_where)):
        raise VmapIneligible("parameter conjuncts lost in planning")
    shared_where_ast = _rebuild_conjunction(shared)

    # the union time range drives the bucket-key domain and the scan's
    # coarse pruning; member masks carve exact slices on the device
    union_range = _union_member_range(template_where, pspecs,
                                      member_values, ts_name,
                                      schema.time_index.dtype)

    # one scan covering the UNION of the member windows (no tag
    # predicates: every member's rows must be present)
    scan = executor.engine.scan(table.region_ids[0],
                                ph._closed_range(union_range),
                                scan_node.columns, None)
    if scan is None or scan.num_rows == 0:
        raise VmapIneligible("empty scan: serial path settles it")
    if table.append_mode and \
            scan.num_rows >= config.stream_threshold_rows():
        raise VmapIneligible("serial path would stream this scan")

    # parity gate: one device block per part seam (see module docstring)
    block_plan = ph._block_plan(scan)
    seen: set = set()
    for entry in block_plan:
        seam = (entry.pkey, entry.part_start)
        if seam in seen:
            raise VmapIneligible("a scan part spans multiple blocks")
        seen.add(seam)

    bctx = BindContext(schema, scan.tag_dicts)
    bound_shared = bind_expr(shared_where_ast, bctx) \
        if shared_where_ast is not None else None

    # stacked parameter matrix: [n_specs][M] bound ints
    cols_ops: list[tuple] = []
    matrix: list[list[int]] = [[] for _ in pspecs]
    for values in member_values:
        for j, (p, v) in enumerate(zip(pspecs, values)):
            name, op, bval = _bind_param(p, v, bctx)
            if len(cols_ops) <= j:
                cols_ops.append((name, op))
            elif cols_ops[j] != (name, op):
                raise VmapIneligible("parameter spec drift across members")
            matrix[j].append(bval)

    # group keys over the union scan; decode is value-based, so a base
    # shift against a member's narrower serial window is invisible
    scan_node_u = lp.Scan(table, scan_node.columns, union_range)
    keys: list = []
    decoders: list = []
    extra_cols: dict[str, np.ndarray] = {}
    for i, (name, kexpr) in enumerate(agg.keys):
        dk, decode = executor._plan_key(i, kexpr, bctx, scan, scan_node_u,
                                        extra_cols)
        keys.append(dk)
        decoders.append(decode)
    num_groups = 1
    for k in keys:
        num_groups *= k.size
    if not keys:
        raise VmapIneligible("global aggregate has no group axis")
    if num_groups >= sparse_ops.GID_SENTINEL:
        raise VmapIneligible(f"group domain {num_groups} overflows gid space")
    # past the dense envelope the members ride the sparse (sort-compact)
    # twin instead of falling back to serial
    sparse = num_groups > config.dense_groups_max() or (
        config.sparse_groups_min() > 0
        and num_groups >= config.sparse_groups_min())
    cap = min(block_size_for(scan.num_rows), config.sparse_groups_max())
    # the stacked axis multiplies the accumulator: bound M*G by the
    # budget one serial query of the same flavor is allowed (dense key
    # domain, or sparse compact cap)
    budget = config.sparse_groups_max() if sparse \
        else config.dense_groups_max()
    if _pad_width(len(member_values)) * (cap if sparse else num_groups) \
            > budget:
        raise VmapIneligible("stacked accumulator exceeds group budget")

    # aggregate layout (the serial routes' packing)
    arg_exprs: list = []
    spec_slot: list = []
    for spec in agg.aggs:
        if spec.arg is None:
            spec_slot.append(None)
            continue
        b = bind_expr(spec.arg, bctx)
        if b not in arg_exprs:
            arg_exprs.append(b)
        spec_slot.append(arg_exprs.index(b))
    ops: set = {"rows"}
    for spec in agg.aggs:
        ops.update(ph._PRIMITIVES[spec.func])
    need_ts = bool({"first", "last"} & ops)

    acc_dtype = config.compute_dtype(executor.device)
    nf = max(len(arg_exprs), 1)
    float_ops = tuple(sorted(ops))
    widths = {op: (1 if op == "rows" else nf) for op in float_ops}
    pack_dtype = torch.float64 if num_groups <= 4096 else acc_dtype
    if "sumsq" in float_ops:
        pack_dtype = torch.float64

    dedup_mask = executor._maybe_dedup(scan, table)
    tag_names = frozenset(bctx.tag_names)
    float_fields = {c.name for c in schema.field_columns
                    if c.dtype.is_float}
    device_col_names = executor._device_columns(
        scan, bound_shared, keys, tuple(arg_exprs), ts_name, extra_cols)
    for name, _op in cols_ops:
        if name not in device_col_names:
            device_col_names.append(name)

    dev = executor.device
    params = [torch.as_tensor(
        np.asarray(matrix[j], dtype=np.int64 if name == ts_name
                   else np.int32), device=dev)
        for j, (name, _op) in enumerate(cols_ops)]
    m = len(member_values)
    q = _Batch(executor, scan, table, agg, project, keys, decoders,
               spec_slot, extra_cols, bound_shared, bctx, cols_ops, params,
               m, device_col_names, float_fields, acc_dtype, dedup_mask,
               tag_names, schema, ts_name, need_ts, tuple(arg_exprs),
               float_ops, widths, pack_dtype, num_groups)
    if sparse:
        return _run_vmapped_sparse(q, cap)
    return _run_vmapped_dense(q, block_plan)


@dataclasses.dataclass
class _Batch:
    """One batch's member-invariant layout, shared by both tails."""

    executor: object
    scan: object
    table: object
    agg: object
    project: object
    keys: list
    decoders: list
    spec_slot: list
    extra_cols: dict
    bound_shared: Optional[ast.Expr]
    bctx: BindContext
    cols_ops: list
    params: list
    m: int
    device_col_names: list
    float_fields: set
    acc_dtype: torch.dtype
    dedup_mask: Optional[torch.Tensor]
    tag_names: frozenset
    schema: object
    ts_name: str
    need_ts: bool
    arg_exprs: tuple
    float_ops: tuple
    widths: dict
    pack_dtype: torch.dtype
    num_groups: int

    def values(self, cols, shape) -> torch.Tensor:
        if self.arg_exprs:
            return ph._value_planes(self.arg_exprs, cols, self.tag_names,
                                    self.schema, shape, self.acc_dtype)
        return torch.zeros((shape[0], 1), dtype=self.acc_dtype,
                           device=self.executor.device)

    def tail(self, acc, sparse_gids):
        host_info = (self.scan, self.extra_cols, self.bound_shared,
                     self.bctx, self.num_groups)
        return self.executor._agg_tail(
            acc, sparse_gids, self.agg, self.keys, self.decoders,
            self.spec_slot, host_info, None, self.project, None, None, None,
            self.table)


def _run_vmapped_dense(q: _Batch, block_plan) -> list:
    """Dense tail: the scan's blocks through the hot set, concatenated;
    one gather and one K2 launch over M * G + 1 segments; one readback."""
    ex = q.executor

    def fetch_block(entry):
        return {name: ex._device_block(
            q.scan, name, entry, q.extra_cols,
            q.acc_dtype if name in q.float_fields else None)
            for name in q.device_col_names}

    blocks, n_valids, dmasks = ex._gather_blocks(
        q.scan, block_plan, fetch_block, q.dedup_mask)
    shared, gid, vals, ts, blk = [], [], [], [], []
    pcols = [[] for _ in q.cols_ops]
    for i, cols in enumerate(blocks):
        some = next(iter(cols.values()))
        n = some.shape[0]
        mask = ph._base_mask(n, n_valids[i],
                             dmasks[i] if dmasks is not None else None,
                             some.device)
        shared.append(ph._where_mask(mask, q.bound_shared, cols,
                                     q.tag_names, q.schema))
        gid.append(ph._group_ids(cols, q.keys, n))
        vals.append(q.values(cols, mask.shape))
        for j, (name, _op) in enumerate(q.cols_ops):
            pcols[j].append(cols[name])
        if q.need_ts:
            ts.append(cols[q.ts_name])
            blk.append(torch.full((n,), i, dtype=torch.int32,
                                  device=some.device))
    member_mask = _member_masks(
        torch.cat(shared), [torch.cat(c) for c in pcols],
        [op for _n, op in q.cols_ops], q.params)
    g = q.num_groups
    out = _stacked_agg(torch.cat(vals), torch.cat(gid), member_mask, g,
                       q.float_ops,
                       ts=torch.cat(ts) if q.need_ts else None,
                       blk=torch.cat(blk) if q.need_ts else None,
                       n_blocks=len(blocks))
    host = ph._to_host(_pack(out, q.float_ops, q.pack_dtype))
    results = [q.tail(_member_acc(host, i * g, (i + 1) * g, q.float_ops,
                                  q.widths), None)
               for i in range(q.m)]
    ex.last_path = "dense_vmapped"
    return results


def _run_vmapped_sparse(q: _Batch, cap: int) -> list:
    """Sparse tail: whole-scan padded columns (the serial sparse route's
    hot-set keys, so a batch after a serial high-cardinality query reuses
    its uploads), ONE sort-compact over the member-invariant rows
    (padding, dedup, shared conjuncts), the members' masks over the
    sorted rows, one gather and one K2 launch over M * U + 1 segments,
    then a per-member demux that keeps only the ranks the member
    observed (rows > 0)."""
    ex = q.executor
    n = q.scan.num_rows
    n_pad = block_size_for(n)
    cols = {name: ex._whole_column(
        q.scan, name, n_pad, q.extra_cols,
        q.acc_dtype if name in q.float_fields else None)
        for name in q.device_col_names}
    base = torch.arange(n_pad, device=ex.device) < n
    if q.dedup_mask is not None:
        base[:n] &= q.dedup_mask[:n]
    mask0 = ph._where_mask(base, q.bound_shared, cols, q.tag_names,
                           q.schema)
    gid = ph._sparse_gid(cols, q.keys)
    # cap at the padded rows (it can never trip): the batch's own cap
    # check below turns an overflow into VmapIneligible, not PlanError
    order, ids, valid_s, uniq, u = sparse_ops.sort_compact(gid, mask0,
                                                           n_pad)
    if u > cap:
        # the UNION of member windows overflowed the sparse cap; each
        # member alone may still fit, so hand back to the serial paths
        raise VmapIneligible(
            f"batch observed {u} distinct groups over sparse cap {cap}")
    vals = q.values(cols, mask0.shape)[order]
    pcols = [cols[name][order] for name, _op in q.cols_ops]
    member_mask = _member_masks(valid_s, pcols,
                                [op for _n, op in q.cols_ops], q.params)
    out = _stacked_agg(vals, ids, member_mask, u, q.float_ops,
                       ts=cols[q.ts_name][order] if q.need_ts else None)
    host = ph._to_host(_pack(out, q.float_ops, q.pack_dtype))
    gids_u = uniq.cpu().numpy()
    results = []
    for i in range(q.m):
        acc = _member_acc(host, i * u, (i + 1) * u, q.float_ops, q.widths)
        present = np.flatnonzero(acc["rows"][:, 0] > 0)
        acc = {k: v[present] for k, v in acc.items()}
        results.append(q.tail(acc, gids_u[present]))
    ex.last_path = "sparse_vmapped"
    return results


def _union_member_range(template_where, pspecs, member_values, ts_name,
                        ts_dtype):
    """(lo, hi) covering every member's ts bounds, or None when any
    member is unbounded on either side. Scanning the union is the
    coarse prune: rows outside a member's own window are masked by its
    bound ts parameters on the device."""
    lo = hi = None
    lo_open = hi_open = False
    for values in member_values:
        repl = {id(p.conjunct): ast.BinaryOp(
            p.op, ast.Column(p.col), ast.Literal(v))
            for p, v in zip(pspecs, values)}
        member_where = _replace_by_id(template_where, repl)
        r = extract_ts_bounds(member_where, ts_name, ts_dtype)
        mlo, mhi = r if r is not None else (None, None)
        if mlo is None:
            lo_open = True
        elif lo is None or mlo < lo:
            lo = mlo
        if mhi is None:
            hi_open = True
        elif hi is None or mhi > hi:
            hi = mhi
    if lo_open and hi_open:
        return None
    union_range = (None if lo_open else lo, None if hi_open else hi)
    return None if union_range == (None, None) else union_range


def _replace_by_id(e, repl: dict):
    """Rebuild `e` with nodes replaced by identity (id(node) -> new)."""
    r = repl.get(id(e))
    if r is not None:
        return r
    if isinstance(e, (list, tuple)):
        return type(e)(_replace_by_id(x, repl) for x in e)
    if dataclasses.is_dataclass(e) and not isinstance(e, type) \
            and not isinstance(e, ast.Statement):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)) or (
                    dataclasses.is_dataclass(v)
                    and not isinstance(v, (type, ast.Statement))):
                nv = _replace_by_id(v, repl)
                if nv is not v:
                    changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e
    return e
