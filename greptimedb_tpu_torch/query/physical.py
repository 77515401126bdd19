"""Physical execution: logical plan -> device kernels over padded column
blocks (the dense subset of greptimedb_tpu/query/physical.py).

  host scan (columnar)  ->  fixed-shape padded blocks on the device  ->
  per block: WHERE mask + group ids + segment reduction  ->  partial
  combine across blocks  ->  host tail (decode group keys, HAVING / ORDER
  / LIMIT over G rows)

Three aggregation routes, chosen by the JAX package's rules so a query
takes the same route and `last_path` reads the same on both:
- `dense_fused`: the fused CUDA kernel over raw value columns
  (ops/segment_kernels.py::fused_segment_agg);
- `dense_prepared`: the CUDA segment-sum kernel over a query-invariant
  [values | validity | ones] plane held in the hot set
  (ops/segment_kernels.py::segment_sum);
- `dense`: plain PyTorch segment reductions for everything else
  (first/last over expressions, non-field arguments).
Tensors stay on the executor's device; only the G-row result comes back.

Left out of this slice (the JAX package's paths, each listed in
ROADMAP.md): mesh and cluster fan-out, the sparse sort-compact path,
incremental partial-aggregate caching, streaming beyond device memory,
lastpoint and boundary first/last pruning, fragment pushdown, tier
routing, hedged warm-up and vmapped serving. A group key space past
config.dense_groups_max() raises PlanError instead of going sparse.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from greptimedb_tpu_torch import config
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.ops import segment_kernels
from greptimedb_tpu_torch.ops.blocks import (
    DEFAULT_BLOCK_ROWS,
    block_size_for,
    pad_rows,
)
from greptimedb_tpu_torch.ops.dedup import sort_dedup
from greptimedb_tpu_torch.ops.segment import (
    _seg_reduce,
    combine_group_ids,
    dense_segment_sum,
    pallas_mode,
    segment_agg,
)
from greptimedb_tpu_torch.query import logical as lp
from greptimedb_tpu_torch.query.device_cache import DeviceCache
from greptimedb_tpu_torch.query.expr import (
    BindContext,
    PlanError,
    bind_expr,
    collect_columns,
    eval_device,
    eval_host,
)
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.storage.region import ScanData

_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64}

# primitive kernel ops backing each SQL aggregate
_PRIMITIVES = {
    "sum": ("sum", "count"),  # count detects all-NULL groups -> NULL sum
    "count": ("count",),
    "rows": ("rows",),
    "avg": ("sum", "count"),
    "min": ("min",),
    "max": ("max",),
    "first": ("first",),
    "last": ("last",),
    "stddev": ("sum", "sumsq", "count"),
    "variance": ("sum", "sumsq", "count"),
}

#: order-statistic aggregates the JAX package computes on the host
#: (query/host_agg.py); not in this slice of the port
HOST_AGGS = frozenset({"argmax", "argmin", "median", "percentile", "polyval"})

# Route envelope of the fused path, the TPU kernel's shape limits
# (greptimedb_tpu/ops/pallas_segment.py:52-63). The CUDA kernel has no
# such caps; the routing keeps them so both packages serve a query the
# same way.
MAX_SEGMENTS = 4096
MAX_FUSED_FIELDS = 56
MAX_FUSED_FIELDS_SUMSQ = 40


def fused_eligible(nf: int, num_segments: int, want_sumsq: bool = False) -> bool:
    limit = MAX_FUSED_FIELDS_SUMSQ if want_sumsq else MAX_FUSED_FIELDS
    return 0 < nf <= limit and 0 < num_segments <= MAX_SEGMENTS


def _needs_host_agg(spec, schema) -> bool:
    """True when a spec cannot ride the numeric device planes: order
    statistics, or first/last/min/max over STRING-typed arguments."""
    if spec.func in HOST_AGGS or spec.func == "count_distinct":
        return True
    if spec.arg is None:
        return False
    dt = _infer_dtype(spec.arg, schema)
    if dt is None or dt.is_numeric or dt.is_timestamp:
        return False
    if spec.func in ("first", "last", "min", "max"):
        return True
    if spec.func == "count":
        # count over a string TAG rides the device (codes, NULL = -1); a
        # string FIELD scans as decoded objects and must count on host
        return (isinstance(spec.arg, ast.Column)
                and spec.arg.name in schema.names
                and schema.column(spec.arg.name).semantic
                is not SemanticType.TAG)
    return False


@dataclass(frozen=True)
class DeviceKey:
    """One group-by key computed on the device."""

    kind: str  # "tag" | "bucket" | "pre"
    column: str
    size: int
    step: int = 0  # bucket width in the column's storage unit
    base: int = 0  # minimum bucket index (offsets ids to 0)


class _BlockEntry(NamedTuple):
    """One device block of the scan: rows [start, end) padded to `block`."""

    start: int
    end: int
    block: int


def _block_plan(scan) -> list[_BlockEntry]:
    """Uniform block layout over the scan (memtable rows have no per-part
    identity, so the JAX package's part-aligned plan reduces to this)."""
    n = scan.num_rows
    pb = min(block_size_for(n), DEFAULT_BLOCK_ROWS)
    return [_BlockEntry(st, min(st + pb, n), pb) for st in range(0, n, pb)]


def _device_of(cols: dict) -> torch.device:
    return next(iter(cols.values())).device


# ---- per-block device work -------------------------------------------------


def _where_mask(mask, where, cols, tag_names, schema):
    if where is None:
        return mask
    w = eval_device(where, cols, tag_names, schema)
    w = w if w.dtype == torch.bool else w != 0
    return mask & w


def _value_planes(agg_args, cols, tag_names, schema, shape, acc_dtype):
    """Aggregate value matrix [N, F]. A tag column used as a VALUE maps
    its NULL code (-1) to NaN so count()/min()/... skip NULL tags."""
    vals = []
    for a in agg_args:
        v = eval_device(a, cols, tag_names, schema)
        if v.dim() == 0:
            v = v.expand(shape)
        v = v.to(acc_dtype)
        if isinstance(a, ast.Column) and a.name in tag_names:
            v = torch.where(cols[a.name] < 0,
                            torch.full_like(v, float("nan")), v)
        vals.append(v)
    return torch.stack(vals, dim=1)


def _group_ids(cols: dict, keys, n: int) -> torch.Tensor:
    """Dense int32 group ids from the key columns."""
    if not keys:
        return torch.zeros(n, dtype=torch.int32, device=_device_of(cols))
    key_arrays = []
    for k in keys:
        c = cols[k.column]
        if k.kind == "tag":
            arr = c + 1
        elif k.kind == "bucket":
            # clamped in int64 before the int32 cast, so a padding row's
            # ts = 0 cannot wrap into a live id
            arr = torch.div(c, k.step, rounding_mode="floor") - k.base
        else:
            arr = c
        key_arrays.append(arr.clamp(0, k.size - 1).to(torch.int32))
    return combine_group_ids(key_arrays, tuple(k.size for k in keys))


def _base_mask(nrows: int, n_valid: int, dedup_mask, device) -> torch.Tensor:
    mask = torch.arange(nrows, device=device) < n_valid
    if dedup_mask is not None:
        mask = mask & dedup_mask
    return mask


def _agg_block(cols, n_valid, dedup_mask, *, where, keys, agg_args, ops,
               num_segments, ts_name, tag_names, schema, need_ts, acc_dtype):
    some = next(iter(cols.values()))
    mask = _base_mask(some.shape[0], n_valid, dedup_mask, some.device)
    mask = _where_mask(mask, where, cols, tag_names, schema)
    gid = _group_ids(cols, keys, mask.shape[0])
    if agg_args:
        values = _value_planes(agg_args, cols, tag_names, schema,
                               mask.shape, acc_dtype)
    else:
        values = torch.zeros((mask.shape[0], 1), dtype=acc_dtype,
                             device=mask.device)
    ts = cols[ts_name] if need_ts else None
    return segment_agg(values, gid, mask, num_segments, ops=ops, ts=ts)


def _agg_scan(blocks, n_valids, dedup_masks, *, where, keys, agg_args, ops,
              num_segments, ts_name, tag_names, schema, need_ts, acc_dtype,
              float_ops, int_ops, pack_dtype):
    """General dense aggregation: plain segment reductions per block,
    combined across blocks, packed into one float and one int matrix."""
    acc = None
    for i, cols in enumerate(blocks):
        partial = _agg_block(
            cols, n_valids[i],
            dedup_masks[i] if dedup_masks is not None else None,
            where=where, keys=keys, agg_args=agg_args, ops=ops,
            num_segments=num_segments, ts_name=ts_name, tag_names=tag_names,
            schema=schema, need_ts=need_ts, acc_dtype=acc_dtype)
        acc = _combine_partials(acc, partial)
    parts = []
    for k in float_ops:
        v = acc[k]
        if v.dim() == 1:
            v = v[:, None]
        parts.append(v.to(pack_dtype))
    packed_f = torch.cat(parts, dim=1)
    packed_i = torch.stack([acc[k] for k in int_ops], dim=1) if int_ops \
        else None
    return packed_f, packed_i


def _agg_scan_prepared(blocks, n_valids, dedup_masks, *, where, keys, nf,
                       has_nan, num_segments, tag_names, schema, float_ops,
                       pack_dtype):
    """Dense fast path for sum/count/mean/rows/min/max/sumsq over plain
    field columns. The "__prep__" plane is query-invariant and cached in
    the hot set, so each query computes only [N]-shaped masks and ids and
    runs one segment-sum kernel per block (dead segment G for masked
    rows).

    Plane layouts (all query-invariant):
    - "__prep__"     [vals0 | valid | ones] (2F+1 with NaNs, F+1 without)
      reduced by the segment-sum kernel: sum/count/mean/rows
    - "__prep_min__" / "__prep_max__" values with NaN -> +inf / -inf,
      reduced by plain segment min/max
    - "__prep_sq__"  squared values (NaN -> 0), f64, segment-sum kernel
    Empty or all-NULL groups come back as +-inf and convert to NULL."""
    G = num_segments
    total = tmin = tmax = tsq = None
    for i, cols in enumerate(blocks):
        plane = cols["__prep__"]
        mask = _base_mask(plane.shape[0], n_valids[i],
                          dedup_masks[i] if dedup_masks is not None else None,
                          plane.device)
        mask = _where_mask(mask, where, cols, tag_names, schema)
        gid = _group_ids(cols, keys, plane.shape[0])
        ids = torch.where(mask, gid, torch.full_like(gid, G))
        part = dense_segment_sum(plane, ids, G + 1)[:G]
        total = part if total is None else total + part
        if "__prep_min__" in cols:
            p = _seg_reduce(cols["__prep_min__"], ids, G + 1, "amin",
                            float("inf"))[:G]
            tmin = p if tmin is None else torch.minimum(tmin, p)
        if "__prep_max__" in cols:
            p = _seg_reduce(cols["__prep_max__"], ids, G + 1, "amax",
                            float("-inf"))[:G]
            tmax = p if tmax is None else torch.maximum(tmax, p)
        if "__prep_sq__" in cols:
            p = dense_segment_sum(cols["__prep_sq__"], ids, G + 1)[:G]
            tsq = p if tsq is None else tsq + p
    sums = total[:, :nf]
    if has_nan:
        cnts = total[:, nf:2 * nf]
        rows = total[:, 2 * nf:2 * nf + 1]
    else:
        rows = total[:, nf:nf + 1]
        cnts = rows.expand(G, nf)
    packed_f = _pack_float_ops(sums, cnts, rows, tmin, tmax, tsq,
                               float_ops, pack_dtype)
    return packed_f, None


def _pack_float_ops(sums, cnts, rows, tmin, tmax, tsq, float_ops,
                    pack_dtype, extra=None):
    """Finalize and pack the prepared/fused accumulator planes into one
    [G, *] matrix. `extra` supplies already-finalized planes the kernel
    cannot derive (the fused path's first/last value planes)."""
    acc: dict = {}
    for k in float_ops:
        if extra is not None and k in extra:
            acc[k] = extra[k]
        elif k == "sum":
            acc[k] = sums
        elif k == "count":
            acc[k] = cnts
        elif k == "rows":
            acc[k] = rows
        elif k == "min":
            # an all-+inf group reads as NULL (the same sentinel rule as
            # segment_agg, a known and shared limitation)
            acc[k] = torch.where(tmin == float("inf"),
                                 torch.full_like(tmin, float("nan")), tmin)
        elif k == "max":
            acc[k] = torch.where(tmax == float("-inf"),
                                 torch.full_like(tmax, float("nan")), tmax)
        elif k == "sumsq":
            acc[k] = tsq
        else:  # mean, with segment_agg's NULL rule
            denom = torch.clamp(cnts, min=1).to(sums.dtype)
            mean = sums / denom
            acc[k] = torch.where(cnts > 0, mean,
                                 torch.full_like(mean, float("nan")))
    return torch.cat([acc[k].to(pack_dtype) for k in float_ops], dim=1)


def _agg_scan_fused(blocks, n_valids, dedup_masks, *, where, keys, arg_names,
                    num_segments, ts_name, tag_names, schema, float_ops,
                    int_ops, pack_dtype, acc_dtype, want_min, want_max,
                    want_sumsq):
    """Fused-kernel twin of _agg_scan_prepared: the hot set holds only the
    RAW value columns, and one fused kernel per block builds validity,
    sums, counts, rows and the optional extremes and squares in
    registers. first/last ride along outside the kernel: their (value,
    ts) pairing goes through segment_agg per block, folded across blocks
    with _combine_partials."""
    G = num_segments
    fl_ops = tuple(sorted(op[:-3] for op in int_ops))
    tsum = tcnt = trow = tmin = tmax = tsq = None
    flacc = None
    for i, cols in enumerate(blocks):
        some = cols[arg_names[0]]
        mask = _base_mask(some.shape[0], n_valids[i],
                          dedup_masks[i] if dedup_masks is not None else None,
                          some.device)
        mask = _where_mask(mask, where, cols, tag_names, schema)
        gid = _group_ids(cols, keys, some.shape[0])
        ids = torch.where(mask, gid, torch.full_like(gid, G))
        vals = torch.stack([cols[a].to(acc_dtype) for a in arg_names], dim=1)
        out = segment_kernels.fused_segment_agg(
            vals, ids, G + 1, want_min=want_min, want_max=want_max,
            want_sumsq=want_sumsq)
        s = out["sum"][:G]
        c = out["count"][:G].to(torch.int64)
        r = out["rows"][:G][:, None].to(torch.int64)
        tsum = s if tsum is None else tsum + s
        tcnt = c if tcnt is None else tcnt + c
        trow = r if trow is None else trow + r
        if want_min:
            m = out["min"][:G]
            tmin = m if tmin is None else torch.minimum(tmin, m)
        if want_max:
            m = out["max"][:G]
            tmax = m if tmax is None else torch.maximum(tmax, m)
        if want_sumsq:
            q = out["sumsq"][:G]
            tsq = q if tsq is None else tsq + q
        if fl_ops:
            part = segment_agg(vals, gid, mask, G, ops=fl_ops,
                               ts=cols[ts_name])
            flacc = _combine_partials(flacc, part)
    extra = {k: flacc[k] for k in fl_ops} if fl_ops else None
    packed_f = _pack_float_ops(tsum, tcnt, trow, tmin, tmax, tsq,
                               float_ops, pack_dtype, extra=extra)
    packed_i = torch.stack([flacc[k] for k in int_ops], dim=1) if int_ops \
        else None
    return packed_f, packed_i


def _build_prep(scan, arg_names, start, end, out_rows, np_acc, has_nan,
                kind) -> np.ndarray:
    """THE prepared-plane builder: rows [start, end) of the scan into a
    plane of `out_rows` rows.

    kind None -> the sum/count plane: [vals0 | valid | ones] (2F+1) with
    NaNs present, [vals | ones] (F+1) without. kind "min"/"max" ->
    identity-filled value planes. kind "sq" -> squared values with NaN ->
    0, always f64 (the stddev/variance cancellation needs it). Writes go
    through a feature-major [F, m] staging buffer and one transpose-assign,
    so the build streams the destination once."""
    f = len(arg_names)
    m = end - start

    def staged():
        src = np.empty((f, m), dtype=np.float64)
        for j, name in enumerate(arg_names):
            src[j] = scan.columns[name][start:end]
        return src

    if kind is None:
        width = (2 * f + 1) if has_nan else (f + 1)
        plane = np.empty((out_rows, width), dtype=np_acc)
        if out_rows > m:
            plane[m:] = 0.0
        src = staged()
        if has_nan:
            nan = np.isnan(src)
            np.copyto(src, 0.0, where=nan)
            plane[:m, :f] = src.T
            plane[:m, f:2 * f] = (~nan).T
        else:
            plane[:m, :f] = src.T
        plane[:m, width - 1] = 1.0
        return plane
    if kind == "sq":
        plane = np.empty((out_rows, f), dtype=np.float64)
        if out_rows > m:
            plane[m:] = 0.0
        src = staged()
        np.multiply(src, src, out=src)
        np.copyto(src, 0.0, where=np.isnan(src))
        plane[:m] = src.T
        return plane
    fill = np.inf if kind == "min" else -np.inf
    plane = np.empty((out_rows, f), dtype=np_acc)
    if out_rows > m:
        plane[m:] = fill
    src = staged()
    np.copyto(src, fill, where=np.isnan(src))
    plane[:m] = src.T
    return plane


def _combine_partials(acc: Optional[dict], p: dict) -> dict:
    if acc is None:
        return p
    out = {}
    for k, v in p.items():
        a = acc[k]
        if k in ("count", "rows"):
            out[k] = a.to(torch.int64) + v.to(torch.int64)
        elif k in ("sum", "sumsq"):
            out[k] = a + v
        elif k == "min":
            out[k] = torch.fmin(a, v)
        elif k == "max":
            out[k] = torch.fmax(a, v)
        elif k in ("last", "last_ts", "first", "first_ts"):
            continue  # handled below as pairs
        else:
            raise PlanError(f"cannot combine partial op {k}")
    if "last" in p:
        newer = p["last_ts"] > acc["last_ts"]
        out["last"] = torch.where(newer[:, None], p["last"], acc["last"])
        out["last_ts"] = torch.where(newer, p["last_ts"], acc["last_ts"])
    if "first" in p:
        older = p["first_ts"] < acc["first_ts"]
        out["first"] = torch.where(older[:, None], p["first"], acc["first"])
        out["first_ts"] = torch.where(older, p["first_ts"], acc["first_ts"])
    return out


def _pad_device_mask(mask: torch.Tensor, start: int, end: int,
                     block: int) -> torch.Tensor:
    out = torch.zeros(block, dtype=torch.bool, device=mask.device)
    out[:end - start] = mask[start:end]
    return out


def _unpack_acc(packed_f, packed_i, float_ops, int_ops, widths):
    """Split the packed output matrices back into per-op host planes: the
    one device -> host readback of an aggregate."""
    host_f = packed_f.cpu().numpy()
    acc: dict = {}
    off = 0
    for k in float_ops:
        w = widths[k]
        sl = host_f[:, off:off + w]
        off += w
        if k in ("count", "rows"):
            sl = sl.astype(np.int64)
        acc[k] = sl
    if int_ops:
        host_i = packed_i.cpu().numpy()
        for j, k in enumerate(int_ops):
            acc[k] = host_i[:, j]
    return acc


# ---- executor ----------------------------------------------------------------


class PhysicalExecutor:
    def __init__(self, engine, device: torch.device):
        self.engine = engine
        self.device = device
        self.cache = DeviceCache(config.device_cache_bytes(device))
        # last_path (which aggregate path served this thread's last query)
        self._tls = threading.local()

    @property
    def last_path(self):
        return getattr(self._tls, "last_path", None)

    @last_path.setter
    def last_path(self, v):
        self._tls.last_path = v

    def execute(self, plan: lp.LogicalPlan) -> QueryResult:
        # unwrap the linear chain
        limit = offset = None
        sort: Optional[lp.Sort] = None
        node = plan
        if isinstance(node, lp.Limit):
            limit, offset = node.limit, node.offset
            node = node.input
        if isinstance(node, lp.Sort):
            sort = node
            node = node.input
        if not isinstance(node, lp.Project):
            raise PlanError(f"unexpected plan root {type(node).__name__}")
        project = node
        node = node.input
        having: Optional[lp.Having] = None
        if isinstance(node, lp.Having):
            having = node
            node = node.input
        agg: Optional[lp.Aggregate] = None
        if isinstance(node, lp.Aggregate):
            agg = node
            node = node.input
        where = None
        if isinstance(node, lp.Filter):
            where = node.predicate
            node = node.input
        if not isinstance(node, lp.Scan):
            raise PlanError(f"unexpected scan node {type(node).__name__}")
        scan_node = node

        table = scan_node.table
        if len(table.region_ids) != 1:
            raise PlanError("multi-region tables are not in this slice of "
                            "the port (the cluster slice brings them)")
        ts_range = _closed_range(scan_node.ts_range)
        # conjunctive tag =/IN predicates become the region's exact
        # in-set row filter
        from greptimedb_tpu_torch.storage.index import extract_tag_predicates

        tag_preds = extract_tag_predicates(where, table.schema) or None

        def run(ts_range):
            scan = self.engine.scan(table.region_ids[0], ts_range,
                                    scan_node.columns, tag_preds)
            if agg is not None:
                return self._execute_agg(scan, table, where, agg, having,
                                         project, sort, limit, offset,
                                         scan_node)
            return self._execute_raw(scan, table, where, project, sort,
                                     limit, offset)

        # bucket-top-k narrowing: ORDER BY <time bucket> DESC/ASC LIMIT k
        # only needs the k newest/oldest buckets — scan those, and widen
        # geometrically if the data is sparse
        candidates = self._bucket_topk_ranges(table, agg, sort, limit,
                                              offset, having, ts_range)
        if candidates:
            for cand in candidates[:-1]:
                res = run(cand)
                if res.num_rows >= int(limit):
                    self.last_path = "bucket_topk+" + (self.last_path or "")
                    return res
            return run(candidates[-1])
        return run(ts_range)

    def _bucket_topk_ranges(self, table, agg, sort, limit, offset, having,
                            ts_range) -> Optional[list]:
        """Candidate scan ranges for the bucket-top-k shape: a single
        date_bin/time_bucket group key, ordered by that key, with LIMIT.
        Only the newest (DESC) or oldest (ASC) k buckets can reach the
        output, so the scan starts at k buckets and widens 4x per attempt
        until the output fills or the original range is covered. Every
        attempt is exact because ranges are bucket-aligned. None when the
        shape doesn't match or narrowing can't help."""
        if (agg is None or sort is None or limit is None
                or having is not None):
            return None
        if len(agg.keys) != 1 or len(sort.keys) != 1:
            return None
        name, kexpr = agg.keys[0]
        ob = sort.keys[0]
        if not (ob.expr == kexpr or (isinstance(ob.expr, ast.Column)
                                     and ob.expr.name == name)):
            return None
        schema = table.schema
        ts_col = schema.time_index
        if not (isinstance(kexpr, ast.FuncCall)
                and kexpr.name in ("date_bin", "time_bucket")
                and len(kexpr.args) == 2
                and isinstance(kexpr.args[0], ast.Interval)
                and isinstance(kexpr.args[1], ast.Column)
                and kexpr.args[1].name == ts_col.name):
            return None
        unit = ts_col.dtype.time_unit.nanos_per_unit
        step = max(kexpr.args[0].nanos // unit, 1)
        k = int(limit) + int(offset or 0)
        exts = [self.engine.ts_extent(rid) for rid in table.region_ids]
        exts = [e for e in exts if e is not None]
        if not exts:
            return None
        dmin = min(e[0] for e in exts)
        dmax = max(e[1] for e in exts)
        lo0, hi0 = ts_range if ts_range else (-(1 << 62), 1 << 62)
        lo_full = max(lo0, dmin)
        hi_full = min(hi0, dmax + 1)  # half-open upper bound
        if hi_full <= lo_full:
            return None
        full = (lo_full, hi_full)
        desc = not ob.asc
        ranges: list = []
        span = k * step
        while True:
            if desc:
                lo = max((max(hi_full - span, lo_full) // step) * step,
                         lo_full)
                cand = (lo, hi_full)
            else:
                hi = min(-(-(min(lo_full + span, hi_full)) // step) * step,
                         hi_full)
                cand = (lo_full, hi)
            ranges.append(cand)
            if cand == full or len(ranges) > 12:
                break
            span *= 4
        if ranges[-1] != full:
            ranges.append(full)
        return ranges if len(ranges) > 1 else None

    def _execute_agg(self, scan, table, where, agg, having, project, sort,
                     limit, offset, scan_node) -> QueryResult:
        schema = table.schema
        ts_name = schema.time_index.name
        host_specs = [s.func for s in agg.aggs if _needs_host_agg(s, schema)]
        if host_specs:
            raise PlanError(
                f"aggregates {sorted(set(host_specs))} run on the host in the "
                "JAX package; they are not in this slice of the port")
        if scan is None:
            return self._empty_agg_result(table, agg, having, project, sort,
                                          limit, offset)

        ctx = BindContext(schema, scan.tag_dicts)
        bound_where = bind_expr(where, ctx) if where is not None else None

        keys: list[DeviceKey] = []
        decoders = []  # per key: fn(int indices) -> (value array, dtype)
        extra_cols: dict[str, np.ndarray] = {}
        for i, (name, kexpr) in enumerate(agg.keys):
            dk, decode = self._plan_key(i, kexpr, ctx, scan, scan_node,
                                        extra_cols)
            keys.append(dk)
            decoders.append(decode)
        num_groups = 1
        for k in keys:
            num_groups *= k.size
        if keys and num_groups > config.dense_groups_max():
            raise PlanError(
                f"group key space {num_groups} exceeds the dense budget "
                f"({config.dense_groups_max()}); the sparse sort-compact "
                "path is not ported yet")

        arg_exprs: list[ast.Expr] = []
        spec_slot: list[Optional[int]] = []
        for spec in agg.aggs:
            if spec.arg is None:
                spec_slot.append(None)
                continue
            b = bind_expr(spec.arg, ctx)
            if b not in arg_exprs:
                arg_exprs.append(b)
            spec_slot.append(arg_exprs.index(b))
        ops: set = {"rows"}
        for spec in agg.aggs:
            ops.update(_PRIMITIVES[spec.func])

        acc = self._stream_agg_inner(scan, table, bound_where, tuple(keys),
                                     tuple(arg_exprs), tuple(sorted(ops)),
                                     num_groups, ts_name, ctx, extra_cols)
        return self._agg_tail(acc, agg, keys, decoders, spec_slot, having,
                              project, sort, limit, offset, table)

    def _agg_tail(self, acc, agg, keys, decoders, spec_slot, having, project,
                  sort, limit, offset, table) -> QueryResult:
        """Host tail: decode present groups' keys, finalize aggregates,
        run HAVING/ORDER/LIMIT over the G-row result."""
        rows = acc["rows"][:, 0] if acc["rows"].ndim == 2 else acc["rows"]
        present = np.flatnonzero(rows > 0) if agg.keys else np.arange(1)
        env: dict = {}
        strides = _strides([k.size for k in keys])
        for i, ((name, kexpr), decode) in enumerate(zip(agg.keys, decoders)):
            idx = (present // strides[i]) % keys[i].size
            col, _ = decode(idx)
            env[kexpr] = col
        for spec, slot in zip(agg.aggs, spec_slot):
            env[spec.call] = _finalize_agg(spec.func, acc, slot, present)
        return self._post_process(env, agg, having, project, sort, limit,
                                  offset, table, len(present))

    def _plan_key(self, i, kexpr, ctx, scan: ScanData, scan_node, extra_cols):
        schema = ctx.schema
        ts_col = schema.time_index
        if isinstance(kexpr, ast.Column) and kexpr.name in ctx.tag_names:
            name = kexpr.name
            card = len(scan.tag_dicts[name])
            values = scan.tag_dicts[name]

            def decode_tag(idx, values=values):
                out = np.empty(len(idx), dtype=object)
                codes = idx - 1
                valid = codes >= 0
                out[valid] = values[codes[valid]]
                out[~valid] = None
                return out, DataType.STRING

            return DeviceKey("tag", name, card + 1), decode_tag
        if (isinstance(kexpr, ast.FuncCall)
                and kexpr.name in ("date_bin", "time_bucket")
                and isinstance(kexpr.args[0], ast.Interval)
                and isinstance(kexpr.args[1], ast.Column)
                and kexpr.args[1].name == ts_col.name):
            unit = ts_col.dtype.time_unit.nanos_per_unit
            step = max(kexpr.args[0].nanos // unit, 1)
            ts_arr = scan.columns[ts_col.name]
            lo, hi = self._ts_bounds(scan_node, ts_arr)
            base = int(np.floor_divide(lo, step))
            size = int(np.floor_divide(hi, step)) - base + 1

            def decode_bucket(idx, step=step, base=base, dtype=ts_col.dtype):
                return (idx.astype(np.int64) + base) * step, dtype

            return (DeviceKey("bucket", ts_col.name, size, step=step,
                              base=base), decode_bucket)
        # generic expression: factorize on host
        from greptimedb_tpu_torch.datatypes.vector import DictVector

        host_cols = dict(scan.columns)
        for c in schema.tag_columns:
            if c.name in host_cols:
                host_cols[c.name] = DictVector(
                    scan.columns[c.name], scan.tag_dicts[c.name]).decode()
        vals = np.asarray(eval_host(kexpr, host_cols, schema))
        if np.ndim(vals) == 0:
            vals = np.broadcast_to(vals, (scan.num_rows,))
        uniq, inverse = np.unique(vals, return_inverse=True)
        colname = f"__key_{i}"
        extra_cols[colname] = inverse.astype(np.int32)
        out_dtype = None
        if isinstance(kexpr, ast.Column) and kexpr.name in schema.names:
            out_dtype = schema.column(kexpr.name).dtype

        def decode_pre(idx, uniq=uniq, out_dtype=out_dtype):
            return uniq[idx], out_dtype

        return DeviceKey("pre", colname, max(len(uniq), 1)), decode_pre

    def _ts_bounds(self, scan_node, ts_arr) -> tuple[int, int]:
        lo = hi = None
        if scan_node.ts_range is not None:
            lo, hi0 = scan_node.ts_range
            hi = None if hi0 is None else hi0 - 1
        if lo is None:
            lo = int(ts_arr.min())
        if hi is None:
            hi = int(ts_arr.max())
        return lo, hi

    def _stream_agg_inner(self, scan, table, bound_where, keys, arg_exprs,
                          ops, num_groups, ts_name, ctx, extra_cols) -> dict:
        """Run the dense device aggregation; returns host planes indexed
        by global group id."""
        schema = table.schema
        acc_dtype = config.compute_dtype(self.device)
        device_col_names = self._device_columns(
            scan, bound_where, keys, arg_exprs, ts_name, extra_cols)
        dedup_mask = self._maybe_dedup(scan, table)
        tag_names = frozenset(ctx.tag_names)
        float_fields = {c.name for c in schema.field_columns
                        if c.dtype.is_float}

        # output layout: which float/int planes the kernels pack
        nf = max(len(arg_exprs), 1)
        produced_f, produced_i = [], []
        widths = {}
        for op in ops:
            produced_f.append(op)
            widths[op] = 1 if op == "rows" else nf
            if op in ("first", "last"):
                produced_i.append(op + "_ts")
        float_ops = tuple(sorted(produced_f))
        int_ops = tuple(sorted(produced_i))
        pack_dtype = torch.float64 if num_groups <= 4096 else acc_dtype
        if "sumsq" in float_ops:
            # f32 packing would undo the f64 moment accumulation
            pack_dtype = torch.float64

        prepared = self._prepared_ok(arg_exprs, ops, int_ops, schema,
                                     extra_cols)
        # first/last can't ride the PREPARED planes (no ts pairing) but
        # CAN ride the fused kernel, with a per-block segment_agg beside it
        fused_extra = (not prepared and bool(int_ops)
                       and all(k.endswith("_ts") for k in int_ops)
                       and self._prepared_ok(
                           arg_exprs, set(ops) - {"first", "last"}, (),
                           schema, extra_cols))
        if prepared or fused_extra:
            arg_names = tuple(a.name for a in arg_exprs)
            aux_names = self._device_columns(
                scan, bound_where, keys, (), ts_name, extra_cols)
            plan = _block_plan(scan)
            if self._fused_ok(ops, arg_names, num_groups, scan):
                packed_f, packed_i = self._dense_fused_scan(
                    scan, plan, aux_names, arg_names, extra_cols,
                    float_fields, acc_dtype, dedup_mask, bound_where, keys,
                    ops, num_groups, ts_name, tag_names, schema, float_ops,
                    int_ops, pack_dtype)
                self.last_path = "dense_fused"
                return _unpack_acc(packed_f, packed_i, float_ops, int_ops,
                                   widths)
        if prepared:
            self.last_path = "dense_prepared"
            has_nan = self._scan_has_nan(scan, arg_names)
            # variance/stddev difference two moments: both carry f64
            prep_dtype = torch.float64 if "sumsq" in ops else acc_dtype

            def fetch_block(entry):
                cols = {name: self._device_block(
                    scan, name, entry, extra_cols,
                    acc_dtype if name in float_fields else None)
                    for name in aux_names}
                cols["__prep__"] = self._prep_plane(
                    scan, arg_names, entry, prep_dtype, has_nan, None)
                if "min" in ops:
                    cols["__prep_min__"] = self._prep_plane(
                        scan, arg_names, entry, acc_dtype, False, "min")
                if "max" in ops:
                    cols["__prep_max__"] = self._prep_plane(
                        scan, arg_names, entry, acc_dtype, False, "max")
                if "sumsq" in ops:
                    cols["__prep_sq__"] = self._prep_plane(
                        scan, arg_names, entry, prep_dtype, False, "sq")
                return cols

            blocks, n_valids, dmasks = self._gather_blocks(
                scan, plan, fetch_block, dedup_mask)
            packed_f, packed_i = _agg_scan_prepared(
                blocks, n_valids, dmasks, where=bound_where, keys=keys,
                nf=nf, has_nan=has_nan, num_segments=num_groups,
                tag_names=tag_names, schema=schema, float_ops=float_ops,
                pack_dtype=pack_dtype)
            return _unpack_acc(packed_f, packed_i, float_ops, int_ops, widths)
        self.last_path = "dense"
        plan = _block_plan(scan)

        def fetch_block(entry):
            return {name: self._device_block(
                scan, name, entry, extra_cols,
                acc_dtype if name in float_fields else None)
                for name in device_col_names}

        blocks, n_valids, dmasks = self._gather_blocks(
            scan, plan, fetch_block, dedup_mask)
        packed_f, packed_i = _agg_scan(
            blocks, n_valids, dmasks, where=bound_where, keys=keys,
            agg_args=arg_exprs, ops=ops, num_segments=num_groups,
            ts_name=ts_name, tag_names=tag_names, schema=schema,
            need_ts=bool({"first", "last"} & set(ops)), acc_dtype=acc_dtype,
            float_ops=float_ops, int_ops=int_ops, pack_dtype=pack_dtype)
        return _unpack_acc(packed_f, packed_i, float_ops, int_ops, widths)

    def _gather_blocks(self, scan, plan, fetch, dedup_mask):
        """Walk the block plan through `fetch`. Returns (blocks, n_valids,
        dedup block masks)."""
        blocks, n_valids = [], []
        dmasks = [] if dedup_mask is not None else None
        for entry in plan:
            blocks.append(fetch(entry))
            n_valids.append(entry.end - entry.start)
            if dmasks is not None:
                dmasks.append(_pad_device_mask(dedup_mask, entry.start,
                                               entry.end, entry.block))
        return blocks, n_valids, dmasks

    def _fused_ok(self, ops, arg_names, num_groups, scan) -> bool:
        """Route to the fused kernel? The JAX package's conditions on the
        op set, the field and group envelope, the dtype and finite values
        (so both serve a query alike); then the mode: `auto` takes the
        route on CUDA, GREPTIMEDB_TPU_PALLAS=on also on the CPU, where
        the kernel's plain version runs."""
        if not set(ops) <= {"sum", "count", "mean", "rows", "min", "max",
                            "sumsq", "first", "last"}:
            return False
        acc_dtype = config.compute_dtype(self.device)
        if "sumsq" in ops and acc_dtype != torch.float64:
            # the kernel accumulates moments in the compute dtype; only
            # f64 carries the variance cancellation
            return False
        if not fused_eligible(len(arg_names), num_groups + 1,
                              want_sumsq="sumsq" in ops):
            return False
        if self._scan_has_inf(scan, arg_names, dtype=acc_dtype):
            return False
        return pallas_mode() == "on" or self.device.type == "cuda"

    def _dense_fused_scan(self, scan, plan, aux_names, arg_names, extra_cols,
                          float_fields, acc_dtype, dedup_mask, bound_where,
                          keys, ops, num_groups, ts_name, tag_names, schema,
                          float_ops, int_ops, pack_dtype):
        """Run the fused-kernel aggregation; returns (packed_f, packed_i).
        A kernel that fails raises: there is no fallback route."""
        need_cols = sorted(set(aux_names) | set(arg_names)
                           | ({ts_name} if int_ops else set()))

        def fetch_block(entry):
            return {name: self._device_block(
                scan, name, entry, extra_cols,
                acc_dtype if name in float_fields else None)
                for name in need_cols}

        blocks, n_valids, dmasks = self._gather_blocks(
            scan, plan, fetch_block, dedup_mask)
        return _agg_scan_fused(
            blocks, n_valids, dmasks, where=bound_where, keys=keys,
            arg_names=arg_names, num_segments=num_groups, ts_name=ts_name,
            tag_names=tag_names, schema=schema, float_ops=float_ops,
            int_ops=int_ops, pack_dtype=pack_dtype, acc_dtype=acc_dtype,
            want_min="min" in ops, want_max="max" in ops,
            want_sumsq="sumsq" in ops)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _device_block(self, scan: ScanData, name, entry: _BlockEntry,
                      extra_cols, cast_dtype):
        """One padded column block through the device hot set."""
        start, end, block = entry.start, entry.end, entry.block

        def build():
            src = extra_cols[name] if name in extra_cols \
                else scan.columns[name]
            arr = pad_rows(src[start:end], block)
            if cast_dtype is not None:
                arr = arr.astype(_NUMPY_OF[cast_dtype], copy=False)
            return self._upload(arr)

        if scan.region_id < 0 or name in extra_cols:
            out = build()  # uncacheable rows: upload, counted
            self.cache.count_upload(out)
            return out
        return self.cache.get(self._hot_key(scan, entry, name,
                                            str(cast_dtype)), build)

    def _hot_key(self, scan, entry: _BlockEntry, name, extra) -> tuple:
        """Hot-set key of one block: snapshot-anchored, so it retires with
        its region's data version."""
        return ("snap", scan.region_id,
                (scan.incarnation, scan.data_version),
                scan.scan_fingerprint, name, entry.start, entry.block, extra)

    def _prepared_ok(self, arg_exprs, ops, int_ops, schema,
                     extra_cols) -> bool:
        """Eligibility for the prepared dense path: plain float/int FIELD
        columns aggregated with sum/count/mean/rows/min/max/sumsq."""
        if int_ops or not arg_exprs:
            return False
        if not set(ops) <= {"mean", "sum", "count", "rows", "min", "max",
                            "sumsq"}:
            return False
        field_names = {c.name for c in schema.field_columns}
        return all(
            isinstance(a, ast.Column) and a.name in field_names
            and a.name not in extra_cols
            for a in arg_exprs)

    def _scan_has_nan(self, scan, arg_names: tuple) -> bool:
        """Whether any aggregated column holds NULLs — decides the
        prepared plane layout. Memoized on the ScanData snapshot."""
        flags = scan.__dict__.setdefault("_nan_flags", {})
        out = False
        for name in arg_names:
            f = flags.get(name)
            if f is None:
                col = np.asarray(scan.columns[name])
                f = bool(np.isnan(col).any()) if col.dtype.kind == "f" \
                    else False
                flags[name] = f
            out = out or f
        return out

    def _scan_has_inf(self, scan, arg_names: tuple, dtype=None) -> bool:
        """Whether any aggregated column holds +-Inf after the cast to the
        compute dtype. The JAX package's fused route refuses such scans
        (its one-hot matmul turns Inf into NaN everywhere); the port keeps
        the rule so both route a query alike. Memoized on the snapshot."""
        flags = scan.__dict__.setdefault("_inf_flags", {})
        np_dt = np.dtype(_NUMPY_OF[dtype]) if dtype is not None else None
        out = False
        for name in arg_names:
            key = (name, np_dt.str if np_dt is not None else None)
            f = flags.get(key)
            if f is None:
                col = np.asarray(scan.columns[name])
                if col.dtype.kind == "f":
                    if np_dt is not None and np_dt.itemsize < col.dtype.itemsize:
                        with np.errstate(over="ignore"):
                            col = col.astype(np_dt)
                    f = bool(np.isinf(col).any())
                else:
                    f = False
                flags[key] = f
            out = out or f
        return out

    def _prep_plane(self, scan, arg_names, entry: _BlockEntry, acc_dtype,
                    has_nan: bool, kind):
        """Query-invariant plane of the prepared path (layout:
        _build_prep), cached in the hot set beside the raw blocks."""

        def build():
            return self._upload(_build_prep(
                scan, arg_names, entry.start, entry.end, entry.block,
                _NUMPY_OF[acc_dtype], has_nan, kind))

        if scan.region_id < 0:
            return build()
        tag = "__prep__" if kind is None else f"__prep_{kind}__"
        return self.cache.get(self._hot_key(
            scan, entry, (tag,) + arg_names, (str(acc_dtype), has_nan)),
            build)

    def _device_columns(self, scan, bound_where, keys, arg_exprs, ts_name,
                        extra_cols):
        needed: set[str] = set()
        collect_columns(bound_where, needed)
        for a in arg_exprs:
            collect_columns(a, needed)
        for k in keys:
            needed.add(k.column)
        needed.add(ts_name)
        avail = set(scan.columns) | set(extra_cols)
        missing = needed - avail
        if missing:
            raise PlanError(f"columns missing from scan: {sorted(missing)}")
        return sorted(needed)

    def _maybe_dedup(self, scan: ScanData, table) -> Optional[torch.Tensor]:
        """Device-resident last-write-wins mask over the scan's rows, or
        None for append-mode tables. Memoized per ScanData."""
        if table.append_mode or not scan.needs_dedup:
            return None
        cached = scan.__dict__.get("_dedup_mask_cache")
        if cached is not None:
            return cached
        mask = self._compute_dedup(scan, table)
        scan._dedup_mask_cache = mask
        return mask

    def _compute_dedup(self, scan: ScanData, table) -> torch.Tensor:
        tag_names = [c.name for c in table.schema.tag_columns]
        n = scan.num_rows
        if tag_names:
            sizes = [len(scan.tag_dicts[t]) + 1 for t in tag_names]
            sid = combine_group_ids(
                [self._upload(scan.columns[t]) + 1 for t in tag_names],
                sizes, dtype=torch.int64)
        else:
            sid = torch.zeros(n, dtype=torch.int64, device=self.device)
        ts = self._upload(scan.columns[table.schema.time_index.name])
        order, keep = sort_dedup(
            sid, ts, self._upload(scan.seq), self._upload(scan.op_type),
            torch.ones(n, dtype=torch.bool, device=self.device))
        mask = torch.zeros(n, dtype=torch.bool, device=self.device)
        mask[order] = keep
        return mask

    # ---- raw (non-aggregate) path ------------------------------------------

    def _filtered_row_indices(self, scan, table, ctx, bound_where,
                              where_unbound=None) -> np.ndarray:
        """Row indices surviving WHERE + LWW dedup, computed blockwise on
        the device. String FIELD columns (not dictionary-coded) cannot
        become device blocks; a WHERE referencing one, or one the device
        evaluator does not cover, filters on the host instead."""
        schema = table.schema
        dedup_mask = self._maybe_dedup(scan, table)
        obj_cols = {name for name, arr in scan.columns.items()
                    if arr.dtype == object and name not in scan.tag_dicts}
        referenced: set = set()
        collect_columns(bound_where, referenced)
        if not referenced & obj_cols:
            try:
                return self._device_filtered_indices(
                    scan, ctx, bound_where, dedup_mask, obj_cols)
            except PlanError:
                pass  # a WHERE construct the device evaluator lacks
        return self._host_filtered_indices(
            scan, schema, bound_where, where_unbound, dedup_mask, referenced)

    def _device_filtered_indices(self, scan, ctx, bound_where, dedup_mask,
                                 obj_cols) -> np.ndarray:
        tag_names = frozenset(ctx.tag_names)
        picked: list[np.ndarray] = []
        for entry in _block_plan(scan):
            cols = {name: self._device_block(scan, name, entry, {}, None)
                    for name in scan.columns if name not in obj_cols}
            dmask = None
            if dedup_mask is not None:
                dmask = _pad_device_mask(dedup_mask, entry.start, entry.end,
                                         entry.block)
            mask = _base_mask(entry.block, entry.end - entry.start, dmask,
                              self.device)
            mask = _where_mask(mask, bound_where, cols, tag_names,
                               scan.schema)
            picked.append(np.flatnonzero(mask.cpu().numpy()) + entry.start)
        return np.concatenate(picked) if picked \
            else np.empty(0, dtype=np.int64)

    def _host_filtered_indices(self, scan, schema, bound_where,
                               where_unbound, dedup_mask,
                               referenced) -> np.ndarray:
        """Numpy filter over host columns: tags referenced by the WHERE
        decode to strings (timestamp-literal coercion still applies)."""
        from greptimedb_tpu_torch.datatypes.vector import DictVector
        from greptimedb_tpu_torch.query.expr import bind_host_expr

        n = scan.num_rows
        host_cols = {}
        for name, arr in scan.columns.items():
            if name in scan.tag_dicts:
                if name not in referenced:
                    continue  # decoding is O(n) python objects — skip
                host_cols[name] = DictVector(
                    arr, scan.tag_dicts[name]).decode()
            else:
                host_cols[name] = arr
        w = bind_host_expr(where_unbound, schema) \
            if where_unbound is not None else bound_where
        if w is None:
            m = np.ones(n, dtype=bool)
        else:
            m = np.asarray(eval_host(w, host_cols, schema))
            m = (m if m.dtype == bool else m != 0)
            m = np.broadcast_to(m, (n,)).copy()
        if dedup_mask is not None:
            m &= dedup_mask.cpu().numpy()[:n]
        return np.flatnonzero(m)

    def _execute_raw(self, scan, table, where, project, sort, limit,
                     offset) -> QueryResult:
        schema = table.schema
        if scan is None:
            return _project_empty(project, schema)
        ctx = BindContext(schema, scan.tag_dicts)
        bound_where = bind_expr(where, ctx) if where is not None else None
        idx = self._filtered_row_indices(scan, table, ctx, bound_where,
                                         where_unbound=where)
        from greptimedb_tpu_torch.datatypes.vector import DictVector

        host_cols: dict[str, np.ndarray] = {}
        for name, arr in scan.columns.items():
            taken = arr[idx]
            if name in scan.tag_dicts:
                taken = DictVector(taken, scan.tag_dicts[name]).decode()
            host_cols[name] = taken
        return self._post_process({}, None, None, project, sort, limit,
                                  offset, table, len(idx),
                                  host_cols=host_cols)

    # ---- shared tail: project/having/sort/limit over host arrays -----------

    def _post_process(self, env, agg, having, project, sort, limit, offset,
                      table, nrows, host_cols=None) -> QueryResult:
        schema = table.schema
        host_cols = host_cols or {}

        if having is not None:
            m = np.asarray(eval_host(having.predicate, host_cols, schema, env))
            m = m if m.dtype == bool else m != 0
            m = np.broadcast_to(m, (nrows,))
            env = {k: v[m] if isinstance(v, np.ndarray) and v.ndim >= 1
                   and len(v) == nrows else v
                   for k, v in env.items()}
            host_cols = {k: v[m] for k, v in host_cols.items()}
            nrows = int(m.sum())

        out_cols: list[np.ndarray] = []
        out_names: list[str] = []
        out_dtypes: list[Optional[DataType]] = []
        for name, e in project.items:
            v = eval_host(e, host_cols, schema, env)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.broadcast_to(arr, (nrows,)).copy()
            out_cols.append(arr)
            out_names.append(name)
            out_dtypes.append(_infer_dtype(e, schema))

        if sort is not None and nrows > 1:
            order = _host_sort_order(sort.keys, project, out_names, out_cols,
                                     host_cols, schema, env)
            out_cols = [c[order] for c in out_cols]
        if offset:
            out_cols = [c[offset:] for c in out_cols]
        if limit is not None:
            out_cols = [c[:limit] for c in out_cols]
        return QueryResult(out_names, out_dtypes, out_cols)

    def _empty_agg_result(self, table, agg, having, project, sort, limit,
                          offset):
        # no data: global aggregates still yield one row
        env: dict = {}
        nrows = 0 if agg.keys else 1
        for name, kexpr in agg.keys:
            env[kexpr] = np.empty(0, dtype=object)
        for spec in agg.aggs:
            if spec.func in ("count", "rows"):
                env[spec.call] = np.zeros(nrows, dtype=np.int64)
            else:
                env[spec.call] = np.full(nrows, np.nan)
        return self._post_process(env, agg, having, project, sort, limit,
                                  offset, table, nrows)


# ---- helpers ---------------------------------------------------------------


def _closed_range(ts_range):
    if ts_range is None:
        return None
    lo, hi = ts_range
    return (lo if lo is not None else -(1 << 62),
            hi if hi is not None else (1 << 62))


def _strides(sizes: list[int]) -> list[int]:
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    return strides


def _finalize_agg(func: str, acc: dict, slot: Optional[int],
                  present: np.ndarray):
    def get(op):
        v = acc[op]
        if v.ndim == 2:
            v = v[:, slot if slot is not None else 0]
        return v[present]

    if func == "rows":
        return get("rows").astype(np.int64)
    if func == "count":
        return get("count").astype(np.int64)
    if func == "sum":
        s, c = get("sum"), get("count")
        return np.where(c > 0, s, np.nan)
    if func == "avg":
        s, c = get("sum"), get("count")
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(c > 0, s / np.maximum(c, 1), np.nan)
    if func in ("min", "max", "first", "last"):
        return get(func)
    if func in ("stddev", "variance"):
        s, ss, c = get("sum"), get("sumsq"), get("count")
        with np.errstate(invalid="ignore", divide="ignore"):
            var = (ss - s * s / np.maximum(c, 1)) / np.maximum(c - 1, 1)
            var = np.where(c > 1, np.maximum(var, 0.0), np.nan)
        return np.sqrt(var) if func == "stddev" else var
    raise PlanError(f"unknown aggregate {func}")


def _infer_dtype(e: ast.Expr, schema) -> Optional[DataType]:
    if isinstance(e, ast.Column) and e.name in schema.names:
        return schema.column(e.name).dtype
    if isinstance(e, ast.FuncCall):
        if e.name in ("date_bin", "time_bucket", "date_trunc"):
            ts_arg = e.args[1] if len(e.args) > 1 else None
            if isinstance(ts_arg, ast.Column) and ts_arg.name in schema.names:
                return schema.column(ts_arg.name).dtype
        if e.name == "count":
            return DataType.INT64
        if e.name in ("min", "max", "first", "last", "first_value",
                      "last_value"):
            arg = e.args[0] if e.args else None
            if isinstance(arg, ast.Column) and arg.name in schema.names:
                dt = schema.column(arg.name).dtype
                if dt.is_timestamp:
                    return dt
            return DataType.FLOAT64
        return DataType.FLOAT64
    if isinstance(e, ast.Literal):
        if isinstance(e.value, bool):
            return DataType.BOOL
        if isinstance(e.value, int):
            return DataType.INT64
        if isinstance(e.value, float):
            return DataType.FLOAT64
        if isinstance(e.value, str):
            return DataType.STRING
    return None


def _host_sort_order(keys, project, out_names, out_cols, host_cols, schema,
                     env):
    sort_arrays = []
    nrows = len(out_cols[0]) if out_cols else 0
    by_name = dict(zip(out_names, out_cols))
    for k in reversed(keys):  # lexsort: primary key last
        if isinstance(k.expr, ast.Column) and k.expr.name in by_name:
            arr = by_name[k.expr.name]
        else:
            arr = np.asarray(eval_host(k.expr, host_cols, schema, env))
            if arr.ndim == 0:
                arr = np.broadcast_to(arr, (nrows,))
        sort_arrays.append(_sortable(arr, k.asc, k.nulls_first))
    return np.lexsort(sort_arrays)


def _sortable(arr: np.ndarray, asc: bool,
              nulls_first: Optional[bool]) -> np.ndarray:
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        mask = np.asarray([v is None for v in arr]) \
            if arr.dtype == object else np.zeros(len(arr), dtype=bool)
        filled = np.where(mask, "", arr.astype(str))
        _, codes = np.unique(filled, return_inverse=True)
        key = codes.astype(np.float64)
        key[mask] = np.nan
    else:
        key = arr.astype(np.float64)
    isnan = np.isnan(key)
    if not asc:
        key = -key
    # SQL default: NULLS LAST for ASC, NULLS FIRST for DESC
    nf = nulls_first if nulls_first is not None else (not asc)
    return np.where(isnan, -np.inf if nf else np.inf, key)


def _project_empty(project, schema) -> QueryResult:
    names = [n for n, _ in project.items]
    dtypes = [_infer_dtype(e, schema) for _, e in project.items]
    cols = [np.empty(0) for _ in project.items]
    return QueryResult(names, dtypes, cols)
