"""Physical execution: logical plan -> device kernels over padded column
blocks (counterpart of greptimedb_tpu/query/physical.py).

  host scan (columnar)  ->  fixed-shape padded blocks on the device  ->
  per block: WHERE mask + group ids + segment reduction  ->  partial
  combine across blocks  ->  host tail (decode group keys, HAVING / ORDER
  / LIMIT over G rows)

Aggregation routes, chosen by the JAX package's rules so a query takes
the same route and `last_path` reads the same on both:
- `dense_fused`: the fused CUDA kernel over raw value columns
  (ops/segment_kernels.py::fused_segment_agg, K2);
- `dense_prepared`: the CUDA segment-sum kernel over a query-invariant
  [values | validity | ones] plane held in the hot set
  (ops/segment_kernels.py::segment_sum, K1);
- `dense`: plain PyTorch segment reductions for everything else
  (first/last over expressions, non-field arguments);
- `sparse_fused` / `sparse`: past config.dense_groups_max() the observed
  group ids are sort-compacted over the whole scan
  (ops/sparse_segment.py) and reduced by one K2 call, or by plain
  segment reductions where K2 does not apply;
- `incremental` / `incremental_sparse`: an aggregate over immutable SST
  parts folds per-part partials from the partial-aggregate cache
  (query/partial_cache.py) and computes only uncached parts and the
  memtable tail, each through the kernel route above;
- order statistics (median, percentile, argmax, argmin, polyval,
  count_distinct, string first/last/min/max) run on the host
  (query/host_agg.py) beside any of the dense or sparse routes;
- `stream_prepared` / `stream`: an aggregate over an append-mode table
  whose row estimate reaches config.stream_threshold_rows() never
  materializes its scan. Lazy SST chunks (Region.scan_stream) become
  fixed-shape blocks on a producer thread (`_prefetch`) and fold into an
  accumulator on the device: one K1 call a block over prepared planes,
  or plain segment reductions and `_combine_partials` for the rest;
- `lastscan+…`: an all-`last` aggregate grouped by one tag, with no
  WHERE, reads SSTs newest-first and stops early (Region.scan_last);
- `boundary+…`: an all-first/last aggregate grouped by tags keeps only
  the rows at series-run boundaries of the sorted SST parts, and the
  memtable's, before any route runs (`_boundary_firstlast`).
Tensors stay on the executor's device; only the result planes come back.
A kernel that fails raises: no route catches it and serves another.

Parameter-sibling batches from the serving batcher take `dense_vmapped`
/ `sparse_vmapped` (query/vmapped.py), one K2 launch a batch. Left out
(the JAX package's paths, each listed in ROADMAP.md): mesh and cluster
fan-out, fragment pushdown, and tier routing and its first-touch compile
hedges.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from greptimedb_tpu_torch import config
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.ops import segment_kernels
from greptimedb_tpu_torch.ops import sparse_segment as sparse_ops
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
from greptimedb_tpu_torch.query import partial_cache as pc
from greptimedb_tpu_torch.query.device_cache import DeviceCache
from greptimedb_tpu_torch.query.dist_agg import combine_partials
from greptimedb_tpu_torch.query.expr import (
    BindContext,
    PlanError,
    bind_expr,
    collect_columns,
    eval_device,
    eval_host,
)
from greptimedb_tpu_torch.query.host_agg import HOST_AGGS
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.storage.region import OP_PUT, ScanData
from greptimedb_tpu_torch.utils import deadline as dl
from greptimedb_tpu_torch.utils import device_telemetry, tracing
from greptimedb_tpu_torch.utils import flame as _flame

# device memory telemetry: the CUDA allocator and the hot set's bytes,
# read at scrape time
device_telemetry.install()


def _to_host(t: torch.Tensor) -> np.ndarray:
    """D2H result materialization, counted: the aggregation routes pull
    their planes to the host through here (device_transfer_bytes and
    the request ledger's d2h_bytes). On the card the copy waits for the
    kernels that produced `t`, so a span that closes after it covers
    them — no synchronize is added."""
    arr = t.cpu().numpy()
    device_telemetry.count_d2h(arr.nbytes)
    return arr


def _upload_counted(arr: np.ndarray, device) -> torch.Tensor:
    """An upload that bypasses the hot set (streamed blocks, dedup
    inputs, RANGE's slot columns), counted as H2D."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    device_telemetry.count_h2d(t.numel() * t.element_size())
    return t

_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64}

# the boundary first/last gather pays only when it shrinks the scan: past
# this share of candidate rows the subset would copy most of the columns
# for no kernel savings (tests patch it to force the gather on)
_BOUNDARY_MAX_FRACTION = 0.5

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
    """One device block of the scan: rows [start, end) padded to `block`.
    `pkey` is the immutable SST part the rows belong to ((file_id,
    ts_range, pred_key) from ScanData.part_keys), or None for memtable
    rows; `part_start` anchors the block's offset inside its part, so its
    hot-set key stays stable across data versions."""

    pkey: Optional[tuple]
    part_start: int
    start: int
    end: int
    block: int


@dataclass
class _AggQuery:
    """One aggregate's device-side shape, shared by every route that can
    run it (whole-scan dense or sparse, and per part in the incremental
    fold): the scan, the bound WHERE, the keys and value expressions, the
    primitive ops, and the packed output layout."""

    scan: ScanData
    schema: object
    where: Optional[ast.Expr]
    keys: tuple
    arg_exprs: tuple
    ops: tuple  # sorted primitive ops
    num_groups: int  # dense key product
    ts_name: str
    tag_names: frozenset
    extra_cols: dict
    acc_dtype: torch.dtype
    float_fields: frozenset
    dedup_mask: Optional[torch.Tensor]
    float_ops: tuple
    int_ops: tuple
    widths: dict
    pack_dtype: torch.dtype

    @property
    def arg_names(self) -> tuple:
        return tuple(getattr(a, "name", None) for a in self.arg_exprs)

    def want(self) -> dict:
        """The fused kernel's optional planes for these ops."""
        return {"want_min": "min" in self.ops, "want_max": "max" in self.ops,
                "want_sumsq": "sumsq" in self.ops}


#: ceiling on the part-aligned plan's blocks: a region with many small
#: unmerged flush files would otherwise launch the kernels once per tiny
#: part; past it the scan takes the uniform, version-keyed layout until
#: compaction catches up
_MAX_PLAN_BLOCKS = 64


def _block_plan(scan) -> list[_BlockEntry]:
    """Part-aligned block plan: blocks never straddle SST part seams, so
    each block is a pure function of its immutable file (and the
    window/predicate key) and its upload survives data-version bumps —
    a write uploads only the memtable tail, a flush only its new file.
    Scans without part identity get the uniform layout."""
    n = scan.num_rows
    offs = scan.sorted_part_offsets
    pkeys = scan.part_keys
    segs: list[tuple] = []
    if pkeys and len(offs) == len(pkeys) + 1 and offs[-1] <= n:
        segs = [(pkeys[i], offs[i], offs[i + 1]) for i in range(len(pkeys))]
        if offs[-1] < n:  # memtable tail: version-keyed, no part identity
            segs.append((None, offs[-1], n))
        est = sum(
            -(-max(s1 - s0, 1) // min(block_size_for(s1 - s0),
                                      DEFAULT_BLOCK_ROWS))
            for _, s0, s1 in segs if s1 > s0)
        if est > _MAX_PLAN_BLOCKS:
            segs = []
    if not segs:
        segs = [(None, 0, n)]
    plan: list[_BlockEntry] = []
    for pk, s0, s1 in segs:
        if s1 <= s0:
            continue
        pb = min(block_size_for(s1 - s0), DEFAULT_BLOCK_ROWS)
        for st in range(s0, s1, pb):
            plan.append(_BlockEntry(pk, s0, st, min(st + pb, s1), pb))
    return plan


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
    return _pack_part(acc, float_ops, int_ops, pack_dtype)


def _pack_part(part: dict, float_ops, int_ops, pack_dtype):
    """Pack a segment_agg plane dict into one float and one int matrix
    (the layout _unpack_acc splits)."""
    parts = []
    for k in float_ops:
        v = part[k]
        if v.dim() == 1:
            v = v[:, None]
        parts.append(v.to(pack_dtype))
    packed_f = torch.cat(parts, dim=1)
    packed_i = torch.stack([part[k] for k in int_ops], dim=1) if int_ops \
        else None
    return packed_f, packed_i


def _sparse_gid(cols: dict, keys) -> torch.Tensor:
    """Combined int64 group id per row. Tag codes and bucket bases do not
    depend on which rows a block holds, so ids computed per part merge
    globally (the mixed radix of _strides over the keys' sizes; tag codes
    shift by one so NULL is 0)."""
    key_arrays = []
    for k in keys:
        c = cols[k.column]
        if k.kind == "tag":
            arr = c.to(torch.int64) + 1
        elif k.kind == "bucket":
            arr = torch.div(c, k.step, rounding_mode="floor") - k.base
        else:
            arr = c.to(torch.int64)
        key_arrays.append(arr.clamp(0, k.size - 1))
    return combine_group_ids(key_arrays, tuple(k.size for k in keys),
                             dtype=torch.int64)


def _agg_scan_sparse(cols, base_mask, q: _AggQuery, cap: int,
                     scope: str = "query"):
    """Sparse (high-cardinality) aggregation over padded columns: sort the
    observed int64 group ids, compact them to ranks [0, U) and reduce
    with plain segment reductions over U segments (every op, first/last
    included). Returns (packed_f, packed_i, uniq [U] int64, U)."""
    mask = _where_mask(base_mask, q.where, cols, q.tag_names, q.schema)
    gid = _sparse_gid(cols, q.keys)
    if q.arg_exprs:
        values = _value_planes(q.arg_exprs, cols, q.tag_names, q.schema,
                               mask.shape, q.acc_dtype)
    else:
        values = torch.zeros((mask.shape[0], 1), dtype=q.acc_dtype,
                             device=mask.device)
    ts = cols[q.ts_name] if {"first", "last"} & set(q.ops) else None
    part, uniq, u = sparse_ops.sparse_segment_agg(
        values, gid, mask, cap, ops=q.ops, ts=ts, scope=scope)
    packed_f, packed_i = _pack_part(part, q.float_ops, q.int_ops,
                                    q.pack_dtype)
    return packed_f, packed_i, uniq, u


def _agg_scan_sparse_fused(cols, base_mask, q: _AggQuery, cap: int,
                           scope: str = "query"):
    """Sparse aggregation with the reductions on K2: sort-compact once,
    gather the raw field values in sorted order and make ONE
    fused_segment_agg call over U + 1 segments (the JAX package tiles its
    Pallas kernel in 4,088-segment windows; K2 has no segment cap).
    Eligibility (plain finite field columns, the op subset) is the
    caller's: PhysicalExecutor._sparse_fused_ok."""
    mask = _where_mask(base_mask, q.where, cols, q.tag_names, q.schema)
    gid = _sparse_gid(cols, q.keys)
    order, ids, _, uniq, u = sparse_ops.sort_compact(gid, mask, cap, scope)
    vals = torch.stack([cols[a].to(q.acc_dtype) for a in q.arg_names],
                       dim=1)[order]
    out = sparse_ops.fused_sparse_segment_agg(vals, ids, u, **q.want())
    packed_f = _pack_float_ops(out["sum"], out["count"],
                               out["rows"][:, None], out.get("min"),
                               out.get("max"), out.get("sumsq"),
                               q.float_ops, q.pack_dtype)
    return packed_f, None, uniq, u


def _agg_block_sparse(cols, n_valid, dedup_mask, q: _AggQuery, cap: int,
                      fused: bool):
    """Sparse twin of the per-block kernels for the incremental per-part
    fold: sort-compact one part's observed group ids and reduce them
    (through K2 when `fused`). The partial carries [U, F] planes and the
    rank -> global-id table."""
    some = next(iter(cols.values()))
    mask = _base_mask(some.shape[0], n_valid, dedup_mask, some.device)
    run = _agg_scan_sparse_fused if fused else _agg_scan_sparse
    return run(cols, mask, q, cap, scope="part")


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
    host_f = _to_host(packed_f)
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
        host_i = _to_host(packed_i)
        for j, k in enumerate(int_ops):
            acc[k] = host_i[:, j]
    return acc


# ---- streaming beyond device memory -------------------------------------------


class _NotStreamable(Exception):
    """A plan the streaming route cannot serve (generic group keys, host
    order statistics, sparse cardinality): a typed decision about the
    plan, after which the query takes the materialized route."""


class _StreamStats:
    """Counters of one streamed aggregate, updated by the producer and the
    consumer thread: chunks, blocks, rows, bytes uploaded, and the host
    bytes in flight (decoded chunks and built blocks not yet uploaded)
    with their peak, which stays within one chunk and depth + 2 blocks,
    and where the time went (`_prefetch`)."""

    def __init__(self, depth: int):
        self._lock = threading.Lock()
        self.depth = depth
        self.chunks = self.blocks = self.rows = self.h2d_bytes = 0
        self.host_bytes = self.peak_host_bytes = 0
        self.chunk_bytes_max = self.block_bytes_max = 0
        # the producer's busy time and the consumer's wait for blocks
        self.produce_s = self.wait_s = 0.0

    def hold(self, nbytes: int, chunk: bool) -> None:
        with self._lock:
            self.host_bytes += nbytes
            self.peak_host_bytes = max(self.peak_host_bytes, self.host_bytes)
            if chunk:
                self.chunks += 1
                self.chunk_bytes_max = max(self.chunk_bytes_max, nbytes)
            else:
                self.blocks += 1
                self.block_bytes_max = max(self.block_bytes_max, nbytes)

    def release(self, nbytes: int, uploaded: bool = False) -> None:
        with self._lock:
            self.host_bytes -= nbytes
            if uploaded:
                self.h2d_bytes += nbytes

    def as_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k != "_lock"}


def _prefetch(items, depth: int = 2, stats: Optional[_StreamStats] = None):
    """Run `items` (the host work of a stream: SST reads, decode, padding
    and plane builds) on a producer thread, up to `depth` items ahead of
    the consumer, through a bounded queue: at most depth + 2 items exist
    at once (queued, one blocked in the producer's put, one with the
    consumer). A producer error re-raises on the consumer after the items
    before it. Closing the generator stops the producer at its next put;
    on every exit the producer thread is joined before the generator
    returns, so no thread outlives its query and no read outlives the
    stream's file pins. `stats` gets the producer's busy seconds and the
    consumer's seconds waiting for an item."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            it = iter(items)
            while True:
                t = time.perf_counter()
                item = next(it, done)
                if stats is not None:
                    stats.produce_s += time.perf_counter() - t
                if item is done or not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            err.append(e)
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()  # on this thread: runs the stream's finally
            put(done)

    # the producer's spans and ledger adds (chunk decode) belong to the
    # query that streams
    t = threading.Thread(target=tracing.propagate(producer),
                         name="gtpu-stream-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            while True:
                try:
                    item = q.get(timeout=0.1)
                    break
                except queue.Empty:
                    # deadline checkpoint: a cancelled or expired query
                    # unwinds typed; the finally stops the producer
                    dl.check("streaming scan wait")
            dl.check("streaming scan block")
            if stats is not None:
                stats.wait_s += time.perf_counter() - t0
            if item is done:
                break
            yield item
            item = None
        if err:
            raise err[0]
    finally:
        stop.set()
        while True:  # free the queued items and a producer blocked in put
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()


def _stream_blocks(stream, stats: _StreamStats, block: int, names,
                   casts: dict, planes=None):
    """The stream's chunks cut into zero-padded blocks of `block` rows:
    the columns `names` (cast where `casts` names a numpy dtype) plus the
    arrays `planes(chunk, start, end)` builds. A chunk counts in flight
    until the next one is asked for, a block until it is uploaded."""
    for cols, nrows in stream.chunks():
        nbytes = sum(int(a.nbytes) for a in cols.values())
        stats.hold(nbytes, chunk=True)
        stats.rows += nrows
        chunk = SimpleNamespace(columns=cols)
        try:
            for start in range(0, nrows, block):
                end = min(start + block, nrows)
                blk = {name: _block_column(cols[name], start, end, block,
                                           casts.get(name))
                       for name in names}
                if planes is not None:
                    blk.update(planes(chunk, start, end))
                stats.hold(sum(a.nbytes for a in blk.values()), chunk=False)
                yield blk, end - start
                blk = None
        finally:
            stats.release(nbytes)
        del cols, chunk


def _block_column(arr: np.ndarray, start: int, end: int, block: int,
                  np_dtype=None) -> np.ndarray:
    """Rows [start, end) of a chunk column as a new zero-padded block,
    cast to `np_dtype`: a copy, so a queued block never keeps its chunk
    alive."""
    out = np.zeros(block, dtype=np_dtype or arr.dtype)
    out[:end - start] = arr[start:end]
    return out


# ---- executor ----------------------------------------------------------------


class PhysicalExecutor:
    def __init__(self, engine, device: torch.device):
        self.engine = engine
        self.device = device
        self.cache = DeviceCache(config.device_cache_bytes(device))
        # the storage engine drops dead files' and regions' blocks, and
        # their entries in the process-wide partial-aggregate cache
        engine.caches.add(self.cache)
        engine.caches.add(pc.global_cache())
        # this thread's last query: which aggregate route served it, the
        # incremental fold's part stats, the sparse route's group count
        self._tls = threading.local()
        # PromQL's loaded series (keyed on the scan snapshot and the
        # selector), grid pivots and their prefix sums (keyed on the
        # loaded tensors' identity): promql/engine.py
        self.promql_load_cache: OrderedDict = OrderedDict()
        self.promql_pivot_cache: list = []
        self.promql_cumsum_cache: list = []

    @property
    def last_path(self):
        return getattr(self._tls, "last_path", None)

    @last_path.setter
    def last_path(self, v):
        self._tls.last_path = v
        # the continuous profiler attributes samples by execution path;
        # this setter is the one choke point every path tag flows
        # through (one attribute read when profiling is off)
        if _flame._ENABLED:
            _flame.note_path(v)

    @property
    def statement_paths(self) -> list:
        """The route of each aggregate this thread's last statement ran,
        in order (a CTE's, a subquery's, a view's and the outer one's);
        `last_path` is the last of them."""
        paths = getattr(self._tls, "statement_paths", None)
        if paths is None:
            paths = self._tls.statement_paths = []
        return paths

    @statement_paths.setter
    def statement_paths(self, v):
        self._tls.statement_paths = v

    @property
    def last_partial_stats(self) -> Optional[dict]:
        return getattr(self._tls, "last_partial_stats", None)

    @last_partial_stats.setter
    def last_partial_stats(self, v):
        self._tls.last_partial_stats = v

    @property
    def last_promql_paths(self) -> Optional[list]:
        """The window path of each range or instant selector of this
        thread's last PromQL evaluation: "edges", "sums" (the grid fast
        paths) or "window_stats"."""
        return getattr(self._tls, "last_promql_paths", None)

    @last_promql_paths.setter
    def last_promql_paths(self, v):
        self._tls.last_promql_paths = v

    @property
    def last_sparse_stats(self) -> Optional[dict]:
        return getattr(self._tls, "last_sparse_stats", None)

    @last_sparse_stats.setter
    def last_sparse_stats(self, v):
        self._tls.last_sparse_stats = v

    @property
    def last_stream_stats(self) -> Optional[dict]:
        """The streaming route's counters of this thread's last query
        (_StreamStats), or None when it did not stream."""
        return getattr(self._tls, "last_stream_stats", None)

    @last_stream_stats.setter
    def last_stream_stats(self, v):
        self._tls.last_stream_stats = v

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
            # lastpoint pruning: an all-`last` aggregate grouped by one
            # tag needs only each series' newest rows, so the region
            # walks SSTs newest-first and stops early. None (tombstones,
            # no data) takes the normal routes, as in the JAX package
            lp_tag = self._lastpoint_tag(table, where, agg, ts_range)
            if lp_tag is not None:
                with tracing.span("scan", table=table.name, regions=1,
                                  lastpoint=True):
                    pruned = self.engine.scan_last(table.region_ids[0],
                                                   lp_tag, scan_node.columns)
                if pruned is not None:
                    with tracing.span("aggregate", rows=pruned.num_rows):
                        res = self._execute_agg(pruned, table, where, agg,
                                                having, project, sort,
                                                limit, offset, scan_node)
                    self.last_path = "lastscan+" + (self.last_path or "")
                    return res
            if agg is not None and table.append_mode:
                res = self._try_stream_agg(table, ts_range, where, agg,
                                           having, project, sort, limit,
                                           offset, scan_node, tag_preds)
                if res is not None:
                    return res
            with tracing.span("scan", table=table.name,
                              regions=len(table.region_ids)) as scan_attrs:
                scan = self.engine.scan(table.region_ids[0], ts_range,
                                        scan_node.columns, tag_preds)
                # rows land on the span (and, through it, the resource
                # ledger's rows_scanned)
                scan_attrs["rows"] = 0 if scan is None else scan.num_rows
            nrows = 0 if scan is None else scan.num_rows
            if agg is not None:
                with tracing.span("aggregate", rows=nrows):
                    return self._execute_agg(scan, table, where, agg,
                                             having, project, sort, limit,
                                             offset, scan_node)
            # every port query runs on the engine's device: the JAX
            # package's tier label is "device" there too
            with tracing.span("filter_project", rows=nrows, tier="device"):
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

    def _lastpoint_tag(self, table, where, agg, ts_range) -> Optional[str]:
        """The group tag when the query is lastpoint-shaped: every
        aggregate is a device `last`, the one group key is a plain tag
        column, and no WHERE or time range restricts the rows the
        newest-first stop argument reasons over. None otherwise."""
        if agg is None or not agg.aggs or where is not None \
                or ts_range is not None:
            return None
        if any(spec.func != "last" or _needs_host_agg(spec, table.schema)
               for spec in agg.aggs):
            return None
        if len(agg.keys) != 1:
            return None
        _, kexpr = agg.keys[0]
        if not isinstance(kexpr, ast.Column):
            return None
        tag_names = {c.name for c in table.schema.tag_columns}
        return kexpr.name if kexpr.name in tag_names else None

    # ---- streaming aggregation ------------------------------------------------

    def _try_stream_agg(self, table, ts_range, where, agg, having, project,
                        sort, limit, offset, scan_node,
                        tag_preds=None) -> Optional[QueryResult]:
        """Beyond-RAM aggregate scans stream (the JAX executor's dispatch,
        physical.py:1590-1615): before the materialized scan and the
        incremental fold. None when the row estimate is under
        config.stream_threshold_rows() or the plan is _NotStreamable; the
        caller then takes the materialized route."""
        stream = self.engine.scan_stream(table.region_ids[0], ts_range,
                                         scan_node.columns, tag_preds)
        if stream is None:
            return None
        try:
            if stream.est_rows < config.stream_threshold_rows():
                return None
            return self._execute_agg_stream(stream, table, where, agg,
                                            having, project, sort, limit,
                                            offset, scan_node)
        except _NotStreamable:
            return None
        finally:
            # idempotent: releases the pins of a stream that was never
            # iterated or was abandoned
            stream.close()

    def _execute_agg_stream(self, stream, table, where, agg, having,
                            project, sort, limit, offset,
                            scan_node) -> QueryResult:
        """Bounded-memory aggregation: lazy scan chunks fold into an
        accumulator on the device. Raises _NotStreamable for plans that
        need the whole scan on the host (generic keys, order statistics)
        or sparse cardinality."""
        schema = table.schema
        ctx = BindContext(schema, stream.tag_dicts)
        bound_where = bind_expr(where, ctx) if where is not None else None
        keys: list[DeviceKey] = []
        decoders = []
        for kexpr in (k for _, k in agg.keys):
            dk, decode = self._plan_key_stream(kexpr, ctx, stream, scan_node)
            keys.append(dk)
            decoders.append(decode)
        num_groups = 1
        for k in keys:
            num_groups *= k.size
        if num_groups > config.dense_groups_max():
            raise _NotStreamable("sparse cardinality")
        arg_exprs: list[ast.Expr] = []
        spec_slot: list[Optional[int]] = []
        for spec in agg.aggs:
            if _needs_host_agg(spec, schema):
                raise _NotStreamable(f"host aggregate {spec.func}")
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
        self.last_partial_stats = None
        self.last_sparse_stats = None
        stats = _StreamStats(depth=2)
        acc = self._fold_stream(stream, schema, bound_where, tuple(keys),
                                tuple(arg_exprs), tuple(sorted(ops)),
                                num_groups, ctx, stats)
        self.last_stream_stats = stats.as_dict()
        return self._agg_tail(acc, None, agg, keys, decoders, spec_slot,
                              None, having, project, sort, limit, offset,
                              table)

    def _fold_stream(self, stream, schema, bound_where, keys, arg_exprs, ops,
                     num_groups, ctx, stats) -> dict:
        """The general streaming fold: per block, plain segment reductions
        (`_agg_block`) combined across blocks (`_combine_partials`).
        Returns host planes indexed by global group id."""
        ts_name = schema.time_index.name
        acc_dtype = config.compute_dtype(self.device)
        tag_names = frozenset(ctx.tag_names)
        float_fields = {c.name for c in schema.field_columns
                        if c.dtype.is_float}
        nf = max(len(arg_exprs), 1)
        need_ts = bool({"first", "last"} & set(ops))
        block = config.stream_block_rows()
        if not need_ts and self._prepared_ok(arg_exprs, ops, (), schema, {}):
            self.last_path = "stream_prepared"
            return self._fold_stream_prepared(
                stream, bound_where, keys, arg_exprs, ops, num_groups,
                tag_names, float_fields, schema, block, acc_dtype, stats)
        self.last_path = "stream"
        needed: set[str] = {ts_name}
        collect_columns(bound_where, needed)
        for a in arg_exprs:
            collect_columns(a, needed)
        needed.update(k.column for k in keys)
        names = sorted(needed)
        casts = dict.fromkeys(float_fields, _NUMPY_OF[acc_dtype])
        acc = None
        gen = _prefetch(_stream_blocks(stream, stats, block, names, casts),
                        stats.depth, stats)
        try:
            for blk, n_valid in gen:
                dev = self._upload_block(blk, stats)
                blk = None
                part = _agg_block(
                    dev, n_valid, None, where=bound_where, keys=keys,
                    agg_args=arg_exprs, ops=ops, num_segments=num_groups,
                    ts_name=ts_name, tag_names=tag_names, schema=schema,
                    need_ts=need_ts, acc_dtype=acc_dtype)
                acc = _combine_partials(acc, part)
        finally:
            # the producer stops before the caller's stream.close()
            # drops the file pins
            gen.close()
        G = num_groups
        if acc is None:  # pruning left nothing: identity planes
            out: dict = {}
            for op in ops:
                if op == "rows":
                    out[op] = np.zeros((G, 1), dtype=np.int64)
                elif op == "count":
                    out[op] = np.zeros((G, nf), dtype=np.int64)
                elif op in ("sum", "sumsq"):
                    out[op] = np.zeros((G, nf))
                else:  # min, max, first, last
                    out[op] = np.full((G, nf), np.nan)
                    if op in ("first", "last"):
                        out[op + "_ts"] = np.zeros(G, dtype=np.int64)
            return out
        out = {k: _to_host(v) for k, v in acc.items()}
        for k in ("count", "rows"):
            if k in out:
                out[k] = out[k].astype(np.int64)
        return out

    def _fold_stream_prepared(self, stream, bound_where, keys, arg_exprs,
                              ops, num_groups, tag_names, float_fields,
                              schema, block, acc_dtype, stats) -> dict:
        """The streaming twin of `dense_prepared`: each block's
        [values | validity | ones] plane is built on the producer thread
        (conservatively with the validity columns, W = 2F + 1: a stream
        cannot pre-scan its chunks for NULLs), uploaded, and folded by
        ONE K1 call over G + 1 segments, masked rows in the dead segment
        G. The accumulators are allocated once on the device and updated
        in place (add_, minimum/maximum with out=): the answer to the JAX
        package's donated buffers. Streamed blocks never enter the hot
        set."""
        G = num_groups
        nf = len(arg_exprs)
        arg_names = tuple(a.name for a in arg_exprs)
        aux: set[str] = set()
        collect_columns(bound_where, aux)
        aux.update(k.column for k in keys)
        aux_names = sorted(aux)
        np_acc = _NUMPY_OF[acc_dtype]
        # variance/stddev difference two moments: both carry f64
        prep_dtype = torch.float64 if "sumsq" in ops else acc_dtype
        np_prep = _NUMPY_OF[prep_dtype]

        def planes(chunk, start, end):
            out = {"__prep__": _build_prep(chunk, arg_names, start, end,
                                           block, np_prep, True, None)}
            for kind in ("min", "max"):
                if kind in ops:
                    out[f"__prep_{kind}__"] = _build_prep(
                        chunk, arg_names, start, end, block, np_acc, False,
                        kind)
            if "sumsq" in ops:
                out["__prep_sq__"] = _build_prep(
                    chunk, arg_names, start, end, block, np.float64, False,
                    "sq")
            return out

        dev = self.device
        total = torch.zeros((G, 2 * nf + 1), dtype=prep_dtype, device=dev)
        tmin = torch.full((G, nf), float("inf"), dtype=acc_dtype,
                          device=dev) if "min" in ops else None
        tmax = torch.full((G, nf), float("-inf"), dtype=acc_dtype,
                          device=dev) if "max" in ops else None
        tsq = torch.zeros((G, nf), dtype=torch.float64, device=dev) \
            if "sumsq" in ops else None
        gen = _prefetch(_stream_blocks(
            stream, stats, block, aux_names,
            dict.fromkeys(float_fields, np_acc), planes), stats.depth, stats)
        try:
            for blk, n_valid in gen:
                cols = self._upload_block(blk, stats)
                blk = None
                plane = cols["__prep__"]
                mask = _base_mask(plane.shape[0], n_valid, None, dev)
                mask = _where_mask(mask, bound_where, cols, tag_names,
                                   schema)
                gid = _group_ids(cols, keys, plane.shape[0])
                ids = torch.where(mask, gid, torch.full_like(gid, G))
                total.add_(dense_segment_sum(plane, ids, G + 1)[:G])
                if tmin is not None:
                    torch.minimum(tmin, _seg_reduce(
                        cols["__prep_min__"], ids, G + 1, "amin",
                        float("inf"))[:G], out=tmin)
                if tmax is not None:
                    torch.maximum(tmax, _seg_reduce(
                        cols["__prep_max__"], ids, G + 1, "amax",
                        float("-inf"))[:G], out=tmax)
                if tsq is not None:
                    tsq.add_(dense_segment_sum(cols["__prep_sq__"], ids,
                                               G + 1)[:G])
                del cols, plane, mask, gid, ids
        finally:
            gen.close()
        host = _to_host(total)
        out: dict = {}
        for op in ops:
            if op == "sum":
                out[op] = host[:, :nf]
            elif op == "count":
                # f32 counts are exact below 2**24 rows a group
                out[op] = host[:, nf:2 * nf].astype(np.int64)
            elif op == "rows":
                out[op] = host[:, 2 * nf:].astype(np.int64)
            elif op == "sumsq":
                out[op] = _to_host(tsq)
            elif op == "min":  # an empty or all-NULL group reads as NULL
                ext = _to_host(tmin)
                out[op] = np.where(np.isposinf(ext), np.nan, ext)
            else:
                ext = _to_host(tmax)
                out[op] = np.where(np.isneginf(ext), np.nan, ext)
        return out

    def _upload_block(self, blk: dict, stats: _StreamStats) -> dict:
        """One streamed block to the device: a synchronous copy from
        pageable host memory, so the host arrays are free when it
        returns."""
        cols = {k: _upload_counted(a, self.device) for k, a in blk.items()}
        stats.release(sum(int(a.nbytes) for a in blk.values()),
                      uploaded=True)
        return cols

    def _plan_key_stream(self, kexpr, ctx, stream, scan_node):
        """Key planning from the stream's metadata only (no data columns):
        tag keys decode from the registry dictionaries, time buckets take
        their extent from the pruned files' stats and the memtable.
        Anything that needs the rows raises _NotStreamable."""
        ts_col = ctx.schema.time_index
        if isinstance(kexpr, ast.Column) and kexpr.name in ctx.tag_names:
            return _tag_key(kexpr.name, stream.tag_dicts[kexpr.name])
        step = _bucket_step(kexpr, ts_col)
        if step is not None:
            lo, hi = self._ts_bounds(scan_node, None,
                                     fallback=(stream.ts_min, stream.ts_max))
            return _bucket_key(ts_col, step, lo, hi)
        raise _NotStreamable(f"group key {kexpr!r} needs the materialized "
                             "scan")

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
        self.last_partial_stats = None
        self.last_sparse_stats = None
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
        if num_groups >= sparse_ops.GID_SENTINEL:
            raise PlanError(
                f"group key space {num_groups} overflows the int64 id "
                "domain; add predicates or reduce keys")
        # dense [G, F] planes up to the budget; past it the sparse
        # sort-compact route. sparse_groups_min (off by default) pulls
        # smaller key products onto the sparse route too
        sparse = bool(keys) and (
            num_groups > config.dense_groups_max()
            or (config.sparse_groups_min() > 0
                and num_groups >= config.sparse_groups_min()))

        # host-computed aggregates consume no device value plane
        arg_exprs: list[ast.Expr] = []
        spec_slot: list[Optional[int]] = []
        for spec in agg.aggs:
            if spec.arg is None or _needs_host_agg(spec, schema):
                spec_slot.append(None)
                continue
            b = bind_expr(spec.arg, ctx)
            if b not in arg_exprs:
                arg_exprs.append(b)
            spec_slot.append(arg_exprs.index(b))
        ops: set = {"rows"}
        for spec in agg.aggs:
            if not _needs_host_agg(spec, schema):
                ops.update(_PRIMITIVES[spec.func])

        # the boundary first/last gather runs before the incremental
        # fold, as in the JAX package: a reduced scan has no part
        # identity and takes the classic routes
        reduced = self._boundary_firstlast(scan, table, agg, bound_where,
                                           keys, extra_cols)
        if reduced is not None:
            scan = reduced
        q = self._agg_query(scan, table, bound_where, tuple(keys),
                            tuple(arg_exprs), tuple(sorted(ops)), num_groups,
                            ctx, extra_cols)
        # immutable parts' partials come from the partial-aggregate cache
        # and only uncached parts and the memtable tail run kernels; a
        # plan the per-part decomposition cannot serve returns None
        if reduced is None:
            res = self._try_incremental_agg(q, agg, decoders, spec_slot,
                                            sparse, table, having, project,
                                            sort, limit, offset)
            if res is not None:
                return res
        with tracing.span("device_agg", rows=scan.num_rows,
                          groups=num_groups):
            # closes after the planes' pull to the host (_to_host), which
            # waits for the kernels: device_ms covers them
            acc, sparse_gids = self._stream_agg_inner(q, sparse)
        if reduced is not None:
            self.last_path = "boundary+" + (self.last_path or "")
        host_info = (scan, extra_cols, bound_where, ctx, num_groups)
        return self._agg_tail(acc, sparse_gids, agg, keys, decoders,
                              spec_slot, host_info, having, project, sort,
                              limit, offset, table)

    def _agg_query(self, scan, table, bound_where, keys, arg_exprs, ops,
                   num_groups, ctx, extra_cols) -> _AggQuery:
        schema = table.schema
        ts_name = schema.time_index.name
        acc_dtype = config.compute_dtype(self.device)
        # raises on a column the scan lacks
        self._device_columns(scan, bound_where, keys, arg_exprs, ts_name,
                             extra_cols)
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
        pack_dtype = torch.float64 if num_groups <= 4096 else acc_dtype
        if "sumsq" in float_ops:
            # f32 packing would undo the f64 moment accumulation
            pack_dtype = torch.float64
        return _AggQuery(
            scan=scan, schema=schema, where=bound_where, keys=keys,
            arg_exprs=arg_exprs, ops=ops, num_groups=num_groups,
            ts_name=ts_name, tag_names=frozenset(ctx.tag_names),
            extra_cols=extra_cols, acc_dtype=acc_dtype,
            float_fields=frozenset(c.name for c in schema.field_columns
                                   if c.dtype.is_float),
            dedup_mask=self._maybe_dedup(scan, table), float_ops=float_ops,
            int_ops=tuple(sorted(produced_i)), widths=widths,
            pack_dtype=pack_dtype)

    def _finalize_combined_agg(self, combined, table, agg, having, project,
                               sort, limit, offset,
                               spec_slot) -> QueryResult:
        """Final step over combined value-keyed partial planes
        (dist_agg.combine_partials): the incremental fold's tail."""
        if combined is None:
            return self._empty_agg_result(table, agg, having, project,
                                          sort, limit, offset)
        planes = combined["planes"]
        g = len(combined["keys"][0]) if agg.keys else 1
        present = np.arange(g)
        env: dict = {}
        for i, (name, kexpr) in enumerate(agg.keys):
            env[kexpr] = combined["keys"][i]
        for spec, slot in zip(agg.aggs, spec_slot):
            env[spec.call] = _finalize_agg(spec.func, planes, slot,
                                           present)
        return self._post_process(env, agg, having, project, sort,
                                  limit, offset, table, g)

    # ---- incremental aggregation (partial-aggregate cache) -----------------

    def _try_incremental_agg(self, q: _AggQuery, agg, decoders, spec_slot,
                             sparse, table, having, project, sort, limit,
                             offset) -> Optional[QueryResult]:
        """Serve this aggregate from per-part cached partials and a
        delta-only fold (query/partial_cache.py), or return None for the
        classic whole-scan routes. Only PartialCacheIneligible, a typed
        decision about the plan, turns the query back; any other failure
        raises."""
        if not pc.enabled():
            return None
        try:
            partials, stats = self._incremental_partials(q, agg, decoders,
                                                         sparse, table)
        except pc.PartialCacheIneligible:
            pc.global_cache().count_event("fallback")
            return None
        with tracing.span("incremental_agg", parts=stats["parts"],
                          part_hits=stats["part_hits"],
                          delta_rows=stats["delta_rows"],
                          total_rows=stats["total_rows"]):
            combined = combine_partials(partials, len(agg.keys), q.ops)
        self.last_path = "incremental_sparse" if stats["sparse"] \
            else "incremental"
        self.last_partial_stats = stats
        return self._finalize_combined_agg(combined, table, agg, having,
                                           project, sort, limit, offset,
                                           spec_slot)

    def _incremental_partials(self, q: _AggQuery, agg, decoders, sparse,
                              table):
        """Gather cached part partials, compute the uncached parts and the
        memtable tail, and return (the part-ordered partial list, stats).
        Raises PartialCacheIneligible when the per-part decomposition is
        not provably exact.

        Each partial is computed by the route the classic path takes for
        that block, decided once on the whole scan (its gates, the finite
        proof included, read the whole scan): on the card K2
        (_agg_scan_fused), K1 (_agg_scan_prepared), or plain segment_agg
        where the classic route also takes it. The JAX package computes
        these partials with XLA's scatter (`_agg_block_jit`); the port
        keeps the card's kernels on this path instead, and the planes
        come out the same. Past the dense cache cap (or when the query is
        already sparse) the per-part fold sort-compacts: partials carry
        only the OBSERVED groups' planes ([U, F], U <= part rows), through
        K2 where _sparse_fused_ok, and the value-keyed combine
        (query/dist_agg.py) is cardinality-oblivious either way."""
        scan = q.scan
        if scan.region_id < 0:
            raise pc.PartialCacheIneligible("synthetic scan")
        if any(_needs_host_agg(spec, q.schema) for spec in agg.aggs):
            raise pc.PartialCacheIneligible("host-side aggregate")
        use_sparse = sparse or q.num_groups > pc.groups_max()
        # DELETE voids the decomposition: a tombstone may mask rows in a
        # different part (memoized on the snapshot)
        has_delete = scan.__dict__.get("_has_delete")
        if has_delete is None:
            has_delete = bool((scan.op_type != OP_PUT).any())
            scan._has_delete = has_delete
        if has_delete:
            raise pc.PartialCacheIneligible("tombstones reachable")

        plan = _block_plan(scan)
        parts: dict = {}
        mem_entries: list[_BlockEntry] = []
        for e in plan:
            if e.pkey is not None:
                parts.setdefault(e.pkey, []).append(e)
            else:
                mem_entries.append(e)
        if not parts:
            raise pc.PartialCacheIneligible("no immutable parts")
        for es in parts.values():
            if len(es) != 1:
                # the cached partial must BE the part's one-block
                # contribution for the combine to reproduce the classic
                # block-sequential fold
                raise pc.PartialCacheIneligible("multi-block part")
        # LWW dedup is whole-scan: a newer duplicate in part Q can kill a
        # row in part P. Duplicates share an exact (series, ts) instant,
        # so pairwise-disjoint part/memtable ts extents prove the dedup
        # part-local: the sliced global mask is then the part's own
        dedup_mask = None
        if q.dedup_mask is not None:
            if not self._parts_ts_disjoint(scan, q.ts_name):
                raise pc.PartialCacheIneligible("cross-part dedup")
            dedup_mask = q.dedup_mask

        fp = pc.shape_fingerprint(q.where, q.keys,
                                  [kexpr for _, kexpr in agg.keys],
                                  q.arg_exprs, q.ops, q.acc_dtype)
        if use_sparse:
            # sparse partials fold in sorted order (another float
            # association than the dense routes): never mix the two
            fp = fp + ("sparse",)
        cache = pc.global_cache()
        probed = []
        for pk, (entry,) in parts.items():
            key = ("part", scan.region_id, pk[0], pk[1], pk[2], fp)
            probed.append((key, entry, cache.get(key)))

        strides = _strides([k.size for k in q.keys])

        def decode_keys(gids):
            out = []
            for i, decode in enumerate(decoders):
                col, _ = decode((gids // strides[i]) % q.keys[i].size)
                out.append(np.asarray(col))
            return out

        if use_sparse:
            fused = self._sparse_fused_ok(q)
            col_names = self._device_columns(
                scan, q.where, q.keys, q.arg_exprs, q.ts_name, q.extra_cols)

            def compute_partial(entry):
                # a part observes at most its own rows: the cap is one
                # device block, clamped by the configured ceiling
                cap = min(entry.block, config.sparse_groups_max())
                cols = {name: self._device_block(
                    scan, name, entry, q.extra_cols,
                    q.acc_dtype if name in q.float_fields else None)
                    for name in col_names}
                dmask = None if dedup_mask is None else _pad_device_mask(
                    dedup_mask, entry.start, entry.end, entry.block)
                packed_f, packed_i, uniq, u = _agg_block_sparse(
                    cols, entry.end - entry.start, dmask, q, cap, fused)
                return {"keys": decode_keys(_to_host(uniq)),
                        "planes": _unpack_acc(packed_f, packed_i,
                                              q.float_ops, q.int_ops,
                                              q.widths)}
        else:
            route = self._dense_route(q)

            def compute_partial(entry):
                planes = self._run_dense(q, route, [entry])
                rows = planes["rows"]
                rows1 = rows[:, 0] if rows.ndim == 2 else rows
                # keyed aggregates keep only observed groups; a global
                # aggregate keeps its one group even when empty
                present = np.flatnonzero(rows1 > 0) if agg.keys \
                    else np.arange(1)
                return {"keys": decode_keys(present),
                        "planes": {op: pl[present]
                                   for op, pl in planes.items()}}

        partials: list[dict] = []
        hits = misses = 0
        delta_rows = cached_rows = 0
        for key, entry, p in probed:
            if p is None:
                epoch = cache.epoch(scan.region_id)
                p = compute_partial(entry)
                cache.put(key, p, epoch=epoch)
                misses += 1
                delta_rows += entry.end - entry.start
            else:
                hits += 1
                cached_rows += entry.end - entry.start
            partials.append(p)
        mem_rows = 0
        for entry in mem_entries:
            partials.append(compute_partial(entry))
            mem_rows += entry.end - entry.start
        delta_rows += mem_rows
        stats = {"parts": len(parts), "part_hits": hits,
                 "part_misses": misses, "delta_rows": delta_rows,
                 "cached_rows": cached_rows, "memtable_rows": mem_rows,
                 "total_rows": scan.num_rows, "sparse": use_sparse}
        return partials, stats

    def _boundary_firstlast(self, scan, table, agg, bound_where, keys,
                            extra_cols) -> Optional[ScanData]:
        """Lastpoint-class reduction (the JAX executor's
        `_boundary_firstlast`): when every aggregate is first/last and
        the keys are tag columns, the winners can only sit at series-run
        boundaries of the (tags..., ts, seq)-sorted SST parts. Returns
        those rows and every memtable row (unsorted) as a new scan, or
        None when the gather does not apply or would keep past
        _BOUNDARY_MAX_FRACTION of the rows. Memoized on the snapshot.

        Last-write-wins: within one sorted part the last row of a
        series' run holds its max ts and, among versions of that ts, the
        max seq; the winning version of the max-ts instant is such a
        boundary row in SOME part, so the subset's dedup picks it.
        `first` mirrors it through the end of the first (tags, ts)
        sub-run. A tombstone voids the argument (the newest row may be
        one, making an interior row the answer): any tombstone in the
        scan turns the gather off."""
        offsets = scan.sorted_part_offsets
        if len(offsets) < 2 or offsets[-1] == 0:
            return None
        if bound_where is not None or extra_cols:
            return None
        if not agg.aggs or any(
                spec.func not in ("first", "last")
                or _needs_host_agg(spec, table.schema)
                for spec in agg.aggs):
            return None
        if not all(k.kind == "tag" for k in keys):
            return None
        cached = scan.__dict__.get("_boundary_fl_cache")
        if cached is not None:
            return cached if cached is not False else None
        has_delete = scan.__dict__.get("_has_delete")
        if has_delete is None:
            has_delete = bool((scan.op_type != OP_PUT).any())
            scan._has_delete = has_delete
        if has_delete:
            scan._boundary_fl_cache = False
            return None

        n = scan.num_rows
        send = offsets[-1]  # end of the sorted parts
        # row i starts a series run when a tag code differs from row
        # i - 1, or i is a part seam (sortedness restarts there)
        new_run = np.zeros(send, dtype=bool)
        new_run[0] = True
        for c in table.schema.tag_columns:
            col = scan.columns[c.name]
            new_run[1:] |= col[1:send] != col[:send - 1]
        seams = np.asarray(offsets[1:-1], dtype=np.int64)
        new_run[seams[seams < send]] = True
        ts = scan.columns[table.schema.time_index.name]
        new_sub = new_run.copy()
        new_sub[1:] |= ts[1:send] != ts[:send - 1]
        run_start = np.flatnonzero(new_run)
        run_end = np.append(run_start[1:] - 1, send - 1)
        # ends of (tags, ts) sub-runs: the max-seq row of each instant
        sub_end = np.flatnonzero(np.append(new_sub[1:], True))
        # `first` candidate: the end of the first sub-run of each run
        first_end = sub_end[np.searchsorted(sub_end, run_start)]
        parts = [run_start, run_end, first_end]
        if send < n:
            parts.append(np.arange(send, n))
        idx = np.unique(np.concatenate(parts))
        if idx.size >= n * _BOUNDARY_MAX_FRACTION:
            scan._boundary_fl_cache = False
            return None
        reduced = ScanData(
            schema=scan.schema,
            columns={k: v[idx] for k, v in scan.columns.items()},
            seq=scan.seq[idx], op_type=scan.op_type[idx],
            tag_dicts=scan.tag_dicts, num_rows=idx.size,
            needs_dedup=scan.needs_dedup, region_id=scan.region_id,
            data_version=scan.data_version, incarnation=scan.incarnation,
            # no part identity, and a fingerprint of its own: the subset
            # never shares a device block with a full scan
            scan_fingerprint=scan.scan_fingerprint + ("__boundary_fl__",))
        scan._boundary_fl_cache = reduced
        return reduced

    def _parts_ts_disjoint(self, scan, ts_name: str) -> bool:
        """Whether every SST part's ts extent (and the memtable tail's) is
        pairwise disjoint: the proof that LWW dedup cannot cross a part
        seam. One O(N) min/max pass, memoized on the snapshot."""
        cached = scan.__dict__.get("_parts_ts_disjoint_cache")
        if cached is not None:
            return cached
        offs = list(scan.sorted_part_offsets) or [0]
        if offs[-1] < scan.num_rows:
            offs.append(scan.num_rows)  # memtable tail interval
        ts = scan.columns[ts_name]
        spans = []
        for i in range(len(offs) - 1):
            s0, s1 = offs[i], offs[i + 1]
            if s1 > s0:
                seg = ts[s0:s1]
                spans.append((int(seg.min()), int(seg.max())))
        spans.sort()
        ok = all(spans[i][1] < spans[i + 1][0]
                 for i in range(len(spans) - 1))
        scan._parts_ts_disjoint_cache = ok
        return ok

    def _agg_tail(self, acc, sparse_gids, agg, keys, decoders, spec_slot,
                  host_info, having, project, sort, limit, offset,
                  table) -> QueryResult:
        """Host tail: decode present groups' keys, finalize aggregates
        (the host-computed ones beside the device planes), run
        HAVING/ORDER/LIMIT over the result."""
        rows = acc["rows"][:, 0] if acc["rows"].ndim == 2 else acc["rows"]
        if sparse_gids is not None:
            # sparse: acc rows [0, U) are the observed groups, in
            # ascending global-id order
            present = np.arange(len(sparse_gids))
            present_gids = sparse_gids
        elif agg.keys:
            present = np.flatnonzero(rows > 0)
            present_gids = present
        else:
            present = np.arange(1)
            present_gids = present
        env: dict = {}
        strides = _strides([k.size for k in keys])
        for i, ((name, kexpr), decode) in enumerate(zip(agg.keys, decoders)):
            idx = (present_gids // strides[i]) % keys[i].size
            col, _ = decode(idx)
            env[kexpr] = col
        host_specs = [s for s in agg.aggs
                      if _needs_host_agg(s, table.schema)]
        for spec, slot in zip(agg.aggs, spec_slot):
            if _needs_host_agg(spec, table.schema):
                continue
            env[spec.call] = _finalize_agg(spec.func, acc, slot, present)
        if host_specs:
            scan, extra_cols, bound_where, ctx, num_groups = host_info
            self._host_aggs(host_specs, keys, scan, extra_cols, bound_where,
                            table, ctx, num_groups, present, env,
                            sparse_gids)
        return self._post_process(env, agg, having, project, sort, limit,
                                  offset, table, len(present))

    def _host_aggs(self, host_specs, keys, scan, extra_cols, bound_where,
                   table, ctx, num_groups, present, env, sparse_gids=None):
        """Order-statistic aggregates (argmax/percentile/...) over the
        scan's host columns: host_agg.py's sort-based group pass. Uses
        the BOUND where and arg expressions (tag literals -> codes, ts
        literals coerced), so the host evaluation over the raw scan
        columns matches the device's exactly."""
        from greptimedb_tpu_torch.datatypes.vector import DictVector
        from greptimedb_tpu_torch.query import host_agg as ha

        strides = _strides([k.size for k in keys])
        gid = ha.row_group_ids(keys, strides, scan, extra_cols)
        if sparse_gids is not None:
            # map global ids onto the compact [0, U) slots the device
            # assigned (ascending global-id order); rows whose group was
            # not observed are masked out below
            num_groups = len(sparse_gids)
            gid = np.clip(np.searchsorted(sparse_gids, gid), 0,
                          max(num_groups - 1, 0))
        n = scan.num_rows
        dmask = self._maybe_dedup(scan, table)
        mask = ha.host_row_mask(
            scan, bound_where, table.schema, n,
            dmask.cpu().numpy()[:n] if dmask is not None else None)
        ts_name = table.schema.time_index.name
        for spec in host_specs:
            if spec.func not in ha.HOST_AGGS:
                # string-typed first/last/min/max/count: decode the
                # argument to values and pick per group on the host
                if isinstance(spec.arg, ast.Column) and \
                        spec.arg.name in scan.tag_dicts:
                    vals = DictVector(
                        scan.columns[spec.arg.name],
                        scan.tag_dicts[spec.arg.name]).decode()
                else:
                    vals = np.asarray(eval_host(
                        spec.arg, scan.columns, table.schema, None, n),
                        dtype=object)
                vals = np.broadcast_to(vals, (n,))
                per_group = ha.compute_host_agg_str(
                    spec.func, gid, vals, scan.columns[ts_name], mask,
                    num_groups)
                env[spec.call] = per_group[present]
                continue
            bound_arg = bind_expr(spec.arg, ctx)
            vals = eval_host(bound_arg, scan.columns, table.schema, None, n)
            vals = np.broadcast_to(np.asarray(vals, dtype=np.float64), (n,))
            per_group = ha.compute_host_agg(
                spec.func, gid, vals, mask, num_groups, spec.extra_args)
            env[spec.call] = per_group[present]

    def _plan_key(self, i, kexpr, ctx, scan: ScanData, scan_node, extra_cols):
        schema = ctx.schema
        ts_col = schema.time_index
        if isinstance(kexpr, ast.Column) and kexpr.name in ctx.tag_names:
            return _tag_key(kexpr.name, scan.tag_dicts[kexpr.name])
        step = _bucket_step(kexpr, ts_col)
        if step is not None:
            lo, hi = self._ts_bounds(scan_node, scan.columns[ts_col.name])
            return _bucket_key(ts_col, step, lo, hi)
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

    def _ts_bounds(self, scan_node, ts_arr, fallback=None) -> tuple[int, int]:
        """The bucket extent: the query's ts range where it has one, else
        the rows' (or, for a stream, `fallback`: the files' stats)."""
        lo = hi = None
        if scan_node.ts_range is not None:
            lo, hi0 = scan_node.ts_range
            hi = None if hi0 is None else hi0 - 1
        if lo is None:
            lo = int(ts_arr.min()) if ts_arr is not None else fallback[0]
        if hi is None:
            hi = int(ts_arr.max()) if ts_arr is not None else fallback[1]
        return lo, hi

    def _stream_agg_inner(self, q: _AggQuery, sparse: bool):
        """Run the device aggregation; returns (host planes, observed
        global ids or None). Dense: planes indexed by global group id.
        Sparse: planes indexed by compact slot, plus the observed ids."""
        if sparse:
            return self._sparse_scan(q)
        route = self._dense_route(q)
        self.last_path = route
        return self._run_dense(q, route, _block_plan(q.scan)), None

    def _dense_route(self, q: _AggQuery) -> str:
        """The dense route of this query, by the JAX package's gates:
        `dense_fused` (K2) when the fused kernel applies, else
        `dense_prepared` (K1) for plain field columns, else `dense`."""
        prepared = self._prepared_ok(q.arg_exprs, q.ops, q.int_ops, q.schema,
                                     q.extra_cols)
        # first/last can't ride the PREPARED planes (no ts pairing) but
        # CAN ride the fused kernel, with a per-block segment_agg beside it
        fused_extra = (not prepared and bool(q.int_ops)
                       and all(k.endswith("_ts") for k in q.int_ops)
                       and self._prepared_ok(
                           q.arg_exprs, set(q.ops) - {"first", "last"}, (),
                           q.schema, q.extra_cols))
        if (prepared or fused_extra) and self._fused_ok(
                q.ops, q.arg_names, q.num_groups, q.scan):
            return "dense_fused"
        return "dense_prepared" if prepared else "dense"

    def _run_dense(self, q: _AggQuery, route: str, plan) -> dict:
        """Run a dense route over the entries of `plan` (the whole scan's
        block plan, or one part's entry in the incremental fold); returns
        host planes indexed by global group id."""
        scan, extra_cols, acc_dtype = q.scan, q.extra_cols, q.acc_dtype
        ops = q.ops

        def block(entry, names):
            return {name: self._device_block(
                scan, name, entry, extra_cols,
                acc_dtype if name in q.float_fields else None)
                for name in names}

        if route == "dense":
            names = self._device_columns(scan, q.where, q.keys, q.arg_exprs,
                                         q.ts_name, extra_cols)
            blocks, n_valids, dmasks = self._gather_blocks(
                scan, plan, lambda e: block(e, names), q.dedup_mask)
            packed_f, packed_i = _agg_scan(
                blocks, n_valids, dmasks, where=q.where, keys=q.keys,
                agg_args=q.arg_exprs, ops=ops, num_segments=q.num_groups,
                ts_name=q.ts_name, tag_names=q.tag_names, schema=q.schema,
                need_ts=bool({"first", "last"} & set(ops)),
                acc_dtype=acc_dtype, float_ops=q.float_ops,
                int_ops=q.int_ops, pack_dtype=q.pack_dtype)
            return _unpack_acc(packed_f, packed_i, q.float_ops, q.int_ops,
                               q.widths)
        arg_names = q.arg_names
        aux_names = self._device_columns(scan, q.where, q.keys, (),
                                         q.ts_name, extra_cols)
        if route == "dense_fused":
            # A kernel that fails raises: there is no fallback route
            need = sorted(set(aux_names) | set(arg_names)
                          | ({q.ts_name} if q.int_ops else set()))
            blocks, n_valids, dmasks = self._gather_blocks(
                scan, plan, lambda e: block(e, need), q.dedup_mask)
            packed_f, packed_i = _agg_scan_fused(
                blocks, n_valids, dmasks, where=q.where, keys=q.keys,
                arg_names=arg_names, num_segments=q.num_groups,
                ts_name=q.ts_name, tag_names=q.tag_names, schema=q.schema,
                float_ops=q.float_ops, int_ops=q.int_ops,
                pack_dtype=q.pack_dtype, acc_dtype=acc_dtype, **q.want())
            return _unpack_acc(packed_f, packed_i, q.float_ops, q.int_ops,
                               q.widths)
        has_nan = self._scan_has_nan(scan, arg_names)
        # variance/stddev difference two moments: both carry f64
        prep_dtype = torch.float64 if "sumsq" in ops else acc_dtype

        def fetch_block(entry):
            cols = block(entry, aux_names)
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
            scan, plan, fetch_block, q.dedup_mask)
        packed_f, packed_i = _agg_scan_prepared(
            blocks, n_valids, dmasks, where=q.where, keys=q.keys,
            nf=max(len(q.arg_exprs), 1), has_nan=has_nan,
            num_segments=q.num_groups, tag_names=q.tag_names,
            schema=q.schema, float_ops=q.float_ops, pack_dtype=q.pack_dtype)
        return _unpack_acc(packed_f, packed_i, q.float_ops, q.int_ops,
                           q.widths)

    def _sparse_scan(self, q: _AggQuery):
        """High-cardinality aggregation over the whole scan as padded
        columns: sort-compact, then one K2 call when _sparse_fused_ok, or
        plain segment reductions. Returns (host planes [U, ...], observed
        global ids [U] ascending)."""
        scan = q.scan
        n = scan.num_rows
        n_pad = block_size_for(n)
        cap = min(n_pad, config.sparse_groups_max())
        names = self._device_columns(scan, q.where, q.keys, q.arg_exprs,
                                     q.ts_name, q.extra_cols)
        cols = {name: self._whole_column(
            scan, name, n_pad, q.extra_cols,
            q.acc_dtype if name in q.float_fields else None)
            for name in names}
        base = torch.arange(n_pad, device=self.device) < n
        if q.dedup_mask is not None:
            base[:n] &= q.dedup_mask[:n]
        if self._sparse_fused_ok(q):
            packed_f, packed_i, uniq, u = _agg_scan_sparse_fused(
                cols, base, q, cap)
            self.last_path = "sparse_fused"
        else:
            packed_f, packed_i, uniq, u = _agg_scan_sparse(cols, base, q,
                                                           cap)
            self.last_path = "sparse"
        self.last_sparse_stats = {
            "groups": u, "rows": n,
            "compaction_ratio": sparse_ops.compaction_ratio(u, n)}
        acc = _unpack_acc(packed_f, packed_i, q.float_ops, q.int_ops,
                          q.widths)
        return acc, _to_host(uniq)

    def _whole_column(self, scan, name, n_pad, extra_cols, cast_dtype):
        """One whole-scan column padded to n_pad rows, on the device. It
        cannot be file-anchored: its hot-set key is the snapshot's, so a
        write retires it (DeviceCache's generation rule)."""

        def build():
            src = extra_cols[name] if name in extra_cols \
                else scan.columns[name]
            arr = pad_rows(src, n_pad)
            if cast_dtype is not None:
                arr = arr.astype(_NUMPY_OF[cast_dtype], copy=False)
            return self._upload(arr)

        if scan.region_id < 0 or name in extra_cols:
            out = build()  # uncacheable rows: upload, counted
            self.cache.count_upload(out)
            return out
        return self.cache.get(
            ("snap", scan.region_id, (scan.incarnation, scan.data_version),
             scan.scan_fingerprint, name, "whole", n_pad, str(cast_dtype)),
            build)

    def _sparse_fused_ok(self, q: _AggQuery) -> bool:
        """Route the sparse reduction through K2? _fused_ok's gates with
        the sparse twists: no group envelope (K2 has no segment cap and
        the JAX package's tile makes the count moot), sumsq only when the
        accumulator already carries f64, and first/last stay on plain
        segment_agg (the kernel has no ts pairing). The mode is the
        port's: `auto` takes the kernel on CUDA, GREPTIMEDB_TPU_PALLAS=on
        also on the CPU, through its plain version."""
        if not set(q.ops) <= {"sum", "count", "mean", "rows", "min", "max",
                              "sumsq"}:
            return False
        if "sumsq" in q.ops and q.acc_dtype != torch.float64:
            return False
        if not self._prepared_ok(q.arg_exprs, q.ops, (), q.schema,
                                 q.extra_cols):
            return False  # plain field columns only (as dense fused)
        if not fused_eligible(len(q.arg_exprs), MAX_SEGMENTS,
                              want_sumsq="sumsq" in q.ops):
            return False
        if self._scan_has_inf(q.scan, q.arg_names, dtype=q.acc_dtype):
            return False
        return pallas_mode() == "on" or self.device.type == "cuda"

    def _gather_blocks(self, scan, plan, fetch, dedup_mask):
        """Walk the block plan through `fetch`. Returns (blocks, n_valids,
        dedup block masks)."""
        blocks, n_valids = [], []
        dmasks = [] if dedup_mask is not None else None
        for entry in plan:
            # host-level deadline checkpoint per device block: an expired
            # or killed query stops dispatching instead of walking the
            # whole plan
            dl.check("device dispatch")
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
        """Hot-set key of one block. A block of an SST part carries the
        part identity and its offset inside the part, so it dies with
        its file, not with the next write; memtable blocks are
        snapshot-anchored and retire with their data version."""
        if entry.pkey is not None:
            fid, ts_r, pred_key = entry.pkey
            return ("file", scan.region_id, fid, ts_r, pred_key, name,
                    entry.start - entry.part_start, entry.block, extra)
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
            out = build()  # uncacheable rows: upload, counted
            self.cache.count_upload(out)
            return out
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
                [_upload_counted(scan.columns[t], self.device) + 1
                 for t in tag_names],
                sizes, dtype=torch.int64)
        else:
            sid = torch.zeros(n, dtype=torch.int64, device=self.device)
        ts = _upload_counted(scan.columns[table.schema.time_index.name],
                             self.device)
        order, keep = sort_dedup(
            sid, ts, _upload_counted(scan.seq, self.device),
            _upload_counted(scan.op_type, self.device),
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


def _tag_key(name: str, values: np.ndarray):
    """A tag group key: ids are codes + 1 (0 is NULL) over the registry
    dictionary `values`. Returns (DeviceKey, decoder)."""

    def decode_tag(idx):
        out = np.empty(len(idx), dtype=object)
        codes = idx - 1
        valid = codes >= 0
        out[valid] = values[codes[valid]]
        out[~valid] = None
        return out, DataType.STRING

    return DeviceKey("tag", name, len(values) + 1), decode_tag


def _bucket_step(kexpr, ts_col) -> Optional[int]:
    """The bucket width, in the time index's unit, of a date_bin /
    time_bucket key over the time index; None for any other key."""
    if (isinstance(kexpr, ast.FuncCall)
            and kexpr.name in ("date_bin", "time_bucket")
            and isinstance(kexpr.args[0], ast.Interval)
            and isinstance(kexpr.args[1], ast.Column)
            and kexpr.args[1].name == ts_col.name):
        unit = ts_col.dtype.time_unit.nanos_per_unit
        return max(kexpr.args[0].nanos // unit, 1)
    return None


def _bucket_key(ts_col, step: int, lo: int, hi: int):
    """A time-bucket group key over [lo, hi]: ids are bucket indexes from
    the first bucket. Returns (DeviceKey, decoder)."""
    base = int(np.floor_divide(lo, step))
    size = int(np.floor_divide(hi, step)) - base + 1

    def decode_bucket(idx):
        return (idx.astype(np.int64) + base) * step, ts_col.dtype

    return (DeviceKey("bucket", ts_col.name, size, step=step, base=base),
            decode_bucket)


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
