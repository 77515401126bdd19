"""PromQL evaluation engine of the port (counterpart of
greptimedb_tpu/promql/engine.py).

Every (sub)expression evaluates to one of
  - SeriesMatrix: labels [S] + values [S, T] (NaN = no sample)
  - a per-step scalar tensor [T]
  - a python float (constant)
over the regular eval grid (start, end, step). Values and times are
float64 torch tensors on the query engine's device, whatever
config.compute_dtype says for SQL fields: an f32 epoch second near 1.7e9
cannot hold a 15 s grid. Range-vector functions run the window ops
(ops/window.py); label aggregations are one K2 call over the series
axis (ops/segment.py::segment_agg_fused); binary-op vector matching
joins label signatures on the host (S is small; S x T math stays on the
device).
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from greptimedb_tpu_torch.catalog.catalog import CatalogError
from greptimedb_tpu_torch.datatypes.types import DataType
from greptimedb_tpu_torch.ops.segment import segment_agg_fused
from greptimedb_tpu_torch.ops.window import (
    counter_adjust,
    exclusive_cumsum,
    extrapolated_delta,
    true_div,
    window_edges_grid,
    window_stats,
    window_sums_grid,
)
from greptimedb_tpu_torch.promql.parser import (
    DEFAULT_LOOKBACK_S,
    Aggregate,
    Binary,
    Call,
    Matcher,
    NumberLiteral,
    PromqlError,
    StringLiteral,
    Subquery,
    Unary,
    VectorSelector,
    parse_promql,
)
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage.index import InSet, Regex
from greptimedb_tpu_torch.storage.region import OP_PUT

F64 = torch.float64
_NAN = float("nan")

_CALENDAR = frozenset({
    "minute", "hour", "day_of_week", "day_of_month", "day_of_year",
    "days_in_month", "month", "year",
})


def _calendar_field(fn: str, secs: np.ndarray) -> np.ndarray:
    """UTC calendar field of unix-second values, NaN-preserving. Pure
    numpy datetime64 arithmetic: any float within int64 seconds works;
    everything else becomes NaN."""
    flat = secs.reshape(-1)
    lim = 9.0e18  # within int64 seconds
    bad = ~np.isfinite(flat) | (np.abs(flat) > lim)
    isecs = np.floor(np.where(bad, 0.0, flat)).astype(np.int64)
    if fn == "minute":
        out = ((isecs % 3600) // 60).astype(np.float64)
    elif fn == "hour":
        out = ((isecs % 86400) // 3600).astype(np.float64)
    else:
        dt = isecs.astype("datetime64[s]")
        days = dt.astype("datetime64[D]")
        months = dt.astype("datetime64[M]")
        years = dt.astype("datetime64[Y]")
        if fn == "day_of_week":
            # 1970-01-01 was a Thursday; Prometheus: Sunday = 0
            out = ((days.astype(np.int64) + 4) % 7).astype(np.float64)
        elif fn == "day_of_month":
            out = ((days - months.astype("datetime64[D]"))
                   .astype(np.int64) + 1).astype(np.float64)
        elif fn == "day_of_year":
            out = ((days - years.astype("datetime64[D]"))
                   .astype(np.int64) + 1).astype(np.float64)
        elif fn == "days_in_month":
            out = ((months + 1).astype("datetime64[D]")
                   - months.astype("datetime64[D]")).astype(np.float64)
        elif fn == "month":
            out = ((months - years.astype("datetime64[M]"))
                   .astype(np.int64) + 1).astype(np.float64)
        else:  # year
            out = (years.astype(np.int64) + 1970).astype(np.float64)
    out[bad] = np.nan
    return out.reshape(secs.shape)


def _fmt_prom_value(v: float) -> str:
    """Shortest positional-decimal float formatting (Go FormatFloat
    'f', -1): no scientific notation; Inf spelled Prometheus-style."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return np.format_float_positional(v, trim="-")


@dataclass
class SeriesMatrix:
    labels: list  # S label sets (no __name__)
    values: torch.Tensor  # [S, T] float64
    metric: Optional[str] = None
    sample_ts: Optional[torch.Tensor] = None  # [S, T] for timestamp()

    @property
    def num_series(self) -> int:
        return len(self.labels)


@dataclass
class EvalParams:
    start: float
    end: float
    step: float
    times: np.ndarray  # [T] seconds

    @property
    def T(self) -> int:
        return len(self.times)


_RANGE_FUNCS = {
    "rate", "increase", "delta", "avg_over_time", "sum_over_time",
    "count_over_time", "min_over_time", "max_over_time", "last_over_time",
    "stddev_over_time", "stdvar_over_time", "present_over_time",
    "changes", "resets", "deriv", "predict_linear", "irate", "idelta",
    "absent_over_time", "holt_winters",
}


def _sign(x: torch.Tensor) -> torch.Tensor:
    # torch.sign maps NaN to 0; PromQL's sgn keeps it
    return torch.where(torch.isnan(x), x, torch.sign(x))


_ELEMENTWISE = {
    "abs": torch.abs, "ceil": torch.ceil, "floor": torch.floor,
    "exp": torch.exp, "ln": torch.log, "log2": torch.log2,
    "log10": torch.log10, "sqrt": torch.sqrt, "sgn": _sign,
    "acos": torch.acos, "asin": torch.asin, "atan": torch.atan,
    "cos": torch.cos, "sin": torch.sin, "tan": torch.tan,
    "cosh": torch.cosh, "sinh": torch.sinh, "tanh": torch.tanh,
    "deg": torch.rad2deg, "rad": torch.deg2rad,
}

#: label aggregations reduced by one K2 call, and the segment ops each
#: needs (count always rides along: it says which groups are present)
_K2_AGG_OPS = {
    "sum": ("sum",), "avg": ("sum", "count"),
    "min": ("min",), "max": ("max",),
    "count": ("count",), "group": ("count",),
    "stddev": ("sum", "sumsq", "count"),
    "stdvar": ("sum", "sumsq", "count"),
}


class PromqlEngine:
    """PromQL over a port QueryEngine's tables, on its device (the CUDA
    card unless the query engine was built with device="cpu")."""

    #: pivots larger than this don't cache their prefix sums (the
    #: cumsum doubles the pivot's memory; recompute instead)
    _CUMSUM_CACHE_BYTES = 512 << 20

    def __init__(self, query_engine):
        self.qe = query_engine
        self.device = query_engine.device

    # ---- public API --------------------------------------------------------

    def eval_range(self, query: str, start: float, end: float, step: float,
                   db: str = "public") -> QueryResult:
        """Range query -> long-format table (labels..., ts, value), the
        TQL output."""
        times, result = self.eval_matrix(query, start, end, step, db)
        return _to_long_result(times, result)

    def eval_matrix(self, query: str, start: float, end: float, step: float,
                    db: str = "public"):
        if step <= 0:
            raise PromqlError("step must be positive")
        node = parse_promql(query)
        self.qe.executor.last_promql_paths = []
        n_steps = int(math.floor((end - start) / step)) + 1
        times = start + np.arange(n_steps) * step
        result = self._eval(node, EvalParams(start, end, step, times), db)
        return times, result

    def eval_instant(self, query: str, t: float, db: str = "public"):
        return self.eval_matrix(query, t, t, 1.0, db)

    # ---- tensors -----------------------------------------------------------

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _times(self, p: EvalParams) -> torch.Tensor:
        return self._tensor(p.times, F64)

    def _took(self, path: str) -> None:
        paths = self.qe.executor.last_promql_paths
        if paths is not None:
            paths.append(path)

    def _empty(self, p: EvalParams) -> SeriesMatrix:
        return SeriesMatrix([], torch.zeros((0, p.T), dtype=F64,
                                            device=self.device))

    def _full(self, p: EvalParams, v: float) -> torch.Tensor:
        return torch.full((p.T,), v, dtype=F64, device=self.device)

    # ---- evaluation --------------------------------------------------------

    def _eval(self, node, p: EvalParams, db: str):
        if isinstance(node, (NumberLiteral, StringLiteral)):
            return node.value
        if isinstance(node, Unary):
            return _map_values(self._eval(node.expr, p, db), lambda x: -x)
        if isinstance(node, VectorSelector):
            if node.range_s is not None:
                raise PromqlError("range vector outside function call")
            if node.at_s is not None:
                return self._eval_at(node, p, db)
            return self._eval_instant_selector(node, p, db)
        if isinstance(node, Call):
            return self._eval_call(node, p, db)
        if isinstance(node, Aggregate):
            return self._eval_aggregate(node, p, db)
        if isinstance(node, Binary):
            return self._eval_binary(node, p, db)
        raise PromqlError(f"cannot evaluate {type(node).__name__}")

    # ---- selectors ---------------------------------------------------------

    @staticmethod
    def _resolve_at(at, p: EvalParams) -> float:
        if at == "__start__":
            return p.start
        if at == "__end__":
            return p.end
        return float(at)

    @staticmethod
    def _pinned(t_fix: float, p: EvalParams) -> EvalParams:
        return EvalParams(start=t_fix, end=t_fix, step=p.step,
                          times=np.asarray([t_fix]))

    def _eval_at(self, sel: VectorSelector, p: EvalParams, db: str):
        """`@ <ts>` / `@ start()` / `@ end()`: evaluate the selector at
        ONE fixed instant, then broadcast that value across every output
        step."""
        pinned = VectorSelector(sel.metric, sel.matchers, sel.range_s,
                                sel.offset_s, None)
        v = self._eval_instant_selector(
            pinned, self._pinned(self._resolve_at(sel.at_s, p), p), db)
        S = v.values.shape[0]
        return SeriesMatrix(
            v.labels, v.values.expand(S, p.T), v.metric,
            sample_ts=(v.sample_ts.expand(S, p.T)
                       if v.sample_ts is not None else None))

    def _eval_instant_selector(self, sel: VectorSelector, p: EvalParams,
                               db: str, lookback: float = DEFAULT_LOOKBACK_S):
        loaded = self._load(sel, p, db, window=lookback)
        if loaded is None:
            return self._empty(p)
        sidx, ts, chans, labels, metric = loaded
        w = max(1, int(math.ceil(lookback / p.step)))
        self._took("window_stats")
        st = window_stats(sidx, ts, chans, ~torch.isnan(chans[:, 0]),
                          p.start, p.step, len(labels), p.T, w,
                          stats=("count", "last"))
        vals = st["last"][:, :, 0]
        lts = st["last_ts"]
        # exact lookback: the bucket window may overcover; validate the
        # sample's ts
        ok = lts > (self._times(p)[None, :] - lookback)
        return SeriesMatrix(labels, torch.where(ok, vals, _NAN), metric,
                            sample_ts=torch.where(ok, lts, _NAN))

    def _range_stats(self, sel, p: EvalParams, db: str, stats: tuple,
                     extra_channels=()):
        """Evaluate a range selector OR subquery into window stats.
        Returns (stats dict, labels, metric, w, range_s) or None when
        empty."""
        range_s = getattr(sel, "range_s", None)
        if range_s is None:
            raise PromqlError("expected a range vector (metric[duration])")
        ratio = range_s / p.step
        w = int(round(ratio))
        if abs(ratio - w) > 1e-9 or w < 1:
            raise PromqlError(
                f"range {range_s}s must be a positive multiple of step "
                f"{p.step}s (blocked-window evaluation)")
        loaded = self._load_any(sel, p, db, window=range_s,
                                extra_channels=extra_channels)
        if loaded is None:
            return None
        sidx, ts, chans, labels, metric = loaded
        st = None
        fast = not isinstance(sel, Subquery) and _edges_enabled()
        if fast and "sum" in stats and set(stats) <= {"sum", "count"}:
            # sum/avg_over_time: one cached cumulative sum over the pivot
            # turns every window sum into a two-gather difference.
            # Count-only stats skip this: the edges path below derives
            # counts from probes alone.
            pivot = self._grid_pivot(sidx, ts, chans, len(labels))
            if pivot is not None:
                grid, mat = pivot
                st = window_sums_grid(grid, self._grid_cumsum(mat),
                                      p.start, p.step, p.T, w)
                self._took("sums")
        if st is None and fast and set(stats) <= {"count", "first", "last"}:
            # the rate family: scrape-aligned series share ONE complete
            # sample grid, so window edges are T probes into the grid +
            # column gathers from the pivoted [S, P, C] matrix
            pivot = self._grid_pivot(sidx, ts, chans, len(labels))
            if pivot is not None:
                grid, mat = pivot
                st = window_edges_grid(grid, mat, p.start, p.step, p.T, w)
                self._took("edges")
        if st is None:
            self._took("window_stats")
            st = window_stats(sidx, ts, chans, ~torch.isnan(chans[:, 0]),
                              p.start, p.step, len(labels), p.T, w,
                              stats=stats)
        return st, labels, metric, w, range_s

    def _grid_pivot(self, sidx, ts, chans, n_series):
        """(grid [P], mat [S, P, C]) when every series has exactly the
        same complete, NaN-free sample grid; None otherwise. The check
        runs on the device, identity-cached against the loaded tensors
        (which the load cache pins), so it runs once per scan snapshot."""
        cache = self.qe.executor.promql_pivot_cache
        for c_sidx, c_chans, result in cache:
            if c_sidx is sidx and c_chans is chans:
                return result
        result = None
        n, C = chans.shape
        S = n_series
        if S > 0 and n % S == 0:
            P = n // S
            grid = ts[:P]
            if bool((ts.view(S, P) == grid[None, :]).all()) \
                    and not bool(torch.isnan(chans).any()):
                result = (grid.contiguous(), chans.view(S, P, C))
        cache.append((sidx, chans, result))
        del cache[:-2]  # two live scans at most (the load cache holds 4)
        return result

    def _grid_cumsum(self, mat):
        """Exclusive prefix sums [S, P+1, C] over a pivoted matrix,
        identity-cached beside the pivot. Oversized pivots compute fresh
        each eval rather than doubling resident memory."""
        cache = self.qe.executor.promql_cumsum_cache
        for c_mat, cs in cache:
            if c_mat is mat:
                return cs
        cs = exclusive_cumsum(mat)
        if cs.numel() * cs.element_size() <= self._CUMSUM_CACHE_BYTES:
            cache.append((mat, cs))
            del cache[:-2]
        return cs

    def _load_any(self, sel, p: EvalParams, db: str, window: float,
                  extra_channels=()):
        if isinstance(sel, Subquery):
            return self._load_subquery(sel, p, db, extra_channels)
        return self._load(sel, p, db, window, extra_channels)

    def _load_subquery(self, sq: Subquery, p: EvalParams, db: str,
                       extra_channels=()):
        """Evaluate the inner expr on the subquery's own grid, flatten the
        matrix to (series, ts, value) samples, and hand back the same
        loaded tuple a storage scan produces."""
        sub_step = sq.step_s if sq.step_s else p.step
        lo = p.start - sq.range_s - sq.offset_s
        hi = p.end - sq.offset_s
        # Prometheus aligns subquery steps to absolute multiples of step
        first = math.ceil(lo / sub_step) * sub_step
        n = int(math.floor((hi - first) / sub_step)) + 1
        if n <= 0:
            return None
        times = first + np.arange(n) * sub_step
        inner = EvalParams(first, times[-1], sub_step, times)
        v = self._eval(sq.expr, inner, db)
        if not isinstance(v, SeriesMatrix):
            raise PromqlError("subquery needs an instant-vector expression")
        if v.num_series == 0:
            return None
        vals = v.values.cpu().numpy()
        S, T2 = vals.shape
        sidx = np.repeat(np.arange(S, dtype=np.int32), T2)
        ts = np.tile(times + sq.offset_s, S)  # back on the outer timeline
        flat = vals.reshape(-1)
        keep = ~np.isnan(flat)  # absent inner samples aren't samples
        if not keep.any():
            return None
        d_sidx = self._tensor(sidx[keep])
        d_ts = self._tensor(ts[keep], F64)
        d_vals = self._tensor(flat[keep], F64)
        channels = self._make_channels(d_sidx, d_ts, d_vals,
                                       extra_channels, p)
        return d_sidx, d_ts, channels, v.labels, v.metric

    def _make_channels(self, d_sidx, d_ts, d_vals, extra_channels, p):
        """Derived per-sample channels riding the window ops beside the
        raw value: counter-reset-adjusted values, change/reset
        indicators, regression moments, previous-sample value/ts."""
        chans = [d_vals]
        extra = set(extra_channels)
        if "adjusted" in extra:
            chans.append(counter_adjust(d_sidx, d_vals))
        if extra & {"changes", "resets", "prev"}:
            prev_v = torch.cat([d_vals[:1], d_vals[:-1]])
            same = torch.cat([torch.zeros(1, dtype=torch.bool,
                                          device=d_vals.device),
                              d_sidx[1:] == d_sidx[:-1]])
            one = torch.ones((), dtype=F64, device=d_vals.device)
            zero = torch.zeros((), dtype=F64, device=d_vals.device)
            if "changes" in extra:
                chans.append(torch.where(same & (d_vals != prev_v), one,
                                         zero))
            if "resets" in extra:
                chans.append(torch.where(same & (d_vals < prev_v), one,
                                         zero))
            if "prev" in extra:
                prev_t = torch.cat([d_ts[:1], d_ts[:-1]])
                chans.append(torch.where(same, prev_v, _NAN))
                chans.append(torch.where(same, prev_t, _NAN))
        if "deriv" in extra:
            tr = d_ts - p.start  # well-conditioned regression coordinates
            chans += [d_vals * tr, tr, tr * tr]
        return torch.stack(chans, dim=1)

    def _load(self, sel: VectorSelector, p: EvalParams, db: str,
              window: float, extra_channels=()):
        """Scan + matcher-filter + series factorization. Returns device
        tensors sorted by (series, ts): sidx [N] int32, ts seconds [N]
        f64, channels [N, C] f64, labels, metric. Channel 0 is the raw
        value; extra_channels in {"adjusted", "changes", "resets",
        "prev", "deriv"} append derived channels."""
        metric = sel.metric
        field_name = None
        rest: list[Matcher] = []
        for m in sel.matchers:
            if m.label == "__name__":
                if m.op != "=":
                    raise PromqlError("__name__ supports '=' only")
                metric = m.value
            elif m.label == "__field__":
                if m.op != "=":
                    raise PromqlError("__field__ supports '=' only")
                field_name = m.value
            else:
                rest.append(m)
        if metric is None:
            raise PromqlError("selector needs a metric name")

        try:
            info = self.qe._table(metric, QueryContext(db=db))
        except CatalogError:
            return None
        schema = info.schema
        fields = schema.field_columns
        if field_name is None:
            if len(fields) == 1:
                field_name = fields[0].name
            elif any(f.name == "greptime_value" for f in fields):
                field_name = "greptime_value"
            else:
                raise PromqlError(
                    f"metric {metric!r} has {len(fields)} fields; select one "
                    "with {__field__=\"...\"}")
        elif field_name not in {f.name for f in fields}:
            raise PromqlError(f"no field {field_name!r} in {metric!r}")

        ts_col = schema.time_index
        unit = ts_col.dtype.time_unit.nanos_per_unit
        offset = sel.offset_s
        lo = int((p.start - window - offset) * 1e9) // unit
        hi = int((p.end - offset) * 1e9) // unit + 1
        # =/=~ matchers prune through the tag index; != and !~ can't (a
        # segment proves presence, not absence). The exact matcher masks
        # below still run on everything scanned.
        idx_preds: dict = {}
        tag_names = [c.name for c in schema.tag_columns]
        for m in rest:
            if m.label not in tag_names:
                continue
            if m.op == "=":
                idx_preds.setdefault(m.label, []).append(InSet.of([m.value]))
            elif m.op == "=~":
                idx_preds.setdefault(m.label, []).append(Regex(m.value))
        scan = self.qe.region_engine.scan(
            info.region_ids[0], (lo, hi), [field_name],
            tag_predicates={k: tuple(v) for k, v in idx_preds.items()}
            or None)
        if scan is None or scan.num_rows == 0:
            return None

        # loaded-series cache: everything below is query-invariant for a
        # scan snapshot + selector. Keyed on the scan identity, so data
        # version changes invalidate; "deriv" channels embed p.start.
        lcache = None
        ckey = None
        if scan.region_id >= 0:
            lcache = self.qe.executor.promql_load_cache
            ckey = (scan.region_id, scan.incarnation, scan.data_version,
                    scan.scan_fingerprint, field_name, offset,
                    tuple(sorted((m.label, m.op, m.value) for m in rest)),
                    tuple(extra_channels), not info.append_mode,
                    p.start if "deriv" in extra_channels else None)
            hit = lcache.get(ckey)
            if hit is not None:
                lcache.move_to_end(ckey)
                d_sidx, d_ts, channels, labels = hit
                return d_sidx, d_ts, channels, labels, metric

        rows = None  # every scanned row
        if rest:
            mask = np.ones(scan.num_rows, dtype=bool)
            for m in rest:
                mask &= _matcher_mask(m, scan, tag_names)
                if not mask.any():
                    return None
            if not mask.all():
                rows = np.flatnonzero(mask)

        def column(name, dtype=None):
            col = scan.columns[name]
            col = col if rows is None else col[rows]
            return self._tensor(np.ascontiguousarray(col, dtype=dtype))

        if tag_names:
            sizes = [len(scan.tag_dicts[t]) + 1 for t in tag_names]
            combined = column(tag_names[0]).to(torch.int64) + 1
            for t, s in zip(tag_names[1:], sizes[1:]):
                combined = combined * s + (column(t).to(torch.int64) + 1)
            uniq, sidx = torch.unique(combined, sorted=True,
                                      return_inverse=True)
            labels = _decode_labels(uniq.cpu().numpy(), tag_names, sizes,
                                    scan.tag_dicts)
            d_sidx = sidx.to(torch.int32)
        else:
            n = scan.num_rows if rows is None else len(rows)
            d_sidx = torch.zeros(n, dtype=torch.int32, device=self.device)
            labels = [{}]
        d_ts = column(ts_col.name).to(F64) * (unit / 1e9) + offset
        d_vals = column(field_name, np.float64)
        # sort by (series, ts): counter_adjust and the indicator channels
        # need it. A single flushed SST already yields (tags..., ts)-
        # sorted rows and series codes factorize in tag order: prove
        # sortedness on the device and skip the sort when it holds.
        if info.append_mode:
            ds = d_sidx[1:] - d_sidx[:-1]
            is_sorted = bool(((ds > 0) | ((ds == 0)
                                          & (d_ts[1:] >= d_ts[:-1]))).all())
            if not is_sorted:
                order = _lexsort((d_ts, d_sidx))
                d_sidx, d_ts, d_vals = (d_sidx[order], d_ts[order],
                                        d_vals[order])
        else:
            # last-write-wins by SEQ, not by scan position: sort with seq
            # as the tiebreaker, keep each duplicate run's last row, and
            # suppress it when that winner is a DELETE tombstone
            seq = scan.seq if rows is None else scan.seq[rows]
            op = scan.op_type if rows is None else scan.op_type[rows]
            d_seq = self._tensor(seq.astype(np.int64))
            d_op = self._tensor(op.astype(np.int8))
            order = _lexsort((d_seq, d_ts, d_sidx))
            d_sidx, d_ts, d_vals, d_op = (d_sidx[order], d_ts[order],
                                          d_vals[order], d_op[order])
            dup_next = torch.zeros_like(d_op, dtype=torch.bool)
            dup_next[:-1] = (d_sidx[:-1] == d_sidx[1:]) \
                & (d_ts[:-1] == d_ts[1:])
            keep = ~dup_next & (d_op == OP_PUT)
            d_vals = torch.where(keep, d_vals, _NAN)

        channels = self._make_channels(d_sidx, d_ts, d_vals,
                                       extra_channels, p)
        if lcache is not None:
            lcache[ckey] = (d_sidx, d_ts, channels, labels)
            while len(lcache) > 4:
                lcache.popitem(last=False)
        return d_sidx, d_ts, channels, labels, metric

    # ---- calls -------------------------------------------------------------

    def _eval_call(self, call: Call, p: EvalParams, db: str):
        fn = call.func
        if fn in _RANGE_FUNCS:
            # `rate(m[5m] @ T)`: pin the whole range evaluation at T and
            # broadcast; never silently evaluate on the normal grid
            sel = next((a for a in call.args
                        if isinstance(a, VectorSelector)), None)
            if sel is not None and sel.at_s is not None:
                pinned = VectorSelector(sel.metric, sel.matchers,
                                        sel.range_s, sel.offset_s, None)
                call2 = Call(call.func, tuple(
                    pinned if a is sel else a for a in call.args))
                v = self._eval_range_func(
                    call2, self._pinned(self._resolve_at(sel.at_s, p), p),
                    db)
                if isinstance(v, SeriesMatrix):
                    return SeriesMatrix(
                        v.labels, v.values.expand(v.values.shape[0], p.T),
                        v.metric)
                return v
            return self._eval_range_func(call, p, db)
        if fn == "time":
            return self._times(p)
        if fn in _CALENDAR:
            # input VALUES are unix seconds (default vector(time()));
            # output the UTC field
            if call.args:
                v = self._eval(call.args[0], p, db)
            else:
                v = SeriesMatrix([{}], self._times(p)[None, :])
            if not isinstance(v, SeriesMatrix):
                v = SeriesMatrix([{}], self._broadcast_scalar(v, p)[None, :])
            out = _calendar_field(fn, v.values.cpu().numpy())
            # functions drop __name__ (the same as _map_values)
            return SeriesMatrix(v.labels, self._tensor(out))
        if fn == "scalar":
            v = self._eval(call.args[0], p, db)
            if isinstance(v, SeriesMatrix):
                return v.values[0] if v.num_series == 1 \
                    else self._full(p, _NAN)
            return v
        if fn == "vector":
            v = self._eval(call.args[0], p, db)
            return SeriesMatrix([{}], self._broadcast_scalar(v, p)[None, :])
        if fn == "timestamp":
            v = self._eval(call.args[0], p, db)
            if not isinstance(v, SeriesMatrix) or v.sample_ts is None:
                raise PromqlError("timestamp() needs an instant selector")
            return SeriesMatrix(v.labels, v.sample_ts, None)
        if fn in ("clamp", "clamp_min", "clamp_max"):
            v = self._eval(call.args[0], p, db)
            if not isinstance(v, SeriesMatrix):
                raise PromqlError(f"{fn} needs a vector")
            args = [self._tensor(_scalar_of(self._eval(a, p, db)), F64)
                    for a in call.args[1:]]
            if fn == "clamp":
                out = torch.minimum(torch.maximum(v.values, args[0]),
                                    args[1])
            elif fn == "clamp_min":
                out = torch.maximum(v.values, args[0])
            else:
                out = torch.minimum(v.values, args[0])
            return SeriesMatrix(v.labels, out)
        if fn == "round":
            v = self._eval(call.args[0], p, db)
            to = _scalar_of(self._eval(call.args[1], p, db)) \
                if len(call.args) > 1 else 1.0
            return SeriesMatrix(v.labels,
                                torch.round(true_div(v.values, to)) * to)
        if fn in _ELEMENTWISE:
            return _map_values(self._eval(call.args[0], p, db),
                               _ELEMENTWISE[fn])
        if fn in ("sort", "sort_desc"):
            v = self._eval(call.args[0], p, db)
            if not isinstance(v, SeriesMatrix) or v.num_series <= 1:
                return v
            # order series by their value at the (last) evaluated
            # instant, NaN last: Prometheus sort() on instant vectors
            key = v.values[:, -1].cpu().numpy().astype(np.float64)
            rank = np.where(np.isnan(key), np.inf,
                            key if fn == "sort" else -key)
            order = np.argsort(rank, kind="stable")
            return SeriesMatrix([v.labels[i] for i in order],
                                v.values[self._tensor(order)], v.metric)
        if fn == "absent":
            v = self._eval(call.args[0], p, db)
            if not isinstance(v, SeriesMatrix):
                raise PromqlError("absent needs an instant vector")
            lab = _absent_labels(call.args[0])
            if v.num_series == 0:
                return SeriesMatrix([lab], self._full(p, 1.0)[None, :])
            all_absent = torch.isnan(v.values).all(dim=0)
            return SeriesMatrix(
                [lab], torch.where(all_absent, 1.0, _NAN)[None, :].to(F64))
        if fn == "histogram_quantile":
            return self._histogram_quantile(call, p, db)
        if fn == "label_replace":
            return self._label_replace(call, p, db)
        if fn == "label_join":
            return self._label_join(call, p, db)
        raise PromqlError(f"unsupported function {fn!r}")

    def _eval_range_func(self, call: Call, p: EvalParams, db: str):
        fn = call.func
        sel = call.args[0]
        if not isinstance(sel, (VectorSelector, Subquery)):
            raise PromqlError(f"{fn} needs a range selector argument")

        if fn in ("rate", "increase", "delta"):
            counter = fn in ("rate", "increase")
            extra = ("adjusted",) if counter else ()
            r = self._range_stats(sel, p, db, ("count", "first", "last"),
                                  extra)
            if r is None:
                return self._empty(p)
            st, labels, metric, w, range_s = r
            ch = 1 if counter else 0
            times = self._times(p)
            vals = extrapolated_delta(
                st["first"][:, :, ch], st["first_ts"],
                st["last"][:, :, ch], st["last_ts"],
                st["count"][:, :, 0],
                times[None, :] - range_s, times[None, :],
                is_counter=counter, is_rate=(fn == "rate"), range_s=range_s)
            return SeriesMatrix(labels, vals)

        if fn in ("irate", "idelta"):
            # the last two samples in the window: the window's "last"
            # gather carries the previous-sample value/ts as channels
            r = self._range_stats(sel, p, db, ("count", "last"), ("prev",))
            if r is None:
                return self._empty(p)
            st, labels, metric, w, range_s = r
            last_v = st["last"][:, :, 0]
            prev_v = st["last"][:, :, 1]
            prev_t = st["last"][:, :, 2]
            last_t = st["last_ts"]
            wstart = self._times(p)[None, :] - range_s
            ok = (~torch.isnan(prev_v)) & (prev_t > wstart) \
                & (last_t > prev_t)
            if fn == "idelta":
                out = last_v - prev_v
            else:
                # counter semantics: a reset's delta is the raw new value
                delta = torch.where(last_v < prev_v, last_v, last_v - prev_v)
                out = delta / (last_t - prev_t)
            return SeriesMatrix(labels, torch.where(ok, out, _NAN))

        if fn == "absent_over_time":
            r = self._range_stats(sel, p, db, ("count",))
            lab = _absent_labels(sel)
            if r is None:
                return SeriesMatrix([lab], self._full(p, 1.0)[None, :])
            st = r[0]
            any_present = (st["count"][:, :, 0] > 0).any(dim=0)
            return SeriesMatrix(
                [lab], torch.where(any_present, _NAN, 1.0)[None, :].to(F64))

        if fn == "holt_winters":
            return self._holt_winters(call, sel, p, db)

        if fn in ("changes", "resets"):
            r = self._range_stats(sel, p, db, ("sum", "count"), (fn,))
            if r is None:
                return self._empty(p)
            st, labels = r[0], r[1]
            present = st["count"][:, :, 0] > 0
            return SeriesMatrix(labels, torch.where(
                present, st["sum"][:, :, 1], _NAN))

        if fn in ("deriv", "predict_linear"):
            r = self._range_stats(sel, p, db, ("sum", "count"), ("deriv",))
            if r is None:
                return self._empty(p)
            st, labels = r[0], r[1]
            n = st["count"][:, :, 0].to(F64)
            sv, svt, t1, t2 = (st["sum"][:, :, i] for i in range(4))
            denom = n * t2 - t1 * t1
            slope = torch.where((n >= 2) & (denom != 0),
                                (n * svt - sv * t1) / denom, _NAN)
            if fn == "deriv":
                return SeriesMatrix(labels, slope)
            horizon = _scalar_of(self._eval(call.args[1], p, db))
            intercept = (sv - slope * t1) / torch.clamp(n, min=1)
            now_r = self._times(p)[None, :] - p.start
            return SeriesMatrix(labels, intercept + slope * (now_r + horizon))

        # *_over_time family
        stat_map = {
            "avg_over_time": ("sum", "count"),
            "sum_over_time": ("sum", "count"),
            "count_over_time": ("count",), "present_over_time": ("count",),
            "min_over_time": ("min", "count"),
            "max_over_time": ("max", "count"),
            "last_over_time": ("count", "last"),
        }
        if fn in ("stddev_over_time", "stdvar_over_time"):
            r = self._range_stats_sq(sel, p, db)
        else:
            r = self._range_stats(sel, p, db, stat_map[fn])
        if r is None:
            return self._empty(p)
        st, labels = r[0], r[1]
        cnt = st["count"][:, :, 0]
        present = cnt > 0
        if fn == "sum_over_time":
            out = torch.where(present, st["sum"][:, :, 0], _NAN)
        elif fn == "avg_over_time":
            out = torch.where(present, st["sum"][:, :, 0]
                              / torch.clamp(cnt, min=1), _NAN)
        elif fn == "count_over_time":
            out = torch.where(present, cnt.to(F64), _NAN)
        elif fn == "present_over_time":
            out = torch.where(present, 1.0, _NAN).to(F64)
        elif fn in ("min_over_time", "max_over_time"):
            out = st[fn[:3]][:, :, 0]
        elif fn == "last_over_time":
            out = st["last"][:, :, 0]
        else:  # stddev / stdvar over time (population, like PromQL)
            s, sq = st["sum"][:, :, 0], st["sum"][:, :, 1]
            n = torch.clamp(cnt.to(F64), min=1)
            var = torch.clamp(sq / n - (s / n) ** 2, min=0.0)
            out = torch.where(present, torch.sqrt(var)
                              if fn == "stddev_over_time" else var, _NAN)
        return SeriesMatrix(labels, out)

    def _histogram_quantile(self, call: Call, p: EvalParams, db: str):
        """φ-quantile over `le`-bucketed classic histograms: group by
        labels-minus-le, cumulative buckets, linear interpolation within
        the bucket."""
        phi = _scalar_of(self._eval(call.args[0], p, db))
        v = self._eval(call.args[1], p, db)
        if not isinstance(v, SeriesMatrix):
            raise PromqlError("histogram_quantile needs an instant vector")
        groups: dict = {}
        glabels: dict = {}
        for i, lab in enumerate(v.labels):
            le_s = lab.get("le")
            if le_s is None:
                continue
            try:
                le = float(le_s.replace("+Inf", "inf")) \
                    if isinstance(le_s, str) else float(le_s)
            except ValueError:
                continue
            rest = {k: x for k, x in lab.items() if k != "le"}
            sig = tuple(sorted(rest.items()))
            groups.setdefault(sig, []).append((le, i))
            glabels[sig] = rest
        if not groups:
            return self._empty(p)
        out_labels, outs = [], []
        for sig, buckets in sorted(groups.items()):
            buckets.sort()
            les = np.asarray([b[0] for b in buckets])
            idx = np.asarray([b[1] for b in buckets])
            out_labels.append(glabels[sig])
            if not np.isinf(les[-1]):
                # no +Inf bucket: quantile undefined (Prometheus -> NaN)
                outs.append(self._full(p, _NAN))
                continue
            counts = v.values[self._tensor(idx)]  # [B, T] cumulative
            # enforce monotonicity like Prometheus (scrape races)
            counts = torch.cummax(torch.nan_to_num(counts), dim=0).values
            total = counts[-1]
            rank = phi * total
            # first bucket whose cumulative count reaches the rank
            b = torch.argmax((counts >= rank[None, :]).to(torch.int32),
                             dim=0)
            B = len(les)
            d_les = self._tensor(les, F64)
            bm1 = torch.clamp(b - 1, min=0)
            upper = d_les[b]
            lower = torch.where(b > 0, d_les[bm1], 0.0)
            cum_prev = torch.where(
                b > 0, torch.gather(counts, 0, bm1[None, :])[0], 0.0)
            cum_b = torch.gather(counts, 0, b[None, :])[0]
            in_bucket = torch.clamp(cum_b - cum_prev, min=1e-300)
            frac = (rank - cum_prev) / in_bucket
            interp = lower + (upper - lower) * torch.clamp(frac, 0.0, 1.0)
            # highest bucket (= +Inf): return the highest finite bound
            highest_finite = d_les[B - 2] if B >= 2 else _NAN
            res = torch.where(b >= B - 1, highest_finite, interp)
            # first bucket with a non-positive upper bound: no
            # interpolation
            res = torch.where((b == 0) & (upper <= 0), upper, res)
            res = torch.where(total > 0, res, _NAN)
            if phi < 0:
                res = self._full(p, float("-inf"))
            elif phi > 1:
                res = self._full(p, float("inf"))
            elif math.isnan(phi):
                res = self._full(p, _NAN)
            outs.append(res)
        return SeriesMatrix(out_labels, torch.stack(outs, dim=0))

    def _holt_winters(self, call: Call, sel, p: EvalParams, db: str):
        """Double exponential smoothing: a sequential per-window
        recurrence, evaluated on the host over the loaded samples."""
        sf = _scalar_of(self._eval(call.args[1], p, db))
        tf = _scalar_of(self._eval(call.args[2], p, db))
        if not 0 < sf < 1 or not 0 < tf < 1:
            raise PromqlError("holt_winters factors must be in (0, 1)")
        range_s = sel.range_s
        if range_s is None:
            raise PromqlError(
                "holt_winters needs a range vector (metric[duration])")
        loaded = self._load_any(sel, p, db, window=range_s)
        if loaded is None:
            return self._empty(p)
        sidx, ts, chans, labels, metric = loaded
        sidx = sidx.cpu().numpy()
        ts = ts.cpu().numpy()
        vals = chans[:, 0].cpu().numpy()
        ok = ~np.isnan(vals)
        sidx, ts, vals = sidx[ok], ts[ok], vals[ok]
        S, T = len(labels), p.T
        out = np.full((S, T), np.nan)
        starts = np.searchsorted(sidx, np.arange(S))
        ends = np.searchsorted(sidx, np.arange(S), side="right")
        for s in range(S):
            s_ts = ts[starts[s]:ends[s]]
            s_v = vals[starts[s]:ends[s]]
            for j, t in enumerate(p.times):
                lo = np.searchsorted(s_ts, t - range_s, side="right")
                hi = np.searchsorted(s_ts, t, side="right")
                x = s_v[lo:hi]
                if len(x) < 2:
                    continue
                s0, b = x[0], x[1] - x[0]
                for i in range(1, len(x)):
                    s1 = sf * x[i] + (1 - sf) * (s0 + b)
                    b = tf * (s1 - s0) + (1 - tf) * b
                    s0 = s1
                out[s, j] = s0
        return SeriesMatrix(labels, self._tensor(out))

    def _range_stats_sq(self, sel, p: EvalParams, db: str):
        """Range stats with a squared-value channel (stddev/stdvar)."""
        range_s = sel.range_s
        w = int(round(range_s / p.step))
        loaded = self._load_any(sel, p, db, window=range_s)
        if loaded is None:
            return None
        sidx, ts, chans, labels, metric = loaded
        chans = torch.cat([chans, chans[:, :1] ** 2], dim=1)
        self._took("window_stats")
        st = window_stats(sidx, ts, chans, ~torch.isnan(chans[:, 0]),
                          p.start, p.step, len(labels), p.T, w,
                          stats=("sum", "count"))
        return st, labels, metric, w, range_s

    # ---- aggregation -------------------------------------------------------

    def _eval_aggregate(self, agg: Aggregate, p: EvalParams, db: str):
        v = self._eval(agg.expr, p, db)
        if not isinstance(v, SeriesMatrix):
            raise PromqlError(f"{agg.op} needs an instant vector")
        if v.num_series == 0:
            return self._empty(p)

        # group signatures
        sigs = []
        for lab in v.labels:
            if agg.by:
                kept = {k: lab.get(k, "") for k in agg.by if k in lab}
            elif agg.without:
                kept = {k: x for k, x in lab.items() if k not in agg.without}
            else:
                kept = {}
            sigs.append(tuple(sorted(kept.items())))
        uniq = sorted(set(sigs))
        pos = {s: i for i, s in enumerate(uniq)}
        gidx = np.asarray([pos[s] for s in sigs], dtype=np.int32)
        G = len(uniq)
        glabels = [dict(u) for u in uniq]

        vals = v.values  # [S, T]
        if agg.op in _K2_AGG_OPS:
            need = set(_K2_AGG_OPS[agg.op]) | {"count"}
            st = segment_agg_fused(
                vals, self._tensor(gidx),
                torch.ones(v.num_series, dtype=torch.bool,
                           device=self.device),
                G, ops=tuple(sorted(need)))
            cnt = st["count"]
            present = cnt > 0
            if agg.op == "sum":
                out = torch.where(present, st["sum"], _NAN)
            elif agg.op == "avg":
                out = torch.where(present, st["sum"]
                                  / torch.clamp(cnt, min=1), _NAN)
            elif agg.op in ("min", "max"):
                out = st[agg.op]
            elif agg.op == "count":
                out = torch.where(present, cnt.to(F64), _NAN)
            elif agg.op == "group":
                out = torch.where(present, 1.0, _NAN).to(F64)
            else:  # stddev / stdvar (population)
                n = torch.clamp(cnt.to(F64), min=1)
                var = torch.clamp(st["sumsq"] / n - (st["sum"] / n) ** 2,
                                  min=0.0)
                out = torch.where(present, var if agg.op == "stdvar"
                                  else torch.sqrt(var), _NAN)
            return SeriesMatrix(glabels, out)

        if agg.op in ("topk", "bottomk"):
            k = int(_scalar_of(self._eval(agg.param, p, db)))
            vv = vals if agg.op == "topk" else -vals
            filled = torch.where(torch.isnan(vv), float("-inf"), vv)
            keep = torch.zeros(vals.shape, dtype=torch.bool,
                               device=self.device)
            for g in range(G):
                rows = self._tensor(np.flatnonzero(gidx == g))
                sub = filled[rows]
                kk = min(k, len(rows))
                thresh = -torch.sort(-sub, dim=0).values[kk - 1]
                keep[rows] = sub >= thresh[None, :]
            out = torch.where(keep & ~torch.isnan(vals), vals, _NAN)
            return SeriesMatrix(v.labels, out, v.metric)

        if agg.op == "quantile":
            q = _scalar_of(self._eval(agg.param, p, db))
            outs = []
            for g in range(G):
                rows = self._tensor(np.flatnonzero(gidx == g))
                outs.append(_nanquantile(vals[rows], q))
            return SeriesMatrix(glabels, torch.stack(outs, dim=0))

        if agg.op == "count_values":
            if not isinstance(agg.param, StringLiteral):
                raise PromqlError(
                    "count_values needs a string label parameter")
            label_name = agg.param.value
            vn = vals.cpu().numpy().astype(np.float64)  # [S, T]
            S, T = vn.shape
            valid = ~np.isnan(vn)
            # sparse factorization: memory stays O(samples + series*T),
            # never a dense [G, D, T] cube
            distinct, inv = np.unique(vn[valid], return_inverse=True)
            D = len(distinct)
            if D == 0:
                return self._empty(p)
            srow, scol = np.nonzero(valid)
            key = (gidx[srow].astype(np.int64) * D + inv) * T + scol
            uk, uc = np.unique(key, return_counts=True)
            gd = uk // T
            col = (uk % T).astype(np.int64)
            pairs, pair_inv = np.unique(gd, return_inverse=True)
            rows_m = np.full((len(pairs), T), np.nan)
            rows_m[pair_inv, col] = uc.astype(np.float64)
            out_labels = []
            for pair in pairs:
                lab = dict(glabels[int(pair // D)])
                lab[label_name] = _fmt_prom_value(float(distinct[pair % D]))
                out_labels.append(lab)
            return SeriesMatrix(out_labels, self._tensor(rows_m))

        raise PromqlError(f"unsupported aggregation {agg.op!r}")

    # ---- binary ops --------------------------------------------------------

    def _broadcast_scalar(self, v, p: EvalParams) -> torch.Tensor:
        if isinstance(v, SeriesMatrix):
            raise PromqlError("expected a scalar")
        if isinstance(v, (int, float)):
            return self._full(p, float(v))
        return v

    def _eval_binary(self, node: Binary, p: EvalParams, db: str):
        lhs = self._eval(node.lhs, p, db)
        rhs = self._eval(node.rhs, p, db)
        lv = isinstance(lhs, SeriesMatrix)
        rv = isinstance(rhs, SeriesMatrix)

        if node.op in ("and", "or", "unless"):
            if not (lv and rv):
                raise PromqlError(f"{node.op} needs vector operands")
            return self._set_op(node, lhs, rhs, p)

        if not lv and not rv:
            a = self._broadcast_scalar(lhs, p)
            b = self._broadcast_scalar(rhs, p)
            out = _apply_op(node.op, a, b)
            if node.op in _CMP:
                out = out.to(F64) if node.bool_mod \
                    else torch.where(out, a, _NAN)
            return out
        if lv != rv:
            vec = lhs if lv else rhs
            s = self._broadcast_scalar(rhs if lv else lhs, p)[None, :]
            out = _apply_op(node.op, vec.values, s) if lv \
                else _apply_op(node.op, s, vec.values)
            if node.op in _CMP:
                out = out.to(F64) if node.bool_mod \
                    else torch.where(out, vec.values, _NAN)
            keep_labels = node.op in _CMP and not node.bool_mod
            return SeriesMatrix(vec.labels if keep_labels
                                else _strip(vec.labels), out)

        # vector-vector: join on signature
        rsig = {_signature(lab, node): i for i, lab in enumerate(rhs.labels)}
        li, ri, labels = [], [], []
        for i, lab in enumerate(lhs.labels):
            j = rsig.get(_signature(lab, node))
            if j is not None:
                li.append(i)
                ri.append(j)
                labels.append(lab if node.group_left else dict(lab))
        if not li:
            return self._empty(p)
        a = lhs.values[self._tensor(li)]
        b = rhs.values[self._tensor(ri)]
        out = _apply_op(node.op, a, b)
        if node.op in _CMP:
            out = out.to(F64) if node.bool_mod else torch.where(out, a, _NAN)
        return SeriesMatrix(labels, out)

    def _set_op(self, node: Binary, lhs: SeriesMatrix, rhs: SeriesMatrix,
                p: EvalParams):
        lsig = [_signature(lab, node) for lab in lhs.labels]
        rmap = {_signature(lab, node): i for i, lab in enumerate(rhs.labels)}
        if node.op == "and":
            keep = [i for i, s in enumerate(lsig) if s in rmap]
            if not keep:
                return SeriesMatrix([], self._empty(p).values, lhs.metric)
            # the rhs sample must be present at t too
            rsel = self._tensor([rmap[lsig[i]] for i in keep])
            vals = torch.where(~torch.isnan(rhs.values[rsel]),
                               lhs.values[self._tensor(keep)], _NAN)
            return SeriesMatrix([lhs.labels[i] for i in keep], vals,
                                lhs.metric)
        if node.op == "unless":
            rows = []
            for i, s in enumerate(lsig):
                j = rmap.get(s)
                rows.append(lhs.values[i] if j is None else torch.where(
                    torch.isnan(rhs.values[j]), lhs.values[i], _NAN))
            vals = torch.stack(rows) if rows else self._empty(p).values
            return SeriesMatrix(list(lhs.labels), vals, lhs.metric)
        # or: lhs plus the rhs series whose signature isn't in lhs
        lsigs = set(lsig)
        extra = [i for i, lab in enumerate(rhs.labels)
                 if _signature(lab, node) not in lsigs]
        labels = list(lhs.labels) + [rhs.labels[i] for i in extra]
        vals = torch.cat([lhs.values, rhs.values[self._tensor(extra)]]) \
            if extra else lhs.values
        return SeriesMatrix(labels, vals, lhs.metric)

    # ---- label functions ---------------------------------------------------

    def _label_replace(self, call: Call, p: EvalParams, db: str):
        v = self._eval(call.args[0], p, db)
        dst, repl, src, regex = (_string_of(a) for a in call.args[1:5])
        rx = re.compile(regex)
        labels = []
        for lab in v.labels:
            m = rx.fullmatch(lab.get(src, ""))
            lab = dict(lab)
            if m is not None:
                val = m.expand(repl.replace("$", "\\")) if "$" in repl \
                    else repl
                if val:
                    lab[dst] = val
                else:
                    lab.pop(dst, None)
            labels.append(lab)
        return SeriesMatrix(labels, v.values, v.metric, v.sample_ts)

    def _label_join(self, call: Call, p: EvalParams, db: str):
        v = self._eval(call.args[0], p, db)
        dst = _string_of(call.args[1])
        sep = _string_of(call.args[2])
        srcs = [_string_of(a) for a in call.args[3:]]
        labels = []
        for lab in v.labels:
            lab = dict(lab)
            lab[dst] = sep.join(lab.get(s, "") for s in srcs)
            labels.append(lab)
        return SeriesMatrix(labels, v.values, v.metric, v.sample_ts)


# ---- helpers ---------------------------------------------------------------

_CMP = {"==", "!=", "<", "<=", ">", ">="}

_OPS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "%": torch.fmod, "^": torch.pow,
    "==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
    ">": torch.gt, ">=": torch.ge,
}


def _apply_op(op, a, b):
    f = _OPS.get(op)
    if f is None:
        raise PromqlError(f"unknown operator {op}")
    return f(a, b)


def _lexsort(keys) -> torch.Tensor:
    """jnp.lexsort on torch: the permutation sorting by the LAST key,
    ties by the ones before it, remaining ties in input order. Stable
    argsorts, minor key first."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        o = torch.sort(kk, stable=True).indices
        order = o if order is None else order[o]
    return order


def _decode_labels(uniq: np.ndarray, tag_names, sizes, tag_dicts) -> list:
    """Label dicts of the combined series keys (code + 1 per tag, mixed
    radix `sizes`; code -1 = the tag is NULL and absent)."""
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    labels = []
    for u in uniq.tolist():
        lab = {}
        for t_name, stride, size in zip(tag_names, strides, sizes):
            code = u // stride % size - 1
            if code >= 0:
                lab[t_name] = str(tag_dicts[t_name][code])
        labels.append(lab)
    return labels


def _nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column quantile of [R, T] ignoring NaN, linear interpolation.
    q outside [0, 1] reads the nearest end, as jnp.nanquantile's clipped
    indices do; torch.nanquantile refuses such q."""
    if math.isnan(q):
        return torch.full(x.shape[1:], _NAN, dtype=x.dtype, device=x.device)
    return torch.nanquantile(x, min(max(q, 0.0), 1.0), dim=0)


def _signature(lab: dict, node: Binary) -> tuple:
    if node.on:
        return tuple((k, lab.get(k, "")) for k in node.on)
    items = dict(lab)
    if node.ignoring:
        for k in node.ignoring:
            items.pop(k, None)
    return tuple(sorted(items.items()))


def _strip(labels: list) -> list:
    return [dict(lab) for lab in labels]


def _map_values(v, f):
    if isinstance(v, SeriesMatrix):
        return SeriesMatrix(v.labels, f(v.values))
    if isinstance(v, (int, float)):
        return float(f(torch.tensor(float(v), dtype=F64)))
    return f(v)


def _scalar_of(v) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    return float(v.reshape(-1)[0])


def _string_of(node) -> str:
    if isinstance(node, StringLiteral):
        return node.value
    raise PromqlError("expected a string literal")


def _absent_labels(node) -> dict:
    """absent()'s output labels: the selector's equality matchers."""
    sel = node.expr if isinstance(node, Subquery) else node
    if isinstance(sel, VectorSelector):
        return {m.label: m.value for m in sel.matchers
                if m.op == "=" and m.label not in ("__name__", "__field__")}
    return {}


def _edges_enabled() -> bool:
    """GREPTIMEDB_TPU_PROMQL_EDGES: the grid fast paths (window edges and
    window sums over a shared sample grid) are on by default; =off pins
    window_stats (the JAX package's switch, read at each evaluation)."""
    return os.environ.get("GREPTIMEDB_TPU_PROMQL_EDGES",
                          "on").lower() not in ("off", "0", "false")


def _matcher_mask(m: Matcher, scan, tag_names) -> np.ndarray:
    """Row mask for one label matcher, via the tag dictionary."""
    if m.label not in tag_names:
        # a missing label behaves as the empty string
        empty_match = (m.op == "=" and m.value == "") or \
            (m.op == "!=" and m.value != "") or \
            (m.op == "=~" and re.fullmatch(m.value, "") is not None) or \
            (m.op == "!~" and re.fullmatch(m.value, "") is None)
        return np.full(scan.num_rows, empty_match, dtype=bool)
    codes = scan.columns[m.label]
    values = scan.tag_dicts[m.label]
    lut = np.zeros(len(values) + 1, dtype=bool)  # slot -1 -> last (empty)
    if m.op == "=":
        lut[:-1] = values == m.value if len(values) else False
        lut[-1] = m.value == ""
    elif m.op == "!=":
        lut[:-1] = values != m.value
        lut[-1] = m.value != ""
    else:
        rx = re.compile(m.value)
        hits = np.asarray([rx.fullmatch(str(x)) is not None
                           for x in values], dtype=bool)
        empty_hit = rx.fullmatch("") is not None
        if m.op == "=~":
            lut[:-1] = hits
            lut[-1] = empty_hit
        else:
            lut[:-1] = ~hits
            lut[-1] = not empty_hit
    return lut[codes]


def _to_long_result(times: np.ndarray, result) -> QueryResult:
    """Matrix -> long-format table (labels..., ts, value), NaN cells
    dropped (the reference's TQL tabular output)."""
    ts_ms = (times * 1000).astype(np.int64)
    if not isinstance(result, SeriesMatrix):
        arr = np.full(len(times), float(result)) \
            if isinstance(result, (int, float)) else result.cpu().numpy()
        return QueryResult(["ts", "value"],
                           [DataType.TIMESTAMP_MILLISECOND, DataType.FLOAT64],
                           [ts_ms, arr])
    vals = result.values.cpu().numpy()
    label_keys = sorted({k for lab in result.labels for k in lab})
    present = ~np.isnan(vals)
    srow, scol = np.nonzero(present)  # row-major: series, then time
    lab_cols = {k: np.asarray([lab.get(k) for lab in result.labels],
                              dtype=object)[srow] for k in label_keys}
    names = label_keys + ["ts", "value"]
    dtypes = [DataType.STRING] * len(label_keys) + \
        [DataType.TIMESTAMP_MILLISECOND, DataType.FLOAT64]
    cols = [lab_cols[k] for k in label_keys] + [ts_ms[scol], vals[present]]
    return QueryResult(names, dtypes, cols)
