"""Window function evaluation over in-memory columns (copy of
greptimedb_tpu/query/window.py).

Mirrors the reference's window-function capability (DataFusion
WindowAggExec behind the forked sqlparser-rs OVER clause,
reference src/query/src/datafusion.rs:66 planner). The port runs
windows on the host over the materialized relation: the scan + filter
still use the device path, and window output sizes are the post-filter
row counts (dashboards: thousands, not the raw scan).

Semantics implemented:
- ranking: row_number, rank, dense_rank, ntile(k)
- navigation: lag(x[,k[,default]]), lead, first_value, last_value,
  nth_value(x, k)
- aggregates over the window: count, sum, avg/mean, min, max
- frames: the SQL defaults — whole-partition when there is no ORDER BY,
  running-to-current-row (RANGE, peer-sharing) when there is — plus
  explicit `ROWS|RANGE` frames with `UNBOUNDED PRECEDING`, `k PRECEDING`
  (numeric, or an INTERVAL for RANGE over a timestamp order key),
  `CURRENT ROW` and `UNBOUNDED FOLLOWING` bounds. Sliding aggregates run
  as cumulative-sum differences; sliding min/max as a vectorized sparse
  table — no per-row Python, so moving averages over a million rows stay
  array-speed (reference gets the same frames from DataFusion's
  WindowAggExec).
- windows over GROUP BY output in the same SELECT (SQL evaluation
  order: aggregate first, windows over the grouped relation) — see
  split_groupby_window.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.query.expr import PlanError, eval_host
from greptimedb_tpu_torch.sql import ast

_RANKING = {"row_number", "rank", "dense_rank", "ntile"}
_NAV = {"lag", "lead", "first_value", "last_value", "nth_value"}
_WAGGS = {"count", "sum", "avg", "mean", "min", "max"}
SUPPORTED = _RANKING | _NAV | _WAGGS


def contains_window(e) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.over is not None:
            return True
        return any(contains_window(a) for a in e.args)
    if isinstance(e, (list, tuple)):
        return any(contains_window(x) for x in e)
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)) and contains_window(v):
                return True
    return False


def select_has_window(sel: ast.Select) -> bool:
    return (any(contains_window(it.expr) for it in sel.items)
            or any(contains_window(ob.expr) for ob in sel.order_by))


def rewrite_select(sel: ast.Select, cols: dict, n: int, resolve,
                   dtypes: Optional[dict] = None):
    """Compute every window call in `sel` over `cols` (mutated: one
    `__win_i` array per distinct call is added) and return a copy of
    `sel` with those calls replaced by column references. The caller's
    normal projection/order machinery then just reads the arrays.
    `dtypes` (column name -> DataType) lets INTERVAL frame offsets
    resolve against timestamp order keys. A SELECT that still carries
    GROUP BY must go through split_groupby_window first."""
    if sel.group_by:
        raise PlanError(
            "window functions cannot be combined with GROUP BY in one "
            "SELECT; aggregate in a subquery or CTE first")

    def dtype_of(e):
        r = resolve(e)
        if isinstance(r, ast.Column) and dtypes:
            return dtypes.get(r.name)
        return None

    calls = collect_window_calls(sel)
    if not calls:
        return sel
    mapping: list[tuple[ast.FuncCall, ast.Column]] = []
    for i, fc in enumerate(calls):
        name = f"__win_{i}"
        cols[name] = _eval_window(fc, cols, n, resolve, dtype_of)
        mapping.append((fc, ast.Column(name)))
    return substitute_window_calls(sel, mapping)


def collect_window_calls(sel: ast.Select) -> list:
    """Distinct window calls in SELECT items and ORDER BY, in first-seen
    order (window args cannot themselves be windows, per SQL)."""
    calls: list[ast.FuncCall] = []

    def collect(e):
        if isinstance(e, ast.FuncCall) and e.over is not None:
            if e not in calls:
                calls.append(e)
            return
        if isinstance(e, (list, tuple)):
            for x in e:
                collect(x)
        elif dataclasses.is_dataclass(e) and not isinstance(e, type):
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (ast.Expr, list, tuple)):
                    collect(v)

    for it in sel.items:
        collect(it.expr)
    for ob in sel.order_by:
        collect(ob.expr)
    return calls


def substitute_window_calls(sel: ast.Select, mapping) -> ast.Select:
    """Replace each (call, column) pair in items/ORDER BY, keeping the
    user-visible header when an unaliased call collapses to an internal
    column reference."""

    def replace(e):
        if isinstance(e, ast.FuncCall) and e.over is not None:
            for fc, col in mapping:
                if e == fc:
                    return col
            return e
        if isinstance(e, (list, tuple)):
            return type(e)(replace(x) for x in e)
        if dataclasses.is_dataclass(e) and not isinstance(e, type) \
                and isinstance(e, ast.Expr):
            changes = {}
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (ast.Expr, list, tuple)):
                    nv = replace(v)
                    if nv != v:
                        changes[f.name] = nv
            if changes:
                return dataclasses.replace(e, **changes)
        return e

    from greptimedb_tpu_torch.query.join import _expr_name

    items = []
    for it in sel.items:
        ne = replace(it.expr)
        alias = it.alias
        if alias is None and ne != it.expr:
            alias = _expr_name(it.expr)
        items.append(dataclasses.replace(it, expr=ne, alias=alias))
    order_by = [dataclasses.replace(ob, expr=replace(ob.expr))
                for ob in sel.order_by]
    return dataclasses.replace(sel, items=items, order_by=order_by)


# ---- core ------------------------------------------------------------------


def _is_nan(v) -> bool:
    return isinstance(v, float) and v != v


def _factorize(arr) -> np.ndarray:
    """Order-preserving integer codes: codes compare exactly like the
    values, with NULL (None/NaN) sorting last."""
    a = np.asarray(arr)
    if a.dtype == object:
        uniq: dict = {}
        for v in a:
            k = None if v is None or _is_nan(v) else v
            if k not in uniq:
                uniq[k] = None
        keys = sorted((k for k in uniq if k is not None)) + \
            ([None] if None in uniq else [])
        remap = {k: i for i, k in enumerate(keys)}
        return np.asarray(
            [remap[None if v is None or _is_nan(v) else v] for v in a],
            dtype=np.int64)
    if a.dtype.kind == "f":
        b = np.where(np.isnan(a), np.inf, a)
        _, codes = np.unique(b, return_inverse=True)
        return codes.astype(np.int64)
    _, codes = np.unique(a, return_inverse=True)
    return codes.astype(np.int64)


def _composite(codes_list: list[np.ndarray], n: int) -> np.ndarray:
    if not codes_list:
        return np.zeros(n, dtype=np.int64)
    pid = codes_list[0].astype(np.int64)
    for c in codes_list[1:]:
        width = int(c.max()) + 1 if len(c) else 1
        _, pid = np.unique(pid * width + c, return_inverse=True)
        pid = pid.astype(np.int64)
    return pid


def _as_column(v, n: int) -> np.ndarray:
    arr = np.asarray(v)
    if arr.ndim == 0:
        return np.broadcast_to(arr, (n,)).copy()
    return arr


def _eval_window(fc: ast.FuncCall, cols: dict, n: int, resolve,
                 dtype_of=None) -> np.ndarray:
    name = fc.name
    if name not in SUPPORTED:
        raise PlanError(f"unsupported window function {name!r}")
    spec = fc.over

    def ev(e):
        return _as_column(eval_host(resolve(e), cols, None, None, n), n)

    pcodes = [_factorize(ev(p)) for p in spec.partition_by]
    pid = _composite(pcodes, n)
    ocodes = []
    for oexpr, asc in spec.order_by:
        c = _factorize(ev(oexpr))
        ocodes.append(c if asc else -c)
    # lexsort: last key is primary → (order keys reversed, then pid last)
    order = np.lexsort(tuple(reversed(ocodes)) + (pid,)) if ocodes \
        else np.lexsort((pid,))
    pid_s = pid[order]
    new_seg = np.empty(n, dtype=bool)
    if n:
        new_seg[0] = True
        new_seg[1:] = pid_s[1:] != pid_s[:-1]
    # peer rows: same partition AND equal on every order key
    new_peer = new_seg.copy()
    for c in ocodes:
        cs = c[order]
        if n:
            new_peer[1:] |= cs[1:] != cs[:-1]
    seg_id = np.cumsum(new_seg) - 1 if n else np.zeros(0, dtype=np.int64)
    run_id = np.cumsum(new_peer) - 1 if n else np.zeros(0, dtype=np.int64)
    seg_starts = np.flatnonzero(new_seg)
    run_starts = np.flatnonzero(new_peer)
    run_ends = np.append(run_starts[1:] - 1, n - 1) if n else run_starts
    # row number within segment, 1-based
    rn = (np.arange(n) - seg_starts[seg_id] + 1) if n \
        else np.zeros(0, dtype=np.int64)

    unit, fstart, fend = _parse_frame(spec.frame, bool(spec.order_by))
    seg_ends = np.append(seg_starts[1:] - 1, n - 1) if n else seg_starts
    idx = np.arange(n)
    # per-row frame bounds [st, en] (inclusive, sorted positions)
    if fstart[0] == "unbounded":
        st = seg_starts[seg_id] if n else idx
    elif unit == "rows":
        if isinstance(fstart[1], tuple):
            raise PlanError("ROWS frames take a row count, not an INTERVAL")
        st = np.maximum(seg_starts[seg_id], idx - int(fstart[1]))
    else:
        st = _range_frame_starts(spec, fstart[1], ev, order, seg_starts,
                                 seg_id, n, dtype_of)
    if fend[0] == "unbounded":
        en = seg_ends[seg_id] if n else idx
    elif unit == "rows":
        en = idx
    else:
        # RANGE ... CURRENT ROW includes the current row's peers
        en = run_ends[run_id] if n else idx

    out_s = _compute(fc, name, ev, order, n, pid_s, seg_id, run_id,
                     seg_starts, run_starts, seg_ends, rn, st, en)
    out = np.empty(n, dtype=out_s.dtype)
    out[order] = out_s
    return out


_BOUND_RE = re.compile(r"^(.*?)\s+(preceding|following)$")


def _parse_frame(frame: Optional[str], has_order: bool):
    """Frame text -> (unit, start, end). unit "rows"|"range"; start
    ("unbounded",) or ("preceding", k) with k a number or ("interval",
    nanos); end ("current",) or ("unbounded",). No frame text means the
    SQL defaults: whole partition without ORDER BY, RANGE UNBOUNDED
    PRECEDING .. CURRENT ROW with it. Unsupported shapes raise — running
    a moving average as a running sum would be silently wrong."""
    if not frame:
        return (("range", ("unbounded",), ("current",)) if has_order
                else ("rows", ("unbounded",), ("unbounded",)))
    text = " ".join(frame.split())
    m = re.match(r"^(rows|range|groups)\s+(.*)$", text)
    if not m:
        raise PlanError(f"unsupported window frame {frame!r}")
    unit, rest = m.group(1), m.group(2)
    if unit == "groups":
        raise PlanError("GROUPS window frames are not supported")
    if rest.startswith("between "):
        m2 = re.match(r"^between\s+(.*?)\s+and\s+(.*)$", rest)
        if m2 is None:
            raise PlanError(f"unsupported window frame {frame!r}")
        b1, b2 = m2.group(1), m2.group(2)
    else:
        b1, b2 = rest, "current row"
    start = _parse_bound(b1, frame, is_end=False)
    end = _parse_bound(b2, frame, is_end=True)
    if start[0] == "preceding" and not has_order:
        raise PlanError(
            "a window frame with an offset requires ORDER BY")
    return unit, start, end


def _parse_bound(s: str, frame: str, is_end: bool):
    s = s.strip()
    if s == "unbounded preceding" and not is_end:
        return ("unbounded",)
    if s == "current row" and is_end:
        return ("current",)
    if s == "unbounded following" and is_end:
        return ("unbounded",)
    if not is_end:
        m = _BOUND_RE.match(s)
        if m is not None and m.group(2) == "preceding":
            val = m.group(1).strip()
            im = re.match(r"^interval\s+'([^']*)'$", val)
            if im is not None:
                from greptimedb_tpu_torch.sql.parser import Parser

                iv = Parser(f"INTERVAL '{im.group(1)}'").parse_expr()
                return ("preceding", ("interval", iv.nanos))
            try:
                return ("preceding", float(val))
            except ValueError:
                pass
    raise PlanError(
        f"unsupported window frame bound {s!r} in {frame!r}; supported: "
        "UNBOUNDED PRECEDING / <n> PRECEDING / INTERVAL '...' PRECEDING "
        "starts and CURRENT ROW / UNBOUNDED FOLLOWING ends")


def _range_frame_starts(spec, value, ev, order, seg_starts, seg_id, n,
                        dtype_of):
    """Window start indices for RANGE <delta> PRECEDING: first row of the
    current segment whose order-key value >= current - delta. Order keys
    are ascending within each sorted segment, so one global searchsorted
    over a segment-shifted encoding answers every row at once."""
    if len(spec.order_by) != 1:
        raise PlanError(
            "RANGE offset frames require exactly one ORDER BY key")
    oexpr, asc = spec.order_by[0]
    if isinstance(value, tuple):  # ("interval", nanos)
        dt = dtype_of(oexpr) if dtype_of is not None else None
        if dt is None or not getattr(dt, "is_timestamp", False):
            raise PlanError(
                "INTERVAL frame offsets need a timestamp ORDER BY key "
                "of known type; use a numeric offset instead")
        delta = float(value[1] // dt.time_unit.nanos_per_unit)
    else:
        delta = float(value)
    if delta < 0:
        raise PlanError("window frame offsets must be non-negative")
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    vals = np.asarray(ev(oexpr))
    if vals.dtype == object or vals.dtype.kind not in "iuf":
        raise PlanError("RANGE offset frames need a numeric or timestamp "
                        "ORDER BY key")
    # integer order keys (timestamps) stay in int64: a float64 detour
    # loses sub-256ns resolution at epoch-ns magnitudes and the
    # segment-shift encoding compounds it
    exact = vals.dtype.kind in "iu" and float(delta).is_integer()
    v = vals[order].astype(np.int64 if exact else np.float64)
    if not exact and np.isnan(v).any():
        raise PlanError("RANGE offset frames need a non-NULL ORDER BY key")
    if not asc:
        v = -v  # descending: preceding means larger values
    # segment-shifted monotone encoding: strictly increasing across
    # segment seams because the shift exceeds the global value span
    nseg = int(seg_id[-1]) + 1
    if exact:
        d = int(delta)
        # Python-int arithmetic: an int64 subtraction could itself wrap
        span = (int(v.max()) - int(v.min())) if n else 0
        shift = span + d + 1
        if nseg * shift < (1 << 62):  # headroom against int64 overflow
            base = v - int(v.min())
            b = base + seg_id * shift
            starts = np.searchsorted(b, b - d, side="left")
            return np.maximum(starts, seg_starts[seg_id])
        v = v.astype(np.float64)  # astronomically wide: approximate
    delta = float(delta)
    span = float(v.max() - v.min()) if n else 0.0
    shift = span + delta + 1.0
    b = v + seg_id.astype(np.float64) * shift
    starts = np.searchsorted(b, b - delta, side="left")
    return np.maximum(starts, seg_starts[seg_id])


def _arg_values(fc, ev, order, n):
    if not fc.args or isinstance(fc.args[0], ast.Star):
        return None
    return ev(fc.args[0])[order]


def _lit(e, default=None):
    if e is None:
        return default
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.UnaryOp) and e.op == "-" \
            and isinstance(e.operand, ast.Literal):
        return -e.operand.value
    raise PlanError("window offset/default arguments must be literals")


def _range_extreme(mv: np.ndarray, st: np.ndarray, en: np.ndarray, op):
    """min/max over arbitrary inclusive index ranges [st, en] via a
    sparse table: level j holds op over blocks of 2^j, a query combines
    the two blocks covering the range — O(n log n) build, O(n) query,
    all vectorized (the frame machinery's RMQ; no per-row Python)."""
    n = len(mv)
    if n == 0:
        return mv
    length = en - st + 1
    max_level = max(int(np.max(length)).bit_length() - 1, 0)
    tables = [mv]
    for j in range(1, max_level + 1):
        prev = tables[-1]
        half = 1 << (j - 1)
        m_len = len(prev) - half  # level j covers n - 2^j + 1 positions
        tables.append(op(prev[:m_len], prev[half:half + m_len]))
    j = np.maximum(
        np.frexp(length.astype(np.float64))[1] - 1, 0).astype(np.int64)
    out = np.empty(n, dtype=mv.dtype)
    for lvl in range(max_level + 1):
        rows = np.flatnonzero(j == lvl)
        if rows.size == 0:
            continue
        t = tables[lvl]
        a = st[rows]
        b = en[rows] - (1 << lvl) + 1
        out[rows] = op(t[a], t[b])
    return out


def _compute(fc, name, ev, order, n, pid_s, seg_id, run_id, seg_starts,
             run_starts, seg_ends, rn, st, en):
    if name == "row_number":
        return rn.astype(np.int64)
    if name == "rank":
        return rn[run_starts][run_id].astype(np.int64)
    if name == "dense_rank":
        return (run_id - run_id[seg_starts][seg_id] + 1).astype(np.int64)
    if name == "ntile":
        k = int(_lit(fc.args[0] if fc.args else None, 1))
        if k <= 0:
            raise PlanError("ntile() requires a positive bucket count")
        seg_len = (seg_ends - seg_starts + 1)[seg_id]
        # SQL ntile: first (len % k) buckets get ceil(len/k) rows
        base, rem = seg_len // k, seg_len % k
        big = (base + 1) * rem
        r0 = rn - 1
        out = np.where(
            (base > 0) & (r0 < big), r0 // np.maximum(base + 1, 1) + 1,
            np.where(base > 0, (r0 - big) // np.maximum(base, 1) + rem + 1,
                     r0 + 1))
        return np.minimum(out, seg_len).astype(np.int64)

    vals = _arg_values(fc, ev, order, n)
    if vals is None and name != "count":
        raise PlanError(f"window function {name}() requires an argument")
    if name in ("lag", "lead"):
        k = int(_lit(fc.args[1] if len(fc.args) > 1 else None, 1))
        default = _lit(fc.args[2] if len(fc.args) > 2 else None, None)
        if name == "lead":
            k = -k
        idx = np.arange(n) - k
        valid = (idx >= 0) & (idx < n)
        src = np.clip(idx, 0, max(n - 1, 0))
        valid &= pid_s[src] == pid_s  # stay within the partition
        out = np.asarray(vals, dtype=object)[src]
        out[~valid] = default
        return out
    if n == 0:
        return np.empty(0, dtype=object)
    # frame-positional navigation: first/last/nth read directly at the
    # frame bounds (with the default frames these reduce to the classic
    # partition-start / running-end behaviors)
    if name == "first_value":
        return np.asarray(vals, dtype=object)[st]
    if name == "last_value":
        return np.asarray(vals, dtype=object)[en]
    if name == "nth_value":
        k = int(_lit(fc.args[1] if len(fc.args) > 1 else None, 1))
        if k < 1:
            raise PlanError("nth_value() position must be >= 1")
        pos = st + (k - 1)
        ok = pos <= en
        out = np.asarray(vals, dtype=object)[np.minimum(pos, en)]
        out[~ok] = None
        return out

    # windowed aggregates over [st, en]: cumulative-sum differences for
    # sum/count/avg, sparse-table range queries for min/max
    if name == "count" and vals is None:
        fv = np.ones(n, dtype=np.float64)
        valid = np.ones(n, dtype=bool)
    else:
        if vals.dtype == object:
            fv = np.asarray(
                [np.nan if v is None or _is_nan(v) else float(v)
                 for v in vals], dtype=np.float64)
        else:
            fv = vals.astype(np.float64)
        valid = ~np.isnan(fv)
        fv = np.where(valid, fv, 0.0)
    if name in ("min", "max"):
        op = np.minimum if name == "min" else np.maximum
        init = np.inf if name == "min" else -np.inf
        mv = np.where(valid, fv, init)
        m = _range_extreme(mv, st, en, op)
        has = _range_extreme(valid.astype(np.float64), st, en, np.maximum)
        return np.where(has > 0, m, np.nan)
    csum = np.concatenate([[0.0], np.cumsum(fv)])
    ccnt = np.concatenate([[0.0], np.cumsum(valid.astype(np.float64))])
    wsum = csum[en + 1] - csum[st]
    wcnt = ccnt[en + 1] - ccnt[st]
    if name == "count":
        return wcnt.astype(np.int64)
    if name == "sum":
        return np.where(wcnt > 0, wsum, np.nan)
    return np.where(wcnt > 0, wsum / np.maximum(wcnt, 1), np.nan)
