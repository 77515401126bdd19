"""Expression compilation: bind -> (device | host) evaluation
(counterpart of greptimedb_tpu/query/expr.py).

Binding rewrites an AST expression against a scan context so the device
never sees strings:
  - tag-column string comparisons become int32 code comparisons
  - LIKE on a tag becomes an InList of matching codes (pattern evaluated
    against the small dictionary on host)
  - timestamp literals are coerced to the column's storage unit
Binding and host evaluation are copied from the JAX package; the device
evaluator is rewritten over torch tensors. Literals become 0-d tensors on
the columns' device, which, like JAX's weakly typed scalars, take the
dtype of the column they meet.

The host evaluator mirrors device semantics over numpy and additionally
handles aggregate-result substitution (post-aggregation HAVING/ORDER BY/
projection) via an identity-keyed env.
"""

from __future__ import annotations

import contextvars
import re
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.datatypes.types import DataType
from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.utils.time import (
    coerce_ts_literal as _coerce_ts_literal_raw,
)


# session timezone for naive timestamp-literal coercion. A contextvar —
# not a parameter — because coercion happens at every depth of binding,
# host eval, and ts-bound extraction; the engine installs it per
# statement.
_SESSION_TZ: contextvars.ContextVar = contextvars.ContextVar(
    "gtpu_torch_session_tz", default=None)


def set_session_tz(tz):
    return _SESSION_TZ.set(tz)


def reset_session_tz(token) -> None:
    _SESSION_TZ.reset(token)


def current_session_tz():
    return _SESSION_TZ.get()


def coerce_ts_literal(value, dtype, tz=None):
    """Timestamp literal -> the column's storage unit; naive literals in
    `tz`, else in the session timezone."""
    return _coerce_ts_literal_raw(value, dtype, tz or _SESSION_TZ.get())


MISSING_CODE = -2  # literal not present in the tag dictionary: matches nothing


class PlanError(Exception):
    pass


@dataclass
class BindContext:
    schema: Schema
    tag_dicts: dict[str, np.ndarray]  # tag name -> value table

    def __post_init__(self):
        self.tag_names = {c.name for c in self.schema.tag_columns}
        self._lookup = {
            name: {v: i for i, v in enumerate(vals)}
            for name, vals in self.tag_dicts.items()
        }

    def code_of(self, tag: str, value) -> int:
        if value is None:
            return -1
        return self._lookup.get(tag, {}).get(value, MISSING_CODE)

    def codes_matching(self, tag: str, pred: Callable[[str], bool]) -> list[int]:
        return [i for i, v in enumerate(self.tag_dicts.get(tag, ())) if pred(v)]

    def column_dtype(self, name: str) -> DataType:
        return self.schema.column(name).dtype


# ---- binding ---------------------------------------------------------------


def bind_expr(e: ast.Expr, ctx: BindContext) -> ast.Expr:
    """Rewrite tag/timestamp literals; recurse structurally."""
    if isinstance(e, ast.BinaryOp):
        l, r = e.left, e.right
        if e.op in ("=", "!=", "<", "<=", ">", ">="):
            tag = _tag_side(l, r, ctx)
            if tag is not None:
                col, lit, flipped = tag
                if e.op in ("=", "!="):
                    return ast.BinaryOp(e.op, col, ast.Literal(ctx.code_of(col.name, lit.value)))
                # ordering comparison: evaluate against the (small) dictionary
                # on host -> membership test over matching codes, so the
                # device still only sees int32 codes
                op = _flip(e.op) if flipped else e.op
                litv = str(lit.value)  # tags are strings; compare as strings
                cmp = {
                    "<": lambda v: v < litv,
                    "<=": lambda v: v <= litv,
                    ">": lambda v: v > litv,
                    ">=": lambda v: v >= litv,
                }[op]
                codes = ctx.codes_matching(col.name, lambda v: cmp(str(v)))
                return ast.InList(col, tuple(ast.Literal(c) for c in codes))
            ts = _ts_side(l, r, ctx)
            if ts is not None:
                col, lit, flipped = ts
                coerced = ast.Literal(coerce_ts_literal(lit.value, ctx.column_dtype(col.name)))
                op = _flip(e.op) if flipped else e.op
                return ast.BinaryOp(op, col, coerced)
        if e.op == "like":
            if isinstance(l, ast.Column) and l.name in ctx.tag_names and isinstance(r, ast.Literal):
                rx = _like_to_regex(str(r.value))
                codes = ctx.codes_matching(l.name, lambda v: rx.fullmatch(v) is not None)
                return ast.InList(l, tuple(ast.Literal(c) for c in codes))
            # non-tag LIKE (string FIELD columns): pass through — the host
            # filter path evaluates it; the device path raises at eval
            return ast.BinaryOp(e.op, bind_expr(l, ctx), bind_expr(r, ctx))
        return ast.BinaryOp(e.op, bind_expr(l, ctx), bind_expr(r, ctx))
    if isinstance(e, ast.UnaryOp):
        return ast.UnaryOp(e.op, bind_expr(e.operand, ctx))
    if isinstance(e, ast.Between):
        col = e.expr
        if isinstance(col, ast.Column) and col.name in ctx.schema.names and \
           ctx.column_dtype(col.name).is_timestamp:
            lo = ast.Literal(coerce_ts_literal(_lit(e.low), ctx.column_dtype(col.name)))
            hi = ast.Literal(coerce_ts_literal(_lit(e.high), ctx.column_dtype(col.name)))
            return ast.Between(col, lo, hi, e.negated)
        if isinstance(col, ast.Column) and col.name in ctx.tag_names and \
                isinstance(e.low, ast.Literal) and isinstance(e.high, ast.Literal):
            # string BETWEEN on a tag: evaluate against the dictionary on
            # host (same trick as ordered comparisons above) so the device
            # only ever sees int32 codes
            lo, hi = str(e.low.value), str(e.high.value)
            codes = ctx.codes_matching(col.name, lambda v: lo <= str(v) <= hi)
            inl = ast.InList(col, tuple(ast.Literal(c) for c in codes))
            return ast.UnaryOp("not", inl) if e.negated else inl
        return ast.Between(bind_expr(e.expr, ctx), bind_expr(e.low, ctx),
                           bind_expr(e.high, ctx), e.negated)
    if isinstance(e, ast.InList):
        if isinstance(e.expr, ast.Column) and e.expr.name in ctx.tag_names:
            codes = tuple(
                ast.Literal(ctx.code_of(e.expr.name, _lit(i))) for i in e.items
            )
            return ast.InList(e.expr, codes, e.negated)
        return ast.InList(bind_expr(e.expr, ctx),
                          tuple(bind_expr(i, ctx) for i in e.items), e.negated)
    if isinstance(e, ast.IsNull):
        return ast.IsNull(bind_expr(e.expr, ctx), e.negated)
    if isinstance(e, ast.FuncCall):
        return ast.FuncCall(e.name, tuple(bind_expr(a, ctx) for a in e.args), e.distinct)
    if isinstance(e, ast.Cast):
        return ast.Cast(bind_expr(e.expr, ctx), e.type_name)
    if isinstance(e, ast.Case):
        return ast.Case(
            bind_expr(e.operand, ctx) if e.operand else None,
            tuple((bind_expr(c, ctx), bind_expr(v, ctx)) for c, v in e.whens),
            bind_expr(e.else_, ctx) if e.else_ else None,
        )
    return e


def _lit(e: ast.Expr):
    if not isinstance(e, ast.Literal):
        raise PlanError(f"expected literal, got {e}")
    return e.value


class HostBindContext(BindContext):
    """Binding for host-side evaluation over DECODED columns: timestamp
    literals still coerce to the column unit, but tag comparisons stay as
    string comparisons (no dictionary-code rewriting — host rows carry
    real strings, not codes)."""

    def __post_init__(self):
        super().__post_init__()
        self.tag_names = set()


def bind_host_expr(e, schema):
    return bind_expr(e, HostBindContext(schema, {}))


def _tag_side(l, r, ctx):
    if isinstance(l, ast.Column) and l.name in ctx.tag_names and isinstance(r, ast.Literal):
        return l, r, False
    if isinstance(r, ast.Column) and r.name in ctx.tag_names and isinstance(l, ast.Literal):
        return r, l, True
    return None


def _ts_side(l, r, ctx):
    if (isinstance(l, ast.Column) and l.name in ctx.schema.names
            and ctx.column_dtype(l.name).is_timestamp and isinstance(r, ast.Literal)):
        return l, r, False
    if (isinstance(r, ast.Column) and r.name in ctx.schema.names
            and ctx.column_dtype(r.name).is_timestamp and isinstance(l, ast.Literal)):
        return r, l, True
    return None


def _flip(op: str) -> str:
    return {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(op, op)


def _like_to_regex(pattern: str) -> re.Pattern:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.IGNORECASE | re.DOTALL)


# ---- device evaluation (torch tensors; expr must be bound) -----------------

_DEVICE_FUNCS = {
    "abs": torch.abs, "sqrt": torch.sqrt, "exp": torch.exp,
    "ln": torch.log, "log": torch.log, "log2": torch.log2,
    "log10": torch.log10,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "floor": torch.floor, "ceil": torch.ceil, "signum": torch.sign,
    "trunc": torch.trunc,
}


def _device_of(cols: dict) -> torch.device:
    for v in cols.values():
        return v.device
    return torch.device("cpu")


def _literal(value, device: torch.device) -> torch.Tensor:
    """0-d tensor for a SQL literal. Integers are int64 and floats f64,
    as under JAX's x64 mode; a 0-d tensor takes the dtype of the column
    it meets when both are of one kind (int with int, float with
    float), as a JAX weakly typed scalar does."""
    if value is None:
        return torch.tensor(float("nan"), dtype=torch.float64, device=device)
    if isinstance(value, bool):
        return torch.tensor(value, dtype=torch.bool, device=device)
    if isinstance(value, int):
        return torch.tensor(value, dtype=torch.int64, device=device)
    if isinstance(value, float):
        return torch.tensor(value, dtype=torch.float64, device=device)
    raise PlanError(f"literal {value!r} cannot be evaluated on device")


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    """Integer floor division, exact on negative timestamps (Python's
    and JAX's `//`, not C's truncation)."""
    return torch.div(a, b, rounding_mode="floor")


def eval_device(e: ast.Expr, cols: dict, ctx_tags: frozenset, schema: Schema):
    """Evaluate a bound expression over device column tensors."""

    def ev(x):
        return eval_device(x, cols, ctx_tags, schema)

    if isinstance(e, ast.Column):
        if e.name not in cols:
            raise PlanError(f"column {e.name!r} not available on device")
        return cols[e.name]
    if isinstance(e, ast.Literal):
        return _literal(e.value, _device_of(cols))
    if isinstance(e, ast.Interval):
        return _literal(e.nanos, _device_of(cols))
    if isinstance(e, ast.BinaryOp):
        if e.op == "and":
            return _as_bool(ev(e.left)) & _as_bool(ev(e.right))
        if e.op == "or":
            return _as_bool(ev(e.left)) | _as_bool(ev(e.right))
        a, b = ev(e.left), ev(e.right)
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        if e.op == "/":
            if not (a.dtype.is_floating_point or b.dtype.is_floating_point):
                return _floor_div(a, b)
            return a / b
        if e.op == "%":
            return torch.remainder(a, b)
        if e.op == "=":
            return a == b
        if e.op == "!=":
            return a != b
        if e.op == "<":
            return a < b
        if e.op == "<=":
            return a <= b
        if e.op == ">":
            return a > b
        if e.op == ">=":
            return a >= b
        raise PlanError(f"unsupported device op {e.op!r}")
    if isinstance(e, ast.UnaryOp):
        v = ev(e.operand)
        return ~_as_bool(v) if e.op == "not" else -v
    if isinstance(e, ast.Between):
        x = ev(e.expr)
        res = (x >= ev(e.low)) & (x <= ev(e.high))
        return ~res if e.negated else res
    if isinstance(e, ast.InList):
        x = ev(e.expr)
        if not e.items:
            res = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        else:
            res = x == ev(e.items[0])
            for item in e.items[1:]:
                res = res | (x == ev(item))
        return ~res if e.negated else res
    if isinstance(e, ast.IsNull):
        x = e.expr
        if isinstance(x, ast.Column) and x.name in ctx_tags:
            res = cols[x.name] < 0
        else:
            v = ev(x)
            res = torch.isnan(v) if v.dtype.is_floating_point \
                else torch.zeros(v.shape, dtype=torch.bool, device=v.device)
        return ~res if e.negated else res
    if isinstance(e, ast.FuncCall):
        if e.order_within is not None:
            raise PlanError(
                f"ORDER BY inside {e.name}() is only supported for "
                "first_value/last_value")
        return _eval_device_func(e, ev, cols, schema)
    if isinstance(e, ast.Cast):
        v = ev(e.expr)
        t = e.type_name.lower()
        if t in ("double", "float64"):
            return v.to(torch.float64)
        if t in ("float", "float32", "real"):
            return v.to(torch.float32)
        if t in ("bigint", "int64"):
            return v.to(torch.int64)
        if t in ("int", "integer", "int32"):
            return v.to(torch.int32)
        raise PlanError(f"unsupported device cast to {e.type_name!r}")
    if isinstance(e, ast.Case):
        if e.operand is not None:
            op = ev(e.operand)
            conds = [op == ev(c) for c, _ in e.whens]
        else:
            conds = [_as_bool(ev(c)) for c, _ in e.whens]
        vals = [ev(v) for _, v in e.whens]
        out = ev(e.else_) if e.else_ is not None \
            else _literal(None, _device_of(cols))
        for c, v in zip(reversed(conds), reversed(vals)):
            out = torch.where(c, v, out)
        return out
    raise PlanError(f"cannot evaluate {e!r} on device")


def _eval_device_func(e: ast.FuncCall, ev, cols, schema: Schema):
    name = e.name
    if name in ("date_bin", "time_bucket"):
        # date_bin(interval, ts[, origin]) -> bucket START timestamp
        interval, ts_expr = e.args[0], e.args[1]
        step = _interval_in_col_unit(interval, ts_expr, schema)
        ts = ev(ts_expr)
        origin = 0
        if len(e.args) > 2:
            origin = int(_lit(e.args[2]))
        return _floor_div(ts - origin, step) * step + origin
    if name == "date_trunc":
        unit_lit, ts_expr = e.args[0], e.args[1]
        unit = str(_lit(unit_lit)).lower()
        nanos = _TRUNC_UNITS.get(unit)
        if nanos is None:
            raise PlanError(f"date_trunc unit {_lit(unit_lit)!r} unsupported")
        step = _scale_to_col_unit(nanos, ts_expr, schema)
        ts = ev(ts_expr)
        # weeks start on Monday (PostgreSQL semantics); the epoch is a
        # Thursday, so shift by 3 days before flooring
        shift = _scale_to_col_unit(3 * 86400 * 10**9, ts_expr, schema) \
            if unit == "week" else 0
        return _floor_div(ts + shift, step) * step - shift
    if name in ("pow", "power"):
        return torch.pow(ev(e.args[0]), ev(e.args[1]))
    if name == "round":
        v = ev(e.args[0])
        if len(e.args) > 1:
            d = int(_lit(e.args[1]))
            f = 10.0 ** d
            return torch.round(v * f) / f
        return torch.round(v)
    if name == "clamp":
        lo, hi = ev(e.args[1]), ev(e.args[2])
        return torch.minimum(torch.maximum(ev(e.args[0]), lo), hi)
    if name in ("mod", "atan2") and len(e.args) == 2:
        a, b = ev(e.args[0]), ev(e.args[1])
        return torch.remainder(a, b) if name == "mod" else torch.atan2(a, b)
    if name in ("greatest", "least") and len(e.args) >= 2:
        f = torch.maximum if name == "greatest" else torch.minimum
        out = ev(e.args[0])
        for a in e.args[1:]:
            out = f(out, ev(a))
        return out
    if name == "coalesce" and e.args:
        out = ev(e.args[0])
        for a in e.args[1:]:
            nxt = ev(a)
            out = torch.where(torch.isnan(out), nxt, out)
        return out
    if name in _DEVICE_FUNCS and len(e.args) == 1:
        v = ev(e.args[0])
        if not v.dtype.is_floating_point and name not in (
                "abs", "signum", "floor", "ceil", "trunc"):
            v = v.to(torch.float64)  # jnp promotes ints to float here
        return _DEVICE_FUNCS[name](v)
    if name == "to_unixtime":
        ts_expr = e.args[0]
        unit = _col_unit_nanos(ts_expr, schema)
        return _floor_div(ev(ts_expr) * unit, 10**9)
    from greptimedb_tpu_torch.plugins import active_plugins
    plugin_fn = active_plugins().scalar_function(name)
    if plugin_fn is not None:
        return _device_plugin_call(plugin_fn, [ev(a) for a in e.args])
    raise PlanError(f"unsupported device function {name!r}")


def _device_plugin_call(fn, args: list):
    """A plugin scalar function inside a device expression: its tensor
    arguments go to the host as numpy arrays (plugins are numpy-
    vectorized callables, as on the host path) and its result comes back
    to the first argument's device. Where the JAX engine raises
    `unsupported device function` for a plugin in an aggregate's WHERE,
    the port evaluates it here."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               None)
    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            for a in args]
    out = np.asarray(fn(*host))
    if dev is None:
        return out
    return torch.as_tensor(np.ascontiguousarray(out), device=dev)


_TRUNC_UNITS = {
    "second": 10**9, "minute": 60 * 10**9, "hour": 3600 * 10**9,
    "day": 86400 * 10**9, "week": 7 * 86400 * 10**9,
}


def _col_unit_nanos(ts_expr: ast.Expr, schema: Schema) -> int:
    if isinstance(ts_expr, ast.Column) and ts_expr.name in schema.names:
        dt = schema.column(ts_expr.name).dtype
        if dt.is_timestamp:
            return dt.time_unit.nanos_per_unit
    return 1  # already nanoseconds or plain int


def _interval_in_col_unit(interval, ts_expr: ast.Expr, schema: Schema) -> int:
    return _scale_to_col_unit(_interval_nanos(interval), ts_expr, schema)


def _interval_nanos(e) -> int:
    """Interval AST node or a duration string literal ('1m', '1 minute')
    → nanoseconds. date_bin/time_bucket accept both spellings."""
    if isinstance(e, ast.Interval):
        return e.nanos
    if isinstance(e, ast.Literal) and isinstance(e.value, str):
        s = e.value.strip().lower()
        verbose = {"second": "s", "seconds": "s", "minute": "m",
                   "minutes": "m", "hour": "h", "hours": "h", "day": "d",
                   "days": "d", "week": "w", "weeks": "w",
                   "millisecond": "ms", "milliseconds": "ms"}
        parts = s.split()
        if len(parts) == 2 and parts[1] in verbose:
            s = parts[0] + verbose[parts[1]]
        try:
            nanos = int(parse_duration_s(s) * 1e9)
        except Exception as exc:  # noqa: BLE001 — planner boundary
            raise PlanError(f"bad interval {e.value!r}") from exc
        if nanos <= 0:
            raise PlanError(f"interval must be positive, got {e.value!r}")
        return nanos
    if isinstance(e, ast.Literal) and isinstance(e.value, (int, float)):
        if int(e.value) <= 0:
            raise PlanError("interval must be positive")
        return int(e.value)
    raise PlanError("expected interval")


_DUR_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0,
              "d": 86400.0, "w": 604800.0, "y": 31536000.0}
_DUR_PART = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)")


def parse_duration_s(text: str) -> float:
    """'1m30s' -> 90.0 (copy of greptimedb_tpu/promql/parser.py's)."""
    total = 0.0
    pos = 0
    for m in _DUR_PART.finditer(text):
        total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(text):
        raise PlanError(f"bad duration {text!r}")
    return total



def _scale_to_col_unit(nanos: int, ts_expr: ast.Expr, schema: Schema) -> int:
    unit = _col_unit_nanos(ts_expr, schema)
    step = max(nanos // unit, 1)
    return step


def _as_bool(v):
    if v.dtype == torch.bool:
        return v
    return v != 0


# ---- host evaluation (numpy; strings allowed; env substitution) ------------


def eval_host(
    e: ast.Expr,
    cols: dict[str, np.ndarray],
    schema: Optional[Schema] = None,
    env: Optional[dict] = None,
    n: Optional[int] = None,
):
    """Numpy twin of eval_device. `env` maps expression *nodes* (hashable)
    to precomputed arrays — how aggregate results and group keys flow into
    post-aggregation expressions."""

    def ev(x):
        return eval_host(x, cols, schema, env, n)

    if env is not None and e in env:
        return env[e]
    if isinstance(e, ast.Column):
        if e.name in cols:
            return cols[e.name]
        raise PlanError(f"unknown column {e.name!r}")
    if isinstance(e, ast.Literal):
        return np.nan if e.value is None else e.value
    if isinstance(e, ast.Interval):
        return e.nanos
    if isinstance(e, ast.BinaryOp):
        if e.op == "and":
            return _np_bool(ev(e.left)) & _np_bool(ev(e.right))
        if e.op == "or":
            return _np_bool(ev(e.left)) | _np_bool(ev(e.right))
        a, b = ev(e.left), ev(e.right)
        if e.op == "like":
            rx = _like_to_regex(str(b))
            return np.asarray([v is not None and rx.fullmatch(str(v)) is not None
                               for v in np.atleast_1d(a)])
        if e.op in ("+", "-", "*", "/", "%") and (
                _holds_null(a) or _holds_null(b)):
            return _null_arith(e.op, a, b)
        ops = {
            "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
            "%": lambda: a % b,
            "=": lambda: _str_eq(a, b), "!=": lambda: ~_str_eq(a, b),
            "<": lambda: a < b, "<=": lambda: a <= b,
            ">": lambda: a > b, ">=": lambda: a >= b,
        }
        if e.op == "/":
            if np.issubdtype(np.result_type(np.asarray(a), np.asarray(b)), np.integer):
                return np.asarray(a) // np.asarray(b)
            return np.asarray(a) / np.asarray(b)
        if e.op in ops:
            return ops[e.op]()
        raise PlanError(f"unsupported host op {e.op!r}")
    if isinstance(e, ast.UnaryOp):
        v = ev(e.operand)
        return ~_np_bool(v) if e.op == "not" else -v
    if isinstance(e, ast.Between):
        x = ev(e.expr)
        res = (x >= ev(e.low)) & (x <= ev(e.high))
        return ~res if e.negated else res
    if isinstance(e, ast.InList):
        x = np.asarray(ev(e.expr))
        items = [_scalar(ev(i)) for i in e.items]
        if x.dtype == object:
            res = np.isin(x.astype(str), [str(i) for i in items])
        else:
            res = np.isin(x, items)
        return ~res if e.negated else res
    if isinstance(e, ast.IsNull):
        v = np.asarray(ev(e.expr))
        if v.dtype == object:
            res = np.asarray([x is None for x in v])
        elif np.issubdtype(v.dtype, np.floating):
            res = np.isnan(v)
        else:
            res = np.zeros(v.shape, bool)
        return ~res if e.negated else res
    if isinstance(e, ast.FuncCall):
        if e.order_within is not None:
            raise PlanError(
                f"ORDER BY inside {e.name}() is only supported for "
                "first_value/last_value")
        return _eval_host_func(e, ev, schema)
    if isinstance(e, ast.Cast):
        v = ev(e.expr)
        t = e.type_name.lower()
        if t in ("double", "float64", "float", "real", "float32"):
            return np.asarray(v, dtype=np.float64)
        if t in ("bigint", "int64", "int", "integer", "int32"):
            return np.asarray(v).astype(np.int64)
        if t in ("string", "varchar", "text"):
            return np.asarray([None if x is None else str(x) for x in np.atleast_1d(v)],
                              dtype=object)
        if t.startswith("timestamp"):
            from greptimedb_tpu_torch.datatypes.types import parse_sql_type
            dtype = parse_sql_type(t)
            arr = np.atleast_1d(v)
            return np.asarray([coerce_ts_literal(x, dtype) for x in arr], dtype=np.int64)
        if t in ("boolean", "bool"):
            arr = np.atleast_1d(v)
            if arr.dtype.kind in ("U", "O", "S"):
                def _b(x):
                    if x is None:
                        return None
                    s = str(x).strip().lower()
                    if s in ("true", "t", "1", "yes"):
                        return True
                    if s in ("false", "f", "0", "no"):
                        return False
                    raise PlanError(f"invalid boolean literal {x!r}")
                out = np.asarray([_b(x) for x in arr], dtype=object)
                return out if np.ndim(v) else out[0]
            return arr.astype(bool) if np.ndim(v) else bool(arr[0])
        raise PlanError(f"unsupported cast to {e.type_name!r}")
    if isinstance(e, ast.Case):
        whens = e.whens
        if e.operand is not None:
            op = np.asarray(ev(e.operand))
            conds = [_str_eq(op, ev(c)) for c, _ in whens]
        else:
            conds = [_np_bool(np.asarray(ev(c))) for c, _ in whens]
        vals = [ev(v) for _, v in whens]
        out = ev(e.else_) if e.else_ is not None else np.nan
        res = np.select(conds, [np.broadcast_to(v, conds[0].shape) for v in vals],
                        default=out)
        return res
    raise PlanError(f"cannot evaluate {e!r} on host")


def _eval_host_func(e: ast.FuncCall, ev, schema):
    name = e.name
    np_funcs = {
        "abs": np.abs, "sqrt": np.sqrt, "exp": np.exp, "ln": np.log,
        "log": np.log, "log2": np.log2, "log10": np.log10,
        "floor": np.floor, "ceil": np.ceil, "signum": np.sign,
        "sin": np.sin, "cos": np.cos, "tan": np.tan, "trunc": np.trunc,
        "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
        "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
        "degrees": np.degrees, "radians": np.radians,
    }
    if name in np_funcs and len(e.args) == 1:
        return np_funcs[name](np.asarray(ev(e.args[0]), dtype=np.float64))
    if name in ("pow", "power"):
        return np.power(ev(e.args[0]), ev(e.args[1]))
    if name in ("mod", "atan2") and len(e.args) == 2:
        f = np.mod if name == "mod" else np.arctan2
        return f(np.asarray(ev(e.args[0]), dtype=np.float64),
                 np.asarray(ev(e.args[1]), dtype=np.float64))
    if name in ("greatest", "least") and len(e.args) >= 2:
        f = np.maximum if name == "greatest" else np.minimum
        out = np.asarray(ev(e.args[0]))
        for a in e.args[1:]:
            out = f(out, np.asarray(ev(a)))
        return out
    if name == "coalesce" and e.args:
        vals = [np.atleast_1d(np.asarray(ev(a))) for a in e.args]
        if any(v.dtype == object for v in vals):
            # string/tag columns: float/NaN semantics would raise; merge
            # elementwise on `is None` instead
            n = max(v.shape[0] for v in vals)
            out = np.broadcast_to(vals[0], (n,)).astype(object).copy()
            for v in vals[1:]:
                nxt = np.broadcast_to(v, (n,))
                # missing = None or NaN (float NULLs keep NaN semantics
                # even when boxed in an object array)
                missing = np.asarray(
                    [x is None or x != x for x in out], dtype=bool)
                out[missing] = nxt[missing]
            return out
        out = vals[0].astype(np.float64)
        for a in vals[1:]:
            nxt = np.broadcast_to(a.astype(np.float64), out.shape)
            out = np.where(np.isnan(out), nxt, out)
        return out
    if name == "clamp" and len(e.args) == 3:
        return np.clip(np.asarray(ev(e.args[0]), dtype=np.float64),
                       ev(e.args[1]), ev(e.args[2]))
    if name == "to_unixtime" and len(e.args) == 1:
        unit = _col_unit_nanos(e.args[0], schema) if schema else 10**6
        return np.asarray(ev(e.args[0])) * unit // 10**9
    if name == "date_format" and len(e.args) == 2:
        import datetime as _dt
        unit = _col_unit_nanos(e.args[0], schema) if schema else 10**6
        fmt = str(_lit(e.args[1]))
        vals = np.atleast_1d(np.asarray(ev(e.args[0]), dtype=np.int64))
        out = np.asarray([
            _dt.datetime.fromtimestamp(v * unit / 1e9, _dt.timezone.utc)
            .strftime(fmt) for v in vals.tolist()], dtype=object)
        return out
    if name == "version":
        return "8.0.0-greptimedb-tpu"
    if name == "build":
        from greptimedb_tpu_torch import __version__
        return f"greptimedb_tpu_torch {__version__} (PyTorch/CUDA backend)"
    if name in ("database", "current_schema", "schema"):
        return "public"  # overridden with session db in engine._select
    if name == "timezone":
        return "UTC"
    if name == "round":
        v = np.asarray(ev(e.args[0]), dtype=np.float64)
        d = int(_lit(e.args[1])) if len(e.args) > 1 else 0
        return np.round(v, d)
    if name in ("date_bin", "time_bucket"):
        interval, ts_expr = e.args[0], e.args[1]
        step = _interval_in_col_unit(interval, ts_expr, schema) if schema else _lit_interval(interval)
        ts = np.asarray(ev(ts_expr))
        return ts // step * step
    if name == "date_trunc":
        unit_lit, ts_expr = e.args[0], e.args[1]
        unit = str(_lit(unit_lit)).lower()
        nanos = _TRUNC_UNITS.get(unit)
        if nanos is None:
            raise PlanError(f"date_trunc unit {_lit(unit_lit)!r} unsupported")
        step = _scale_to_col_unit(nanos, ts_expr, schema) if schema else nanos
        ts = np.asarray(ev(ts_expr))
        shift = 0
        if unit == "week":
            # weeks start on Monday; epoch is a Thursday (device branch)
            shift_ns = 3 * 86400 * 10**9
            shift = (_scale_to_col_unit(shift_ns, ts_expr, schema)
                     if schema else shift_ns)
        return (ts + shift) // step * step - shift
    if name == "now":
        import time as _time
        return int(_time.time() * 1000)
    if name == "date_part":
        # date_part('year', ts) / EXTRACT(year FROM ts) — calendar field
        # extraction (reference: DataFusion date_part)
        import datetime as _dt
        unit = str(_lit(e.args[0])).lower()
        ts_expr = e.args[1]
        col_unit = _col_unit_nanos(ts_expr, schema) if schema else 10**6
        vals = np.atleast_1d(np.asarray(ev(ts_expr), dtype=np.int64))
        secs = vals * col_unit / 1e9
        getters = {
            "year": lambda d: d.year, "month": lambda d: d.month,
            "day": lambda d: d.day, "hour": lambda d: d.hour,
            "minute": lambda d: d.minute, "second": lambda d: d.second,
            "dow": lambda d: (d.weekday() + 1) % 7,  # Sunday = 0
            "doy": lambda d: d.timetuple().tm_yday,
            "week": lambda d: d.isocalendar()[1],
            "quarter": lambda d: (d.month - 1) // 3 + 1,
            "epoch": None,
        }
        if unit not in getters:
            raise PlanError(f"date_part unit {unit!r} unsupported")
        if unit == "epoch":
            return secs
        get = getters[unit]
        return np.asarray([
            get(_dt.datetime.fromtimestamp(s, _dt.timezone.utc))
            for s in secs.tolist()], dtype=np.int64)
    if name in _STRING_FUNCS:
        return _STRING_FUNCS[name](e, ev)
    # extension seam: plugin-registered scalar functions (resolved against
    # the executing engine's container, falling back to the process default)
    from greptimedb_tpu_torch.plugins import active_plugins
    plugin_fn = active_plugins().scalar_function(name)
    if plugin_fn is not None:
        return plugin_fn(*(ev(a) for a in e.args))
    raise PlanError(f"unsupported host function {name!r}")


def _obj_col(v) -> np.ndarray:
    return np.atleast_1d(np.asarray(v, dtype=object))


def _str_map(fn):
    """Element-wise NULL-preserving string transform."""
    def apply(e, ev):
        vals = _obj_col(ev(e.args[0]))
        return np.asarray(
            [None if v is None else fn(str(v)) for v in vals], dtype=object)
    return apply


def _fn_concat(e, ev):
    # DataFusion concat skips NULL arguments (the reference's behavior)
    cols = [_obj_col(ev(a)) for a in e.args]
    n = max(len(c) for c in cols)
    cols = [np.broadcast_to(c, (n,)) if len(c) != n else c for c in cols]
    return np.asarray(
        ["".join(str(c[i]) for c in cols if c[i] is not None)
         for i in range(n)], dtype=object)


def _fn_length(e, ev):
    vals = _obj_col(ev(e.args[0]))
    return np.asarray(
        [None if v is None else len(str(v)) for v in vals], dtype=object)


def _fn_substr(e, ev):
    vals = _obj_col(ev(e.args[0]))
    start = int(_lit(e.args[1]))
    ln = int(_lit(e.args[2])) if len(e.args) > 2 else None
    # SQL substr is 1-based and the length window anchors at the TRUE
    # start even when it is <= 0 (substr('alphabet', 0, 3) = 'al')
    i0 = max(start - 1, 0)
    i1 = None if ln is None else max(start - 1 + ln, 0)
    return np.asarray(
        [None if v is None else str(v)[i0:i1] for v in vals], dtype=object)


def _fn_replace(e, ev):
    vals = _obj_col(ev(e.args[0]))
    old, new = str(_lit(e.args[1])), str(_lit(e.args[2]))
    return np.asarray(
        [None if v is None else str(v).replace(old, new) for v in vals],
        dtype=object)


def _fn_affix(method):
    def apply(e, ev):
        vals = _obj_col(ev(e.args[0]))
        probe = str(_lit(e.args[1]))
        # NULL input stays NULL (three-valued logic), not FALSE
        return np.asarray(
            [None if v is None else getattr(str(v), method)(probe)
             for v in vals], dtype=object)
    return apply


#: string scalar functions (reference: DataFusion string fns used by the
#: sqlness suites — lower/upper/trim/length/concat/substr/replace/...)
_STRING_FUNCS = {
    "lower": _str_map(str.lower),
    "upper": _str_map(str.upper),
    "trim": _str_map(str.strip),
    "ltrim": _str_map(str.lstrip),
    "rtrim": _str_map(str.rstrip),
    "reverse": _str_map(lambda s: s[::-1]),
    "length": _fn_length,
    "char_length": _fn_length,
    "character_length": _fn_length,
    "concat": _fn_concat,
    "substr": _fn_substr,
    "substring": _fn_substr,
    "replace": _fn_replace,
    "starts_with": _fn_affix("startswith"),
    "ends_with": _fn_affix("endswith"),
}


def _lit_interval(e):
    return _interval_nanos(e)


def _np_bool(v):
    v = np.asarray(v)
    return v if v.dtype == bool else v != 0


def _str_eq(a, b):
    a_obj = isinstance(a, np.ndarray) and a.dtype == object
    b_obj = isinstance(b, np.ndarray) and b.dtype == object
    if a_obj or b_obj or isinstance(a, str) or isinstance(b, str):
        av = a.astype(str) if isinstance(a, np.ndarray) else str(a)
        bv = b.astype(str) if isinstance(b, np.ndarray) else str(b)
        return np.asarray(av == bv)
    return np.asarray(a == b)


def _scalar(v):
    arr = np.asarray(v)
    return arr.item() if arr.ndim == 0 else v


# ---- time-range extraction (scan pruning) ----------------------------------


def extract_ts_bounds(
    where: Optional[ast.Expr], ts_name: str, dtype: DataType
) -> Optional[tuple[Optional[int], Optional[int]]]:
    """Half-open [lo, hi) bounds on the time index from the conjunctive
    prefix of WHERE (the reference's scan_region time-predicate pruning,
    read/scan_region.rs:148)."""
    if where is None:
        return None
    lo: Optional[int] = None
    hi: Optional[int] = None

    def visit(e):
        nonlocal lo, hi
        if isinstance(e, ast.BinaryOp) and e.op == "and":
            visit(e.left)
            visit(e.right)
            return
        if isinstance(e, ast.BinaryOp) and e.op in ("=", "<", "<=", ">", ">="):
            side = None
            if isinstance(e.left, ast.Column) and e.left.name == ts_name and isinstance(e.right, ast.Literal):
                side = (e.op, e.right.value)
            elif isinstance(e.right, ast.Column) and e.right.name == ts_name and isinstance(e.left, ast.Literal):
                side = (_flip(e.op), e.left.value)
            if side is None:
                return
            op, raw = side
            try:
                v = coerce_ts_literal(raw, dtype)
            except (ValueError, TypeError):
                return
            if op == ">=":
                lo = v if lo is None else max(lo, v)
            elif op == ">":
                lo = v + 1 if lo is None else max(lo, v + 1)
            elif op == "<":
                hi = v if hi is None else min(hi, v)
            elif op == "<=":
                hi = v + 1 if hi is None else min(hi, v + 1)
            elif op == "=":
                lo = v if lo is None else max(lo, v)
                hi = v + 1 if hi is None else min(hi, v + 1)
        if isinstance(e, ast.Between) and not e.negated:
            if isinstance(e.expr, ast.Column) and e.expr.name == ts_name:
                try:
                    l = coerce_ts_literal(_lit(e.low), dtype)
                    h = coerce_ts_literal(_lit(e.high), dtype)
                except (ValueError, TypeError, PlanError):
                    return
                lo = l if lo is None else max(lo, l)
                hi = h + 1 if hi is None else min(hi, h + 1)

    visit(where)
    if lo is None and hi is None:
        return None
    return lo, hi


def collect_columns(e: Optional[ast.Expr], out: set[str]) -> set[str]:
    """All column names referenced by an expression."""
    if e is None:
        return out
    if isinstance(e, ast.Column):
        out.add(e.name)
    elif isinstance(e, ast.BinaryOp):
        collect_columns(e.left, out)
        collect_columns(e.right, out)
    elif isinstance(e, ast.UnaryOp):
        collect_columns(e.operand, out)
    elif isinstance(e, ast.Between):
        for x in (e.expr, e.low, e.high):
            collect_columns(x, out)
    elif isinstance(e, ast.InList):
        collect_columns(e.expr, out)
        for i in e.items:
            collect_columns(i, out)
    elif isinstance(e, ast.IsNull):
        collect_columns(e.expr, out)
    elif isinstance(e, ast.FuncCall):
        for a in e.args:
            collect_columns(a, out)
    elif isinstance(e, ast.Cast):
        collect_columns(e.expr, out)
    elif isinstance(e, ast.Case):
        if e.operand:
            collect_columns(e.operand, out)
        for c, v in e.whens:
            collect_columns(c, out)
            collect_columns(v, out)
        if e.else_:
            collect_columns(e.else_, out)
    return out


def has_aggregate(e: Optional[ast.Expr]) -> bool:
    if e is None:
        return False
    if isinstance(e, ast.FuncCall):
        if e.name in AGG_FUNCS:
            return True
        return any(has_aggregate(a) for a in e.args)
    if isinstance(e, ast.BinaryOp):
        return has_aggregate(e.left) or has_aggregate(e.right)
    if isinstance(e, ast.UnaryOp):
        return has_aggregate(e.operand)
    if isinstance(e, ast.Between):
        return any(has_aggregate(x) for x in (e.expr, e.low, e.high))
    if isinstance(e, ast.InList):
        return has_aggregate(e.expr) or any(has_aggregate(i) for i in e.items)
    if isinstance(e, ast.IsNull):
        return has_aggregate(e.expr)
    if isinstance(e, ast.Cast):
        return has_aggregate(e.expr)
    if isinstance(e, ast.Case):
        parts = [e.operand, e.else_] + [x for w in e.whens for x in w]
        return any(has_aggregate(p) for p in parts if p is not None)
    return False


def collect_aggregates(e: Optional[ast.Expr], out: list) -> list:
    """All aggregate FuncCall nodes in an expression (deduplicated)."""
    if e is None:
        return out
    if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS:
        if e not in out:
            out.append(e)
        return out
    if isinstance(e, ast.FuncCall):
        for a in e.args:
            collect_aggregates(a, out)
    elif isinstance(e, ast.BinaryOp):
        collect_aggregates(e.left, out)
        collect_aggregates(e.right, out)
    elif isinstance(e, ast.UnaryOp):
        collect_aggregates(e.operand, out)
    elif isinstance(e, ast.Between):
        for x in (e.expr, e.low, e.high):
            collect_aggregates(x, out)
    elif isinstance(e, ast.Case):
        for w in e.whens:
            collect_aggregates(w[0], out)
            collect_aggregates(w[1], out)
        if e.operand:
            collect_aggregates(e.operand, out)
        if e.else_:
            collect_aggregates(e.else_, out)
    elif isinstance(e, ast.Cast):
        collect_aggregates(e.expr, out)
    elif isinstance(e, ast.InList):
        collect_aggregates(e.expr, out)
    elif isinstance(e, ast.IsNull):
        collect_aggregates(e.expr, out)
    return out


AGG_FUNCS = {
    "count", "sum", "avg", "mean", "min", "max", "first", "last",
    "last_value", "first_value", "stddev", "variance",
    "argmax", "argmin", "median", "percentile", "approx_percentile_cont",
    "polyval",
}


def _holds_null(v) -> bool:
    return isinstance(v, np.ndarray) and v.dtype == object \
        and any(x is None for x in v.ravel())


def _null_arith(op: str, a, b):
    """`a op b` where an operand is an object column holding SQL NULL as
    None (a window's lag/lead column): NULL in, NULL out, as `x + NULL`
    gives. The JAX package raises a TypeError here instead (ROADMAP C)."""

    def split(v):
        arr = np.asarray(v)
        if arr.dtype != object:
            return arr, np.zeros(arr.shape, dtype=bool)
        flat = arr.ravel()
        null = np.asarray([x is None for x in flat], dtype=bool)
        vals = np.asarray([0 if x is None else x for x in flat])
        return vals.reshape(arr.shape), null.reshape(arr.shape)

    av, a_null = split(a)
    bv, b_null = split(b)
    if op == "/":
        res = av // bv if np.issubdtype(np.result_type(av, bv),
                                        np.integer) else av / bv
    else:
        res = {"+": np.add, "-": np.subtract, "*": np.multiply,
               "%": np.mod}[op](av, bv)
    out = np.asarray(res).astype(object)
    out[np.broadcast_to(a_null | b_null, out.shape)] = None
    return out


def split_conjuncts(where) -> list:
    """The AND-conjunction atoms of a WHERE clause (None -> [])."""
    if where is None:
        return []
    if isinstance(where, ast.BinaryOp) and where.op == "and":
        return split_conjuncts(where.left) + split_conjuncts(where.right)
    return [where]
