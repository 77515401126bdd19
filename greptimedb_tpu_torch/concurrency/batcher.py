"""Cross-query batching: one device dispatch for a window of queries
(copy of greptimedb_tpu/concurrency/batcher.py).

Under fleet-scale dashboard traffic the engine would serialize 50
concurrent single-groupby queries into 50 kernel launches over the same
resident blocks. The batcher opens a short collection window when the
server is busy, groups admitted SELECTs by shape, and serves a group
with less work than member-by-member execution:

- **coalescing**: members whose statements are identical (same shape,
  same parameters, same db/timezone) share ONE execution — the common
  case for dashboard fan-out.
- **vmapped dispatch**: members identical except for the values of
  *parameter conjuncts* — tag equalities (one or several: multi-tag
  selectors stack) and time-index comparisons (different windows stack
  via one scan covering the union, per-member masks) — execute as ONE
  K2 launch over a stacked member axis (query/vmapped.py): each
  member's (member, group) cells are segments of one reduction.
- **stacked dispatch** (fallback): when the vmapped path declines (a
  scan part spanning several device blocks, host aggregates) and the
  members differ in a single tag equality, the group rewrites into one
  combined query — the selector tag becomes the leading group key and
  the predicate becomes `host IN (v1..vN)` — and demultiplexes the
  combined result.

Only aggregate shapes whose masked evaluation is the serial evaluation
batch (plain sum/count/min/max/avg/first/last over columns, non-empty
GROUP BY, a conjunctive WHERE); everything else falls back to
coalescing or per-member serial execution inside the same admission
slot. The collection window only opens when other queries are in
flight — an idle client never pays it.

The JAX batcher latches its vmapped path off after one unexpected
dispatch failure (`_vmap_failed`). The port has no such latch: on the
card it would be a fallback that hides the kernel, so a failing vmapped
dispatch raises into the statement like every other K2 failure. The
typed turns stay: `VmapIneligible`, `Unavailable` / `FaultError`, and
the statement-scoped errors of `_statement_errors()` are decisions about
the plan, not failures of the kernel. A leader's failure reaches only
the members that share its statement; a member with other parameters
then runs its own (a bad literal fails its own statement only).

Batched results carry a shared `encode_memo` dict so the result encoder
materializes the (identical) wire rows once per group, not once per
member.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.fault import Cancelled, DeadlineExceeded
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.utils import deadline as dl
from greptimedb_tpu_torch.utils.metrics import (
    QUERY_BATCH_EVENTS,
    QUERY_BATCH_SIZE,
    VMAP_BATCH_WIDTH,
)

#: aggregate functions whose masked/stacked evaluation is exactly the
#: serial evaluation (order-insensitive, or identity-element exact;
#: first/last resolve by their companion timestamps in the vmapped
#: kernel and by ordinary serial evaluation in the IN-list rewrite)
SAFE_FUNCS = frozenset(
    {"sum", "count", "min", "max", "avg", "mean", "first", "last"})

BATCH_TAG = "__batch_tag"

#: time-index comparison operators that can become stacked parameters
_TS_PARAM_OPS = frozenset({"=", "<", "<=", ">", ">="})


def _replace_node(e, target, repl):
    """Rebuild `e` with the node `target` (by identity) replaced."""
    if e is target:
        return repl
    if isinstance(e, (list, tuple)):
        return type(e)(_replace_node(x, target, repl) for x in e)
    if dataclasses.is_dataclass(e) and not isinstance(e, type) \
            and not isinstance(e, ast.Statement):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)) or (
                    dataclasses.is_dataclass(v)
                    and not isinstance(v, (type, ast.Statement))):
                nv = _replace_node(v, target, repl)
                if nv is not v:
                    changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e
    return e


def _conjuncts(e) -> list:
    from greptimedb_tpu_torch.query.expr import split_conjuncts

    return split_conjuncts(e)


def _statement_errors() -> tuple:
    """Error classes that belong to ONE statement (plan validation,
    catalog lookups, a literal that does not parse, such as a bad
    timestamp): the member's own serial run surfaces the same error, so
    the group turns to the fallbacks."""
    from greptimedb_tpu_torch.catalog.catalog import CatalogError
    from greptimedb_tpu_torch.query.expr import PlanError

    return (PlanError, CatalogError, ValueError)


class BatchParam:
    """One parameter conjunct of a stack-eligible SELECT: the conjunct
    node (by identity, inside the statement's WHERE), the column it
    constrains, its kind ("tag" equality | "ts" comparison), and the
    normalized operator (column on the left)."""

    __slots__ = ("conjunct", "col", "kind", "op")

    def __init__(self, conjunct, col, kind, op):
        self.conjunct = conjunct
        self.col = col
        self.kind = kind
        self.op = op


class BatchShape:
    """Analysis of one batch-eligible SELECT: its parameter conjuncts,
    this statement's parameter values, and the statement with the
    parameter literals masked (the group key — members share it iff
    they differ ONLY in parameter values)."""

    __slots__ = ("params", "values", "masked")

    def __init__(self, params, values, masked):
        self.params = params  # tuple[BatchParam]
        self.values = values  # tuple of this statement's literal values
        self.masked = masked


def analyze(sel: ast.Select, info) -> Optional[BatchShape]:
    """None when the statement can't join a parameterized group (it may
    still coalesce with byte-identical statements)."""
    if (sel.joins or sel.ctes or sel.from_subquery is not None
            or sel.distinct or sel.having is not None or sel.order_by
            or sel.limit is not None or sel.offset
            or sel.align is not None or not sel.group_by
            or sel.where is None):
        return None
    from greptimedb_tpu_torch.query import range_select as rs
    from greptimedb_tpu_torch.query.expr import (
        _flip,
        collect_columns,
        has_aggregate,
    )
    from greptimedb_tpu_torch.query.planner import _FUNC_CANON
    from greptimedb_tpu_torch.query.window import select_has_window

    if rs.is_range_select(sel) or select_has_window(sel):
        return None
    n_aggs = 0
    for it in sel.items:
        e = it.expr
        if isinstance(e, ast.Star):
            return None
        if not has_aggregate(e):
            continue  # a group key expression: shared across members
        if not isinstance(e, ast.FuncCall) or e.distinct \
                or e.order_within is not None:
            return None
        func = _FUNC_CANON.get(e.name)
        if func not in SAFE_FUNCS:
            return None
        if len(e.args) == 1 and isinstance(e.args[0], ast.Star):
            if func != "count":
                return None
        elif len(e.args) != 1 or not isinstance(e.args[0], ast.Column):
            return None
        n_aggs += 1
    if n_aggs == 0:
        return None
    schema = info.schema
    tag_names = {c.name for c in schema.tag_columns}
    ts_name = schema.time_index.name
    # a selector tag must not feed the output relation: a tag that is
    # also a group key / projected column changes shape when batched.
    # (The time index IS typically a group key via date_bin — that's
    # fine: window parameters only mask rows, the bucket key decodes by
    # value.)
    used: set = set()
    for it in sel.items:
        collect_columns(it.expr, used)
    for g in sel.group_by:
        collect_columns(g, used)

    params: list[BatchParam] = []
    values: list = []
    for c in _conjuncts(sel.where):
        if not isinstance(c, ast.BinaryOp):
            continue
        col, lit, flipped = c.left, c.right, False
        if isinstance(col, ast.Literal) and isinstance(lit, ast.Column):
            col, lit, flipped = lit, col, True
        if not (isinstance(col, ast.Column) and isinstance(lit, ast.Literal)):
            continue
        if col.table not in (None, sel.table, sel.table_alias):
            continue
        op = _flip(c.op) if flipped else c.op
        if (op == "=" and col.name in tag_names
                and col.name not in used
                and isinstance(lit.value, str)):
            params.append(BatchParam(c, col.name, "tag", "="))
            values.append(lit.value)
        elif (op in _TS_PARAM_OPS and col.name == ts_name
                and isinstance(lit.value, (int, float, str))
                and not isinstance(lit.value, bool)):
            params.append(BatchParam(c, col.name, "ts", op))
            values.append(lit.value)
    if not params:
        return None
    masked_where = sel.where
    for i, p in enumerate(params):
        marker = ast.BinaryOp(p.op, ast.Column(p.col),
                              ast.Literal(("__gtpu_batch_param__", i)))
        masked_where = _replace_node(masked_where, p.conjunct, marker)
    masked = repr(dataclasses.replace(sel, where=masked_where))
    return BatchShape(tuple(params), tuple(values), masked)


def combined_select(base: ast.Select, shape: BatchShape,
                    values: list[str],
                    param: BatchParam) -> ast.Select:
    """The legacy stacked rewrite (single varying tag parameter):
    selector eq -> IN over every member value, selector tag prepended
    as the leading group key (leading so each member's groups come back
    as one contiguous, serial-ordered run) and appended to the
    projection for demux. `param` names the one VARYING tag parameter —
    the caller determines it, defaulting would silently rewrite the
    wrong conjunct on multi-param shapes."""
    p = param
    tagcol = ast.Column(p.col)
    in_list = ast.InList(tagcol, tuple(ast.Literal(v) for v in values))
    new_where = _replace_node(base.where, p.conjunct, in_list)
    items = list(base.items) + [ast.SelectItem(tagcol, alias=BATCH_TAG)]
    group_by = [tagcol] + list(base.group_by)
    return dataclasses.replace(base, items=items, group_by=group_by,
                               where=new_where)


def demux(combined: QueryResult, value: str) -> QueryResult:
    """One member's slice of the combined result, BATCH_TAG dropped.
    combined_select APPENDS its tag column, so the demux key is the
    LAST occurrence — a user column aliased __batch_tag sits earlier
    and must come back in the member's result, not be used as the key."""
    tag_idx = (len(combined.names) - 1
               - combined.names[::-1].index(BATCH_TAG))
    tagcol = np.asarray(combined.columns[tag_idx])
    idx = np.flatnonzero(tagcol == value)
    keep = [i for i in range(len(combined.names)) if i != tag_idx]
    return QueryResult(
        [combined.names[i] for i in keep],
        [combined.dtypes[i] for i in keep],
        [np.asarray(combined.columns[i])[idx] for i in keep])


#: by_value sentinel: this member executes its own statement on its own
#: thread (the group could not be served batched, and leader-serial
#: execution would park N-1 admitted threads behind one — pre-batching
#: traffic ran these queries in parallel and still must)
SELF_EXECUTE = object()


class _Relay:
    """Fallback coalescing for one distinct non-leader value: the first
    member with the value executes and publishes here; its duplicates
    wait on it instead of re-running the same query."""

    __slots__ = ("event", "result", "error", "path")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.path = None


class _Member:
    __slots__ = ("event", "result", "error", "path", "value", "sel",
                 "self_execute", "relay", "wait_relay", "abandoned")

    def __init__(self, value, sel):
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.path = None
        self.value = value
        self.sel = sel
        self.self_execute = False
        self.relay = None       # publish my self-execution here
        self.wait_relay = None  # ride another member's self-execution
        self.abandoned = False  # deadline/cancel drop-out (no relay duty)


class _Group:
    __slots__ = ("members", "closed", "shape", "sel", "value")

    def __init__(self, sel, shape):
        self.members: list[_Member] = []
        self.closed = False
        self.shape = shape
        self.sel = sel
        self.value = shape.values if shape is not None else None


def _copy(r: QueryResult, memo: Optional[dict] = None) -> QueryResult:
    # column arrays shared (read-only downstream); the container is
    # per-caller so one member's post-processing can't surprise another.
    # `memo` is the group-shared encode cache: every copy of one
    # execution's result points at the same dict, so the HTTP/MySQL
    # encoders materialize the wire rows once per group.
    out = QueryResult(list(r.names), list(r.dtypes), list(r.columns))
    if memo is not None:
        out.encode_memo = memo
    return out


class QueryBatcher:
    def __init__(self, window_s: float = 0.002, max_queries: int = 64,
                 max_rows: int = 4 << 20, enabled: bool = True,
                 vmap: bool = True):
        self.window_s = window_s
        self.max_queries = max_queries
        self.max_rows = max_rows
        self.enabled = enabled
        self.vmap = vmap
        self._lock = threading.Lock()
        self._open: dict[tuple, _Group] = {}

    # ---- entry -------------------------------------------------------------

    def execute(self, qe, sel: ast.Select, info, ctx, busy: bool) -> QueryResult:
        """Join or lead a batch group for `sel`. `busy` gates the
        collection window: an idle server executes immediately."""
        if not busy and not self._open:
            # idle server with no leader collecting: no group could be
            # joined or led, so skip the analyze/repr bookkeeping
            # entirely (single-client traffic must not pay batching
            # overhead on the parse/plan hot path). Racy read on
            # purpose: a group opening concurrently only costs a missed
            # join, never correctness.
            return qe._select_table(sel, info, ctx)
        shape = analyze(sel, info)
        gkey = (info.db, info.table_id, ctx.timezone,
                shape.masked if shape is not None else repr(sel))
        with self._lock:
            g = self._open.get(gkey)
            if g is not None and not g.closed \
                    and len(g.members) < self.max_queries:
                m = _Member(shape.values if shape is not None else None,
                            sel)
                g.members.append(m)
                QUERY_BATCH_EVENTS.inc(event="join")
                joined = True
            else:
                g = _Group(sel, shape)
                self._open[gkey] = g
                joined = False
        if joined:
            return self._await(qe, m, info, ctx)
        interrupted = None
        try:
            if busy and self.window_s > 0:
                # deadline-aware: an expired leader aborts the window
                # instead of burning its last budget collecting
                dl.sleep(self.window_s, "batch window")
        except BaseException as e:  # noqa: BLE001 — members must not hang
            interrupted = e
        finally:
            with self._lock:
                g.closed = True
                if self._open.get(gkey) is g:
                    del self._open[gkey]
        if interrupted is not None:
            typed = isinstance(interrupted, (DeadlineExceeded, Cancelled))
            for m in g.members:
                if typed:
                    # the leader's own deadline/cancel: members
                    # re-execute for themselves (see _lead)
                    m.self_execute = True
                else:
                    m.error = interrupted
                m.event.set()
            raise interrupted
        return self._lead(qe, g, info, ctx)

    def _await(self, qe, m: _Member, info, ctx) -> QueryResult:
        # wait as long as the leader runs: its execution IS this
        # member's execution, so a slow leader means a slow query, not
        # an overload (the leader sets every member's event in a
        # finally on ALL exit paths — see execute()/_lead). The
        # periodic wakeup exists only so a wedged process shows a live
        # thread doing something diagnosable instead of parking forever.
        try:
            while not dl.wait_event(m.event, 30.0, where="batch member"):
                pass
        except (DeadlineExceeded, Cancelled):
            # drop out of the group: the leader continues for everyone
            # else. The abandon is claimed under the batcher lock so it
            # is atomic against the leader's relay assignment — a
            # member the leader already tasked with relay duty (event
            # set) must stay and serve it: its execution unwinds typed
            # below and publishes the error, and duplicates recover by
            # self-executing.
            with self._lock:
                if not m.event.is_set():
                    m.abandoned = True
                    raise
            if not m.self_execute:
                raise
        if m.error is not None:
            raise m.error
        if m.self_execute:
            # the group fell back without a batched execution for this
            # member's parameters: run it here, in parallel with the
            # other members, exactly as un-batched traffic would —
            # publishing to the relay so duplicates don't re-run it
            try:
                res = qe._select_table(m.sel, info, ctx)
            except BaseException as e:
                if m.relay is not None:
                    m.relay.error = e
                    m.relay.event.set()
                raise
            if m.relay is not None:
                res.encode_memo = {}
                m.relay.result = res
                m.relay.path = qe.executor.last_path
                m.relay.event.set()
                return _copy(res, res.encode_memo)
            return res
        if m.wait_relay is not None:
            r = m.wait_relay
            while not dl.wait_event(r.event, 30.0, where="batch relay"):
                pass
            if r.error is not None:
                if isinstance(r.error, (DeadlineExceeded, Cancelled)):
                    # the relay executor hit ITS deadline/cancel, not
                    # ours (our own token raised from the wait above):
                    # serve this member's statement directly
                    return qe._select_table(m.sel, info, ctx)
                raise r.error
            qe.executor.last_path = r.path
            return _copy(r.result, r.result.encode_memo)
        qe.executor.last_path = m.path
        return _copy(m.result, getattr(m.result, "encode_memo", None))

    # ---- leader ------------------------------------------------------------

    def _lead(self, qe, g: _Group, info, ctx) -> QueryResult:
        run = lambda s: qe._select_table(s, info, ctx)  # noqa: E731
        if not g.members:
            return run(g.sel)
        QUERY_BATCH_SIZE.observe(float(1 + len(g.members)))
        try:
            by_value: dict = {}
            if g.shape is None:
                # every member is statement-identical: one execution
                res = run(g.sel)
                res.encode_memo = {}
                path = qe.executor.last_path
                QUERY_BATCH_EVENTS.inc(float(len(g.members)),
                                       event="coalesced")
                for m in g.members:
                    m.result, m.path = res, path
                    m.event.set()
                return _copy(res, res.encode_memo)
            order: list = [g.value]
            for m in g.members:
                if m.value not in order:
                    order.append(m.value)
            if len(order) == 1:
                res = run(g.sel)
                path = qe.executor.last_path
                by_value[g.value] = (res, path)
                QUERY_BATCH_EVENTS.inc(float(len(g.members)),
                                       event="coalesced")
            else:
                by_value = self._execute_group(qe, g, info, ctx, order,
                                               run)
            for v, entry in by_value.items():
                if entry is not SELF_EXECUTE:
                    entry[0].encode_memo = {}
            relays: dict = {}
            # assignment runs under the batcher lock so it is atomic
            # against a member abandoning on deadline/cancel: an
            # abandoned member never receives relay duty, and a member
            # that sees its event set always serves the duty it got
            with self._lock:
                for m in g.members:
                    entry = by_value[m.value]
                    if entry is SELF_EXECUTE:
                        r = relays.get(m.value)
                        if r is None and not m.abandoned:
                            # first live member with this value executes
                            # for all its duplicates (one execution per
                            # distinct value, like the old leader-serial
                            # fallback — but in parallel across values)
                            relays[m.value] = m.relay = _Relay()
                            m.self_execute = True
                        elif r is not None:
                            m.wait_relay = r
                    else:
                        m.result, m.path = entry
                    m.event.set()
            res, path = by_value[g.value]  # the leader always executes
            qe.executor.last_path = path
            return _copy(res, res.encode_memo)
        except (DeadlineExceeded, Cancelled):
            # the LEADER's deadline/cancel must not fail the other
            # members (their deadlines are their own): every unserved
            # member re-executes its statement on its own thread
            with self._lock:
                for m in g.members:
                    if not m.event.is_set():
                        m.self_execute = True
                        m.event.set()
            raise
        except BaseException as e:
            # the leader's failure is the error of the leader's own
            # statement: members coalesced onto it share it, a member
            # with other parameters runs its own statement
            with self._lock:
                for m in g.members:
                    if m.event.is_set():
                        continue
                    if g.shape is not None and m.value != g.value:
                        m.self_execute = True
                    else:
                        m.error = e
                    m.event.set()
            raise

    def _execute_group(self, qe, g: _Group, info, ctx, order, run) -> dict:
        """Execute one multi-member group: vmapped stacked axis first,
        the legacy IN-list rewrite for single-tag shapes it declines,
        serial per distinct member as the last resort."""
        by_value: dict = {}
        shape = g.shape
        if self.vmap and self._stack_ok(qe, info):
            from greptimedb_tpu_torch.fault import FaultError, Unavailable
            from greptimedb_tpu_torch.query.vmapped import (
                VmapIneligible,
                run_vmapped,
            )

            try:
                results = run_vmapped(qe.executor, g.sel, info,
                                      shape.params, order)
            except VmapIneligible:
                pass
            except (Unavailable, FaultError):
                # typed, transient (region unavailable, an injected
                # fault): the fallbacks reproduce the real per-member
                # error or ride a retry
                pass
            except _statement_errors():
                # statement-scoped (a DDL race invalidating the plan, a
                # bad literal): the member's own serial run surfaces the
                # same error. Any other failure (a K2 launch on the
                # card) raises into the statement: no latch, no fallback
                pass
            else:
                path = qe.executor.last_path or "dense_vmapped"
                for v, res in zip(order, results):
                    by_value[v] = (res, path)
                QUERY_BATCH_EVENTS.inc(float(len(order)), event="vmapped")
                VMAP_BATCH_WIDTH.observe(float(len(order)))
                return by_value
        # IN-list rewrite fallback: only one parameter actually varies
        # across the members and it is a tag equality (the constant
        # window/tag conjuncts stay literal in the leader's statement)
        varying = [j for j in range(len(shape.params))
                   if len({v[j] for v in order}) > 1]
        single_tag = (len(varying) == 1
                      and shape.params[varying[0]].kind == "tag")
        if single_tag and self._stack_ok(qe, info):
            j = varying[0]
            vals = sorted({v[j] for v in order})
            combined = combined_select(g.sel, shape, vals,
                                       param=shape.params[j])
            full = run(combined)
            path = (qe.executor.last_path or "") + "+stacked"
            for v in order:
                by_value[v] = (demux(full, v[j]), path)
            QUERY_BATCH_EVENTS.inc(float(len(order)), event="stacked")
            return by_value
        # vmapped declined and the IN-list rewrite doesn't cover the
        # shape (or the scan is too big to stack safely): the leader
        # executes ITS statement (members sharing its parameters still
        # coalesce onto it); everyone else self-executes on their own
        # thread — pre-batching traffic ran these distinct queries in
        # parallel, and a leader-serial loop would park N-1 admitted
        # threads behind one
        by_value[g.value] = (run(g.sel), qe.executor.last_path)
        for v in order:
            if v != g.value:
                by_value[v] = SELF_EXECUTE
        QUERY_BATCH_EVENTS.inc(float(len(order)), event="serial_fallback")
        return by_value

    def _stack_ok(self, qe, info) -> bool:
        """Stacked parity needs the whole scan in one kernel dispatch:
        estimate rows from region metadata (SST rows, plus the
        memtable's bytes over 64); an engine that cannot say stacks only
        when no bound is configured."""
        if self.max_rows <= 0:
            return True
        est = 0
        for rid in info.region_ids:
            try:
                region = qe.region_engine.region(rid)
            except Exception:  # noqa: BLE001 — remote/unrouted region
                return False
            num = getattr(region, "num_sst_rows", None)
            if num is None:
                return False
            est += int(num)
            mem = getattr(region, "memtable", None)
            if mem is not None:
                est += int(getattr(mem, "bytes_estimate", 0) // 64)
        return est <= self.max_rows
