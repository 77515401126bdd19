"""QueryEngine of the port (lean counterpart of
greptimedb_tpu/query/engine.py).

SQL text -> statements over the durable region engine, under a
QueryContext (session/): CREATE TABLE / DATABASE / VIEW, INSERT ...
VALUES and INSERT ... SELECT, SELECT, UNION [ALL], DELETE, DROP and
TRUNCATE TABLE, DROP VIEW, ALTER TABLE ADD/DROP COLUMN, USE, SET,
SHOW TABLES / DATABASES / VIEWS / CREATE TABLE, DESCRIBE, EXPLAIN and
EXPLAIN ANALYZE, ADMIN flush_table / compact_table / rollup_table /
expire_table / maintenance_status (job ids from the engine's maintenance
plane, or synchronous flushes and compactions when the plane is off),
TQL EVAL / EXPLAIN / ANALYZE (PromQL, promql/engine.py) and KILL QUERY.

The observability plane (utils/): each statement runs in a
`stmt:<Type>` span whose attrs carry its slice of the request's resource
ledger and the roofline fold, under the slow-query watch; EXPLAIN
ANALYZE and TQL ANALYZE run the statement under a fresh trace id and
ledger and print the span tree, the ledger and the roofline line.

A top-level `execute_sql` runs under one deadline and cancel token
(utils/deadline.py) registered in the running-queries table. Every
statement text first meets the concurrency plane's parse-free fast lane
(concurrency/fast_lane.py): a known template binds and executes its
cached plan; anything else takes `_execute_sql_slow`, which parses and
runs each statement inside one admission slot, after the permission
check (auth/). A table SELECT goes through the plane's batcher, which
lands back in `_select_table` (straight away when the server is idle),
and there through the shape-keyed plan cache (concurrency/plan_cache.py)
around the planner. DDL evicts the table's plan shapes and templates.

SELECT follows the JAX engine's order: CTEs run once into virtual
relations, uncorrelated subqueries fold to literals, then a derived
table, a CTE relation, joins (query/join.py), information_schema
(catalog/information_schema.py), views (inlined into one table query
when simple), literal SELECTs, and last the table path: window
functions over the device aggregate or the device scan
(query/window.py), RANGE ... ALIGN (query/range_select.py), rollup
substitution (maintenance/rollup.py: an eligible coarse-bucket aggregate
served from the companion region's plane rows, `last_path` ending in
`+rollup`; GTPU_ROLLUP_SUBSTITUTE=0 turns it off), or the copied planner
and the torch physical layer on the engine's device. DROP and TRUNCATE
take a table's rollup companions down with it.
Everything around those device calls runs on the host over numpy.
Regions open lazily from the catalog on first use, so a persisted
catalog and a reopened storage engine serve the tables they held.
CREATE TABLE … ENGINE = metric makes a logical table over the database's
shared physical region (storage/metric_engine.py) and CREATE EXTERNAL
TABLE a read-only table over a CSV, ndjson, Parquet or ORC file
(storage/file_engine.py); both engines are built eagerly and register
openers, so their tables reopen after a restart. CREATE FLOW / DROP
FLOW / SHOW FLOWS and ADMIN flush_flow drive the flow engine
(flow/engine.py); its incremental ticks reduce new rows with one K2
call a region. The plugin container (plugins.py) runs its SQL
interceptors once a statement, before parsing (here or in the fast
lane, which tells this path it already ran them), and its scalar
functions resolve in expressions while a statement of this engine runs.
COPY TABLE / COPY DATABASE write and read CSV, ndjson, Parquet and
ORC files (datasource/, each format written by hand).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from greptimedb_tpu_torch import config
from greptimedb_tpu_torch.catalog import information_schema as infoschema
from greptimedb_tpu_torch.catalog.catalog import (
    Catalog,
    CatalogError,
    TableInfo,
)
from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import (
    DataType,
    SemanticType,
    parse_sql_type,
)
from greptimedb_tpu_torch.datatypes.vector import DictVector
from greptimedb_tpu_torch.fault import Cancelled, DeadlineExceeded
from greptimedb_tpu_torch.query import logical as lp
from greptimedb_tpu_torch.query import range_select as rs
from greptimedb_tpu_torch.query.expr import (
    PlanError,
    _like_to_regex,
    coerce_ts_literal,
    current_session_tz,
    eval_host,
    extract_ts_bounds,
    has_aggregate,
    reset_session_tz,
    set_session_tz,
)
from greptimedb_tpu_torch.query.join import (
    _columns_in,
    execute_join_select,
    execute_select_over,
    split_groupby_window,
)
from greptimedb_tpu_torch.query.physical import PhysicalExecutor
from greptimedb_tpu_torch.query.planner import _default_name, plan_select
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.query.window import select_has_window
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import ast, parse_sql
from greptimedb_tpu_torch.storage.engine import RegionEngine
from greptimedb_tpu_torch.storage.file_engine import FileEngine
from greptimedb_tpu_torch.storage.metric_engine import MetricEngine
from greptimedb_tpu_torch.utils import deadline as dl
from greptimedb_tpu_torch.utils import ledger, roofline, slow_query, tracing
from greptimedb_tpu_torch.utils import time as ts_util
from greptimedb_tpu_torch.utils.metrics import (
    PLAN_CACHE_EVENTS,
    QUERY_ACHIEVED_GBPS,
    STAGE_SECONDS,
    STMT_DURATION,
)


class UnsupportedStatement(PlanError):
    """A statement the JAX engine runs that this slice of the port does
    not; the message names the slice that brings it."""


class QueryEngine:
    def __init__(self, catalog: Catalog, region_engine: RegionEngine,
                 device=None, concurrency=None,
                 default_timezone: str = "UTC", plugins=None):
        from greptimedb_tpu_torch.auth import PermissionChecker
        from greptimedb_tpu_torch.concurrency import ConcurrencyPlane
        from greptimedb_tpu_torch.plugins import default_plugins

        self.catalog = catalog
        self.region_engine = region_engine
        # the session timezone of a context that sets none
        # (the `default_timezone` option)
        self.default_timezone = default_timezone
        self.permission_checker = PermissionChecker()
        self.plugins = plugins if plugins is not None else default_plugins()
        self.device = config.device(device)
        # the roofline accountant reads this device's peak
        roofline.note_device(self.device)
        self.executor = PhysicalExecutor(region_engine, self.device)
        # frontend concurrency plane (concurrency/): the fast lane, the
        # plan cache, admission control and cross-query batching; every
        # statement routes through it (pass concurrency= to inject a
        # tuned one)
        self.concurrency = concurrency if concurrency is not None \
            else ConcurrencyPlane()
        # per-thread statement-scope flags (plan-cache skip noted once
        # per top-level statement)
        self._skip_tls = threading.local()
        self._stmt_cache: "OrderedDict[str, list]" = OrderedDict()
        self._stmt_cache_lock = threading.Lock()
        # the write protocols' auto-create of a new table (ingest.py)
        self._auto_create_lock = threading.Lock()
        # regions this frontend opened through a router (the cluster's
        # RegionRouter has no local region map to consult)
        self._open_regions: set[int] = set()
        # eager: both engines register openers, so their tables reopen
        # after a restart; a cluster frontend's router has none
        self.metric_engine = self.file_engine = None
        if hasattr(region_engine, "register_opener"):
            self.metric_engine = MetricEngine(region_engine, catalog.kv)
            self.file_engine = FileEngine(region_engine, catalog.kv)

    # ---- entry points ------------------------------------------------------

    def execute_sql(self, sql: str, ctx: Optional[QueryContext] = None, *,
                    db: Optional[str] = None) -> list[QueryResult]:
        """Run every statement of `sql`. `ctx` carries the session (USE
        and SET persist in it); `db=` is a shorthand for a fresh context
        on that database. A top-level call runs under one CancelToken
        registered in the running-queries table (KILL QUERY, DELETE
        /v1/queries/<id>), its deadline from `_resolve_timeout_ms`."""
        if ctx is None:
            ctx = QueryContext() if db is None else QueryContext(db=db)
        if ctx.timezone is None:
            ctx.timezone = self.default_timezone
        if dl.current() is not None:
            # nested statement (a batch member re-entering, a caller
            # already under a token) rides the outer statement's token —
            # a fresh one would let inner work outlive the outer kill
            if ctx.cancel_token is None:
                ctx.cancel_token = dl.current()
            return self._dispatch_lane(sql, ctx)
        token = ctx.cancel_token  # servers pre-create for disconnect
        created = token is None
        if created:
            token = dl.CancelToken()
            ctx.cancel_token = token
        token.set_timeout(self._resolve_timeout_ms(ctx))
        qid = dl.RUNNING.register(
            token, sql, db=ctx.db,
            channel=getattr(ctx.channel, "value", str(ctx.channel)),
            tenant=ctx.tenant or "", trace_id=ctx.trace_id or "")
        try:
            with dl.activate(token):
                return self._dispatch_lane(sql, ctx)
        finally:
            dl.RUNNING.unregister(qid)
            if created:
                ctx.cancel_token = None

    def _dispatch_lane(self, sql: str, ctx: QueryContext) -> list[QueryResult]:
        # parse-free fast lane: a known statement template executes its
        # cached bound plan with zero parse/AST/planning; everything
        # else (and every first sighting) takes _execute_sql_slow below
        fl = self.concurrency.fast_lane
        if fl.enabled:
            return fl.execute(self, sql, ctx)
        return self._execute_sql_slow(sql, ctx)

    def _resolve_timeout_ms(self, ctx: QueryContext):
        """Deadline precedence: explicit client timeout (header) >
        session vars (MySQL max_execution_time / PG statement_timeout,
        landed in ctx.extensions via SET) > GTPU_QUERY_DEFAULT_TIMEOUT_MS;
        0/absent everywhere = unbounded."""
        if ctx.timeout_ms is not None and ctx.timeout_ms > 0:
            return float(ctx.timeout_ms)
        for var in ("max_execution_time", "statement_timeout"):
            t = dl.parse_timeout_ms(ctx.extensions.get(var))
            if t is not None and t > 0:
                return t
        t = dl.default_timeout_ms()
        return t if t > 0 else None

    def _execute_sql_slow(self, sql: str, ctx: QueryContext,
                          _intercepted: bool = False) -> list[QueryResult]:
        """The full statement path: parse, then run every statement
        inside one admission slot (bounded queue, per-tenant fair
        scheduling; nested statements ride their top-level slot). The
        slot is released at execute-done, before any result encoding.
        The fast lane routes through here on any miss or fallback —
        this IS the semantics the lane must match. `_intercepted=True`
        means the fast lane already ran the plugin interceptor chain on
        this exact text: it runs ONCE a statement (auditing and
        rate-limit interceptors count calls)."""
        from greptimedb_tpu_torch.plugins import reset_active, set_active

        if ctx.timezone is None:
            ctx.timezone = self.default_timezone
        # plugin interceptors may rewrite or veto the statement before
        # parsing (reference SqlQueryInterceptor, frontend/src/instance.rs)
        if not _intercepted:
            sql = self.plugins.intercept_sql(sql, ctx)
        # expression evaluation resolves plugin scalar functions against
        # THIS engine's container for the duration of the statement
        token = set_active(self.plugins)
        try:
            # slow-query watch: a statement over the threshold leaves a
            # structured record (trace id, text, duration, rows, path,
            # stage breakdown, ledger) in the ring behind
            # information_schema.slow_queries and /v1/slow_queries
            with slow_query.watch("sql", sql, ctx.db) as w:
                self._reset_statement_state()
                t_parse = time.perf_counter()
                stmts = self._parse_cached(sql)
                STAGE_SECONDS.observe(time.perf_counter() - t_parse,
                                      stage="parse")
                # queueing counts into the watch: it IS part of the
                # latency the operator debugs; nested statements ride
                # their top-level slot
                with self.concurrency.admission.slot(
                        self.concurrency.tenant_of(ctx)):
                    results = [self.execute_statement(s, ctx)
                               for s in stmts]
                last = results[-1] if results else None
                if last is not None:
                    w.rows = last.num_rows if last.is_query \
                        else last.affected_rows
                w.execution_path = self.executor.last_path
                return results
        finally:
            reset_active(token)

    def _reset_statement_state(self) -> None:
        """Clear the executor's per-statement routes and stats (thread
        local): only aggregate paths assign them, and a statement must
        not inherit the previous one's."""
        self.executor.last_path = None
        self.executor.statement_paths = []
        self.executor.last_partial_stats = None
        self.executor.last_sparse_stats = None
        self.executor.last_stream_stats = None

    def _parse_cached(self, sql: str) -> list:
        """Parse with a small LRU over the raw SQL text. Dashboards and
        load generators repeat identical statements. Safe to share: the
        AST is only mutated during parsing; every post-parse transform
        copies via dataclasses.replace."""
        if len(sql) > 2048:
            # bulk INSERT texts never repeat — caching their (large)
            # ASTs would pin memory for a zero hit rate
            return parse_sql(sql)
        cache = self._stmt_cache
        with self._stmt_cache_lock:
            stmts = cache.get(sql)
            if stmts is not None:
                cache.move_to_end(sql)
                return stmts
        stmts = parse_sql(sql)  # parse outside the lock: it dominates
        with self._stmt_cache_lock:
            cache[sql] = stmts
            while len(cache) > 512:
                cache.popitem(last=False)
        return stmts

    def execute_one(self, sql: str, ctx: Optional[QueryContext] = None, *,
                    db: Optional[str] = None) -> QueryResult:
        results = self.execute_sql(sql, ctx, db=db)
        if not results:
            raise PlanError("empty statement")
        return results[-1]

    def execute_statement(self, stmt: ast.Statement,
                          ctx: QueryContext) -> QueryResult:
        # statement authorization before dispatch (auth/)
        self.permission_checker.check(ctx.user, stmt, ctx.db)
        # new top-level statement: its first plan-cache skip (if any)
        # is the one that gets counted
        self._skip_tls.noted = False
        ctx.trace_id = tracing.set_trace(ctx.trace_id)
        kind = type(stmt).__name__
        # naive timestamp literals — WHERE, BETWEEN, CAST, INSERT —
        # coerce in the session timezone everywhere in this statement
        token = set_session_tz(ctx.timezone or self.default_timezone)
        try:
            with STMT_DURATION.time(stmt=kind), \
                    tracing.span(f"stmt:{kind}") as sp:
                # the statement's resource-ledger slice is stamped onto
                # its root span (diffed: a multi-statement request
                # shares one request-scoped ledger)
                with ledger.attach() as led:
                    led0 = led.snapshot() if led is not None else {}
                    try:
                        dl.check(f"{kind} start")
                        return self._execute_statement(stmt, ctx)
                    except (DeadlineExceeded, Cancelled) as e:
                        # stamp the terminal deadline event on the
                        # statement span, the ledger and (if the
                        # statement turns out slow) the slow-query record
                        tok = dl.current()
                        event = (tok.kind if tok and tok.kind else
                                 ("expired"
                                  if isinstance(e, DeadlineExceeded)
                                  else "cancelled"))
                        sp["deadline_event"] = event
                        ledger.add(f"deadline_{event}", 1)
                        slow_query.annotate(deadline_event=event)
                        raise
                    finally:
                        if led is not None:
                            d = ledger.diff(led0, led.snapshot())
                            if d:
                                sp["ledger"] = ledger.format_dict(d)
                                rf = roofline.stamp(sp, d)
                                if rf is not None:
                                    QUERY_ACHIEVED_GBPS.observe(
                                        rf["achieved_gbps"], stmt=kind)
        finally:
            reset_session_tz(token)

    def _execute_statement(self, stmt: ast.Statement,
                           ctx: QueryContext) -> QueryResult:
        if isinstance(stmt, ast.Select):
            return self._select(stmt, ctx)
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt, ctx)
        if isinstance(stmt, ast.CreateDatabase):
            if stmt.name.lower() == "information_schema":
                raise CatalogError("'information_schema' is reserved")
            self.catalog.create_database(stmt.name, stmt.if_not_exists)
            return QueryResult.of_affected(1)
        if isinstance(stmt, ast.SetVar):
            return self._set_var(stmt, ctx)
        if isinstance(stmt, ast.KillQuery):
            if not dl.RUNNING.kill(stmt.query_id, reason="KILL QUERY"):
                raise PlanError(
                    f"unknown query id: {stmt.query_id} (see "
                    "information_schema.running_queries)")
            return QueryResult.of_affected(1)
        if isinstance(stmt, ast.Union):
            return self._union(stmt, ctx)
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt, ctx)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt, ctx)
        if isinstance(stmt, ast.CreateView):
            return self._create_view(stmt, ctx)
        if isinstance(stmt, ast.DropView):
            db, name = self._db_and_name(stmt.name, ctx)
            try:
                self.catalog.drop_view(db, name, if_exists=stmt.if_exists)
            except CatalogError as e:
                raise PlanError(str(e)) from None
            return QueryResult.of_affected(0)
        if isinstance(stmt, ast.ShowViews):
            views = sorted(self.catalog.list_views(ctx.db))
            return QueryResult(["Views"], [DataType.STRING],
                               [np.asarray(views, dtype=object)])
        if isinstance(stmt, ast.DropTable):
            return self._drop_table(stmt, ctx)
        if isinstance(stmt, ast.TruncateTable):
            return self._truncate(stmt, ctx)
        if isinstance(stmt, ast.ShowTables):
            return self._show_tables(stmt, ctx)
        if isinstance(stmt, ast.ShowDatabases):
            dbs = list(self.catalog.list_databases()) + ["information_schema"]
            return QueryResult(["Databases"], [DataType.STRING],
                               [np.asarray(sorted(dbs), dtype=object)])
        if isinstance(stmt, ast.DescribeTable):
            return self._describe(stmt, ctx)
        if isinstance(stmt, ast.ShowCreateTable):
            return self._show_create(stmt, ctx)
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt, ctx)
        if isinstance(stmt, ast.Use):
            if stmt.database.lower() != "information_schema" and \
                    not self.catalog.database_exists(stmt.database):
                raise CatalogError(f"database {stmt.database!r} not found")
            ctx.db = stmt.database
            return QueryResult.of_affected(0)
        if isinstance(stmt, ast.AlterTable):
            return self._alter(stmt, ctx)
        if isinstance(stmt, ast.AdminFunc):
            return self._admin(stmt, ctx)
        if isinstance(stmt, ast.Tql):
            return self._tql(stmt, ctx)
        if isinstance(stmt, ast.CopyTable):
            return self._copy_table(stmt, ctx)
        if isinstance(stmt, ast.CopyDatabase):
            return self._copy_database(stmt, ctx)
        if isinstance(stmt, ast.CreateFlow):
            self.flow_engine.create_flow(stmt, ctx)
            return QueryResult.of_affected(0)
        if isinstance(stmt, ast.DropFlow):
            self.flow_engine.drop_flow(stmt.name, ctx.db, stmt.if_exists)
            return QueryResult.of_affected(0)
        if isinstance(stmt, ast.ShowFlows):
            flows = self.flow_engine.list_flows(ctx.db)
            return QueryResult(
                ["Flows", "Sink", "Source", "Query"],
                [DataType.STRING] * 4,
                [np.asarray([f.name for f in flows], dtype=object),
                 np.asarray([f.sink_table for f in flows], dtype=object),
                 np.asarray([f.source_table for f in flows], dtype=object),
                 np.asarray([f.sql for f in flows], dtype=object)],
            )
        raise PlanError(f"unsupported statement {type(stmt).__name__}")

    @property
    def flow_engine(self):
        if not hasattr(self, "_flow_engine"):
            from greptimedb_tpu_torch.flow import FlowEngine

            self._flow_engine = FlowEngine(self)
        return self._flow_engine

    # ---- CTEs / subqueries -------------------------------------------------

    def _with_ctes(self, ctes, ctx: QueryContext) -> QueryContext:
        """Execute each CTE once and register it as a virtual relation in
        a copied context; CTEs shadow real tables and are visible to
        later CTEs, derived tables, and join sides."""
        ctx2 = ctx.with_db(ctx.db)
        ctx2.extensions = dict(ctx.extensions)
        vmap = dict(ctx2.extensions.get("__virtual_tables__") or {})
        ctx2.extensions["__virtual_tables__"] = vmap
        for name, stmt, col_names in ctes:
            r = self._execute_statement(stmt, ctx2)
            if not r.is_query:
                raise PlanError(f"CTE {name!r} must be a query")
            names = list(col_names) if col_names else list(r.names)
            if col_names and len(col_names) != len(r.names):
                raise PlanError(
                    f"CTE {name!r} declares {len(col_names)} columns but "
                    f"its query returns {len(r.names)}")
            if len(set(names)) != len(names):
                raise PlanError(
                    f"CTE {name!r} produces duplicate column names; "
                    "alias them in the CTE query")
            vmap[name.lower()] = (names, list(r.dtypes),
                                  [np.asarray(c) for c in r.columns])
        return ctx2

    def _virtual_table(self, table: Optional[str], ctx: QueryContext):
        if table is None:
            return None
        vmap = ctx.extensions.get("__virtual_tables__")
        return vmap.get(table.lower()) if vmap else None

    def _fold_tree(self, e, ctx: QueryContext, predicate: bool = False):
        """Replace uncorrelated ast.Subquery nodes with literals by
        executing them now. Correlated subqueries fail naturally inside
        with 'unknown column'. `predicate` marks WHERE/HAVING/ON position,
        where UNKNOWN (NULL) may legally collapse to FALSE."""
        if isinstance(e, ast.Subquery):
            stmt = e.stmt
            if e.exists and isinstance(stmt, (ast.Select, ast.Union)) \
                    and stmt.limit is None:
                # only row existence matters — don't materialize the rest
                stmt = dataclasses.replace(stmt, limit=1)
            r = self._execute_statement(stmt, ctx)
            if not r.is_query:
                raise PlanError("subquery must be a query")
            if e.exists:
                return ast.Literal(bool(r.num_rows))
            if len(r.names) != 1:
                raise PlanError(
                    "scalar subquery must return exactly one column")
            if r.num_rows == 0:
                return ast.Literal(None)
            if r.num_rows > 1:
                raise PlanError("scalar subquery returned more than one row")
            v = r.columns[0][0]
            v = v.item() if isinstance(v, np.generic) else v
            return ast.Literal(None if _is_nan_scalar(v) else v)
        if isinstance(e, ast.InList) and len(e.items) == 1 \
                and isinstance(e.items[0], ast.Subquery):
            r = self._execute_statement(e.items[0].stmt, ctx)
            if len(r.names) != 1:
                raise PlanError("IN subquery must return exactly one column")
            vals = [v.item() if isinstance(v, np.generic) else v
                    for v in r.columns[0].tolist()]
            nonnull = [v for v in vals
                       if v is not None and not _is_nan_scalar(v)]
            # the LHS is a comparison OPERAND: UNKNOWN≡FALSE never
            # applies inside it, whatever position the IN itself holds
            expr = self._fold_tree(e.expr, ctx, False)
            if e.negated and len(nonnull) != len(vals):
                # NOT IN over a list containing NULL is never TRUE:
                # matched → FALSE, unmatched → UNKNOWN. In predicate
                # position both exclude the row, so FALSE is exact; in
                # projection position preserve the FALSE/NULL split
                if predicate:
                    return ast.Literal(False)
                if not nonnull:  # every element NULL: always UNKNOWN
                    return ast.Literal(None)
                return ast.Case(
                    None,
                    ((ast.InList(expr, tuple(ast.Literal(v)
                                             for v in nonnull)),
                      ast.Literal(False)),),
                    ast.Literal(None))
            if not nonnull:
                # x IN (empty) is FALSE; NOT IN (empty) is TRUE
                return ast.Literal(bool(e.negated))
            return ast.InList(expr, tuple(ast.Literal(v) for v in nonnull),
                              e.negated)
        # UNKNOWN ≡ FALSE survives only through AND/OR conjunctions; any
        # other enclosing operator (NOT, IS NULL, CASE, comparisons) can
        # distinguish them, so the flag resets before descending
        child_pred = (predicate and isinstance(e, ast.BinaryOp)
                      and e.op in ("and", "or"))
        if isinstance(e, (list, tuple)):
            return type(e)(self._fold_tree(x, ctx, predicate) for x in e)
        # descend any expression-carrying dataclass (incl. non-Expr
        # carriers like WindowSpec) but never into embedded statements —
        # those execute atomically via the Subquery branch above
        if dataclasses.is_dataclass(e) and not isinstance(e, type) \
                and not isinstance(e, ast.Statement):
            changes = {}
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (ast.Expr, list, tuple)) or (
                        dataclasses.is_dataclass(v)
                        and not isinstance(v, (type, ast.Statement))):
                    nv = self._fold_tree(v, ctx, child_pred)
                    if nv != v:
                        changes[f.name] = nv
            return dataclasses.replace(e, **changes) if changes else e
        return e

    def _fold_select_subqueries(self, sel: ast.Select,
                                ctx: QueryContext) -> ast.Select:
        if not _has_subquery(sel):
            return sel
        changes: dict = {
            "items": [dataclasses.replace(it,
                                          expr=self._fold_tree(it.expr, ctx))
                      for it in sel.items]}
        if sel.where is not None:
            changes["where"] = self._fold_tree(sel.where, ctx,
                                               predicate=True)
        if sel.having is not None:
            changes["having"] = self._fold_tree(sel.having, ctx,
                                                predicate=True)
        if sel.group_by:
            changes["group_by"] = [self._fold_tree(g, ctx)
                                   for g in sel.group_by]
        if sel.order_by:
            changes["order_by"] = [
                dataclasses.replace(ob, expr=self._fold_tree(ob.expr, ctx))
                for ob in sel.order_by]
        if sel.joins:
            changes["joins"] = [
                dataclasses.replace(
                    j, on=self._fold_tree(j.on, ctx, predicate=True)
                    if j.on is not None else None)
                for j in sel.joins]
        return dataclasses.replace(sel, **changes)

    # ---- table resolution --------------------------------------------------

    def _db_and_name(self, name: str, ctx: QueryContext) -> tuple[str, str]:
        # db.table only when the prefix names a real database — otherwise
        # it's a table name containing dots ("sys.cpu")
        if "." in name:
            candidate_db, rest = name.rsplit(".", 1)
            if self.catalog.database_exists(candidate_db):
                return candidate_db, rest
        return ctx.db, name

    def _table(self, name: str, ctx: QueryContext) -> TableInfo:
        info = self.catalog.table(*self._db_and_name(name, ctx))
        self._ensure_open(info)
        return info

    def _ensure_open(self, info: TableInfo) -> None:
        """Open the table's regions from disk on first use (a catalog
        that outlived the storage engine's process), each region once:
        the engine, or through a cluster's router the region's datanode,
        keeps it open."""
        for rid in info.region_ids:
            if rid not in self._open_regions:
                try:
                    self.region_engine.region(rid)
                except KeyError:
                    self.region_engine.open_region(rid)
                self._open_regions.add(rid)

    # ---- views -------------------------------------------------------------

    def _create_view(self, stmt: ast.CreateView,
                     ctx: QueryContext) -> QueryResult:
        if "." in stmt.name:
            prefix = stmt.name.rsplit(".", 1)[0]
            if not self.catalog.database_exists(prefix):
                # DDL must not silently fold a typo'd db prefix into the
                # view name (reads tolerate dotted names)
                raise PlanError(f"database {prefix!r} not found")
        db, name = self._db_and_name(stmt.name, ctx)
        # the definition must at least parse and name a single query
        defs = parse_sql(stmt.query_sql)
        if len(defs) != 1 or not isinstance(defs[0],
                                            (ast.Select, ast.Union, ast.Tql)):
            raise PlanError("CREATE VIEW requires a single query")
        try:
            self.catalog.create_view(db, name, stmt.query_sql,
                                     or_replace=stmt.or_replace,
                                     if_not_exists=stmt.if_not_exists)
        except CatalogError as e:
            raise PlanError(str(e)) from None
        return QueryResult.of_affected(0)

    def _view_sql(self, name: str, ctx: QueryContext):
        db, short = self._db_and_name(name, ctx)
        return self.catalog.view(db, short)

    def _select_view(self, sel: ast.Select, vsql: str,
                     ctx: QueryContext) -> QueryResult:
        """SELECT over a view. Simple views (single-table
        projection/filter) INLINE into the outer query, so the merged
        query keeps the device scan path and RANGE ... ALIGN. Complex
        views (aggregates, joins, limits) materialize through the normal
        engine and the outer select evaluates over their columns."""
        inner_stmts = parse_sql(vsql)
        if len(inner_stmts) != 1:
            raise PlanError("view definition must be a single query")
        inlined = self._try_inline_view(sel, inner_stmts[0], ctx)
        if inlined is not None:
            return self._select(inlined, ctx)
        if rs.is_range_select(sel):
            # RANGE/ALIGN needs the base table's time-index machinery —
            # refusing beats silently dropping the alignment semantics
            raise PlanError(
                "RANGE ... ALIGN is only supported over simple "
                "(projection/filter) views; query the underlying table "
                "or fold the RANGE into the view")
        view_db, short = self._db_and_name(sel.table, ctx)
        # the defining query resolves unqualified names in the VIEW's
        # database, and nested views are depth-limited (a ↔ b cycles
        # must be a PlanError, not a RecursionError)
        inner_ctx = ctx.with_db(view_db)
        inner_ctx.extensions = dict(ctx.extensions)
        depth = int(inner_ctx.extensions.get("__view_depth__", 0)) + 1
        if depth > 16:
            raise PlanError(
                f"view nesting deeper than 16 at {view_db}.{short} "
                "(possible view cycle)")
        inner_ctx.extensions["__view_depth__"] = depth
        base = self._execute_statement(inner_stmts[0], inner_ctx)
        if not base.is_query:
            raise PlanError("view definition is not a query")
        if len(set(base.names)) != len(base.names):
            dupes = sorted({n for n in base.names
                            if base.names.count(n) > 1})
            raise PlanError(
                f"view {view_db}.{short} produces duplicate column "
                f"name(s) {dupes}; alias them in the view definition")
        cols = dict(zip(base.names, base.columns))
        dtypes = dict(zip(base.names, base.dtypes))
        return execute_select_over(self, sel, cols, dtypes,
                                   alias=sel.table_alias or short)

    def _try_inline_view(self, sel: ast.Select, inner,
                         ctx: QueryContext) -> Optional[ast.Select]:
        """Merge the outer select into a SIMPLE view definition
        (single table, projection + filter only): outer column refs
        substitute to the view's defining expressions, WHEREs conjoin,
        and the merged query plans against the base table. Returns None
        when the view is too complex to inline."""
        if not isinstance(inner, ast.Select):
            return None
        if (inner.joins or inner.group_by or inner.having or inner.distinct
                or inner.order_by or inner.limit is not None or inner.offset
                or inner.ctes or inner.from_subquery is not None
                or inner.table is None or inner.align is not None):
            return None
        if select_has_window(inner):
            return None
        if any(has_aggregate(it.expr) for it in inner.items):
            return None  # aggregate-only view (no GROUP BY): materialize
        if any(_expr_has_subquery(it.expr) for it in inner.items) or (
                inner.where is not None
                and _expr_has_subquery(inner.where)):
            return None
        # resolve the base table's schema in the VIEW's database
        view_db, _ = self._db_and_name(sel.table, ctx)
        inner_ctx = ctx.with_db(view_db)
        try:
            info = self._table(inner.table, inner_ctx)
        except (CatalogError, PlanError):
            return None
        # exposed name -> defining expression, in the VIEW's item order
        # (Star expands in place so positional clients see the view's
        # declared column order)
        mapping: dict[str, ast.Expr] = {}
        for it in inner.items:
            if isinstance(it.expr, ast.Star):
                for c in info.schema.names:
                    if c in mapping:
                        return None  # duplicate: materialize path errors
                    mapping[c] = ast.Column(c)
                continue
            name = it.alias or (it.expr.name
                                if isinstance(it.expr, ast.Column)
                                else None)
            if name is None:
                return None  # unnamed computed column: can't reference it
            if name in mapping:
                # duplicate output name: let the materialize path raise
                # its duplicate-column error
                return None
            mapping[name] = it.expr
        alias = sel.table_alias or sel.table

        class _Unmappable(Exception):
            pass

        def leaf(e):
            if isinstance(e, ast.Column):
                if e.table not in (None, alias, sel.table):
                    raise _Unmappable()
                if e.name not in mapping:
                    raise _Unmappable()
                return mapping[e.name]
            return NotImplemented

        def subst(e):
            return _rewrite_tree(e, leaf)

        def item_sub(it):
            if isinstance(it.expr, ast.Star):
                return it
            new_expr = subst(it.expr)
            alias = it.alias
            # keep the VIEW-level spelling when substitution changed the
            # expression: sum(dbl) must not surface as "sum(v * 2)"
            if alias is None and new_expr != it.expr:
                alias = _default_name(it.expr)
            return dataclasses.replace(it, expr=new_expr, alias=alias)

        try:
            items = []
            for it in sel.items:
                if isinstance(it.expr, ast.Star):
                    # SELECT * over the view projects the VIEW's outputs
                    for name, expr in mapping.items():
                        items.append(ast.SelectItem(expr, alias=name))
                else:
                    items.append(item_sub(it))
            where = subst(sel.where) if sel.where is not None else None
            if inner.where is not None:
                where = inner.where if where is None else \
                    ast.BinaryOp("and", where, inner.where)
            merged = dataclasses.replace(
                sel, items=items, table=inner.table, table_alias=None,
                where=where,
                group_by=[subst(g) for g in sel.group_by],
                having=subst(sel.having) if sel.having is not None else None,
                order_by=[dataclasses.replace(ob, expr=subst(ob.expr))
                          for ob in sel.order_by],
                align_by=[subst(a) for a in sel.align_by],
                align_to=subst(sel.align_to)
                if sel.align_to is not None else None)
        except _Unmappable:
            return None
        # run in the view's database so the base table resolves there
        if view_db != ctx.db:
            merged = dataclasses.replace(merged, table=f"{view_db}.{inner.table}") \
                if "." not in inner.table else merged
        return merged

    # ---- SELECT ------------------------------------------------------------

    def _note_plan_cache_skip(self, reason: str) -> None:
        """A statement shape the plan cache cannot hold: count it with a
        reason label and stamp the slow-query record, so an uncacheable
        dashboard query is visible instead of just slow. Once per
        top-level statement — a CTE body re-entering _select must not
        double-count or overwrite the outer statement's reason."""
        if not self.concurrency.plan_cache.enabled:
            return
        if getattr(self._skip_tls, "noted", False):
            return
        self._skip_tls.noted = True
        PLAN_CACHE_EVENTS.inc(event="skip", reason=reason)
        slow_query.annotate(plan_cache_skip=reason)

    def _select(self, sel: ast.Select, ctx: QueryContext) -> QueryResult:
        if sel.ctes:
            self._note_plan_cache_skip("cte")
        elif sel.joins:
            self._note_plan_cache_skip("join")
        elif sel.from_subquery is not None:
            self._note_plan_cache_skip("subquery")
        if sel.ctes:
            # WITH ...: run each CTE once, visible to later CTEs and the
            # body
            ctx = self._with_ctes(sel.ctes, ctx)
            sel = dataclasses.replace(sel, ctes=[])
        # uncorrelated scalar/IN/EXISTS subqueries fold to literals
        # before planning
        sel = self._fold_select_subqueries(sel, ctx)
        if sel.from_subquery is not None and not sel.joins:
            # FROM (SELECT ...) alias — materialize the derived table,
            # evaluate the outer pipeline over its columns (view path)
            base = self._execute_statement(sel.from_subquery, ctx)
            if not base.is_query:
                raise PlanError("derived table must be a query")
            return execute_select_over(
                self, sel, dict(zip(base.names, base.columns)),
                dict(zip(base.names, base.dtypes)), alias=sel.table_alias)
        vt = self._virtual_table(sel.table, ctx)
        if vt is not None and not sel.joins:
            names, vdtypes, vcols = vt
            return execute_select_over(
                self, sel, dict(zip(names, vcols)),
                dict(zip(names, vdtypes)),
                alias=sel.table_alias or sel.table)
        if sel.joins:
            # joins first: the join executor materializes each side via
            # _select, which handles information_schema sides itself
            return execute_join_select(self, sel, ctx)
        if sel.table is not None and \
                infoschema.is_information_schema_query(sel.table, ctx.db):
            return infoschema.execute_virtual_select(self, sel, ctx)
        if sel.table is not None:
            vsql = self._view_sql(sel.table, ctx)
            if vsql is not None:
                return self._select_view(sel, vsql, ctx)
        if sel.table is None:
            # SELECT <literals> — session funcs substitute here too
            sel = _subst_session_funcs(sel, ctx)
            names, cols = [], []
            for i, it in enumerate(sel.items):
                v = eval_host(it.expr, {}, None, None)
                cols.append(np.asarray([v]) if np.ndim(v) == 0
                            else np.asarray(v))
                names.append(it.alias or f"column{i}")
            return QueryResult(names, [None] * len(names), cols)
        info = self._table(sel.table, ctx)
        # concurrency plane: a top-level SELECT on a busy server may
        # coalesce or stack with shape-compatible concurrent queries; the
        # plane always lands back in _select_table below
        return self.concurrency.execute_select(
            self, _subst_session_funcs(sel, ctx), info, ctx)

    def _select_table(self, sel: ast.Select, info: TableInfo,
                      ctx: QueryContext) -> QueryResult:
        """The single-table SELECT below the concurrency plane: windows
        over the device aggregate or the device scan, RANGE ... ALIGN, or
        one planned device query through the plan cache. Batch leaders
        re-enter here with the combined statement."""
        if select_has_window(sel):
            self._note_plan_cache_skip("window")
            if sel.group_by:
                # SQL evaluation order: aggregate first (the device
                # aggregate routes), then windows over the G-row grouped
                # relation
                inner, outer = split_groupby_window(sel)
                base = self._select(inner, ctx)
                return execute_select_over(
                    self, outer, dict(zip(base.names, base.columns)),
                    dict(zip(base.names, base.dtypes)))
            # window-partition pushdown: a PARTITION BY covering the
            # table's partition-rule columns keeps each window partition
            # inside one region, so the regions compute the windows and
            # ship filtered rows plus window columns
            res = self._try_window_pushdown(sel, info, ctx)
            if res is not None:
                return res
            # the device scan + WHERE mask materializes the base
            # relation, windows evaluate on the host over the filtered
            # rows. Project only referenced columns (a Star or an
            # unresolvable qualifier falls back to everything).
            base_items = [ast.SelectItem(ast.Star())]
            if not any(isinstance(it.expr, ast.Star) for it in sel.items):
                refs: set = set()
                for it in sel.items:
                    _columns_in(it.expr, refs)
                for ob in sel.order_by:
                    _columns_in(ob.expr, refs)
                _columns_in(sel.where, refs)
                for g in sel.group_by:
                    _columns_in(g, refs)
                _columns_in(sel.having, refs)
                alias = sel.table_alias or sel.table
                names = {c for t, c in refs if t in (None, alias, sel.table)}
                qual_ok = all(t in (None, alias, sel.table)
                              for t, _ in refs)
                if qual_ok and names <= set(info.schema.names):
                    base_items = [ast.SelectItem(ast.Column(c))
                                  for c in sorted(names)]
            base_sel = ast.Select(items=base_items, table=sel.table,
                                  where=sel.where)
            base = self._select(base_sel, ctx)
            outer = dataclasses.replace(sel, where=None, table=None)
            return execute_select_over(
                self, outer, dict(zip(base.names, base.columns)),
                dict(zip(base.names, base.dtypes)),
                alias=sel.table_alias or sel.table)
        if rs.is_range_select(sel):
            self._note_plan_cache_skip("range_select")
            return rs.execute_range_select(self.executor,
                                           rs.plan_range_select(sel, info))
        # shape-keyed plan cache: repeated dashboard statements re-bind
        # a cached validated plan instead of re-planning; the entry also
        # memoizes a negative rollup-substitution probe (version-stamped:
        # any rollup state change re-probes)
        t_plan = time.perf_counter()
        plan, entry, binding = self.concurrency.plan_cache.lookup(sel, info)
        # a probed shape may memoize the negative outcome only when it
        # was STRUCTURAL (sub_note): coverage / alignment failures depend
        # on this query's literal values
        sub_note = {"memoizable": True}
        sub_stamp = None
        if sel.group_by or any(has_aggregate(it.expr) for it in sel.items):
            # rollup substitution: eligible coarse-bucket aggregates are
            # served from the planes (maintenance/rollup.py); None =
            # ineligible or uncovered, fall through to the raw scan
            if entry is None or not entry.skip_substitution():
                from greptimedb_tpu_torch.concurrency.plan_cache import (
                    substitution_stamp,
                )
                from greptimedb_tpu_torch.maintenance.rollup import (
                    try_substitute,
                )

                # pre-probe stamp: a roll finishing mid-probe must not
                # lend its fresher version to this negative outcome
                sub_stamp = substitution_stamp()
                t_sub = time.perf_counter()
                res = try_substitute(self, sel, info, ctx,
                                     shape_note=sub_note)
                if res is not None:
                    STAGE_SECONDS.observe(t_sub - t_plan, stage="plan")
                    STAGE_SECONDS.observe(time.perf_counter() - t_sub,
                                          stage="execute")
                    return res
                if entry is not None and sub_note.get("memoizable"):
                    entry.mark_sub_ineligible(sub_stamp)
        if plan is None:
            plan = plan_select(sel, info)
            entry = self.concurrency.plan_cache.store(binding, sel, info,
                                                      plan)
            if entry is not None and sub_note.get("memoizable"):
                entry.mark_sub_ineligible(sub_stamp)
        STAGE_SECONDS.observe(time.perf_counter() - t_plan, stage="plan")
        # stamp a fast-lane build ticket (if this thread armed one):
        # the statement is about to execute exactly this plan-cache
        # plan, which is what a text-template entry memoizes
        self.concurrency.fast_lane.note_plan_execution(sel, info, entry)
        ex = self.executor
        before = ex.last_path
        ex.last_path = None
        t_exec = time.perf_counter()
        try:
            result = ex.execute(plan)
        finally:
            STAGE_SECONDS.observe(time.perf_counter() - t_exec,
                                  stage="execute")
        if ex.last_path is None:
            # a raw scan: the statement's route stays its last
            # aggregate's, as the JAX engine reports it
            ex.last_path = before
        else:
            ex.statement_paths.append(ex.last_path)
        return result

    # ---- UNION -------------------------------------------------------------

    def _union(self, stmt: ast.Union, ctx: QueryContext) -> QueryResult:
        """UNION [ALL]: concatenate branch results; plain UNION dedups
        whole rows."""
        if stmt.ctes:
            ctx = self._with_ctes(stmt.ctes, ctx)
        results = [self._select(b, ctx) for b in stmt.branches]
        first = results[0]
        width = len(first.names)
        for r in results[1:]:
            if len(r.names) != width:
                raise PlanError(
                    f"UNION branches have {width} vs {len(r.names)} columns")
        cols = []
        for i in range(width):
            parts = [np.asarray(r.columns[i]) for r in results]
            if any(p.dtype == object for p in parts):
                parts = [p.astype(object) for p in parts]
            cols.append(np.concatenate(parts))

        def row_key(i):
            # NULL floats are NaN and NaN != NaN — normalize so UNION
            # treats NULLs as not distinct (SQL semantics)
            return tuple(
                None if (isinstance(v, float) and v != v) else v
                for v in (c[i] for c in cols))

        if not stmt.all and cols and len(cols[0]):
            seen: set = set()
            keep = []
            for i in range(len(cols[0])):
                row = row_key(i)
                if row not in seen:
                    seen.add(row)
                    keep.append(i)
            cols = [c[keep] for c in cols]
        out = QueryResult(list(first.names), list(first.dtypes), cols)
        # trailing ORDER BY / LIMIT / OFFSET over the whole union
        n = out.num_rows
        idx = np.arange(n)
        for ob in reversed(stmt.order_by):
            name = ob.expr.name if isinstance(ob.expr, ast.Column) else None
            if name is None or name not in out.names:
                raise PlanError(
                    "UNION ORDER BY must name an output column")
            col = np.asarray(out.column(name))[idx]
            try:
                srt = np.argsort(col, kind="stable")
            except TypeError:
                srt = np.asarray(sorted(
                    range(len(col)),
                    key=lambda i: (col[i] is None, col[i])), dtype=np.int64)
            if not ob.asc:
                srt = srt[::-1]
            idx = idx[srt]
        off = stmt.offset or 0
        stop = off + stmt.limit if stmt.limit is not None else None
        idx = idx[off:stop]
        if len(idx) != n or stmt.order_by:
            out = QueryResult(out.names, out.dtypes,
                              [np.asarray(c)[idx] for c in out.columns])
        return out

    # ---- session and introspection -----------------------------------------

    def _set_var(self, stmt: ast.SetVar, ctx: QueryContext) -> QueryResult:
        """Session variables: time_zone takes effect; client-compat
        chatter (NAMES, sql_mode, autocommit, ...) is accepted and
        recorded but changes nothing."""
        name = stmt.name.rsplit(".", 1)[-1]  # strip session./global.
        if name in ("time_zone", "timezone"):
            # SET TIME ZONE DEFAULT (value None) restores the engine
            # default rather than the string 'None'. Validate NOW: a
            # typo'd zone must fail at SET, not on a later INSERT
            if stmt.value is None:
                ctx.timezone = self.default_timezone
            else:
                try:
                    ts_util.tzinfo_for(str(stmt.value))
                except ValueError as e:
                    raise PlanError(str(e)) from None
                ctx.timezone = str(stmt.value)
        else:
            ctx.extensions[name] = stmt.value
        return QueryResult.of_affected(0)

    def _show_tables(self, stmt: ast.ShowTables,
                     ctx: QueryContext) -> QueryResult:
        db = stmt.database or ctx.db
        if db.lower() == infoschema.INFORMATION_SCHEMA:
            names = infoschema.table_names()
        else:
            names = self.catalog.list_tables(db)
        if stmt.like:
            rx = _like_to_regex(stmt.like)
            names = [n for n in names if rx.fullmatch(n)]
        return QueryResult(["Tables"], [DataType.STRING],
                           [np.asarray(names, dtype=object)])

    def _describe(self, stmt: ast.DescribeTable,
                  ctx: QueryContext) -> QueryResult:
        info = self._table(stmt.name, ctx)
        names, types, keys, nulls, defaults, semantics = [], [], [], [], [], []
        cols = ([info.schema.column(n) for n in info.column_order]
                if info.column_order else info.schema.columns)
        for c in cols:
            names.append(c.name)
            types.append(c.dtype.value)
            keys.append("PRI" if c.semantic in (SemanticType.TAG,
                                                SemanticType.TIMESTAMP)
                        else "")
            nulls.append("YES" if c.nullable else "NO")
            defaults.append("" if c.default is None else str(c.default))
            semantics.append({"tag": "TAG", "timestamp": "TIMESTAMP",
                              "field": "FIELD"}[c.semantic.value])
        return QueryResult(
            ["Column", "Type", "Key", "Null", "Default", "Semantic Type"],
            [DataType.STRING] * 6,
            [np.asarray(x, dtype=object) for x in
             (names, types, keys, nulls, defaults, semantics)])

    def _show_create(self, stmt: ast.ShowCreateTable,
                     ctx: QueryContext) -> QueryResult:
        if stmt.is_view or self._view_sql(stmt.name, ctx) is not None:
            db, name = self._db_and_name(stmt.name, ctx)
            vsql = self.catalog.view(db, name)
            if vsql is None:
                raise CatalogError(f"view {db}.{name} not found")
            return QueryResult(
                ["View", "Create View"],
                [DataType.STRING, DataType.STRING],
                [np.asarray([name], dtype=object),
                 np.asarray([f'CREATE VIEW "{name}" AS {vsql}'],
                            dtype=object)])
        info = self._table(stmt.name, ctx)
        lines = [f"CREATE TABLE IF NOT EXISTS \"{info.name}\" ("]
        defs = []
        for c in info.schema.columns:
            null = "" if c.nullable else " NOT NULL"
            defs.append(f'  "{c.name}" {_render_type(c.dtype)}{null}')
        defs.append(f'  TIME INDEX ("{info.schema.time_index.name}")')
        tags = [c.name for c in info.schema.tag_columns]
        if tags:
            defs.append("  PRIMARY KEY ("
                        + ", ".join(f'"{t}"' for t in tags) + ")")
        lines.append(",\n".join(defs))
        lines.append(")")
        lines.append("ENGINE=mito")
        if info.options:
            opts = ", ".join(f"'{k}' = '{v}'"
                             for k, v in info.options.items())
            lines.append(f"WITH ({opts})")
        ddl = "\n".join(lines)
        return QueryResult(
            ["Table", "Create Table"], [DataType.STRING, DataType.STRING],
            [np.asarray([info.name], dtype=object),
             np.asarray([ddl], dtype=object)])

    def _explain(self, stmt: ast.Explain, ctx: QueryContext) -> QueryResult:
        """EXPLAIN: the logical plan of a table query, the view or the
        join it names. EXPLAIN ANALYZE also runs the statement and
        appends its span tree, resource ledger and roofline fold."""
        if isinstance(stmt.inner, ast.Select) and stmt.inner.joins:
            sides = [stmt.inner.table] + [j.table for j in stmt.inner.joins]
            text = "Join: " + " ⋈ ".join(
                f"{t} (view)" if self._view_sql(t, ctx) is not None else t
                for t in sides) + "\n  (host hash join over device scans)"
        elif isinstance(stmt.inner, ast.Select) \
                and stmt.inner.table is not None:
            vsql = self._view_sql(stmt.inner.table, ctx)
            if vsql is not None:
                text = (f"View: {stmt.inner.table} AS {vsql}\n"
                        "  (outer select evaluates over the view result)")
            else:
                info = self._table(stmt.inner.table, ctx)
                text = lp.explain_plan(plan_select(stmt.inner, info))
        else:
            text = f"{type(stmt.inner).__name__}"
        lines = text.split("\n")
        if stmt.analyze:
            # the inner statement really runs: it needs its OWN
            # authorization (EXPLAIN itself only required read — without
            # this a read-only user could EXPLAIN ANALYZE a DELETE)
            self.permission_checker.check(ctx.user, stmt.inner, ctx.db)
            lines += self._analyze_run(
                lambda: self._execute_statement(stmt.inner, ctx),
                show_path=True)
        return QueryResult(["plan"], [DataType.STRING],
                           [np.asarray(lines, dtype=object)])

    def _analyze_run(self, run, show_path: bool = False) -> list[str]:
        """Execute `run` under a FRESH trace id and report its span tree
        (shared by EXPLAIN ANALYZE and TQL ANALYZE). A fresh id matters:
        connection-scoped contexts pin one trace id, and reusing it would
        dump every prior statement's spans into this report. The
        connection's trace AND parent-span context are restored
        afterwards (adopt_remote with a cleared parent makes the inner
        run its own tree root instead of a child of the request span)."""
        tid = tracing.new_trace_id()
        with tracing.adopt_remote(tid, None):
            # a fresh ledger too: the report must attribute THIS
            # statement's resources, not the whole request's
            with ledger.attach_fresh() as led:
                t0 = time.perf_counter()
                # ANALYZE must run ITS OWN execution: riding a batch
                # leader's run would report someone else's (empty) trace
                with self.concurrency.suppress_batching():
                    result = run()
                total_ms = (time.perf_counter() - t0) * 1000.0
            spans = tracing.spans_for(tid)
        lines = ["", f"ANALYZE trace={tid} total={total_ms:.2f} ms "
                     f"rows={result.num_rows}"]
        if show_path:
            path = self.executor.last_path
            if path:
                lines.append(f"  execution path: {path}")
        # the span TREE: children nest under their parents, each parent
        # reporting self-time
        lines.extend(tracing.render_tree(spans))
        if led is not None:
            summary = led.summary()
            if summary:
                lines.append(f"  resource ledger: {summary}")
                rf = roofline.account(ledger.derive(led.snapshot()))
                if rf is not None:
                    lines.append(f"  roofline: {roofline.format_line(rf)}")
        return lines

    # ---- TQL ---------------------------------------------------------------

    def _tql(self, stmt: ast.Tql, ctx: QueryContext) -> QueryResult:
        """TQL EVAL: the PromQL range query on this engine's device, in
        the long table format; TQL EXPLAIN: the parsed PromQL tree; TQL
        ANALYZE also runs the query and appends its span tree."""
        from greptimedb_tpu_torch.promql.engine import PromqlEngine
        from greptimedb_tpu_torch.promql.parser import parse_promql

        engine = PromqlEngine(self)
        if stmt.explain or stmt.analyze:
            lines = [f"PromQL: {stmt.query}",
                     _explain_promql(parse_promql(stmt.query))]
            if stmt.analyze:
                lines += self._analyze_run(
                    lambda: engine.eval_range(stmt.query, stmt.start,
                                              stmt.end, stmt.step, ctx.db))
            return QueryResult(["plan"], [DataType.STRING],
                               [np.asarray(lines, dtype=object)])
        return engine.eval_range(stmt.query, stmt.start, stmt.end,
                                 stmt.step, ctx.db)

    def _try_window_pushdown(self, sel: ast.Select, info, ctx):
        """Ship [filter, prune, window] PlanFragments when every window
        call's PARTITION BY covers the partition-rule columns (rows of one
        window partition never span regions: the reference's
        ConditionalCommutative class, commutativity.rs). The union of the
        regions' rows and window columns feeds the outer select. None
        when the shape does not commute: the caller gathers."""
        eng = self.region_engine
        if (len(info.region_ids) <= 1 or not info.partition_rules
                or not hasattr(eng, "execute_fragment")
                or sel.having is not None):
            return None
        from concurrent.futures import ThreadPoolExecutor

        from greptimedb_tpu_torch.query.dist_agg import merge_topk
        from greptimedb_tpu_torch.query.plan_ser import PlanFragment
        from greptimedb_tpu_torch.query.window import (
            SUPPORTED,
            collect_window_calls,
            substitute_window_calls,
        )
        from greptimedb_tpu_torch.utils import deadline as dl
        from greptimedb_tpu_torch.utils import tracing
        from greptimedb_tpu_torch.utils.metrics import FRAGMENT_PUSHDOWNS

        rule_cols = set(_cached_rule(info).columns)
        calls = collect_window_calls(sel)
        if not calls:
            return None
        schema = info.schema
        for fc in calls:
            if fc.name not in SUPPORTED:
                return None
            part_cols = {p.name for p in fc.over.partition_by
                         if isinstance(p, ast.Column)}
            if not rule_cols <= part_cols:
                return None
        refs: set = set()
        for it in sel.items:
            if isinstance(it.expr, ast.Star):
                return None  # the projection must be known statically
            _columns_in(it.expr, refs)
        for ob in sel.order_by:
            _columns_in(ob.expr, refs)
        _columns_in(sel.where, refs)
        alias = sel.table_alias or sel.table
        if not all(t in (None, alias, sel.table) for t, _ in refs):
            return None
        cols = {c for _, c in refs}
        if not cols <= set(schema.names):
            return None
        ts_col = schema.time_index
        ts_range = extract_ts_bounds(sel.where, ts_col.name, ts_col.dtype)
        mapping = [(fc, ast.Column(f"__win_{i}"))
                   for i, fc in enumerate(calls)]
        stages: list = []
        if sel.where is not None:
            stages.append({"op": "filter", "expr": sel.where})
        stages.append({"op": "prune", "columns": sorted(cols)})
        stages.append({"op": "window",
                       "calls": [(col.name, fc) for fc, col in mapping]})
        frag = PlanFragment(stages=stages, ts_range=ts_range,
                            append_mode=info.append_mode,
                            tz=current_session_tz())
        FRAGMENT_PUSHDOWNS.inc(mode="window")
        rids = list(info.region_ids)
        with tracing.span("window_pushdown", regions=len(rids)):
            # the pool is joined before the outer select runs
            one = dl.propagate(tracing.propagate(
                lambda rid: eng.execute_fragment(rid, frag)))
            with ThreadPoolExecutor(max_workers=min(8, len(rids)),
                                    thread_name_prefix="gtpu-frag") as pool:
                partials = list(pool.map(one, rids))
        merged = merge_topk(partials)  # the union of the regions' rows
        outer = substitute_window_calls(
            dataclasses.replace(sel, where=None, table=None,
                                table_alias=None), mapping)
        self.executor.last_path = "window_pushdown"
        base_cols = merged["cols"] if merged else \
            {name: np.empty(0, dtype=object)
             for name in sorted(cols) + [c.name for _, c in mapping]}
        return execute_select_over(
            self, outer, base_cols,
            {c.name: c.dtype for c in schema.columns
             if c.name in base_cols},
            # qualified references passed the gate: the relation exposes
            # them as the gather path's does
            alias=alias)

    # ---- DDL ---------------------------------------------------------------

    def _invalidate_plans(self, db: str, name: str) -> None:
        """DDL changed `db.name`: evict its cached plan shapes and text
        templates (the content-comparison safety net would also catch
        it, but explicit eviction keeps the caches from serving a doomed
        rebind and makes the invalidation observable in
        gtpu_plan_cache_events_total)."""
        self.concurrency.invalidate_table(db, name)

    def _create_table_partitioned(self, stmt: ast.CreateTable,
                                  ctx: QueryContext, rule) -> QueryResult:
        """CREATE TABLE split into one region per partition of `rule`
        (reference PARTITION ON COLUMNS, partition/src/multi_dim.rs)."""
        return self._create_table(stmt, ctx, rule=rule)

    def _create_table(self, stmt: ast.CreateTable, ctx: QueryContext,
                      rule=None) -> QueryResult:
        if rule is None and stmt.partitions:
            from greptimedb_tpu_torch.partition.rule import (
                rule_from_partition_ast,
            )

            rule = rule_from_partition_ast(stmt.partitions[0],
                                           stmt.partitions[1])
        db, name = ctx.db, stmt.name
        if "." in name:
            db, name = name.rsplit(".", 1)
        # a DROP+CREATE cycle must not serve the old table's shapes
        self._invalidate_plans(db, name)
        time_index = stmt.time_index
        pks = list(stmt.primary_keys)
        for c in stmt.columns:
            if c.is_time_index:
                time_index = c.name
            if c.is_primary_key and c.name not in pks:
                pks.append(c.name)
        if time_index is None and stmt.columns:
            raise PlanError("CREATE TABLE requires a TIME INDEX column")
        cols = []
        for c in stmt.columns:
            dtype = parse_sql_type(c.type_name)
            if c.name == time_index:
                sem = SemanticType.TIMESTAMP
            elif c.name in pks:
                sem = SemanticType.TAG
            else:
                sem = SemanticType.FIELD
            default = None
            if c.default is not None and isinstance(c.default, ast.Literal):
                default = c.default.value
            cols.append(ColumnSchema(c.name, dtype, sem, c.nullable, default))
        # the JAX engine's order: the columns validate first, then the
        # file engine, the column list, the metric engine, the partitions
        schema = Schema(cols) if stmt.columns else None
        if stmt.external or stmt.engine == "file":
            return self._create_file_table(db, name, schema, stmt)
        if schema is None:
            raise PlanError("CREATE TABLE requires a column list")
        if stmt.engine == "metric":
            return self._create_metric_table(db, name, schema, stmt)
        if rule is None and not stmt.partitions:
            rule = self._default_hash_rule(schema)
        num_regions = rule.num_regions() if rule is not None else 1
        rules_json = json.loads(rule.to_json()) if rule is not None \
            else None
        ddl = getattr(self.region_engine, "ddl_manager", None)
        if ddl is not None:
            # cluster mode: DDL is a journaled procedure across datanodes
            # (DdlManager, common/meta/src/ddl_manager.rs)
            from greptimedb_tpu_torch.meta.ddl import DdlError

            try:
                info = ddl.create_table(
                    db, name, schema, options=dict(stmt.options),
                    if_not_exists=stmt.if_not_exists,
                    num_regions=num_regions, partition_rules=rules_json,
                    column_order=[c.name for c in stmt.columns])
            except DdlError as e:
                raise PlanError(str(e)) from None
            self._open_regions.update(info.region_ids)
            return QueryResult.of_affected(0)
        existed = self.catalog.table_exists(db, name)
        info = self.catalog.create_table(
            db, name, schema, options=dict(stmt.options),
            if_not_exists=stmt.if_not_exists, num_regions=num_regions,
            partition_rules=rules_json,
            column_order=[c.name for c in stmt.columns])
        if not existed:
            for rid in info.region_ids:
                self.region_engine.create_region(rid, schema)
                self._open_regions.add(rid)
        return QueryResult.of_affected(0)

    def _default_hash_rule(self, schema):
        """[partition] default_hash_regions: cluster DDL without an
        explicit PARTITION clause spreads the new table over N hash
        partitions on the leading tag (or [partition] hash_columns), so
        ingest scatters and scans fan out without per-table ceremony.
        A standalone engine (no placement selector) keeps one region."""
        n = config.default_hash_partitions()
        if n <= 1 or not hasattr(self.region_engine, "select_node"):
            return None
        tag_names = [c.name for c in schema.tag_columns]
        cols = config.hash_partition_columns()
        cols = [c for c in cols if c in tag_names] if cols \
            else tag_names[:1]
        if not cols:
            return None
        from greptimedb_tpu_torch.partition.rule import HashPartitionRule

        return HashPartitionRule(cols, n)

    def _create_file_table(self, db, name, schema, stmt) -> QueryResult:
        """CREATE EXTERNAL TABLE: an external file as a read-only table
        (reference file-engine, src/file-engine/src/engine.rs)."""
        if self.file_engine is None:
            raise PlanError("file engine not configured")
        location = stmt.options.get("location")
        if not location:
            raise PlanError(
                "CREATE EXTERNAL TABLE requires WITH (location = '...')")
        if self.catalog.table_exists(db, name):
            if stmt.if_not_exists:
                return QueryResult.of_affected(0)
            raise CatalogError(f"table {db}.{name} already exists")
        rid, schema = self.file_engine.create_file_table(
            db, name, schema, location, stmt.options.get("format"))
        self.catalog.create_table(
            db, name, schema,
            options={**dict(stmt.options), "engine": "file"},
            if_not_exists=True,
            column_order=[c.name for c in stmt.columns] or None,
            region_ids=[rid])
        self._open_regions.add(rid)
        return QueryResult.of_affected(0)

    def _create_metric_table(self, db, name, schema: Schema,
                             stmt) -> QueryResult:
        """CREATE TABLE ... ENGINE=metric: a logical table multiplexed onto
        the shared physical region (reference metric-engine, SURVEY §2.3)."""
        if self.metric_engine is None:
            raise PlanError("metric engine not configured")
        fields = schema.field_columns
        if len(fields) != 1:
            raise PlanError(
                "metric engine tables need exactly one field column")
        if self.catalog.table_exists(db, name):
            if stmt.if_not_exists:
                return QueryResult.of_affected(0)
            raise CatalogError(f"table {db}.{name} already exists")
        meta = self.metric_engine.create_logical_table(
            db, name, [c.name for c in schema.tag_columns],
            ts_name=schema.time_index.name, value_name=fields[0].name,
        )
        self.catalog.create_table(
            db, name, schema,
            options={**dict(stmt.options), "engine": "metric"},
            if_not_exists=True,
            column_order=[c.name for c in stmt.columns] or None,
            region_ids=[meta.logical_region],
        )
        self._open_regions.add(meta.logical_region)
        return QueryResult.of_affected(0)

    def _drop_table(self, stmt: ast.DropTable,
                    ctx: QueryContext) -> QueryResult:
        db, name = ctx.db, stmt.name
        if "." in name:
            db, name = name.rsplit(".", 1)
        self._invalidate_plans(db, name)
        ddl = getattr(self.region_engine, "ddl_manager", None)
        if ddl is not None:
            # cluster mode: a journaled procedure drops the catalog entry,
            # then every region and its route
            from greptimedb_tpu_torch.meta.ddl import DdlError

            dropped = []
            if self.catalog.table_exists(db, name):
                dropped = list(self.catalog.table(db, name).region_ids)
            try:
                ddl.drop_table(db, name, if_exists=stmt.if_exists)
            except DdlError as e:
                raise PlanError(str(e)) from None
            self._open_regions.difference_update(dropped)
            return QueryResult.of_affected(0)
        if self.catalog.table_exists(db, name):
            # open first: the drop deletes the region's files on disk
            self._ensure_open(self.catalog.table(db, name))
        info = self.catalog.drop_table(db, name, stmt.if_exists)
        if info is None:
            return QueryResult.of_affected(0)
        self._open_regions.difference_update(info.region_ids)
        if info.options.get("engine") == "metric":
            # the rows stay in the shared physical region, as in JAX
            self.metric_engine.drop_logical_table(db, name)
            return QueryResult.of_affected(0)
        if info.options.get("engine") == "file":
            # the external file itself is kept
            for rid in info.region_ids:
                self.file_engine.drop_file_table(rid)
            return QueryResult.of_affected(0)
        from greptimedb_tpu_torch.maintenance.rollup import drop_companions

        for rid in info.region_ids:
            self.region_engine.drop_region(rid)
            # rollup planes die with the raw data, or substituted
            # aggregates would resurrect the dropped table's rows
            drop_companions(self.region_engine, rid)
        return QueryResult.of_affected(0)

    def _truncate(self, stmt: ast.TruncateTable,
                  ctx: QueryContext) -> QueryResult:
        """Drop the regions' data and recreate them empty."""
        from greptimedb_tpu_torch.maintenance.rollup import drop_companions

        info = self._table(stmt.name, ctx)
        self._invalidate_plans(info.db, info.name)
        engine_kind = info.options.get("engine")
        if engine_kind == "file":
            raise PlanError("file engine tables are read-only; "
                            "TRUNCATE is not supported")
        if engine_kind == "metric":
            raise PlanError("TRUNCATE is not supported on metric engine "
                            "logical tables")
        for rid in info.region_ids:
            self.region_engine.drop_region(rid)
            # coverage claims over truncated data go with it
            drop_companions(self.region_engine, rid)
            self.region_engine.create_region(rid, info.schema)
        return QueryResult.of_affected(0)

    def _alter(self, stmt: ast.AlterTable, ctx: QueryContext) -> QueryResult:
        info = self._table(stmt.name, ctx)
        self._invalidate_plans(info.db, info.name)
        if stmt.action == "add_column":
            col = stmt.column
            if col.is_time_index or col.is_primary_key:
                raise PlanError("can only ADD nullable field columns")
            default = col.default.value \
                if isinstance(col.default, ast.Literal) else None
            new_schema = Schema(list(info.schema.columns) + [ColumnSchema(
                col.name, parse_sql_type(col.type_name), SemanticType.FIELD,
                True, default)])
            self._refresh_column_order(info, added=col.name)
        elif stmt.action == "drop_column":
            dropped = info.schema.column(stmt.column_name)
            if dropped.semantic is not SemanticType.FIELD:
                raise PlanError("can only DROP field columns")
            new_schema = Schema([c for c in info.schema.columns
                                 if c.name != stmt.column_name])
            self._refresh_column_order(info, dropped=stmt.column_name)
        else:
            raise PlanError(f"unsupported ALTER action {stmt.action}")
        return self._apply_alter(info, new_schema)

    def _refresh_column_order(self, info: TableInfo,
                              added: Optional[str] = None,
                              dropped: Optional[str] = None) -> None:
        if info.column_order:
            if added:
                info.column_order = list(info.column_order) + [added]
            if dropped:
                info.column_order = [n for n in info.column_order
                                     if n != dropped]

    def _apply_alter(self, info: TableInfo,
                     new_schema: Schema) -> QueryResult:
        """Swap the table's schema in its regions and the catalog (the
        ALTER statements and the write protocols' auto-alter); in cluster
        mode a journaled AlterTableProcedure does it."""
        ddl = getattr(self.region_engine, "ddl_manager", None)
        if ddl is not None:
            from greptimedb_tpu_torch.meta.ddl import DdlError

            try:
                ddl.alter_table(info.db, info.name, new_schema,
                                info.region_ids,
                                column_order=info.column_order,
                                old_schema=info.schema)
            except DdlError as e:
                raise PlanError(str(e)) from None
            return QueryResult.of_affected(0)
        for rid in info.region_ids:
            self.region_engine.alter_region_schema(rid, new_schema)
        info.schema = new_schema
        self.catalog.update_table(info)
        return QueryResult.of_affected(0)

    #: ADMIN fn name -> maintenance job kind (the async job-id flow)
    _ADMIN_JOBS = {"flush_table": "flush", "compact_table": "compact",
                   "rollup_table": "rollup", "expire_table": "expire"}

    def _admin(self, stmt: ast.AdminFunc, ctx: QueryContext) -> QueryResult:
        """The JAX engine's dispatch. With the maintenance plane,
        flush_table / compact_table / rollup_table / expire_table submit
        a job a region and return the job ids (manual compaction is a
        full merge), flush_region / compact_region one job, and
        maintenance_status(job_id) reports one job. Without it
        (`maintenance_workers=0`), flushes and compactions run
        synchronously and return 0 affected rows, and the rollup,
        expiry and status functions raise the JAX PlanError.
        flush_flow(name) ticks the named flow now and returns the rows it
        upserted; any other name is the JAX PlanError."""
        from greptimedb_tpu_torch.maintenance import parse_duration_ms

        fn = stmt.func
        args = [a.value if isinstance(a, ast.Literal) else None
                for a in fn.args]
        maint = self.region_engine.maintenance
        if fn.name == "flush_flow":
            # tick the named flow now (reference flow flush admin fn,
            # common/function/src/flush_flow.rs)
            try:
                n = self.flow_engine.flush(str(args[0]), ctx.db)
            except KeyError as e:
                raise PlanError(str(e)) from None
            return QueryResult.of_affected(n)
        if fn.name in self._ADMIN_JOBS:
            if not fn.args or not isinstance(fn.args[0], ast.Literal):
                raise PlanError(f"ADMIN {fn.name} takes a table name")
            info = self._table(str(args[0]), ctx)
            kind = self._ADMIN_JOBS[fn.name]
            if maint is None:
                # no plane: flush and compact keep their synchronous shape
                if kind == "flush":
                    for rid in info.region_ids:
                        self.region_engine.flush(rid)
                elif kind == "compact":
                    for rid in info.region_ids:
                        self.region_engine.compact(rid)
                else:
                    raise PlanError(
                        f"{fn.name} needs the maintenance plane "
                        "(engine.maintenance_workers > 0)")
                return QueryResult.of_affected(0)
            params: dict = {}
            if kind == "compact":
                # manual compaction is a full merge; background TWCS
                # stays windowed
                params["strategy"] = "full"
            if kind == "rollup":
                res_ms = parse_duration_ms(args[1]) if len(args) > 1 \
                    else (maint.rollup_rules[0].resolution_ms
                          if maint.rollup_rules else 60_000)
                maint.rule_for(res_ms)  # register ad-hoc resolutions
                params["resolution"] = res_ms
            elif kind == "expire" and len(args) > 1:
                params["ttl_ms"] = parse_duration_ms(args[1])
            job_ids = [maint.submit(kind, rid, params).job_id
                       for rid in info.region_ids]
            return QueryResult(["job_id"], [DataType.INT64],
                               [np.asarray(job_ids, dtype=np.int64)])
        if fn.name == "maintenance_status":
            if maint is None:
                raise PlanError("maintenance plane is disabled")
            job = maint.job(int(args[0]))
            if job is None:
                raise PlanError(f"unknown maintenance job {args[0]}")
            d = job.to_dict()
            names = ["job_id", "kind", "region_id", "state", "error",
                     "duration_ms", "detail"]
            dtypes = [DataType.INT64, DataType.STRING, DataType.INT64,
                      DataType.STRING, DataType.STRING, DataType.FLOAT64,
                      DataType.STRING]
            cols = [np.asarray([d["job_id"]], dtype=np.int64),
                    np.asarray([d["kind"]], dtype=object),
                    np.asarray([d["region_id"]], dtype=np.int64),
                    np.asarray([d["state"]], dtype=object),
                    np.asarray([d["error"]], dtype=object),
                    np.asarray([d["duration_ms"] if d["duration_ms"]
                                is not None else np.nan]),
                    np.asarray([json.dumps(d["detail"], sort_keys=True)],
                               dtype=object)]
            return QueryResult(names, dtypes, cols)
        if fn.name in ("flush_region", "compact_region"):
            rid = int(args[0])
            if maint is not None:
                kind = "flush" if fn.name == "flush_region" else "compact"
                job = maint.submit(kind, rid)
                return QueryResult(["job_id"], [DataType.INT64],
                                   [np.asarray([job.job_id],
                                               dtype=np.int64)])
            if fn.name == "flush_region":
                self.region_engine.flush(rid)
            else:
                self.region_engine.compact(rid)
            return QueryResult.of_affected(0)
        raise PlanError(f"unknown admin function {fn.name!r}")

    # ---- DELETE ------------------------------------------------------------

    def _delete(self, stmt: ast.Delete, ctx: QueryContext) -> QueryResult:
        """Tombstones for the (tags, ts) keys of the rows WHERE selects."""
        info = self._table(stmt.table, ctx)
        schema = info.schema
        key_cols = [c.name for c in schema.tag_columns] \
            + [schema.time_index.name]
        sel = ast.Select(items=[ast.SelectItem(ast.Column(n))
                                for n in key_cols],
                         table=stmt.table, where=stmt.where)
        rows = self._select(sel, ctx)
        n = rows.num_rows
        if n == 0:
            return QueryResult.of_affected(0)
        got = dict(zip(rows.names, rows.columns))
        cols: dict = {}
        for c in schema.columns:
            if c.name in got:
                cols[c.name] = DictVector.encode(list(got[c.name])) \
                    if c.semantic is SemanticType.TAG \
                    else np.asarray(got[c.name], dtype=np.int64)
            elif c.dtype.is_float:
                cols[c.name] = np.full(n, np.nan, dtype=c.dtype.to_numpy())
            elif c.dtype.is_string:
                cols[c.name] = DictVector.encode([None] * n)
            else:
                cols[c.name] = np.zeros(n, dtype=c.dtype.to_numpy())
        return QueryResult.of_affected(self._sharded_write(
            info, RecordBatch(schema, cols), delete=True))

    def _copy_table(self, stmt: ast.CopyTable,
                    ctx: QueryContext) -> QueryResult:
        """COPY <table> TO / FROM '<path>' (reference operator/src/
        statement/copy_table_{to,from}.rs): TO writes SELECT * of the
        table, FROM inserts the file's columns by name."""
        from greptimedb_tpu_torch import datasource
        from greptimedb_tpu_torch.datasource import convert

        if stmt.direction == "to":
            sel = ast.Select(items=[ast.SelectItem(ast.Star())],
                             table=stmt.table)
            result = self._select(sel, ctx)
            n = datasource.write_file(convert.result_to_table(result),
                                      stmt.path, stmt.options.get("format"))
            return QueryResult.of_affected(n)
        t = datasource.read_file(stmt.path, stmt.options.get("format"))
        return QueryResult.of_affected(
            convert.insert_table(self, stmt.table, t, ctx))

    def _copy_database(self, stmt: ast.CopyDatabase,
                       ctx: QueryContext) -> QueryResult:
        """COPY DATABASE TO / FROM '<dir>': one file a table, Parquet
        unless WITH (format = ...) says otherwise (reference operator/src/
        statement/copy_database.rs). FROM loads each file whose base name
        is a table of the database."""
        from greptimedb_tpu_torch import datasource

        db = stmt.database
        fmt = stmt.options.get("format", "parquet")
        dctx = ctx.with_db(db)
        total = 0
        if stmt.direction == "to":
            os.makedirs(stmt.path, exist_ok=True)
            for name in self.catalog.list_tables(db):
                sub = ast.CopyTable(
                    name, "to", os.path.join(stmt.path, f"{name}.{fmt}"),
                    dict(stmt.options))
                total += self._copy_table(sub, dctx).affected_rows
            return QueryResult.of_affected(total)
        for fname in sorted(os.listdir(stmt.path)):
            base, ext = os.path.splitext(fname)
            ext = ext.lstrip(".").lower()
            if ext in ("ndjson", "jsonl"):
                ext = "json"
            if ext not in datasource.FORMATS:
                continue
            if not self.catalog.table_exists(db, base):
                continue
            sub = ast.CopyTable(base, "from", os.path.join(stmt.path, fname),
                                dict(stmt.options))
            total += self._copy_table(sub, dctx).affected_rows
        return QueryResult.of_affected(total)

    def _sharded_write(self, info: TableInfo, batch: RecordBatch,
                       delete: bool) -> int:
        """Row-to-region scatter through the table's partition rule
        (reference operator/src/insert.rs:114-118 and
        partition/src/splitter.rs): every write of SQL, the write
        protocols, COPY FROM and the flow sinks lands here."""
        write = self.region_engine.delete if delete \
            else self.region_engine.put
        if len(info.region_ids) == 1 or not info.partition_rules:
            return write(info.region_ids[0], batch)
        rule = _cached_rule(info)
        cols = []
        for cname in rule.columns:
            col = batch.columns[cname]
            cols.append(col.decode() if hasattr(col, "decode")
                        else np.asarray(col))
        n = 0
        for region_idx, rows in rule.split(cols,
                                           n_rows=batch.num_rows).items():
            part = batch.take(rows)
            # each slice's tag dictionaries shrink to the values its rows
            # use: take() keeps the whole batch's dictionary, and every
            # region's tag registry would otherwise learn every other
            # region's series (lastpoint's newest-first stop then waits
            # for series that never come)
            part = RecordBatch(part.schema, {
                name: (col.compact() if isinstance(col, DictVector)
                       else col)
                for name, col in part.columns.items()})
            n += write(info.region_ids[region_idx], part)
        return n

    # ---- INSERT ------------------------------------------------------------

    def _insert(self, stmt: ast.Insert, ctx: QueryContext) -> QueryResult:
        info = self._table(stmt.table, ctx)
        schema = info.schema
        if stmt.select is not None:
            return self._insert_select(stmt, info, ctx)
        # positional VALUES bind in the user-declared column order
        col_names = stmt.columns or info.column_order or schema.names
        unknown = set(col_names) - set(schema.names)
        if unknown:
            raise PlanError(f"unknown insert columns {sorted(unknown)}")
        ncols = len(col_names)
        cv = stmt.columnar_values
        if cv is not None:
            if len(cv) != ncols:
                raise PlanError("INSERT row arity mismatch")
            nrows = len(cv[0]) if cv else 0
            by_col = dict(zip(col_names, cv))
        else:
            nrows = len(stmt.rows)
            by_col = {n: [] for n in col_names}
            for row in stmt.rows:
                if len(row) != ncols:
                    raise PlanError("INSERT row arity mismatch")
                for n, e in zip(col_names, row):
                    v = e.value if isinstance(e, ast.Literal) \
                        else eval_host(e, {}, schema, None)
                    by_col[n].append(None if _is_nan_scalar(v) else v)
        batch = values_batch(schema, by_col, nrows)
        return QueryResult.of_affected(
            self._sharded_write(info, batch, delete=False))

    def _insert_select(self, stmt: ast.Insert, info: TableInfo,
                       ctx: QueryContext) -> QueryResult:
        """INSERT ... SELECT: run the query and bind its columns
        positionally to the target list, with the coercions of the JAX
        engine's Arrow round trip (result_to_table, then
        insert_arrow_table) done on the numpy columns: timestamps to the
        time index's unit, strings to dictionaries, absent columns to
        their defaults. The rows go through the WAL as any INSERT."""
        schema = info.schema
        sub = self._select(stmt.select, ctx)
        target_cols = stmt.columns or info.column_order or schema.names
        unknown_t = set(target_cols) - set(schema.names)
        if unknown_t:
            raise PlanError(f"unknown insert columns {sorted(unknown_t)}")
        if len(sub.names) != len(target_cols):
            raise PlanError(
                f"INSERT ... SELECT: {len(sub.names)} source columns "
                f"for {len(target_cols)} target columns")
        nrows = sub.num_rows
        src = {}
        for name, dt, col in zip(target_cols, sub.dtypes, sub.columns):
            col = np.asarray(col)
            src[name] = (dt or DataType.from_numpy(col.dtype), col)
        cols: dict = {}
        for c in schema.columns:
            dt, col = src.get(c.name, (None, None))
            if dt is not None and dt.is_timestamp and c.dtype.is_timestamp:
                # unit to unit, flooring as the datetime round trip does
                cols[c.name] = (col.astype(np.int64)
                                * dt.time_unit.nanos_per_unit
                                // c.dtype.time_unit.nanos_per_unit)
                continue
            vals = [c.default] * nrows if dt is None \
                else _arrow_values(dt, col)
            if c.semantic is SemanticType.TAG or c.dtype.is_string:
                cols[c.name] = DictVector.encode(
                    [None if v is None else str(v) for v in vals])
            elif c.dtype.is_timestamp:
                if any(v is None for v in vals):
                    raise PlanError(f"time index {c.name} cannot be NULL")
                cols[c.name] = np.asarray(
                    [ts_util.coerce_ts_literal(v, c.dtype) for v in vals],
                    dtype=np.int64)
            elif c.dtype.is_float:
                cols[c.name] = np.asarray(
                    [np.nan if v is None else float(v) for v in vals],
                    dtype=c.dtype.to_numpy())
            elif c.dtype is DataType.BOOL:
                cols[c.name] = np.asarray(
                    [False if v is None else bool(v) for v in vals])
            else:
                cols[c.name] = np.asarray(
                    [0 if v is None else int(v) for v in vals],
                    dtype=c.dtype.to_numpy())
        return QueryResult.of_affected(self._sharded_write(
            info, RecordBatch(schema, cols), delete=False))


def _arrow_values(dt: DataType, col: np.ndarray) -> list:
    """A result column as the Python values an Arrow array of `dt` gives
    back (`to_pylist`): naive UTC datetimes for timestamps, strings for
    strings, plain numbers otherwise."""
    if dt.is_timestamp:
        per = dt.time_unit.nanos_per_unit
        epoch = datetime.datetime(1970, 1, 1)
        return [None if v is None else
                epoch + datetime.timedelta(microseconds=int(v) * per // 1000)
                for v in col.tolist()]
    if dt.is_string:
        return [None if v is None else str(v) for v in col.tolist()]
    return col.tolist()


def _explain_promql(node, indent: int = 0) -> str:
    """The PromQL AST as an operator tree (the evaluation tree is the
    plan)."""
    from greptimedb_tpu_torch.promql import parser as pp

    pad = "  " * indent
    if isinstance(node, pp.VectorSelector):
        parts = [node.metric or ""]
        if node.matchers:
            parts.append("{" + ",".join(
                f"{m.label}{m.op}{m.value!r}" for m in node.matchers) + "}")
        if node.range_s:
            parts.append(f"[{node.range_s:g}s]")
        if node.offset_s:
            parts.append(f" offset {node.offset_s:g}s")
        if node.at_s is not None:
            parts.append(f" @ {node.at_s}")
        return f"{pad}Selector: {''.join(parts)}"
    if isinstance(node, pp.NumberLiteral):
        return f"{pad}Number: {node.value:g}"
    if isinstance(node, pp.StringLiteral):
        return f"{pad}String: {node.value!r}"
    if isinstance(node, pp.Call):
        inner = "\n".join(_explain_promql(a, indent + 1)
                          for a in node.args)
        return f"{pad}Call: {node.func}" + ("\n" + inner if inner else "")
    if isinstance(node, pp.Aggregate):
        mods = ""
        if node.by:
            mods = f" by ({', '.join(node.by)})"
        elif node.without:
            mods = f" without ({', '.join(node.without)})"
        head = f"{pad}Aggregate: {node.op}{mods}"
        if node.param is not None:
            head += "\n" + _explain_promql(node.param, indent + 1)
        return head + "\n" + _explain_promql(node.expr, indent + 1)
    if isinstance(node, pp.Binary):
        return (f"{pad}Binary: {node.op}\n"
                + _explain_promql(node.lhs, indent + 1) + "\n"
                + _explain_promql(node.rhs, indent + 1))
    if isinstance(node, pp.Subquery):
        return (f"{pad}Subquery: [{node.range_s:g}s:"
                f"{node.step_s or ''}]"
                + "\n" + _explain_promql(node.expr, indent + 1))
    if isinstance(node, pp.Unary):
        return f"{pad}Unary: {node.op}\n" + _explain_promql(node.expr,
                                                            indent + 1)
    return f"{pad}{type(node).__name__}"


def values_batch(schema: Schema, by_col: dict, nrows: int) -> RecordBatch:
    """Raw VALUES columns -> one RecordBatch, with the JAX package's
    per-dtype conversions (ingest.py::sql_values_batch); naive timestamp
    strings coerce in the session timezone."""
    cols: dict = {}
    for c in schema.columns:
        vals = by_col.get(c.name)
        if vals is None:
            vals = [c.default] * nrows
        if c.semantic is SemanticType.TAG or c.dtype.is_string:
            cols[c.name] = DictVector.encode(
                [None if v is None else str(v) for v in vals])
        elif c.dtype.is_timestamp:
            if any(v is None for v in vals):
                raise PlanError(f"time index {c.name} cannot be NULL")
            cols[c.name] = np.asarray(
                [v if type(v) is int else coerce_ts_literal(v, c.dtype)
                 for v in vals], dtype=np.int64)
        elif c.dtype.is_float:
            cols[c.name] = np.asarray(
                [np.nan if v is None else float(v) for v in vals],
                dtype=c.dtype.to_numpy())
        elif c.dtype is DataType.BOOL:
            cols[c.name] = np.asarray(
                [False if v is None else bool(v) for v in vals])
        else:
            cols[c.name] = np.asarray(
                [0 if v is None else int(v) for v in vals],
                dtype=c.dtype.to_numpy())
    return RecordBatch(schema, cols)


def _subst_expr(e, ctx: QueryContext):
    """Replace session-dependent zero-arg functions (database(),
    timezone()) with literals before planning."""
    if isinstance(e, ast.FuncCall):
        if e.name in ("database", "current_schema", "schema"):
            return ast.Literal(ctx.db)
        if e.name == "timezone":
            return ast.Literal(ctx.timezone)
    if not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Expr):
            nv = _subst_expr(v, ctx)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, (tuple, list)) and any(
                isinstance(x, ast.Expr) for x in v):
            nv = type(v)(_subst_expr(x, ctx) if isinstance(x, ast.Expr)
                         else x for x in v)
            changes[f.name] = nv
    return dataclasses.replace(e, **changes) if changes else e


def _subst_session_funcs(sel: ast.Select, ctx: QueryContext) -> ast.Select:
    items = [dataclasses.replace(it, expr=_subst_expr(it.expr, ctx))
             for it in sel.items]
    return dataclasses.replace(sel, items=items)


def _render_type(dt: DataType) -> str:
    if dt.is_timestamp:
        return {"s": "TIMESTAMP(0)", "ms": "TIMESTAMP(3)",
                "us": "TIMESTAMP(6)",
                "ns": "TIMESTAMP(9)"}[dt.time_unit.value]
    return dt.value.upper()


def _is_nan_scalar(v) -> bool:
    return isinstance(v, float) and v != v


def _rewrite_tree(e, leaf):
    """Generic expression rewrite: `leaf(node)` returns a replacement or
    NotImplemented to descend. Descends containers and any
    expression-carrying dataclass (incl. non-Expr carriers like
    WindowSpec) but never into embedded statements."""
    out = leaf(e)
    if out is not NotImplemented:
        return out
    if isinstance(e, (list, tuple)):
        return type(e)(_rewrite_tree(x, leaf) for x in e)
    if dataclasses.is_dataclass(e) and not isinstance(e, type) \
            and not isinstance(e, ast.Statement):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)) or (
                    dataclasses.is_dataclass(v)
                    and not isinstance(v, (type, ast.Statement))):
                nv = _rewrite_tree(v, leaf)
                if nv != v:
                    changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e
    return e


def _expr_has_subquery(e) -> bool:
    if isinstance(e, ast.Subquery):
        return True
    if isinstance(e, (list, tuple)):
        return any(_expr_has_subquery(x) for x in e)
    if dataclasses.is_dataclass(e) and not isinstance(e, type) \
            and isinstance(e, ast.Expr):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)) \
                    and _expr_has_subquery(v):
                return True
    return False


def _has_subquery(sel: ast.Select) -> bool:
    if any(_expr_has_subquery(it.expr) for it in sel.items):
        return True
    for e in (sel.where, sel.having):
        if e is not None and _expr_has_subquery(e):
            return True
    if any(_expr_has_subquery(g) for g in sel.group_by):
        return True
    if any(_expr_has_subquery(ob.expr) for ob in sel.order_by):
        return True
    return any(j.on is not None and _expr_has_subquery(j.on)
               for j in sel.joins)


def _cached_rule(info: TableInfo):
    """The table's partition rule, parsed once and memoized on the
    TableInfo (the catalog stores its JSON form)."""
    from greptimedb_tpu_torch.partition.rule import (
        PartitionRule,
        rule_from_json,
    )

    rule = info.__dict__.get("_rule_cache")
    if rule is None:
        rule = info.partition_rules \
            if isinstance(info.partition_rules, PartitionRule) \
            else rule_from_json(info.partition_rules)
        info.__dict__["_rule_cache"] = rule
    return rule
