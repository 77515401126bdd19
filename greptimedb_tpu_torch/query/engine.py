"""QueryEngine of the port (lean counterpart of
greptimedb_tpu/query/engine.py).

SQL text -> statements over the durable region engine: CREATE TABLE,
INSERT ... VALUES, SELECT, DELETE, DROP and TRUNCATE TABLE, ALTER TABLE
ADD/DROP COLUMN, ADMIN flush_table / compact_table (synchronous: the
maintenance plane is a later slice), and TQL EVAL / TQL EXPLAIN (PromQL,
promql/engine.py). SELECT is planned by the copied planner and executed
by the torch physical layer on the engine's device; SELECT ... RANGE ...
ALIGN goes to query/range_select.py. Regions open lazily
from the catalog on first use, so a persisted catalog and a reopened
storage engine serve the tables they held. Every other statement raises
UnsupportedStatement naming the slice of the port that brings it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from greptimedb_tpu_torch import config
from greptimedb_tpu_torch.catalog.catalog import Catalog, TableInfo
from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import (
    DataType,
    SemanticType,
    parse_sql_type,
)
from greptimedb_tpu_torch.datatypes.vector import DictVector
from greptimedb_tpu_torch.query.expr import PlanError, eval_host
from greptimedb_tpu_torch.query import range_select as rs
from greptimedb_tpu_torch.query.physical import PhysicalExecutor
from greptimedb_tpu_torch.query.planner import plan_select
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast, parse_sql
from greptimedb_tpu_torch.storage.engine import RegionEngine
from greptimedb_tpu_torch.utils.time import coerce_ts_literal

# the later slice of the port that brings the host-side SQL the JAX
# engine answers: subqueries, window functions, UNION, views, SHOW,
# DESCRIBE, EXPLAIN, information_schema (ROADMAP.md, A13)
_HOST_SQL = "host SQL surface (ROADMAP A13)"

# statements of the JAX engine this slice leaves out, by the later slice
# of the port that brings them (ROADMAP.md, queue A)
_LATER = {
    # COPY reads and writes Parquet/CSV files
    "CopyTable": "COPY import and export",
    "CopyDatabase": "COPY import and export",
    "CreateFlow": "servers and CLI",
    "DropFlow": "servers and CLI",
    "ShowFlows": "servers and CLI",
    **{name: _HOST_SQL for name in (
        "Union", "ShowTables", "ShowDatabases", "ShowCreateTable",
        "DescribeTable", "CreateDatabase", "Use", "SetVar", "CreateView",
        "DropView", "ShowViews")},
}


def _ast_nodes(obj):
    """Every AST node reachable from `obj` (expressions, window specs,
    select items), not descending into a subquery's statement."""
    if isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _ast_nodes(x)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        yield obj
        if not isinstance(obj, ast.Subquery):
            for f in dataclasses.fields(obj):
                yield from _ast_nodes(getattr(obj, f.name))


class UnsupportedStatement(PlanError):
    """A statement the JAX engine runs that this slice of the port does
    not; the message names the slice that brings it."""


class QueryEngine:
    def __init__(self, catalog: Catalog, region_engine: RegionEngine,
                 device=None):
        self.catalog = catalog
        self.region_engine = region_engine
        self.device = config.device(device)
        self.executor = PhysicalExecutor(region_engine, self.device)

    # ---- entry points ------------------------------------------------------

    def execute_sql(self, sql: str, db: str = "public") -> list[QueryResult]:
        self.executor.last_path = None
        self.executor.last_partial_stats = None
        self.executor.last_sparse_stats = None
        self.executor.last_stream_stats = None
        return [self.execute_statement(s, db) for s in parse_sql(sql)]

    def execute_one(self, sql: str, db: str = "public") -> QueryResult:
        results = self.execute_sql(sql, db)
        if not results:
            raise PlanError("empty statement")
        return results[-1]

    def execute_statement(self, stmt: ast.Statement,
                          db: str = "public") -> QueryResult:
        if isinstance(stmt, ast.Select):
            return self._select(stmt, db)
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt, db)
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt, db)
        if isinstance(stmt, ast.DropTable):
            return self._drop_table(stmt, db)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt, db)
        if isinstance(stmt, ast.TruncateTable):
            return self._truncate(stmt, db)
        if isinstance(stmt, ast.AlterTable):
            return self._alter(stmt, db)
        if isinstance(stmt, ast.AdminFunc):
            return self._admin(stmt, db)
        if isinstance(stmt, ast.Tql):
            return self._tql(stmt, db)
        name = type(stmt).__name__
        slice_name = _LATER.get(name, "servers and CLI")
        if isinstance(stmt, ast.Explain) and not stmt.analyze:
            # EXPLAIN ANALYZE needs the tracing spans (servers and CLI)
            slice_name = _HOST_SQL
        raise UnsupportedStatement(
            f"{name} is not in this slice of greptimedb_tpu_torch; the "
            f"{slice_name} slice brings it")

    # ---- SELECT ------------------------------------------------------------

    def _table(self, name: str, db: str) -> TableInfo:
        if "." in name:
            prefix, rest = name.rsplit(".", 1)
            if self.catalog.database_exists(prefix):
                db, name = prefix, rest
        info = self.catalog.table(db, name)
        self._ensure_open(info)
        return info

    def _ensure_open(self, info: TableInfo) -> None:
        """Open the table's regions from disk on first use (a catalog
        that outlived the storage engine's process)."""
        for rid in info.region_ids:
            if rid not in self.region_engine.regions:
                self.region_engine.open_region(rid)

    def _select(self, sel: ast.Select, db: str) -> QueryResult:
        if sel.ctes or sel.joins or sel.from_subquery is not None:
            raise UnsupportedStatement(
                "CTEs, joins and derived tables are not in this slice of "
                "greptimedb_tpu_torch")
        nodes = list(_ast_nodes(sel))
        for what, hit in (
                ("window functions (OVER)", any(
                    isinstance(n, ast.WindowSpec) for n in nodes)),
                ("subqueries", any(isinstance(n, ast.Subquery)
                                   for n in nodes)),
                ("information_schema tables", sel.table is not None and
                 "information_schema" in sel.table.lower().split(".")[:-1])):
            if hit:
                raise UnsupportedStatement(
                    f"{what} are not in this slice of greptimedb_tpu_torch; "
                    f"the {_HOST_SQL} slice brings them")
        if sel.table is None:
            names, cols = [], []
            for i, it in enumerate(sel.items):
                v = eval_host(it.expr, {}, None, None)
                cols.append(np.asarray([v]) if np.ndim(v) == 0
                            else np.asarray(v))
                names.append(it.alias or f"column{i}")
            return QueryResult(names, [None] * len(names), cols)
        info = self._table(sel.table, db)
        if rs.is_range_select(sel):
            return rs.execute_range_select(self.executor,
                                           rs.plan_range_select(sel, info))
        return self.executor.execute(plan_select(sel, info))

    # ---- TQL ---------------------------------------------------------------

    def _tql(self, stmt: ast.Tql, db: str) -> QueryResult:
        """TQL EVAL: the PromQL range query on this engine's device, in
        the long table format; TQL EXPLAIN: the parsed PromQL tree."""
        from greptimedb_tpu_torch.promql.engine import PromqlEngine
        from greptimedb_tpu_torch.promql.parser import parse_promql

        if stmt.analyze:
            raise UnsupportedStatement(
                "TQL ANALYZE is not in this slice of greptimedb_tpu_torch; "
                "the servers and CLI slice brings EXPLAIN ANALYZE")
        if stmt.explain:
            lines = [f"PromQL: {stmt.query}",
                     _explain_promql(parse_promql(stmt.query))]
            return QueryResult(["plan"], [DataType.STRING],
                               [np.asarray(lines, dtype=object)])
        return PromqlEngine(self).eval_range(stmt.query, stmt.start,
                                             stmt.end, stmt.step, db)

    # ---- DDL ---------------------------------------------------------------

    def _create_table(self, stmt: ast.CreateTable, db: str) -> QueryResult:
        if stmt.partitions or stmt.external or stmt.engine not in (
                "mito", None):
            raise UnsupportedStatement(
                "partitioned, external and metric-engine tables are not in "
                "this slice of greptimedb_tpu_torch")
        name = stmt.name
        if "." in name:
            db, name = name.rsplit(".", 1)
        time_index = stmt.time_index
        pks = list(stmt.primary_keys)
        for c in stmt.columns:
            if c.is_time_index:
                time_index = c.name
            if c.is_primary_key and c.name not in pks:
                pks.append(c.name)
        if not stmt.columns:
            raise PlanError("CREATE TABLE requires a column list")
        if time_index is None:
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
        schema = Schema(cols)
        existed = self.catalog.table_exists(db, name)
        info = self.catalog.create_table(
            db, name, schema, options=dict(stmt.options),
            if_not_exists=stmt.if_not_exists,
            column_order=[c.name for c in stmt.columns])
        if not existed:
            for rid in info.region_ids:
                self.region_engine.create_region(rid, schema)
        return QueryResult.of_affected(0)

    def _drop_table(self, stmt: ast.DropTable, db: str) -> QueryResult:
        name = stmt.name
        if "." in name:
            db, name = name.rsplit(".", 1)
        if self.catalog.table_exists(db, name):
            # open first: the drop deletes the region's files on disk
            self._ensure_open(self.catalog.table(db, name))
        info = self.catalog.drop_table(db, name, stmt.if_exists)
        if info is None:
            return QueryResult.of_affected(0)
        for rid in info.region_ids:
            self.region_engine.drop_region(rid)
        return QueryResult.of_affected(0)

    def _truncate(self, stmt: ast.TruncateTable, db: str) -> QueryResult:
        """Drop the regions' data and recreate them empty."""
        info = self._table(stmt.name, db)
        for rid in info.region_ids:
            self.region_engine.drop_region(rid)
            self.region_engine.create_region(rid, info.schema)
        return QueryResult.of_affected(0)

    def _alter(self, stmt: ast.AlterTable, db: str) -> QueryResult:
        info = self._table(stmt.name, db)
        if stmt.action == "add_column":
            col = stmt.column
            if col.is_time_index or col.is_primary_key:
                raise PlanError("can only ADD nullable field columns")
            default = col.default.value \
                if isinstance(col.default, ast.Literal) else None
            new_schema = Schema(list(info.schema.columns) + [ColumnSchema(
                col.name, parse_sql_type(col.type_name), SemanticType.FIELD,
                True, default)])
            if info.column_order:
                info.column_order = list(info.column_order) + [col.name]
        elif stmt.action == "drop_column":
            dropped = info.schema.column(stmt.column_name)
            if dropped.semantic is not SemanticType.FIELD:
                raise PlanError("can only DROP field columns")
            new_schema = Schema([c for c in info.schema.columns
                                 if c.name != stmt.column_name])
            if info.column_order:
                info.column_order = [n for n in info.column_order
                                     if n != stmt.column_name]
        else:
            raise PlanError(f"unsupported ALTER action {stmt.action}")
        for rid in info.region_ids:
            self.region_engine.alter_region_schema(rid, new_schema)
        info.schema = new_schema
        self.catalog.update_table(info)
        return QueryResult.of_affected(0)

    def _admin(self, stmt: ast.AdminFunc, db: str) -> QueryResult:
        """ADMIN flush_table / compact_table, run synchronously; the
        manual compaction is a full merge."""
        fn = stmt.func
        if fn.name not in ("flush_table", "compact_table"):
            raise UnsupportedStatement(
                f"ADMIN {fn.name} is not in this slice of "
                "greptimedb_tpu_torch; the maintenance plane brings it")
        if not fn.args or not isinstance(fn.args[0], ast.Literal):
            raise PlanError(f"ADMIN {fn.name} takes a table name")
        info = self._table(str(fn.args[0].value), db)
        for rid in info.region_ids:
            if fn.name == "flush_table":
                self.region_engine.flush(rid)
            else:
                self.region_engine.compact(rid)
        return QueryResult.of_affected(0)

    # ---- DELETE ------------------------------------------------------------

    def _delete(self, stmt: ast.Delete, db: str) -> QueryResult:
        """Tombstones for the (tags, ts) keys of the rows WHERE selects."""
        info = self._table(stmt.table, db)
        schema = info.schema
        key_cols = [c.name for c in schema.tag_columns] \
            + [schema.time_index.name]
        sel = ast.Select(items=[ast.SelectItem(ast.Column(n))
                                for n in key_cols],
                         table=stmt.table, where=stmt.where)
        rows = self._select(sel, db)
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
        return QueryResult.of_affected(self.region_engine.delete(
            info.region_ids[0], RecordBatch(schema, cols)))

    # ---- INSERT ------------------------------------------------------------

    def _insert(self, stmt: ast.Insert, db: str) -> QueryResult:
        if stmt.select is not None:
            raise UnsupportedStatement(
                "INSERT ... SELECT is not in this slice of "
                "greptimedb_tpu_torch")
        info = self._table(stmt.table, db)
        schema = info.schema
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
            self.region_engine.put(info.region_ids[0], batch))


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
    per-dtype conversions (ingest.py::sql_values_batch)."""
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


def _is_nan_scalar(v) -> bool:
    return isinstance(v, float) and v != v
