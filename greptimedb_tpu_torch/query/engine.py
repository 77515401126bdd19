"""QueryEngine of the port (lean counterpart of
greptimedb_tpu/query/engine.py).

SQL text -> statements -> CREATE TABLE / INSERT ... VALUES / SELECT /
DROP TABLE over the in-memory region engine, with SELECT planned by the
copied planner and executed by the torch physical layer on the engine's
device. Every other statement raises UnsupportedStatement naming the
slice of the port that brings it.
"""

from __future__ import annotations

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
from greptimedb_tpu_torch.query.physical import PhysicalExecutor
from greptimedb_tpu_torch.query.planner import plan_select
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast, parse_sql
from greptimedb_tpu_torch.storage.engine import RegionEngine
from greptimedb_tpu_torch.utils.time import coerce_ts_literal

# statements of the JAX engine this slice leaves out, by the later slice
# of the port that brings them (ROADMAP.md, queue A)
_LATER = {
    "Tql": "PromQL",
    "AlterTable": "durable storage",
    "TruncateTable": "durable storage",
    "AdminFunc": "durable storage",
    "CopyTable": "durable storage",
    "CopyDatabase": "durable storage",
    "Delete": "durable storage",
    "CreateFlow": "servers and CLI",
    "DropFlow": "servers and CLI",
    "ShowFlows": "servers and CLI",
}


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
        name = type(stmt).__name__
        slice_name = _LATER.get(name, "servers and CLI")
        raise UnsupportedStatement(
            f"{name} is not in this slice of greptimedb_tpu_torch; the "
            f"{slice_name} slice brings it")

    # ---- SELECT ------------------------------------------------------------

    def _table(self, name: str, db: str) -> TableInfo:
        if "." in name:
            prefix, rest = name.rsplit(".", 1)
            if self.catalog.database_exists(prefix):
                db, name = prefix, rest
        return self.catalog.table(db, name)

    def _select(self, sel: ast.Select, db: str) -> QueryResult:
        if sel.ctes or sel.joins or sel.from_subquery is not None \
                or sel.align is not None:
            raise UnsupportedStatement(
                "CTEs, joins, derived tables and RANGE ... ALIGN are not in "
                "this slice of greptimedb_tpu_torch")
        if sel.table is None:
            names, cols = [], []
            for i, it in enumerate(sel.items):
                v = eval_host(it.expr, {}, None, None)
                cols.append(np.asarray([v]) if np.ndim(v) == 0
                            else np.asarray(v))
                names.append(it.alias or f"column{i}")
            return QueryResult(names, [None] * len(names), cols)
        info = self._table(sel.table, db)
        return self.executor.execute(plan_select(sel, info))

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
        info = self.catalog.drop_table(db, name, stmt.if_exists)
        if info is None:
            return QueryResult.of_affected(0)
        for rid in info.region_ids:
            self.region_engine.drop_region(rid)
            self.executor.cache.invalidate_region(rid)
        return QueryResult.of_affected(0)

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
