"""`information_schema` virtual tables of the port (copy of
greptimedb_tpu/catalog/information_schema.py; mirrors reference
src/catalog/src/information_schema/*.rs).

The catalog-backed tables (schemata, tables, columns, engines, views,
key_column_usage, table_constraints, character_sets, collations,
build_info) materialize from catalog state at query time as host-side
column dicts; a small host evaluator applies WHERE / projection / ORDER
BY / LIMIT (these tables are tiny — no device round-trip). build_info
reports this package's version. The runtime tables are listed, as the
JAX package lists them, but reading one raises UnsupportedStatement
naming the later slice of the port that brings its plane.
"""

from __future__ import annotations

import time

import numpy as np

from greptimedb_tpu_torch.datatypes.types import DataType
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast

INFORMATION_SCHEMA = "information_schema"

_START_TIME = time.time()

#: virtual table name -> builder(qe, ctx) -> dict[col -> list]
_TABLES = {}


def _virtual(name):
    def deco(fn):
        _TABLES[name] = fn
        return fn
    return deco


def is_information_schema_query(table: str, db: str) -> bool:
    if table is None:
        return False
    t = table.lower()
    return t.startswith(INFORMATION_SCHEMA + ".") or (
        db.lower() == INFORMATION_SCHEMA and t.split(".")[0] in _TABLES
    )


def table_names() -> list[str]:
    return sorted(_TABLES)


def _runtime_plane(name: str, slice_name: str):
    from greptimedb_tpu_torch.query.engine import UnsupportedStatement

    return UnsupportedStatement(
        f"information_schema.{name} is not in this slice of "
        f"greptimedb_tpu_torch; the {slice_name} slice brings it")


# ---- builders ---------------------------------------------------------------


@_virtual("schemata")
def _schemata(qe, ctx):
    dbs = qe.catalog.list_databases()
    return {
        "catalog_name": ["greptime"] * (len(dbs) + 1),
        "schema_name": list(dbs) + [INFORMATION_SCHEMA],
    }


@_virtual("tables")
def _tables(qe, ctx):
    cols = {k: [] for k in ("table_catalog", "table_schema", "table_name",
                            "table_type", "table_id", "engine")}
    for db in qe.catalog.list_databases():
        for name in qe.catalog.list_tables(db):
            info = qe.catalog.table(db, name)
            cols["table_catalog"].append("greptime")
            cols["table_schema"].append(db)
            cols["table_name"].append(name)
            cols["table_type"].append("BASE TABLE")
            cols["table_id"].append(info.table_id)
            cols["engine"].append(info.options.get("engine", "mito"))
    for vt in table_names():
        cols["table_catalog"].append("greptime")
        cols["table_schema"].append(INFORMATION_SCHEMA)
        cols["table_name"].append(vt)
        cols["table_type"].append("LOCAL TEMPORARY")
        cols["table_id"].append(0)
        cols["engine"].append("virtual")
    return cols


@_virtual("columns")
def _columns(qe, ctx):
    cols = {k: [] for k in (
        "table_catalog", "table_schema", "table_name", "column_name",
        "ordinal_position", "data_type", "semantic_type", "is_nullable",
        "column_default")}
    for db in qe.catalog.list_databases():
        for name in qe.catalog.list_tables(db):
            info = qe.catalog.table(db, name)
            for i, c in enumerate(info.schema.columns):
                cols["table_catalog"].append("greptime")
                cols["table_schema"].append(db)
                cols["table_name"].append(name)
                cols["column_name"].append(c.name)
                cols["ordinal_position"].append(i + 1)
                cols["data_type"].append(c.dtype.value)
                cols["semantic_type"].append(c.semantic.value.upper())
                cols["is_nullable"].append("Yes" if c.nullable else "No")
                cols["column_default"].append(
                    "" if c.default is None else str(c.default))
    return cols


@_virtual("partitions")
def _partitions(qe, ctx):
    raise _runtime_plane("partitions", "mesh and cluster (ROADMAP A10)")


@_virtual("region_peers")
def _region_peers(qe, ctx):
    raise _runtime_plane("region_peers", "mesh and cluster (ROADMAP A10)")


@_virtual("cluster_info")
def _cluster_info(qe, ctx):
    raise _runtime_plane("cluster_info", "mesh and cluster (ROADMAP A10)")


@_virtual("runtime_metrics")
def _runtime_metrics(qe, ctx):
    raise _runtime_plane("runtime_metrics", "servers and CLI (ROADMAP A9)")


@_virtual("slow_queries")
def _slow_queries(qe, ctx):
    raise _runtime_plane("slow_queries", "servers and CLI (ROADMAP A9)")


@_virtual("running_queries")
def _running_queries(qe, ctx):
    raise _runtime_plane("running_queries", "servers and CLI (ROADMAP A9)")


@_virtual("cluster_profile")
def _cluster_profile(qe, ctx):
    raise _runtime_plane("cluster_profile", "servers and CLI (ROADMAP A9)")


@_virtual("cluster_faults")
def _cluster_faults(qe, ctx):
    raise _runtime_plane("cluster_faults", "servers and CLI (ROADMAP A9)")


@_virtual("maintenance_jobs")
def _maintenance_jobs(qe, ctx):
    raise _runtime_plane("maintenance_jobs", "maintenance plane (ROADMAP A12)")


@_virtual("engines")
def _engines(qe, ctx):
    names = ["mito", "metric", "file"]
    return {
        "engine": names,
        "support": ["DEFAULT"] + ["YES"] * (len(names) - 1),
        "comment": [
            "TPU-native LSM time-series engine",
            "logical tables multiplexed over one physical region",
            "external files as read-only tables",
        ],
    }


@_virtual("views")
def _views(qe, ctx):
    cols = {"table_catalog": [], "table_schema": [], "table_name": [],
            "view_definition": []}
    for db in qe.catalog.list_databases():
        for name in qe.catalog.list_views(db):
            cols["table_catalog"].append("greptime")
            cols["table_schema"].append(db)
            cols["table_name"].append(name)
            cols["view_definition"].append(qe.catalog.view(db, name))
    return cols


@_virtual("flows")
def _flows(qe, ctx):
    raise _runtime_plane("flows", "servers and CLI (ROADMAP A9)")


# ---- host-side mini executor ------------------------------------------------


@_virtual("key_column_usage")
def _key_column_usage(qe, ctx):
    """Primary-key / time-index membership per column (reference
    catalog/src/information_schema/key_column_usage.rs:40-55)."""
    cols = {k: [] for k in (
        "constraint_catalog", "constraint_schema", "constraint_name",
        "table_catalog", "table_schema", "table_name", "column_name",
        "ordinal_position")}
    from greptimedb_tpu_torch.datatypes.types import SemanticType

    def add(db, name, constraint, col, pos):
        cols["constraint_catalog"].append("def")
        cols["constraint_schema"].append(db)
        cols["constraint_name"].append(constraint)
        cols["table_catalog"].append("def")
        cols["table_schema"].append(db)
        cols["table_name"].append(name)
        cols["column_name"].append(col)
        cols["ordinal_position"].append(pos)

    for db in qe.catalog.list_databases():
        for name in qe.catalog.list_tables(db):
            info = qe.catalog.table(db, name)
            pos = 1
            for c in info.schema.columns:
                if c.semantic is SemanticType.TAG:
                    add(db, name, "PRIMARY", c.name, pos)
                    pos += 1
            ti = info.schema.time_index
            if ti is not None:
                add(db, name, "TIME INDEX", ti.name, 1)
    return cols


@_virtual("table_constraints")
def _table_constraints(qe, ctx):
    """PRIMARY KEY + TIME INDEX constraints per table (reference
    catalog/src/information_schema/table_constraints.rs)."""
    cols = {k: [] for k in (
        "constraint_catalog", "constraint_schema", "constraint_name",
        "table_schema", "table_name", "constraint_type")}
    for db in qe.catalog.list_databases():
        for name in qe.catalog.list_tables(db):
            info = qe.catalog.table(db, name)
            entries = []
            if info.schema.tag_columns:
                entries.append(("PRIMARY", "PRIMARY KEY"))
            if info.schema.time_index is not None:
                entries.append(("TIME INDEX", "TIME INDEX"))
            for cname, ctype in entries:
                cols["constraint_catalog"].append("def")
                cols["constraint_schema"].append(db)
                cols["constraint_name"].append(cname)
                cols["table_schema"].append(db)
                cols["table_name"].append(name)
                cols["constraint_type"].append(ctype)
    return cols


@_virtual("character_sets")
def _character_sets(qe, ctx):
    # utf8-only, like the reference (memory_table/tables.rs CHARACTER_SETS)
    return {
        "character_set_name": ["utf8"],
        "default_collate_name": ["utf8_bin"],
        "description": ["UTF-8 Unicode"],
        "maxlen": [4],
    }


@_virtual("collations")
def _collations(qe, ctx):
    return {
        "collation_name": ["utf8_bin"],
        "character_set_name": ["utf8"],
        "id": [1],
        "is_default": ["Yes"],
        "is_compiled": ["Yes"],
        "sortlen": [1],
    }


@_virtual("build_info")
def _build_info(qe, ctx):
    import greptimedb_tpu_torch

    return {
        "git_branch": ["main"],
        "git_commit": ["unknown"],
        "git_commit_short": ["unknown"],
        "git_dirty": ["false"],
        "pkg_version": [greptimedb_tpu_torch.__version__],
    }


def execute_virtual_select(qe, sel: ast.Select, ctx) -> QueryResult:
    """SELECT over an information_schema table: materialize, then apply
    WHERE / projection / ORDER BY / LIMIT on host."""
    from greptimedb_tpu_torch.query.expr import PlanError

    t = sel.table.lower()
    name = t.split(".", 1)[1] if t.startswith(INFORMATION_SCHEMA + ".") \
        else t.split(".")[0]
    builder = _TABLES.get(name)
    if builder is None:
        raise PlanError(f"information_schema table {name!r} not found")
    if sel.group_by or sel.having is not None or sel.distinct:
        raise PlanError(
            "GROUP BY/HAVING/DISTINCT not supported on information_schema")
    from greptimedb_tpu_torch.query.expr import eval_host

    data = {k: np.asarray(v, dtype=object) for k, v in builder(qe, ctx).items()}
    n = len(next(iter(data.values()))) if data else 0

    def ev(expr):
        return eval_host(expr, data, None, None, n)

    mask = np.ones(n, dtype=bool)
    if sel.where is not None:
        mask = np.broadcast_to(
            np.asarray(ev(sel.where), dtype=bool), (n,))
    idx = np.nonzero(mask)[0]

    # projection
    star = any(isinstance(it.expr, ast.Star) for it in sel.items)
    is_count = [isinstance(it.expr, ast.FuncCall)
                and it.expr.name.lower() == "count" for it in sel.items]
    if star:
        names = list(data)
        out_cols = [data[c][idx] for c in names]
    elif any(is_count):
        # aggregate shape: only count(*) items allowed (no GROUP BY here)
        if not all(is_count):
            raise PlanError(
                "cannot mix count(*) with plain columns on "
                "information_schema without GROUP BY")
        names = [it.alias or "count(*)" for it in sel.items]
        out_cols = [np.asarray([len(idx)], dtype=object) for _ in sel.items]
    else:
        names, out_cols = [], []
        for i, it in enumerate(sel.items):
            vals = np.asarray(ev(it.expr), dtype=object)
            if vals.ndim == 0:
                vals = np.full(n, vals[()], dtype=object)
            names.append(it.alias or _expr_name(it.expr, i))
            out_cols.append(vals[idx])

    # ORDER BY over projected or source columns; multi-key sort applies
    # keys last-to-first with a stable argsort. DESC negates factorized
    # codes (reversing a stable sort would also reverse equal-key runs
    # and destroy the ordering of later keys).
    if sel.order_by:
        perm = np.arange(len(out_cols[0]) if out_cols else 0)
        for ob in reversed(sel.order_by):
            col = _order_col(ob, names, out_cols, data, idx)
            try:
                codes = np.unique(col, return_inverse=True)[1]
            except TypeError:
                # None/mixed types: NULLs first, rest by string value
                skey = np.asarray(
                    ["" if v is None else "\x01" + str(v) for v in col])
                codes = np.unique(skey, return_inverse=True)[1]
            asc = ob.asc if hasattr(ob, "asc") else True
            key = codes if asc else -codes
            perm = perm[np.argsort(key[perm], kind="stable")]
        out_cols = [c[perm] for c in out_cols]
    if sel.offset:
        out_cols = [c[sel.offset:] for c in out_cols]
    if sel.limit is not None:
        out_cols = [c[:sel.limit] for c in out_cols]

    dtypes = [_dtype_of(c) for c in out_cols]
    return QueryResult(names, dtypes, out_cols)


def _order_col(ob, names, out_cols, data, idx):
    expr = ob.expr if hasattr(ob, "expr") else ob
    if isinstance(expr, ast.Column):
        if expr.name in names:
            return out_cols[names.index(expr.name)]
        if expr.name in data:
            return data[expr.name][idx]
    raise_err = getattr(expr, "name", str(expr))
    from greptimedb_tpu_torch.query.expr import PlanError
    raise PlanError(f"cannot ORDER BY {raise_err!r} on information_schema")


def _expr_name(expr, i):
    if isinstance(expr, ast.Column):
        return expr.name
    return f"column{i}"


def _dtype_of(col) -> DataType:
    for v in col:
        if isinstance(v, bool):
            return DataType.BOOL
        if isinstance(v, (int, np.integer)):
            return DataType.INT64
        if isinstance(v, (float, np.floating)):
            return DataType.FLOAT64
        break
    return DataType.STRING
