"""`information_schema` virtual tables of the port (copy of
greptimedb_tpu/catalog/information_schema.py; mirrors reference
src/catalog/src/information_schema/*.rs).

The catalog-backed tables (schemata, tables, columns, engines, views,
key_column_usage, table_constraints, character_sets, collations,
build_info), maintenance_jobs (the maintenance plane's queue and
history) and the observability plane's runtime tables (runtime_metrics,
slow_queries, running_queries, cluster_profile, cluster_faults) and
flows (the flow engine's flows in every database) materialize at query
time as host-side column dicts; a small host evaluator applies WHERE /
projection / ORDER BY / LIMIT (these tables are tiny — no device
round-trip). build_info reports this package's version. The cluster
tables (partitions, region_peers, cluster_info) read the catalog's
partition rules and region ids, and a `cluster` hook on the engine when
one is attached, as the JAX package's do.
"""

from __future__ import annotations

import json
import time

import numpy as np

from greptimedb_tpu_torch.datatypes.types import DataType
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast

INFORMATION_SCHEMA = "information_schema"
#: this process's start, as cluster_info reports it
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
    """One row a region: its partition's upper bound as the JAX package
    prints it (the rule's `bounds` entry; the last region unbounded)."""
    cols = {k: [] for k in ("table_catalog", "table_schema", "table_name",
                            "partition_name", "partition_expression",
                            "greptime_partition_id")}
    for db in qe.catalog.list_databases():
        for name in qe.catalog.list_tables(db):
            info = qe.catalog.table(db, name)
            exprs = [None] * len(info.region_ids)
            if info.partition_rules:
                rules = info.partition_rules
                if isinstance(rules, dict):
                    bounds = rules.get("bounds") or []
                    exprs = [str(b) for b in bounds] + [None]
                    exprs = exprs[:len(info.region_ids)] or [None]
            for i, rid in enumerate(info.region_ids):
                cols["table_catalog"].append("greptime")
                cols["table_schema"].append(db)
                cols["table_name"].append(name)
                cols["partition_name"].append(f"p{i}")
                cols["partition_expression"].append(
                    exprs[i] if i < len(exprs) else None)
                cols["greptime_partition_id"].append(rid)
    return cols


@_virtual("region_peers")
def _region_peers(qe, ctx):
    """One row a region and its peer: the engine's `cluster` hook
    (`region_routes()`, region id -> peer id) when one is attached, as
    in the JAX package; peer 0 otherwise."""
    cols = {k: [] for k in ("region_id", "peer_id", "peer_addr",
                            "is_leader", "status")}
    cluster = getattr(qe, "cluster", None)
    route = {}
    if cluster is not None and hasattr(cluster, "region_routes"):
        route = cluster.region_routes()
    for db in qe.catalog.list_databases():
        for name in qe.catalog.list_tables(db):
            info = qe.catalog.table(db, name)
            for rid in info.region_ids:
                peer = route.get(rid, 0)
                cols["region_id"].append(rid)
                cols["peer_id"].append(peer)
                cols["peer_addr"].append(f"datanode-{peer}")
                cols["is_leader"].append("Yes")
                cols["status"].append("ALIVE")
    return cols


@_virtual("cluster_info")
def _cluster_info(qe, ctx):
    """The peers of the engine's `cluster` hook (`datanode_ids()`) and
    this process: STANDALONE alone, FRONTEND beside a metasrv and
    datanodes."""
    from greptimedb_tpu_torch import __version__

    cols = {k: [] for k in ("peer_id", "peer_type", "peer_addr", "version",
                            "start_time", "uptime")}
    cluster = getattr(qe, "cluster", None)
    peers = []
    if cluster is not None and hasattr(cluster, "datanode_ids"):
        peers = [(pid, "DATANODE") for pid in cluster.datanode_ids()]
        peers += [(0, "METASRV")]
    peers.append((0, "STANDALONE") if not peers else (0, "FRONTEND"))
    uptime = time.time() - _START_TIME
    for pid, ptype in peers:
        cols["peer_id"].append(pid)
        cols["peer_type"].append(ptype)
        cols["peer_addr"].append("127.0.0.1")
        cols["version"].append(__version__)
        cols["start_time"].append(int(_START_TIME * 1000))
        cols["uptime"].append(f"{uptime:.0f}s")
    return cols


@_virtual("runtime_metrics")
def _runtime_metrics(qe, ctx):
    from greptimedb_tpu_torch.utils.metrics import REGISTRY

    cols = {"metric_name": [], "value": [], "labels": [],
            "timestamp": []}
    now = int(time.time() * 1000)
    for name, value, labels in REGISTRY.samples():
        cols["metric_name"].append(name)
        cols["value"].append(float(value))
        cols["labels"].append(labels)
        cols["timestamp"].append(now)
    return cols


@_virtual("slow_queries")
def _slow_queries(qe, ctx):
    """Slow-query ring (utils/slow_query.py), newest first — the system
    table surface of the slow-query log."""
    from greptimedb_tpu_torch.utils import ledger, slow_query

    cols = {k: [] for k in (
        "trace_id", "kind", "query", "db", "duration_ms", "threshold_ms",
        "rows", "execution_path", "plan_cache_skip", "started_at",
        "stages", "ledger", "achieved_gbps", "roofline_fraction")}
    for rec in slow_query.records():
        cols["trace_id"].append(rec.trace_id)
        cols["kind"].append(rec.kind)
        cols["query"].append(rec.query)
        cols["db"].append(rec.db)
        cols["duration_ms"].append(round(rec.duration_ms, 3))
        cols["threshold_ms"].append(rec.threshold_ms)
        cols["rows"].append(rec.rows)
        cols["execution_path"].append(rec.execution_path or "")
        cols["plan_cache_skip"].append(rec.plan_cache_skip or "")
        cols["started_at"].append(int(rec.started_at * 1000))
        cols["stages"].append("; ".join(
            f"{'' if n == 'local' else '[' + str(n) + '] '}{s}={d:.2f}ms"
            for n, s, d in rec.stages))
        cols["ledger"].append(ledger.format_dict(rec.ledger))
        cols["achieved_gbps"].append(rec.achieved_gbps)
        cols["roofline_fraction"].append(rec.roofline_fraction)
    return cols


@_virtual("running_queries")
def _running_queries(qe, ctx):
    """Live statements on this frontend (utils/deadline.py RUNNING
    registry) — id, text, origin, elapsed vs remaining budget, and
    whether a cancel is already pending. The id column feeds
    KILL QUERY <id> and DELETE /v1/queries/<id>."""
    from greptimedb_tpu_torch.utils import deadline

    cols = {k: [] for k in (
        "id", "query", "db", "channel", "tenant", "trace_id",
        "started_at", "elapsed_ms", "remaining_ms", "cancelled")}
    for e in deadline.RUNNING.list():
        cols["id"].append(e["id"])
        cols["query"].append(e["query"][:4096])
        cols["db"].append(e["db"])
        cols["channel"].append(e["channel"])
        cols["tenant"].append(e["tenant"])
        cols["trace_id"].append(e["trace_id"])
        cols["started_at"].append(e["start_time_ms"])
        cols["elapsed_ms"].append(round(e["elapsed_ms"], 3))
        cols["remaining_ms"].append(
            None if e["remaining_ms"] is None
            else round(e["remaining_ms"], 3))
        cols["cancelled"].append(e["cancelled"])
    return cols


@_virtual("cluster_profile")
def _cluster_profile(qe, ctx):
    """Continuous-profiling view (utils/flame.py): one row per (node x
    coarse stage). The port has no cluster yet, so the view holds the
    local node only; empty when profiling is disabled. `share` is that
    stage's fraction of the node's samples; `top_frames` names the
    node's hottest self-time frames."""
    from greptimedb_tpu_torch.utils import flame

    cols = {k: [] for k in (
        "node", "stage", "stage_samples", "share", "node_samples",
        "attributed_ratio", "hz", "window_s", "captured_at",
        "top_frames")}
    view = flame.cluster_view()
    for node in sorted(view["nodes"]):
        summ = view["nodes"][node]
        total = summ.get("samples", 0) or 0
        top = "; ".join(f"{r['frame']} x{r['self']}"
                        for r in (summ.get("top") or [])[:3])
        for stage, n in sorted((summ.get("stages") or {}).items()):
            cols["node"].append(node)
            cols["stage"].append(stage)
            cols["stage_samples"].append(int(n))
            cols["share"].append(round(n / total, 4) if total else 0.0)
            cols["node_samples"].append(int(total))
            cols["attributed_ratio"].append(
                round(summ.get("attributed", 0) / total, 4) if total
                else 0.0)
            cols["hz"].append(float(summ.get("hz", 0.0)))
            cols["window_s"].append(float(summ.get("window_s", 0.0)))
            cols["captured_at"].append(int(summ.get("ts_ms", 0)))
            cols["top_frames"].append(top)
    return cols


@_virtual("cluster_faults")
def _cluster_faults(qe, ctx):
    """Armed chaos state and fire counts (fault/): one row per (armed
    point x observed counter series), and one per installed network
    partition. Empty when chaos is off."""
    from greptimedb_tpu_torch.fault import FAULTS, chaos_seed
    from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

    cols = {k: [] for k in ("point", "kind", "schedule", "matchers",
                            "edge", "node", "fires", "chaos_seed")}
    seed = chaos_seed()

    def add(point, kind, schedule, matchers, edge, node, fires):
        cols["point"].append(point)
        cols["kind"].append(kind)
        cols["schedule"].append(schedule)
        cols["matchers"].append(matchers)
        cols["edge"].append(edge)
        cols["node"].append(node)
        cols["fires"].append(fires)
        cols["chaos_seed"].append(seed)

    for f in FAULTS.describe():
        matchers = ",".join(f"{k}:{v}" for k, v in sorted(f["match"].items()))
        edges = f["edges"] or [""]
        fired = FAULT_INJECTIONS.series(point=f["point"], kind=f["kind"])
        if not fired:
            for edge in edges:
                add(f["point"], f["kind"], f["schedule"], matchers, edge,
                    "", 0.0)
            continue
        for labels, count in fired:
            add(f["point"], f["kind"], f["schedule"], matchers,
                labels.get("edge", edges[0]), labels.get("node", ""),
                count)
    for edge in FAULTS.partitions():
        add("partition", "partition", "installed", "", edge, "",
            FAULT_INJECTIONS.total(kind="partition", edge=edge))
    return cols


@_virtual("maintenance_jobs")
def _maintenance_jobs(qe, ctx):
    """The maintenance plane's job queue and recent history
    (maintenance/scheduler.py), newest first. Empty when the engine has
    no plane (maintenance_workers=0)."""
    cols = {k: [] for k in (
        "job_id", "kind", "region_id", "state", "priority", "error",
        "detail", "queued_at", "started_at", "finished_at",
        "duration_ms")}
    maint = qe.region_engine.maintenance
    for job in (maint.jobs() if maint is not None else []):
        d = job.to_dict()
        cols["job_id"].append(d["job_id"])
        cols["kind"].append(d["kind"])
        cols["region_id"].append(d["region_id"])
        cols["state"].append(d["state"])
        cols["priority"].append(d["priority"])
        cols["error"].append(d["error"])
        cols["detail"].append(json.dumps(d["detail"], sort_keys=True))
        cols["queued_at"].append(int(d["queued_at"] * 1000))
        cols["started_at"].append(
            None if d["started_at"] is None else int(d["started_at"] * 1000))
        cols["finished_at"].append(
            None if d["finished_at"] is None
            else int(d["finished_at"] * 1000))
        cols["duration_ms"].append(
            None if d["duration_ms"] is None else round(d["duration_ms"], 3))
    return cols


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
    cols = {"flow_name": [], "table_catalog": [], "flow_schema": [],
            "source_table": [], "sink_table": [], "raw_sql": []}
    for db in qe.catalog.list_databases():
        for f in qe.flow_engine.list_flows(db):
            cols["flow_name"].append(f.name)
            cols["table_catalog"].append("greptime")
            cols["flow_schema"].append(db)
            cols["source_table"].append(f.source_table)
            cols["sink_table"].append(f.sink_table)
            cols["raw_sql"].append(f.sql)
    return cols


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
