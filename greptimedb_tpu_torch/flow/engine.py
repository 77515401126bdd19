"""Flow engine: continuous aggregation into sink tables (counterpart of
greptimedb_tpu/flow/engine.py; reference src/flow, adapter.rs:148
FlownodeManager, run_available :507-527).

A flow is `CREATE FLOW name SINK TO sink AS SELECT <aggregate>`; as new
rows land in the source table, ticks (`run_available`, `ADMIN
flush_flow`) keep the aggregate up to date in the sink table. Each tick
folds through one of two paths, as in the JAX engine:

1. INCREMENTAL (append-mode sources, decomposable aggregates): each
   region scan is bounded by the write-sequence fold boundary
   (`seq_min`: only rows written since the last tick leave disk, whole
   SSTs pruned by FileMeta.max_seq), the new rows reduce to partial
   planes with ONE K2 call a region (query/dist_agg.py::
   partial_region_agg), and the planes MERGE with per-group state
   persisted as `__st_*` columns in the sink itself. A tick is O(new
   data), exactly once per row, and the sink's visible columns finalize
   from the merged state (avg = sum / count, ...). A tick with no new
   rows launches no kernel.
2. DIRTY-SPAN (updates or deletes possible, or non-decomposable
   aggregates): re-run the aggregate, restricted to the time range
   dirtied since the last tick when the flow has an expiry, and upsert
   the groups (last-write-wins makes the upsert idempotent).

Only the port's own native `Region` carries the write sequence the fold
boundary needs: a metric-engine logical region (which has a `files`
property over its physical region, where the JAX package tests
`hasattr(region, "files")`) and an external table's region never reach
the `seq_min` path.

The incremental path writes the merged groups into the sink as one
columnar batch (the values the JAX engine's INSERT text carries,
through the same `values_batch` conversion), not as SQL text.
`last_tick_stats` adds to the JAX keys the tick's host wall time split
into scan, the K2 reduction and the sink merge / write, and the SSTs its
scans pruned by sequence, decoded and found in the part cache.
"""

from __future__ import annotations

import json
import logging
import re
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.catalog.kv import KvBackend
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import ast, parse_sql
from greptimedb_tpu_torch.utils.metrics import FLOW_TICK_ERRORS

logger = logging.getLogger(__name__)

FLOW_PREFIX = "__flow/"


@dataclass
class FlowInfo:
    name: str
    db: str
    sink_table: str
    source_table: str
    sql: str  # the SELECT, re-parsed on load
    expire_after_s: Optional[int] = None
    comment: str = ""
    # incremental state
    last_version: int = -1  # source data_version at last tick
    watermark_ms: int = 0  # max source ts folded into the sink
    # sequence fold boundary per source region (incremental path):
    # every row with seq <= last_seqs[str(rid)] has been folded exactly
    # once into the sink's state planes
    last_seqs: dict = field(default_factory=dict)
    incremental: bool = False  # sink carries __st_* state columns

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "FlowInfo":
        return FlowInfo(**json.loads(s))


class FlowEngine:
    """Manages flows; `run_available()` ticks every flow (adapter.rs:507)."""

    def __init__(self, query_engine, kv: Optional[KvBackend] = None):
        self.qe = query_engine
        self.kv = kv if kv is not None else query_engine.catalog.kv

    # ------------------------------------------------------------- DDL
    def create_flow(self, stmt: ast.CreateFlow, ctx: QueryContext) -> FlowInfo:
        key = f"{FLOW_PREFIX}{ctx.db}/{stmt.name}"
        if self.kv.get(key) is not None:
            if stmt.if_not_exists:
                return FlowInfo.from_json(self.kv.get(key))
            raise ValueError(f"flow {stmt.name!r} already exists")
        sel = stmt.query
        if not isinstance(sel, ast.Select) or sel.table is None:
            raise ValueError("flow query must be a SELECT over a source table")
        sql = stmt.raw_query.strip() or _render_select(sel)
        info = FlowInfo(
            name=stmt.name, db=ctx.db, sink_table=stmt.sink_table,
            source_table=sel.table, sql=sql,
            expire_after_s=stmt.expire_after_s, comment=stmt.comment,
        )
        try:
            src = self.qe._table(sel.table, ctx)
            plan = self._incr_plan(parse_sql(sql)[0], src)
        except Exception:  # noqa: BLE001 — eligibility probe only
            plan = None
        info.incremental = plan is not None
        self._ensure_sink(info, sel, ctx, plan)
        if info.incremental:
            # a pre-existing sink without state columns cannot carry
            # the incremental planes — stay on the dirty-span path
            sink = self.qe.catalog.table(ctx.db, info.sink_table)
            need = {c for c, _, _ in self._state_cols(plan)}
            if not need <= set(sink.schema.names):
                info.incremental = False
        self.kv.put(key, info.to_json())
        return info

    def drop_flow(self, name: str, db: str = "public",
                  if_exists: bool = False) -> None:
        key = f"{FLOW_PREFIX}{db}/{name}"
        if self.kv.get(key) is None and not if_exists:
            raise ValueError(f"flow {name!r} not found")
        self.kv.delete(key)

    def list_flows(self, db: str = "public") -> list[FlowInfo]:
        return [FlowInfo.from_json(v)
                for _, v in self.kv.range(f"{FLOW_PREFIX}{db}/")]

    # ------------------------------------------------------------- ticking
    def run_available(self, db: str = "public") -> dict[str, int]:
        """Tick every flow whose source changed; returns rows upserted per
        flow (the run_available loop, adapter.rs:507-527)."""
        out = {}
        for info in self.list_flows(db):
            n = self._tick_flow(info)
            if n:
                out[info.name] = n
        return out

    def flush(self, name: str, db: str = "public") -> int:
        """Tick one flow by name NOW; returns rows upserted (the ADMIN
        flush_flow() surface, reference common/function flush_flow)."""
        for info in self.list_flows(db):
            if info.name == name:
                return self._tick_flow(info)
        raise KeyError(f"flow {name!r} not found")

    # stats of the most recent tick that did work
    last_tick_stats: Optional[dict] = None

    #: aggregate functions whose state decomposes onto the plane algebra
    _INCR_FUNCS = frozenset({"sum", "count", "avg", "min", "max",
                             "stddev", "variance", "rows"})

    def _incr_plan(self, sel: ast.Select, src) -> Optional[dict]:
        """Classify the flow query for the incremental path. Returns
        {keys, aggs, where, args, ops, spec_slots, items} or None when
        only the dirty-span re-scan is sound (non-append sources could
        rewrite already-folded rows; non-decomposable aggregates have no
        mergeable state; post-aggregate expressions would need
        re-evaluation over finalized planes; regions without write
        sequences cannot bound a fold)."""
        from greptimedb_tpu_torch.query import logical as lp
        from greptimedb_tpu_torch.query.physical import (
            _PRIMITIVES,
            _needs_host_agg,
        )
        from greptimedb_tpu_torch.query.planner import plan_select
        from greptimedb_tpu_torch.storage.region import Region

        if not src.append_mode:
            return None
        for rid in src.region_ids:
            try:
                region = self.qe.region_engine.region(rid)
            except KeyError:  # resolution happens at tick
                continue
            if not isinstance(region, Region):
                return None
        node = plan_select(sel, src)
        if not isinstance(node, lp.Project):
            return None
        project = node
        node = node.input
        if not isinstance(node, lp.Aggregate):
            return None
        agg = node
        node = node.input
        where = None
        if isinstance(node, lp.Filter):
            where = node.predicate
            node = node.input
        if not isinstance(node, lp.Scan):
            return None
        for spec in agg.aggs:
            if spec.func not in self._INCR_FUNCS \
                    or _needs_host_agg(spec, src.schema):
                return None
        # each output must be exactly a group key or a plain aggregate
        # call — finalization recomputes visible values from state
        items: list[tuple[str, str, int]] = []  # (col, kind, index)
        for name, expr in project.items:
            hit = None
            for i, (_, kexpr) in enumerate(agg.keys):
                if expr == kexpr:
                    hit = ("key", i)
                    break
            if hit is None:
                for j, spec in enumerate(agg.aggs):
                    if expr == spec.call:
                        hit = ("agg", j)
                        break
            if hit is None:
                return None
            items.append((_ident(name), hit[0], hit[1]))
        # every group key must be projected: the sink re-identifies
        # groups by their key column values
        projected = {idx for _, kind, idx in items if kind == "key"}
        if projected != set(range(len(agg.keys))):
            return None
        args: list[ast.Expr] = []
        spec_slots: list[Optional[int]] = []
        ops: set = {"rows"}
        for spec in agg.aggs:
            ops.update(_PRIMITIVES[spec.func])
            if spec.arg is None:
                spec_slots.append(None)
                continue
            if spec.arg not in args:
                args.append(spec.arg)
            spec_slots.append(args.index(spec.arg))
        return {"keys": agg.keys, "aggs": agg.aggs, "where": where,
                "args": args, "ops": sorted(ops),
                "spec_slots": spec_slots, "items": items}

    @staticmethod
    def _state_cols(plan: dict) -> list[tuple[str, str, Optional[int]]]:
        """[(column name, op, slot)] for the sink's state planes."""
        out = []
        for op in plan["ops"]:
            if op == "rows":
                out.append(("__st_rows", op, None))
            else:
                for slot in range(max(len(plan["args"]), 1)):
                    out.append((f"__st_{op}_{slot}", op, slot))
        return out

    def _tick_flow(self, info: FlowInfo) -> int:
        ctx = QueryContext(db=info.db)
        try:
            src = self.qe._table(info.source_table, ctx)
        except Exception:  # noqa: BLE001 — a dropped source ticks nothing
            return 0
        version = sum(
            self.qe.region_engine.region(rid).data_version
            for rid in src.region_ids
        )
        if version == info.last_version:
            return 0
        sel = parse_sql(info.sql)[0]
        if info.incremental:
            # an incremental flow may NEVER fall through to the
            # dirty-span path: its upsert writes only visible columns,
            # which would NULL the sink's state planes and corrupt
            # every later merge. On any failure, retry next tick — the
            # boundary only advances on success.
            try:
                plan = self._incr_plan(sel, src)
                if plan is None:
                    raise RuntimeError(
                        f"flow {info.name}: incremental plan no longer "
                        "eligible (source or query changed?)")
                return self._tick_incremental(info, src, ctx, plan,
                                              version)
            except Exception:  # noqa: BLE001 — retry next tick
                # observable: the boundary did not advance, so the next
                # tick retries the same rows
                FLOW_TICK_ERRORS.inc(flow=info.name)
                logger.warning(
                    "flow %s: incremental tick failed; retrying next tick",
                    info.name, exc_info=True)
                return 0
        # dirty-horizon restriction: only recompute buckets that new data
        # can touch (watermark minus the expire horizon)
        if info.watermark_ms and info.expire_after_s:
            lo = info.watermark_ms - info.expire_after_s * 1000
            ts_name = src.schema.time_index.name
            cond = ast.BinaryOp(">=", ast.Column(ts_name), ast.Literal(lo))
            sel.where = cond if sel.where is None \
                else ast.BinaryOp("and", sel.where, cond)
        # the re-aggregate rides the executor's delta fold where the
        # shape is partial-cache eligible: immutable parts fold from
        # cached partials and only the span's delta runs kernels
        res = self.qe.execute_statement(sel, ctx)
        pstats = getattr(self.qe.executor, "last_partial_stats", None)
        FlowEngine.last_tick_stats = {
            "flow": info.name, "path": "dirty_span",
            "partial_cache": pstats}
        n = self._upsert_sink(info, res, ctx)
        # advance watermark to max source ts seen
        scan = None
        try:
            scan = self.qe.region_engine.scan(src.region_ids[0])
        except Exception:  # noqa: BLE001 — the watermark is advisory
            pass
        if scan is not None and scan.num_rows:
            info.watermark_ms = int(np.max(
                scan.columns[src.schema.time_index.name]))
        info.last_version = version
        self.kv.put(f"{FLOW_PREFIX}{info.db}/{info.name}", info.to_json())
        return n

    def _tick_incremental(self, info: FlowInfo, src, ctx: QueryContext,
                          plan: dict, version: int) -> int:
        """Fold rows written since the last tick into the sink's state
        planes (module docstring path 1)."""
        from greptimedb_tpu_torch.query.dist_agg import (
            combine_partials,
            partial_region_agg,
        )

        executor = self.qe.executor
        # expire horizon: rows older than watermark - expire drop out of
        # the FOLD (a WHERE conjunct, as on the dirty-span path) but not
        # out of the scan, so their sequences still advance the boundary
        # and they are skipped exactly once, not rescanned forever
        where = plan["where"]
        if info.expire_after_s and info.watermark_ms:
            lo = info.watermark_ms - info.expire_after_s * 1000
            ts_name = src.schema.time_index.name
            cond = ast.BinaryOp(">=", ast.Column(ts_name), ast.Literal(lo))
            where = cond if where is None \
                else ast.BinaryOp("and", where, cond)
        shim = SimpleNamespace(keys=plan["keys"], args=plan["args"],
                               ops=plan["ops"], where=where,
                               ts_range=None, append_mode=True, tz=None)
        partials = []
        scanned = 0
        scan_s = agg_s = 0.0
        files = dict.fromkeys(("ssts_seq_pruned", "files_decoded",
                               "part_hits"), 0)
        new_seqs = dict(info.last_seqs or {})
        max_ts = info.watermark_ms
        for rid in src.region_ids:
            st: dict = {}
            p = partial_region_agg(
                executor, rid, shim, schema=src.schema,
                seq_min=int(new_seqs.get(str(rid), -1)), stats_out=st)
            scanned += st.get("rows", 0)
            scan_s += st.get("scan_s", 0.0)
            agg_s += st.get("agg_s", 0.0)
            for k in files:
                files[k] += (st.get("scan_stats") or {}).get(k, 0)
            if st.get("max_seq") is not None:
                new_seqs[str(rid)] = max(int(st["max_seq"]),
                                         int(new_seqs.get(str(rid), -1)))
            if st.get("max_ts") is not None:
                max_ts = max(max_ts, int(st["max_ts"]))
            if p is not None:
                partials.append(p)
        t_sink = time.perf_counter()
        stats = {"flow": info.name, "path": "incremental",
                 "scanned_rows": scanned, "scan_ms": scan_s * 1e3,
                 "k2_ms": agg_s * 1e3, **files}
        FlowEngine.last_tick_stats = stats
        key = f"{FLOW_PREFIX}{info.db}/{info.name}"
        if not partials:
            info.last_seqs = new_seqs
            info.last_version = version
            info.watermark_ms = max_ts
            self.kv.put(key, info.to_json())
            stats["sink_ms"] = (time.perf_counter() - t_sink) * 1e3
            return 0
        n_keys = len(plan["keys"])
        ops = tuple(plan["ops"])
        new = combine_partials(partials, n_keys, ops)
        state = self._read_sink_state(info, plan, new, ctx)
        merged = combine_partials(
            [state, new], n_keys, ops) if state is not None else new
        n = self._write_sink_merged(info, plan, merged, ctx)
        info.last_seqs = new_seqs
        info.last_version = version
        info.watermark_ms = max_ts
        self.kv.put(key, info.to_json())
        stats["sink_ms"] = (time.perf_counter() - t_sink) * 1e3
        return n

    def _sink_key_names(self, plan: dict) -> list[Optional[str]]:
        """Sink column name per group-key index (None if unprojected)."""
        names: list[Optional[str]] = [None] * len(plan["keys"])
        for col, kind, idx in plan["items"]:
            if kind == "key":
                names[idx] = col
        return names

    def _read_sink_state(self, info: FlowInfo, plan: dict, new: dict,
                         ctx: QueryContext) -> Optional[dict]:
        """Current state planes for the groups the new partials touch,
        read back from the sink as a mergeable partial. Bounded by the
        new data's bucket span when the sink is time-keyed."""
        sink = self.qe.catalog.table(ctx.db, info.sink_table)
        ts_col = sink.schema.time_index.name
        key_names = self._sink_key_names(plan)
        state_cols = self._state_cols(plan)
        sel_cols = [n for n in key_names if n is not None] \
            + [c for c, _, _ in state_cols]
        where = ""
        if ts_col in key_names:
            b = np.asarray(new["keys"][key_names.index(ts_col)],
                           dtype=np.int64)
            where = f" WHERE {ts_col} >= {int(b.min())} " \
                    f"AND {ts_col} <= {int(b.max())}"
        res = self.qe.execute_one(
            f"SELECT {', '.join(sel_cols)} FROM {info.sink_table}{where}",
            ctx)
        if res.num_rows == 0:
            return None
        cols = dict(zip(res.names, res.columns))
        keys = [np.asarray(cols[n]) for n in key_names]
        f = max(len(plan["args"]), 1)
        planes: dict[str, np.ndarray] = {}
        for op in plan["ops"]:
            if op == "rows":
                planes[op] = np.asarray(cols["__st_rows"],
                                        dtype=np.float64)
            else:
                planes[op] = np.stack(
                    [np.asarray(cols[f"__st_{op}_{s}"], dtype=np.float64)
                     for s in range(f)], axis=1)
        return {"keys": keys, "planes": planes}

    def _write_sink_merged(self, info: FlowInfo, plan: dict, merged: dict,
                           ctx: QueryContext) -> int:
        """Upsert merged groups: finalized visible columns + state planes
        (LWW on the sink's keys overwrites the previous row), as one
        batch through the INSERT path's `values_batch`."""
        from greptimedb_tpu_torch.query.engine import values_batch
        from greptimedb_tpu_torch.query.physical import _finalize_agg

        g = len(merged["keys"][0]) if merged["keys"] else 1
        present = np.arange(g)
        out_cols: dict[str, np.ndarray] = {}
        for col, kind, idx in plan["items"]:
            if kind == "key":
                out_cols[col] = np.asarray(merged["keys"][idx])
            else:
                spec = plan["aggs"][idx]
                out_cols[col] = _finalize_agg(
                    spec.func, merged["planes"], plan["spec_slots"][idx],
                    present)
        for col, op, slot in self._state_cols(plan):
            pl = np.asarray(merged["planes"][op], dtype=np.float64)
            # rows is [G, 1]: its one column (the JAX INSERT text takes
            # the 1-element row's item)
            out_cols[col] = pl[:, slot or 0] if pl.ndim == 2 else pl
        sink = self.qe._table(info.sink_table, ctx)
        ts_col = sink.schema.time_index.name
        if ts_col not in out_cols:
            # group-only flows key the sink on a constant time index
            out_cols[ts_col] = np.zeros(g, dtype=np.int64)
        unknown = set(out_cols) - set(sink.schema.names)
        if unknown:
            raise ValueError(f"unknown insert columns {sorted(unknown)}")
        by_col = {c: _sql_values(v) for c, v in out_cols.items()}
        batch = values_batch(sink.schema, by_col, g)
        return self.qe._sharded_write(sink, batch, delete=False)

    # ------------------------------------------------------------- sink
    def _ensure_sink(self, info: FlowInfo, sel: ast.Select,
                     ctx: QueryContext, plan: Optional[dict] = None) -> None:
        """Auto-create the sink table from the flow query's output shape:
        group-by string keys become tags, a bucket timestamp becomes the
        time index, aggregates become fields."""
        if self.qe.catalog.table_exists(ctx.db, info.sink_table):
            return
        probe = self.qe.execute_statement(sel, ctx)
        cols_sql = []
        pks = []
        ts_col = None
        for name, dt in zip(probe.names, probe.dtypes):
            safe = _ident(name)
            if dt is not None and getattr(dt, "is_timestamp", False) \
                    and ts_col is None:
                ts_col = safe
                cols_sql.append(f"{safe} TIMESTAMP(3) TIME INDEX")
            elif dt is not None and getattr(dt, "is_string", False):
                pks.append(safe)
                cols_sql.append(f"{safe} STRING")
            else:
                cols_sql.append(f"{safe} DOUBLE")
        if ts_col is None:
            cols_sql.append("update_at TIMESTAMP(3) TIME INDEX")
        if plan is not None:
            # state planes for the incremental path ride in the sink
            # itself: the LWW upsert replaces value + state atomically
            for col, _, _ in self._state_cols(plan):
                cols_sql.append(f"{col} DOUBLE")
        pk = f", PRIMARY KEY({', '.join(pks)})" if pks else ""
        self.qe.execute_one(
            f"CREATE TABLE {info.sink_table} ({', '.join(cols_sql)}{pk})",
            ctx,
        )

    def _upsert_sink(self, info: FlowInfo, res: QueryResult,
                     ctx: QueryContext) -> int:
        if res.num_rows == 0:
            return 0
        sink = self.qe.catalog.table(ctx.db, info.sink_table)
        names = [_ident(n) for n in res.names]
        has_ts = any(n == sink.schema.time_index.name for n in names)
        rows_sql = []
        for row in res.rows():
            vals = []
            for v in row:
                if v is None or (isinstance(v, float) and np.isnan(v)):
                    vals.append("NULL")
                elif isinstance(v, str):
                    vals.append("'" + v.replace("'", "''") + "'")
                else:
                    vals.append(repr(v) if not isinstance(v, bool)
                                else str(v).upper())
            if not has_ts:
                # un-bucketed flows key the sink purely on the group tags:
                # a constant time index makes each tick's upsert overwrite
                # the group's previous value (LWW)
                vals.append("0")
            rows_sql.append("(" + ", ".join(vals) + ")")
        cols = names + ([] if has_ts else [sink.schema.time_index.name])
        sql = (f"INSERT INTO {info.sink_table} ({', '.join(cols)}) VALUES "
               + ", ".join(rows_sql))
        out = self.qe.execute_one(sql, ctx)
        return out.affected_rows or 0


def _sql_values(col: np.ndarray) -> list:
    """A column as the values its INSERT literals parse to: NULL for None
    and NaN, Python scalars otherwise."""
    out = np.asarray(col).tolist()
    return [None if v is None or (isinstance(v, float) and v != v) else v
            for v in out]


def _ident(name: str) -> str:
    safe = re.sub(r"[^0-9a-zA-Z_]", "_", name)
    return safe or "col"


def _render_select(sel: ast.Select) -> str:
    raise ValueError("flow statement carried no raw query text")
