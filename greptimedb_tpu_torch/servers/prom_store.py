"""Prometheus remote storage protocol: remote_write + remote_read
(counterpart of greptimedb_tpu/servers/prom_store.py).

Mirrors reference src/servers/src/prom_store.rs + http/prom_store.rs:
snappy-compressed protobuf bodies; each metric becomes a table whose tags
are the label set, with `greptime_timestamp` as the time index and
`greptime_value` as the single field (prom_row_builder.rs analog).
remote_read evaluates matchers against those tables and streams the series
back as a snappy ReadResponse.
"""

from __future__ import annotations

import re
from collections import defaultdict

from greptimedb_tpu_torch.catalog.catalog import CatalogError
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.utils import protowire as pw
from greptimedb_tpu_torch.utils import snappy
from greptimedb_tpu_torch.utils.metrics import REGISTRY

GREPTIME_TIMESTAMP = "greptime_timestamp"
GREPTIME_VALUE = "greptime_value"

INGEST_ROWS = REGISTRY.counter(
    "greptimedb_tpu_prom_store_rows_total",
    "Rows ingested via Prometheus remote write"
)


# ---------------------------------------------------------------- decode


def parse_write_request(body: bytes) -> list[tuple[dict, list[tuple[float, int]]]]:
    """Snappy+protobuf WriteRequest -> [(labels, [(value, ts_ms)])]."""
    raw = snappy.decompress(body)
    series = []
    for field, _wt, v in pw.iter_fields(raw):
        if field != 1:  # timeseries
            continue
        labels: dict[str, str] = {}
        samples: list[tuple[float, int]] = []
        for f2, _wt2, v2 in pw.iter_fields(v):
            if f2 == 1:  # Label
                name = value = ""
                for f3, _wt3, v3 in pw.iter_fields(v2):
                    if f3 == 1:
                        name = v3.decode()
                    elif f3 == 2:
                        value = v3.decode()
                labels[name] = value
            elif f2 == 2:  # Sample
                val, ts = 0.0, 0
                for f3, wt3, v3 in pw.iter_fields(v2):
                    if f3 == 1:
                        val = pw.fixed64_to_double(v3)
                    elif f3 == 2:
                        ts = pw.varint_to_sint64(v3)
                samples.append((val, ts))
        if samples:
            series.append((labels, samples))
    return series


def handle_remote_write(query_engine, body: bytes, db: str = "public") -> int:
    """Decode and ingest a remote-write body. Returns rows written.

    Columnar fast path: each decoded series bulk-extends its metric's
    column slab (a series' samples share ONE label set, so tag columns
    extend with a repeated value instead of per-sample appends), and
    each metric table gets one RecordBatch onto the bulk write path of
    its one region."""
    from greptimedb_tpu_torch.ingest import TableSlab, ensure_table

    series = parse_write_request(body)
    ctx = QueryContext(db=db)
    slabs: dict[str, TableSlab] = {}
    for labels, samples in series:
        table = _sanitize(labels.get("__name__", "unknown_metric"))
        slab = slabs.get(table)
        if slab is None:
            slab = slabs[table] = TableSlab()
        n = len(samples)
        for k, v in labels.items():
            if k != "__name__":
                slab.extend_column("tag", k, [v] * n)
        slab.extend_column("field", GREPTIME_VALUE,
                           [value for value, _ in samples])
        slab.extend_rows([ts for _, ts in samples])
    total = 0
    for table, slab in slabs.items():
        # label columns create in sorted order (stable table shapes
        # regardless of series arrival order), via the shared schema
        # bootstrap every front door uses
        slab.tags = {k: slab.tags[k] for k in sorted(slab.tags)}
        info = ensure_table(query_engine, ctx, table, slab,
                            time_index=GREPTIME_TIMESTAMP,
                            value_field=GREPTIME_VALUE)
        batch = slab.to_batch(info.schema)
        total += query_engine._sharded_write(info, batch, delete=False)
    INGEST_ROWS.inc(total)
    return total


def _sanitize(metric: str) -> str:
    return re.sub(r"[^0-9a-zA-Z_]", "_", metric)


# ---------------------------------------------------------------- read


def parse_read_request(body: bytes) -> list[dict]:
    """Snappy+protobuf ReadRequest -> [{start_ms, end_ms, matchers}]."""
    raw = snappy.decompress(body)
    queries = []
    for field, _wt, v in pw.iter_fields(raw):
        if field != 1:
            continue
        q = {"start_ms": 0, "end_ms": 0, "matchers": []}
        for f2, wt2, v2 in pw.iter_fields(v):
            if f2 == 1:
                q["start_ms"] = pw.varint_to_sint64(v2)
            elif f2 == 2:
                q["end_ms"] = pw.varint_to_sint64(v2)
            elif f2 == 3:
                mtype, name, value = 0, "", ""
                for f3, _wt3, v3 in pw.iter_fields(v2):
                    if f3 == 1:
                        mtype = v3
                    elif f3 == 2:
                        name = v3.decode()
                    elif f3 == 3:
                        value = v3.decode()
                q["matchers"].append((mtype, name, value))
        queries.append(q)
    return queries


def handle_remote_read(query_engine, body: bytes, db: str = "public") -> bytes:
    """Evaluate a ReadRequest -> snappy-compressed ReadResponse."""
    queries = parse_read_request(body)
    ctx = QueryContext(db=db)
    results = b""
    for q in queries:
        metric = None
        for mtype, name, value in q["matchers"]:
            if name == "__name__" and mtype == 0:
                metric = _sanitize(value)
        series_blobs = b""
        if metric is not None:
            series_blobs = _query_series(query_engine, ctx, metric, q)
        results += pw.field_bytes(1, series_blobs)  # QueryResult
    resp = results
    return snappy.compress(resp)


def _query_series(query_engine, ctx, table: str, q: dict) -> bytes:
    try:
        info = query_engine._table(table, ctx)
    except CatalogError:
        return b""
    conds = [f"{GREPTIME_TIMESTAMP} >= {q['start_ms']}",
             f"{GREPTIME_TIMESTAMP} <= {q['end_ms']}"]
    for mtype, name, value in q["matchers"]:
        if name == "__name__":
            continue
        if name not in info.schema.names:
            if mtype in (0, 2) and value != "":
                return b""  # matcher on a label the table doesn't have
            continue
        esc = value.replace("'", "''")
        if mtype == 0:
            conds.append(f"{name} = '{esc}'")
        elif mtype == 1:
            conds.append(f"{name} != '{esc}'")
        # regex matchers (2, 3) filtered after scan below
    tag_names = [c.name for c in info.schema.tag_columns]
    sel_cols = ", ".join(tag_names + [GREPTIME_TIMESTAMP, GREPTIME_VALUE])
    sql = (f"SELECT {sel_cols} FROM {table} WHERE {' AND '.join(conds)} "
           f"ORDER BY {GREPTIME_TIMESTAMP}")
    res = query_engine.execute_one(sql, QueryContext(db=ctx.db))
    rows = res.rows()
    # regex matcher post-filter
    regex = [(re.compile(v), name, t == 3)
             for t, name, v in q["matchers"] if t in (2, 3) and name != "__name__"]
    # group rows into series by tag tuple
    series: dict[tuple, list[tuple[int, float]]] = defaultdict(list)
    n_tags = len(tag_names)
    for row in rows:
        tags = tuple(row[:n_tags])
        skip = False
        for rx, name, negate in regex:
            idx = tag_names.index(name) if name in tag_names else None
            val = "" if idx is None or tags[idx] is None else str(tags[idx])
            m = rx.fullmatch(val) is not None
            if m == negate:
                skip = True
                break
        if skip:
            continue
        ts, val = row[n_tags], row[n_tags + 1]
        if val is None:
            continue
        series[tags].append((int(ts), float(val)))
    out = b""
    for tags, samples in sorted(series.items(), key=lambda kv: kv[0]):
        labels = pw.field_bytes(
            1, pw.field_str(1, "__name__") + pw.field_str(2, table)
        )
        for name, value in zip(tag_names, tags):
            if value is None:
                continue
            labels += pw.field_bytes(1, pw.field_str(1, name) + pw.field_str(2, str(value)))
        sample_blobs = b""
        for ts, val in samples:
            sample_blobs += pw.field_bytes(2, pw.field_double(1, val) + pw.field_varint(2, ts))
        out += pw.field_bytes(1, labels + sample_blobs)  # TimeSeries
    return out
