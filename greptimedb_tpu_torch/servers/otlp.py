"""OTLP/HTTP metrics and traces ingestion (counterpart of
greptimedb_tpu/servers/otlp.py).

Mirrors reference src/servers/src/otlp/metrics.rs: an
ExportMetricsServiceRequest (protobuf) is flattened into per-metric tables —
data-point attributes become tags, `greptime_timestamp`/`greptime_value`
carry the sample. Gauge and Sum map directly; Histogram explodes into
`<name>_bucket` (le tag) / `<name>_sum` / `<name>_count` tables; Summary
into `<name>` with a `quantile` tag — the same shape Prometheus exporters
produce.
"""

from __future__ import annotations

import struct

from greptimedb_tpu_torch.servers.influx import Point, write_points
from greptimedb_tpu_torch.utils import protowire as pw
from greptimedb_tpu_torch.utils.metrics import REGISTRY

INGEST_ROWS = REGISTRY.counter(
    "greptimedb_tpu_otlp_rows_total", "Rows ingested via OTLP metrics"
)


def _any_value(data: bytes) -> str:
    for f, wt, v in pw.iter_fields(data):
        if f == 1:
            return v.decode()
        if f == 2:
            return "true" if v else "false"
        if f == 3:
            return str(pw.varint_to_sint64(v))
        if f == 4:
            return str(pw.fixed64_to_double(v))
    return ""


def _keyvalue(data: bytes) -> tuple[str, str]:
    key, val = "", ""
    for f, _wt, v in pw.iter_fields(data):
        if f == 1:
            key = v.decode()
        elif f == 2:
            val = _any_value(v)
    return key, val


def _number_point(data: bytes) -> tuple[dict, int, float]:
    attrs: dict[str, str] = {}
    ts_ns = 0
    value = 0.0
    for f, wt, v in pw.iter_fields(data):
        if f == 7:  # attributes
            k, val = _keyvalue(v)
            attrs[k] = val
        elif f == 3:  # time_unix_nano (fixed64)
            ts_ns = v
        elif f == 4:  # as_double
            value = pw.fixed64_to_double(v)
        elif f == 6:  # as_int (sfixed64)
            value = float(struct.unpack("<q", struct.pack("<Q", v))[0])
    return attrs, ts_ns, value


def _histogram_point(data: bytes):
    attrs: dict[str, str] = {}
    ts_ns = 0
    count = 0
    total = 0.0
    bucket_counts: list[int] = []
    bounds: list[float] = []
    for f, wt, v in pw.iter_fields(data):
        if f == 9:  # attributes
            k, val = _keyvalue(v)
            attrs[k] = val
        elif f == 3:
            ts_ns = v
        elif f == 4:  # count fixed64
            count = v
        elif f == 5:  # sum double
            total = pw.fixed64_to_double(v)
        elif f == 6:  # bucket_counts packed fixed64
            if isinstance(v, bytes):
                bucket_counts = [
                    struct.unpack("<Q", v[i:i + 8])[0] for i in range(0, len(v), 8)
                ]
        elif f == 7:  # explicit_bounds packed double
            if isinstance(v, bytes):
                bounds = [
                    struct.unpack("<d", v[i:i + 8])[0] for i in range(0, len(v), 8)
                ]
    return attrs, ts_ns, count, total, bucket_counts, bounds


def parse_metrics_request(body: bytes) -> list[Point]:
    """ExportMetricsServiceRequest -> flat list of Points."""
    points: list[Point] = []
    for f, _wt, rm in pw.iter_fields(body):
        if f != 1:  # resource_metrics
            continue
        resource_attrs: dict[str, str] = {}
        scope_metrics = []
        for f2, _wt2, v2 in pw.iter_fields(rm):
            if f2 == 1:  # Resource
                for f3, _wt3, v3 in pw.iter_fields(v2):
                    if f3 == 1:
                        k, val = _keyvalue(v3)
                        resource_attrs[k] = val
            elif f2 == 2:
                scope_metrics.append(v2)
        for sm in scope_metrics:
            for f3, _wt3, metric in pw.iter_fields(sm):
                if f3 != 2:  # Metric
                    continue
                points.extend(_metric_points(metric, resource_attrs))
    return points


def _metric_points(metric: bytes, resource_attrs: dict[str, str]) -> list[Point]:
    name = ""
    gauge_pts, sum_pts, hist_pts = [], [], []
    for f, _wt, v in pw.iter_fields(metric):
        if f == 1:
            name = v.decode()
        elif f == 5:  # Gauge
            for f2, _wt2, dp in pw.iter_fields(v):
                if f2 == 1:
                    gauge_pts.append(dp)
        elif f == 7:  # Sum
            for f2, _wt2, dp in pw.iter_fields(v):
                if f2 == 1:
                    sum_pts.append(dp)
        elif f == 9:  # Histogram
            for f2, _wt2, dp in pw.iter_fields(v):
                if f2 == 1:
                    hist_pts.append(dp)
    table = _sanitize(name)
    out: list[Point] = []
    for dp in gauge_pts + sum_pts:
        attrs, ts_ns, value = _number_point(dp)
        tags = sorted({**resource_attrs, **attrs}.items())
        out.append(Point(measurement=table, tags=tags,
                         fields=[("greptime_value", value)], ts=ts_ns // 1_000_000))
    for dp in hist_pts:
        attrs, ts_ns, count, total, bucket_counts, bounds = _histogram_point(dp)
        base_tags = {**resource_attrs, **attrs}
        ts_ms = ts_ns // 1_000_000
        cum = 0
        for i, bc in enumerate(bucket_counts):
            cum += bc
            le = repr(bounds[i]) if i < len(bounds) else "+Inf"
            out.append(Point(measurement=table + "_bucket",
                             tags=sorted({**base_tags, "le": le}.items()),
                             fields=[("greptime_value", float(cum))], ts=ts_ms))
        out.append(Point(measurement=table + "_sum", tags=sorted(base_tags.items()),
                         fields=[("greptime_value", total)], ts=ts_ms))
        out.append(Point(measurement=table + "_count", tags=sorted(base_tags.items()),
                         fields=[("greptime_value", float(count))], ts=ts_ms))
    return out


def _sanitize(name: str) -> str:
    import re

    return re.sub(r"[^0-9a-zA-Z_]", "_", name) or "unknown_metric"


def handle_otlp_metrics(query_engine, body: bytes, db: str = "public") -> int:
    points = parse_metrics_request(body)
    n = write_points(query_engine, db, points, precision="ms")
    INGEST_ROWS.inc(n)
    return n


# ---------------------------------------------------------------- traces

TRACE_TABLE_NAME = "opentelemetry_traces"

TRACE_ROWS = REGISTRY.counter(
    "greptimedb_tpu_otlp_trace_rows_total", "Spans ingested via OTLP traces"
)

_SPAN_KINDS = {0: "SPAN_KIND_UNSPECIFIED", 1: "SPAN_KIND_INTERNAL",
               2: "SPAN_KIND_SERVER", 3: "SPAN_KIND_CLIENT",
               4: "SPAN_KIND_PRODUCER", 5: "SPAN_KIND_CONSUMER"}
_STATUS_CODES = {0: "STATUS_CODE_UNSET", 1: "STATUS_CODE_OK",
                 2: "STATUS_CODE_ERROR"}


def _attrs_json(pairs: dict) -> str:
    import json as _json

    return _json.dumps(pairs, sort_keys=True)


def _span_to_point(span: bytes, resource_attrs: dict, scope_name: str,
                   scope_version: str) -> Point:
    """One OTLP Span message -> one row (reference
    servers/src/otlp/trace.rs write_span_to_row: trace ids are tags,
    everything else fields, time index = span start)."""
    trace_id = span_id = parent_span_id = ""
    name = trace_state = ""
    kind = 0
    start_ns = end_ns = 0
    attrs: dict[str, str] = {}
    status_code, status_msg = 0, ""
    n_events = n_links = 0
    for f, _wt, v in pw.iter_fields(span):
        if f == 1:
            trace_id = v.hex()
        elif f == 2:
            span_id = v.hex()
        elif f == 3:
            trace_state = v.decode()
        elif f == 4:
            parent_span_id = v.hex()
        elif f == 5:
            name = v.decode()
        elif f == 6:
            kind = v
        elif f == 7:
            start_ns = v
        elif f == 8:
            end_ns = v
        elif f == 9:
            k, val = _keyvalue(v)
            attrs[k] = val
        elif f == 11:
            n_events += 1
        elif f == 13:
            n_links += 1
        elif f == 15:
            for f2, _wt2, sv in pw.iter_fields(v):
                if f2 == 2:
                    status_msg = sv.decode()
                elif f2 == 3:
                    status_code = sv
    return Point(
        measurement=TRACE_TABLE_NAME,
        tags=[("trace_id", trace_id), ("span_id", span_id),
              ("parent_span_id", parent_span_id)],
        fields=[
            ("resource_attributes", _attrs_json(resource_attrs)),
            ("scope_name", scope_name),
            ("scope_version", scope_version),
            ("trace_state", trace_state),
            ("span_name", name),
            ("span_kind", _SPAN_KINDS.get(int(kind), str(kind))),
            ("span_status_code", _STATUS_CODES.get(int(status_code),
                                                   str(status_code))),
            ("span_status_message", status_msg),
            ("span_attributes", _attrs_json(attrs)),
            ("span_events_count", float(n_events)),
            ("span_links_count", float(n_links)),
            ("end", int(end_ns)),
            ("duration_nano", float(max(end_ns - start_ns, 0))),
        ],
        ts=start_ns // 1_000_000,
    )


def parse_traces_request(body: bytes) -> list[Point]:
    """ExportTraceServiceRequest: resource_spans(1) -> resource(1) +
    scope_spans(2) -> scope(1) + spans(2)."""
    out: list[Point] = []
    for f, _wt, rs in pw.iter_fields(body):
        if f != 1:
            continue
        resource_attrs: dict[str, str] = {}
        scope_blocks: list[bytes] = []
        for f2, _wt2, v in pw.iter_fields(rs):
            if f2 == 1:  # Resource
                for f3, _wt3, kv in pw.iter_fields(v):
                    if f3 == 1:
                        k, val = _keyvalue(kv)
                        resource_attrs[k] = val
            elif f2 == 2:  # ScopeSpans
                scope_blocks.append(v)
        for block in scope_blocks:
            scope_name = scope_version = ""
            spans: list[bytes] = []
            for f2, _wt2, v in pw.iter_fields(block):
                if f2 == 1:  # InstrumentationScope
                    for f3, _wt3, sv in pw.iter_fields(v):
                        if f3 == 1:
                            scope_name = sv.decode()
                        elif f3 == 2:
                            scope_version = sv.decode()
                elif f2 == 2:
                    spans.append(v)
            for span in spans:
                out.append(_span_to_point(span, resource_attrs, scope_name,
                                          scope_version))
    return out


def handle_otlp_traces(query_engine, body: bytes, db: str = "public") -> int:
    points = parse_traces_request(body)
    n = write_points(query_engine, db, points, precision="ms")
    TRACE_ROWS.inc(n)
    return n
