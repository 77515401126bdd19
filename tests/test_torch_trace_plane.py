"""Port twin of tests/test_trace_plane.py: span trees with parent/child
nesting and self-time, the trace-id ring index, W3C traceparent at every
ingress, the OTLP exporter (golden payload, sampling, tail keep, typed
degradation), the per-query resource ledger and OpenMetrics exemplars —
over greptimedb_tpu_torch on the CPU.

The JAX tests' cluster cases (Flight piggyback) stay with the mesh and
cluster slice. Every server and exporter started here is stopped, and
its threads are joined (checked by `_no_plane_threads`).
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time
import urllib.request

import pytest

from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils import ledger, otlp_trace, slow_query, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: thread names the observability plane starts; none may outlive a test
PLANE_THREADS = ("gtpu-flame-sampler", "gtpu-otlp-export",
                 "gtpu-export-metrics", "gtpu-telemetry", "gtpu-http-serve")


def _no_plane_threads():
    alive = [t.name for t in threading.enumerate()
             if t.name in PLANE_THREADS]
    assert not alive, alive


@pytest.fixture
def qe(tmp_path):
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "data"),
                                       maintenance_workers=0),
                          device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    yield qe
    qe.concurrency.shutdown()
    engine.close()


def _seed(qe, rows=64):
    qe.execute_one(
        "CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP TIME INDEX, "
        "PRIMARY KEY(host))")
    vals = ", ".join(f"('h{i % 4}', {float(i)}, {1000 * (i + 1)})"
                     for i in range(rows))
    qe.execute_one(f"INSERT INTO cpu VALUES {vals}")


# ---- span trees -------------------------------------------------------------


class TestSpanTree:
    def test_nesting_assigns_parent_ids(self):
        tid = tracing.set_trace(None)
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d"):
                pass
        spans = {s.name: s for s in tracing.spans_for(tid)}
        assert spans["a"].parent_id is None
        assert spans["b"].parent_id == spans["a"].span_id
        assert spans["c"].parent_id == spans["b"].span_id
        assert spans["d"].parent_id == spans["a"].span_id
        assert len({s.span_id for s in spans.values()}) == 4

    def test_tree_order_and_self_time(self):
        tid = tracing.set_trace(None)
        with tracing.span("root"):
            with tracing.span("first"):
                time.sleep(0.01)
            with tracing.span("second"):
                pass
        rows = tracing.span_tree(tracing.spans_for(tid))
        assert [(d, s.name) for d, s, _ in rows] == \
            [(0, "root"), (1, "first"), (1, "second")]
        root_row = rows[0]
        kids_ms = rows[1][1].duration_ms + rows[2][1].duration_ms
        assert 0.0 <= root_row[2] <= root_row[1].duration_ms
        assert root_row[2] == pytest.approx(
            root_row[1].duration_ms - kids_ms, abs=1.0)

    def test_render_marks_remote_nodes_and_self_time(self):
        tid = tracing.set_trace(None)
        with tracing.span("outer"):
            pass
        spans = tracing.spans_for(tid)
        remote = tracing.Span(tid, "region_scan", 1.5, time.time(),
                              {"rows": 7}, node="dn-1",
                              span_id="feedbeef00000001",
                              parent_id=spans[0].span_id)
        lines = tracing.render_tree(spans + [remote])
        assert any(ln.strip() == "[dn-1]" for ln in lines)
        scan = next(ln for ln in lines if "region_scan" in ln)
        assert "rows=7" in scan
        outer = next(ln for ln in lines if ln.strip().startswith("outer"))
        assert "(self " in outer
        assert len(scan) - len(scan.lstrip()) > \
            len(outer) - len(outer.lstrip())

    def test_parallel_children_never_negative_self_time(self):
        parent = tracing.Span("t" * 16, "scan", 12.0, 100.0, {},
                              span_id="aa" * 8)
        kids = [tracing.Span("t" * 16, f"decode{i}", 10.0, 100.001, {},
                             span_id=f"{i:016x}", parent_id="aa" * 8)
                for i in range(4)]
        rows = tracing.span_tree([parent] + kids)
        assert rows[0][2] == pytest.approx(2.0, abs=0.1)
        wide = tracing.Span("t" * 16, "huge", 50.0, 100.0, {},
                            span_id="ee" * 8, parent_id="aa" * 8)
        rows = tracing.span_tree([parent, wide])
        assert rows[0][2] == 0.0

    def test_orphan_parent_renders_as_root(self):
        s = tracing.Span("t", "lonely", 1.0, 0.0, {},
                         span_id="ab" * 8, parent_id="cd" * 8)
        assert tracing.span_tree([s]) == [(0, s, 1.0)]

    def test_disabled_records_nothing(self, monkeypatch):
        monkeypatch.setenv("GTPU_TRACING", "off")
        tid = tracing.set_trace(None)
        with tracing.span("ghost"):
            pass
        assert tracing.spans_for(tid) == []
        with ledger.attach() as led:
            assert led is None
        from greptimedb_tpu_torch.utils.metrics import Histogram

        h = Histogram("greptimedb_tpu_gate_test_seconds", "t",
                      exemplars=True)
        h.observe(0.01, stage="x")
        assert h._exemplar == {}


class TestRingIndex:
    def test_spans_for_uses_index_and_evicts_with_ring(self):
        doomed = tracing.set_trace(None)
        with tracing.span("old"):
            pass
        assert len(tracing.spans_for(doomed)) == 1
        for _ in range(tracing._RING_CAP + 10):
            tracing.set_trace(None)
            with tracing.span("filler"):
                pass
        assert tracing.spans_for(doomed) == []
        with tracing._ring_lock:
            assert len(tracing._SPANS) <= tracing._RING_CAP
            assert len(tracing._BY_TRACE) <= tracing._RING_CAP
            assert doomed not in tracing._BY_TRACE

    def test_merge_dedupes_by_span_id(self):
        tracing.set_trace(None)
        with tracing.collect_spans() as sink:
            with tracing.span("region_scan"):
                pass
        wire = tracing.spans_to_wire(sink)
        assert wire[0]["span_id"] and "parent_id" in wire[0]
        assert tracing.merge_spans(wire, node="dn-0") == []
        tracing.set_trace(None)
        merged = tracing.merge_spans(wire, node="dn-0")
        assert len(merged) == 1
        assert merged[0].span_id == wire[0]["span_id"]


# ---- W3C trace context ------------------------------------------------------


class TestTraceparent:
    def test_round_trip(self):
        tid = tracing.set_trace(None)
        with tracing.span("x"):
            tp = tracing.to_traceparent()
        parsed = tracing.parse_traceparent(tp)
        assert parsed is not None and parsed[0] == tid

    def test_malformed_rejected(self):
        for bad in ("", "garbage", "00-zz-bb-01",
                    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
                    "ff-" + "1" * 32 + "-" + "2" * 16 + "-01"):
            assert tracing.parse_traceparent(bad) is None

    def test_full_32_char_id_adopted_verbatim(self):
        tp = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
        tid, parent = tracing.parse_traceparent(tp)
        assert tid == "4bf92f3577b34da6a3ce929d0e0e4736"
        assert parent == "00f067aa0ba902b7"
        assert tracing.to_traceparent(tid, parent) == tp

    def test_sql_comment_carrier(self):
        tp = "00-" + "0" * 16 + "feedbeefcafe0001-00f067aa0ba902b7-01"
        sql = f"/* traceparent='{tp}' */ SELECT 1"
        assert tracing.traceparent_from_sql(sql) == tp
        assert tracing.traceparent_from_sql("SELECT 1") is None

    def test_http_ingress_and_egress(self, qe):
        from greptimedb_tpu_torch.servers import HttpServer

        _seed(qe)
        srv = HttpServer(qe, port=0)
        port = srv.start()
        tid = "4bf92f3577b34da6a3ce929d0e0e4736"
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            body = "sql=" + urllib.request.quote(
                "SELECT count(*) FROM cpu")
            conn.request("POST", "/v1/sql", body=body, headers={
                "Content-Type": "application/x-www-form-urlencoded",
                "traceparent": f"00-{tid}-00f067aa0ba902b7-01"})
            resp = conn.getresponse()
            resp.read()
            echoed = resp.getheader("traceparent")
            assert resp.status == 200
            assert echoed and tracing.parse_traceparent(echoed)[0] == tid
            # the request root span records at request_span exit, after
            # the response bytes went out: poll briefly
            deadline = time.time() + 5.0
            names: set = set()
            while time.time() < deadline:
                names = {s.name for s in tracing.spans_for(tid)}
                if "http:/v1/sql" in names:
                    break
                time.sleep(0.01)
            assert "http:/v1/sql" in names and "stmt:Select" in names
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/traces/{tid}") as r2:
                out = json.loads(r2.read())
            assert out["trace_id"] == tid
            conn.request("POST", "/v1/sql", body=body, headers={
                "Content-Type": "application/x-www-form-urlencoded"})
            resp2 = conn.getresponse()
            resp2.read()
            minted = tracing.parse_traceparent(
                resp2.getheader("traceparent"))[0]
            assert len(minted) == 16
            padded = minted.rjust(32, "0")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/traces/{padded}") as r3:
                assert json.loads(r3.read())["trace_id"] == minted
            tree = "\n".join(out["tree"])
            assert "http:/v1/sql" in tree and "stmt:Select" in tree
            assert any(s["span_id"] for s in out["spans"])
            conn.close()
        finally:
            srv.stop()
        _no_plane_threads()

    def test_mysql_comment_ingress(self, qe):
        from greptimedb_tpu_torch.servers.mysql import _dispatch

        _seed(qe)
        tid = "feedbeefcafe7777"
        tp = f"00-{tid.rjust(32, '0')}-00f067aa0ba902b7-01"
        kind, res = _dispatch(
            qe, f"/* traceparent='{tp}' */ SELECT count(*) FROM cpu",
            QueryContext())
        assert kind == "result" and res.rows()[0][0] == 64
        names = {s.name for s in tracing.spans_for(tid)}
        assert "mysql:query" in names and "stmt:Select" in names


# ---- OTLP export ------------------------------------------------------------


class _Collector:
    """Tiny in-process OTLP/HTTP sink: records every POSTed payload."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        self.payloads: list = []
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                outer.payloads.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = HTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def spans(self) -> list:
        return [s for p in self.payloads
                for r in p.get("resourceSpans", ())
                for sc in r["scopeSpans"]
                for s in sc["spans"]]

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


@pytest.fixture
def no_exporter():
    yield
    otlp_trace.configure(None)
    _no_plane_threads()


class TestOtlpExport:
    def test_golden_payload(self):
        spans = [
            tracing.Span("feedbeefcafe0001", "stmt:Select", 12.5,
                         1700000000.0, {"rows": 4, "cold": False,
                                        "path": "dense"},
                         span_id="aa" * 8),
            tracing.Span("feedbeefcafe0001", "scan", 3.25, 1700000000.001,
                         {"bytes": 1024}, node="dn-1",
                         span_id="bb" * 8, parent_id="aa" * 8),
        ]
        p = otlp_trace.payload(spans, node="frontend-0")
        rs, = p["resourceSpans"]
        attrs = {a["key"]: a["value"] for a in rs["resource"]["attributes"]}
        assert attrs["service.name"] == {"stringValue": "greptimedb_tpu"}
        assert attrs["service.instance.id"] == {"stringValue": "frontend-0"}
        s0, s1 = rs["scopeSpans"][0]["spans"]
        assert s0["traceId"] == "feedbeefcafe0001".rjust(32, "0")
        assert s0["spanId"] == "aa" * 8
        assert "parentSpanId" not in s0
        assert s0["startTimeUnixNano"] == str(int(1700000000.0 * 1e9))
        assert int(s0["endTimeUnixNano"]) - int(s0["startTimeUnixNano"]) \
            == int(12.5 * 1e6)
        a0 = {a["key"]: a["value"] for a in s0["attributes"]}
        assert a0["rows"] == {"intValue": "4"}
        assert a0["cold"] == {"boolValue": False}
        assert a0["path"] == {"stringValue": "dense"}
        assert s1["parentSpanId"] == "aa" * 8
        a1 = {a["key"]: a["value"] for a in s1["attributes"]}
        assert a1["gtpu.node"] == {"stringValue": "dn-1"}

    def test_exports_spans_end_to_end(self, no_exporter):
        col = _Collector()
        try:
            exp = otlp_trace.configure(
                f"http://127.0.0.1:{col.port}", flush_interval_s=0.05)
            tid = tracing.set_trace(None)
            with tracing.span("exported_span", rows=1):
                pass
            assert exp.flush(timeout_s=5.0)
            names = [s["name"] for s in col.spans()]
            assert "exported_span" in names
            assert tid.rjust(32, "0") in [s["traceId"] for s in col.spans()]
        finally:
            otlp_trace.configure(None)
            col.stop()

    def test_query_spans_exported_equal_recorded(self, qe, no_exporter):
        """Every span a statement records is exported, none dropped."""
        from greptimedb_tpu_torch.utils.otlp_trace import OTLP_TRACE_SPANS

        _seed(qe)
        col = _Collector()
        try:
            exp = otlp_trace.configure(
                f"http://127.0.0.1:{col.port}", flush_interval_s=0.05)
            dropped = OTLP_TRACE_SPANS.total(event="dropped")
            ctx = QueryContext()
            qe.execute_sql("SELECT host, avg(v) FROM cpu GROUP BY host",
                           ctx)
            assert exp.flush(timeout_s=5.0)
            recorded = {s.span_id for s in tracing.spans_for(ctx.trace_id)}
            exported = {s["spanId"] for s in col.spans()
                        if s["traceId"] == ctx.trace_id.rjust(32, "0")}
            assert recorded and exported == recorded
            assert OTLP_TRACE_SPANS.total(event="dropped") == dropped
        finally:
            otlp_trace.configure(None)
            col.stop()

    def test_dead_endpoint_degrades_typed_without_query_impact(
            self, qe, no_exporter):
        from greptimedb_tpu_torch.utils.otlp_trace import OTLP_TRACE_SPANS

        _seed(qe)
        otlp_trace.configure("http://127.0.0.1:1", flush_interval_s=0.05,
                             timeout_s=0.2)
        before = OTLP_TRACE_SPANS.total(event="failed")
        r = qe.execute_one("SELECT count(*) FROM cpu")
        assert r.rows()[0][0] == 64
        otlp_trace.exporter().flush(timeout_s=5.0)
        assert OTLP_TRACE_SPANS.total(event="failed") > before

    def test_injected_fault_counts_failed(self, no_exporter):
        from greptimedb_tpu_torch.fault import FAULTS, Fault
        from greptimedb_tpu_torch.utils.otlp_trace import OTLP_TRACE_SPANS

        col = _Collector()
        try:
            exp = otlp_trace.configure(
                f"http://127.0.0.1:{col.port}", flush_interval_s=0.05)
            FAULTS.arm("otlp.export", Fault(kind="fail", times=1))
            before = OTLP_TRACE_SPANS.total(event="failed")
            tracing.set_trace(None)
            with tracing.span("faulted"):
                pass
            exp.flush(timeout_s=5.0)
            assert OTLP_TRACE_SPANS.total(event="failed") > before
        finally:
            FAULTS.disarm("otlp.export")
            otlp_trace.configure(None)
            col.stop()

    def test_queue_overflow_drops_counted(self, no_exporter):
        from greptimedb_tpu_torch.utils.otlp_trace import OTLP_TRACE_SPANS

        exp = otlp_trace.OtlpTraceExporter("http://127.0.0.1:1",
                                           queue_size=4)
        exp._stop = True  # worker never drains: pure queue mechanics
        before = OTLP_TRACE_SPANS.total(event="dropped")
        for i in range(10):
            exp.on_span(tracing.Span("t" * 16, f"s{i}", 1.0, 0.0, {},
                                     span_id=f"{i:016x}"))
        assert exp.depth() == 4
        assert OTLP_TRACE_SPANS.total(event="dropped") == before + 6

    def test_head_sampling_and_tail_keep(self, no_exporter):
        from greptimedb_tpu_torch.utils.otlp_trace import OTLP_TRACE_SPANS

        exp = otlp_trace.OtlpTraceExporter("http://127.0.0.1:1",
                                           sample_ratio=0.0)
        exp._stop = True
        s = tracing.Span("feedbeefcafe0002", "slow_stmt", 99.0, 0.0, {},
                         span_id="cc" * 8)
        exp.on_span(s)
        assert exp.depth() == 0
        before = OTLP_TRACE_SPANS.total(event="kept")
        exp.mark_keep("feedbeefcafe0002")
        assert exp.depth() == 1
        assert OTLP_TRACE_SPANS.total(event="kept") == before + 1
        exp.on_span(tracing.Span("feedbeefcafe0002", "later", 1.0, 0.0,
                                 {}, span_id="dd" * 8))
        assert exp.depth() == 2

    def test_slow_query_marks_keep(self, qe, monkeypatch, no_exporter):
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
        slow_query.clear()
        exp = otlp_trace.configure("http://127.0.0.1:1",
                                   sample_ratio=0.0,
                                   flush_interval_s=30.0)
        _seed(qe)
        qe.execute_one("SELECT count(*) FROM cpu")
        rec = slow_query.records(1)[0]
        with exp._cv:
            assert rec.trace_id in exp._keep
        slow_query.clear()


# ---- per-query resource ledger ----------------------------------------------


class TestLedger:
    @pytest.fixture(autouse=True)
    def _fast_threshold(self, monkeypatch):
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
        slow_query.clear()
        yield
        slow_query.clear()

    def test_slow_record_carries_ledger(self, qe):
        _seed(qe)
        qe.execute_one("SELECT host, avg(v) FROM cpu GROUP BY host")
        rec = next(r for r in slow_query.records()
                   if r.query.startswith("SELECT host"))
        assert rec.ledger.get("rows_scanned") == 64
        assert [k for k in rec.ledger if k.startswith("cache.")]
        assert rec.ledger.get("agg_ms", 0) > 0
        assert rec.to_dict()["ledger"] == rec.ledger

    def test_root_span_stamped_with_ledger(self, qe):
        _seed(qe)
        ctx = QueryContext()
        qe.execute_sql("SELECT count(*) FROM cpu", ctx)
        stmt = next(s for s in tracing.spans_for(ctx.trace_id)
                    if s.name == "stmt:Select")
        assert "rows_scanned=64" in stmt.attrs.get("ledger", "")

    def test_explain_analyze_prints_ledger(self, qe):
        _seed(qe)
        r = qe.execute_one(
            "EXPLAIN ANALYZE SELECT host, avg(v) FROM cpu GROUP BY host")
        text = "\n".join(row[0] for row in r.rows())
        assert "resource ledger:" in text
        assert "rows_scanned=64" in text

    def test_host_device_split_does_not_double_count(self, qe):
        _seed(qe)
        qe.execute_one("SELECT host, avg(v) FROM cpu GROUP BY host")
        rec = next(r for r in slow_query.records()
                   if "GROUP BY" in r.query)
        agg, dev = rec.ledger["agg_ms"], rec.ledger["device_ms"]
        assert rec.ledger["host_ms"] == pytest.approx(agg - dev, abs=0.01)

    def test_threaded_parity_with_serial(self, qe):
        """Per-request ledgers under concurrency equal the serial
        baseline: no cross-thread leakage, no lost counts."""
        _seed(qe)
        queries = [f"SELECT host, v FROM cpu WHERE ts >= {1000 + i}"
                   for i in range(20)]
        for q in queries:  # warm lane and caches so both passes match
            qe.execute_one(q)
        slow_query.clear()
        for q in queries:
            qe.execute_one(q)
        serial = {r.query: r.ledger.get("rows_scanned")
                  for r in slow_query.records()}
        assert len(serial) == 20
        slow_query.clear()
        threads = [threading.Thread(target=qe.execute_one, args=(q,))
                   for q in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        threaded = {r.query: r.ledger.get("rows_scanned")
                    for r in slow_query.records()}
        assert threaded == serial


# ---- OpenMetrics exemplars --------------------------------------------------


class TestExemplars:
    def test_stage_bucket_links_a_trace(self, qe):
        sys.path.insert(0, REPO)
        from tools.check_metrics import check_exemplars

        from greptimedb_tpu_torch.utils.metrics import REGISTRY

        _seed(qe)
        ctx = QueryContext()
        qe.execute_sql("SELECT count(*) FROM cpu", ctx)
        om = REGISTRY.render(openmetrics=True)
        ex_lines = [ln for ln in om.splitlines()
                    if "greptimedb_tpu_query_stage_seconds_bucket" in ln
                    and " # " in ln]
        assert ex_lines, "no stage-histogram exemplar rendered"
        assert any(f'trace_id="{ctx.trace_id}"' in ln for ln in ex_lines)
        assert check_exemplars(om) == []
        classic = REGISTRY.render()
        assert not any(" # " in ln for ln in classic.splitlines()
                       if not ln.startswith("#"))
        assert not classic.rstrip().endswith("# EOF")

    def test_openmetrics_counter_family_drops_total_suffix(self):
        from greptimedb_tpu_torch.utils.metrics import Counter

        c = Counter("greptimedb_tpu_widget_total", "widgets")
        c.inc(kind="a")
        om = c.render(exemplars=True)
        assert om[0] == "# HELP greptimedb_tpu_widget widgets"
        assert om[1] == "# TYPE greptimedb_tpu_widget counter"
        assert om[2].startswith("greptimedb_tpu_widget_total{")
        assert c.render()[1] == "# TYPE greptimedb_tpu_widget_total counter"

    def test_http_metrics_content_negotiation(self, qe):
        from greptimedb_tpu_torch.servers import HttpServer

        _seed(qe)
        qe.execute_one("SELECT count(*) FROM cpu")
        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/metrics",
                headers={"Accept": "application/openmetrics-text"})
            with urllib.request.urlopen(req) as resp:
                assert "openmetrics-text" in resp.headers["Content-Type"]
                body = resp.read().decode()
            assert body.rstrip().endswith("# EOF")
            assert 'trace_id="' in body
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics") as resp:
                assert "text/plain" in resp.headers["Content-Type"]
                assert not resp.read().decode().rstrip().endswith("# EOF")
        finally:
            srv.stop()
        _no_plane_threads()

    def test_grafana_dashboard_reads_the_port(self):
        """Every family the port registers keeps a JAX name that the
        repo's dashboard charts (tools/check_metrics.py's rule), apart
        from the port's own Flight series, listed with their reason in
        the lint's PORT_ONLY (pyarrow counts them in the JAX package)."""
        sys.path.insert(0, REPO)
        from tools.check_metrics import DASHBOARD, check

        import greptimedb_tpu_torch.servers.otlp  # noqa: F401
        import greptimedb_tpu_torch.servers.prom_store  # noqa: F401
        from greptimedb_tpu_torch.lint.metrics_options import PORT_ONLY
        from greptimedb_tpu_torch.utils.metrics import REGISTRY

        with open(DASHBOARD, encoding="utf-8") as f:
            text = f.read()
        assert set(PORT_ONLY) == {"greptimedb_tpu_flight_calls_total",
                                  "greptimedb_tpu_flight_bytes_total"}
        assert check([m for m in REGISTRY._metrics
                      if m.name not in PORT_ONLY], text) == []


# ---- tools/trace_dump -------------------------------------------------------


class TestTraceDump:
    def test_fetch_and_render(self, qe):
        sys.path.insert(0, REPO)
        from tools.trace_dump import fetch

        from greptimedb_tpu_torch.servers import HttpServer

        _seed(qe)
        ctx = QueryContext()
        qe.execute_sql("SELECT host, avg(v) FROM cpu GROUP BY host", ctx)
        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            out = fetch(f"127.0.0.1:{port}", ctx.trace_id)
            assert out["trace_id"] == ctx.trace_id
            tree = out["tree"]
            assert any("stmt:Select" in ln for ln in tree)
            assert any("device_agg" in ln for ln in tree)
            with pytest.raises(urllib.request.HTTPError):
                fetch(f"127.0.0.1:{port}", "deadbeef00000000")
        finally:
            srv.stop()
        _no_plane_threads()
