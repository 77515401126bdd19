"""Port twin of tests/test_profile_plane.py: the always-on flame sampler
(stage and path attribution, bounded windows, profiler-thread
exclusion, a joined thread on shutdown), the roofline accountant (golden
folds, the card's own peak, span / slow-query / ANALYZE stamps that agree
with the ledger), the /v1/profile and /debug/pprof endpoints, the OTLP
log lane and the [profiling] options — over greptimedb_tpu_torch on the
CPU.

The JAX tests' cluster rollup (heartbeat and Flight digests) waits for
the port's cluster; `cluster_view` here holds the local node only.
Environment knobs are set through monkeypatch: both packages read the
same GTPU_* variables in one process.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils import (
    flame,
    otlp_trace,
    profiling,
    roofline,
    slow_query,
    tracing,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture
def sampler_off():
    """Every test leaves the process sampler stopped (its thread joined)
    and the windows empty."""
    flame.shutdown()
    flame.reset()
    yield
    flame.shutdown()
    flame.reset()
    assert not any(t.name == "gtpu-flame-sampler"
                   for t in threading.enumerate())


def _spin_ms(ms: float) -> float:
    """Busy CPU loop the sampler can land on (sleeps are idle-filtered)."""
    t0 = time.perf_counter()
    x = 0.0
    while (time.perf_counter() - t0) * 1000 < ms:
        x += sum(i * i for i in range(200))
    return x


# ---- roofline accountant ----------------------------------------------------


class TestRooflineAccountant:
    def test_golden_fold(self, monkeypatch):
        monkeypatch.setenv("GTPU_ROOFLINE_PEAK_GBPS", "100")
        led = {"h2d_bytes": 6_000_000, "d2h_bytes": 1_000_000,
               "bytes_decoded": 3_000_000, "device_ms": 20.0,
               "rows_scanned": 1000}
        rf = roofline.account(led)
        assert rf["bytes_total"] == 10_000_000
        assert rf["achieved_gbps"] == pytest.approx(0.5)
        assert rf["roofline_fraction"] == pytest.approx(0.005)
        assert rf["arithmetic_intensity"] == pytest.approx(2e-4)
        assert rf["window_ms"] == 20.0
        assert rf["peak_gbps"] == 100.0

    def test_time_preference_device_then_agg_then_duration(self):
        base = {"h2d_bytes": 1_000_000_000}
        assert roofline.account({**base, "device_ms": 100.0,
                                 "agg_ms": 999.0},
                                duration_ms=5555.0)["window_ms"] == 100.0
        assert roofline.account({**base, "agg_ms": 200.0},
                                duration_ms=5555.0)["window_ms"] == 200.0
        assert roofline.account(base,
                                duration_ms=400.0)["window_ms"] == 400.0

    def test_host_only_statement_stamps_nothing(self):
        assert roofline.account({"device_ms": 10.0}) is None
        assert roofline.account({"h2d_bytes": 1024}) is None
        assert roofline.account({}) is None
        attrs = {}
        assert roofline.stamp(attrs, {"agg_ms": 3.0}) is None
        assert attrs == {}

    def test_stamp_writes_rounded_attrs(self, monkeypatch):
        monkeypatch.setenv("GTPU_ROOFLINE_PEAK_GBPS", "3350")
        attrs = {}
        rf = roofline.stamp(
            attrs, {"h2d_bytes": 3_350_000_000, "device_ms": 1000.0})
        assert attrs["achieved_gbps"] == pytest.approx(3.35)
        assert attrs["roofline_fraction"] == pytest.approx(0.001)
        assert rf["bytes_total"] == 3_350_000_000

    def test_peak_env_override_and_host_stand_in(self, monkeypatch):
        monkeypatch.setenv("GTPU_ROOFLINE_PEAK_GBPS", "123.5")
        assert roofline.peak_gbps() == 123.5
        monkeypatch.delenv("GTPU_ROOFLINE_PEAK_GBPS")
        assert roofline.peak_gbps("cpu") == 100.0
        monkeypatch.setenv("GTPU_ROOFLINE_PEAK_GBPS", "not-a-number")
        assert roofline.peak_gbps("cpu") == 100.0
        # the port holds no accelerator figure of its own: a card's peak
        # is read from the card (see the next test)
        assert set(roofline._PEAKS) == {"cpu"}

    def test_card_peak_read_from_the_card(self, monkeypatch):
        """A CUDA engine's peak comes from the kernel library's
        cudaDeviceGetAttribute read, once per card."""
        import torch

        monkeypatch.delenv("GTPU_ROOFLINE_PEAK_GBPS", raising=False)
        calls = []

        def fake_peak(index):
            calls.append(index)
            return 3352.32

        monkeypatch.setattr(roofline, "card_peak_gbps", fake_peak)
        monkeypatch.setattr(roofline, "_DEVICE", torch.device("cuda", 0))
        assert roofline._link() == {"backend": "gpu", "colocated": True,
                                    "index": 0}
        assert roofline.peak_gbps() == 3352.32
        assert calls == [0]
        monkeypatch.setattr(roofline, "_DEVICE", torch.device("cpu"))
        assert roofline.peak_gbps() == 100.0

    def test_format_line_stable(self):
        rf = roofline.account({"h2d_bytes": 2_000_000, "device_ms": 4.0},
                              peak=100.0)
        line = roofline.format_line(rf)
        assert "achieved_gbps=0.5" in line
        assert "bytes=2000000" in line
        assert "peak_gbps=100" in line


# ---- continuous sampler -----------------------------------------------------


class TestContinuousSampler:
    def test_attributes_stage_and_path(self, sampler_off):
        flame.configure(enabled=True, hz=250.0, window_s=30.0)
        tracing.set_trace(None)
        with tracing.span("stmt:Select"):
            flame.note_path("dense_fused")
            _spin_ms(600)
        folded = flame.folded()
        assert folded.startswith("# flame:")
        body = [ln for ln in folded.splitlines()[1:] if ln]
        assert body, "sampler captured nothing in 600 ms @ 250 Hz"
        assert [ln for ln in body
                if ln.startswith("stage:stmt:Select;path:dense_fused;")]
        summ = flame.summary()
        assert summ["samples"] > 0
        assert summ["stages"].get("stmt", 0) > 0
        assert summ["paths"].get("dense_fused", 0) > 0

    def test_executor_path_setter_feeds_attribution(self, qe, sampler_off):
        flame.configure(enabled=True, hz=250.0)
        qe.executor.last_path = "dense_prepared"
        assert flame._PATHS[threading.get_ident()] == "dense_prepared"

    def test_stage_filter_and_speedscope_document(self, sampler_off):
        flame.configure(enabled=True, hz=250.0)
        with tracing.span("stmt:Select"):
            _spin_ms(300)
        only = flame.folded(stage="stmt")
        assert all(ln.startswith(("#", "stage:stmt"))
                   for ln in only.splitlines() if ln)
        doc = flame.speedscope()
        assert doc["$schema"].endswith("file-format-schema.json")
        prof, = doc["profiles"]
        assert prof["type"] == "sampled"
        assert len(prof["samples"]) == len(prof["weights"])
        assert prof["endValue"] == sum(prof["weights"])
        names = {f["name"] for f in doc["shared"]["frames"]}
        assert any(n.startswith("stage:stmt") for n in names)

    def test_sampler_excludes_itself(self, sampler_off):
        flame.configure(enabled=True, hz=250.0)
        _spin_ms(300)
        folded = flame.folded()
        assert "_tick" not in folded
        assert "gtpu-flame-sampler" not in folded

    def test_disabled_hooks_are_cheap_noops(self, sampler_off):
        assert not flame.enabled()
        flame.push_stage("x")
        flame.pop_stage()
        flame.note_path("y")
        assert flame.summary()["samples"] == 0

    def test_configure_retunes_and_shutdown_joins(self, sampler_off):
        flame.configure(enabled=True, hz=200.0)
        assert flame.running()
        t = next(th for th in threading.enumerate()
                 if th.name == "gtpu-flame-sampler")
        flame.configure(enabled=True, hz=200.0)  # idempotent: same thread
        assert t is next(th for th in threading.enumerate()
                         if th.name == "gtpu-flame-sampler")
        flame.shutdown()
        assert not flame.running()
        assert not t.is_alive()  # joined by shutdown itself

    def test_maybe_install_env_twins(self, sampler_off, monkeypatch):
        monkeypatch.setenv("GTPU_PROFILE", "off")
        flame.maybe_install()
        assert not flame.running()
        monkeypatch.setenv("GTPU_PROFILE", "1")
        monkeypatch.setenv("GTPU_PROFILE_HZ", "55")
        flame.maybe_install()
        assert flame.running()
        assert flame._SAMPLER.period == pytest.approx(1.0 / 55)

    def test_cluster_view_is_the_local_node(self, sampler_off):
        flame.configure(enabled=True, hz=250.0)
        with tracing.span("stmt:Select"):
            _spin_ms(200)
        view = flame.cluster_view()
        assert list(view["nodes"]) == ["local"]
        assert view["merged"]["samples"] == \
            view["nodes"]["local"]["samples"]


# ---- sample_cpu profiler-thread exclusion -----------------------------------


class TestSampleCpuExclusion:
    def test_own_sampler_thread_not_counted(self):
        out = {}

        def run():
            out["folded"] = profiling.sample_cpu(seconds=0.3, hz=200,
                                                 include_idle=True)

        t = threading.Thread(target=run)
        t.start()
        _spin_ms(300)
        t.join()
        assert "_sample_loop" not in out["folded"]
        assert "sample_cpu" not in out["folded"]

    def test_continuous_sampler_excluded_from_sample_cpu(self, sampler_off):
        flame.configure(enabled=True, hz=200.0)
        folded = profiling.sample_cpu(seconds=0.2, hz=100,
                                      include_idle=True)
        assert "_tick" not in folded


# ---- per-query stamps (engine / ANALYZE / slow query) -----------------------


class TestQueryStamps:
    def test_analyze_roofline_agrees_with_ledger(self, qe, monkeypatch):
        monkeypatch.setenv("GTPU_ROOFLINE_PEAK_GBPS", "100")
        _seed(qe)
        r = qe.execute_one(
            "EXPLAIN ANALYZE SELECT host, avg(v) FROM cpu GROUP BY host")
        text = "\n".join(row[0] for row in r.rows())
        led_line = next(ln for ln in text.splitlines()
                        if "resource ledger:" in ln)
        rf_line = next(ln for ln in text.splitlines() if "roofline:" in ln)
        led_kv = dict(kv.split("=") for kv in
                      led_line.split("resource ledger:")[1].split())
        rf_kv = dict(kv.split("=") for kv in
                     rf_line.split("roofline:")[1].split())
        ledger_bytes = sum(float(led_kv.get(k, 0)) for k in
                           ("h2d_bytes", "d2h_bytes", "bytes_decoded"))
        assert float(rf_kv["bytes"]) == pytest.approx(ledger_bytes,
                                                      rel=0.01)
        recomputed = (float(rf_kv["bytes"])
                      / (float(rf_kv["window_ms"]) / 1e3) / 1e9)
        assert float(rf_kv["achieved_gbps"]) == pytest.approx(
            recomputed, rel=0.01)
        assert float(rf_kv["roofline_fraction"]) == pytest.approx(
            float(rf_kv["achieved_gbps"]) / 100.0, rel=0.01)
        # the window is the device_agg span, which encloses the pull
        assert float(rf_kv["window_ms"]) == pytest.approx(
            float(led_kv["device_ms"]), rel=0.01)

    def test_root_span_and_histogram_stamped(self, qe, monkeypatch):
        monkeypatch.setenv("GTPU_ROOFLINE_PEAK_GBPS", "100")
        from greptimedb_tpu_torch.utils.metrics import QUERY_ACHIEVED_GBPS

        _seed(qe)
        n0 = QUERY_ACHIEVED_GBPS.total_count(stmt="Select")
        ctx = QueryContext()
        qe.execute_sql("SELECT host, avg(v) FROM cpu GROUP BY host", ctx)
        spans = {s.name: s for s in tracing.spans_for(ctx.trace_id)}
        stmt = spans["stmt:Select"]
        assert stmt.attrs.get("achieved_gbps", 0) > 0
        assert 0 < stmt.attrs["roofline_fraction"] < 1e6
        assert QUERY_ACHIEVED_GBPS.total_count(stmt="Select") == n0 + 1

    def test_ddl_statement_not_stamped(self, qe):
        ctx = QueryContext()
        qe.execute_sql("CREATE TABLE t0 (ts TIMESTAMP TIME INDEX)", ctx)
        spans = [s for s in tracing.spans_for(ctx.trace_id)
                 if s.name.startswith("stmt:")]
        assert spans
        assert all("achieved_gbps" not in s.attrs for s in spans)

    def test_slow_query_record_carries_roofline(self, qe, monkeypatch):
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
        monkeypatch.setenv("GTPU_ROOFLINE_PEAK_GBPS", "100")
        slow_query.clear()
        try:
            _seed(qe)
            qe.execute_one("SELECT host, avg(v) FROM cpu GROUP BY host")
            rec = next(r for r in slow_query.records(50)
                       if r.query.startswith("SELECT"))
            assert rec.achieved_gbps is not None and rec.achieved_gbps > 0
            assert rec.roofline_fraction == pytest.approx(
                rec.achieved_gbps / 100.0, rel=0.02)
            d = rec.to_dict()
            assert d["achieved_gbps"] == rec.achieved_gbps
            assert d["roofline_fraction"] == rec.roofline_fraction
        finally:
            slow_query.clear()

    def test_information_schema_slow_queries_columns(self, qe, monkeypatch):
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
        slow_query.clear()
        try:
            _seed(qe)
            qe.execute_one("SELECT count(*) FROM cpu")
            r = qe.execute_one(
                "SELECT achieved_gbps, roofline_fraction "
                "FROM information_schema.slow_queries")
            assert r.rows()
        finally:
            slow_query.clear()

    def test_fast_lane_hit_runs_in_a_stmt_span(self, qe, monkeypatch):
        """A template hit skips parse and plan but keeps the slow lane's
        statement span, slow-query watch and ledger."""
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
        slow_query.clear()
        _seed(qe)
        sql = "SELECT host, avg(v) FROM cpu WHERE ts >= 2000 GROUP BY host"
        for _ in range(3):
            qe.execute_one(sql)
        ctx = QueryContext()
        # a server's request_span attaches the request ledger the lane's
        # hit lands in
        from greptimedb_tpu_torch.utils import ledger

        with ledger.attach() as led:
            qe.execute_sql(sql, ctx)
        assert led.snapshot().get("cache.fast_lane.hit") == 1
        names = [s.name for s in tracing.spans_for(ctx.trace_id)]
        assert "stmt:Select" in names and "aggregate" in names
        rec = slow_query.records(1)[0]
        assert rec.query == sql and rec.ledger.get("rows_scanned") == 64
        assert rec.execution_path == qe.executor.last_path
        slow_query.clear()


# ---- HTTP endpoints ---------------------------------------------------------


class TestProfileEndpoints:
    def _get(self, port, path, auth=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
        if auth:
            import base64
            cred = base64.b64encode(auth.encode()).decode()
            req.add_header("Authorization", f"Basic {cred}")
        return urllib.request.urlopen(req, timeout=10)

    def test_flame_endpoint_auth_and_content_types(self, qe, sampler_off):
        from greptimedb_tpu_torch.auth import StaticUserProvider
        from greptimedb_tpu_torch.servers import HttpServer

        flame.configure(enabled=True, hz=250.0)
        with tracing.span("stmt:Select"):
            _spin_ms(400)
        srv = HttpServer(qe, port=0,
                         user_provider=StaticUserProvider({"u": "pw"}))
        port = srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                self._get(port, "/v1/profile/flame")
            assert ei.value.code == 401
            with self._get(port, "/v1/profile/flame", auth="u:pw") as resp:
                assert "text/plain" in resp.headers["Content-Type"]
                body = resp.read().decode()
            assert body.startswith("# flame:")
            assert "stage:stmt:Select;" in body
            with self._get(port, "/v1/profile/flame?format=speedscope",
                           auth="u:pw") as resp:
                assert "application/json" in resp.headers["Content-Type"]
                doc = json.loads(resp.read())
            assert doc["profiles"][0]["type"] == "sampled"
            with self._get(port, "/v1/profile/cluster",
                           auth="u:pw") as resp:
                view = json.loads(resp.read())
            assert view["merged"]["samples"] >= 1
            # the dashboard page stays open, like /health
            with self._get(port, "/dashboard") as resp:
                assert "text/html" in resp.headers["Content-Type"]
        finally:
            srv.stop()
        # stop() joined the sampler with the server
        assert not flame.running()

    def test_flame_endpoint_503_when_disabled(self, qe, sampler_off):
        from greptimedb_tpu_torch.servers import HttpServer

        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                self._get(port, "/v1/profile/flame")
            assert ei.value.code == 503
            assert "GTPU_PROFILE" in json.loads(ei.value.read())["error"]
        finally:
            srv.stop()

    def test_pprof_cpu_and_mem(self, qe):
        from greptimedb_tpu_torch.servers import HttpServer

        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            with self._get(port, "/debug/pprof/cpu?seconds=0.2") as resp:
                assert resp.read().decode().startswith("# sampler:")
            with self._get(port, "/debug/pprof/mem") as resp:
                assert "tracemalloc" in resp.read().decode()
            with self._get(port, "/debug/pprof/mem?top=5") as resp:
                assert "live python allocations" in resp.read().decode()
            with self._get(port, "/debug/pprof/mem?action=stop") as resp:
                assert "stopped" in resp.read().decode()
        finally:
            srv.stop()

    def test_flame_dump_tool(self, qe, sampler_off):
        sys.path.insert(0, REPO)
        from tools.flame_dump import fetch, render_cluster

        from greptimedb_tpu_torch.servers import HttpServer

        flame.configure(enabled=True, hz=250.0)
        with tracing.span("stmt:Select"):
            _spin_ms(300)
        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            body, ctype = fetch(f"127.0.0.1:{port}", "/v1/profile/flame")
            assert "text/plain" in ctype
            assert body.decode().startswith("# flame:")
            body, _ = fetch(f"127.0.0.1:{port}", "/v1/profile/cluster")
            assert "cluster profile:" in render_cluster(json.loads(body))
        finally:
            srv.stop()

    def test_information_schema_cluster_profile(self, qe, sampler_off):
        flame.configure(enabled=True, hz=250.0)
        with tracing.span("scan"):
            _spin_ms(200)
        r = qe.execute_one("SELECT node, stage, stage_samples, share "
                           "FROM information_schema.cluster_profile")
        rows = r.rows()
        assert rows and {row[0] for row in rows} == {"local"}
        assert any(row[1] == "scan" and row[2] > 0 for row in rows)


# ---- OTLP log lane ----------------------------------------------------------


class _Sink:
    """In-process OTLP/HTTP sink recording (path, payload) pairs."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        self.posts: list = []
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                outer.posts.append(
                    (self.path, json.loads(self.rfile.read(n))))
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

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


@pytest.fixture
def no_exporter():
    yield
    otlp_trace.configure(None)
    assert not any(t.name == "gtpu-otlp-export"
                   for t in threading.enumerate())


class TestOtlpLogLane:
    def test_golden_log_payload(self):
        p = otlp_trace.log_payload([
            {"ts": 1700000000.5, "levelno": logging.WARNING,
             "logger": "greptimedb_tpu_torch.fault", "body": "seam tripped",
             "trace_id": "feedbeefcafe0001"},
            {"ts": 1700000001.0, "levelno": logging.ERROR,
             "logger": "greptimedb_tpu_torch.wal", "body": "fsync failed",
             "trace_id": ""},
        ], node="dn-0")
        rl, = p["resourceLogs"]
        attrs = {a["key"]: a["value"] for a in rl["resource"]["attributes"]}
        assert attrs["service.name"] == {"stringValue": "greptimedb_tpu"}
        assert attrs["service.instance.id"] == {"stringValue": "dn-0"}
        r0, r1 = rl["scopeLogs"][0]["logRecords"]
        assert r0["timeUnixNano"] == "1700000000500000000"
        assert r0["severityText"] == "WARN"
        assert r0["body"] == {"stringValue": "seam tripped"}
        assert r0["traceId"] == "feedbeefcafe0001".rjust(32, "0")
        assert r1["severityText"] == "ERROR"
        assert "traceId" not in r1

    def test_warning_logs_export_with_trace_correlation(self, no_exporter):
        sink = _Sink()
        try:
            otlp_trace.configure(f"http://127.0.0.1:{sink.port}",
                                 flush_interval_s=0.05)
            tid = tracing.set_trace(None)
            with tracing.span("stmt:Select"):
                logging.getLogger("greptimedb_tpu_torch.test_profile"
                                  ).warning("deliberate warning for export")
            assert otlp_trace.exporter().flush(timeout_s=5.0)
            logs = [p for path, p in sink.posts
                    if path.endswith("/v1/logs")]
            assert logs, [p for p, _ in sink.posts]
            recs = [r for p in logs
                    for rl in p["resourceLogs"]
                    for sl in rl["scopeLogs"]
                    for r in sl["logRecords"]]
            mine = next(r for r in recs if "deliberate warning"
                        in r["body"]["stringValue"])
            assert mine["traceId"] == tid.rjust(32, "0")
        finally:
            otlp_trace.configure(None)
            sink.stop()

    def test_info_records_and_own_logger_skipped(self, no_exporter):
        sink = _Sink()
        try:
            exp = otlp_trace.configure(f"http://127.0.0.1:{sink.port}",
                                       flush_interval_s=0.05)
            logging.getLogger("greptimedb_tpu_torch.x").info(
                "below threshold")
            logging.getLogger("greptimedb_tpu_torch.otlp_trace").warning(
                "export failed (must not feed back)")
            assert exp.flush(timeout_s=5.0)
            recs = [r for path, p in sink.posts
                    if path.endswith("/v1/logs")
                    for rl in p["resourceLogs"]
                    for sl in rl["scopeLogs"]
                    for r in sl["logRecords"]]
            assert not recs
        finally:
            otlp_trace.configure(None)
            sink.stop()

    def test_gate_env_disables_log_lane(self, no_exporter, monkeypatch):
        monkeypatch.setenv("GTPU_OTLP_LOGS", "off")
        otlp_trace.configure("http://127.0.0.1:1")
        handlers = logging.getLogger("greptimedb_tpu_torch").handlers
        assert not any(isinstance(h, otlp_trace.OtlpLogHandler)
                       for h in handlers)
        monkeypatch.delenv("GTPU_OTLP_LOGS")
        otlp_trace.configure("http://127.0.0.1:1")
        handlers = logging.getLogger("greptimedb_tpu_torch").handlers
        assert any(isinstance(h, otlp_trace.OtlpLogHandler)
                   for h in handlers)

    def test_token_bucket_throttles_storms(self, no_exporter):
        from greptimedb_tpu_torch.utils.otlp_trace import OTLP_LOG_RECORDS

        exp = otlp_trace.OtlpTraceExporter("http://127.0.0.1:1")
        exp._stop = True  # enqueue only; never actually post
        t0 = OTLP_LOG_RECORDS.get(event="throttled")
        for i in range(200):
            exp.on_log({"ts": 0.0, "levelno": logging.WARNING,
                        "logger": "greptimedb_tpu_torch.storm",
                        "body": f"warn {i}", "trace_id": ""})
        assert len(exp._logq) <= exp._log_rate + 1
        assert OTLP_LOG_RECORDS.get(event="throttled") - t0 >= 150


# ---- options / config plumbing ----------------------------------------------


class TestProfilingOptions:
    def test_apply_observability_env_twins(self, sampler_off, monkeypatch):
        from greptimedb_tpu_torch.options import (
            ProfilingOptions,
            StandaloneOptions,
            apply_observability,
        )

        for k in ("GTPU_PROFILE", "GTPU_PROFILE_HZ",
                  "GTPU_PROFILE_WINDOW_S", "GTPU_PROFILE_WINDOWS",
                  "GTPU_SLOW_QUERY_MS", "GTPU_TRACING"):
            monkeypatch.delenv(k, raising=False)
        opts = StandaloneOptions()
        opts.profiling = ProfilingOptions(enabled=False, hz=7.0)
        apply_observability(opts)
        # monkeypatch restores whatever apply_observability wrote
        monkeypatch.setenv("GTPU_PROFILE", os.environ["GTPU_PROFILE"])
        monkeypatch.setenv("GTPU_PROFILE_HZ", os.environ["GTPU_PROFILE_HZ"])
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS",
                           os.environ["GTPU_SLOW_QUERY_MS"])
        assert os.environ.get("GTPU_PROFILE") == "off"
        assert os.environ.get("GTPU_PROFILE_HZ") == "7.0"
        assert not flame.running()
        opts.profiling = ProfilingOptions()  # defaults: on @ 19 Hz
        apply_observability(opts)
        assert os.environ.get("GTPU_PROFILE", "") == ""
        assert flame.running()
        assert flame._SAMPLER.period == pytest.approx(1.0 / 19.0)

    def test_observability_sections_boot_at_any_value(self, tmp_path):
        """The five sections load and pass check_port_support away from
        their defaults (the port runs the plane)."""
        from greptimedb_tpu_torch import options

        p = tmp_path / "cfg.toml"
        p.write_text(
            "[tracing]\nenabled = false\n"
            "otlp_endpoint = 'http://127.0.0.1:1'\n"
            "[profiling]\nenabled = false\nhz = 7.0\n"
            "[slow_query]\nthreshold_ms = 5.0\n"
            "[metrics]\nenable = true\n"
            "[telemetry]\nenable = true\n")
        opts = options.load_options(str(p), env={})
        options.check_port_support(opts)
        assert opts.profiling.hz == 7.0 and opts.metrics.enable

    def test_example_toml_documents_profiling(self):
        from greptimedb_tpu_torch.options import example_toml

        toml = example_toml()
        assert "[profiling]" in toml
        assert "hz = 19.0" in toml
