"""Port twin of tests/test_telemetry.py (opt-out usage telemetry: payload
shape, uuid persistence, failure isolation), with the port's own
version in the payload, and the two periodic tasks `standalone start`
runs — the telemetry reporter and the metrics self-scrape
(utils/export_metrics.py) — each joined by its `stop()`.
"""

import json
import threading

import pytest

import greptimedb_tpu_torch
from greptimedb_tpu_torch.utils import export_metrics, telemetry


class TestStatisticData:
    def test_payload_shape(self, tmp_path):
        d = telemetry.statistic_data("standalone", str(tmp_path), nodes=3)
        assert d["mode"] == "standalone"
        assert d["nodes"] == 3
        assert d["os"] and d["arch"]
        assert d["version"] == greptimedb_tpu_torch.__version__
        assert len(d["uuid"]) == 32

    def test_uuid_persists_across_restarts(self, tmp_path):
        a = telemetry.load_or_create_uuid(str(tmp_path))
        b = telemetry.load_or_create_uuid(str(tmp_path))
        assert a == b
        assert (tmp_path / telemetry.UUID_FILE_NAME).exists()


class TestTelemetryTask:
    def test_report_once_posts_payload(self, tmp_path):
        sent = []
        task = telemetry.TelemetryTask(
            "http://example.invalid/stats", "distributed", str(tmp_path),
            nodes_fn=lambda: 5, post=lambda url, body: sent.append(
                (url, json.loads(body))))
        assert task.report_once() is True
        url, payload = sent[0]
        assert url.endswith("/stats")
        assert payload["mode"] == "distributed"
        assert payload["nodes"] == 5
        assert task.reports_sent == 1

    def test_post_failure_is_swallowed(self, tmp_path):
        def boom(url, body):
            raise OSError("no egress")

        task = telemetry.TelemetryTask(
            "http://example.invalid", "standalone", str(tmp_path),
            post=boom)
        assert task.report_once() is False
        assert task.reports_sent == 0

    def test_stop_joins_the_reporter(self, tmp_path):
        sent = threading.Event()
        task = telemetry.TelemetryTask(
            "http://example.invalid", "standalone", str(tmp_path),
            interval_s=3600.0, post=lambda url, body: sent.set())
        task.start()
        assert sent.wait(5.0)  # the first report goes out at once
        task.stop()
        assert not task._thread.is_alive()


class TestExportMetricsTask:
    @pytest.fixture
    def qe(self, tmp_path):
        from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
        from greptimedb_tpu_torch.query import QueryEngine
        from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

        engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d"),
                                           maintenance_workers=0),
                              device="cpu")
        qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
        yield qe
        qe.concurrency.shutdown()
        engine.close()

    def test_one_scrape_writes_the_registry_as_tables(self, qe):
        qe.execute_one("SELECT 1")
        n = export_metrics.write_metrics_once(qe, "greptime_metrics")
        assert n > 0
        r = qe.execute_one(
            "SELECT stmt, greptime_value FROM "
            "greptime_metrics.greptimedb_tpu_statement_duration_seconds_count")
        assert any(row[0] == "Select" and row[1] >= 1 for row in r.rows())

    def test_task_scrapes_and_stop_joins(self, qe):
        task = export_metrics.ExportMetricsTask(qe, interval_s=0.05)
        task.start()
        deadline = threading.Event()
        for _ in range(100):
            if "greptime_metrics" in qe.catalog.list_databases():
                break
            deadline.wait(0.05)
        task.stop()
        assert not task._thread.is_alive()
        assert task.errors == 0
        assert "greptime_metrics" in qe.catalog.list_databases()
