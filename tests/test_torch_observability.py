"""Port twin of tests/test_observability.py: Prometheus exposition-format
validity, span piggyback primitives, trace-id log correlation, the
slow-query log, the runtime information_schema tables and the device
telemetry of the port's own seams (the nvcc build, the hot set's
uploads, the aggregation routes' pulls, the CUDA allocator's gauges) —
over greptimedb_tpu_torch on the CPU.
"""

import json
import logging
import os
import re
import subprocess
import threading
import time
import urllib.parse
import urllib.request

import pytest

from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils import device_telemetry, slow_query, tracing
from greptimedb_tpu_torch.utils.metrics import (
    DEVICE_CACHE_EVENTS,
    REGISTRY,
    XLA_COMPILE_SECONDS,
    XLA_COMPILES,
    Counter,
    Registry,
)


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


# ---- Prometheus exposition-format validator --------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})? (?P<value>[^ ]+)$")
_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\["\\n])*)"')


def _parse_exposition(text: str):
    """Parse exposition text into samples; raises on malformed lines."""
    samples = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"malformed sample line: {line!r}"
        labels = {}
        raw = m.group("labels")
        if raw:
            body = raw[1:-1]
            parsed = _LABEL_RE.findall(body)
            reconstructed = ",".join(f'{k}="{v}"' for k, v in parsed)
            assert reconstructed == body, f"bad label escaping in: {line!r}"
            labels = dict(parsed)
        samples.append((m.group("name"), labels, float(m.group("value"))))
    return samples


class TestExpositionFormat:
    def test_every_metrics_line_parses(self, qe):
        _seed(qe)
        qe.execute_one("SELECT host, avg(v) FROM cpu GROUP BY host")
        assert _parse_exposition(REGISTRY.render())

    def test_label_values_are_escaped(self):
        reg = Registry()
        c = reg.counter("greptimedb_tpu_test_escape_total", "escape test")
        c.inc(q='say "hi"\nback\\slash')
        (name, labels, value), = _parse_exposition(reg.render())
        assert value == 1.0
        unescaped = (labels["q"].replace("\\n", "\n")
                     .replace('\\"', '"').replace("\\\\", "\\"))
        assert unescaped == 'say "hi"\nback\\slash'

    def test_histogram_buckets_monotone_and_inf_equals_count(self, qe):
        _seed(qe)
        qe.execute_one("SELECT count(*) FROM cpu")
        samples = _parse_exposition(REGISTRY.render())
        by_series: dict = {}
        counts: dict = {}
        for name, labels, value in samples:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            if name.endswith("_bucket"):
                by_series.setdefault((name[:-7], key), []).append(
                    (labels["le"], value))
            elif name.endswith("_count"):
                counts[(name[:-6], key)] = value
        assert by_series, "no histograms rendered"
        for (hname, key), buckets in by_series.items():
            ordered = sorted(buckets, key=lambda b: float("inf")
                             if b[0] == "+Inf" else float(b[0]))
            values = [v for _, v in ordered]
            assert values == sorted(values), hname
            assert ordered[-1][0] == "+Inf"
            assert ordered[-1][1] == counts[(hname, key)], hname

    def test_counter_get_is_locked_and_total_sums_subsets(self):
        c = Counter("greptimedb_tpu_test_total", "t")
        c.inc(point="p", node="a")
        c.inc(point="p", node="b")
        c.inc(2.0, point="q")
        assert c.get(point="p", node="a") == 1.0
        assert c.get(point="p") == 0.0
        assert c.total(point="p") == 2.0
        assert c.total() == 4.0
        assert c.series(point="p") == [({"node": "a", "point": "p"}, 1.0),
                                       ({"node": "b", "point": "p"}, 1.0)]


# ---- span piggyback primitives ---------------------------------------------


class TestSpanPiggyback:
    def test_collect_spans_captures_only_inner(self):
        with tracing.span("outer_before"):
            pass
        with tracing.collect_spans() as sink:
            with tracing.span("inner", rows=3):
                pass
        assert [s.name for s in sink] == ["inner"]
        assert sink[0].attrs == {"rows": 3}

    def test_span_yields_mutable_attrs(self):
        with tracing.collect_spans() as sink:
            with tracing.span("scan") as attrs:
                attrs["rows"] = 42
        assert sink[0].attrs["rows"] == 42

    def test_wire_round_trip_tags_node(self):
        tid = tracing.set_trace(None)
        with tracing.collect_spans() as sink:
            with tracing.span("region_scan", region=7):
                pass
        wire = json.loads(json.dumps(tracing.spans_to_wire(sink)))
        tracing.set_trace(None)
        merged = tracing.merge_spans(wire, node="dn-1")
        assert len(merged) == 1
        assert merged[0].node == "dn-1"
        assert merged[0].trace_id == tracing.current_trace_id() != tid
        assert tracing.spans_for(merged[0].trace_id)[0].attrs == \
            {"region": 7}

    def test_propagate_carries_trace_and_sink_across_threads(self):
        from concurrent.futures import ThreadPoolExecutor

        tid = tracing.set_trace(None)
        with tracing.collect_spans() as sink:
            def work(i):
                with tracing.span(f"job{i}"):
                    return tracing.current_trace_id()
            with ThreadPoolExecutor(max_workers=2) as pool:
                tids = list(pool.map(tracing.propagate(work), range(2)))
        assert tids == [tid, tid]
        assert sorted(s.name for s in sink) == ["job0", "job1"]

    def test_stream_producer_runs_in_the_query_trace(self, qe, monkeypatch):
        """The streamed aggregate's prefetch producer works under the
        query's context (tracing.propagate): the scan's SST reads it
        makes land in the statement's trace."""
        monkeypatch.setenv("GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS", "1")
        monkeypatch.setenv("GREPTIMEDB_TPU_STREAM_BLOCK_ROWS", "1024")
        qe.execute_one(
            "CREATE TABLE s (host STRING, v DOUBLE, ts TIMESTAMP TIME "
            "INDEX, PRIMARY KEY(host)) WITH (append_mode = 'true')")
        vals = ", ".join(f"('h{i % 4}', {float(i)}, {1000 * (i + 1)})"
                         for i in range(64))
        qe.execute_one(f"INSERT INTO s VALUES {vals}")
        qe.execute_one("ADMIN flush_table('s')")
        ctx = QueryContext()
        qe.execute_sql("SELECT host, sum(v) FROM s GROUP BY host", ctx)
        assert qe.executor.last_path.startswith("stream")
        spans = tracing.spans_for(ctx.trace_id)
        reads = [s for s in spans if s.name == "objectstore_read"]
        stmt = next(s for s in spans if s.name == "stmt:Select")
        assert reads and all(s.parent_id == stmt.span_id for s in reads)
        assert not any(t.name == "gtpu-stream-prefetch"
                       for t in threading.enumerate())


# ---- trace-id log correlation ----------------------------------------------


class TestTraceLogFilter:
    def test_filter_stamps_current_trace(self):
        filt = tracing.TraceIdFilter()
        rec = logging.LogRecord("x", logging.INFO, "f", 1, "m", (), None)
        tid = tracing.set_trace(None)
        assert filt.filter(rec) is True
        assert rec.trace_id == tid
        tracing.restore_trace(None)
        rec2 = logging.LogRecord("x", logging.INFO, "f", 1, "m", (), None)
        filt.filter(rec2)
        assert rec2.trace_id == "-"

    def test_install_is_idempotent(self):
        h = logging.StreamHandler()
        root = logging.getLogger()
        root.addHandler(h)
        try:
            tracing.install_trace_logging()
            tracing.install_trace_logging()
            assert sum(isinstance(f, tracing.TraceIdFilter)
                       for f in h.filters) == 1
        finally:
            root.removeHandler(h)


# ---- slow-query log ---------------------------------------------------------


class TestSlowQueryLog:
    @pytest.fixture(autouse=True)
    def _fast_threshold(self, monkeypatch):
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
        slow_query.clear()
        yield
        slow_query.clear()

    def test_records_structured_entry(self, qe):
        _seed(qe)
        qe.execute_one("SELECT host, avg(v) FROM cpu GROUP BY host")
        recs = slow_query.records()
        sel = [r for r in recs if r.query.startswith("SELECT host")]
        assert sel, [r.query for r in recs]
        r = sel[0]
        assert r.kind == "sql" and r.db == "public"
        assert r.trace_id != "-" and len(r.trace_id) == 16
        assert r.rows == 4
        assert r.execution_path == "dense_prepared"
        assert r.duration_ms >= 0
        assert any(name == "scan" for _, name, _ in r.stages)
        assert any(name == "device_agg" for _, name, _ in r.stages)
        assert slow_query.records(1)[0] is recs[0]

    def test_threshold_disables_at_zero(self, qe, monkeypatch):
        monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0")
        _seed(qe)
        qe.execute_one("SELECT count(*) FROM cpu")
        assert slow_query.records() == []

    def test_slow_failure_still_recorded(self, qe):
        _seed(qe)
        with pytest.raises(Exception):
            qe.execute_one("SELECT nope FROM cpu")
        assert any("nope" in r.query for r in slow_query.records())

    def test_plan_cache_skip_annotated(self, qe):
        _seed(qe)
        qe.execute_one("WITH c AS (SELECT host, v FROM cpu) "
                       "SELECT count(*) FROM c")
        rec = slow_query.records(1)[0]
        assert rec.plan_cache_skip == "cte"

    def test_information_schema_surface(self, qe):
        _seed(qe)
        qe.execute_one("SELECT host, avg(v) FROM cpu GROUP BY host")
        r = qe.execute_one(
            "SELECT kind, query, duration_ms, rows, stages FROM "
            "information_schema.slow_queries WHERE kind = 'sql'")
        assert r.num_rows >= 1
        assert any("GROUP BY" in row[1] for row in r.rows())

    def test_promql_entry_records_once(self, qe):
        from greptimedb_tpu_torch.promql.engine import PromqlEngine

        _seed(qe)
        PromqlEngine(qe).eval_matrix("cpu", 0.0, 10.0, 1.0)
        kinds = [r.kind for r in slow_query.records()]
        assert kinds.count("promql") == 1

    def test_tql_records_as_sql_not_twice(self, qe):
        _seed(qe)
        qe.execute_one("TQL EVAL (0, 10, '1s') cpu")
        recs = [r for r in slow_query.records() if "TQL" in r.query
                or r.kind == "promql"]
        assert len(recs) == 1 and recs[0].kind == "sql"

    def test_ring_is_bounded(self, qe):
        slow_query.configure(ring_size=4)
        try:
            _seed(qe)
            for i in range(8):
                qe.execute_one(f"SELECT count(*) + {i} FROM cpu")
            assert len(slow_query.records()) == 4
        finally:
            slow_query.configure(ring_size=slow_query.DEFAULT_RING)
            os.environ.pop("GTPU_SLOW_QUERY_RING", None)

    def test_http_debug_route(self, qe):
        from greptimedb_tpu_torch.servers import HttpServer

        _seed(qe)
        qe.execute_one("SELECT count(*) FROM cpu")
        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/slow_queries?limit=5") as resp:
                out = json.loads(resp.read())
        finally:
            srv.stop()
        assert out["threshold_ms"] == pytest.approx(0.0001)
        assert out["slow_queries"]
        assert {"trace_id", "kind", "query", "duration_ms",
                "stages"} <= set(out["slow_queries"][0])


# ---- the runtime information_schema tables ---------------------------------


class TestRuntimeTables:
    def test_runtime_metrics_lists_the_registry(self, qe):
        _seed(qe)
        qe.execute_one("SELECT count(*) FROM cpu")
        r = qe.execute_one(
            "SELECT metric_name, value, labels FROM "
            "information_schema.runtime_metrics WHERE metric_name = "
            "'greptimedb_tpu_statement_duration_seconds_count'")
        assert r.num_rows >= 1
        assert any('stmt="Select"' in row[2] and row[1] >= 1
                   for row in r.rows())

    def test_running_queries_lists_this_statement(self, qe):
        r = qe.execute_one("SELECT query, db, cancelled FROM "
                           "information_schema.running_queries")
        assert [row for row in r.rows()
                if "running_queries" in row[0]] == [
            ["SELECT query, db, cancelled FROM "
             "information_schema.running_queries", "public", False]]

    def test_cluster_faults_lists_armed_points(self, qe):
        from greptimedb_tpu_torch.fault import FAULTS, Fault
        from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

        assert qe.execute_one(
            "SELECT * FROM information_schema.cluster_faults").num_rows == 0
        FAULTS.arm("otlp.export", Fault(kind="fail", nth=2, times=3))
        try:
            # the process-wide counter: earlier tests may have fired it
            fired = FAULT_INJECTIONS.total(point="otlp.export", kind="fail")
            r = qe.execute_one("SELECT point, kind, schedule, fires FROM "
                               "information_schema.cluster_faults")
            assert r.rows() == [["otlp.export", "fail", "nth:2,times:3",
                                 fired]]
        finally:
            FAULTS.disarm("otlp.export")


# ---- device telemetry on the port's seams ----------------------------------


class TestDeviceTelemetry:
    def test_metrics_nonzero_after_query(self, qe):
        """The hot set's hits and misses, the H2D uploads, the D2H pulls
        and the device working set are nonzero after a query (on the
        CPU the hot set's pinned bytes stand in for the allocator)."""
        _seed(qe)
        q = "SELECT host, avg(v) FROM cpu GROUP BY host"
        qe.execute_one(q)
        qe.execute_one(q)  # second run: hot-set hits
        samples = {(n, tuple(sorted(lbl.items()))): v
                   for n, lbl, v in _parse_exposition(REGISTRY.render())}

        def total(name, **labels):
            want = set(labels.items())
            return sum(v for (n, key), v in samples.items()
                       if n == name and want <= set(key))

        assert total("greptimedb_tpu_device_memory_bytes", kind="in_use") > 0
        assert total("greptimedb_tpu_device_cache_events_total",
                     event="hit") > 0
        assert total("greptimedb_tpu_device_cache_events_total",
                     event="miss") > 0
        assert total("greptimedb_tpu_device_hot_set_events_total",
                     event="pin") > 0
        assert total("greptimedb_tpu_device_hot_set_bytes") > 0
        assert total("greptimedb_tpu_device_transfer_bytes_total",
                     direction="h2d") > 0
        assert total("greptimedb_tpu_device_transfer_bytes_total",
                     direction="d2h") > 0

    def test_ledger_h2d_equals_the_hot_set_uploads(self, qe):
        """On an append-mode table (no dedup inputs to upload): cold,
        the statement's h2d_bytes are the hot set's uploads; warm,
        nothing moves host to device."""
        from greptimedb_tpu_torch.utils import ledger

        qe.execute_one(
            "CREATE TABLE a (host STRING, v DOUBLE, ts TIMESTAMP TIME "
            "INDEX, PRIMARY KEY(host)) WITH (append_mode = 'true')")
        vals = ", ".join(f"('h{i % 4}', {float(i)}, {1000 * (i + 1)})"
                         for i in range(64))
        qe.execute_one(f"INSERT INTO a VALUES {vals}")
        q = "SELECT host, avg(v) FROM a GROUP BY host"
        cache = qe.executor.cache
        before = cache.h2d_bytes
        with ledger.attach_fresh() as led:
            qe.execute_one(q)
        assert led.snapshot()["h2d_bytes"] == cache.h2d_bytes - before > 0
        with ledger.attach_fresh() as led:
            qe.execute_one(q)
        assert "h2d_bytes" not in led.snapshot()
        assert led.snapshot()["d2h_bytes"] > 0

    def test_cache_eviction_counted(self):
        import torch

        from greptimedb_tpu_torch.query.device_cache import DeviceCache

        before = DEVICE_CACHE_EVENTS.get(event="evict")
        c = DeviceCache(budget_bytes=100)
        c.get(("snap", 1, (0, 0), "a"), lambda: torch.ones(10,
                                                           dtype=torch.float64))
        c.get(("snap", 1, (0, 0), "b"), lambda: torch.ones(10,
                                                           dtype=torch.float64))
        assert DEVICE_CACHE_EVENTS.get(event="evict") >= before + 1

    def test_nvcc_build_counts_as_a_compile(self, tmp_path, monkeypatch):
        """ops/_build.py's nvcc build feeds the JAX package's
        xla_compile_* families (backend="cuda"); a reused library does
        not."""
        from greptimedb_tpu_torch.ops import _build

        class FakeProc:
            returncode = 0

            def __init__(self, argv, **kw):
                open(argv[argv.index("-o") + 1], "wb").close()

            def communicate(self):
                return b"", b""

        def fake_run(argv, **kw):
            open(argv[argv.index("-o") + 1], "wb").close()
            return subprocess.CompletedProcess(argv, 0, b"", b"")

        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(_build, "LIB_PATH",
                            str(tmp_path / "libsegment_kernels.so"))
        monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
        monkeypatch.setattr(_build.subprocess, "run", fake_run)
        n0 = XLA_COMPILES.get(backend="cuda")
        c0 = XLA_COMPILE_SECONDS.count(backend="cuda")
        _build.build()
        assert XLA_COMPILES.get(backend="cuda") == n0 + 1
        assert XLA_COMPILE_SECONDS.count(backend="cuda") == c0 + 1
        _build.build()  # the stamp matches: reused, not a compile
        assert XLA_COMPILES.get(backend="cuda") == n0 + 1

    def test_allocator_read_only_once_a_card_is_up(self, monkeypatch):
        """The scrape never initialises CUDA: with no card up the hot
        set's bytes stand in for the allocator's."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda: {
            "allocated_bytes.all.current": 123,
            "reserved_bytes.all.current": 456,
            "allocated_bytes.all.peak": 789})
        device_telemetry._collect_device_memory()
        from greptimedb_tpu_torch.utils.metrics import DEVICE_MEMORY

        assert DEVICE_MEMORY.get(kind="in_use") == 123
        assert DEVICE_MEMORY.get(kind="reserved") == 456
        assert DEVICE_MEMORY.get(kind="peak") == 789


# ---- the disconnect watcher on a socket with a timeout ----------------------


class TestDisconnectWatcher:
    """The plane's first-query breakdown put the `standalone start`
    process's 30 s first query in the handler's join of this watcher:
    on a socket with a timeout (the HTTP server's `http.timeout_s`) its
    peek waited out the whole timeout."""

    def _pair(self, timeout):
        import socket

        a, b = socket.socketpair()
        a.settimeout(timeout)
        return a, b

    def test_stop_returns_at_once_on_a_socket_with_a_timeout(self):
        from greptimedb_tpu_torch.utils import deadline

        a, b = self._pair(30.0)
        try:
            token = deadline.CancelToken()
            stop = deadline.watch_disconnect(a, token)
            threading.Event().wait(3 * deadline.POLL_S)  # watcher polls
            t0 = time.perf_counter()
            stop()
            assert time.perf_counter() - t0 < 1.0
            assert not token.cancelled
        finally:
            a.close()
            b.close()

    def test_peer_close_still_cancels(self):
        from greptimedb_tpu_torch.utils import deadline

        a, b = self._pair(30.0)
        try:
            token = deadline.CancelToken()
            stop = deadline.watch_disconnect(a, token)
            b.close()
            for _ in range(100):
                if token.cancelled:
                    break
                threading.Event().wait(deadline.POLL_S)
            stop()
            assert token.cancelled
        finally:
            a.close()

    def test_served_statement_past_the_poll_is_not_held(self, qe):
        """Through an HttpServer with the 30 s timeout standalone's
        options give it: a statement slower than the watcher's poll
        answers in its own time, not the socket timeout's."""
        from greptimedb_tpu_torch.servers import HttpServer
        from greptimedb_tpu_torch.utils import deadline

        _seed(qe)
        srv = HttpServer(qe, port=0, timeout_s=30.0)
        port = srv.start()
        real = qe.execute_sql

        def slow(*a, **kw):
            threading.Event().wait(4 * deadline.POLL_S)
            return real(*a, **kw)

        qe.execute_sql = slow
        try:
            body = urllib.parse.urlencode(
                {"sql": "SELECT count(*) FROM cpu"}).encode()
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/sql", data=body,
                    timeout=60) as r:
                assert r.status == 200
            assert time.perf_counter() - t0 < 5.0
        finally:
            qe.execute_sql = real
            srv.stop()
