"""The port's HTTP server (greptimedb_tpu_torch/servers/http.py) against
the JAX package's HttpServer over the same writes: /v1/sql bodies
(equal apart from `execution_time_ms`; floats within rtol=1e-9), the
Prometheus query API (range, instant, labels, label values, series),
error statuses and bodies, the write protocols (status, body and the
rows read back), unknown and unported routes, /metrics series names, the 408 / 499 / 503 mappings of typed deadline, kill and overload
errors, and that `stop()` leaves no server thread behind.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.concurrency import ConcurrencyConfig as JPlaneConfig
from greptimedb_tpu.concurrency import ConcurrencyPlane as JPlane
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.servers.http import HttpServer as JHttpServer
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import (
    ConcurrencyConfig,
    ConcurrencyPlane,
)
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.servers import HttpServer
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

SEED = 29
HOSTS, POINTS = 5, 180
DDL = ("CREATE TABLE cpu (host STRING, v DOUBLE, w DOUBLE, ts TIMESTAMP(3) "
       "TIME INDEX, PRIMARY KEY(host))")


def _insert(grid, points) -> str:
    return "INSERT INTO cpu VALUES " + ", ".join(
        f"('h{h}', {float(grid[0, h, p])!r}, {float(grid[1, h, p])!r}, "
        f"{p * 1000})" for p in points for h in range(HOSTS))


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def build(root, jplane=None, tplane=None):
    jeng = JRegionEngine(JConfig(data_dir=str(root / "jax"),
                                 maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng,
                       concurrency=jplane or JPlane(JPlaneConfig(
                           fast_lane=False, plan_cache_entries=0)))
    teng = RegionEngine(EngineConfig(data_dir=str(root / "port"), maintenance_workers=0),
                        device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), teng, device="cpu",
                      concurrency=tplane)
    grid = np.round(np.random.default_rng(SEED).uniform(
        0, 100, (2, HOSTS, POINTS)), 3)
    for qe in (jqe, tqe):
        qe.execute_one(DDL)
        qe.execute_one(_insert(grid, range(0, 120)))
        qe.execute_one("ADMIN flush_table('cpu')")
        qe.execute_one(_insert(grid, range(120, POINTS)))
    jsrv, tsrv = JHttpServer(jqe, port=0), HttpServer(tqe, port=0)
    return (jeng, jqe, jsrv, jsrv.start()), (teng, tqe, tsrv, tsrv.start())


def teardown(j, t):
    for eng, qe, srv, _ in (j, t):
        srv.stop()
        qe.concurrency.shutdown()
        eng.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    j, t = build(tmp_path_factory.mktemp("http"))
    yield j[3], t[3]
    teardown(j, t)


def call(port, path, body=None, method=None, headers=None):
    """(status, body bytes) of one request."""
    data = urllib.parse.urlencode(body).encode() if isinstance(body, dict) \
        else body
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def close_json(a, b, path="$"):
    """JSON documents equal, floats within rtol=1e-9 (PromQL values are
    strings: compared as floats)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            close_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=1e-9, err_msg=path)
    elif isinstance(a, str) and isinstance(b, str) and a != b:
        try:
            np.testing.assert_allclose(float(b), float(a), rtol=1e-9,
                                       err_msg=path)
        except ValueError:
            raise AssertionError((path, a, b)) from None
    else:
        assert a == b, (path, a, b)


SQLS = {
    "dashboard": "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
                 "max(v), avg(w) FROM cpu WHERE host = 'h1' AND ts >= 0 "
                 "AND ts < 150000 GROUP BY minute",
    "by_host": "SELECT host, max(v), min(w), count(*) FROM cpu GROUP BY host "
               "ORDER BY host",
    "raw": "SELECT host, ts, v FROM cpu WHERE ts < 3000 ORDER BY host, ts",
    "last_value": "SELECT last_value(v ORDER BY ts) FROM cpu WHERE "
                  "host = 'h2'",
    "two_statements": "SELECT count(*) FROM cpu; SHOW TABLES",
}


@pytest.mark.parametrize("name", list(SQLS))
def test_sql_body_matches_jax(servers, name):
    (js, jb), (ts, tb) = (call(p, "/v1/sql", {"sql": SQLS[name]})
                          for p in servers)
    assert js == ts == 200
    jdoc, tdoc = json.loads(jb), json.loads(tb)
    assert isinstance(jdoc.pop("execution_time_ms"), float)
    assert isinstance(tdoc.pop("execution_time_ms"), float)
    close_json(jdoc, tdoc)


PROM = {
    "query_range": "/v1/prometheus/api/v1/query_range?" + urllib.parse
    .urlencode({"query": 'max_over_time(cpu{__field__="v"}[30s])',
                "start": "30", "end": "170", "step": "10"}),
    "query_range_agg": "/v1/prometheus/api/v1/query_range?" + urllib.parse
    .urlencode({"query": 'avg(avg_over_time(cpu{__field__="w"}[30s]))',
                "start": "30", "end": "165", "step": "15s"}),
    "promql": "/v1/promql?" + urllib.parse.urlencode(
        {"query": 'cpu{__field__="v", host="h3"}', "start": "10",
         "end": "60", "step": "5"}),
    "instant": "/v1/prometheus/api/v1/query?" + urllib.parse.urlencode(
        {"query": 'max by (host) (cpu{__field__="v"})', "time": "100"}),
    "labels": "/v1/prometheus/api/v1/labels",
    "label_values": "/v1/prometheus/api/v1/label/host/values",
    "names": "/v1/prometheus/api/v1/label/__name__/values",
    "series": "/v1/prometheus/api/v1/series?" + urllib.parse.urlencode(
        {"match[]": 'cpu{host="h1", __field__="v"}', "start": "0",
         "end": "200"}),
}


@pytest.mark.parametrize("name", list(PROM))
def test_prometheus_api_matches_jax(servers, name):
    (js, jb), (ts, tb) = (call(p, PROM[name]) for p in servers)
    assert js == ts == 200, (jb, tb)
    close_json(json.loads(jb), json.loads(tb))


ERRORS = {
    "missing_sql": ("/v1/sql", {"x": "1"}, None),
    "bad_table": ("/v1/sql", {"sql": "SELECT * FROM nope"}, None),
    "syntax": ("/v1/sql", {"sql": "SELEC 1"}, None),
    "unknown_route": ("/nope", None, None),
    "prom_unknown": ("/v1/prometheus/api/v1/nope", None, None),
    "prom_remote_write_under_api": ("/v1/prometheus/api/v1/write", None,
                                    None),
    "prom_missing_query": ("/v1/prometheus/api/v1/query_range", None, None),
    "prom_bad_range": ("/v1/prometheus/api/v1/query_range?query=cpu", None,
                       None),
    "prom_two_fields": ("/v1/prometheus/api/v1/query?query=cpu&time=10",
                        None, None),
    "series_no_match": ("/v1/prometheus/api/v1/series", None, None),
    "delete_bad_id": ("/v1/queries/abc", None, "DELETE"),
    "delete_unknown_id": ("/v1/queries/987654", None, "DELETE"),
    "queries": ("/v1/queries", None, None),
    "health": ("/health", None, None),
    "ready": ("/ready", None, None),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_statuses_and_error_bodies_match_jax(servers, name):
    path, body, method = ERRORS[name]
    (js, jb), (ts, tb) = (call(p, path, body, method) for p in servers)
    assert js == ts, (jb, tb)
    jdoc, tdoc = json.loads(jb), json.loads(tb)
    if name == "bad_table":
        assert jdoc["code"] == tdoc["code"] == 3000
        assert "nope" in tdoc["error"]
    else:
        assert jdoc == tdoc


@pytest.mark.parametrize("path,slice_name", [
    ("/v1/scripts", "flows, scripts, shm"),
    ("/v1/faults", "A10"),
])
def test_unported_routes_name_their_slice(servers, path, slice_name):
    status, body = call(servers[1], path, b"", "POST")
    doc = json.loads(body)
    assert status == 400 and doc["code"] == 3000
    assert doc["execution_time_ms"] == 0
    assert slice_name in doc["error"] and path in doc["error"]


def _remote_write_body(metric: str) -> bytes:
    from greptimedb_tpu_torch.utils import protowire as pw
    from greptimedb_tpu_torch.utils import snappy

    rng = np.random.default_rng(SEED + 1)
    body = b""
    for h in range(3):
        blob = b"".join(
            pw.field_bytes(1, pw.field_str(1, k) + pw.field_str(2, v))
            for k, v in (("__name__", metric), ("host", f"h{h}")))
        for p, v in enumerate(rng.uniform(0, 100, 5).tolist()):
            blob += pw.field_bytes(2, pw.field_double(1, v)
                                   + pw.field_varint(2, 1000 * p + h))
        body += pw.field_bytes(1, blob)
    return snappy.compress(body)


def _remote_read_body(metric: str) -> bytes:
    from greptimedb_tpu_torch.utils import protowire as pw
    from greptimedb_tpu_torch.utils import snappy

    q = pw.field_varint(1, 0) + pw.field_varint(2, 10**6)
    for mtype, name, value in ((0, "__name__", metric), (2, "host", "h[01]")):
        q += pw.field_bytes(3, pw.field_varint(1, mtype)
                            + pw.field_str(2, name) + pw.field_str(3, value))
    return snappy.compress(pw.field_bytes(1, q))


def _otlp_metrics_body() -> bytes:
    import struct

    from greptimedb_tpu_torch.utils import protowire as pw

    kv = pw.field_str(1, "host") + pw.field_bytes(2, pw.field_str(1, "h1"))
    dp = pw.field_bytes(7, kv) + pw.write_varint((3 << 3) | 1) \
        + struct.pack("<Q", 2_000_000_000) + pw.field_double(4, 42.5)
    metric = pw.field_str(1, "http.gauge") + pw.field_bytes(
        5, pw.field_bytes(1, dp))
    return pw.field_bytes(1, pw.field_bytes(2, pw.field_bytes(2, metric)))


def _otlp_traces_body() -> bytes:
    import struct

    from greptimedb_tpu_torch.utils import protowire as pw

    spans = b""
    for i in range(3):
        span = (pw.field_bytes(1, bytes([7]) * 16)
                + pw.field_bytes(2, bytes([i + 1]) * 8)
                + pw.field_str(5, f"op{i}") + pw.field_varint(6, 2)
                + pw.write_varint((7 << 3) | 1)
                + struct.pack("<Q", 10**9 + i)
                + pw.write_varint((8 << 3) | 1)
                + struct.pack("<Q", 2 * 10**9 + 7 * i))
        spans += pw.field_bytes(2, span)
    return pw.field_bytes(1, pw.field_bytes(2, spans))


_LP = ("lp_http,host=a v=1.5,w=2.0 1000\nlp_http,host=b v=2.5,w=3.0 2000\n"
       "lp_http,host=a v=3.5,w=4.0 3000").encode()
_TSDB = json.dumps([{"metric": "tsdb_http", "timestamp": 1356998400 + i,
                     "value": 1.5 * i, "tags": {"host": f"h{i % 2}"}}
                    for i in range(4)]).encode()

#: case -> (writes sent first, the request under test, SQL read back)
WRITES = {
    "influxdb_write": ([], ("/v1/influxdb/write?precision=ms", _LP),
                       "SELECT * FROM lp_http ORDER BY ts"),
    "influxdb_v2_write": ([], ("/v1/influxdb/api/v2/write?precision=ms&"
                               "bucket=public", _LP.replace(b"lp_", b"v2_")),
                          "SELECT * FROM v2_http ORDER BY ts"),
    "influxdb_alias": ([], ("/influxdb/write?precision=ms",
                            _LP.replace(b"lp_", b"al_")),
                       "SELECT * FROM al_http ORDER BY ts"),
    "influxdb_bad_line": ([], ("/v1/influxdb/write",
                               b"cpu,h=a v=1.0 1000\ncpu,h=b v=oops 2000"),
                          None),
    "prometheus_write": ([], ("/v1/prometheus/write",
                              _remote_write_body("rw_http")),
                         "SELECT * FROM rw_http ORDER BY "
                         "greptime_timestamp"),
    "prometheus_read": ([("/v1/prometheus/write",
                          _remote_write_body("rr_http"))],
                        ("/v1/prometheus/read", _remote_read_body("rr_http")),
                        None),
    "otlp_metrics": ([], ("/v1/otlp/v1/metrics", _otlp_metrics_body()),
                     "SELECT * FROM http_gauge"),
    "otlp_traces": ([], ("/v1/otlp/v1/traces", _otlp_traces_body()),
                    "SELECT * FROM opentelemetry_traces ORDER BY span_id"),
    "opentsdb_put": ([], ("/v1/opentsdb/api/put", _TSDB),
                     'SELECT * FROM tsdb_http ORDER BY ts'),
    "prometheus_api_write": ([], ("/v1/prometheus/api/v1/write",
                                  _remote_write_body("api_http")), None),
}


@pytest.mark.parametrize("name", list(WRITES))
def test_write_routes_match_jax(servers, name):
    """The write protocols through both servers: the JAX status and body
    (remote read compared decompressed), then the same rows read back
    through /v1/sql. These cases moved here from
    test_unported_routes_name_their_slice when the write protocols were
    ported; `/v1/prometheus/api/v1/write` falls into the Prometheus API
    branch first and answers 404 on both."""
    from greptimedb_tpu_torch.utils import snappy

    setup, (path, body), sql = WRITES[name]
    for p, b in setup:
        for port in servers:
            assert call(port, p, b, "POST")[0] == 204
    (js, jb), (ts, tb) = (call(p, path, body, "POST") for p in servers)
    assert js == ts, (jb, tb)
    if name == "prometheus_read":
        assert ts == 200
        assert snappy.decompress(tb) == snappy.decompress(jb)
        assert b"h0" in snappy.decompress(tb)
    elif tb or jb:
        assert json.loads(tb) == json.loads(jb)
    want = {"influxdb_bad_line": 400, "prometheus_api_write": 404,
            "otlp_metrics": 200, "otlp_traces": 200, "opentsdb_put": 200}
    assert ts == want.get(name, 200 if name == "prometheus_read" else 204)
    if sql is not None:
        (js, jb), (ts, tb) = (call(p, "/v1/sql", {"sql": sql})
                              for p in servers)
        assert js == ts == 200
        jdoc, tdoc = json.loads(jb), json.loads(tb)
        jdoc.pop("execution_time_ms"), tdoc.pop("execution_time_ms")
        close_json(jdoc, tdoc)
        assert tdoc["output"][0]["records"]["rows"]


def _series_names(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_carry_the_jax_series_names(servers):
    call(servers[1], "/v1/sql", {"sql": SQLS["dashboard"]})
    (js, jb), (ts, tb) = (call(p, "/metrics") for p in servers)
    assert js == ts == 200
    jnames, tnames = _series_names(jb.decode()), _series_names(tb.decode())
    assert tnames and tnames <= jnames
    for want in ("greptimedb_tpu_http_requests_total",
                 "greptimedb_tpu_query_duration_seconds",
                 "greptimedb_tpu_admission_events_total",
                 "greptimedb_tpu_query_batch_events_total",
                 "greptimedb_tpu_query_vmap_batch_width",
                 "greptimedb_tpu_encode_seconds"):
        assert want in tnames
    assert 'greptimedb_tpu_http_requests_total{path="/v1/sql",' \
        'status="200"}' in tb.decode()


# ---- typed errors over the wire -----------------------------------------------


class HeldSlot:
    """Hold one admission slot of `plane` on a helper thread."""

    def __init__(self, plane):
        self.plane, self.go, self.held = plane, threading.Event(), \
            threading.Event()

    def __enter__(self):
        def hold():
            with self.plane.admission.slot("holder"):
                self.held.set()
                self.go.wait(30)

        self.t = threading.Thread(target=hold)
        self.t.start()
        assert self.held.wait(30)

    def __exit__(self, *exc):
        self.go.set()
        self.t.join()


def test_overload_deadline_and_kill_map_like_jax(tmp_path):
    kw = dict(batching=False, max_concurrency=1, queue_size=1,
              queue_timeout_s=30.0)
    j, t = build(tmp_path, JPlane(JPlaneConfig(
        fast_lane=False, plan_cache_entries=0, **kw)),
        ConcurrencyPlane(ConcurrencyConfig(**kw)))
    sql = {"sql": "SELECT host, max(v) FROM cpu GROUP BY host"}
    out = []
    try:
        for _eng, qe, _srv, port in (j, t):
            got = {}
            with HeldSlot(qe.concurrency):
                # 408: the request's own deadline expires in the queue
                got["408"] = call(port, "/v1/sql", sql,
                                  headers={"X-Greptime-Timeout": "50ms"})
                # 499: a queued request killed through DELETE
                res = {}
                th = threading.Thread(target=lambda: res.update(
                    r=call(port, "/v1/sql", sql)))
                th.start()
                qid = None
                for _ in range(600):
                    _s, body = call(port, "/v1/queries")
                    qs = json.loads(body)["queries"]
                    if qs:
                        qid = qs[0]["id"]
                        break
                    time.sleep(0.01)
                assert qid is not None
                # 503: the one queue place is taken by the victim
                got["503"] = call(port, "/v1/sql", sql)
                got["delete"] = call(port, f"/v1/queries/{qid}",
                                     method="DELETE")
                th.join(30)
                got["499"] = res["r"]
            out.append({k: (s, json.loads(b)) for k, (s, b) in got.items()})
    finally:
        teardown(j, t)
    jgot, tgot = out
    for key, status in (("408", 408), ("499", 499), ("503", 503),
                        ("delete", 200)):
        assert jgot[key][0] == tgot[key][0] == status, (key, jgot, tgot)
    assert tgot["408"][1] == jgot["408"][1] == {
        "code": 3001, "error": "query deadline exceeded at admission queue",
        "execution_time_ms": 0}
    assert tgot["499"][1]["code"] == jgot["499"][1]["code"] == 3002
    assert tgot["499"][1]["error"] == jgot["499"][1]["error"]
    assert tgot["503"][1] == jgot["503"][1]
    assert tgot["delete"][1].keys() == {"killed"}


def test_stop_leaves_no_server_thread(tmp_path):
    eng = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port")),
                       device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), eng, device="cpu")
    qe.execute_one(DDL)
    before = set(threading.enumerate())
    srv = HttpServer(qe, port=0)
    port = srv.start()
    conns = []
    for _ in range(3):  # keep-alive connections left open at stop()
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request("POST", "/v1/sql", body=urllib.parse.urlencode(
            {"sql": "SELECT count(*) FROM cpu"}),
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        r = c.getresponse()
        assert r.status == 200
        r.read()
        conns.append(c)
    assert set(threading.enumerate()) - before
    srv.stop()
    qe.concurrency.shutdown()
    eng.close()
    assert set(threading.enumerate()) - before == set()
    for c in conns:
        c.close()
