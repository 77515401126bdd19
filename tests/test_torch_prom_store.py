"""Prometheus remote write and read, OTLP metrics and OTLP traces through
the port's HTTP server beside the JAX package's, on the same bodies made
from a numpy seed: equal status, equal body (remote read compared after
snappy decompression), and equal rows read back with SQL on both
engines afterwards. Also the snappy codec twins of
tests/test_prom_store.py::TestSnappy and the OTLP traces case of
tests/test_extensions.py::TestOtlpTraces.
"""

import json
import struct

import numpy as np
import pytest

from greptimedb_tpu.utils import snappy as jsnappy
from greptimedb_tpu_torch.utils import protowire as pw
from greptimedb_tpu_torch.utils import snappy
from torch_write_pair import Pair

SEED = 41


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("prom"))
    yield p
    p.close()


# ---- snappy ----------------------------------------------------------------


@pytest.mark.parametrize("payload", [
    b"", b"x", b"hello world" * 100, bytes(range(256)) * 300])
def test_snappy_roundtrip_matches_jax(payload):
    assert snappy.decompress(snappy.compress(payload)) == payload
    assert jsnappy.decompress(snappy.compress(payload)) == payload
    assert snappy.decompress(jsnappy.compress(payload)) == payload


@pytest.mark.parametrize("data,want", [
    (bytes([8, 3 << 2]) + b"abcd" + bytes([1, 4]), b"abcdabcd"),
    (bytes([8, 0]) + b"a" + bytes([(3 << 2) | 1, 1]), b"aaaaaaaa"),
])
def test_snappy_copy_ops_match_jax(data, want):
    assert snappy.decompress(data) == jsnappy.decompress(data) == want


def test_snappy_bad_input_raises_like_jax():
    bad = bytes([100]) + b"\x00"
    with pytest.raises(snappy.SnappyError) as ei:
        snappy.decompress(bad)
    with pytest.raises(jsnappy.SnappyError) as ej:
        jsnappy.decompress(bad)
    assert str(ei.value) == str(ej.value)


# ---- bodies ------------------------------------------------------------------


def write_request(series) -> bytes:
    """[(labels, [(value, ts_ms)])] -> a snappy WriteRequest body."""
    body = b""
    for labels, samples in series:
        blob = b""
        for name, value in labels.items():
            blob += pw.field_bytes(1, pw.field_str(1, name)
                                   + pw.field_str(2, value))
        for value, ts in samples:
            blob += pw.field_bytes(2, pw.field_double(1, value)
                                   + pw.field_varint(2, ts))
        body += pw.field_bytes(1, blob)
    return snappy.compress(body)


def read_request(queries) -> bytes:
    """[(start_ms, end_ms, [(type, name, value)])] -> a ReadRequest."""
    body = b""
    for start, end, matchers in queries:
        q = pw.field_varint(1, start) + pw.field_varint(2, end)
        for mtype, name, value in matchers:
            q += pw.field_bytes(3, pw.field_varint(1, mtype)
                                + pw.field_str(2, name)
                                + pw.field_str(3, value))
        body += pw.field_bytes(1, q)
    return snappy.compress(body)


def seeded_series(metric: str, hosts: int, points: int) -> list:
    rng = np.random.default_rng(SEED)
    out = []
    for h in range(hosts):
        labels = {"__name__": metric, "instance": f"i{h}",
                  "job": "api" if h % 2 else "web"}
        if h % 3 == 0:
            labels["zone"] = f"z{h % 2}"
        vals = rng.uniform(-10, 100, points).tolist()
        out.append((labels, [(v, 1000 * (p + 1) + h)
                             for p, v in enumerate(vals)]))
    return out


def both_ok(answers, status) -> None:
    (js, jh, jb), (ts, th, tb) = answers
    assert js == ts == status, (jb, tb)
    assert tb == jb


# ---- remote write ------------------------------------------------------------


def test_remote_write_rows_match_jax(pair):
    body = write_request(seeded_series("http_requests", 6, 40)
                         + [({"__name__": "weird.metric-name", "x": "1"},
                             [(9.0, 5)])])
    both_ok(pair.post("/v1/prometheus/write", body), 204)
    for sql in ("SELECT * FROM http_requests "
                "ORDER BY greptime_timestamp, instance",
                "SELECT job, count(*), max(greptime_value) FROM "
                "http_requests GROUP BY job ORDER BY job",
                "SELECT greptime_value FROM weird_metric_name"):
        jrows, trows = pair.rows(sql)
        assert trows == jrows and trows
    names = [r.names for r in (
        qe.execute_one("SELECT * FROM http_requests LIMIT 1")
        for qe in (pair.jqe, pair.tqe))]
    # label columns are created in sorted order
    assert list(names[1]) == list(names[0]) == [
        "instance", "job", "zone", "greptime_timestamp", "greptime_value"]


def test_remote_write_garbage_body_answers_like_jax(pair):
    (js, _, jb), (ts, _, tb) = pair.post("/v1/prometheus/write",
                                         bytes([100]) + b"\x00")
    assert js == ts == 400
    assert json.loads(tb) == json.loads(jb)


# ---- remote read -------------------------------------------------------------


READS = {
    "eq": [(0, 10**9, [(0, "__name__", "cpu_read"), (0, "job", "api")])],
    "neq": [(0, 10**9, [(0, "__name__", "cpu_read"), (1, "job", "api")])],
    "regex": [(0, 10**9, [(0, "__name__", "cpu_read"),
                          (2, "instance", "i[12]")])],
    "not_regex": [(0, 10**9, [(0, "__name__", "cpu_read"),
                              (3, "instance", "i[12]")])],
    "time_range": [(5000, 12000, [(0, "__name__", "cpu_read")])],
    "unknown_metric": [(0, 10**9, [(0, "__name__", "nope")])],
    "missing_label": [(0, 10**9, [(0, "__name__", "cpu_read"),
                                  (0, "dc", "x")])],
    "two_queries": [(0, 3000, [(0, "__name__", "cpu_read")]),
                    (0, 10**9, [(0, "__name__", "cpu_read"),
                                (0, "zone", "z0")])],
}


@pytest.fixture(scope="module")
def read_pair(pair):
    body = write_request(seeded_series("cpu_read", 5, 20))
    both_ok(pair.post("/v1/prometheus/write", body), 204)
    return pair


@pytest.mark.parametrize("name", list(READS))
def test_remote_read_matches_jax(read_pair, name):
    (js, jh, jb), (ts, th, tb) = read_pair.post(
        "/v1/prometheus/read", read_request(READS[name]))
    assert js == ts == 200
    for h in ("Content-Type", "Content-Encoding"):
        assert th[h] == jh[h]
    raw = snappy.decompress(tb)
    assert raw == jsnappy.decompress(jb)
    n_results = sum(1 for _ in pw.iter_fields(raw))
    assert n_results == len(READS[name])
    if name == "eq":
        assert b"i1" in raw and b"i0" not in raw


# ---- OTLP metrics ------------------------------------------------------------


def _kv(key, val: str) -> bytes:
    return pw.field_str(1, key) + pw.field_bytes(2, pw.field_str(1, val))


def _fixed64(field, v) -> bytes:
    return pw.write_varint((field << 3) | 1) + struct.pack("<Q", v)


def _number_point(attrs, ts_ns, value, as_int=False) -> bytes:
    dp = b"".join(pw.field_bytes(7, _kv(k, v)) for k, v in attrs.items())
    dp += _fixed64(3, ts_ns)
    if as_int:
        dp += pw.write_varint((6 << 3) | 1) + struct.pack("<q", value)
    else:
        dp += pw.field_double(4, value)
    return pw.field_bytes(1, dp)


def _histogram_point(attrs, ts_ns, counts, bounds, total) -> bytes:
    dp = b"".join(pw.field_bytes(9, _kv(k, v)) for k, v in attrs.items())
    dp += _fixed64(3, ts_ns) + _fixed64(4, sum(counts))
    dp += pw.field_double(5, total)
    dp += pw.field_bytes(6, b"".join(struct.pack("<Q", c) for c in counts))
    dp += pw.field_bytes(7, b"".join(struct.pack("<d", b) for b in bounds))
    return pw.field_bytes(1, dp)


def metrics_request() -> bytes:
    rng = np.random.default_rng(SEED + 1)
    gauge = b"".join(_number_point({"host": f"h{i}"}, (2 + i) * 10**9,
                                   float(v))
                     for i, v in enumerate(rng.uniform(0, 50, 4)))
    sums = b"".join(_number_point({"host": f"h{i}", "dir": "in"},
                                  (3 + i) * 10**9, int(v), as_int=True)
                    for i, v in enumerate(rng.integers(-5, 1000, 3)))
    hist = b"".join(_histogram_point({"route": r}, 5 * 10**9,
                                     rng.integers(0, 20, 4).tolist(),
                                     [0.1, 0.5, 2.5], float(s))
                    for r, s in (("/a", 3.5), ("/b", 11.25)))
    metrics = (pw.field_str(1, "my.gauge") + pw.field_bytes(5, gauge),
               pw.field_str(1, "bytes_total") + pw.field_bytes(7, sums),
               pw.field_str(1, "latency") + pw.field_bytes(9, hist))
    scope = b"".join(pw.field_bytes(2, m) for m in metrics)
    resource = pw.field_bytes(1, pw.field_bytes(1, _kv("service", "shop")))
    return pw.field_bytes(1, resource + pw.field_bytes(2, scope))


def test_otlp_metrics_rows_match_jax(pair):
    both_ok(pair.post("/v1/otlp/v1/metrics", metrics_request()), 200)
    for table in ("my_gauge", "bytes_total", "latency_bucket",
                  "latency_sum", "latency_count"):
        order = "ts" if table == "my_gauge" else "greptime_value"
        jrows, trows = pair.rows(f"SELECT * FROM {table} ORDER BY {order}")
        assert trows == jrows and trows, table
    jrows, trows = pair.rows("SELECT le, greptime_value FROM latency_bucket "
                             "WHERE route = '/a' ORDER BY greptime_value")
    assert trows == jrows and [r[0] for r in trows][-1] == "+Inf"


# ---- OTLP traces ---------------------------------------------------------------


def _field(tag, wt, payload):
    head = pw.write_varint((tag << 3) | wt)
    if wt == 2:
        return head + pw.write_varint(len(payload)) + payload
    if wt == 1:
        return head + payload
    return head + pw.write_varint(payload)


def _make_span(trace_id, span_id, name, start_ns, end_ns, kind=2,
               parent=b""):
    body = _field(1, 2, trace_id) + _field(2, 2, span_id)
    if parent:
        body += _field(4, 2, parent)
    body += _field(5, 2, name.encode()) + _field(6, 0, kind)
    body += _field(7, 1, struct.pack("<Q", start_ns))
    body += _field(8, 1, struct.pack("<Q", end_ns))
    body += _field(9, 2, _kv("http.method", "GET"))
    body += _field(9, 2, _kv("a.z", name))
    body += _field(15, 2, _field(3, 0, 1))  # STATUS_CODE_OK
    return body


def traces_request(n_spans: int) -> bytes:
    rng = np.random.default_rng(SEED + 2)
    resource = _field(1, 2, _field(1, 2, _kv("service.name", "checkout")))
    scope = _field(1, 2, _field(1, 2, b"my-lib") + _field(2, 2, b"1.0"))
    spans = []
    for i in range(n_spans):
        start = 1_000_000_000 + int(rng.integers(0, 10**9))
        spans.append(_field(2, 2, _make_span(
            bytes([i % 7 + 1]) * 16, i.to_bytes(8, "big"), f"op{i % 5}",
            start, start + int(rng.integers(0, 10**8)),
            kind=int(rng.integers(0, 6)),
            parent=(i - 1).to_bytes(8, "big") if i else b"")))
    return _field(1, 2, resource + _field(2, 2, scope + b"".join(spans)))


def test_otlp_traces_rows_match_jax(pair):
    both_ok(pair.post("/v1/otlp/v1/traces", traces_request(60)), 200)
    jrows, trows = pair.rows("SELECT * FROM opentelemetry_traces "
                             "ORDER BY span_id")
    assert trows == jrows and len(trows) == 60


def test_otlp_traces_case_of_the_extensions_test(tmp_path):
    """tests/test_extensions.py::TestOtlpTraces on the port."""
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.servers.otlp import handle_otlp_traces
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    eng = RegionEngine(EngineConfig(data_dir=str(tmp_path)), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), eng, device="cpu")
    resource = _field(1, 2, _field(1, 2, _kv("service.name", "checkout")))
    scope = _field(1, 2, _field(1, 2, b"my-lib") + _field(2, 2, b"1.0"))
    spans = b"".join([
        _field(2, 2, _make_span(b"\x01" * 16, b"\x0a" * 8, "GET /cart",
                                1_000_000_000, 1_250_000_000)),
        _field(2, 2, _make_span(b"\x01" * 16, b"\x0b" * 8, "SELECT db",
                                1_050_000_000, 1_100_000_000, kind=3)),
    ])
    try:
        assert handle_otlp_traces(
            qe, _field(1, 2, resource + _field(2, 2, scope + spans))) == 2
        rows = qe.execute_one(
            "SELECT trace_id, span_name, span_kind, duration_nano "
            "FROM opentelemetry_traces ORDER BY span_name").rows()
        assert rows[0][0] == "01" * 16 and rows[0][1] == "GET /cart"
        assert rows[0][2] == "SPAN_KIND_SERVER"
        assert rows[0][3] == pytest.approx(250_000_000.0)
        assert rows[1][2] == "SPAN_KIND_CLIENT"
        attrs = json.loads(qe.execute_one(
            "SELECT resource_attributes FROM opentelemetry_traces "
            "LIMIT 1").rows()[0][0])
        assert attrs["service.name"] == "checkout"
    finally:
        qe.concurrency.shutdown()
        eng.close()
