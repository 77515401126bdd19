"""The observability plane of the port against the JAX engine's on the same
statements (both engines on the CPU, built as tests/torch_sql_pair.py
builds them): EXPLAIN ANALYZE of a dense, a fused, a sparse and an
incremental aggregate, TQL ANALYZE and a RANGE query give the same span
names and nesting (times ignored), the same resource-ledger keys, equal
`rows_scanned` and `bytes_decoded`, and the same execution path. Slow-
query records carry the same fields, the OTLP payloads of the same spans
are equal, `roofline.account` folds a ledger alike, and /v1/traces and
/v1/slow_queries answer JSON with the same keys.

The fused route needs GREPTIMEDB_TPU_PALLAS=on, which the JAX package
reads when it traces its kernels: that case runs in a subprocess. A
fresh pair serves each statement, so both engines' caches start cold.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from greptimedb_tpu.utils import otlp_trace as jotlp
from greptimedb_tpu.utils import roofline as jroofline
from greptimedb_tpu.utils import slow_query as jslow
from greptimedb_tpu.utils import tracing as jtracing
from greptimedb_tpu_torch.utils import otlp_trace, roofline, slow_query, tracing

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_sql_pair import Pair  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _inline_jax_decode():
    """The JAX engines here decode SST parts inline: the JAX package's
    process-wide decode pool would leave idle worker threads in this test
    process (tests/test_profile_plane.py's sampler counts them)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


@pytest.fixture
def pairs(tmp_path):
    made = []

    def make(state):
        p = Pair(str(tmp_path / f"p{len(made)}"), state)
        made.append(p)
        return p

    yield make
    for p in made:
        # no encode worker of either plane outlives the test
        p.jqe.concurrency.shutdown()
        p.tqe.concurrency.shutdown()
        p.close()


_TREE_RE = re.compile(r"^(?P<pad>\s+)(?P<name>[^\s\[][^:]*): [0-9.]+ ms")


def report(result) -> dict:
    """An ANALYZE result's execution path, span tree shape ((depth,
    name) rows, times dropped) and resource ledger."""
    lines = [row[0] for row in result.rows()]
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("ANALYZE trace="))
    out = {"path": None, "tree": [], "ledger": {}}
    for ln in lines[start + 1:]:
        if ln.startswith("  execution path: "):
            out["path"] = ln.split(": ", 1)[1]
        elif ln.startswith("  resource ledger: "):
            out["ledger"] = {k: float(v) for k, v in (
                kv.split("=") for kv in ln.split(": ", 1)[1].split())}
        elif ln.startswith("  roofline: "):
            continue
        else:
            m = _TREE_RE.match(ln)
            assert m, ln
            out["tree"].append((len(m.group("pad")) // 2 - 1,
                                m.group("name")))
    return out


def assert_same_report(j: dict, t: dict) -> None:
    assert t["path"] == j["path"]
    assert t["tree"] == j["tree"]
    assert set(t["ledger"]) == set(j["ledger"])
    for key in ("rows_scanned", "bytes_decoded"):
        assert t["ledger"].get(key) == j["ledger"].get(key), key


def analyze_both(pair, sql) -> tuple[dict, dict]:
    j, t = pair.both(sql)
    return report(j), report(t)


DENSE = "SELECT hostname, avg(usage_user) FROM cpu GROUP BY hostname"
FUSED = "SELECT hostname, max(usage_user) FROM cpu GROUP BY hostname"
SPARSE = ("SELECT date_bin(INTERVAL '10 minutes', ts) AS b, hostname, "
          "avg(usage_user), max(usage_system) FROM cpu GROUP BY b, hostname")
TQL = "TQL ANALYZE (0, 14400, '600s') cpu{__field__=\"usage_user\"}"
RANGE = ("SELECT ts, hostname, avg(usage_user) RANGE '20m', "
         "max(usage_system) RANGE '10m' FROM cpu ALIGN '10m' BY (hostname)")


@pytest.mark.parametrize("state,sql,path", [
    ("memtable", DENSE, "dense_prepared"),
    ("flushed", DENSE, "incremental"),
    ("memtable", SPARSE, "sparse"),
    ("flushed", SPARSE, "incremental_sparse"),
], ids=["dense", "incremental", "sparse", "incremental_sparse"])
def test_explain_analyze_matches_jax(pairs, monkeypatch, state, sql, path):
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX",
                       "8" if sql == SPARSE else "100000")
    j, t = analyze_both(pairs(state), "EXPLAIN ANALYZE " + sql)
    assert t["path"] == path
    assert_same_report(j, t)
    names = [n for _, n in t["tree"]]
    assert names[:2] == ["scan", "objectstore_read"] \
        if state == "flushed" else names[0] == "scan"
    assert ("incremental_agg" if path.startswith("incremental")
            else "device_agg") in names
    assert t["ledger"]["rows_scanned"] == 150


@pytest.mark.parametrize("state", ["memtable", "flushed"])
def test_tql_analyze_matches_jax(pairs, state):
    j, t = analyze_both(pairs(state), TQL)
    assert_same_report(j, t)
    assert t["tree"][0] == (0, "promql_scan")


def _trace_shape(mod, tid) -> tuple[list, dict]:
    spans = mod.spans_for(tid)
    tree = [(d, s.name) for d, s, _ in mod.span_tree(spans)]
    stmt = next(s for s in spans if s.name.startswith("stmt:"))
    led = {k: float(v) for k, v in (
        kv.split("=") for kv in stmt.attrs.get("ledger", "").split())}
    return tree, led


@pytest.mark.parametrize("state", ["memtable", "flushed"])
def test_range_query_spans_match_jax(pairs, state):
    """EXPLAIN ANALYZE of a RANGE query raises in the JAX planner, so the
    statement runs under a fixed trace id on each engine and the trees
    come from the span rings."""
    pair = pairs(state)
    pair.jctx.trace_id = "feedbeefcafe0a01"
    pair.tctx.trace_id = "feedbeefcafe0a02"
    pair.same(RANGE)
    jt, jl = _trace_shape(jtracing, pair.jctx.trace_id)
    tt, tl = _trace_shape(tracing, pair.tctx.trace_id)
    assert tt == jt
    assert tt[:2] == [(0, "stmt:Select"), (1, "scan")]
    assert (1, "range_agg") in tt
    assert set(tl) == set(jl)
    for key in ("rows_scanned", "bytes_decoded"):
        assert tl.get(key) == jl.get(key), key


def run_fused() -> list:
    """EXPLAIN ANALYZE of the fused aggregate in both engines, cold then
    warm; the reports, JAX first."""
    import tempfile

    out = []
    with tempfile.TemporaryDirectory() as d:
        pair = Pair(d, "memtable")
        for _ in range(2):
            out.append(analyze_both(pair, "EXPLAIN ANALYZE " + FUSED))
        pair.close()
    return out


def test_fused_explain_analyze_matches_jax():
    env = dict(os.environ, GREPTIMEDB_TPU_PALLAS="on", JAX_PLATFORMS="cpu",
               GREPTIMEDB_TPU_SCAN_DECODE_THREADS="1")
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[2]); "
            "import test_torch_obs_parity as t; "
            "print(json.dumps(t.run_fused()))")
    proc = subprocess.run([sys.executable, "-c", code, HERE,
                           os.path.dirname(HERE)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for j, t in out:
        t["tree"] = [tuple(r) for r in t["tree"]]
        j["tree"] = [tuple(r) for r in j["tree"]]
        assert t["path"] == "dense_fused"
        assert_same_report(j, t)
    (_, cold), (_, warm) = out
    assert cold["ledger"]["h2d_bytes"] > 0 and "h2d_bytes" not in \
        warm["ledger"]


def test_slow_query_records_match_jax(pairs, monkeypatch):
    monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
    pair = pairs("flushed")
    jslow.clear()
    slow_query.clear()
    try:
        for sql in (DENSE, "WITH c AS (SELECT hostname FROM cpu) "
                           "SELECT count(*) FROM c"):
            pair.same(sql)
            j = jslow.records(1)[0].to_dict()
            t = slow_query.records(1)[0].to_dict()
            assert set(t) == set(j)
            for key in ("kind", "query", "db", "rows", "execution_path",
                        "plan_cache_skip", "deadline_event",
                        "threshold_ms"):
                assert t[key] == j[key], key
            assert [s["stage"] for s in t["stages"]] == \
                [s["stage"] for s in j["stages"]]
            assert set(t["ledger"]) == set(j["ledger"])
            assert (t["achieved_gbps"] is None) == \
                (j["achieved_gbps"] is None)
    finally:
        jslow.clear()
        slow_query.clear()


def _spans(mod):
    return [
        mod.Span("feedbeefcafe0001", "stmt:Select", 12.5, 1700000000.0,
                 {"rows": 4, "cold": False, "path": "dense", "r": 0.25},
                 span_id="aa" * 8),
        mod.Span("feedbeefcafe0001", "scan", 3.25, 1700000000.001,
                 {"bytes": 1024}, node="dn-1", span_id="bb" * 8,
                 parent_id="aa" * 8),
    ]


def test_otlp_payloads_equal():
    assert otlp_trace.payload(_spans(tracing), node="fe-0") == \
        jotlp.payload(_spans(jtracing), node="fe-0")
    recs = [{"ts": 1700000000.5, "levelno": 30, "logger": "x",
             "body": "warn", "trace_id": "feedbeefcafe0001"}]
    assert otlp_trace.log_payload(recs, node="dn-0") == \
        jotlp.log_payload(recs, node="dn-0")
    assert jtracing.render_tree(_spans(jtracing)) == \
        tracing.render_tree(_spans(tracing))


@pytest.mark.parametrize("led", [
    {"h2d_bytes": 6_000_000, "d2h_bytes": 1_000_000,
     "bytes_decoded": 3_000_000, "device_ms": 20.0, "rows_scanned": 1000},
    {"h2d_bytes": 1_000_000_000, "agg_ms": 200.0},
    {"bytes_decoded": 4096, "rows_scanned": 64},
    {"device_ms": 3.0},
])
def test_roofline_account_equal(led):
    assert roofline.account(led, duration_ms=7.0, peak=3352.32) == \
        jroofline.account(led, duration_ms=7.0, peak=3352.32)


def _get(port, path) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_debug_routes_answer_the_same_keys(pairs, monkeypatch):
    from greptimedb_tpu.servers import HttpServer as JHttpServer
    from greptimedb_tpu_torch.servers import HttpServer

    monkeypatch.setenv("GTPU_SLOW_QUERY_MS", "0.0001")
    pair = pairs("memtable")
    jslow.clear()
    slow_query.clear()
    jsrv, tsrv = JHttpServer(pair.jqe, port=0), HttpServer(pair.tqe, port=0)
    ports = (jsrv.start(), tsrv.start())
    try:
        docs = []
        for port, mod in zip(ports, (jtracing, tracing)):
            tid = mod.new_trace_id()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/sql",
                data=b"sql=" + urllib.request.quote(DENSE).encode(),
                headers={"traceparent":
                         f"00-{tid.rjust(32, '0')}-00f067aa0ba902b7-01"})
            urllib.request.urlopen(req, timeout=30).read()
            deadline = time.time() + 5.0
            while time.time() < deadline and not any(
                    s.name.startswith("http:") for s in mod.spans_for(tid)):
                time.sleep(0.01)
            docs.append((_get(port, f"/v1/traces/{tid}"),
                         _get(port, "/v1/slow_queries?limit=5")))
        (jtr, jsq), (ttr, tsq) = docs
        assert set(ttr) == set(jtr)
        assert [set(s) for s in ttr["spans"]] == \
            [set(s) for s in jtr["spans"]]
        assert [s["name"] for s in ttr["spans"]] == \
            [s["name"] for s in jtr["spans"]]
        assert set(tsq) == set(jsq)
        assert set(tsq["slow_queries"][0]) == set(jsq["slow_queries"][0])
    finally:
        jsrv.stop()
        tsrv.stop()
        jslow.clear()
        slow_query.clear()
    assert not any(t.name in ("gtpu-http-serve", "gtpu-flame-sampler",
                              "gtpu-otlp-export")
                   for t in threading.enumerate())
