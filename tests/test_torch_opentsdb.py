"""OpenTSDB on the port beside the JAX package: `parse_put_line` on the
same lines (results or error texts), `put` lines over each package's
telnet OpentsdbServer and JSON puts over each HTTP server, with equal
answers and equal rows read back afterwards. The port's telnet server
joins every thread it started in `shutdown()`.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from greptimedb_tpu.servers.opentsdb import OpentsdbServer as JOpentsdb
from greptimedb_tpu.servers.opentsdb import parse_put_line as j_parse
from greptimedb_tpu_torch.servers.opentsdb import (
    OpentsdbServer,
    parse_put_line,
)
from torch_write_pair import Pair

SEED = 43


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _outcome(fn, line):
    try:
        return ("ok", fn(line))
    except Exception as e:  # noqa: BLE001 — both packages' errors compared
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("line", [
    "put sys.cpu.user 1356998400 42.5 host=web01 cpu=0",
    "put m 1356998400123 1",
    "put m 1356998400.9 -3e2 a=b",
    "get x 1 2",
    "put m 1",
    "put m 1 2 badtag",
    "put m notatime 2",
    "put m 1 nan z=1",
    "",
])
def test_parse_put_line_matches_jax(line):
    # repr: a NaN value compares equal to itself only as text
    assert repr(_outcome(parse_put_line, line)) \
        == repr(_outcome(j_parse, line))


def put_lines(n: int) -> list:
    rng = np.random.default_rng(SEED)
    return [f"put sys.cpu.user {1356998400 + i} {float(v)!r} "
            f"host=web{i % 3:02d} dc=d{i % 2}"
            for i, v in enumerate(rng.uniform(0, 100, n))]


def _telnet(port, lines) -> bytes:
    """Send `lines`, then `version` and `exit`; everything answered."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(("\n".join(lines + ["version", "exit"]) + "\n").encode())
        f = s.makefile("rb")
        return f.read()


def test_telnet_puts_match_jax(tmp_path):
    pair = Pair(tmp_path)
    before = set(threading.enumerate())
    jsrv, tsrv = JOpentsdb(pair.jqe, port=0), OpentsdbServer(pair.tqe,
                                                             port=0)
    jsrv.start()
    tsrv.start()
    try:
        lines = put_lines(40) + ["put bad line", "get x 1 2"]
        answers = [_telnet(srv.port, lines) for srv in (jsrv, tsrv)]
        assert answers[1] == answers[0]
        assert b"put:" in answers[1] and b"opentsdb" in answers[1]
        sql = 'SELECT * FROM "sys.cpu.user" ORDER BY ts'
        jrows, trows = pair.rows(sql)
        assert trows == jrows and len(trows) == 40
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
        pair.close()
    left = [t for t in set(threading.enumerate()) - before
            if t.is_alive() and "opentsdb" in t.name]
    assert not left
    assert not tsrv._thread.is_alive()


def test_telnet_put_roots_a_request_span(tmp_path):
    """Each telnet put runs in its own request span (the span_coverage
    lint checker's wire-entry rule): a put line leaves an `opentsdb:put`
    root span with the rows it wrote; a line that fails to parse leaves
    its span too, the error recorded."""
    from greptimedb_tpu_torch.utils import tracing

    pair = Pair(tmp_path)
    srv = OpentsdbServer(pair.tqe, port=0)
    srv.start()
    try:
        seen = {s.span_id for s in tracing.recent_spans(10_000)}
        _telnet(srv.port, ["put span.m 1356998400 1.5 host=a",
                           "put span.m 1"])
        spans = [s for s in tracing.recent_spans(10_000)
                 if s.name == "opentsdb:put" and s.span_id not in seen]
        assert len(spans) == 2
        assert sorted(s.attrs.get("rows", 0) for s in spans) == [0, 1]
        assert all(s.parent_id is None for s in spans)
        assert len({s.trace_id for s in spans}) == 2
    finally:
        srv.shutdown()
        pair.close()


def test_shutdown_joins_open_sessions(tmp_path):
    """A client still connected when the server stops: its session
    thread is joined by shutdown(), not left behind."""
    pair = Pair(tmp_path)
    srv = OpentsdbServer(pair.tqe, port=0)
    srv.start()
    before = set(threading.enumerate())
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        sock.sendall(b"version\n")
        assert b"opentsdb" in sock.makefile("rb").readline()
        session = [t for t in set(threading.enumerate()) - before
                   if t.is_alive()]
        assert session
        t = time.perf_counter()
        srv.shutdown()
        assert time.perf_counter() - t < 10
        assert not any(s.is_alive() for s in session)
    finally:
        sock.close()
        pair.close()


@pytest.mark.parametrize("shape", ["one", "many", "bad_value"])
def test_http_json_put_matches_jax(tmp_path, shape):
    pair = Pair(tmp_path)
    rng = np.random.default_rng(SEED + 1)
    points = [{"metric": "sys.mem", "timestamp": 1356998400 + i,
               "value": float(v), "tags": {"host": f"h{i % 4}", "a": "b"}}
              for i, v in enumerate(rng.uniform(0, 1e6, 25))]
    points[3]["timestamp"] = 1356998400123  # milliseconds by magnitude
    body = {"one": points[0], "many": points,
            "bad_value": [{"metric": "m", "timestamp": 1,
                           "value": "x"}]}[shape]
    try:
        (js, _, jb), (ts, _, tb) = pair.post(
            "/v1/opentsdb/api/put", json.dumps(body).encode())
        assert js == ts and json.loads(tb) == json.loads(jb)
        if shape != "bad_value":
            assert ts == 200
            jrows, trows = pair.rows(
                'SELECT * FROM "sys.mem" ORDER BY ts, host')
            assert trows == jrows and trows
        else:
            assert ts == 400
    finally:
        pair.close()
