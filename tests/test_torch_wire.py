"""The port's MySQL and PostgreSQL wire servers
(greptimedb_tpu_torch/servers/{mysql,postgres}.py) beside the JAX
package's over the same writes, driven by the hand-rolled clients of
tests/test_wire_protocols.py: handshakes, text and binary result rows,
INSERT counts and command tags, federated probes, errors and recovery,
prepared statements (round trip, escaping, cached types, backslashes,
`?` in comments, SEND_LONG_DATA), the extended protocol and SET, the
max_execution_time / statement_timeout deadlines with their typed
errors, rows equal to the in-process results, and `shutdown()` leaving
no server thread behind.
"""

import struct
import threading

import numpy as np
import pytest

from tests.test_wire_protocols import MiniMysql, MiniPg

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.concurrency import ConcurrencyConfig as JPlaneConfig
from greptimedb_tpu.concurrency import ConcurrencyPlane as JPlane
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.servers.mysql import MysqlServer as JMysqlServer
from greptimedb_tpu.servers.postgres import PostgresServer as JPostgresServer
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import (
    ConcurrencyConfig,
    ConcurrencyPlane,
)
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.servers.mysql import MysqlServer
from greptimedb_tpu_torch.servers.postgres import PostgresServer
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

SEED = 53
DDL = ("CREATE TABLE cpu (host STRING, usage DOUBLE, ts TIMESTAMP TIME "
       "INDEX, PRIMARY KEY(host))")
ROWS = "INSERT INTO cpu (host, usage, ts) VALUES ('a', 1.5, 1000), " \
    "('b', 2.5, 2000)"
GRID_DDL = ("CREATE TABLE grid (host STRING, v DOUBLE, ts TIMESTAMP(3) "
            "TIME INDEX, PRIMARY KEY(host))")


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _grid_insert() -> str:
    g = np.round(np.random.default_rng(SEED).uniform(0, 100, (5, 40)), 3)
    return "INSERT INTO grid (host, v, ts) VALUES " + ", ".join(
        f"('h{h}', {float(g[h, p])!r}, {p * 1000})"
        for h in range(5) for p in range(40))


class Side:
    """One package's engine with its MySQL and Postgres servers."""

    def __init__(self, root, port_side: bool, **plane):
        if port_side:
            self.eng = RegionEngine(EngineConfig(data_dir=str(root)),
                                    device="cpu")
            self.qe = QueryEngine(
                Catalog(MemoryKv()), self.eng, device="cpu",
                concurrency=ConcurrencyPlane(ConcurrencyConfig(**plane)))
            self.my = MysqlServer(self.qe, port=0)
            self.pg = PostgresServer(self.qe, port=0)
        else:
            self.eng = JRegionEngine(JConfig(data_dir=str(root),
                                             maintenance_workers=0))
            self.qe = JQueryEngine(
                JCatalog(JMemoryKv()), self.eng,
                concurrency=JPlane(JPlaneConfig(**plane)))
            self.my = JMysqlServer(self.qe, port=0)
            self.pg = JPostgresServer(self.qe, port=0)
        for sql in (DDL, ROWS, GRID_DDL, _grid_insert()):
            self.qe.execute_one(sql)
        self.my.start()
        self.pg.start()

    def close(self):
        self.my.shutdown()
        self.pg.shutdown()
        self.qe.concurrency.shutdown()
        self.eng.close()


@pytest.fixture
def sides(tmp_path):
    out = (Side(tmp_path / "jax", False), Side(tmp_path / "port", True))
    yield out
    for s in out:
        s.close()


def both(sides, fn):
    """fn(side) on the JAX side and the port side: (jax, port), each a
    value or the raised exception's text."""
    out = []
    for s in sides:
        try:
            out.append(fn(s))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(("raised", type(e).__name__, str(e)))
    return tuple(out)


def same(sides, fn):
    """fn on both sides returns, with equal results."""
    j, t = both(sides, fn)
    assert t == j
    assert not (isinstance(t, tuple) and t[:1] == ("raised",)), t
    return t


def _close_rows(j, t, rtol=1e-9):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        for x, y in zip(a, b):
            if x is None or y is None:
                assert x == y
            else:
                try:
                    np.testing.assert_allclose(float(y), float(x), rtol=rtol)
                except ValueError:
                    assert x == y


# ---- MySQL ---------------------------------------------------------------------


def test_mysql_queries_probes_inserts_and_errors(sides):
    def run(s):
        c = MiniMysql(s.my.port)
        out = [c.ping(),
               c.query("SELECT host, usage FROM cpu ORDER BY host"),
               c.query("SELECT @@version_comment LIMIT 1"),
               c.query("SELECT @@max_allowed_packet, @@tx_isolation"),
               c.query("SET NAMES utf8mb4"),
               c.query("SET max_execution_time = 5000"),
               c.query("SELECT @@max_execution_time"),
               c.query("BEGIN"),
               c.query("INSERT INTO cpu (host, usage, ts) VALUES "
                       "('c', 9.0, 3000), ('d', NULL, 4000)"),
               c.query("SELECT count(*), count(usage) FROM cpu"),
               c.query("SELECT host, max(v), min(v), count(v) FROM grid "
                       "WHERE ts >= 5000 GROUP BY host ORDER BY host")]
        for bad in ("SELECT nope FROM cpu", "SELEC 1", "SELECT * FROM none"):
            try:
                c.query(bad)
            except RuntimeError as e:
                out.append(str(e))
        out.append(c.query("SELECT count(*) FROM cpu"))
        c.close()
        return out

    same(sides, run)


def test_mysql_sums_and_averages_within_parity(sides):
    sql = ("SELECT host, sum(v), avg(v) FROM grid WHERE ts < 30000 "
           "GROUP BY host ORDER BY host")
    j, t = both(sides, lambda s: MiniMysql(s.my.port).query(sql))
    assert j[:2] == t[:2]
    _close_rows(j[2], t[2])


def test_mysql_prepared_statements(sides):
    def run(s):
        c = MiniMysql(s.my.port)
        out = []
        stmt, n = c.prepare("SELECT host, usage FROM cpu WHERE usage > ? "
                            "ORDER BY host")
        out += [n, c.execute(stmt, (2.0,)), c.execute(stmt, (0.5,)),
                # libmysqlclient re-executes without the type block
                c.execute(stmt, (0.5,), send_types=False)]
        c.stmt_close(stmt)
        ins, n = c.prepare("INSERT INTO cpu (host, usage, ts) VALUES "
                           "(?, ?, ?)")
        out += [n, c.execute(ins, ("it's-c", 9.5, 3000)),
                c.execute(ins, ("d", None, 4000)),
                c.execute(ins, ("C:\\tmp", 1.0, 9000))]
        sel, _ = c.prepare("SELECT host FROM cpu WHERE host = ?")
        out += [c.execute(sel, ("C:\\tmp",)), c.execute(sel, ("it's-c",))]
        quoted, n = c.prepare("SELECT host FROM cpu WHERE host = '?'")
        out += [n, c.execute(quoted, ())]
        comment, n = c.prepare("SELECT host FROM cpu WHERE usage > ? -- "
                               "retry? see FAQ?\nORDER BY host")
        out += [n, c.execute(comment, (2.0,))]
        long_data, _ = c.prepare("SELECT count(*) FROM cpu WHERE host != ?")
        # pipeline: a long-data chunk then the execute, one reply read
        c.seq = 0
        c._send(b"\x18" + struct.pack("<IH", long_data, 0) + b"ignored")
        out.append(c.execute(long_data, ("zzz",)))
        try:
            c.execute(999, ())
        except RuntimeError as e:
            out.append(str(e))
        out.append(c.ping())
        c.close()
        return out

    same(sides, run)


def test_mysql_connect_with_db_and_init_db(sides):
    for s in sides:
        s.qe.execute_one("CREATE DATABASE metrics")

    def run(s):
        c = MiniMysql(s.my.port, db="metrics")
        out = [c.query("CREATE TABLE m (host STRING, v DOUBLE, ts "
                       "TIMESTAMP TIME INDEX, PRIMARY KEY(host))"),
               c.query("INSERT INTO m (host, v, ts) VALUES ('x', 1.0, 1)"),
               c.query("SELECT host, v FROM m")]
        c.seq = 0
        c._send(b"\x02public")  # COM_INIT_DB
        out.append(c._read_packet()[0])
        out.append(c.query("SELECT count(*) FROM cpu"))
        c.close()
        return out

    same(sides, run)


def test_mysql_and_postgres_rows_equal_in_process(sides):
    """Text rows over both wires equal the engine's in-process rows (the
    servers' value formatting over QueryResult.rows())."""
    sqls = ["SELECT host, max(v), count(v) FROM grid GROUP BY host "
            "ORDER BY host",
            "SELECT date_bin(INTERVAL '10 seconds', ts) AS b, min(v) FROM "
            "grid WHERE host = 'h2' GROUP BY b ORDER BY b"]
    _, port = sides
    c, p = MiniMysql(port.my.port), MiniPg(port.pg.port)
    try:
        for sql in sqls:
            res = port.qe.execute_one(sql)
            want = [[None if v is None else
                     repr(float(v)) if isinstance(v, float) else str(v)
                     for v in row] for row in res.rows()]
            assert c.query(sql) == ("rows", list(res.names), want)
            cols, rows, tag = p.query(sql)
            assert (cols, rows, tag) == (list(res.names), want,
                                         f"SELECT {len(want)}")
    finally:
        c.close()
        p.close()


# ---- Postgres ----------------------------------------------------------------


def test_postgres_simple_extended_set_and_recovery(sides):
    def run(s):
        c = MiniPg(s.pg.port)
        out = [c.query("SELECT host, usage FROM cpu ORDER BY host"),
               c.query("INSERT INTO cpu (host, usage, ts) VALUES "
                       "('z', 3.5, 9000)"),
               c.query("CREATE TABLE t2 (h STRING, v DOUBLE, ts TIMESTAMP "
                       "TIME INDEX, PRIMARY KEY(h))"),
               c.query("DELETE FROM cpu WHERE host = 'z'"),
               c.query("SET client_encoding TO 'UTF8'"),
               c.query("SET statement_timeout = '5s'"),
               c.query("BEGIN"),
               c.query(""),
               c.extended_query("SELECT host FROM cpu ORDER BY host"),
               c.extended_query("SELECT host, max(v) FROM grid GROUP BY "
                                "host ORDER BY host")]
        for bad in ("SELECT broken syntax here FROM", "SELECT nope FROM cpu"):
            try:
                c.query(bad)
            except RuntimeError as e:
                out.append(str(e))
        out.append(c.query("SELECT count(*) FROM cpu"))
        c.close()
        return out

    same(sides, run)


# ---- deadlines -----------------------------------------------------------------


class HeldSlot:
    """Hold the one admission slot of `plane` on a helper thread."""

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
        return self

    def __exit__(self, *exc):
        self.go.set()
        self.t.join()


def test_session_deadlines_map_like_jax(tmp_path):
    """`SET max_execution_time` (MySQL) and `SET statement_timeout`
    (Postgres) arm the session's deadline: a statement queued past it
    gets ER_QUERY_TIMEOUT 3024 / SQLSTATE 57014 with the JAX text, and
    the connection keeps serving."""
    kw = dict(max_concurrency=1, queue_size=4, queue_timeout_s=30.0,
              batching=False)
    sides = (Side(tmp_path / "jax", False, **kw),
             Side(tmp_path / "port", True, **kw))
    try:
        def run(s):
            c, p = MiniMysql(s.my.port), MiniPg(s.pg.port)
            out = [c.query("SET max_execution_time = 50"),
                   p.query("SET statement_timeout = '50ms'")]
            with HeldSlot(s.qe.concurrency):
                for fn in (lambda: c.query("SELECT count(*) FROM cpu"),
                           lambda: p.query("SELECT count(*) FROM cpu")):
                    try:
                        fn()
                        out.append("no error")
                    except RuntimeError as e:
                        out.append(str(e))
            out += [c.query("SELECT count(*) FROM cpu"),
                    p.query("SELECT count(*) FROM cpu")]
            c.close()
            p.close()
            return out

        t = same(sides, run)
        assert "mysql error 3024" in t[2] and "deadline" in t[2]
        assert "C57014" in t[3]
    finally:
        for s in sides:
            s.close()


# ---- lifecycle -----------------------------------------------------------------


def test_shutdown_leaves_no_server_thread(tmp_path):
    before = set(threading.enumerate())
    side = Side(tmp_path, True)
    clients = [MiniMysql(side.my.port), MiniMysql(side.my.port),
               MiniPg(side.pg.port)]
    clients[0].query("SELECT count(*) FROM cpu")
    clients[2].query("SELECT count(*) FROM cpu")
    assert set(threading.enumerate()) - before  # handlers are serving
    side.close()  # with the connections still open
    assert set(threading.enumerate()) - before == set()
    for c in clients:
        c.sock.close()
