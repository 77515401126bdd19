"""The port's `auth/` (greptimedb_tpu_torch/auth) against the JAX
package's: the mysql_native_password scramble, Basic-auth parsing, the
static user provider's pair and file forms, the option parser and the
permission checker, with the same errors; then HTTP Basic auth (401
statuses and bodies equal to the JAX server's), MySQL and Postgres
logins right and wrong, and TLS on both wire protocols with an
`openssl` test certificate (skipped when there is no `openssl`).
"""

import base64
import json
import shutil
import socket
import ssl
import struct
import subprocess
import urllib.error
import urllib.request

import pytest

from tests import test_auth as jauth_tests
from tests import test_tls as jtls_tests
from tests.test_wire_protocols import MiniMysql, MiniPg

from greptimedb_tpu import auth as jauth
from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.servers.http import HttpServer as JHttpServer
from greptimedb_tpu.servers.mysql import MysqlServer as JMysqlServer
from greptimedb_tpu.servers.postgres import PostgresServer as JPostgresServer
from greptimedb_tpu.servers.tls import TlsConfig as JTlsConfig
from greptimedb_tpu.session import QueryContext as JQueryContext
from greptimedb_tpu.sql import parse_sql as jparse
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch import auth
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.servers import HttpServer
from greptimedb_tpu_torch.servers.mysql import MysqlServer
from greptimedb_tpu_torch.servers.postgres import PostgresServer
from greptimedb_tpu_torch.servers.tls import TlsConfig
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils.metrics import HTTP_REQUESTS

USERS = "static_user_provider:cmd:alice=s3cret,bob="


def outcome(fn):
    try:
        r = fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))
    if isinstance(r, (jauth.UserInfo, auth.UserInfo)):
        return ("user", r.username, r.grants)
    return r


# ---- the module --------------------------------------------------------------


@pytest.mark.parametrize("password,salt", [
    ("s3cret", bytes(range(33, 53))), ("", b"x" * 20),
    ("pässwörd", b"0123456789abcdefghij"), ("a" * 64, b"\x7e" * 20)])
def test_scramble_matches_jax(password, salt):
    assert auth.mysql_native_scramble(password, salt) \
        == jauth.mysql_native_scramble(password, salt)


def test_providers_and_options_match_jax(tmp_path):
    users = tmp_path / "users"
    users.write_text("# comment\nalice = s3cret\n\nbob=\nbroken line\n")
    options = [USERS, f"static_user_provider:file:{users}",
               "static_user_provider:file:/nonexistent/users",
               "static_user_provider:cmd:", "static_user_provider:cmd:=x",
               "static_user_provider:env:a=b", "ldap:cmd:a=b", ""]
    for opt in options:
        got = outcome(lambda: auth.user_provider_from_option(opt))
        want = outcome(lambda: jauth.user_provider_from_option(opt))
        if not isinstance(want, tuple):
            got, want = got._users, want._users
        assert got == want, opt
    tp = auth.user_provider_from_option(USERS)
    jp = jauth.user_provider_from_option(USERS)
    for user, pw in (("alice", "s3cret"), ("alice", "wrong"), ("bob", ""),
                     ("nobody", "x")):
        assert outcome(lambda: tp.authenticate(user, pw)) \
            == outcome(lambda: jp.authenticate(user, pw))
        salt = b"abcdefghij0123456789"
        resp = jauth.mysql_native_scramble(pw, salt) if pw else b""
        assert outcome(lambda: tp.authenticate_mysql(user, resp, salt)) \
            == outcome(lambda: jp.authenticate_mysql(user, resp, salt))
        assert tp.allow(user) == jp.allow(user)


@pytest.mark.parametrize("header", [
    "Basic " + base64.b64encode(b"alice:s3cret").decode(),
    "Basic " + base64.b64encode(b"alice:wrong").decode(),
    "Basic " + base64.b64encode(b"bob:").decode(),
    "basic " + base64.b64encode(b"alice:s3cret").decode(),
    "Basic !!!not-base64", "Basic ", "Bearer abc", ""])
def test_authenticate_basic_matches_jax(header):
    tp = auth.user_provider_from_option(USERS)
    jp = jauth.user_provider_from_option(USERS)
    assert outcome(lambda: tp.authenticate_basic(header)) \
        == outcome(lambda: jp.authenticate_basic(header))


@pytest.mark.parametrize("sql", [
    "SELECT 1", "INSERT INTO t VALUES (1)", "DROP TABLE t",
    "CREATE DATABASE d", "ALTER TABLE t ADD COLUMN c DOUBLE",
    "ADMIN flush_table('t')", "SHOW TABLES", "DELETE FROM t WHERE a = 1",
    "CREATE VIEW v AS SELECT 1", "TRUNCATE TABLE t"])
def test_permission_checker_matches_jax(sql):
    checks = []
    for user in (None, "reader", "writer", "greptime"):
        for db in ("public", "greptime_private"):
            grants = {"reader": frozenset({"read"}),
                      "writer": frozenset({"read", "write"})}.get(user)
            tu = None if user is None else auth.UserInfo(user, grants)
            ju = None if user is None else jauth.UserInfo(user, grants)
            got = outcome(lambda: auth.PermissionChecker().check(
                tu, parse_sql(sql)[0], db))
            want = outcome(lambda: jauth.PermissionChecker().check(
                ju, jparse(sql)[0], db))
            assert got == want, (sql, user, db)
            checks.append(got)
    assert any(c is None for c in checks)


def test_engine_checks_every_statement(tmp_path):
    """The engine authorizes each statement at dispatch, on the slow and
    the fast lane: a read-only user reads, and is refused writes with
    the JAX text."""
    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                 maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng)
    teng = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"), maintenance_workers=0),
                        device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), teng, device="cpu")
    try:
        out = []
        for qe, ctx_cls, mod in ((jqe, JQueryContext, jauth),
                                 (tqe, QueryContext, auth)):
            qe.execute_one("CREATE TABLE t (h STRING, v DOUBLE, ts "
                           "TIMESTAMP(3) TIME INDEX, PRIMARY KEY(h))")
            qe.execute_one("INSERT INTO t VALUES ('a', 1.0, 0)")
            reader = mod.UserInfo("r", frozenset({"read"}))
            got = []
            for sql in ["SELECT count(*) FROM t WHERE ts >= 0"] * 3 + [
                    "INSERT INTO t VALUES ('b', 2.0, 1)", "DROP TABLE t"]:
                got.append(outcome(lambda: qe.execute_one(
                    sql, ctx_cls(user=reader)).rows()))
            out.append(got)
        assert out[0] == out[1]
        assert out[1][2] == [[1]]
        assert out[1][3][:2] == ("raised", "AuthError")
    finally:
        for qe, eng in ((jqe, jeng), (tqe, teng)):
            qe.concurrency.shutdown()
            eng.close()


# ---- the servers ---------------------------------------------------------------


@pytest.fixture
def engines(tmp_path):
    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                 maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng)
    teng = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"), maintenance_workers=0),
                        device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), teng, device="cpu")
    for qe in (jqe, tqe):
        qe.execute_one("CREATE TABLE cpu (host STRING, usage DOUBLE, ts "
                       "TIMESTAMP TIME INDEX, PRIMARY KEY(host))")
        qe.execute_one("INSERT INTO cpu VALUES ('a', 1.5, 1000)")
    yield jqe, tqe
    for qe, eng in ((jqe, jeng), (tqe, teng)):
        qe.concurrency.shutdown()
        eng.close()


def _http(port, path, authorization=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if authorization is not None:
        req.add_header("Authorization", authorization)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("WWW-Authenticate"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("WWW-Authenticate"), e.read()


def test_http_basic_auth_like_jax(engines):
    jqe, tqe = engines
    sql = "/v1/sql?sql=SELECT%20host%2C%20usage%20FROM%20cpu"
    cases = [("/health", None), ("/metrics", None), (sql, None),
             (sql, "Basic " + base64.b64encode(b"alice:wrong").decode()),
             (sql, "Basic " + base64.b64encode(b"nobody:x").decode()),
             (sql, "Bearer abc"),
             (sql, "Basic " + base64.b64encode(b"alice:s3cret").decode())]
    before = HTTP_REQUESTS.get(path="/v1/sql", status="401")
    out = []
    for cls, qe, mod in ((JHttpServer, jqe, jauth), (HttpServer, tqe, auth)):
        srv = cls(qe, port=0,
                  user_provider=mod.user_provider_from_option(USERS))
        port = srv.start()
        try:
            got = []
            for path, authz in cases:
                status, www, body = _http(port, path, authz)
                if path == "/metrics":
                    body = b""
                elif path.startswith("/v1/sql") and status == 200:
                    doc = json.loads(body)
                    doc.pop("execution_time_ms")
                    body = doc
                got.append((status, www, body))
        finally:
            srv.stop()
        out.append(got)
    assert out[1] == out[0]
    assert [s for s, _, _ in out[1]] == [200, 200, 401, 401, 401, 401, 200]
    assert json.loads(out[1][2][2]) == {
        "code": 7002, "error": "unsupported authorization scheme"}
    assert HTTP_REQUESTS.get(path="/v1/sql", status="401") == before + 4


class AuthMiniMysql(MiniMysql):
    """MiniMysql that answers the greeting's salt with a password's
    mysql_native_password scramble."""

    def __init__(self, port, user, password):
        self.user, self.password = user, password
        super().__init__(port)

    def _handshake(self, db):
        greeting = self._read_packet()
        pos = greeting.index(b"\x00", 1) + 1 + 4
        salt = greeting[pos:pos + 8]
        pos += 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt += greeting[pos:pos + 12]
        scramble = auth.mysql_native_scramble(self.password, salt) \
            if self.password else b""
        resp = struct.pack("<I", 0x0200 | 0x8000) + struct.pack(
            "<I", 1 << 24) + bytes([0x21]) + b"\x00" * 23
        resp += self.user.encode() + b"\x00" + bytes([len(scramble)]) \
            + scramble
        self._send(resp)
        first = self._read_packet()
        if first[0] != 0x00:
            code = struct.unpack("<H", first[1:3])[0]
            raise RuntimeError(f"mysql error {code}: {first[9:].decode()}")


def test_mysql_and_postgres_logins(engines):
    jqe, tqe = engines
    out = []
    for (mcls, pcls, qe, mod) in ((JMysqlServer, JPostgresServer, jqe, jauth),
                                  (MysqlServer, PostgresServer, tqe, auth)):
        provider = mod.user_provider_from_option(USERS)
        ms = mcls(qe, port=0, user_provider=provider)
        ps = pcls(qe, port=0, user_provider=provider)
        ms.start()
        ps.start()
        try:
            got = []
            for user, pw in (("alice", "s3cret"), ("alice", "wrong"),
                             ("nobody", "x"), ("bob", "")):
                try:
                    c = AuthMiniMysql(ms.port, user, pw)
                    got.append(c.query("SELECT host, usage FROM cpu"))
                    c.close()
                except RuntimeError as e:
                    got.append(str(e))
                got.append(jauth_tests.TestPostgresAuth()._login(
                    ps.port, user, pw))
            out.append(got)
        finally:
            ms.shutdown()
            ps.shutdown()
    assert out[1] == out[0]
    assert out[1][0] == ("rows", ["host", "usage"], [["a", "1.5"]])
    assert out[1][1] is True and out[1][3] is False
    assert "mysql error 1045" in out[1][2]


# ---- TLS -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("the test certificate needs the openssl binary")
    d = tmp_path_factory.mktemp("certs")
    cert, key = str(d / "server.crt"), str(d / "server.key")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1",
         "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True)
    return cert, key


def _pg_over_tls(port) -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(struct.pack("!II", 8, 80877103))
    assert s.recv(1) == b"S"
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    c = MiniPg.__new__(MiniPg)
    c.sock = ctx.wrap_socket(s)
    body = struct.pack("!I", 196608) + b"user\x00tester\x00database\x00" \
        b"public\x00\x00"
    c.sock.sendall(struct.pack("!I", len(body) + 4) + body)
    c._drain_until_ready()
    out = c.query("SELECT host, usage FROM cpu")
    c.close()
    return out


def test_tls_on_both_wires(engines, certs):
    """MySQL upgrades after SSLRequest (queries and prepared statements
    cross the TLS socket), plaintext passes in prefer mode and fails in
    require mode; Postgres answers SSLRequest with S and serves over
    TLS, N without TLS, and refuses plaintext startups in require mode —
    as the JAX servers do."""
    jqe, tqe = engines
    out = []
    for mcls, pcls, tcls, qe in ((JMysqlServer, JPostgresServer, JTlsConfig,
                                  jqe),
                                 (MysqlServer, PostgresServer, TlsConfig,
                                  tqe)):
        got = []
        for mode in ("prefer", "require"):
            ms = mcls(qe, port=0, tls=tcls(*certs, mode=mode))
            ps = pcls(qe, port=0, tls=tcls(*certs, mode=mode))
            ms.start()
            ps.start()
            try:
                c = jtls_tests.TlsMiniMysql(ms.port)
                got.append(isinstance(c.sock, ssl.SSLSocket))
                got.append(c.query("SELECT host, usage FROM cpu"))
                stmt, _ = c.prepare("SELECT usage FROM cpu WHERE host = ?")
                got.append(c.execute(stmt, ("a",)))
                c.close()
                try:
                    plain = MiniMysql(ms.port)
                    got.append(plain.query("SELECT count(*) FROM cpu"))
                    plain.close()
                except AssertionError as e:
                    got.append(str(e).split(":")[0])
                got.append(_pg_over_tls(ps.port))
                s = socket.create_connection(("127.0.0.1", ps.port),
                                             timeout=10)
                body = struct.pack("!I", 196608) + b"user\x00tester\x00\x00"
                s.sendall(struct.pack("!I", len(body) + 4) + body)
                got.append(s.recv(4096)[:1])
                s.close()
            finally:
                ms.shutdown()
                ps.shutdown()
        ps = pcls(qe, port=0)
        ps.start()
        try:
            s = socket.create_connection(("127.0.0.1", ps.port), timeout=10)
            s.sendall(struct.pack("!II", 8, 80877103))
            got.append(s.recv(1))
            s.close()
        finally:
            ps.shutdown()
        out.append(got)
    assert out[1] == out[0]
    assert out[1][0] is True and out[1][1][2] == [["a", "1.5"]]
    assert out[1][3] == ("rows", ["count(*)"], [["1"]])  # prefer
    assert out[1][9] == "auth failed"  # require: plaintext refused
    assert out[1][11] == b"E" and out[1][-1] == b"N"
