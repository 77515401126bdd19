"""PostgreSQL wire-protocol server of the port (copy of
greptimedb_tpu/servers/postgres.py).

Mirrors reference src/servers/src/postgres (pgwire 0.20 handler.rs,
server.rs): startup/auth handshake, the simple query protocol ('Q'), and
the extended protocol (Parse/Bind/Describe/Execute/Sync) far enough for
psql and standard drivers. All values are sent in text format with proper
type OIDs so clients render ints/floats/timestamps natively.

`shutdown()` closes every open connection and joins every handler
thread (servers/tcp.py). Each statement is one
`request_span("postgres:query")`; a W3C traceparent in a leading SQL
comment joins it to the caller's trace.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.datatypes.types import DataType
from greptimedb_tpu_torch.fault import Cancelled, DeadlineExceeded, Unavailable
from greptimedb_tpu_torch.query.engine import QueryEngine
from greptimedb_tpu_torch.servers.tcp import ThreadingServer
from greptimedb_tpu_torch.session import Channel, QueryContext

OID_BOOL = 16
OID_INT8 = 20
OID_FLOAT8 = 701
OID_TEXT = 25
OID_TIMESTAMP = 1114

SSL_REQUEST_CODE = 80877103
CANCEL_REQUEST_CODE = 80877102
PROTOCOL_3 = 196608


def _oid_for(dt) -> int:
    try:
        if dt is None:
            return OID_TEXT
        if dt.is_timestamp:
            return OID_TIMESTAMP
        if dt.is_float:
            return OID_FLOAT8
        if dt in (DataType.INT64, DataType.INT32, DataType.UINT64, DataType.UINT32):
            return OID_INT8
        if dt is DataType.BOOL:
            return OID_BOOL
    except AttributeError:
        pass
    return OID_TEXT


#: memoized RowDescription bodies keyed by the result shape — repeat
#: dashboard shapes re-packed identical field descriptors per response.
#: Benign-race dict under the GIL, bounded by a wholesale clear.
_ROWDESC_CACHE: dict = {}


def _row_description(names, dtypes) -> bytes:
    key = (tuple(names), tuple(getattr(dt, "value", None)
                               for dt in dtypes))
    cached = _ROWDESC_CACHE.get(key)
    if cached is None:
        fields = b""
        for name, dt in zip(names, dtypes):
            fields += (
                name.encode() + b"\x00"
                + struct.pack("!IhIhih", 0, 0, _oid_for(dt), -1, -1, 0)
            )
        cached = struct.pack("!h", len(names)) + fields
        if len(_ROWDESC_CACHE) > 512:
            _ROWDESC_CACHE.clear()
        _ROWDESC_CACHE[key] = cached
    return cached


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock

    def read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def read_message(self) -> Optional[tuple[bytes, bytes]]:
        t = self.read_exact(1)
        if t is None:
            return None
        raw = self.read_exact(4)
        if raw is None:
            return None
        (length,) = struct.unpack("!I", raw)
        body = self.read_exact(length - 4) if length > 4 else b""
        return t, body or b""

    def send(self, type_byte: bytes, body: bytes = b"") -> None:
        self.sock.sendall(type_byte + struct.pack("!I", len(body) + 4) + body)

    def send_many(self, messages) -> None:
        """Frame (type, body) pairs into a buffer flushed in ~1 MiB
        chunks — the byte stream is identical to per-message sends,
        without one syscall (and one Nagle hazard) per data row, and
        without materializing a huge resultset's full wire image.
        sendall accepts the bytearray directly (no copy)."""
        buf = bytearray()
        for type_byte, body in messages:
            buf += type_byte
            buf += struct.pack("!I", len(body) + 4)
            buf += body
            if len(buf) >= (1 << 20):
                self.sock.sendall(buf)
                buf = bytearray()
        if buf:
            self.sock.sendall(buf)


class _Session(socketserver.BaseRequestHandler):
    def handle(self):
        import socket as _socket

        self.request.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        conn = _Conn(self.request)
        server: PostgresServer = self.server.owner  # type: ignore[attr-defined]
        # ---- startup ----
        params = self._startup(conn, server)
        if params is None:
            return
        db = params.get("database", "public") or "public"
        ctx = QueryContext(db=db, channel=Channel.POSTGRES,
                           user=params.get("_user_info"))
        engine = server.query_engine
        # prepared statements / portals for the extended protocol
        stmts: dict[str, str] = {}
        portals: dict[str, str] = {}
        while True:
            msg = conn.read_message()
            if msg is None:
                return
            t, body = msg
            if t == b"X":  # Terminate
                return
            if t == b"Q":
                sql = body.rstrip(b"\x00").decode("utf-8", "replace")
                self._run_simple(conn, engine, sql, ctx)
                self._ready(conn)
            elif t == b"P":  # Parse: name\0 query\0 nparams...
                name_end = body.index(b"\x00")
                name = body[:name_end].decode()
                q_end = body.index(b"\x00", name_end + 1)
                stmts[name] = body[name_end + 1: q_end].decode("utf-8", "replace")
                conn.send(b"1")  # ParseComplete
            elif t == b"B":  # Bind: portal\0 stmt\0 ... (ignore params: no $n support yet)
                p_end = body.index(b"\x00")
                portal = body[:p_end].decode()
                s_end = body.index(b"\x00", p_end + 1)
                stmt_name = body[p_end + 1: s_end].decode()
                portals[portal] = stmts.get(stmt_name, "")
                conn.send(b"2")  # BindComplete
            elif t == b"D":  # Describe
                kind, name = body[:1], body[1:].rstrip(b"\x00").decode()
                sql = portals.get(name, "") if kind == b"P" else stmts.get(name, "")
                # NoData keeps drivers happy without pre-planning the query
                conn.send(b"n")
            elif t == b"E":  # Execute: portal\0 maxrows
                p_end = body.index(b"\x00")
                portal = body[:p_end].decode()
                sql = portals.get(portal, "")
                if sql:
                    self._run_simple(conn, engine, sql, ctx, suppress_empty=True)
                else:
                    conn.send(b"I")  # EmptyQueryResponse
            elif t == b"S":  # Sync
                self._ready(conn)
            elif t == b"H":  # Flush
                pass
            elif t == b"C":  # Close
                conn.send(b"3")  # CloseComplete
            else:
                self._error(conn, f"unsupported message type {t!r}")
                self._ready(conn)

    # ---- helpers ----
    def _startup(self, conn: _Conn, server) -> Optional[dict]:
        while True:
            raw = conn.read_exact(4)
            if raw is None:
                return None
            (length,) = struct.unpack("!I", raw)
            body = conn.read_exact(length - 4)
            if body is None:
                return None
            (code,) = struct.unpack("!I", body[:4])
            if code == SSL_REQUEST_CODE:
                if server.tls is None:
                    self.request.sendall(b"N")  # no TLS configured
                    continue
                # 'S' then upgrade the accepted socket in place
                self.request.sendall(b"S")
                self.request = server.tls_context.wrap_socket(
                    self.request, server_side=True)
                self.server.track(self.request)
                conn.sock = self.request
                self._tls_active = True
                continue
            if code == CANCEL_REQUEST_CODE:
                return None
            if code != PROTOCOL_3:
                return None
            if server.tls is not None and server.tls.mode == "require" \
                    and not getattr(self, "_tls_active", False):
                self._error(conn, "server requires TLS (sslmode=require)")
                return None
            parts = body[4:].split(b"\x00")
            params = {}
            for k, v in zip(parts[::2], parts[1::2]):
                if k:
                    params[k.decode()] = v.decode()
            user = params.get("user", "")
            if server.user_provider is not None:
                # AuthenticationCleartextPassword (reference pgwire
                # startup handler, servers/src/postgres/handler.rs)
                conn.send(b"R", struct.pack("!I", 3))
                pwd = self._read_password(conn)
                from greptimedb_tpu_torch.auth import AuthError
                try:
                    if pwd is None:
                        # client sent something other than PasswordMessage
                        # (or hung up) — fail closed, don't try ''
                        raise AuthError("no password message")
                    if hasattr(server.user_provider, "authenticate"):
                        params["_user_info"] = server.user_provider.authenticate(
                            user, pwd)
                    elif not server.user_provider.allow(user):
                        raise AuthError(user)
                except AuthError:
                    self._error(
                        conn,
                        f"password authentication failed for user {user!r}")
                    return None
            conn.send(b"R", struct.pack("!I", 0))  # AuthenticationOk
            for k, v in (
                ("server_version", "16.0 (greptimedb-tpu)"),
                ("server_encoding", "UTF8"),
                ("client_encoding", "UTF8"),
                ("DateStyle", "ISO"),
                ("TimeZone", "UTC"),
                ("integer_datetimes", "on"),
            ):
                conn.send(b"S", k.encode() + b"\x00" + v.encode() + b"\x00")
            conn.send(b"K", struct.pack("!II", threading.get_ident() & 0x7FFFFFFF, 0))
            self._ready(conn)
            return params

    def _read_password(self, conn: _Conn) -> Optional[str]:
        """Read a PasswordMessage ('p') from the client."""
        tag = conn.read_exact(1)
        if tag != b"p":
            return None
        raw = conn.read_exact(4)
        if raw is None:
            return None
        (length,) = struct.unpack("!I", raw)
        body = conn.read_exact(length - 4)
        if body is None:
            return None
        return body.rstrip(b"\x00").decode()

    def _ready(self, conn: _Conn) -> None:
        conn.send(b"Z", b"I")

    def _error(self, conn: _Conn, msg: str,
               sqlstate: bytes = b"42601") -> None:
        body = b"SERROR\x00" + b"C" + sqlstate + b"\x00" \
            + b"M" + msg.encode()[:900] + b"\x00\x00"
        conn.send(b"E", body)

    def _run_simple(self, conn: _Conn, engine: QueryEngine, sql: str,
                    ctx: QueryContext, suppress_empty: bool = False) -> None:
        sql = sql.strip().rstrip(";")
        if not sql:
            conn.send(b"I")
            return
        low = sql.lower()
        if low.startswith(("begin", "commit", "rollback", "discard")):
            conn.send(b"C", b"SET\x00")
            return
        if low.startswith("set "):
            # SET reaches the engine so session vars persist on the
            # connection ctx — `SET statement_timeout = '500ms'` arms
            # the deadline plane for every later statement here; vars
            # the parser can't digest stay an accepted no-op
            try:
                engine.execute_one(sql, ctx)
            except (DeadlineExceeded, Cancelled) as e:
                self._error(conn, str(e), sqlstate=b"57014")
                return
            except Unavailable as e:
                self._error(conn, str(e), sqlstate=b"53300")
                return
            except Exception:  # noqa: BLE001 — client-compat vars vary
                pass
            conn.send(b"C", b"SET\x00")
            return
        from greptimedb_tpu_torch.utils import deadline, tracing

        try:
            # header-less wire: a W3C traceparent rides a leading SQL
            # comment; each statement is one request-root span
            with tracing.request_span(
                    "postgres:query",
                    traceparent=tracing.traceparent_from_sql(sql)):
                # the CONNECTION ctx executes (a fresh one here used to
                # drop the session vars SET just stored); per-statement
                # token so a hung-up client cancels its work
                ctx.trace_id = tracing.current_trace_id()
                token = deadline.CancelToken()
                ctx.cancel_token = token
                stop_watch = deadline.watch_disconnect(conn.sock, token)
                try:
                    res = engine.execute_one(sql, ctx)
                finally:
                    stop_watch()
                    ctx.cancel_token = None
        except (DeadlineExceeded, Cancelled) as e:
            # query_canceled: PG uses 57014 for both statement_timeout
            # expiry and pg_cancel_backend-style cancellation
            self._error(conn, str(e), sqlstate=b"57014")
            return
        except Unavailable as e:
            # typed backpressure/degradation: SQLSTATE 53300
            # (too_many_connections) tells drivers to back off —
            # NOT the 42601 syntax-error a generic failure maps to
            self._error(conn, str(e), sqlstate=b"53300")
            return
        except Exception as e:  # noqa: BLE001 — wire must stay up
            self._error(conn, str(e))
            return
        if not res.is_query:
            tag = f"INSERT 0 {res.affected_rows}" if low.startswith("insert") else f"SELECT {res.affected_rows}"
            if low.startswith(("create", "drop", "alter", "truncate")):
                tag = low.split()[0].upper() + " TABLE"
            elif low.startswith("delete"):
                tag = f"DELETE {res.affected_rows}"
            conn.send(b"C", tag.encode() + b"\x00")
            return
        # RowDescription (memoized per result shape) + every DataRow +
        # CommandComplete framed into ONE write
        dtypes = list(getattr(res, "dtypes", [])) or [None] * len(res.names)
        messages = [(b"T", _row_description(res.names, dtypes))]
        rows = res.rows()
        for row in rows:
            body = bytearray(struct.pack("!h", len(row)))
            for v in row:
                if v is None or (isinstance(v, float) and np.isnan(v)):
                    body += b"\xff\xff\xff\xff"  # length -1: NULL
                else:
                    s = _fmt(v).encode()
                    body += struct.pack("!i", len(s))
                    body += s
            messages.append((b"D", bytes(body)))
        messages.append((b"C", f"SELECT {len(rows)}\x00".encode()))
        conn.send_many(messages)


def _fmt(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "t" if v else "f"
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


class PostgresServer:
    def __init__(self, query_engine: QueryEngine, host: str = "127.0.0.1",
                 port: int = 4003, user_provider=None, tls=None):
        self.query_engine = query_engine
        self.user_provider = user_provider
        self.tls = tls
        self.tls_context = tls.make_context() if tls is not None else None
        self._server = ThreadingServer((host, port), _Session)
        self._server.owner = self
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="gtpu-postgres-serve",
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        """Stop accepting, close every open connection and join the serve
        thread and every handler thread."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
        self._server.close_all()
