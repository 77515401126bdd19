"""gRPC over the port's HTTP/2 (`servers/h2.py`): a threaded server with a
method registry and a client channel (the JAX package gets both from
grpc's C core through pyarrow.flight).

The wire (grpc/doc/PROTOCOL-HTTP2.md): a request is HEADERS
(`:method POST`, `:scheme http`, `:path /service/Method`, `:authority`,
`content-type: application/grpc`, `te: trailers`, optionally
`grpc-timeout` and custom metadata) then length-prefixed messages (a
compressed flag byte, a big-endian u32 length, the bytes) in DATA
frames. A response is HEADERS (`:status 200`, the content type), the
messages, then trailers with `grpc-status` and a percent-encoded
`grpc-message`; an error before any message is one Trailers-Only
HEADERS block. Metadata whose key ends in `-bin` is base64 on the wire
and bytes in here.

- `GrpcServer(handlers, host, port)`: `handlers` maps a path to
  `(kind, fn)`, kind one of `unary`, `server_stream`, `client_stream`,
  `bidi`. `fn(ctx, request)` for the first two, `fn(ctx, requests)` (an
  iterator of messages) for the others; it returns a message (unary,
  client_stream) or an iterable of them. Raise `RpcError` for a status;
  any other exception answers UNKNOWN. Every connection has a reader
  thread and every call a handler thread; `shutdown()` closes the
  connections (GOAWAY) and joins them all, as `servers/tcp.py::
  JoinedThreads` does for the other servers.
- `Channel(addr)`: one connection, opened on first use and again after
  it is lost. `channel.call(path, metadata, timeout)` returns a
  `ClientCall` (`write`, `done_writing`, `read`, `cancel`); `unary` and
  `unary_stream` wrap it. A call past its timeout is reset (RST_STREAM
  CANCEL) and raises DEADLINE_EXCEEDED; a connection that cannot be
  made raises UNAVAILABLE.
"""

from __future__ import annotations

import base64
import socket
import struct
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

from greptimedb_tpu_torch.servers import h2

OK, CANCELLED, UNKNOWN, INVALID_ARGUMENT, DEADLINE_EXCEEDED = 0, 1, 2, 3, 4
NOT_FOUND, ALREADY_EXISTS, PERMISSION_DENIED, RESOURCE_EXHAUSTED = 5, 6, 7, 8
FAILED_PRECONDITION, ABORTED, OUT_OF_RANGE, UNIMPLEMENTED = 9, 10, 11, 12
INTERNAL, UNAVAILABLE, DATA_LOSS, UNAUTHENTICATED = 13, 14, 15, 16

CONTENT_TYPE = "application/grpc"
KINDS = ("unary", "server_stream", "client_stream", "bidi")


class RpcError(Exception):
    """A call that ended with a non-OK status. `trailers` are the
    response's trailing metadata (`-bin` values as bytes)."""

    def __init__(self, code: int, details: str = "",
                 trailers: Optional[dict] = None):
        super().__init__(f"gRPC status {code}: {details}")
        self.code = code
        self.details = details
        self.trailers = trailers or {}


# ---- wire helpers --------------------------------------------------------------


def frame_message(msg: bytes) -> bytes:
    return struct.pack(">BI", 0, len(msg)) + msg


_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
          "n": 1e-9}


def format_timeout(seconds: float) -> str:
    """`grpc-timeout`: at most 8 digits and a unit."""
    us = max(1, int(seconds * 1e6))
    for unit, scale in (("u", 1), ("m", 1000), ("S", 1_000_000),
                        ("M", 60_000_000)):
        if us // scale < 100_000_000:
            return f"{-(-us // scale)}{unit}"
    return "99999999H"


def parse_timeout(value: str) -> Optional[float]:
    if len(value) < 2 or value[-1] not in _UNITS or \
            not value[:-1].isdigit() or len(value) > 9:
        return None
    return int(value[:-1]) * _UNITS[value[-1]]


_SAFE = frozenset(range(0x20, 0x7F)) - {ord("%")}
_HEX = frozenset(b"0123456789abcdefABCDEF")


def percent_encode(text: str) -> str:
    return "".join(chr(b) if b in _SAFE else f"%{b:02X}"
                   for b in text.encode())


def percent_decode(text: str) -> str:
    raw = text.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(raw):
        digits = raw[i + 1:i + 3]
        if raw[i] == 0x25 and len(digits) == 2 and \
                all(c in _HEX for c in digits):
            out.append(int(digits, 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def encode_metadata(md) -> list[tuple[str, str]]:
    """(key, value) pairs: `-bin` values (bytes) go base64, unpadded."""
    out = []
    for k, v in (md.items() if isinstance(md, dict) else md):
        k = k.lower()
        if k.endswith("-bin"):
            raw = v if isinstance(v, (bytes, bytearray)) else v.encode()
            out.append((k, base64.b64encode(raw).decode().rstrip("=")))
        else:
            out.append((k, v if isinstance(v, str) else v.decode()))
    return out


def decode_metadata(headers) -> dict:
    """Header pairs as a dict (the last of a repeated key wins; `-bin`
    values decoded to bytes)."""
    out = {}
    for k, v in headers:
        if k.endswith("-bin"):
            try:
                out[k] = base64.b64decode(v + "=" * (-len(v) % 4))
            except ValueError:
                out[k] = b""
        else:
            out[k] = v
    return out


class _Messages:
    """Length-prefixed messages out of a stream's DATA events; header
    blocks after the first are the trailers."""

    def __init__(self, stream: h2.Stream, deadline: Optional[float],
                 on_timeout: Callable[[], None]):
        self.stream = stream
        self.deadline = deadline
        self.on_timeout = on_timeout
        self.buf = bytearray()
        self.ended = False
        self.headers: Optional[list] = None
        self.trailers: Optional[list] = None

    def _event(self):
        wait = None if self.deadline is None else \
            max(0.0, self.deadline - time.monotonic())
        ev = self.stream.next_event(wait)
        if ev is None:
            self.on_timeout()
            raise RpcError(DEADLINE_EXCEEDED, "Deadline Exceeded")
        return ev

    def first_headers(self) -> list:
        while self.headers is None:
            self._take(self._event())
        return self.headers

    def _take(self, ev) -> None:
        kind, payload, end = ev
        if kind == "headers":
            if self.headers is None:
                self.headers = payload
            else:
                self.trailers = payload
        else:
            self.buf += payload
        if end:
            self.ended = True

    def next(self) -> Optional[bytes]:
        """The next whole message, or None at the end of the stream."""
        while True:
            if len(self.buf) >= 5:
                flag, n = struct.unpack_from(">BI", self.buf, 0)
                if flag:
                    raise RpcError(UNIMPLEMENTED,
                                   "compressed gRPC messages are not "
                                   "supported")
                if len(self.buf) >= 5 + n:
                    msg = bytes(self.buf[5:5 + n])
                    del self.buf[:5 + n]
                    return msg
            if self.ended:
                if self.buf:
                    raise RpcError(INTERNAL, "stream ended inside a "
                                   "message")
                return None
            self._take(self._event())


# ---- server --------------------------------------------------------------------


class ServerContext:
    """What a handler knows of its call."""

    def __init__(self, method: str, metadata: dict, peer: str,
                 deadline: Optional[float]):
        self.method = method
        self.metadata = metadata
        self.peer = peer
        self.deadline = deadline
        #: trailing metadata the handler adds to its response
        self.trailers: dict = {}

    def time_remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()


class GrpcServer:
    def __init__(self, handlers: dict, host: str = "127.0.0.1",
                 port: int = 0, name: str = "gtpu-grpc"):
        for path, (kind, _fn) in handlers.items():
            if kind not in KINDS:
                raise ValueError(f"{path}: unknown method kind {kind!r}")
        self.handlers = handlers
        self.host = host
        self.name = name
        self._sock = socket.create_server((host, port), backlog=128)
        self.port = self._sock.getsockname()[1]
        self._lock = threading.Lock()
        self._conns: list[h2.Connection] = []
        self._threads: list[threading.Thread] = []
        self._accept: Optional[threading.Thread] = None
        self._stopping = False

    def start(self) -> int:
        self._accept = threading.Thread(target=self._accept_loop,
                                        name=f"{self.name}-accept",
                                        daemon=True)
        self._accept.start()
        return self.port

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return  # the listening socket was closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = f"ipv4:{addr[0]}:{addr[1]}"
            conn = h2.Connection(
                sock, client=False, name=f"{self.name}-conn",
                on_stream=lambda st, p=peer: self._on_stream(st, p))
            with self._lock:
                if self._stopping:
                    sock.close()
                    return
                # a connection leaves the list once its reader has ended
                self._conns = [c for c in self._conns if c.running()]
                self._conns.append(conn)
            conn.start()

    def _on_stream(self, stream: h2.Stream, peer: str) -> None:
        t = threading.Thread(target=self._serve_call, args=(stream, peer),
                             name=f"{self.name}-call", daemon=True)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def _serve_call(self, stream: h2.Stream, peer: str) -> None:
        sent_headers = False
        try:
            kind, payload, _end = stream.next_event()
            headers = decode_metadata(payload)
            path = headers.get(":path", "")
            timeout = parse_timeout(headers.get("grpc-timeout", ""))
            deadline = None if timeout is None else \
                time.monotonic() + timeout
            ctx = ServerContext(path, headers, peer, deadline)
            msgs = _Messages(stream, None, lambda: None)
            msgs.headers = payload
            try:
                if not headers.get("content-type", "").startswith(
                        CONTENT_TYPE):
                    raise RpcError(INTERNAL, "content-type is not "
                                   "application/grpc")
                entry = self.handlers.get(path)
                if entry is None:
                    raise RpcError(UNIMPLEMENTED, f"unknown method {path}")
                responses = self._invoke(entry, ctx, msgs)
                for msg in responses:
                    if not sent_headers:
                        stream.send_headers([(":status", "200"),
                                             ("content-type", CONTENT_TYPE)])
                        sent_headers = True
                    stream.send_data(frame_message(msg))
                status, details = OK, ""
            except RpcError as e:
                status, details = e.code, e.details
                ctx.trailers.update(e.trailers)
            except h2.StreamReset:
                raise
            except Exception as e:  # noqa: BLE001 — the call's boundary
                status, details = UNKNOWN, f"{type(e).__name__}: {e}"
            trailers = [("grpc-status", str(status))]
            if details:
                trailers.append(("grpc-message", percent_encode(details)))
            trailers += encode_metadata(ctx.trailers)
            if not sent_headers:
                stream.send_headers([(":status", "200"),
                                     ("content-type", CONTENT_TYPE)]
                                    + trailers, end_stream=True)
            else:
                stream.send_headers(trailers, end_stream=True)
            if not stream.remote_closed:
                # answered before the client finished: stop its request
                stream.reset(h2.NO_ERROR)
        except (h2.StreamReset, OSError):
            return  # the client went away or reset the call

    @staticmethod
    def _invoke(entry, ctx: ServerContext, msgs: _Messages) -> Iterable:
        kind, fn = entry

        def requests() -> Iterator[bytes]:
            while True:
                m = msgs.next()
                if m is None:
                    return
                yield m

        if kind in ("unary", "server_stream"):
            req = msgs.next()
            if req is None:
                raise RpcError(INTERNAL, "request without a message")
            out = fn(ctx, req)
        else:
            out = fn(ctx, requests())
        return [out] if kind in ("unary", "client_stream") else out

    def shutdown(self) -> None:
        """Stop accepting, close every connection (GOAWAY) and join the
        accept, connection and call threads."""
        with self._lock:
            self._stopping = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if self._accept is not None:
            self._accept.join()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        for c in conns:
            c.join()
        while True:
            with self._lock:
                threads = [t for t in self._threads if t.is_alive()]
                self._threads = threads
            if not threads:
                return
            for t in threads:
                t.join()


# ---- client --------------------------------------------------------------------


class ClientCall:
    """One call on a channel: write request messages, read responses."""

    def __init__(self, stream: h2.Stream, deadline: Optional[float]):
        self.stream = stream
        self._msgs = _Messages(stream, deadline, self.cancel)
        self._half_closed = False
        self.initial_metadata: Optional[dict] = None
        self.trailers: Optional[dict] = None
        self.code: Optional[int] = None

    def write(self, msg: bytes) -> None:
        try:
            self.stream.send_data(frame_message(msg))
        except h2.StreamReset as e:
            # the server answered (or went away) mid-request: its status
            while self.read() is not None:
                pass
            raise RpcError(UNAVAILABLE, str(e)) from e
        except OSError as e:
            # the socket failed under the send (the peer's process died):
            # UNAVAILABLE, as gRPC reports a lost connection
            raise RpcError(UNAVAILABLE, f"connection lost: {e}") from e

    def done_writing(self) -> None:
        if not self._half_closed:
            self._half_closed = True
            try:
                self.stream.send_data(b"", end_stream=True)
            except (h2.StreamReset, OSError):
                pass  # the read that follows reports the status

    def read(self) -> Optional[bytes]:
        """The next response message; None once the call ended OK.
        Raises RpcError for a non-OK status."""
        try:
            if self.initial_metadata is None:
                self.initial_metadata = decode_metadata(
                    self._msgs.first_headers())
                if self._msgs.ended:  # Trailers-Only
                    self._msgs.trailers = self._msgs.headers
            msg = self._msgs.next()
        except h2.StreamReset as e:
            # a CANCEL reset of the call itself (this side's cancel, the
            # peer's RST_STREAM) is CANCELLED; a lost connection is
            # UNAVAILABLE whatever code its streams were reset with
            cancelled = e.code == h2.CANCEL and not e.lost
            raise RpcError(CANCELLED if cancelled else UNAVAILABLE,
                           str(e)) from e
        if msg is not None:
            return msg
        self._finish()
        return None

    def _finish(self) -> None:
        md = decode_metadata(self._msgs.trailers or [])
        self.trailers = md
        status = md.get("grpc-status")
        if status is None:
            http = (self.initial_metadata or {}).get(":status", "")
            self.code = UNKNOWN if http == "200" else UNAVAILABLE
            raise RpcError(self.code, f"no grpc-status (HTTP {http})", md)
        self.code = int(status)
        if self.code != OK:
            raise RpcError(self.code,
                           percent_decode(md.get("grpc-message", "")), md)

    def cancel(self) -> None:
        try:
            self.stream.reset(h2.CANCEL)
        except (OSError, h2.StreamReset):
            pass

    def responses(self) -> Iterator[bytes]:
        while True:
            msg = self.read()
            if msg is None:
                return
            yield msg


class Channel:
    """A client connection to one `host:port`."""

    def __init__(self, addr: str, name: str = "gtpu-grpc-client"):
        self.addr = addr
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.name = name
        self._lock = threading.Lock()
        self._conn: Optional[h2.Connection] = None

    def _connection(self, timeout: Optional[float]) -> h2.Connection:
        with self._lock:
            c = self._conn
            if c is not None and not c.closed and not c.goaway:
                return c
        # connect outside the lock: a slow peer stalls only this call
        try:
            sock = socket.create_connection(
                (self.host, self.port),
                timeout=10.0 if timeout is None else max(0.05, timeout))
        except OSError as e:
            raise RpcError(UNAVAILABLE,
                           f"failed to connect to {self.addr}: {e}") from e
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        new = h2.Connection(sock, client=True, name=self.name)
        new.start()
        with self._lock:
            c = self._conn
            if c is not None and not c.closed and not c.goaway:
                stale = new  # another caller connected first: keep its
            else:
                stale, self._conn, c = c, new, new
        if stale is not None:  # its reader thread ends here
            stale.close()
            stale.join()
        return c

    def call(self, path: str, metadata=None,
             timeout: Optional[float] = None) -> ClientCall:
        deadline = None if timeout is None else time.monotonic() + timeout
        conn = self._connection(timeout)
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", path), (":authority", self.addr),
                   ("content-type", CONTENT_TYPE), ("te", "trailers")]
        if timeout is not None:
            headers.append(("grpc-timeout", format_timeout(timeout)))
        headers += encode_metadata(metadata or {})
        try:
            stream = conn.open_stream(headers)
        except (h2.StreamReset, OSError) as e:
            raise RpcError(UNAVAILABLE, f"connection to {self.addr} lost: "
                           f"{e}") from e
        return ClientCall(stream, deadline)

    def unary(self, path: str, request: bytes, metadata=None,
              timeout: Optional[float] = None) -> bytes:
        call = self.call(path, metadata, timeout)
        call.write(request)
        call.done_writing()
        out = call.read()
        while call.read() is not None:
            pass
        if out is None:
            raise RpcError(INTERNAL, "unary call without a response")
        return out

    def unary_stream(self, path: str, request: bytes, metadata=None,
                     timeout: Optional[float] = None) -> Iterator[bytes]:
        call = self.call(path, metadata, timeout)
        call.write(request)
        call.done_writing()
        return call.responses()

    def close(self) -> None:
        with self._lock:
            c, self._conn = self._conn, None
        if c is not None:
            c.close()
            c.join()
