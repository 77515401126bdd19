"""HTTP/2 (RFC 9113) over cleartext TCP with prior knowledge (h2c), the
transport of the port's gRPC (`servers/grpc.py`).

One `Connection` serves either end. Its reader thread reads frames and
hands each stream its header blocks and data; callers on other threads
send on their streams. Frame writes are serialized by one lock, so a
header block and its CONTINUATION frames go out together.

- Frames: the client preface, SETTINGS and their ACK, HEADERS with
  CONTINUATION (padding and priority fields stripped), DATA (padded or
  not), WINDOW_UPDATE, PING and its ACK, RST_STREAM and GOAWAY;
  PRIORITY and unknown frame types are ignored.
- Flow control: the connection and every stream keep a send window
  (the peer's SETTINGS_INITIAL_WINDOW_SIZE, changes applied to open
  streams, and its WINDOW_UPDATEs); a send waits while either window
  is 0 and never writes a frame past the peer's SETTINGS_MAX_FRAME_SIZE.
  This side opens large receive windows (`RECV_WINDOW` a stream,
  `CONN_WINDOW` the connection) and hands credit back as the consumer
  reads, so a slow consumer holds the sender back.
- A stream reset by the peer (RST_STREAM), or a connection that ends,
  wakes every waiter on the stream with `StreamReset`.
"""

from __future__ import annotations

import collections
import socket
import struct
import threading
from typing import Callable, Optional

from greptimedb_tpu_torch.servers.hpack import Decoder, Encoder, HpackError

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0, 1, 2, 3, 4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 5, 6, 7, 8, 9
END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20

S_ENABLE_PUSH, S_INITIAL_WINDOW_SIZE, S_MAX_FRAME_SIZE = 2, 4, 5

NO_ERROR, PROTOCOL_ERROR, FLOW_CONTROL_ERROR = 0, 1, 3
FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = 6, 7, 8, 9

DEFAULT_WINDOW = 65_535
MAX_WINDOW = (1 << 31) - 1
#: this side's receive windows: a stream's, and the connection's
RECV_WINDOW = 1 << 24
CONN_WINDOW = 1 << 30
#: the largest frame this side accepts (SETTINGS_MAX_FRAME_SIZE)
RECV_MAX_FRAME = 1 << 20


class H2Error(Exception):
    """A connection error: the peer broke the protocol."""

    def __init__(self, code: int, what: str):
        super().__init__(what)
        self.code = code


class StreamReset(Exception):
    """The stream ended abnormally: the peer reset it, or the connection
    went away (`lost`: the socket closed or failed under the stream, as
    when the peer's process dies, not an RST_STREAM of either side)."""

    def __init__(self, code: int, what: str = "", lost: bool = False):
        super().__init__(what or f"stream reset (code {code})")
        self.code = code
        self.lost = lost


class Stream:
    """One HTTP/2 stream. Received header blocks and data queue up in
    order as events: ("headers", [(name, value)], end_stream) and
    ("data", bytes, end_stream)."""

    def __init__(self, conn: "Connection", sid: int):
        self.conn = conn
        self.id = sid
        self.send_window = conn.peer_initial_window
        self.events: collections.deque = collections.deque()
        self.cv = threading.Condition()
        self.remote_closed = False  # the peer sent END_STREAM
        self.local_closed = False   # this side sent END_STREAM
        self.reset_code: Optional[int] = None
        self.reset_what = ""
        self.reset_lost = False     # reset because the connection went
        self._unacked = 0           # bytes read, credit not yet returned

    # -- receiving -----------------------------------------------------------

    def _push(self, event) -> None:
        with self.cv:
            self.events.append(event)
            if event[2]:
                self.remote_closed = True
            self.cv.notify_all()

    def _reset(self, code: int, what: str = "", lost: bool = False) -> None:
        with self.cv:
            if self.reset_code is None:
                self.reset_code = code
                self.reset_what = what
                self.reset_lost = lost
            self.cv.notify_all()

    def next_event(self, timeout: Optional[float] = None):
        """The next event, or None if `timeout` passed first. Raises
        StreamReset once the queue is drained and the stream is reset."""
        with self.cv:
            if not self.cv.wait_for(
                    lambda: self.events or self.reset_code is not None,
                    timeout):
                return None
            if self.events:
                ev = self.events.popleft()
            else:
                raise StreamReset(self.reset_code, self.reset_what,
                                  self.reset_lost)
        if ev[0] == "data" and ev[1]:
            self._credit(len(ev[1]))
        return ev

    def _credit(self, n: int) -> None:
        """`n` bytes were consumed: hand the credit back once half the
        stream's window is used, and count them for the connection."""
        self.conn._consumed(n)
        with self.cv:
            self._unacked += n
            if self._unacked < RECV_WINDOW // 2 or self.remote_closed:
                return
            n, self._unacked = self._unacked, 0
        self.conn._window_update(self.id, n)

    # -- sending -------------------------------------------------------------

    def send_headers(self, headers, end_stream: bool = False) -> None:
        self.conn._send_headers(self, headers, end_stream)

    def send_data(self, data, end_stream: bool = False) -> None:
        self.conn._send_data(self, data, end_stream)

    def reset(self, code: int = CANCEL) -> None:
        """Reset the stream from this side (RST_STREAM)."""
        with self.cv:
            send = self.reset_code is None and not (self.local_closed
                                                    and self.remote_closed)
        if send:
            self.conn._write_frame(RST_STREAM, 0, self.id,
                                   struct.pack(">I", code))
        self._reset(code, "reset by this side")
        self.conn._forget(self)


class Connection:
    """An HTTP/2 connection over a connected socket. A server passes
    `on_stream`, called on the reader thread with each stream the peer
    opens (after its first header block is queued)."""

    def __init__(self, sock: socket.socket, client: bool,
                 on_stream: Optional[Callable[[Stream], None]] = None,
                 name: str = "gtpu-h2"):
        self.sock = sock
        self.client = client
        self.on_stream = on_stream
        self.name = name
        self._rfile = sock.makefile("rb", buffering=1 << 18)
        self._wlock = threading.Lock()
        self._cv = threading.Condition()  # send windows, the stream table
        self.streams: dict[int, Stream] = {}
        self.next_id = 1 if client else 2
        self.last_peer_id = 0
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = 16_384
        self.conn_send_window = DEFAULT_WINDOW
        self._conn_unacked = 0
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.closed = False
        self.goaway = False
        self.error: Optional[BaseException] = None
        self._reader: Optional[threading.Thread] = None

    # -- lifetime ------------------------------------------------------------

    def start(self) -> None:
        """Send the preface (a client's) and SETTINGS, open the receive
        window, and start the reader thread."""
        settings = [(S_INITIAL_WINDOW_SIZE, RECV_WINDOW),
                    (S_MAX_FRAME_SIZE, RECV_MAX_FRAME)]
        if self.client:
            settings.append((S_ENABLE_PUSH, 0))
        payload = b"".join(struct.pack(">HI", k, v) for k, v in settings)
        with self._wlock:
            if self.client:
                self.sock.sendall(PREFACE)
        self._write_frame(SETTINGS, 0, 0, payload)
        self._window_update(0, CONN_WINDOW - DEFAULT_WINDOW)
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"{self.name}-reader",
                                        daemon=True)
        self._reader.start()

    def close(self, code: int = NO_ERROR) -> None:
        """GOAWAY, then shut the socket down; the reader thread ends."""
        try:
            self._write_frame(GOAWAY, 0, 0,
                              struct.pack(">II", self.last_peer_id, code))
        except (OSError, StreamReset):
            pass  # already closed
        self._shutdown_socket()

    def _shutdown_socket(self) -> None:
        # the shutdown first: it fails a writer blocked in sendall, which
        # then lets go of the write lock
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        with self._wlock:
            self.closed = True
        with self._cv:
            self._cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._reader is not None:
            self._reader.join(timeout)

    def running(self) -> bool:
        """The reader thread has not ended yet."""
        return self._reader is not None and self._reader.is_alive()

    # -- writing -------------------------------------------------------------

    def _write_frame(self, ftype: int, flags: int, sid: int,
                     payload=b"") -> None:
        header = struct.pack(">I", len(payload))[1:] + \
            struct.pack(">BBI", ftype, flags, sid)
        with self._wlock:
            if self.closed:
                raise StreamReset(CANCEL, "connection closed", lost=True)
            self.sock.sendall(header)
            if payload:
                self.sock.sendall(payload)

    def _window_update(self, sid: int, n: int) -> None:
        if n > 0:
            try:
                self._write_frame(WINDOW_UPDATE, 0, sid,
                                  struct.pack(">I", n))
            except (OSError, StreamReset):
                pass

    def _consumed(self, n: int) -> None:
        if not n:
            return
        with self._cv:
            self._conn_unacked += n
            if self._conn_unacked < CONN_WINDOW // 2:
                return
            n, self._conn_unacked = self._conn_unacked, 0
        self._window_update(0, n)

    def open_stream(self, headers, end_stream: bool = False) -> Stream:
        """A client stream: its id and its header block go out under one
        lock, so ids reach the peer in increasing order."""
        with self._wlock:
            if self.closed or self.goaway:
                raise StreamReset(REFUSED_STREAM, "connection closed")
            sid = self.next_id
            self.next_id += 2
            st = Stream(self, sid)
            with self._cv:
                self.streams[sid] = st
            self._headers_locked(st, headers, end_stream)
        return st

    def _send_headers(self, st: Stream, headers, end_stream: bool) -> None:
        with self._wlock:
            self._headers_locked(st, headers, end_stream)

    def _headers_locked(self, st: Stream, headers, end_stream: bool) -> None:
        if self.closed:
            raise StreamReset(CANCEL, "connection closed", lost=True)
        if st.reset_code is not None:
            raise StreamReset(st.reset_code, "stream reset", st.reset_lost)
        block = self.encoder.encode(headers)
        step = self.peer_max_frame
        chunks = [block[i:i + step] for i in range(0, len(block), step)] \
            or [b""]
        for i, chunk in enumerate(chunks):
            ftype = HEADERS if i == 0 else CONTINUATION
            flags = (END_HEADERS if i == len(chunks) - 1 else 0) | \
                (END_STREAM if end_stream and i == 0 else 0)
            self.sock.sendall(struct.pack(">I", len(chunk))[1:]
                              + struct.pack(">BBI", ftype, flags, st.id))
            self.sock.sendall(chunk)
        if end_stream:
            st.local_closed = True
            self._maybe_forget(st)

    def _send_data(self, st: Stream, data, end_stream: bool) -> None:
        view = memoryview(data)
        pos, n = 0, len(view)
        while pos < n or (end_stream and pos == n):
            with self._cv:
                while True:
                    if st.reset_code is not None:
                        raise StreamReset(st.reset_code, "stream reset",
                                          st.reset_lost)
                    if self.closed:
                        raise StreamReset(CANCEL, "connection closed",
                                          lost=True)
                    if pos == n or (self.conn_send_window > 0
                                    and st.send_window > 0):
                        break
                    # woken by a WINDOW_UPDATE, a reset or the close; the
                    # timeout only re-checks
                    self._cv.wait(1.0)
                size = min(n - pos, self.conn_send_window, st.send_window,
                           self.peer_max_frame)
                self.conn_send_window -= size
                st.send_window -= size
            last = pos + size == n
            flags = END_STREAM if end_stream and last else 0
            self._write_frame(DATA, flags, st.id, view[pos:pos + size])
            pos += size
            if flags:
                st.local_closed = True
                self._maybe_forget(st)
                return

    def _maybe_forget(self, st: Stream) -> None:
        if st.local_closed and st.remote_closed:
            self._forget(st)

    def _forget(self, st: Stream) -> None:
        with self._cv:
            self.streams.pop(st.id, None)
            self._cv.notify_all()

    # -- reading -------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        data = self._rfile.read(n)
        if data is None or len(data) < n:
            raise ConnectionError("connection closed by the peer")
        return data

    def _read_loop(self) -> None:
        code = NO_ERROR
        try:
            if not self.client:
                if self._read_exact(len(PREFACE)) != PREFACE:
                    raise H2Error(PROTOCOL_ERROR, "bad client preface")
            while True:
                self._read_frame()
        except H2Error as e:
            code = e.code
            self.error = e
            try:
                self._write_frame(GOAWAY, 0, 0, struct.pack(
                    ">II", self.last_peer_id, e.code) + str(e).encode())
            except (OSError, StreamReset):
                pass
        except (OSError, ConnectionError, ValueError) as e:
            self.error = e
            code = CANCEL
        finally:
            self._shutdown_socket()
            with self._cv:
                streams = list(self.streams.values())
                self._cv.notify_all()
            for st in streams:
                st._reset(code if code != NO_ERROR else CANCEL,
                          f"connection lost: {self.error}", lost=True)
            self._rfile.close()

    def _read_frame(self) -> None:
        head = self._read_exact(9)
        length = int.from_bytes(head[:3], "big")
        ftype, flags, sid = struct.unpack(">BBI", head[3:])
        sid &= 0x7FFFFFFF
        if length > RECV_MAX_FRAME:
            raise H2Error(FRAME_SIZE_ERROR, f"frame of {length} bytes")
        payload = self._read_exact(length) if length else b""
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            self._on_headers(flags, sid, payload)
        elif ftype == SETTINGS:
            self._on_settings(flags, sid, payload)
        elif ftype == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif ftype == PING:
            if len(payload) != 8 or sid:
                raise H2Error(PROTOCOL_ERROR, "bad PING")
            if not flags & ACK:
                self._write_frame(PING, ACK, 0, payload)
        elif ftype == RST_STREAM:
            if len(payload) != 4 or not sid:
                raise H2Error(PROTOCOL_ERROR, "bad RST_STREAM")
            st = self.streams.get(sid)
            if st is not None:
                st._reset(struct.unpack(">I", payload)[0],
                          "reset by the peer")
                self._forget(st)
        elif ftype == GOAWAY:
            last = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            with self._wlock:
                self.goaway = True
            with self._cv:
                doomed = [s for i, s in self.streams.items() if i > last
                          and (i % 2 == 1) == self.client]
            for st in doomed:
                st._reset(REFUSED_STREAM, "refused by GOAWAY")
                self._forget(st)
        elif ftype == CONTINUATION:
            raise H2Error(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        elif ftype == PUSH_PROMISE:
            raise H2Error(PROTOCOL_ERROR, "PUSH_PROMISE was disabled")
        # PRIORITY and unknown types are ignored

    @staticmethod
    def _strip_padding(flags: int, payload: bytes) -> bytes:
        if flags & PADDED:
            if not payload:
                raise H2Error(PROTOCOL_ERROR, "padded frame without length")
            pad = payload[0]
            if pad >= len(payload):
                raise H2Error(PROTOCOL_ERROR, "padding past the frame")
            return payload[1:len(payload) - pad]
        return payload

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if not sid:
            raise H2Error(PROTOCOL_ERROR, "DATA on stream 0")
        n = len(payload)
        data = self._strip_padding(flags, payload)
        st = self.streams.get(sid)
        if st is None or st.reset_code is not None:
            # a closed stream: its flow-control share goes straight back
            self._consumed(n)
            return
        if n > len(data):
            st._credit(n - len(data))  # padding counts, is never read
        st._push(("data", data, bool(flags & END_STREAM)))
        if flags & END_STREAM:
            self._maybe_forget(st)

    def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        if not sid:
            raise H2Error(PROTOCOL_ERROR, "HEADERS on stream 0")
        block = self._strip_padding(flags, payload)
        if flags & PRIORITY_FLAG:
            block = block[5:]
        end_stream = bool(flags & END_STREAM)
        while not flags & END_HEADERS:
            head = self._read_exact(9)
            length = int.from_bytes(head[:3], "big")
            ftype, flags, csid = struct.unpack(">BBI", head[3:])
            if ftype != CONTINUATION or (csid & 0x7FFFFFFF) != sid:
                raise H2Error(PROTOCOL_ERROR,
                              "header block interrupted")
            if length > RECV_MAX_FRAME:
                raise H2Error(FRAME_SIZE_ERROR, f"frame of {length} bytes")
            block += self._read_exact(length) if length else b""
        try:
            headers = self.decoder.decode(block)
        except HpackError as e:
            raise H2Error(COMPRESSION_ERROR, str(e)) from e
        st = self.streams.get(sid)
        new = False
        if st is None:
            if self.client or sid % 2 == 0 or sid <= self.last_peer_id:
                return  # a stream already forgotten (reset or done)
            self.last_peer_id = sid
            st = Stream(self, sid)
            with self._cv:
                self.streams[sid] = st
            new = True
        st._push(("headers", headers, end_stream))
        if end_stream:
            self._maybe_forget(st)
        if new and self.on_stream is not None:
            self.on_stream(st)

    def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        if sid:
            raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            return
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "SETTINGS length")
        for i in range(0, len(payload), 6):
            key, value = struct.unpack(">HI", payload[i:i + 6])
            if key == S_INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR, "window past 2^31-1")
                with self._cv:
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for st in self.streams.values():
                        st.send_window += delta
                    self._cv.notify_all()
            elif key == S_MAX_FRAME_SIZE:
                if not 16_384 <= value <= (1 << 24) - 1:
                    raise H2Error(PROTOCOL_ERROR, "bad SETTINGS_MAX_FRAME")
                with self._wlock:
                    self.peer_max_frame = value
        self._write_frame(SETTINGS, ACK, 0)

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "WINDOW_UPDATE length")
        inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
        with self._cv:
            if not sid:
                if not inc:
                    raise H2Error(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                self.conn_send_window += inc
                if self.conn_send_window > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR, "window past 2^31-1")
            else:
                st = self.streams.get(sid)
                if st is not None:
                    st.send_window += inc
            self._cv.notify_all()
