"""The port's HPACK, HTTP/2 and gRPC (greptimedb_tpu_torch/servers/
{hpack,h2,grpc}.py) on the CPU: HPACK against RFC 7541's examples and
in round trips, a header block pyarrow's gRPC client sends (Huffman-
coded), a stream sent through a 1-byte window, a header block split
into CONTINUATION frames, PING acks, a client that cancels a stream
mid-flight (the server's call thread ends and the next call works),
grpc-timeout, and no thread left after shutdown."""

import socket
import struct
import threading
import time

import numpy as np
import pyarrow.flight as fl
import pytest

from greptimedb_tpu_torch.servers import grpc, h2, hpack


# ---- HPACK -----------------------------------------------------------------------


def test_integer_representation_rfc_examples():
    assert hpack.encode_int(10, 5) == b"\x0a"
    assert hpack.encode_int(1337, 5) == b"\x1f\x9a\x0a"
    assert hpack.encode_int(42, 8) == b"\x2a"
    assert hpack.decode_int(b"\x1f\x9a\x0a", 0, 5) == (1337, 3)


def test_requests_with_huffman_rfc_c4():
    """RFC 7541 C.4: three requests on one connection, Huffman-coded,
    the dynamic table carried between them."""
    dec = hpack.Decoder()
    blocks = [
        "828684418cf1e3c2e5f23a6ba0ab90f4ff",
        "828684be5886a8eb10649cbf",
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf",
    ]
    want = [
        [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com")],
        [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com"), ("cache-control", "no-cache")],
        [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
         (":authority", "www.example.com"), ("custom-key", "custom-value")],
    ]
    for block, headers, size in zip(blocks, want, (57, 110, 164)):
        assert dec.decode(bytes.fromhex(block)) == headers
        assert dec.size == size
    assert hpack.huffman_encode(b"www.example.com") == \
        bytes.fromhex("f1e3c2e5f23a6ba0ab90f4ff")


def test_dynamic_table_size_update_and_eviction():
    dec = hpack.Decoder(max_table_size=100)
    block = (b"\x40" + hpack.encode_str("k1") + hpack.encode_str("v" * 40)
             + b"\x40" + hpack.encode_str("k2") + hpack.encode_str("w" * 40))
    assert dec.decode(block) == [("k1", "v" * 40), ("k2", "w" * 40)]
    assert dec.table == [("k2", "w" * 40)]  # 74 + 74 > 100: k1 evicted
    assert dec.decode(b"\xbe") == [("k2", "w" * 40)]
    assert dec.decode(b"\x20") == [] and dec.table == []
    with pytest.raises(hpack.HpackError):
        dec.decode(hpack.encode_int(200, 5, 0x20))  # past the setting
    with pytest.raises(hpack.HpackError):
        dec.decode(b"\xbe")  # index past the tables


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_round_trips(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        raw = bytes(rng.integers(0, 256, int(rng.integers(0, 40)))
                    .astype(np.uint8))
        assert hpack.huffman_decode(hpack.huffman_encode(raw)) == raw
    headers = [(":status", "200"), ("content-type", "application/grpc"),
               ("grpc-status", "0"), ("x-custom", "a" * 300),
               ("auth-token-bin", "AAEC"), ("grpc-message", "b%C3%A9")]
    assert hpack.Decoder().decode(hpack.Encoder().encode(headers)) == headers
    with pytest.raises(hpack.HpackError):
        hpack.huffman_decode(b"\x00")  # padding that is not all ones


# ---- a raw HTTP/2 peer ------------------------------------------------------------


class RawPeer:
    """A hand-driven HTTP/2 client: frames in and out, nothing else."""

    def __init__(self, port: int, settings=()):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.rfile = self.sock.makefile("rb")
        self.sock.sendall(h2.PREFACE)
        self.send(h2.SETTINGS, 0, 0, b"".join(
            struct.pack(">HI", k, v) for k, v in settings))

    def send(self, ftype, flags, sid, payload=b""):
        self.sock.sendall(struct.pack(">I", len(payload))[1:]
                          + struct.pack(">BBI", ftype, flags, sid) + payload)

    def read(self):
        head = self.rfile.read(9)
        if len(head) < 9:
            return None
        n = int.from_bytes(head[:3], "big")
        ftype, flags, sid = struct.unpack(">BBI", head[3:])
        return ftype, flags, sid, self.rfile.read(n)

    def request_block(self, path: str) -> bytes:
        return hpack.Encoder().encode([
            (":method", "POST"), (":scheme", "http"), (":path", path),
            (":authority", "x"), ("content-type", "application/grpc"),
            ("te", "trailers")])

    def close(self):
        self.rfile.close()
        self.sock.close()


def _server(handlers):
    srv = grpc.GrpcServer(handlers)
    srv.start()
    return srv


def _port_threads() -> set:
    return {t for t in threading.enumerate()
            if t.name.startswith(("gtpu-grpc", "gtpu-h2"))}


def test_stream_through_a_one_byte_window():
    payload = bytes(range(256)) * 4
    srv = _server({"/t/Big": ("server_stream",
                              lambda ctx, req: [payload])})
    peer = RawPeer(srv.port, settings=[(h2.S_INITIAL_WINDOW_SIZE, 1)])
    try:
        peer.send(h2.HEADERS, h2.END_HEADERS, 1, peer.request_block("/t/Big"))
        peer.send(h2.DATA, h2.END_STREAM, 1, grpc.frame_message(b""))
        body = bytearray()
        frames = 0
        dec = hpack.Decoder()
        while True:
            f = peer.read()
            assert f is not None
            ftype, flags, sid, data = f
            if ftype == h2.DATA and sid == 1:
                assert len(data) <= 1
                body += data
                frames += 1
                peer.send(h2.WINDOW_UPDATE, 0, 1, struct.pack(">I", 1))
            elif ftype == h2.HEADERS:
                headers = dict(dec.decode(data))
                if flags & h2.END_STREAM:
                    assert headers["grpc-status"] == "0"
                    break
        assert bytes(body) == grpc.frame_message(payload)
        assert frames == len(payload) + 5
    finally:
        peer.close()
        srv.shutdown()


def test_headers_continuation_and_ping():
    srv = _server({"/t/Echo": ("unary", lambda ctx, req: req[::-1])})
    peer = RawPeer(srv.port)
    try:
        block = peer.request_block("/t/Echo")
        peer.send(h2.HEADERS, 0, 1, block[:5])
        peer.send(h2.CONTINUATION, 0, 1, block[5:9])
        peer.send(h2.CONTINUATION, h2.END_HEADERS, 1, block[9:])
        peer.send(h2.PING, 0, 0, b"12345678")
        peer.send(h2.DATA, h2.END_STREAM, 1, grpc.frame_message(b"abc"))
        got, pong, dec = b"", False, hpack.Decoder()
        while True:
            ftype, flags, sid, data = peer.read()
            if ftype == h2.PING:
                assert flags & h2.ACK and data == b"12345678"
                pong = True
            elif ftype == h2.DATA:
                got += data
            elif ftype == h2.HEADERS:
                headers = dict(dec.decode(data))
                if flags & h2.END_STREAM:
                    assert headers["grpc-status"] == "0"
                    break
        assert pong and got == grpc.frame_message(b"cba")
    finally:
        peer.close()
        srv.shutdown()


def test_pyarrow_client_header_block_is_read(monkeypatch):
    """The header block of pyarrow's gRPC client (gRPC's C core codes
    `-bin` values with Huffman) decodes to the call's headers."""
    huffman = []
    real = hpack.huffman_decode
    monkeypatch.setattr(hpack, "huffman_decode",
                        lambda raw: huffman.append(raw) or real(raw))
    listener = socket.create_server(("127.0.0.1", 0))
    port = listener.getsockname()[1]
    seen = {}

    listener.settimeout(0.2)
    stop = threading.Event()

    def serve():
        # until a header block arrives: the client may connect again
        while "headers" not in seen and not stop.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            conn.settimeout(30)
            rfile = conn.makefile("rb")
            try:
                if rfile.read(len(h2.PREFACE)) != h2.PREFACE:
                    continue
                conn.sendall(b"\x00\x00\x00\x04\x00\x00\x00\x00\x00")
                dec = hpack.Decoder()
                while True:
                    head = rfile.read(9)
                    if len(head) < 9:
                        break
                    n = int.from_bytes(head[:3], "big")
                    data = rfile.read(n)
                    if head[3] == h2.HEADERS:
                        seen["headers"] = dict(dec.decode(data))
                        break
            except OSError:
                continue
            finally:
                rfile.close()
                conn.close()

    t = threading.Thread(target=serve)
    t.start()
    client = fl.FlightClient(f"grpc://127.0.0.1:{port}")
    token = bytes(range(16))
    with pytest.raises(fl.FlightError):
        client.do_get(fl.Ticket(b"x"), fl.FlightCallOptions(
            timeout=5, headers=[(b"auth-token-bin", token)])).read_all()
    client.close()
    stop.set()
    t.join(30)
    listener.close()
    assert not t.is_alive()
    assert "headers" in seen, "pyarrow's client sent no header block"
    headers = seen["headers"]
    # gRPC's C core Huffman-codes a -bin value's base64
    assert huffman, "no Huffman-coded string in the block"
    assert grpc.decode_metadata(headers.items())["auth-token-bin"] == token
    assert headers[":path"] == "/arrow.flight.protocol.FlightService/DoGet"
    assert headers["content-type"] == "application/grpc"
    assert headers["te"] == "trailers"
    assert "grpc-timeout" in headers
    # gRPC core sends the remaining time rounded UP to three significant
    # figures of its unit: at most 5 s left encodes as at most 5010m
    assert grpc.parse_timeout(headers["grpc-timeout"]) <= 5.01


def test_cancel_mid_stream_ends_the_call_thread():
    ended = threading.Event()

    def forever(ctx, req):
        try:
            while True:
                yield b"x" * 1000
        finally:
            ended.set()

    before = _port_threads()
    srv = _server({"/t/Forever": ("server_stream", forever),
                   "/t/Echo": ("unary", lambda ctx, req: req)})
    ch = grpc.Channel(f"127.0.0.1:{srv.port}")
    call = ch.call("/t/Forever")
    call.write(b"")
    call.done_writing()
    for _ in range(3):
        assert call.read() == b"x" * 1000
    call.cancel()
    assert ended.wait(30)
    deadline = time.monotonic() + 30
    while any(t.name == "gtpu-grpc-call" for t in threading.enumerate()) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not any(t.name == "gtpu-grpc-call"
                   for t in threading.enumerate())
    assert ch.unary("/t/Echo", b"again") == b"again"
    ch.close()
    srv.shutdown()
    assert _port_threads() <= before


def test_timeout_raises_deadline_exceeded():
    release = threading.Event()

    def slow(ctx, req):
        assert 0 < ctx.time_remaining() <= 0.3
        release.wait(10)
        return req

    srv = _server({"/t/Slow": ("unary", slow)})
    ch = grpc.Channel(f"127.0.0.1:{srv.port}")
    with pytest.raises(grpc.RpcError) as e:
        ch.unary("/t/Slow", b"x", timeout=0.2)
    assert e.value.code == grpc.DEADLINE_EXCEEDED
    release.set()
    ch.close()
    srv.shutdown()
    # at most 8 digits: the finest unit that fits
    for s, text in ((0.2, "200000u"), (120.0, "120000m"),
                    (1e6, "1000000S"), (1e9, "16666667M")):
        assert grpc.format_timeout(s) == text
        assert grpc.parse_timeout(text) == pytest.approx(s, rel=1e-3)
    assert grpc.parse_timeout("12x") is None


def test_errors_metadata_and_unknown_methods():
    def fail(ctx, req):
        raise grpc.RpcError(grpc.PERMISSION_DENIED, "no é%",
                            {"x-detail-bin": b"\x00\xff"})

    def boom(ctx, req):
        raise RuntimeError("kaput")

    before = _port_threads()
    srv = _server({"/t/Fail": ("unary", fail), "/t/Boom": ("unary", boom),
                   "/t/Md": ("unary", lambda ctx, req:
                             ctx.metadata["k-bin"] + ctx.metadata["k"]
                             .encode())})
    ch = grpc.Channel(f"127.0.0.1:{srv.port}")
    with pytest.raises(grpc.RpcError) as e:
        ch.unary("/t/Fail", b"")
    assert (e.value.code, e.value.details) == (grpc.PERMISSION_DENIED,
                                               "no é%")
    assert e.value.trailers["x-detail-bin"] == b"\x00\xff"
    with pytest.raises(grpc.RpcError) as e:
        ch.unary("/t/Boom", b"")
    assert e.value.code == grpc.UNKNOWN and "kaput" in e.value.details
    with pytest.raises(grpc.RpcError) as e:
        ch.unary("/t/Nope", b"")
    assert e.value.code == grpc.UNIMPLEMENTED
    assert ch.unary("/t/Md", b"", {"k-bin": b"\x01\x02", "k": "v"}) == \
        b"\x01\x02v"
    ch.close()
    srv.shutdown()
    assert _port_threads() <= before
    with pytest.raises(grpc.RpcError) as e:
        grpc.Channel(f"127.0.0.1:{srv.port}").unary("/t/Md", b"")
    assert e.value.code == grpc.UNAVAILABLE
