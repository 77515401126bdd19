"""OpenTSDB telnet protocol (mirrors reference servers::opentsdb,
src/servers/src/opentsdb.rs + codec: line-based TCP `put` commands).

    put <metric> <timestamp> <value> <tagk=tagv> [<tagk=tagv> ...]

Timestamps are seconds or milliseconds by magnitude (like the HTTP
/api/put endpoint in http.py). `version` and `exit` are handled for
telnet compatibility; malformed puts answer a diagnostic line, matching
OpenTSDB's telnet behavior.

Counterpart of greptimedb_tpu/servers/opentsdb.py. Its server joins the
serve thread and every session thread in `shutdown()`
(servers/tcp.py::JoinedThreads), where the JAX server leaves daemon
threads behind, and each `put` runs in a `request_span("opentsdb:put")`
(a trace of its own, as every other front door's request), where the
JAX session writes untraced.
"""

from __future__ import annotations

import socketserver
import threading
from typing import Optional

from greptimedb_tpu_torch.fault import Unavailable
from greptimedb_tpu_torch.query.engine import QueryEngine
from greptimedb_tpu_torch.servers.tcp import ThreadingServer
from greptimedb_tpu_torch.utils import tracing
from greptimedb_tpu_torch.utils.metrics import INGEST_ROWS

GREPTIME_VALUE = "greptime_value"


def parse_put_line(line: str):
    """One telnet put command → (metric, ts_ms, value, tags)."""
    parts = line.split()
    if not parts or parts[0] != "put":
        raise ValueError(f"unknown command {parts[0] if parts else ''!r}")
    if len(parts) < 4:
        raise ValueError("put needs: metric timestamp value [tags]")
    metric = parts[1]
    ts = int(float(parts[2]))
    ts_ms = ts * 1000 if ts < 10_000_000_000 else ts
    value = float(parts[3])
    tags = []
    for kv in parts[4:]:
        k, sep, v = kv.partition("=")
        if not sep or not k or not v:
            raise ValueError(f"bad tag {kv!r}")
        tags.append((k, v))
    return metric, ts_ms, value, sorted(tags)


class _Session(socketserver.StreamRequestHandler):
    disable_nagle_algorithm = True

    def handle(self):
        server: OpentsdbServer = self.server.owner  # type: ignore[attr-defined]
        from greptimedb_tpu_torch.servers.influx import Point, write_points

        while True:
            raw = self.rfile.readline()
            if not raw:
                return
            line = raw.decode(errors="replace").strip()
            if not line:
                continue
            cmd = line.split(None, 1)[0]
            if cmd == "exit":
                return
            if cmd == "version":
                self.wfile.write(b"greptimedb_tpu opentsdb endpoint\n")
                continue
            try:
                with tracing.request_span("opentsdb:put") as attrs:
                    metric, ts_ms, value, tags = parse_put_line(line)
                    point = Point(measurement=metric, tags=tags,
                                  fields=[(GREPTIME_VALUE, value)],
                                  ts=ts_ms)
                    n = write_points(server.query_engine, server.db,
                                     [point], precision="ms")
                    attrs["rows"] = n
                INGEST_ROWS.inc(n, protocol="opentsdb")
            except Unavailable as e:
                # typed backpressure: the telnet protocol has no status
                # codes, but "unavailable" is what tcollector-style
                # clients pattern-match to back off and retry
                self.wfile.write(f"put: unavailable: {e}\n".encode())
            except Exception as e:  # noqa: BLE001 — wire boundary
                self.wfile.write(f"put: {e}\n".encode())


class OpentsdbServer:
    """Telnet-mode OpenTSDB ingestion over the shared QueryEngine."""

    def __init__(self, query_engine: QueryEngine, host: str = "127.0.0.1",
                 port: int = 4242, db: str = "public"):
        self.query_engine = query_engine
        self.db = db
        self._server = ThreadingServer((host, port), _Session)
        self._server.owner = self
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="gtpu-opentsdb-serve",
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        """Stop accepting, close every open session and join the serve
        thread and every session thread."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
        self._server.close_all()
