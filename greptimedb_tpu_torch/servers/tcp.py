"""Threaded servers whose threads are all joined at shutdown: the HTTP,
MySQL and Postgres servers handle each connection on its own thread,
and `JoinedThreads` tracks every one of them so `close_all()` can close
the open connections and join them all. No server thread outlives a
server's `stop()` / `shutdown()` (the JAX servers leave daemon handler
threads to wind down on their own).
"""

from __future__ import annotations

import socket
import socketserver
import threading


class JoinedThreads:
    """Mixin for a socketserver.ThreadingMixIn server (put it first in
    the bases)."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._lock = threading.Lock()
        self._conns: dict = {}  # handler thread -> the socket it serves
        self._workers: list = []  # every handler thread not yet joined
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        # on the serve thread: once serve_forever has returned,
        # `_workers` holds every handler thread ever started
        t = threading.Thread(target=self.process_request_thread,
                             args=(request, client_address), daemon=True)
        with self._lock:
            self._workers[:] = [w for w in self._workers if w.is_alive()]
            self._workers.append(t)
            self._conns[t] = request
        t.start()

    def track(self, sock) -> None:
        """The calling handler now serves `sock` (its connection after a
        TLS upgrade, which detaches the accepted socket)."""
        with self._lock:
            self._conns[threading.current_thread()] = sock

    def shutdown_request(self, request):
        with self._lock:
            current = self._conns.pop(threading.current_thread(), None)
        if current is not None and current is not request:
            current.close()
        super().shutdown_request(request)

    def close_all(self) -> None:
        """After the serve thread has returned: shut every open
        connection down so its handler's blocking read returns, join
        every handler thread, and close the listening socket."""
        with self._lock:
            conns = list(self._conns.values())
            workers = list(self._workers)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in workers:
            t.join()
        self.server_close()


class ThreadingServer(JoinedThreads, socketserver.ThreadingTCPServer):
    """The MySQL and Postgres servers' TCP server."""

    allow_reuse_address = True
