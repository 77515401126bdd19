"""End-to-end query deadlines + cooperative cancellation (copy of
greptimedb_tpu/utils/deadline.py).

Every top-level statement executes under a `CancelToken` carrying an
absolute deadline (from the X-Greptime-Timeout header or the `timeout`
parameter, the `max_execution_time` / `statement_timeout` session vars,
or GTPU_QUERY_DEFAULT_TIMEOUT_MS) and a cancel event (KILL QUERY,
DELETE /v1/queries/<id>, or client disconnect). The token rides a
contextvar so every layer under the statement — admission wait, batch
window, device block loop, streamed-block waits — can call `check()` /
`sleep()` / `wait_event()` without plumbing arguments through, and
worker threads re-adopt it via `activate()`.

Expiry raises the typed `DeadlineExceeded`, cancellation the typed
`Cancelled` (both `Unavailable` siblings, greptimedb_tpu_torch/fault) —
the HTTP server maps them to 408/499 instead of a 503 or a stack trace.

The frontend `RUNNING` registry (one entry per in-flight statement)
backs `/v1/queries` and `KILL QUERY <id>`. `budget_ms()` stamps the
remaining budget on an outgoing Flight region-scan ticket, and
`token_for_budget()` turns it back into a token on the serving side.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Callable, Optional

from greptimedb_tpu_torch.fault import (  # noqa: F401 — re-exported
    Cancelled,
    DeadlineExceeded,
)
from greptimedb_tpu_torch.utils.metrics import DEADLINE_EVENTS

#: how often a blocked wait re-checks its token when nothing else wakes
#: it — the cancellation-latency floor for waits on foreign events
POLL_S = 0.05


class CancelToken:
    """One query's deadline + cancel state. Thread-safe; shared by every
    thread working for the query (scan-pool workers, batch leaders,
    hedge attempts). `check()` raises typed exactly once per cause —
    the first raise counts the deadline event, later raises unwind the
    remaining layers without inflating the counter."""

    __slots__ = ("query_id", "deadline", "reason", "kind", "_event",
                 "_counted", "_lock", "_on_cancel")

    def __init__(self, timeout_ms: Optional[float] = None,
                 query_id: Optional[int] = None):
        self.query_id = query_id
        self.deadline = (time.monotonic() + timeout_ms / 1000.0) \
            if timeout_ms and timeout_ms > 0 else None
        self.reason: str = ""
        self.kind: str = ""      # "" | expired | cancelled | killed
        self._event = threading.Event()
        self._counted = False
        self._lock = threading.Lock()
        self._on_cancel: list = []

    # -- state ----------------------------------------------------------------

    def cancel(self, reason: str = "cancelled",
               kind: str = "cancelled", count: bool = True) -> None:
        """Cooperatively cancel (kind: cancelled = disconnect/hedge
        loser, killed = KILL QUERY / DELETE-to-kill). Idempotent; the
        first cause wins. `count=False` pre-marks the token as counted:
        hedge losers are infrastructure churn, not query deadline
        events, and must not inflate the counter."""
        with self._lock:
            if not self.kind:
                self.kind = kind
                self.reason = reason
            if not count:
                self._counted = True
            hooks, self._on_cancel = self._on_cancel, []
            self._event.set()
        for fn in hooks:
            fn()

    def on_cancel(self, fn) -> Callable[[], None]:
        """Call `fn()` once when this token is cancelled (at once if it
        already is): how a cancel reaches a call blocked outside the
        cooperative checkpoints, such as a wire read. Returns the undo,
        which the caller runs once the call is over."""
        with self._lock:
            if not self._event.is_set():
                self._on_cancel.append(fn)
                return lambda: self._forget(fn)
        fn()
        return lambda: None

    def _forget(self, fn) -> None:
        with self._lock:
            if fn in self._on_cancel:
                self._on_cancel.remove(fn)

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def set_timeout(self, timeout_ms: Optional[float]) -> None:
        """Arm the deadline if none is set yet (servers pre-create the
        token for disconnect detection; the engine resolves the budget
        once session vars and defaults are known)."""
        if timeout_ms and timeout_ms > 0 and self.deadline is None:
            self.deadline = time.monotonic() + timeout_ms / 1000.0

    def expired(self) -> bool:
        return self.deadline is not None \
            and time.monotonic() >= self.deadline

    def remaining_s(self) -> Optional[float]:
        """Seconds of budget left; None = no deadline; never negative."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    def remaining_ms(self) -> Optional[float]:
        r = self.remaining_s()
        return None if r is None else r * 1000.0

    # -- the cooperative checkpoint -------------------------------------------

    def _count_once(self, kind: str) -> None:
        with self._lock:
            if self._counted:
                return
            self._counted = True
            if not self.kind:
                self.kind = kind
        DEADLINE_EVENTS.inc(event=self.kind or kind)

    def check(self, where: str = "") -> None:
        """Raise typed if this query is cancelled or past its deadline.
        The cheap per-iteration checkpoint: one Event.is_set + one
        monotonic read."""
        at = f" at {where}" if where else ""
        if self._event.is_set():
            self._count_once(self.kind or "cancelled")
            why = f" ({self.reason})" if self.reason else ""
            raise Cancelled(f"query cancelled{at}{why}")
        if self.expired():
            self._count_once("expired")
            raise DeadlineExceeded(f"query deadline exceeded{at}")

    def clip(self, timeout_s: float) -> float:
        """`timeout_s` clipped to the remaining budget (for bounded
        waits that already have their own timeout)."""
        r = self.remaining_s()
        return timeout_s if r is None else min(timeout_s, r)


# ---- contextvar plumbing ----------------------------------------------------

_current: contextvars.ContextVar = contextvars.ContextVar(
    "gtpu_cancel_token", default=None)


def current() -> Optional[CancelToken]:
    return _current.get()


@contextlib.contextmanager
def activate(token: Optional[CancelToken]):
    """Install `token` as the calling thread's active token (None = run
    unbounded — e.g. maintenance work that must not inherit a query's
    budget). Worker threads executing on a query's behalf re-adopt the
    submitting thread's token through this."""
    cv_token = _current.set(token)
    try:
        yield token
    finally:
        _current.reset(cv_token)


def check(where: str = "") -> None:
    """Module-level checkpoint: no-op without an active token."""
    token = _current.get()
    if token is not None:
        token.check(where)


def budget_ms() -> Optional[int]:
    """The remaining budget to stamp on an outgoing scan ticket (whole
    milliseconds; None = unbounded)."""
    token = _current.get()
    r = None if token is None else token.remaining_ms()
    return None if r is None else max(0, int(r))


def token_for_budget(budget: Optional[float]) -> Optional[CancelToken]:
    """Region-service ingress: a local token enforcing the budget a
    ticket carried (server-side deadline enforcement — the caller's
    token cannot cross the process boundary). A spent budget (0) is a
    token already past its deadline; the JAX copy's CancelToken(0) has
    none (ROADMAP C, "Reference defects")."""
    if budget is None:
        return None
    return CancelToken(timeout_ms=max(float(budget), 1e-3))


def default_timeout_ms() -> float:
    """[query] default_timeout_ms, env-mediated (options.py writes
    GTPU_QUERY_DEFAULT_TIMEOUT_MS so children inherit); 0 = unbounded."""
    try:
        return float(os.environ.get("GTPU_QUERY_DEFAULT_TIMEOUT_MS",
                                    "0") or 0.0)
    except ValueError:
        return 0.0


def parse_timeout_ms(value) -> Optional[float]:
    """Tolerant session-var parse: 500 / '500' are milliseconds (the
    MySQL max_execution_time unit), '500ms' / '2s' / '1min' carry a PG
    interval unit, quotes are shed. None/unparseable -> None."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().strip("'\"").lower()
    if not s:
        return None
    mult = 1.0
    if s.endswith("ms"):
        s = s[:-2]
    elif s.endswith("min"):
        s, mult = s[:-3], 60000.0
    elif s.endswith("s"):
        s, mult = s[:-1], 1000.0
    try:
        return float(s) * mult
    except ValueError:
        return None


def sleep(delay_s: float, point: str = "") -> None:
    """Interruptible sleep: wakes (and raises typed) the moment the
    active token is cancelled, and never sleeps past its deadline.
    Without a token this is a plain time.sleep."""
    token = _current.get()
    if token is None:
        if delay_s > 0:
            time.sleep(delay_s)
        return
    token.check(point)
    remaining = token.remaining_s()
    bounded = delay_s if remaining is None else min(delay_s, remaining)
    if bounded > 0 and token._event.wait(bounded):
        pass  # cancelled mid-sleep: fall through to the typed raise
    token.check(point)


def propagate(fn):
    """Wrap `fn` so the caller's active token rides into whichever worker
    thread runs it (contextvars do not cross threads on their own): the
    deadline twin of tracing.propagate, for fan-out sites that hand
    per-region work to a pool."""
    token = _current.get()
    if token is None:
        return fn

    def run(*args, **kwargs):
        with activate(token):
            return fn(*args, **kwargs)

    return run


def wait_future(fut, where: str = ""):
    """Deadline-aware Future.result(): re-checks the active token every
    POLL_S so a cancelled/expired query unwinds typed instead of
    parking on a wedged worker. Tokenless callers block plainly (with a
    long bound so a wedged pool is diagnosable, not a silent hang)."""
    from concurrent.futures import TimeoutError as _FutTimeout

    token = _current.get()
    if token is None:
        return fut.result(timeout=3600.0)
    while True:
        token.check(where)
        try:
            return fut.result(timeout=POLL_S)
        except _FutTimeout:
            continue


def wait_event(event: threading.Event, timeout_s: float,
               where: str = "") -> bool:
    """Wait on a foreign event (admission grant, batch-leader done,
    single-flight result) while honoring the active token: returns
    event.is_set() within `timeout_s`, raises typed on cancel/expiry.
    The foreign event's owner doesn't know about the token, so the wait
    re-checks every POLL_S."""
    token = _current.get()
    if token is None:
        return event.wait(timeout_s)
    end = time.monotonic() + timeout_s
    while True:
        token.check(where)
        left = end - time.monotonic()
        if left <= 0:
            return event.is_set()
        if event.wait(min(POLL_S, token.clip(left))):
            return True


def watch_disconnect(sock, token: CancelToken):
    """Cancel `token` when the client socket hits EOF while its
    statement executes (the HTTP/MySQL/PG request is fully read, so
    readable-with-zero-bytes means the peer closed — abandoning work for
    a dead client is the whole point of the cancellation plane).
    Returns a stop() callable the server invokes once the statement
    finishes; it joins the watcher. Non-fatal best effort: a TLS-wrapped
    socket can't be MSG_PEEKed with flags, so the watcher just stands
    down."""
    import select as _select
    import socket as _socket

    done = threading.Event()

    def run():
        while not done.wait(POLL_S):
            try:
                # poll first: on a socket with a timeout (the HTTP
                # server's `http.timeout_s`) Python waits up to that
                # timeout inside recv whatever the flags, and stop()
                # would join a watcher that cannot see `done` meanwhile
                # (a statement past POLL_S took the whole 30 s)
                readable, _, _ = _select.select([sock], [], [], 0)
                if not readable:
                    continue  # nothing readable: the client is still there
                data = sock.recv(1, _socket.MSG_PEEK | _socket.MSG_DONTWAIT)
            except (BlockingIOError, InterruptedError, TimeoutError):
                continue  # nothing readable: the client is still there
            except ValueError:
                return  # TLS socket: flags unsupported, cannot watch
            except OSError:
                token.cancel("client disconnected", kind="cancelled")
                return
            if data == b"":
                token.cancel("client disconnected", kind="cancelled")
                return
            return  # pipelined next request, not a close: stand down

    t = threading.Thread(target=run, name="gtpu-disconnect-watch",
                         daemon=True)
    t.start()

    def stop():
        # joined, not just signalled: no watcher outlives its statement
        done.set()
        t.join()

    return stop


# ---- frontend running-queries registry --------------------------------------


class RunningQueries:
    """Every in-flight statement on this frontend, keyed by a
    process-unique query id — the surface behind
    information_schema.running_queries, /v1/queries, and KILL QUERY."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._entries: dict[int, dict] = {}
        self._lock = threading.Lock()

    def register(self, token: CancelToken, sql: str, db: str = "",
                 channel: str = "", tenant: str = "",
                 trace_id: str = "") -> int:
        qid = next(self._ids)
        token.query_id = qid
        with self._lock:
            self._entries[qid] = {
                "id": qid, "token": token, "query": sql, "db": db,
                "channel": channel, "tenant": tenant or "default",
                "trace_id": trace_id or "",
                "start_monotonic": time.monotonic(),
                "start_time_ms": int(time.time() * 1000),
            }
        return qid

    def unregister(self, qid: Optional[int]) -> None:
        if qid is None:
            return
        with self._lock:
            self._entries.pop(qid, None)

    def get(self, qid: int) -> Optional[dict]:
        with self._lock:
            return self._entries.get(qid)

    def kill(self, qid: int, reason: str = "killed") -> bool:
        """Cancel query `qid` (KILL QUERY / DELETE /v1/queries/<id>).
        False when the id is unknown or already finished."""
        with self._lock:
            entry = self._entries.get(qid)
        if entry is None:
            return False
        entry["token"].cancel(reason=reason, kind="killed")
        return True

    def list(self) -> list[dict]:
        """Snapshot for the observability surfaces (token objects
        replaced by their state)."""
        now = time.monotonic()
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
        out = []
        for e in entries:
            token: CancelToken = e.pop("token")
            rem = token.remaining_ms()
            e["elapsed_ms"] = (now - e.pop("start_monotonic")) * 1000.0
            e["remaining_ms"] = rem
            e["cancelled"] = token.cancelled
            out.append(e)
        out.sort(key=lambda e: e["id"])
        return out


#: process-wide registry (frontends register; datanode budget tokens
#: are anonymous and never land here)
RUNNING = RunningQueries()
