"""Slow-query log: a bounded ring of structured records for statements
that crossed a configurable latency threshold.

Mirrors the reference's slow-query timer (servers register a slow query
threshold and log structured records; GreptimeDB additionally exposes
them as a system table). Here every SQL statement and PromQL evaluation
runs under `watch(...)`; when its wall time crosses the threshold the
record — trace id, query text, duration, rows, execution path, and the
per-stage span breakdown — lands in a process-wide ring surfaced three
ways:

- `information_schema.slow_queries` (SQL)
- `GET /v1/slow_queries` (HTTP debug route, auth-gated)
- `greptimedb_tpu_slow_queries_total` counter at /metrics

Configuration: `[slow_query]` options (options.py) write the
GTPU_SLOW_QUERY_MS / GTPU_SLOW_QUERY_RING env knobs this module reads —
same env-is-truth layering as config.py, so child datanode processes
inherit the operator's setting. Threshold <= 0 disables capture.

Copy of greptimedb_tpu/utils/slow_query.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.utils import ledger, tracing
from greptimedb_tpu_torch.utils.metrics import SLOW_QUERIES

#: default threshold (ms); the reference defaults its slow-query timer on
DEFAULT_THRESHOLD_MS = 1000.0
DEFAULT_RING = 128

#: re-entrancy guard: TQL runs PromQL INSIDE an execute_sql statement —
#: only the outermost watch records (the inner text is a substring of
#: the outer statement anyway)
_active: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "gtpu_slow_query_active", default=False)

def _ring_capacity() -> int:
    try:
        return max(1, int(os.environ.get("GTPU_SLOW_QUERY_RING",
                                         DEFAULT_RING)))
    except ValueError:
        return DEFAULT_RING


_lock = threading.Lock()
_ring: deque = deque(maxlen=_ring_capacity())


def threshold_ms() -> float:
    try:
        return float(os.environ.get("GTPU_SLOW_QUERY_MS",
                                    DEFAULT_THRESHOLD_MS))
    except ValueError:
        return DEFAULT_THRESHOLD_MS


def configure(threshold: Optional[float] = None,
              ring_size: Optional[int] = None) -> None:
    """Apply [slow_query] options: env is the store (children inherit
    both knobs), the ring is rebuilt only when its capacity changes."""
    global _ring
    if threshold is not None:
        os.environ["GTPU_SLOW_QUERY_MS"] = str(float(threshold))
    if ring_size is not None:
        os.environ["GTPU_SLOW_QUERY_RING"] = str(int(ring_size))
        if ring_size != _ring.maxlen:
            with _lock:
                _ring = deque(_ring, maxlen=max(1, int(ring_size)))


@dataclass
class SlowQuery:
    trace_id: str
    kind: str            # sql | promql
    query: str
    db: str
    duration_ms: float
    threshold_ms: float
    rows: int
    execution_path: Optional[str]
    started_at: float    # epoch seconds
    #: why the statement never reached the plan cache (join/cte/
    #: subquery/range_select/window) — uncacheable dashboard queries
    #: show up here instead of just being slow
    plan_cache_skip: Optional[str] = None
    #: how the deadline plane ended this statement, if it did
    #: (expired | cancelled | killed) — an expired statement is almost
    #: always a slow one, so the record says WHY it stopped
    deadline_event: Optional[str] = None
    stages: list = field(default_factory=list)  # (node, name, ms) triples
    #: the statement's slice of the per-query resource ledger (cache
    #: hits, H2D bytes, admission wait, rows scanned — utils/ledger.py)
    ledger: dict = field(default_factory=dict)
    #: roofline fold over that same ledger slice (utils/roofline.py) —
    #: None when the statement moved no bytes (host-only work)
    achieved_gbps: Optional[float] = None
    roofline_fraction: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "kind": self.kind,
            "query": self.query, "db": self.db,
            "duration_ms": round(self.duration_ms, 3),
            "threshold_ms": self.threshold_ms, "rows": self.rows,
            "execution_path": self.execution_path,
            "plan_cache_skip": self.plan_cache_skip,
            "deadline_event": self.deadline_event,
            "started_at_ms": int(self.started_at * 1000),
            "stages": [
                {"node": n, "stage": s, "duration_ms": round(d, 3)}
                for n, s, d in self.stages
            ],
            "ledger": dict(self.ledger),
            "achieved_gbps": self.achieved_gbps,
            "roofline_fraction": self.roofline_fraction,
        }


class _Watch:
    """Mutable per-statement record the caller annotates after the run
    (rows, execution path) — only read if the statement turns out slow."""

    __slots__ = ("rows", "execution_path", "plan_cache_skip",
                 "deadline_event")

    def __init__(self):
        self.rows = 0
        self.execution_path = None
        self.plan_cache_skip = None
        self.deadline_event = None


#: the active watch, reachable from deep inside planning (the engine's
#: plan-cache skip annotation fires levels below execute_sql)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "gtpu_slow_query_watch", default=None)


def annotate(**attrs) -> None:
    """Set fields on the current statement's watch (no-op outside one)."""
    w = _current.get()
    if w is None:
        return
    for k, v in attrs.items():
        if k in _Watch.__slots__:
            setattr(w, k, v)


@contextlib.contextmanager
def watch(kind: str, query: str, db: str = "public"):
    """Time the enclosed statement; record it if it crosses the
    threshold. Nested watches (TQL inside SQL) are no-ops. Records even
    when the statement RAISES — a slow failure is still a slow query."""
    thr = threshold_ms()
    if _active.get() or thr <= 0:
        yield _Watch()
        return
    token = _active.set(True)
    w = _Watch()
    w_token = _current.set(w)
    # entry points that bypass the SQL engine (direct PromQL HTTP) have
    # no trace yet — mint one so the record, the spans, and the log
    # lines of this evaluation still join on an id
    prev_tid = tracing.current_trace_id()
    if prev_tid is None:
        tracing.set_trace(None)
    started = time.time()
    t0 = time.perf_counter()
    try:
        # the statement's resource-ledger slice: attach one if the
        # server didn't (direct engine callers), and diff around the
        # run so multi-statement requests attribute per statement
        with ledger.attach() as led:
            led0 = led.snapshot() if led is not None else {}
            with tracing.collect_spans() as sink:
                yield w
    finally:
        _active.reset(token)
        _current.reset(w_token)
        dur_ms = (time.perf_counter() - t0) * 1000.0
        if dur_ms >= thr:
            led_slice = ledger.diff(led0, led.snapshot()) \
                if led is not None else {}
            _record(kind, query, db, dur_ms, thr, w, started, sink,
                    led_slice)
        if prev_tid is None:
            tracing.restore_trace(None)


def _record(kind, query, db, dur_ms, thr, w, started, sink,
            led_slice=None) -> None:
    rec = SlowQuery(
        trace_id=tracing.current_trace_id() or "-",
        kind=kind, query=query[:4096], db=db,
        duration_ms=dur_ms, threshold_ms=thr, rows=w.rows,
        execution_path=w.execution_path,
        plan_cache_skip=w.plan_cache_skip,
        deadline_event=w.deadline_event, started_at=started,
        stages=[(s.node or "local", s.name, s.duration_ms) for s in sink],
        ledger=led_slice or {},
    )
    if led_slice:
        from greptimedb_tpu_torch.utils import roofline

        rf = roofline.account(led_slice, duration_ms=dur_ms)
        if rf is not None:
            rec.achieved_gbps = round(rf["achieved_gbps"], 6)
            rec.roofline_fraction = round(rf["roofline_fraction"], 9)
    with _lock:
        _ring.append(rec)
    SLOW_QUERIES.inc(kind=kind)
    # tail-based keep: a slow (or slow-failing) statement's trace is
    # worth exporting even when head sampling passed on it
    from greptimedb_tpu_torch.utils import otlp_trace

    otlp_trace.mark_keep(rec.trace_id if rec.trace_id != "-" else "")
    import logging

    # log a bounded prefix: a multi-thousand-row INSERT VALUES is tens
    # of KB — the full statement lives in the ring (information_schema.
    # slow_queries), the log line only needs enough to identify it
    logging.getLogger("greptimedb_tpu_torch.slow_query").warning(
        "slow query (%.1f ms >= %.0f ms) kind=%s rows=%d path=%s: %s",
        dur_ms, thr, kind, rec.rows, rec.execution_path,
        rec.query[:400] + ("..." if len(rec.query) > 400 else ""))


def records(n: Optional[int] = None) -> list[SlowQuery]:
    """Newest-first slice of the ring."""
    with _lock:
        out = list(_ring)
    out.reverse()
    return out[:n] if n is not None else out


def clear() -> None:
    with _lock:
        _ring.clear()
