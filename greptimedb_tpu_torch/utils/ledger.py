"""Per-query resource ledger: one request-scoped accumulator every
subsystem feeds, answering "where did THIS query's time and bytes go".

The metrics registry aggregates across requests; the span ring shows
wall time per stage — neither attributes *resources* (cache hits, H2D
bytes, rows folded, admission wait) to one statement. The ledger closes
that gap: servers (or the engine, for direct callers) attach one per
request, the seams that already count global metrics also feed the
active ledger, and the result is stamped onto the root span, the
slow-query record, and EXPLAIN ANALYZE.

Feeds (same call sites as the global counters, so the two surfaces can
never drift):

- caches: plan cache, fast lane, scan part cache, partial-aggregate
  cache, device hot set — per-cache hit/miss/... under ``cache.<name>.<event>``
- admission: wait seconds (``admission_wait_ms``)
- scan: rows scanned and host bytes decoded (fed from scan spans /
  the decode seam, including scan-pool worker threads via
  `tracing.propagate`)
- device: H2D/D2H bytes (the device_telemetry seams), host-vs-device
  aggregation milliseconds (fed from span completion)

`GTPU_TRACING=off` disables the ledger together with span recording —
the observability plane A/Bs as one unit (the bench's overhead gate).

Copy of greptimedb_tpu/utils/ledger.py. On the card `device_ms` is the
wall time of the `device_agg` span, which closes after the result's
pull to the host (`query/physical.py::_to_host`): that copy waits for
the kernels, so the span covers them without any added synchronize.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from typing import Optional

_current: contextvars.ContextVar[Optional["Ledger"]] = \
    contextvars.ContextVar("gtpu_ledger", default=None)

#: span name -> ledger key for duration feeds. `agg_ms` is the whole
#: aggregation wall (host + device); `device_ms` the device-kernel
#: portion nested inside it — `host_ms` is DERIVED as their difference
#: at export time (a nested span must not double-count)
_SPAN_MS_KEYS = {
    "device_agg": "device_ms",
    "vmapped_fragments": "device_ms",
    "aggregate": "agg_ms",
    "range_agg": "agg_ms",
}


def enabled() -> bool:
    """The GTPU_TRACING master switch — the CANONICAL parse for the
    whole observability plane (tracing.enabled delegates here; tracing
    imports ledger, never the reverse), so spans and the ledger always
    agree on what "off" means."""
    return os.environ.get("GTPU_TRACING", "").lower() not in (
        "off", "0", "false", "no")


class Ledger:
    """Thread-safe numeric accumulator. Adds happen on request threads
    AND pool workers (scan decode, region RPC fan-out) that inherited
    the contextvar via `tracing.propagate` — hence the lock (adds are
    per-part/per-event, not per-row; contention is negligible)."""

    __slots__ = ("_data", "_lock")

    def __init__(self):
        self._data: dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, key: str, value: float = 1.0) -> None:
        with self._lock:
            self._data[key] = self._data.get(key, 0.0) + value

    def note_span(self, span) -> None:
        """Span-completion feed (called by tracing._record): scan rows
        and the host-vs-device time split fall out of spans that already
        exist — no extra instrumentation at those sites. Piggybacked
        remote copies (node set) are skipped: the frontend's own scan
        span already covers the distributed gather, and counting the
        merged datanode span too would double every row."""
        if span.node is not None:
            return
        key = _SPAN_MS_KEYS.get(span.name)
        if key is not None:
            self.add(key, span.duration_ms)
        if span.name in ("scan", "region_scan"):
            rows = span.attrs.get("rows")
            if isinstance(rows, (int, float)):
                self.add("rows_scanned", float(rows))

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._data)

    def to_dict(self) -> dict[str, float]:
        d = derive(self.snapshot())
        return {k: round(v, 3) for k, v in sorted(d.items())}

    def summary(self) -> str:
        """Compact ``k=v`` rendering for span attrs and log lines."""
        return format_dict(derive(self.snapshot()))


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else f"{v:.3f}"


def format_dict(d: dict) -> str:
    """Compact ``k=v`` line for a ledger slice (span attrs, ANALYZE)."""
    return " ".join(f"{k}={_fmt(v)}" for k, v in sorted(d.items()))


def derive(d: dict) -> dict:
    """Derived fields over raw counters: the host share of aggregation
    time is agg_ms minus the device-kernel spans nested inside it."""
    agg = d.get("agg_ms")
    if agg is not None:
        host = agg - d.get("device_ms", 0.0)
        if host > 0:
            d = dict(d)
            d["host_ms"] = round(host, 3)
    return d


def diff(before: dict, after: dict) -> dict[str, float]:
    """after - before, dropping zero deltas — the per-statement slice of
    a request-scoped ledger (multi-statement requests share one).
    Derived fields are computed over the slice."""
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0.0)
        if d:
            out[k] = round(d, 3)
    return derive(out)


def active() -> Optional[Ledger]:
    return _current.get()


def add(key: str, value: float = 1.0) -> None:
    """Feed the active ledger (no-op outside a request)."""
    led = _current.get()
    if led is not None:
        led.add(key, value)


def cache_event(cache: str, event: str, n: float = 1.0) -> None:
    """Per-cache attribution (``cache.<name>.<event>``) — called next to
    the global *_EVENTS counter incs so the surfaces cannot drift."""
    led = _current.get()
    if led is not None:
        led.add(f"cache.{cache}.{event}", n)


@contextlib.contextmanager
def attach():
    """Install a fresh ledger unless the context already carries one
    (nested statements — views, TQL-inside-SQL, EXPLAIN's inner run —
    accumulate into their request's ledger). Yields the active ledger,
    or None when the observability plane is off."""
    led = _current.get()
    if led is not None or not enabled():
        yield led
        return
    led = Ledger()
    token = _current.set(led)
    try:
        yield led
    finally:
        _current.reset(token)


@contextlib.contextmanager
def attach_fresh():
    """Force a new ledger (EXPLAIN ANALYZE: the report must cover the
    inner statement alone, not the whole connection's request)."""
    if not enabled():
        yield None
        return
    led = Ledger()
    token = _current.set(led)
    try:
        yield led
    finally:
        _current.reset(token)
