"""Trace context + hierarchical spans (mirrors reference common/telemetry
tracing: `TracingContext::to_w3c` rides region requests across process
hops, query/src/dist_plan/merge_scan.rs:185-201, re-attached server-side
at servers/src/grpc/region_server.rs:74).

A request's trace id lives in a contextvar; spans carry a `span_id` and
a `parent_id` maintained by a contextvar parent stack inside `span()`,
so EXPLAIN ANALYZE / TQL ANALYZE and `/v1/traces/<id>` render true
nested trees with per-span self-time. The wire protocols speak W3C
trace context: HTTP accepts and emits a `traceparent` header,
MySQL/Postgres accept one in a leading SQL comment, and the Flight
piggyback ships parent linkage both ways — a datanode's `region_scan`
span re-parents under the frontend span that sent the RPC, so one
tree covers every process the query touched.

The span ring is indexed by trace id (bounded dict-of-lists evicted
with the ring) so `spans_for`/`merge_spans` on a busy frontend never
walk thousands of foreign spans. Completed spans also feed the OTLP
exporter (utils/otlp_trace.py) and the per-query resource ledger
(utils/ledger.py) when either is active. `GTPU_TRACING=off` turns span
recording (and the ledger) into a no-op for A/B overhead runs.

Logs join the same id: `TraceIdFilter` stamps every log record with the
current trace id (`trace_id=<id>`), so logs, metrics, and spans
correlate on one key — and histogram exemplars (utils/metrics.py) close
the metrics→trace direction.

Copy of greptimedb_tpu/utils/tracing.py. The port's threads that work
for a request (the stream's prefetch producer, the encode pool, the
write workers) run their work under `propagate`, so their spans and
ledger adds land on the request's trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.utils import flame as _flame
from greptimedb_tpu_torch.utils import ledger, roofline

_current: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "gtpu_trace_id", default=None)

#: innermost open span's id — the parent of the next span opened in this
#: context (and the span id a traceparent/Flight request propagates)
_parent: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "gtpu_span_parent", default=None)

#: request-scoped span sink (see collect_spans): lets a server handler
#: capture exactly the spans ITS request produced, concurrency-safe,
#: without diffing the shared ring
_collector: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "gtpu_span_collector", default=None)

_RING_CAP = 4096
_SPANS: deque = deque()
#: trace_id -> spans, evicted in lockstep with the ring: spans_for is
#: one dict lookup instead of an O(ring) scan over foreign spans
_BY_TRACE: dict[str, list] = {}
_ring_lock = threading.Lock()

#: OTLP exporter hook — otlp_trace.configure() installs the live
#: exporter here (attribute handoff, no import cycle); None = disabled
_exporter = None


def enabled() -> bool:
    """Span recording master switch (GTPU_TRACING). The single env
    parse lives in ledger.enabled() — tracing imports ledger, never the
    other way — so the two halves of the observability plane can never
    drift apart on what "off" means. Trace-ID minting/propagation stays
    on either way — log correlation is too cheap to gate."""
    return ledger.enabled()


@dataclass
class Span:
    trace_id: Optional[str]
    name: str
    duration_ms: float
    started_at: float
    attrs: dict = field(default_factory=dict)
    #: source process for piggybacked remote spans (None = this process)
    node: Optional[str] = None
    #: 16-hex span identity + parent linkage (None = a root span)
    span_id: str = ""
    parent_id: Optional[str] = None


def new_trace_id() -> str:
    # os.urandom(8).hex() is ~3x cheaper than uuid4 and ids are minted
    # per request AND per span — this is hot-path cost (the <3% bench
    # overhead budget)
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def set_trace(trace_id: Optional[str] = None) -> str:
    """Install (or adopt) a trace id for the current context."""
    tid = trace_id or new_trace_id()
    _current.set(tid)
    return tid


def current_trace_id() -> Optional[str]:
    return _current.get()


def current_span_id() -> Optional[str]:
    """The innermost open span's id (what an outgoing RPC propagates as
    the remote side's parent)."""
    return _parent.get()


def restore_trace(trace_id: Optional[str]) -> None:
    """Put back a previously-saved id verbatim (None clears — unlike
    set_trace, which would mint a fresh id)."""
    _current.set(trace_id)


def _record(span: Span) -> None:
    sink = _collector.get()
    if sink is not None:
        sink.append(span)
    with _ring_lock:
        _SPANS.append(span)
        if span.trace_id:
            _BY_TRACE.setdefault(span.trace_id, []).append(span)
        while len(_SPANS) > _RING_CAP:
            old = _SPANS.popleft()
            if old.trace_id:
                lst = _BY_TRACE.get(old.trace_id)
                if lst is not None:
                    try:
                        lst.remove(old)
                    except ValueError:
                        pass
                    if not lst:
                        del _BY_TRACE[old.trace_id]
    led = ledger.active()
    if led is not None:
        led.note_span(span)
    exp = _exporter
    # merged remote copies (node set) are NOT re-exported: the peer that
    # recorded them exports its own spans under the same ids — the
    # frontend re-exporting would duplicate every datanode span at the
    # collector (head sampling decides identically on both sides)
    if exp is not None and span.node is None:
        exp.on_span(span)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record a timed span nested under the innermost open one. Yields
    the (mutable) attrs dict so the body can attach result stats it only
    knows at the end (rows, bytes, pruning counts) — they land on the
    recorded span."""
    # the continuous profiler's stage attribution rides span entry/exit
    # (a thread-id-keyed registry the sampler thread can read — the
    # contextvar stack is invisible cross-thread); guarded by flame's
    # fast flag so the cost with profiling off is one attribute read,
    # and kept alive even with GTPU_TRACING=off so flames stay staged
    # during tracing A/B runs
    prof = _flame._ENABLED
    if prof:
        _flame.push_stage(name)
    try:
        if not enabled():
            yield attrs
            return
        sid = new_span_id()
        parent = _parent.get()
        token = _parent.set(sid)
        t0 = time.perf_counter()
        started = time.time()
        try:
            yield attrs
        finally:
            _parent.reset(token)
            _record(Span(_current.get(), name,
                         (time.perf_counter() - t0) * 1000.0,
                         started, attrs, span_id=sid, parent_id=parent))
    finally:
        if prof:
            _flame.pop_stage()


@contextlib.contextmanager
def request_span(name: str, traceparent: Optional[str] = None, **attrs):
    """Wire-ingress scaffold: adopt the caller's W3C trace context (or
    mint a fresh trace), open the request's root span, and attach the
    resource ledger — then restore the connection thread's previous
    context so keep-alive reuse can't leak one request's trace into the
    next. Every protocol front door (HTTP, MySQL, Postgres, Flight SQL)
    enters through here; the span_coverage lint checker enforces it."""
    parsed = parse_traceparent(traceparent) if traceparent else None
    tid, remote_parent = parsed if parsed else (new_trace_id(), None)
    tok_tid = _current.set(tid)
    tok_par = _parent.set(remote_parent)
    try:
        with ledger.attach() as led:
            with span(name, **attrs) as a:
                try:
                    yield a
                finally:
                    # stamp INSIDE the span block: the span is recorded
                    # (and handed to the OTLP exporter) at __exit__, so
                    # a later mutation would race the export serializer
                    # and leave the exported copy ledger-less
                    if led is not None:
                        counts = ledger.derive(led.snapshot())
                        if counts:
                            a["ledger"] = ledger.format_dict(counts)
                            # roofline fold on the request root: same
                            # ledger dict, so the stamped numbers agree
                            # with the byte counts by construction
                            roofline.stamp(a, counts)
    finally:
        _parent.reset(tok_par)
        _current.reset(tok_tid)


@contextlib.contextmanager
def adopt_remote(trace_id: Optional[str], parent_id: Optional[str] = None):
    """Server side of a cross-process hop (region_server.rs:74 analog):
    adopt the caller's trace AND parent span so spans recorded inside
    re-parent under the frontend span that sent the RPC. Restores the
    worker thread's previous context on exit."""
    tok_tid = _current.set(trace_id or _current.get())
    tok_par = _parent.set(parent_id)
    try:
        yield
    finally:
        _parent.reset(tok_par)
        _current.reset(tok_tid)


@contextlib.contextmanager
def collect_spans():
    """Yield a list that receives every span recorded in this context
    (on top of the shared ring). Used by the Flight region service to
    piggyback exactly ITS request's spans on the response, and by the
    slow-query log to capture a statement's per-stage breakdown. Nesting
    installs the innermost sink only — the outer one resumes on exit."""
    sink: list[Span] = []
    token = _collector.set(sink)
    try:
        yield sink
    finally:
        _collector.reset(token)


def propagate(fn):
    """Carry the caller's trace id, open-span parent, span sink, AND
    resource ledger across a thread-pool boundary (contextvars don't
    cross threads): the returned wrapper re-installs all four around
    each invocation. The sink is appended from worker threads —
    list.append is atomic, so concurrent region RPCs interleave
    safely; the ledger takes its own lock."""
    tid = _current.get()
    parent = _parent.get()
    sink = _collector.get()
    led = ledger.active()

    def wrapper(*args, **kwargs):
        t1 = _current.set(tid)
        t2 = _collector.set(sink)
        t3 = _parent.set(parent)
        t4 = ledger._current.set(led)
        try:
            return fn(*args, **kwargs)
        finally:
            ledger._current.reset(t4)
            _parent.reset(t3)
            _collector.reset(t2)
            _current.reset(t1)
    return wrapper


# ---- W3C trace context ------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^(?P<ver>[0-9a-f]{2})-(?P<tid>[0-9a-f]{32})-"
    r"(?P<sid>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$")

#: leading-comment carrier for header-less wire protocols (MySQL/
#: Postgres text): /* traceparent='00-...-...-01' */ SELECT ...
_COMMENT_TP_RE = re.compile(
    r"/\*\s*traceparent\s*[=:]\s*'?"
    r"(?P<tp>[0-9a-f]{2}-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2})"
    r"'?\s*\*/", re.IGNORECASE)


def pad32(trace_id: str) -> str:
    """Our internal ids are 16 hex chars; W3C wants 32 — left-pad with
    zeros (an adopted 32-char id passes through unchanged)."""
    return trace_id.rjust(32, "0")


def parse_traceparent(header: str) -> Optional[tuple[str, Optional[str]]]:
    """(trace_id, parent_span_id) from a W3C `traceparent`, or None on
    anything malformed (a bad header must never fail the request). A
    zero-padded id we emitted earlier round-trips back to its internal
    16-char form."""
    m = _TRACEPARENT_RE.match((header or "").strip().lower())
    if not m or m.group("ver") == "ff":
        return None
    tid, sid = m.group("tid"), m.group("sid")
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    if tid.startswith("0" * 16):
        tid = tid[16:]
    return tid, sid


def to_traceparent(trace_id: Optional[str] = None,
                   span_id: Optional[str] = None) -> Optional[str]:
    """W3C header for the current (or given) context — what HTTP egress
    emits and what a client would hand the next hop."""
    tid = trace_id or _current.get()
    if not tid:
        return None
    sid = (span_id or _parent.get() or new_span_id()).rjust(16, "0")[-16:]
    return f"00-{pad32(tid)}-{sid}-01"


def traceparent_from_sql(sql: str) -> Optional[str]:
    """Extract a traceparent carried in a leading SQL comment (the
    MySQL/Postgres ingress carrier — those wires have no headers)."""
    m = _COMMENT_TP_RE.search(sql[:256])
    return m.group("tp") if m else None


# ---- cross-process piggyback ------------------------------------------------


def spans_to_wire(spans: list[Span]) -> list[dict]:
    """JSON-serializable span records for the Flight response metadata
    (the RecordBatchMetrics payload analog). span_id/parent_id ride
    along so the frontend's merged tree keeps the nesting."""
    return [
        {"name": s.name, "duration_ms": round(s.duration_ms, 4),
         "started_at": s.started_at, "attrs": _wire_attrs(s.attrs),
         "span_id": s.span_id, "parent_id": s.parent_id}
        for s in spans
    ]


def _wire_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        out[str(k)] = v if isinstance(v, (int, float, bool, str,
                                          type(None))) else str(v)
    return out


def merge_spans(wire: list[dict], node: Optional[str] = None,
                trace_id: Optional[str] = None) -> list[Span]:
    """Merge piggybacked remote spans into the local ring, tagged with
    their source node and attributed to the CURRENT trace (the remote
    process recorded them under the same propagated id; using the local
    id keeps them joined even if the peer was mid-rollout and dropped
    it). When the 'remote' service actually shares this process (the
    in-process wire-mode cluster), its handler already recorded the
    same spans into this ring — those piggybacked copies are skipped,
    not double-reported. Returns the merged spans."""
    tid = trace_id or _current.get()
    local = spans_for(tid) if tid else []
    existing_ids = {s.span_id for s in local if s.span_id}
    # legacy dedup key for peers that predate span ids
    existing = {(s.name, s.started_at, round(s.duration_ms, 4))
                for s in local}
    merged = []
    for w in wire:
        try:
            s = Span(tid, str(w["name"]), float(w["duration_ms"]),
                     float(w.get("started_at", 0.0)),
                     dict(w.get("attrs") or {}), node=node,
                     span_id=str(w.get("span_id") or ""),
                     parent_id=w.get("parent_id") or None)
        except (KeyError, TypeError, ValueError):
            continue  # a mangled record must not kill the query
        if s.span_id and s.span_id in existing_ids:
            continue
        if (s.name, s.started_at, s.duration_ms) in existing:
            continue
        _record(s)
        merged.append(s)
    return merged


def spans_for(trace_id: str) -> list[Span]:
    with _ring_lock:
        return list(_BY_TRACE.get(trace_id, ()))


def recent_spans(n: int = 100) -> list[Span]:
    with _ring_lock:
        return list(_SPANS)[-n:]


# ---- tree rendering ---------------------------------------------------------


def span_tree(spans: list[Span]) -> list[tuple[int, Span, float]]:
    """(depth, span, self_ms) rows in tree order. Children sort by start
    time under their parent; spans whose parent never landed in the ring
    (evicted, or a peer that predates linkage) surface as roots. Self
    time is the span's duration minus its direct children's — the
    'where did the 50 ms actually go' number."""
    by_id = {s.span_id: s for s in spans if s.span_id}
    children: dict[Optional[str], list[Span]] = {}
    roots: list[Span] = []
    for s in spans:
        if s.parent_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)
    roots.sort(key=lambda s: s.started_at)
    out: list[tuple[int, Span, float]] = []

    def walk(s: Span, depth: int, seen: set) -> None:
        if s.span_id and s.span_id in seen:
            return  # defensive: a mangled piggyback must not loop
        seen = seen | ({s.span_id} if s.span_id else set())
        kids = sorted(children.get(s.span_id, ()),
                      key=lambda c: c.started_at)
        # self = duration minus the WALL-CLOCK UNION of the children:
        # parallel children (scan-pool fan-out re-parents per-file
        # decode under one scan span) overlap, and a plain sum would
        # print negative self-time for exactly those spans
        covered = 0.0
        cur_lo = cur_hi = None
        for c in kids:
            lo, hi = c.started_at, c.started_at + c.duration_ms / 1000.0
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    covered += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            covered += cur_hi - cur_lo
        self_ms = max(s.duration_ms - covered * 1000.0, 0.0)
        out.append((depth, s, self_ms))
        for c in kids:
            walk(c, depth + 1, seen)

    for r in roots:
        walk(r, 0, set())
    return out


def render_tree(spans: list[Span], indent: str = "  ") -> list[str]:
    """Human lines for one trace's span tree (EXPLAIN ANALYZE,
    /v1/slow_queries rendering, tools/trace_dump.py). A `[node]` marker
    line precedes the first span of each remote process at its nesting
    depth, so cross-process hops stay visually attributable."""
    lines: list[str] = []
    rows = span_tree(spans)
    prev_node: Optional[str] = None
    for depth, s, self_ms in rows:
        pad = indent * (depth + 1)
        if s.node != prev_node and s.node is not None:
            lines.append(f"{pad}[{s.node}]")
        prev_node = s.node
        attrs = " ".join(f"{k}={v}" for k, v in s.attrs.items())
        has_kids = any(d == depth + 1 and p.parent_id == s.span_id
                       for d, p, _ in rows)
        self_part = f" (self {self_ms:.2f} ms)" if has_kids else ""
        lines.append(f"{pad}{s.name}: {s.duration_ms:.2f} ms{self_part}"
                     + (f" [{attrs}]" if attrs else ""))
    return lines


# ---- log correlation --------------------------------------------------------


class TraceIdFilter(logging.Filter):
    """Stamp every record with the context's trace id so log lines join
    metrics and spans on one key (reference: its tracing subscriber puts
    the trace id on every event)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.trace_id = _current.get() or "-"
        return True


#: format fragment including the trace id (used by install_trace_logging
#: and any service that builds its own handler)
TRACE_LOG_FORMAT = ("%(asctime)s %(levelname)s %(name)s "
                    "trace_id=%(trace_id)s %(message)s")


def install_trace_logging(level: Optional[int] = None) -> TraceIdFilter:
    """Attach a TraceIdFilter to the root logger's handlers (creating a
    basicConfig handler with TRACE_LOG_FORMAT if none exist yet) so every
    log record carries `trace_id=`. Idempotent."""
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(format=TRACE_LOG_FORMAT,
                            level=level if level is not None else logging.INFO)
    elif level is not None:
        root.setLevel(level)
    filt = None
    for h in root.handlers:
        existing = [f for f in h.filters if isinstance(f, TraceIdFilter)]
        if existing:
            filt = existing[0]
            continue
        filt = filt or TraceIdFilter()
        h.addFilter(filt)
    return filt or TraceIdFilter()
