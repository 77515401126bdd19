"""OTLP/HTTP trace export: completed spans leave the process.

The span ring (utils/tracing.py) answers "what happened recently on
THIS node"; fleet operators want the same trees in their tracing
backend (Jaeger/Tempo/anything OTLP). A bounded-queue background
exporter drains completed spans into OTLP/HTTP **JSON**
(`/v1/traces` ExportTraceServiceRequest) — no protobuf dependency, and
the payload function is pure, so the golden-payload test pins it.

Sampling is two-sided:

- **head**: a deterministic per-trace hash against `sample_ratio`
  decides at record time whether a trace's spans enter the queue;
- **tail keep**: spans from unsampled traces park in a bounded
  lookback ring, and `mark_keep(trace_id)` — called by the slow-query
  log for every slow or failed statement — promotes them after the
  fact, so the traces worth keeping survive even at 1% head sampling.

Failure contract: the exporter must NEVER impact a query. Enqueue past
the bound drops (counted), a dead endpoint counts `failed` and moves
on (log-throttled), and the chaos point `otlp.export` injects exactly
that failure in tests. Health is observable at /metrics:
`otlp_trace_queue_depth` + `otlp_trace_spans_total{event=...}`.

Configuration: `[tracing]` options (options.apply_observability) write
the `GTPU_OTLP_*` env knobs this module reads via `maybe_install()` —
env-is-truth layering, so child processes inherit the operator's
endpoint and export their own spans too.

Copy of greptimedb_tpu/utils/otlp_trace.py. The payloads are the JAX
package's byte for byte (service and scope names included); the log
lane listens on the port's own logger namespace, and `shutdown()` (or
`configure(None)`) joins the exporter thread: no thread outlives its
server (HttpServer.stop() and `standalone start`'s exit call it).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.request
import zlib
from collections import OrderedDict, deque
from typing import Optional

from greptimedb_tpu_torch.utils.metrics import REGISTRY

OTLP_TRACE_SPANS = REGISTRY.counter(
    "greptimedb_tpu_otlp_trace_spans_total",
    "OTLP trace exporter span outcomes by event (exported = delivered, "
    "dropped = bounded queue was full, failed = endpoint error after "
    "the span was queued, kept = promoted from the unsampled lookback "
    "ring by a tail-based keep — slow/failed statements)")
OTLP_TRACE_QUEUE_DEPTH = REGISTRY.gauge(
    "greptimedb_tpu_otlp_trace_queue_depth",
    "Spans waiting in the bounded OTLP exporter queue")
OTLP_TRACE_EXPORTS = REGISTRY.counter(
    "greptimedb_tpu_otlp_trace_exports_total",
    "OTLP export batches by outcome (ok/error)")
OTLP_LOG_RECORDS = REGISTRY.counter(
    "greptimedb_tpu_otlp_log_records_total",
    "OTLP log exporter record outcomes by event (exported = delivered "
    "to /v1/logs, dropped = bounded queue was full, failed = endpoint "
    "error, throttled = over the per-second rate cap) — fault, "
    "slow-query, and degradation warnings ride the trace exporter's "
    "queue with trace_id correlation")

_log = logging.getLogger("greptimedb_tpu_torch.otlp_trace")

#: traces remembered as keep-worthy / recently-decided (bounded)
_KEEP_CAP = 512
_LOOKBACK_CAP = 2048


def _span_otlp(s) -> dict:
    """One tracing.Span -> OTLP JSON span."""
    start_ns = int(s.started_at * 1e9)
    out = {
        "traceId": (s.trace_id or "").rjust(32, "0"),
        "spanId": (s.span_id or "").rjust(16, "0"),
        "name": s.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(start_ns + int(s.duration_ms * 1e6)),
        "attributes": [
            {"key": str(k), "value": _attr_value(v)}
            for k, v in s.attrs.items()
        ],
    }
    if s.parent_id:
        out["parentSpanId"] = s.parent_id.rjust(16, "0")
    if s.node:
        out["attributes"].append(
            {"key": "gtpu.node", "value": {"stringValue": str(s.node)}})
    return out


def _attr_value(v) -> dict:
    if isinstance(v, bool):  # before int: bool subclasses int
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # proto3 JSON maps int64 to string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def payload(spans, service_name: str = "greptimedb_tpu",
            node: Optional[str] = None) -> dict:
    """ExportTraceServiceRequest JSON for one batch — pure, so the
    golden-payload test pins the wire shape without a live endpoint."""
    resource_attrs = [
        {"key": "service.name", "value": {"stringValue": service_name}},
    ]
    if node:
        resource_attrs.append(
            {"key": "service.instance.id", "value": {"stringValue": node}})
    return {
        "resourceSpans": [{
            "resource": {"attributes": resource_attrs},
            "scopeSpans": [{
                "scope": {"name": "greptimedb_tpu.tracing"},
                "spans": [_span_otlp(s) for s in spans],
            }],
        }],
    }


#: python logging levelno -> OTLP severityNumber (spec table)
_SEVERITY = ((logging.CRITICAL, 21, "FATAL"), (logging.ERROR, 17, "ERROR"),
             (logging.WARNING, 13, "WARN"), (logging.INFO, 9, "INFO"),
             (logging.DEBUG, 5, "DEBUG"))


def _severity(levelno: int):
    for floor, num, text in _SEVERITY:
        if levelno >= floor:
            return num, text
    return 1, "TRACE"


def log_payload(records, service_name: str = "greptimedb_tpu",
                node: Optional[str] = None) -> dict:
    """ExportLogsServiceRequest JSON for one batch of log-record dicts
    (see OtlpLogHandler.emit for the dict shape) — pure, golden-testable
    like payload()."""
    resource_attrs = [
        {"key": "service.name", "value": {"stringValue": service_name}},
    ]
    if node:
        resource_attrs.append(
            {"key": "service.instance.id", "value": {"stringValue": node}})
    out = []
    for r in records:
        num, text = _severity(int(r.get("levelno", logging.INFO)))
        rec = {
            "timeUnixNano": str(int(r.get("ts", 0.0) * 1e9)),
            "severityNumber": num,
            "severityText": text,
            "body": {"stringValue": str(r.get("body", ""))},
            "attributes": [
                {"key": "logger",
                 "value": {"stringValue": str(r.get("logger", ""))}},
            ],
        }
        # trace correlation: same 32-hex zero-pad as span export, so the
        # backend joins this record to the statement's exported tree
        tid = r.get("trace_id") or ""
        if tid:
            rec["traceId"] = tid.rjust(32, "0")
        out.append(rec)
    return {
        "resourceLogs": [{
            "resource": {"attributes": resource_attrs},
            "scopeLogs": [{
                "scope": {"name": "greptimedb_tpu.logging"},
                "logRecords": out,
            }],
        }],
    }


def _sampled(trace_id: str, ratio: float) -> bool:
    """Deterministic head sampling: the same trace decides the same way
    on every node (crc32 over the id, uniform in [0, 1))."""
    if ratio >= 1.0:
        return True
    if ratio <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 2**32 < ratio


class OtlpTraceExporter:
    """Bounded-queue background exporter. Thread starts lazily on the
    first enqueued span; `flush()` is for tests and shutdown."""

    def __init__(self, endpoint: str, sample_ratio: float = 1.0,
                 queue_size: int = 2048, batch: int = 256,
                 flush_interval_s: float = 2.0, timeout_s: float = 5.0,
                 node: Optional[str] = None):
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.endswith("/v1/traces"):
            self.endpoint += "/v1/traces"
        self.sample_ratio = float(sample_ratio)
        self.queue_size = int(queue_size)
        self.batch = int(batch)
        self.flush_interval_s = float(flush_interval_s)
        self.timeout_s = float(timeout_s)
        self.node = node or os.environ.get("GTPU_NODE_ID") or ""
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._busy = 0          # spans taken off the queue, not yet posted
        self._keep: "OrderedDict[str, bool]" = OrderedDict()
        self._lookback: deque = deque(maxlen=_LOOKBACK_CAP)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._fail_streak = 0
        # log lane: fault/slow-query/degradation records share this
        # exporter's worker + endpoint host, posted to /v1/logs
        self.log_endpoint = self.endpoint[:-len("/v1/traces")] + "/v1/logs"
        self._logq: deque = deque()
        self._log_rate = 20.0          # records/s token bucket
        self._log_tokens = self._log_rate
        self._log_refill = time.monotonic()
        self._log_fail_streak = 0

    # -- producer side (called from tracing._record; must never raise) -------

    def on_span(self, span) -> None:
        try:
            tid = span.trace_id
            if not tid:
                return  # background spans outside any request trace
            with self._cv:
                keep = tid in self._keep
            if keep or _sampled(tid, self.sample_ratio):
                self._enqueue([span])
            else:
                self._lookback.append(span)
        except Exception:  # noqa: BLE001 — telemetry must never hurt a query
            pass

    def mark_keep(self, trace_id: str) -> None:
        """Tail-based keep: promote an unsampled trace (the slow-query
        ring calls this for every slow or failed statement) — its parked
        spans enter the queue, and spans still being recorded follow."""
        if not trace_id:
            return
        try:
            with self._cv:
                already = trace_id in self._keep
                self._keep[trace_id] = True
                while len(self._keep) > _KEEP_CAP:
                    self._keep.popitem(last=False)
            if already or self.sample_ratio >= 1.0:
                return
            promoted = [s for s in list(self._lookback)
                        if s.trace_id == trace_id]
            if promoted:
                OTLP_TRACE_SPANS.inc(float(len(promoted)), event="kept")
                self._enqueue(promoted)
        except Exception:  # noqa: BLE001 — telemetry must never hurt a query
            pass

    def on_log(self, record: dict) -> None:
        """Enqueue one log-record dict (throttled, bounded, never
        raises) — the OtlpLogHandler's sink."""
        try:
            now = time.monotonic()
            with self._cv:
                # token bucket: a fault storm logging thousands of
                # warnings must not monopolize the export lane
                self._log_tokens = min(
                    self._log_rate,
                    self._log_tokens + (now - self._log_refill)
                    * self._log_rate)
                self._log_refill = now
                if self._log_tokens < 1.0:
                    OTLP_LOG_RECORDS.inc(event="throttled")
                    return
                self._log_tokens -= 1.0
                if len(self._logq) >= self.queue_size:
                    OTLP_LOG_RECORDS.inc(event="dropped")
                    return
                self._logq.append(record)
                if self._thread is None and not self._stop:
                    self._thread = threading.Thread(
                        target=self._run, name="gtpu-otlp-export",
                        daemon=True)
                    self._thread.start()
                self._cv.notify_all()
        except Exception:  # noqa: BLE001 — telemetry must never hurt a query
            pass

    def _enqueue(self, spans) -> None:
        with self._cv:
            for s in spans:
                if len(self._q) >= self.queue_size:
                    OTLP_TRACE_SPANS.inc(event="dropped")
                    continue
                self._q.append(s)
            OTLP_TRACE_QUEUE_DEPTH.set(float(len(self._q)))
            if self._thread is None and not self._stop:
                self._thread = threading.Thread(
                    target=self._run, name="gtpu-otlp-export", daemon=True)
                self._thread.start()
            self._cv.notify_all()

    # -- worker side ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                # idle: block untimed — producers notify on enqueue and
                # flush/shutdown notify too, so there is no 20 Hz
                # wakeup loop on a quiet node
                while not self._stop and not self._q and not self._logq:
                    self._cv.wait()
                if self._stop and not self._q and not self._logq:
                    return
                # batch-accumulation window: give a bursting producer
                # up to flush_interval_s to fill the batch
                deadline = time.monotonic() + self.flush_interval_s
                while not self._stop and len(self._q) < self.batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                chunk = [self._q.popleft()
                         for _ in range(min(self.batch, len(self._q)))]
                logs = [self._logq.popleft()
                        for _ in range(min(self.batch, len(self._logq)))]
                self._busy = len(chunk) + len(logs)
                OTLP_TRACE_QUEUE_DEPTH.set(float(len(self._q)))
            if chunk:
                self._post(chunk)
            if logs:
                self._post_logs(logs)
            with self._cv:
                self._busy = 0
                self._cv.notify_all()

    def _post(self, spans) -> None:
        from greptimedb_tpu_torch.fault import FAULTS

        try:
            # serialization INSIDE the guard: a surprise in one span's
            # attrs must count as a failed batch, never kill the worker
            # thread (it is the only one; _enqueue never respawns it)
            body = json.dumps(payload(spans, node=self.node)).encode()
            # chaos seam: the fault-injected-endpoint test arms this to
            # prove typed degradation (counted, logged, zero query
            # impact) without standing up a broken collector
            FAULTS.fire("otlp.export")
            req = urllib.request.Request(
                self.endpoint, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except Exception as e:  # noqa: BLE001 — export must degrade, not raise
            OTLP_TRACE_SPANS.inc(float(len(spans)), event="failed")
            OTLP_TRACE_EXPORTS.inc(event="error")
            self._fail_streak += 1
            if self._fail_streak == 1 or self._fail_streak % 100 == 0:
                _log.warning("OTLP trace export to %s failing (streak %d): %s",
                             self.endpoint, self._fail_streak, e)
            return
        self._fail_streak = 0
        OTLP_TRACE_SPANS.inc(float(len(spans)), event="exported")
        OTLP_TRACE_EXPORTS.inc(event="ok")

    def _post_logs(self, records) -> None:
        from greptimedb_tpu_torch.fault import FAULTS

        try:
            body = json.dumps(log_payload(records, node=self.node)).encode()
            # same chaos seam + typed-degradation contract as span
            # export: an armed otlp.export fault fails this batch too
            FAULTS.fire("otlp.export")
            req = urllib.request.Request(
                self.log_endpoint, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except Exception as e:  # noqa: BLE001 — export must degrade, not raise
            OTLP_LOG_RECORDS.inc(float(len(records)), event="failed")
            self._log_fail_streak += 1
            if self._log_fail_streak == 1 or self._log_fail_streak % 100 == 0:
                _log.warning("OTLP log export to %s failing (streak %d): %s",
                             self.log_endpoint, self._log_fail_streak, e)
            return
        self._log_fail_streak = 0
        OTLP_LOG_RECORDS.inc(float(len(records)), event="exported")

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until both queues drain (tests / shutdown)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            self._cv.notify_all()
            while self._q or self._logq or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.1))
        return True

    def shutdown(self, timeout_s: float = 2.0) -> None:
        """Drain (up to `timeout_s`), stop and join the worker: a post
        in flight ends within the request timeout, so the join is
        bounded by it."""
        self.flush(timeout_s)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join()

    def depth(self) -> int:
        with self._cv:
            return len(self._q)


class OtlpLogHandler(logging.Handler):
    """logging.Handler that ships warning+ records from the repo's own
    loggers (fault injections, slow queries, degradations) through the
    exporter's queue as OTLP logs — trace-correlated via the current
    trace id, throttled by the exporter's token bucket, and never
    raising (the logging contract and the telemetry contract agree)."""

    #: never re-export the exporter's own failure warnings: a dead
    #: collector would otherwise feed its own error log back into the
    #: queue it cannot drain
    _SKIP = ("greptimedb_tpu_torch.otlp_trace",)

    def __init__(self, exporter: "OtlpTraceExporter"):
        super().__init__(level=logging.WARNING)
        self._exporter = exporter

    def emit(self, record: logging.LogRecord) -> None:
        try:
            if record.name in self._SKIP:
                return
            tid = getattr(record, "trace_id", None)
            if not tid or tid == "-":
                from greptimedb_tpu_torch.utils import tracing
                tid = tracing.current_trace_id() or ""
            self._exporter.on_log({
                "ts": record.created,
                "levelno": record.levelno,
                "logger": record.name,
                "body": record.getMessage(),
                "trace_id": tid,
            })
        except Exception:  # noqa: BLE001 — logging must never raise
            pass


# ---- module-level wiring ----------------------------------------------------

_EXPORTER: Optional[OtlpTraceExporter] = None
_LOG_HANDLER: Optional[OtlpLogHandler] = None
_install_lock = threading.Lock()


def exporter() -> Optional[OtlpTraceExporter]:
    return _EXPORTER


def configure(endpoint: Optional[str], **kwargs) -> Optional[OtlpTraceExporter]:
    """Install (endpoint set) or tear down (empty/None) the process
    exporter and hand it to tracing's span-completion hook."""
    global _EXPORTER, _LOG_HANDLER
    from greptimedb_tpu_torch.utils import tracing

    with _install_lock:
        old, _EXPORTER = _EXPORTER, None
        tracing._exporter = None
        repo_logger = logging.getLogger("greptimedb_tpu_torch")
        if _LOG_HANDLER is not None:
            repo_logger.removeHandler(_LOG_HANDLER)
            _LOG_HANDLER = None
        if old is not None:
            old.shutdown()
        if endpoint:
            _EXPORTER = OtlpTraceExporter(endpoint, **kwargs)
            tracing._exporter = _EXPORTER
            # log lane rides the same exporter: fault/slow-query/
            # degradation warnings under the repo's logger namespace
            # (gate: GTPU_OTLP_LOGS=off opts out)
            if os.environ.get("GTPU_OTLP_LOGS", "1").strip().lower() \
                    not in ("off", "0", "false", "no"):
                _LOG_HANDLER = OtlpLogHandler(_EXPORTER)
                repo_logger.addHandler(_LOG_HANDLER)
        return _EXPORTER


def maybe_install() -> Optional[OtlpTraceExporter]:
    """Env-driven install (GTPU_OTLP_ENDPOINT + GTPU_OTLP_* knobs) —
    idempotent; called by apply_observability and datanode bootstrap so
    every process in a cluster exports under one configuration. Any
    changed knob (not just the endpoint) reinstalls the exporter."""
    endpoint = os.environ.get("GTPU_OTLP_ENDPOINT", "")
    cur = _EXPORTER
    if not endpoint:
        if cur is not None:
            configure(None)
        return None

    def _f(name, default):
        try:
            return float(os.environ.get(name, default))
        except ValueError:
            return default

    cfg = (endpoint.rstrip("/"),
           _f("GTPU_OTLP_SAMPLE_RATIO", 1.0),
           int(_f("GTPU_OTLP_QUEUE", 2048)),
           _f("GTPU_OTLP_FLUSH_S", 2.0),
           os.environ.get("GTPU_OTLP_LOGS", "1"))
    if cur is not None and getattr(cur, "_env_cfg", None) == cfg:
        return cur
    exp = configure(cfg[0], sample_ratio=cfg[1], queue_size=cfg[2],
                    flush_interval_s=cfg[3])
    if exp is not None:
        exp._env_cfg = cfg
    return exp


def shutdown() -> None:
    """Stop and join the process exporter (a no-op when none runs)."""
    if _EXPORTER is not None:
        configure(None)


def mark_keep(trace_id: str) -> None:
    """Module-level tail-keep hook (slow_query imports this lazily)."""
    exp = _EXPORTER
    if exp is not None:
        exp.mark_keep(trace_id)
