"""Admission control + per-tenant weighted fair scheduling (copy of
greptimedb_tpu/concurrency/admission.py; a queued wait also feeds the
request's resource ledger as admission_wait_ms).

A bounded queue in front of statement execution (the reference frontend
bounds its runtime the same way): at most `max_concurrency` statements
execute at once; excess callers wait in per-tenant FIFO queues drained
by weighted round-robin, so a flooding tenant's backlog cannot starve a
light tenant — the light tenant's next query is served after at most
one full WRR turn, not after the flood drains. A full queue or an
expired wait raises the typed `Overloaded` (an `Unavailable` subclass:
HTTP maps it to 503, MySQL to 1040, and the cluster retry machinery
already treats it as a terminal degradation signal) instead of letting
unbounded pile-up take the process down.

Re-entrant by thread: nested statements (views, CTEs, EXPLAIN ANALYZE,
flow ticks inside an admitted statement) pass through on the slot their
top-level statement already holds — an inner acquire would deadlock
against a full house.

Uncontended fast path: execution slots are a token pool
(`_tokens`), and when nobody is queued an acquire is one GIL-atomic
`list.pop` + a sharded-counter inc — no lock, no condition round-trip.
The slow path (waiters exist, or the pool is empty) keeps the classic
lock + per-tenant WRR queues. The lost-wakeup race between a lock-free
release and a concurrent enqueue is closed from both sides: release
re-checks the queue AFTER returning its token (and rescues under the
lock), and a waiter re-checks the pool AFTER enqueuing — under the
GIL's total order one of the two always observes the other.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager

from greptimedb_tpu_torch.fault import Unavailable
from greptimedb_tpu_torch.utils import deadline as dl
from greptimedb_tpu_torch.utils import ledger
from greptimedb_tpu_torch.utils.metrics import (
    ADMISSION_EVENTS,
    ADMISSION_QUEUE_DEPTH,
    ADMISSION_WAIT_SECONDS,
)


class Overloaded(Unavailable):
    """Typed admission rejection: the server is saturated; back off and
    retry, don't stack-trace."""


class _Waiter:
    __slots__ = ("event", "granted", "tenant")

    def __init__(self, tenant: str):
        self.event = threading.Event()
        self.granted = False
        self.tenant = tenant


def parse_weights(spec: str) -> dict[str, int]:
    """"tenantA=3,tenantB=1" -> {...}; unlisted tenants weigh 1."""
    out: dict[str, int] = {}
    for entry in (spec or "").split(","):
        name, sep, w = entry.partition("=")
        if not sep or not name.strip():
            continue
        try:
            out[name.strip()] = max(1, int(w))
        except ValueError:
            continue
    return out


class AdmissionController:
    def __init__(self, max_concurrency: int, queue_size: int = 256,
                 queue_timeout_s: float = 30.0,
                 weights: dict[str, int] | None = None,
                 enabled: bool = True):
        self.max_concurrency = max(1, int(max_concurrency))
        self.queue_size = max(0, int(queue_size))
        self.queue_timeout_s = float(queue_timeout_s)
        self.weights = dict(weights or {})
        self.enabled = enabled
        self._lock = threading.Lock()
        # free execution slots; invariant: active = max_concurrency -
        # len(_tokens) (a direct waiter handoff transfers a slot without
        # touching the pool, keeping both sides constant)
        self._tokens: list = [None] * self.max_concurrency
        self._queued = 0
        self._queues: dict[str, deque] = {}
        self._ring: list[str] = []
        self._credits: dict[str, int] = {}
        self._idx = 0
        self._tls = threading.local()

    # ---- public ------------------------------------------------------------

    @property
    def active(self) -> int:
        return self.max_concurrency - len(self._tokens)

    @property
    def queued(self) -> int:
        return self._queued

    def depth(self) -> int:
        """This thread's statement nesting depth (1 = top level)."""
        return getattr(self._tls, "depth", 0)

    @contextmanager
    def slot(self, tenant: str):
        d = getattr(self._tls, "depth", 0)
        self._tls.depth = d + 1
        try:
            if d > 0 or not self.enabled:
                yield
                return
            self._acquire(tenant or "default")
            try:
                yield
            finally:
                self._release()
        finally:
            self._tls.depth = d

    # ---- internals ---------------------------------------------------------

    def _weight(self, tenant: str) -> int:
        return self.weights.get(tenant, 1)

    def _acquire(self, tenant: str) -> None:
        # fast path: atomic slot grab when nobody is queued. The
        # _queued read is racy, but a request that slips past a
        # concurrently-enqueuing waiter grabbed a token that waiter
        # could not have been handed yet — fairness drift of at most
        # one request, never a lost slot.
        if self._queued == 0:
            try:
                self._tokens.pop()
            except IndexError:
                pass
            else:
                ADMISSION_EVENTS.inc(event="admit")
                return
        with self._lock:
            if self._queued == 0 and self._tokens:
                self._tokens.pop()
                ADMISSION_EVENTS.inc(event="admit")
                return
            if self._queued >= self.queue_size:
                ADMISSION_EVENTS.inc(event="reject_full", tenant=tenant)
                raise Overloaded(
                    f"admission queue full ({self._queued} waiting, "
                    f"{self.active} executing)")
            w = _Waiter(tenant)
            q = self._queues.get(tenant)
            if q is None:
                q = deque()
                self._queues[tenant] = q
                self._ring.append(tenant)
                self._credits.setdefault(tenant, self._weight(tenant))
            q.append(w)
            self._queued += 1
            ADMISSION_QUEUE_DEPTH.set(float(self._queued))
            ADMISSION_EVENTS.inc(event="queue", tenant=tenant)
        # close the lock-free release race: a token appended between our
        # fast-path check and the enqueue above would strand this waiter
        # until timeout — re-check the pool now that we are visible in
        # _queued (one of the two sides always sees the other)
        if self._tokens:
            self._rescue()
        t0 = time.perf_counter()
        try:
            # deadline/cancel-aware wait: a killed or expired query
            # leaves the queue typed instead of burning queue_timeout_s
            granted = dl.wait_event(w.event, self.queue_timeout_s,
                                    where="admission queue")
        except Unavailable:
            waited = time.perf_counter() - t0
            ADMISSION_WAIT_SECONDS.observe(waited)
            ledger.add("admission_wait_ms", waited * 1000.0)
            with self._lock:
                granted_in_race = w.granted
                if not granted_in_race:
                    q = self._queues.get(tenant)
                    if q is not None:
                        try:
                            q.remove(w)
                            self._queued -= 1
                            ADMISSION_QUEUE_DEPTH.set(float(self._queued))
                        except ValueError:
                            granted_in_race = w.granted
            if granted_in_race:
                # a slot was handed over in the race window: give it
                # back so the typed unwind cannot leak admission
                self._release()
            ADMISSION_EVENTS.inc(event="deadline", tenant=tenant)
            raise
        waited = time.perf_counter() - t0
        ADMISSION_WAIT_SECONDS.observe(waited)
        ledger.add("admission_wait_ms", waited * 1000.0)
        if granted:
            return
        with self._lock:
            if w.granted:  # granted in the race window after timeout
                return
            q = self._queues.get(tenant)
            if q is not None:
                try:
                    q.remove(w)
                    self._queued -= 1
                    ADMISSION_QUEUE_DEPTH.set(float(self._queued))
                except ValueError:
                    pass
        ADMISSION_EVENTS.inc(event="reject_timeout", tenant=tenant)
        raise Overloaded(
            f"query waited longer than {self.queue_timeout_s:g}s for "
            "admission")

    def _release(self) -> None:
        if self._queued:
            with self._lock:
                w = self._next_waiter()
                if w is not None:
                    # hand the slot over directly: the token pool is
                    # untouched, so `active` stays constant
                    w.granted = True
                    self._queued -= 1
                    ADMISSION_QUEUE_DEPTH.set(float(self._queued))
                    ADMISSION_EVENTS.inc(event="admit")
                    w.event.set()
                    return
        # nobody visibly queued: return the token lock-free, then
        # re-check — a waiter that enqueued between the read above and
        # the append is rescued under the lock instead of timing out
        self._tokens.append(None)
        if self._queued:
            self._rescue()

    def _rescue(self) -> None:
        """Match free tokens to queued waiters under the lock. Both
        lock-free halves (release's token append, a fresh waiter's
        enqueue) call this after publishing their side, which closes
        the lost-wakeup window in every interleaving."""
        with self._lock:
            while self._queued and self._tokens:
                w = self._next_waiter()
                if w is None:
                    break
                self._tokens.pop()
                w.granted = True
                self._queued -= 1
                ADMISSION_QUEUE_DEPTH.set(float(self._queued))
                ADMISSION_EVENTS.inc(event="admit")
                w.event.set()

    def _next_waiter(self):
        """Weighted round-robin pop (caller holds the lock): serve up to
        `weight` consecutive waiters per tenant before yielding the
        turn; tenants with drained queues leave the ring."""
        steps = 0
        while self._ring and steps <= 2 * len(self._ring) + 1:
            pos = self._idx % len(self._ring)
            t = self._ring[pos]
            q = self._queues.get(t)
            if not q:
                self._ring.pop(pos)
                self._queues.pop(t, None)
                self._credits.pop(t, None)
                continue
            if self._credits.get(t, 0) > 0:
                self._credits[t] -= 1
                w = q.popleft()
                if not q:
                    self._ring.pop(pos)
                    self._queues.pop(t, None)
                    self._credits.pop(t, None)
                return w
            self._credits[t] = self._weight(t)
            self._idx += 1
            steps += 1
        return None
