"""Bounded result-encode pool: serving I/O off the engine threads (copy
of greptimedb_tpu/concurrency/encode_pool.py without the shared-memory
result arena, which comes with the serving fabric, ROADMAP.md A9-shm).

The 50-client qps bench is parse/JSON-bound on host threads: every
connection thread that just finished executing re-enters the GIL to
materialize Python row objects and JSON-encode them, convoying with the
threads still executing queries. The pool bounds that contention:

- the admission slot is released at *execute-done* (the engine holds it
  only inside `execute_sql`), so serialization never occupies an
  execution slot;
- at most `workers` serializations run at once — the other request
  threads park on a future (releasing the GIL) instead of thrashing it;
- the encoders themselves are columnar (servers/encode.py): numpy
  C-loop casts and a single C `json.dumps`, no per-value Python
  sanitization, and batched results share one materialization through
  their group `encode_memo`;
- process mode moves the serialization into spawn-mode worker processes
  for a true GIL escape. It is selected PER RESULT by measured size
  (`process_mode="auto"`, the default): results at or above
  `process_min_rows` rows pay the pickle round trip to escape the GIL,
  dashboard-sized results keep the thread pool (handoff to a process
  costs more than their serialization). `process_mode="on"` pins every
  offload to the process pool, `"off"` disables it — the A/B knob
  (GTPU_ENCODE_PROCESS_MODE).

Saturation degrades, never drops: when every worker is busy and the
queue is full, the request thread encodes inline (the pre-pool
behavior), counted as `encode_pool_events_total{event="inline"}`.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Optional

from greptimedb_tpu_torch.utils import deadline
from greptimedb_tpu_torch.utils import tracing
from greptimedb_tpu_torch.utils.metrics import (
    ENCODE_POOL_EVENTS,
    ENCODE_POOL_QUEUE_DEPTH,
    ENCODE_SECONDS,
)


def _auto_workers() -> int:
    import os

    return max(2, min(8, (os.cpu_count() or 4) // 2))


def _worker_watchdog(parent: int) -> None:
    import os
    import time

    while True:
        time.sleep(5.0)
        if os.getppid() != parent:
            # the serving process died without reclaiming us (SIGKILL:
            # shutdown() never ran, the call-queue read blocks forever):
            # an orphan worker must not outlive its server
            os._exit(0)


def _worker_init() -> None:
    import os

    t = threading.Thread(target=_worker_watchdog, args=(os.getppid(),),
                         daemon=True, name="gtpu-encode-watchdog")
    t.start()


class EncodePool:
    def __init__(self, workers: int = 0, queue_size: int = 64,
                 enabled: bool = True, min_rows: int = 256,
                 process_mode: str = "auto",
                 process_min_rows: int = 100_000):
        self.workers = workers if workers > 0 else _auto_workers()
        self.queue_size = max(1, int(queue_size))
        process_mode = str(process_mode).strip().lower()
        if process_mode not in ("auto", "on", "off"):
            # fail loudly at plane construction: a typo'd value silently
            # pinning thread mode would make the A/B knob measure nothing
            raise ValueError(
                f"encode_process_mode must be auto|on|off, "
                f"got {process_mode!r}")
        self.process_mode = process_mode
        self.process_min_rows = max(0, int(process_min_rows))
        self.enabled = enabled
        self.min_rows = max(0, int(min_rows))
        self._lock = threading.Lock()
        self._thread_executor = None
        self._process_executor = None
        self._inflight = 0

    # ---- lifecycle ---------------------------------------------------------

    def _want_process(self, cost_rows: Optional[int]) -> bool:
        """Per-result routing: is THIS serialization big enough that a
        spawn-mode worker (pickle round trip included) beats fighting
        the request threads for the GIL?"""
        if self.process_mode == "on":
            return True
        if self.process_mode != "auto":
            return False
        return cost_rows is not None and cost_rows >= self.process_min_rows

    def _pool(self, process: bool):
        """Lazy executor construction: servers that never serve a query
        (storage-only datanodes) must not spawn encode workers, and the
        process pool only exists once a result actually routed to it."""
        import weakref

        with self._lock:
            if process:
                if self._process_executor is None:
                    import multiprocessing

                    # spawn, not fork: the serving process has live CUDA
                    # and request threads a fork would copy mid-lock; the
                    # child imports only servers/encode.py (no torch)
                    self._process_executor = ProcessPoolExecutor(
                        max_workers=self.workers,
                        mp_context=multiprocessing.get_context("spawn"),
                        initializer=_worker_init)
                    # a discarded plane (tests, embedded engines) must
                    # not leak idle workers until interpreter exit
                    weakref.finalize(self, self._process_executor.shutdown,
                                     wait=False)
                return self._process_executor
            if self._thread_executor is None:
                self._thread_executor = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="gtpu-encode")
                weakref.finalize(self, self._thread_executor.shutdown,
                                 wait=False)
            return self._thread_executor

    def shutdown(self) -> None:
        """Stop the workers and join them: no encode thread or worker
        process outlives the plane (the JAX pool does not wait)."""
        with self._lock:
            pools = (self._thread_executor, self._process_executor)
            self._thread_executor = self._process_executor = None
        for ex in pools:
            if ex is not None:
                ex.shutdown(wait=True)

    # ---- entry -------------------------------------------------------------

    def run(self, fn, *args, cost_rows: Optional[int] = None):
        """Run `fn(*args)` on a pool worker and wait for the bytes; the
        calling request thread sleeps on the future (GIL released)
        instead of competing for it. Falls back to inline encoding when
        the pool is disabled or saturated — output is byte-identical
        either way (same encoder function). `cost_rows` gates the
        handoff twice: results under `min_rows` encode inline (handoff
        costs more than dashboard-sized serialization), and results at
        or above `process_min_rows` escape to the process pool in auto
        mode (measured size picks the executor, not a static flag)."""
        if not self.enabled:
            return fn(*args)
        if cost_rows is not None and cost_rows < self.min_rows:
            ENCODE_POOL_EVENTS.inc(event="small_inline")
            return fn(*args)
        process = self._want_process(cost_rows)
        with self._lock:
            if self._inflight >= self.queue_size:
                saturated = True
            else:
                saturated = False
                self._inflight += 1
                ENCODE_POOL_QUEUE_DEPTH.set(float(self._inflight))
        if saturated:
            ENCODE_POOL_EVENTS.inc(event="inline")
            return fn(*args)
        try:
            try:
                # a thread worker encodes under the request's trace and
                # ledger (a process worker cannot carry them)
                fut = self._pool(process).submit(
                    fn if process else tracing.propagate(fn), *args)
            except RuntimeError:
                # executor torn down concurrently (submit after
                # shutdown): the request still gets its bytes. Errors
                # raised by the encoder itself propagate from
                # wait_future below — they must NOT be retried inline
                ENCODE_POOL_EVENTS.inc(event="inline")
                return fn(*args)
            ENCODE_POOL_EVENTS.inc(
                event="offload_process" if process else "offload")
            if process:
                # a worker PROCESS observes its metrics into its own
                # registry (lost to the parent's /metrics): time the
                # round trip here so the encode split stays visible
                t0 = time.perf_counter()
                out = deadline.wait_future(fut, "encode offload")
                ENCODE_SECONDS.observe(time.perf_counter() - t0,
                                       protocol="process")
                return out
            return deadline.wait_future(fut, "encode offload")
        finally:
            with self._lock:
                self._inflight -= 1
                ENCODE_POOL_QUEUE_DEPTH.set(float(self._inflight))
