"""Bounded worker threads for parallel SST scan decode (counterpart of
greptimedb_tpu/storage/scan_pool.py).

A scan fans its SST reads and decodes, and the concatenation of its
columns, across up to `resolve(...)` workers. The port's reads are
`readinto` calls and its decode is numpy gathers and copies, which
release the GIL.

Sizing: `decode_threads` from `[scan]` (EngineConfig.scan_decode_threads)
caps a scan's workers; 0 means auto (min(8, cpu_count)). The
GREPTIMEDB_TPU_SCAN_DECODE_THREADS environment variable wins over the
config, as in the JAX package. A scan with one worker, or one file of
one row group, decodes inline: byte for byte the serial path.

Where the JAX package keeps one process-wide pool whose idle threads
outlive every query, the port's `DecodePool` belongs to its RegionEngine
and keeps no idle thread: each parallel step of a scan runs on workers
(`gtpu-scan-decode`) that start with it and are joined when it ends, so
no decode thread outlives its query, and `RegionEngine.close()` joins any
still running. An idle executor worker would also stay visible to a
stack sampler as host time that belongs to no query.
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

from greptimedb_tpu_torch.utils import deadline as dl

_AUTO_CAP = 8

THREAD_PREFIX = "gtpu-scan-decode"


def resolve(decode_threads: int, num_files: int) -> int:
    """Effective worker count for one scan: the configured cap (0 =
    auto) bounded by the files actually needing decode. The env var
    (set by A/B runs and tests) wins over the config object."""
    env = os.environ.get("GREPTIMEDB_TPU_SCAN_DECODE_THREADS")
    if env:
        try:
            decode_threads = int(env)
        except ValueError:
            pass
    if decode_threads <= 0:
        decode_threads = min(_AUTO_CAP, os.cpu_count() or 1)
    return max(1, min(decode_threads, num_files))


class DecodePool:
    """The engine's decode executors: one a parallel step, joined when
    the step ends; `shutdown()` joins any still running."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: set[ThreadPoolExecutor] = set()

    @contextlib.contextmanager
    def executor(self, workers: int):
        """An executor of `workers` threads for one step of a scan; its
        threads are joined when the block exits."""
        ex = ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix=THREAD_PREFIX)
        with self._lock:
            self._live.add(ex)
        try:
            yield ex
        finally:
            ex.shutdown(wait=True)
            with self._lock:
                self._live.discard(ex)

    def shutdown(self) -> None:
        """Join every worker of a step still running (queued units
        finish first)."""
        with self._lock:
            live = list(self._live)
        for ex in live:
            ex.shutdown(wait=True)


def submit(pool: ThreadPoolExecutor, fn, *args, **kwargs):
    """Submit a decode unit with the caller's CancelToken re-adopted
    inside the worker (contextvars don't cross threads on their own):
    each unit checkpoints before decoding, so a cancelled or expired
    query's still-queued units unwind typed instead of burning pool
    workers on dead work. Tokenless callers get a plain submit."""
    token = dl.current()
    if token is None:
        return pool.submit(fn, *args, **kwargs)

    def run():
        with dl.activate(token):
            dl.check("scan decode")
            return fn(*args, **kwargs)

    return pool.submit(run)
