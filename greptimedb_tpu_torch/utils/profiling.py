"""On-demand profiling over HTTP — the pprof analog.

Mirrors the reference's `servers/src/http/pprof.rs` (CPU flamegraphs via
the pprof crate's sampling profiler) and `http/mem_prof.rs` (jemalloc heap
profiles): here a wall-clock stack sampler over `sys._current_frames()`
produces folded-stack output (the flamegraph.pl / speedscope "collapsed"
format), and tracemalloc snapshots provide allocation profiles. Both are
pull-style: hit the endpoint, get a self-contained text artifact.

Copy of greptimedb_tpu/utils/profiling.py."""

from __future__ import annotations

import sys
import threading
import time
import tracemalloc
from collections import Counter

#: thread idents of every live profiler/sampler thread — each sampler
#: (this module's on-demand one, utils/flame.py's continuous one)
#: registers itself so no flame is ever polluted by the instruments
#: observing each other. Plain set mutations are GIL-atomic.
_PROFILER_TIDS: set = set()


def register_profiler_thread(tid: int) -> None:
    _PROFILER_TIDS.add(tid)


def unregister_profiler_thread(tid: int) -> None:
    _PROFILER_TIDS.discard(tid)


def sample_cpu(seconds: float = 5.0, hz: float = 99.0,
               include_idle: bool = False) -> str:
    """Sample every thread's Python stack for `seconds` at `hz`.

    Returns folded stacks: `frame;frame;...;leaf count` per line, leaf
    last — feed to any flamegraph renderer. Threads blocked in epoll/GIL
    waits are skipped unless include_idle (matching pprof's on-CPU view
    as closely as a wall sampler can). Profiler threads — this one and
    any registered continuous sampler — are excluded: an earlier version
    counted its own sampling loop when invoked off the serving thread,
    so every flame carried a phantom `sample_cpu` tower."""
    deadline = time.monotonic() + seconds
    interval = 1.0 / hz
    stacks: Counter = Counter()
    me = threading.get_ident()
    register_profiler_thread(me)
    try:
        n_samples = _sample_loop(deadline, interval, stacks, include_idle)
    finally:
        unregister_profiler_thread(me)
    lines = [f"# sampler: {n_samples} samples @ {hz:g}Hz over {seconds:g}s"]
    for stack, count in stacks.most_common():
        lines.append(f"{stack} {count}")
    return "\n".join(lines) + "\n"


def _sample_loop(deadline: float, interval: float, stacks: Counter,
                 include_idle: bool) -> int:
    n_samples = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid in _PROFILER_TIDS:
                continue
            parts = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            if not parts:
                continue
            leaf = parts[0]
            if not include_idle and (
                "wait" in leaf or "select" in leaf or "poll" in leaf
                or "accept" in leaf or "read (" in leaf
            ):
                continue
            stacks[";".join(reversed(parts))] += 1
        n_samples += 1
        time.sleep(interval)
    return n_samples


_mem_lock = threading.Lock()


def mem_profile(top: int = 50) -> str:
    """Allocation snapshot (jemalloc heap-profile analog). Starts
    tracemalloc on first call — the first snapshot covers allocations from
    then on; subsequent calls show current live allocations."""
    with _mem_lock:
        if not tracemalloc.is_tracing():
            tracemalloc.start(10)
            return ("# tracemalloc started; allocations recorded from now —"
                    " call again for a snapshot\n")
        snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")
    total = sum(s.size for s in stats)
    lines = [f"# live python allocations: {total / 1e6:.1f} MB "
             f"in {len(stats)} sites (top {top})"]
    for s in stats[:top]:
        fr = s.traceback[0]
        lines.append(f"{s.size / 1e3:.1f}kB x{s.count} "
                     f"{fr.filename.rsplit('/', 1)[-1]}:{fr.lineno}")
    return "\n".join(lines) + "\n"


def mem_profile_stop() -> str:
    with _mem_lock:
        if tracemalloc.is_tracing():
            tracemalloc.stop()
            return "# tracemalloc stopped\n"
        return "# tracemalloc was not running\n"
