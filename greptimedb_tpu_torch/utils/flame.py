"""Continuous profiling: a bounded always-on sampler with stage tags.

`utils/profiling.py` is pull-on-demand — hit /debug/pprof/cpu, block
for five seconds, get one flat flame.  This module is the push twin: a
single daemon thread samples every Python stack at a low default rate
(~19 Hz, deliberately co-prime with common periodic work so it doesn't
alias against 10/20/100 Hz loops), attributes each sample to the query
stage and execution path that thread was serving, and aggregates into
rolling per-stage flame windows.  The instrument is always warm: "where
did the last half hour of CPU go, per stage, across the cluster?" is a
single GET away, with no profiling session to arrange.

Attribution works without touching contextvars from the sampler thread
(contextvars are invisible cross-thread): `tracing.span()` pushes and
pops the active span name into a thread-id-keyed registry here, and the
physical executor notes its `last_path` tag the same way.  Both hooks
are guarded by the module-level `_ENABLED` flag so the cost when
profiling is off is one attribute read.

Bounds, because always-on must never become the outage: stack depth is
capped, distinct stacks per window overflow into an ``(other)`` bucket,
windows are a fixed-length deque, and dead-thread registry entries are
purged from the sampler tick itself.  Sampler threads register with
profiling._PROFILER_TIDS so neither sampler ever appears in any flame.

Cluster rollup: datanodes fold `summary()` digests onto the Flight span
piggyback and the metasrv heartbeat; the frontend merges them here
(`note_node_summary` / `cluster_view`) into one deterministic view
served at /v1/profile/cluster and information_schema.cluster_profile.

Copy of greptimedb_tpu/utils/flame.py. A Flight response's piggybacked
digest reaches `note_node_summary` (a wire-mode cluster frontend's view
holds its datanodes' digests); the metasrv keeps the heartbeats' own. `shutdown()` joins the sampler thread (HttpServer.stop()
and `standalone start`'s exit call it).
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Optional

from greptimedb_tpu_torch.utils import profiling as _prof

#: fast-path flag read by tracing.span() and the executor path setter;
#: flipped only by configure()/shutdown()
_ENABLED = False

_DEPTH_CAP = 64          # frames kept per sampled stack
_STACK_CAP = 4000        # distinct stacks per window before "(other)"
_THREAD_CAP = 512        # stage-registry entries before a purge pass
_CLUSTER_CAP = 128       # remote node summaries retained

#: thread-id -> stack of active span names (innermost last)
_STAGES: dict = {}
#: thread-id -> last execution-path tag (dense_fused / mesh / ...)
_PATHS: dict = {}

_lock = threading.Lock()          # guards windows + cluster store
_WINDOWS: collections.deque = collections.deque(maxlen=10)
_CLUSTER: "collections.OrderedDict[str, dict]" = collections.OrderedDict()

_SAMPLER: Optional["_Sampler"] = None
_NODE = "local"
_HZ = 19.0
_WINDOW_S = 30.0

_IDLE_MARKS = ("wait", "select", "poll", "accept", "read (")


# ---- hot-path hooks (called from tracing.span / executor) ------------------

def push_stage(name: str) -> None:
    tid = threading.get_ident()
    st = _STAGES.get(tid)
    if st is None:
        _STAGES[tid] = [name]
    else:
        st.append(name)


def pop_stage() -> None:
    st = _STAGES.get(threading.get_ident())
    if st:
        st.pop()


def note_path(tag) -> None:
    if tag:
        _PATHS[threading.get_ident()] = str(tag)


# ---- sampler ---------------------------------------------------------------

def _new_window() -> dict:
    return {"start_ms": int(time.time() * 1000),
            "counts": collections.Counter()}


def _coarse(stage: str) -> str:
    # metric label + rollup key: "http:POST /v1/sql" -> "http",
    # "stmt:Select" -> "stmt"; span names without a kind pass through
    return stage.split(":", 1)[0] if stage else "host"


_SAMPLES_METRIC = None


def _samples_metric():
    # late-bound: flame is imported by tracing which is imported by
    # metrics, so a top-level metrics import here would be circular
    global _SAMPLES_METRIC
    if _SAMPLES_METRIC is None:
        from greptimedb_tpu_torch.utils.metrics import PROFILE_SAMPLES
        _SAMPLES_METRIC = PROFILE_SAMPLES
    return _SAMPLES_METRIC


class _Sampler(threading.Thread):
    def __init__(self, hz: float, window_s: float):
        super().__init__(name="gtpu-flame-sampler", daemon=True)
        self.period = 1.0 / max(float(hz), 0.1)
        self.window_s = max(float(window_s), 1.0)
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        _prof.register_profiler_thread(threading.get_ident())
        try:
            next_roll = time.monotonic() + self.window_s
            while not self._halt.wait(self.period):
                try:
                    self._tick()
                except Exception:
                    pass  # the instrument must never take the node down
                if time.monotonic() >= next_roll:
                    with _lock:
                        _WINDOWS.append(_new_window())
                    next_roll = time.monotonic() + self.window_s
        finally:
            _prof.unregister_profiler_thread(threading.get_ident())

    def _tick(self) -> None:
        me = threading.get_ident()
        frames = sys._current_frames()
        if len(_STAGES) > _THREAD_CAP or len(_PATHS) > _THREAD_CAP:
            live = set(frames)
            for reg in (_STAGES, _PATHS):
                for tid in [t for t in list(reg) if t not in live]:
                    reg.pop(tid, None)
        metric = None
        try:
            metric = _samples_metric()
        except Exception:
            pass
        batch = []
        for tid, frame in frames.items():
            if tid == me or tid in _prof._PROFILER_TIDS:
                continue
            parts = []
            f = frame
            while f is not None and len(parts) < _DEPTH_CAP:
                code = f.f_code
                parts.append(
                    f"{code.co_name} "
                    f"({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            if not parts:
                continue
            leaf = parts[0]
            st = _STAGES.get(tid)
            stage = None
            if st:
                try:
                    stage = st[-1]
                except IndexError:
                    stage = None
            path = _PATHS.get(tid) if stage is not None else None
            if stage is None and any(m in leaf for m in _IDLE_MARKS):
                continue  # parked pool/acceptor threads are not CPU time
            parts.reverse()
            key = (stage or "host", path or "-", tuple(parts))
            batch.append(key)
            if metric is not None:
                metric.inc(stage=_coarse(stage) if stage else "host")
        if not batch:
            return
        with _lock:
            if not _WINDOWS:
                _WINDOWS.append(_new_window())
            counts = _WINDOWS[-1]["counts"]
            for key in batch:
                if key not in counts and len(counts) >= _STACK_CAP:
                    key = (key[0], key[1], ("(other)",))
                counts[key] += 1


# ---- configuration ---------------------------------------------------------

def enabled() -> bool:
    return _ENABLED


def running() -> bool:
    return _SAMPLER is not None and _SAMPLER.is_alive()


def configure(enabled: bool = True, hz: float = 19.0,
              window_s: float = 30.0, windows: int = 10,
              node: Optional[str] = None) -> None:
    """Start, retune, or stop the continuous sampler (idempotent)."""
    global _ENABLED, _SAMPLER, _NODE, _HZ, _WINDOW_S
    if node is not None:
        _NODE = str(node)
    _HZ, _WINDOW_S = float(hz), float(window_s)
    with _lock:
        if _WINDOWS.maxlen != int(windows):
            kept = list(_WINDOWS)[-int(windows):]
            new = collections.deque(kept, maxlen=max(int(windows), 1))
            _WINDOWS.clear()
            globals()["_WINDOWS"] = new
    if not enabled:
        shutdown()
        return
    if (_SAMPLER is not None and _SAMPLER.is_alive()
            and abs(_SAMPLER.period - 1.0 / max(hz, 0.1)) < 1e-9
            and abs(_SAMPLER.window_s - max(window_s, 1.0)) < 1e-9):
        _ENABLED = True
        return
    shutdown()
    with _lock:
        if not _WINDOWS:
            _WINDOWS.append(_new_window())
    _SAMPLER = _Sampler(hz=hz, window_s=window_s)
    _ENABLED = True
    _SAMPLER.start()


def shutdown() -> None:
    global _ENABLED, _SAMPLER
    _ENABLED = False
    s, _SAMPLER = _SAMPLER, None
    if s is not None and s.is_alive():
        s.stop()
        s.join()


def maybe_install() -> None:
    """Apply `GTPU_PROFILE*` env (the [profiling] twins).

    Called from options.apply_observability at boot and from child
    datanode processes, which inherit the env — same layering as
    tracing/OTLP: env is truth.
    """
    raw = os.environ.get("GTPU_PROFILE", "1").strip().lower()
    on = raw not in ("off", "0", "false", "no")

    def _f(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, "") or default)
        except ValueError:
            return default

    configure(enabled=on,
              hz=_f("GTPU_PROFILE_HZ", 19.0),
              window_s=_f("GTPU_PROFILE_WINDOW_S", 30.0),
              windows=int(_f("GTPU_PROFILE_WINDOWS", 10)),
              node=os.environ.get("GTPU_NODE_ID") or None)


# ---- views -----------------------------------------------------------------

def _merged() -> collections.Counter:
    with _lock:
        total: collections.Counter = collections.Counter()
        for w in _WINDOWS:
            total.update(w["counts"])
        return total


def reset() -> None:
    """Drop all windows and remote summaries (tests / bench A/B)."""
    with _lock:
        _WINDOWS.clear()
        _WINDOWS.append(_new_window())
        _CLUSTER.clear()


def folded(stage: Optional[str] = None) -> str:
    """Rolling windows as folded stacks, stage/path as root frames.

    `stage:<name>;path:<tag>;frame;...;leaf count` per line — feed to
    any flamegraph renderer; grep a `stage:` prefix for one stage.
    """
    merged = _merged()
    lines = [f"# flame: {sum(merged.values())} samples @ {_HZ:g}Hz, "
             f"{len(_WINDOWS)} x {_WINDOW_S:g}s windows, node={_NODE}"]
    rows = []
    for (stg, path, frames), count in merged.items():
        if stage is not None and stg != stage and _coarse(stg) != stage:
            continue
        rows.append((f"stage:{stg};path:{path};" + ";".join(frames), count))
    rows.sort(key=lambda r: (-r[1], r[0]))
    lines.extend(f"{stack} {count}" for stack, count in rows)
    return "\n".join(lines) + "\n"


def speedscope() -> dict:
    """The same windows as a speedscope 'sampled' profile document."""
    merged = _merged()
    frame_ix: dict = {}
    frames_out = []
    samples = []
    weights = []
    for (stg, path, frames), count in sorted(
            merged.items(), key=lambda kv: (-kv[1], kv[0])):
        stack = [f"stage:{stg}", f"path:{path}", *frames]
        ixs = []
        for name in stack:
            ix = frame_ix.get(name)
            if ix is None:
                ix = frame_ix[name] = len(frames_out)
                frames_out.append({"name": name})
            ixs.append(ix)
        samples.append(ixs)
        weights.append(count)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames_out},
        "profiles": [{
            "type": "sampled",
            "name": f"greptimedb_tpu_torch continuous ({_NODE})",
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
        "exporter": "greptimedb_tpu_torch.utils.flame",
        "activeProfileIndex": 0,
    }


def summary(top: int = 10, node: Optional[str] = None) -> dict:
    """Compact digest for piggyback/heartbeat/bench: bounded, mergeable."""
    merged = _merged()
    total = sum(merged.values())
    attributed = 0
    stages: collections.Counter = collections.Counter()
    paths: collections.Counter = collections.Counter()
    self_time: collections.Counter = collections.Counter()
    for (stg, path, frames), count in merged.items():
        if stg != "host" or path != "-":
            attributed += count
        stages[_coarse(stg)] += count
        if path != "-":
            paths[path] += count
        self_time[frames[-1] if frames else "(other)"] += count
    out = {
        "node": str(node) if node is not None else _NODE,
        "ts_ms": int(time.time() * 1000),
        "hz": _HZ,
        "window_s": _WINDOW_S,
        "samples": total,
        "attributed": attributed,
        "stages": {k: int(v) for k, v in sorted(stages.items())},
        "paths": {k: int(v) for k, v in sorted(paths.items())},
        "top": [{"frame": f, "self": int(c)}
                for f, c in sorted(self_time.items(),
                                   key=lambda kv: (-kv[1], kv[0]))[:top]],
    }
    led = _ledger_rollup()
    if led:
        out["ledger"] = led
    return out


def _ledger_rollup() -> dict:
    """Cumulative node-level byte/query totals riding along the digest."""
    try:
        from greptimedb_tpu_torch.utils.metrics import (DEVICE_TRANSFER_BYTES,
                                                  QUERY_ACHIEVED_GBPS)
        out = {}
        for labels, val in DEVICE_TRANSFER_BYTES.series():
            d = labels.get("direction", "?")
            out[f"{d}_bytes"] = int(out.get(f"{d}_bytes", 0) + val)
        out["queries_accounted"] = int(QUERY_ACHIEVED_GBPS.total_count())
        out["gbps_sum"] = float(QUERY_ACHIEVED_GBPS.total_sum())
        return out
    except Exception:
        return {}


# ---- cluster rollup --------------------------------------------------------

def note_node_summary(node: str, summ: dict) -> None:
    """Record a remote node's digest (Flight piggyback / heartbeat)."""
    if not isinstance(summ, dict):
        return
    node = str(node)
    with _lock:
        _CLUSTER.pop(node, None)
        _CLUSTER[node] = summ
        while len(_CLUSTER) > _CLUSTER_CAP:
            _CLUSTER.popitem(last=False)


def cluster_view(top: int = 10) -> dict:
    """Local + remote digests merged into one deterministic view.

    Merging is a commutative sum keyed by stage/path/frame, emitted in
    sorted order — the view is identical whatever order node summaries
    arrived in (the determinism the tests pin).
    """
    local = summary(top=top)
    with _lock:
        nodes = dict(_CLUSTER)
    nodes[local["node"]] = local
    stages: collections.Counter = collections.Counter()
    paths: collections.Counter = collections.Counter()
    self_time: collections.Counter = collections.Counter()
    samples = 0
    attributed = 0
    for summ in nodes.values():
        samples += int(summ.get("samples", 0))
        attributed += int(summ.get("attributed", 0))
        for k, v in (summ.get("stages") or {}).items():
            stages[k] += int(v)
        for k, v in (summ.get("paths") or {}).items():
            paths[k] += int(v)
        for row in (summ.get("top") or []):
            self_time[row.get("frame", "?")] += int(row.get("self", 0))
    return {
        "nodes": {k: nodes[k] for k in sorted(nodes)},
        "merged": {
            "samples": samples,
            "attributed": attributed,
            "stages": {k: int(v) for k, v in sorted(stages.items())},
            "paths": {k: int(v) for k, v in sorted(paths.items())},
            "top": [{"frame": f, "self": int(c)}
                    for f, c in sorted(self_time.items(),
                                       key=lambda kv: (-kv[1], kv[0]))[:top]],
        },
    }
