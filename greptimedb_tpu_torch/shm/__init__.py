"""Cross-process serving fabric of the port (counterpart of
greptimedb_tpu/shm/): a shared-memory artifact plane N frontend
processes on one box attach to.

What rides the fabric:

- **fast-lane templates** (`concurrency/fast_lane.py`): a template miss
  probes the fabric before paying the probe-verification parses; a
  local build publishes its verified binder so peers adopt instead of
  re-probing. Peer-DDL safety rides per-(db, table) fabric versions
  bumped through `ConcurrencyPlane.invalidate_table` plus the existing
  per-hit TableInfo snapshot checks.
- **plan-cache entries** (`concurrency/plan_cache.py`): a shape miss
  probes the fabric for a peer's validated canonical plan; adoption
  re-runs the same `_info_matches` safety net every in-process hit
  runs.
- **compiled kernels**: nothing to share at run time. The JAX
  package's fourth leg points every process's persistent XLA cache at
  `<fabric_dir>/xla-cache` (`apply_shared_xla_cache`); the port compiles
  nothing while it serves. Its CUDA kernels are built once per checkout
  by nvcc into `_build/` (ops/_build.py, under a lock when processes
  start together), and every process loads that one library.
- **zero-copy result handoff** (`shm/results.py`): process-mode encode
  workers write encoded payloads into a shared-memory arena and return
  an offset; the socket writer sends straight from the mapping.
- **worker metrics** (`shm/metrics_bridge.py`): encode workers publish
  their cumulative counters through the fabric so the parent's
  /metrics is exact, not a parent-side approximation.

Configuration: `[shm]` options (`fabric`, `fabric_bytes`,
`fabric_dir`) with `GTPU_SHM_FABRIC` / `GTPU_SHM_FABRIC_BYTES` /
`GTPU_SHM_FABRIC_DIR` env twins (spawned encode workers inherit the
environment, so one setting covers the whole box). The fabric is opt-in
(off by default): a single-process deployment pays nothing. It shares
host-side artifacts only: every process runs its own kernels on the
card, so a fabric fault never changes what a kernel computes.

Degradation contract: attach failure, a corrupt slot, or a layout
version mismatch detaches THIS process to its private in-process lane
— typed, counted (`shm_fabric_events_total{event="detach"}`), and
byte-for-byte identical output either way.

A port process and a JAX process may attach one segment (the layout is
the JAX one's), but they share versions and raw bytes only: the port
stores its plans, templates and worker metrics under kinds of its own
(`PLAN_KIND`, `TEMPLATE_KIND`, `METRICS_KIND`), and `loads` builds only
the port's own classes, so a blob of the other package (or a forged
one) is a plain miss that imports and runs nothing.
"""

from __future__ import annotations

import io
import os
import pickle
import threading
from dataclasses import dataclass

from greptimedb_tpu_torch.shm.fabric import (  # noqa: F401 — package surface
    Fabric,
    FabricError,
    SEGMENT_PREFIX,
    segment_name,
)
from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_BYTES, SHM_FABRIC_EVENTS

_TRUE = ("1", "true", "on", "yes")

#: the port's artifact kinds; the JAX package uses the bare names
PLAN_KIND = "torch.plan"
TEMPLATE_KIND = "torch.tpl"
METRICS_KIND = "torch.met"

#: builtins a published artifact may hold (plain containers and values)
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple"})


class _PortUnpickler(pickle.Unpickler):
    """Builds the port's own classes and plain builtin values, nothing
    else: no function, no module of another package."""

    def find_class(self, module, name):
        if "." not in name:
            if module == "builtins" and name in _SAFE_BUILTINS:
                return super().find_class(module, name)
            if module.startswith("greptimedb_tpu_torch."):
                obj = super().find_class(module, name)
                if isinstance(obj, type) and obj.__module__ == module:
                    return obj
        raise pickle.UnpicklingError(f"not a port artifact: {module}.{name}")


def loads(blob: bytes):
    """A blob read from the fabric -> its object, or None when it is not
    one the port published (another package's, a stale or torn one)."""
    try:
        return _PortUnpickler(io.BytesIO(blob)).load()
    except Exception:  # noqa: BLE001 — any doubt is a plain miss
        return None


def fabric_op(fn, default=None):
    """fn(fabric) on this process's attached fabric: `default` when the
    fabric is off, and a counted detach (then `default`) when the
    segment fails under it."""
    fabric = get_fabric()
    if fabric is None:
        return default
    try:
        return fn(fabric)
    except (FabricError, OSError, ValueError):
        detach()
        return default


@dataclass
class ShmConfig:
    #: master switch for the whole fabric plane (opt-in)
    fabric: bool = False
    #: bytes per shared segment (artifact fabric and result arena each)
    fabric_bytes: int = 64 << 20
    #: directory holding the lockfiles; every process pointing at the
    #: same directory shares one fabric
    fabric_dir: str = ""


def default_fabric_dir() -> str:
    import tempfile

    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"gtpu-fabric-{uid}")


def config_from_env() -> ShmConfig:
    """The env-twin layer (options.apply_shm writes these so spawned
    children, the encode workers, inherit)."""
    cfg = ShmConfig()
    cfg.fabric = os.environ.get("GTPU_SHM_FABRIC", "").lower() in _TRUE
    raw = os.environ.get("GTPU_SHM_FABRIC_BYTES", "")
    if raw:
        try:
            cfg.fabric_bytes = max(1 << 20, int(raw))
        except ValueError:
            pass
    cfg.fabric_dir = os.environ.get("GTPU_SHM_FABRIC_DIR", "") \
        or default_fabric_dir()
    return cfg


# singleton state: one attached fabric per process. `failed` latches a
# detach so a corrupt fabric is probed once, not per request.
_state = {"fabric": None, "inited": False}
_state_lock = threading.Lock()


def get_fabric():
    """The process-wide attached Fabric, or None (disabled, never
    configured, or detached after a failure). Never raises."""
    with _state_lock:
        if _state["inited"]:
            return _state["fabric"]
        _state["inited"] = True
        cfg = config_from_env()
        if not cfg.fabric:
            return None
        try:
            f = Fabric(cfg.fabric_dir, size=cfg.fabric_bytes)
        except (FabricError, OSError, ValueError):
            SHM_FABRIC_EVENTS.inc(event="detach", kind="fabric")
            return None
        _state["fabric"] = f
        import atexit

        # engines share the singleton, so no plane shutdown may close
        # it; the process closes it on the way out (last one unlinks)
        atexit.register(shutdown_fabric)
        SHM_FABRIC_BYTES.set(float(cfg.fabric_bytes),
                             segment="fabric", dim="size")
        return f


def detach(reason: str = "corrupt"):
    """Degrade this process to the private in-process lane: close the
    fabric (peers keep theirs) and latch the failure. Typed + counted;
    serving continues without it."""
    with _state_lock:
        f = _state["fabric"]
        _state["fabric"] = None
        _state["inited"] = True
    if f is not None:
        if reason == "corrupt":
            SHM_FABRIC_EVENTS.inc(event="corrupt", kind="fabric")
        SHM_FABRIC_EVENTS.inc(event="detach", kind="fabric")
        try:
            f.close()
        except OSError:
            pass


def shutdown_fabric():
    """Clean detach at plane shutdown (the last process out unlinks the
    segment); resets the singleton so tests can re-init."""
    with _state_lock:
        f = _state["fabric"]
        _state["fabric"] = None
        _state["inited"] = False
    if f is not None:
        try:
            f.close()
        except OSError:
            pass
    from greptimedb_tpu_torch.shm import results

    results.shutdown_arena()


_stats_installed = {"done": False}


def install_stats_collector() -> None:
    """Register the fabric-gauge collector once per process (tests
    build many planes; one collector serves them all)."""
    with _state_lock:
        if _stats_installed["done"]:
            return
        _stats_installed["done"] = True
    from greptimedb_tpu_torch.utils.metrics import REGISTRY

    REGISTRY.register_collector(collect_fabric_stats)


def collect_fabric_stats() -> None:
    """Scrape-time collector: refresh the fabric gauges (registered by
    ConcurrencyPlane when the fabric attaches)."""
    with _state_lock:
        f = _state["fabric"]
    if f is None:
        return
    try:
        st = f.stats()
    except (FabricError, OSError, ValueError):
        return
    if st:
        SHM_FABRIC_BYTES.set(float(st["size"]), segment="fabric",
                             dim="size")
        SHM_FABRIC_BYTES.set(float(st["heap_used"]), segment="fabric",
                             dim="used")
