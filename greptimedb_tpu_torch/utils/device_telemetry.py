"""Device runtime telemetry of the port: kernel builds, device memory and
link traffic (counterpart of greptimedb_tpu/utils/device_telemetry.py,
which listens to jax.monitoring compile events and reads PJRT memory).

Three feeds, under the JAX package's metric names so its dashboard reads
the port unchanged:

- **Kernel builds**: `ops/_build.py::build()` compiles the CUDA kernel
  library with nvcc; each build that really compiles calls `note_build`,
  counted as `greptimedb_tpu_xla_compile_total{backend="cuda"}` and
  timed in `greptimedb_tpu_xla_compile_duration_seconds` (the family
  keeps its XLA name; in the port it counts nvcc builds).
- **Device memory**: a render-time collector reads the CUDA caching
  allocator (`torch.cuda.memory_stats`: allocated, reserved and the peak
  allocated bytes) when a card is initialised, plus the hot set's own
  pinned bytes, which work on every device.
- **Transfers**: `count_h2d` / `count_d2h` are called at the upload and
  readback seams: the hot set's uploads (`query/device_cache.py`,
  `count_upload`), the uncached uploads of query/physical.py and
  promql/, and the aggregation routes' pulls (`physical._to_host`).
  Each also feeds the request's resource ledger (`h2d_bytes`,
  `d2h_bytes`).

`install()` is idempotent and cheap; importing query/physical.py wires
the collector.
"""

from __future__ import annotations

import sys
import threading
import weakref

from greptimedb_tpu_torch.utils import ledger
from greptimedb_tpu_torch.utils.metrics import (
    DEVICE_MEMORY,
    DEVICE_TRANSFER_BYTES,
    REGISTRY,
    XLA_COMPILE_SECONDS,
    XLA_COMPILES,
)

_install_lock = threading.Lock()
_installed = False

#: live DeviceCache instances (registered by DeviceCache.__init__) —
#: the memory collector sums their pinned bytes at scrape time
_caches: "weakref.WeakSet" = weakref.WeakSet()


def register_cache(cache) -> None:
    _caches.add(cache)


def count_h2d(nbytes: int) -> None:
    if nbytes:
        DEVICE_TRANSFER_BYTES.inc(float(nbytes), direction="h2d")
        ledger.add("h2d_bytes", float(nbytes))


def count_d2h(nbytes: int) -> None:
    if nbytes:
        DEVICE_TRANSFER_BYTES.inc(float(nbytes), direction="d2h")
        ledger.add("d2h_bytes", float(nbytes))


def note_build(seconds: float, backend: str = "cuda") -> None:
    """One nvcc build of the kernel library (ops/_build.py)."""
    XLA_COMPILES.inc(backend=backend)
    XLA_COMPILE_SECONDS.observe(float(seconds), backend=backend)


def _collect_device_memory() -> None:
    """Scrape-time gauge refresh (registered on REGISTRY)."""
    cache_bytes = 0
    for cache in list(_caches):
        cache_bytes += getattr(cache, "_bytes", 0)
    DEVICE_MEMORY.set(float(cache_bytes), kind="cache")
    stats = None
    # read the allocator only where torch is loaded and a card was
    # initialised: a scrape must never be the call that wakes CUDA up
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                stats = torch.cuda.memory_stats()
        except Exception:  # noqa: BLE001 — a scrape must never fail
            stats = None
    if stats:
        DEVICE_MEMORY.set(float(stats.get("allocated_bytes.all.current", 0)),
                          kind="in_use")
        DEVICE_MEMORY.set(float(stats.get("reserved_bytes.all.current", 0)),
                          kind="reserved")
        DEVICE_MEMORY.set(float(stats.get("allocated_bytes.all.peak", 0)),
                          kind="peak")
    else:
        # no card initialised: the hot set's pinned bytes ARE the device
        # working set — report them so the series exists everywhere
        DEVICE_MEMORY.set(float(cache_bytes), kind="in_use")


def install() -> None:
    """Wire the memory collector. Safe to call from several modules;
    only the first call does work."""
    global _installed
    with _install_lock:
        if _installed:
            return
        _installed = True
    REGISTRY.register_collector(_collect_device_memory)
