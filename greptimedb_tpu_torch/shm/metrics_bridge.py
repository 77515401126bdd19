"""Worker->parent metrics bridge (copy of
greptimedb_tpu/shm/metrics_bridge.py).

A spawn-mode encode worker observes its metrics into ITS OWN process
registry: without the fabric, the parent's /metrics can only show a
parent-side round-trip approximation for `encode_seconds{protocol=
"process"}` and loses the worker-side series entirely. With it, every worker
publishes a cumulative pickled snapshot of its touched metrics into the
fabric under (METRICS_KIND, "<parent pid>/<pid>") after each encode; the parent
registers a scrape-time collector that folds the latest snapshot of each
of ITS OWN workers into the matching registry metrics via
`set_external` — cumulative snapshots, so republishing never
double-counts, and a worker that dies keeps its final counts visible
(counters are cumulative by contract). Unlike the JAX copy, which keys a
snapshot by the worker's pid alone and folds every worker on the
fabric, the key names the parent: several frontends share one fabric,
and each one's /metrics counts its own workers' encodes, not its
peers'.

Trust note: snapshots are pickles read from our own uid-scoped fabric
segment — the same-box, same-user trust domain every other fabric
artifact lives in — and `shm.loads` builds plain builtin values only
for them.
"""

from __future__ import annotations

import os
import pickle
import threading


#: worker-side metrics worth bridging (the encode path's surface);
#: names resolve against the parent registry at fold time
_BRIDGED_HISTOGRAMS = ("greptimedb_tpu_encode_seconds",)
_BRIDGED_COUNTERS = ("greptimedb_tpu_shm_fabric_events_total",
                     "greptimedb_tpu_encode_pool_events_total")

_installed = {"done": False}
_install_lock = threading.Lock()


def _by_name():
    from greptimedb_tpu_torch.utils.metrics import REGISTRY

    with REGISTRY._lock:
        metrics = list(REGISTRY._metrics)
    return {m.name: m for m in metrics}


def publish_worker_metrics() -> None:
    """Worker side: push this process's cumulative encode-path series
    into the fabric (no-op when the fabric is off/unattached). Never
    raises — metrics must not fail an encode."""
    from greptimedb_tpu_torch import shm

    metrics = _by_name()
    state: dict = {"hist": {}, "counter": {}}
    for name in _BRIDGED_HISTOGRAMS:
        m = metrics.get(name)
        if m is not None:
            st = m.export_state()
            if st:
                state["hist"][name] = st
    for name in _BRIDGED_COUNTERS:
        m = metrics.get(name)
        if m is not None:
            # _snapshot folds the worker's own thread shards; the
            # worker has no externals of its own to double-count
            snap = m._snapshot()
            if snap:
                state["counter"][name] = snap
    if not state["hist"] and not state["counter"]:
        return
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    shm.fabric_op(lambda fabric: fabric.put(
        shm.METRICS_KIND, f"{os.getppid()}/{os.getpid()}".encode(), blob))


def collect_worker_metrics() -> None:
    """Parent side (scrape-time collector): fold the latest snapshot of
    each of this process's workers into the registry metrics."""
    from greptimedb_tpu_torch import shm

    published = shm.fabric_op(lambda fabric: fabric.scan(shm.METRICS_KIND))
    if not published:
        return
    metrics = _by_name()
    mine = f"{os.getpid()}/".encode()
    for key, val in published:
        if not key.startswith(mine):
            continue  # a peer frontend's worker, or this process itself
        state = shm.loads(val)
        if not isinstance(state, dict):
            continue  # a torn or stale blob must not kill the scrape
        source = f"shm-worker-{key.decode(errors='replace')}"
        for name, st in state.get("hist", {}).items():
            m = metrics.get(name)
            if m is not None and hasattr(m, "set_external"):
                m.set_external(source, st)
        for name, snap in state.get("counter", {}).items():
            m = metrics.get(name)
            if m is not None and hasattr(m, "set_external"):
                m.set_external(source, snap)


def install_collector() -> None:
    """Register the parent-side collector once per process (the
    ConcurrencyPlane calls this when the fabric attaches)."""
    with _install_lock:
        if _installed["done"]:
            return
        _installed["done"] = True
    from greptimedb_tpu_torch.utils.metrics import REGISTRY

    REGISTRY.register_collector(collect_worker_metrics)
