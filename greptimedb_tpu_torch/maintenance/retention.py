"""Retention expiry: a TTL drops whole expired SSTs (copy of
greptimedb_tpu/maintenance/retention.py).

An SST whose ts_max is older than `now - ttl` is dropped wholesale: one
manifest edit removes the files atomically, and the purge queue deletes
the bytes once no scan pins them. Rows inside a straddling SST are NOT
trimmed (that would be a rewrite, a compaction's job); expiry is
metadata-only. The memtable and the WAL are untouched: the edit never
advances the flushed sequence."""

from __future__ import annotations

import time
from typing import Optional

from greptimedb_tpu_torch.fault import FAULTS
from greptimedb_tpu_torch.utils.metrics import EXPIRED_SSTS


def ms_to_units(ms: int, dtype) -> int:
    """Milliseconds -> the timestamp column's native unit (floor)."""
    nanos = dtype.time_unit.nanos_per_unit
    return int(ms * 1_000_000 // nanos)


def run_expiry(region, ttl_ms: int, now_ms: Optional[int] = None) -> dict:
    """Drop every SST fully older than the TTL from `region` with one
    atomic manifest edit. Returns {"removed": n, "cutoff": units}."""
    if ttl_ms <= 0:
        return {"removed": 0, "cutoff": None}
    now = int(time.time() * 1000) if now_ms is None else int(now_ms)
    dtype = region.schema.time_index.dtype
    cutoff = ms_to_units(now - ttl_ms, dtype)
    # _compact_lock: a concurrent merge (the inline stall-escape
    # compaction bypasses the scheduler's per-region serialization)
    # reads its input SSTs outside region._lock; expiring one mid-merge
    # would fail the merge or resurrect expired rows
    with region._compact_lock, region._lock:
        expired = [f for f in region.files.values() if f.ts_max < cutoff]
        if not expired:
            return {"removed": 0, "cutoff": cutoff}
        # chaos seam: a crash here must leave the pre-expiry file list
        # fully readable (the manifest edit below is the atomic swap)
        FAULTS.fire("maintenance.job", op="expire", phase="swap")
        removed = [f.file_id for f in expired]
        for fid in removed:
            region.files.pop(fid, None)
        # expired files' decoded parts and device blocks go with them
        region._invalidate_file_parts(removed)
        # flushed_seq=None: expiry persists nothing from the memtable;
        # advancing flushed_seq would drop unflushed writes on replay
        region.manifest.record_flush(
            [], flushed_seq=None,
            tag_dicts=region.registry.snapshot(), removed=removed)
        region._purge_queue.extend(removed)
        region.data_version += 1
        region._drain_purge()
    EXPIRED_SSTS.inc(len(removed))
    return {"removed": len(removed), "cutoff": cutoff}
