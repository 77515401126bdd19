"""Background maintenance plane of the port (copy of
greptimedb_tpu/maintenance/).

- `MaintenanceScheduler` (scheduler.py): a bounded priority queue and a
  small worker pool per engine. Per-region jobs serialize (one running
  job per region); priority is flush > compaction > rollup > expiry; the
  write path only stalls when a region's memtable bytes or L0 file count
  cross a hard threshold (RegionEngine._maybe_stall).
- rollup jobs (rollup.py): inactive-window raw rows re-encoded into
  coarser-resolution plane rows (min/max/sum/count per field, the raw
  row count) in a hidden companion region, built by ONE K2 call
  (ops/segment_kernels.fused_segment_agg) a job, and substituted at
  query time for eligible coarse-bucket aggregates.
- retention expiry (retention.py): a TTL drops whole expired SSTs with
  one atomic manifest edit.

Job visibility: every job carries an id; ADMIN flush_table / compact_table
/ rollup_table / expire_table return it, ADMIN maintenance_status(job_id)
polls it, and `information_schema.maintenance_jobs` and `/v1/maintenance`
list the live queue and recent history. Chaos hooks: the
`maintenance.job` fault point fires at job start (op=kind, phase=start)
and at each job's manifest or coverage swap (phase=swap).
"""

from __future__ import annotations

from .scheduler import PRIORITY, Job, MaintenanceScheduler, parse_duration_ms

__all__ = ["Job", "MaintenanceScheduler", "PRIORITY", "parse_duration_ms"]
