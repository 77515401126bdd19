"""Bounded-queue background job scheduler, one per RegionEngine (copy of
greptimedb_tpu/maintenance/scheduler.py).

Maintenance runs on a small worker pool, never on the writer thread. Jobs for the same region
serialize (the reference keeps one in-flight task per region); across
regions the pool runs jobs concurrently. The queue is bounded — when it
fills, a submission degrades to running the job inline on the caller
(backpressure with forward progress, never unbounded memory).

Priority: flush > compaction > downsample(rollup) > expiry. A stalled
writer is waiting on flush, so flush must never queue behind a day-long
rollup re-encode.

`stop()` joins every worker and the tick thread before it returns (the
JAX scheduler's threads are daemons joined with a timeout).
"""

from __future__ import annotations

import heapq
import itertools
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.fault import FAULTS
from greptimedb_tpu_torch.storage.compaction import TwcsPicker
from greptimedb_tpu_torch.utils.metrics import (
    MAINTENANCE_JOB_SECONDS,
    MAINTENANCE_JOBS,
    MAINTENANCE_QUEUE_DEPTH,
)

logger = logging.getLogger(__name__)

#: job kinds in dispatch-priority order (lower = sooner)
PRIORITY = {"flush": 0, "compact": 1, "rollup": 2, "expire": 3}

#: completed/failed jobs kept for maintenance_status / info schema
HISTORY_LIMIT = 512

_DUR_UNITS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
              "d": 86_400_000, "w": 7 * 86_400_000}


def parse_duration_ms(spec) -> int:
    """'90s' / '1m' / '7d' / bare int (ms) -> milliseconds."""
    if isinstance(spec, (int, float)):
        return int(spec)
    s = str(spec).strip().lower()
    if not s:
        return 0
    for unit in ("ms", "w", "d", "h", "m", "s"):
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * _DUR_UNITS[unit])
    return int(float(s))


@dataclass
class Job:
    """One maintenance job: identity + lifecycle + result detail."""

    job_id: int
    kind: str  # flush | compact | rollup | expire
    region_id: int
    params: dict = field(default_factory=dict)
    state: str = "queued"  # queued | running | done | failed
    error: str = ""
    detail: dict = field(default_factory=dict)
    queued_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def duration_ms(self) -> Optional[float]:
        if self.started_at is None or self.finished_at is None:
            return None
        return (self.finished_at - self.started_at) * 1000.0

    @property
    def terminal(self) -> bool:
        return self.state in ("done", "failed")

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id, "kind": self.kind,
            "region_id": self.region_id, "state": self.state,
            "priority": PRIORITY.get(self.kind, 9), "error": self.error,
            "detail": dict(self.detail),
            "queued_at": self.queued_at, "started_at": self.started_at,
            "finished_at": self.finished_at,
            "duration_ms": self.duration_ms,
        }


class MaintenanceScheduler:
    def __init__(self, engine, workers: int = 1, queue_size: int = 64,
                 tick_interval_s: float = 0.0, retention_ttl_ms: int = 0,
                 rollup_rules: Optional[list] = None):
        from greptimedb_tpu_torch.maintenance.rollup import RollupRule

        self.engine = engine
        self.queue_size = max(1, queue_size)
        self.retention_ttl_ms = retention_ttl_ms
        #: configured downsample rules; identity is the RESOLUTION (the
        #: rollup region id embeds rollup.rule_slot(resolution_ms)), so
        #: order never matters. ADMIN-registered ad-hoc rules persist to
        #: the data dir and are merged back in at boot — a restart must
        #: not silently stop substituting over existing plane SSTs.
        self.rollup_rules: list[RollupRule] = [
            r if isinstance(r, RollupRule) else RollupRule.from_dict(r)
            for r in (rollup_rules or [])
        ]
        for r in self._load_adhoc_rules():
            if all(r.resolution_ms != c.resolution_ms
                   for c in self.rollup_rules):
                self.rollup_rules.append(r)
        self._check_slot_collisions(self.rollup_rules)
        self._ids = itertools.count(1)
        self._seq = itertools.count()  # FIFO tie-break inside a priority
        self._heap: list[tuple[int, int, Job]] = []
        self._jobs: "OrderedDict[int, Job]" = OrderedDict()
        self._queued_keys: dict[tuple, Job] = {}  # dedup of queued jobs
        self._busy_regions: set[int] = set()
        #: region -> thread ident of the job currently running it; lets
        #: a job's own follow-up submission detect itself (re-entrant
        #: inline execution on the submitter's busy region = deadlock)
        self._region_owner: dict[int, int] = {}
        self._cv = threading.Condition()
        self._stopping = False
        self._workers: list[threading.Thread] = []
        n = max(1, int(workers))
        for i in range(n):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"gtpu-maint-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        self._ticker = None
        if tick_interval_s and tick_interval_s > 0:
            self.tick_interval_s = float(tick_interval_s)
            self._ticker = threading.Thread(target=self._tick_loop,
                                            name="gtpu-maint-tick",
                                            daemon=True)
            self._ticker.start()

    # ---- submission ---------------------------------------------------------

    def submit(self, kind: str, region_id: int,
               params: Optional[dict] = None) -> Job:
        """Enqueue a job and return it immediately (async). An identical
        (kind, region, params) job already queued is returned instead of
        double-queued — repeated auto-flush triggers while one flush is
        pending collapse to one job. When the queue is full the job runs
        INLINE on the caller (bounded queue, forward progress)."""
        if kind not in PRIORITY:
            raise ValueError(f"unknown maintenance job kind {kind!r} "
                             f"(have: {sorted(PRIORITY)})")
        params = params or {}
        key = (kind, region_id, tuple(sorted(params.items())))
        inline = False
        with self._cv:
            if self._stopping:
                raise RuntimeError("maintenance scheduler is stopped")
            dup = self._queued_keys.get(key)
            if dup is not None:
                return dup
            job = Job(job_id=next(self._ids), kind=kind,
                      region_id=region_id, params=params)
            self._remember(job)
            if len(self._heap) >= self.queue_size:
                inline = True  # full: degrade to caller-side execution
                # detail is REBOUND, never mutated: to_dict() snapshots
                # it without the scheduler lock
                job.detail = {**job.detail, "inline": True}
            else:
                heapq.heappush(
                    self._heap,
                    (PRIORITY[kind], next(self._seq), job))
                self._queued_keys[key] = job
                MAINTENANCE_QUEUE_DEPTH.set(len(self._heap))
                self._cv.notify_all()
        if inline:
            # inline degradation still honors per-region serialization:
            # claim the region like a worker would, or two compactions
            # could race on the same file set / coverage state
            me = threading.get_ident()
            deadline = time.monotonic() + 5.0
            with self._cv:
                claimed = False
                if self._region_owner.get(job.region_id) != me:
                    # bounded wait: a writer must never freeze behind a
                    # long-running job on this region (the re-entrant
                    # case — our own running job — never waits at all)
                    while job.region_id in self._busy_regions and \
                            time.monotonic() < deadline:
                        self._cv.wait(0.1)
                    claimed = job.region_id not in self._busy_regions
                if not claimed:
                    if self._stopping:
                        # stop() may have swept the heap while we waited
                        # — re-queueing now would strand the job
                        # 'queued' forever (wait() would never return)
                        job.state = "failed"
                        job.error = "scheduler stopped"
                        job.finished_at = time.time()
                        self._cv.notify_all()
                        return job
                    # region busy (or it's us): queue past the bound —
                    # soft overflow beats deadlock/frozen writers
                    job.detail = {k: v for k, v in job.detail.items()
                                  if k != "inline"}
                    heapq.heappush(
                        self._heap,
                        (PRIORITY[job.kind], next(self._seq), job))
                    self._queued_keys[key] = job
                    MAINTENANCE_QUEUE_DEPTH.set(len(self._heap))
                    self._cv.notify_all()
                    return job
                self._busy_regions.add(job.region_id)
                self._region_owner[job.region_id] = me
            try:
                self._run_job(job)
            finally:
                with self._cv:
                    self._busy_regions.discard(job.region_id)
                    self._region_owner.pop(job.region_id, None)
                    self._cv.notify_all()
        return job

    def _remember(self, job: Job) -> None:
        # under self._cv
        self._jobs[job.job_id] = job
        while len(self._jobs) > HISTORY_LIMIT:
            oldest = next(iter(self._jobs))
            if not self._jobs[oldest].terminal:
                break  # never forget a live job
            self._jobs.popitem(last=False)

    # ---- inspection ---------------------------------------------------------

    def job(self, job_id: int) -> Optional[Job]:
        with self._cv:
            return self._jobs.get(job_id)

    def jobs(self) -> list[Job]:
        """Newest first."""
        with self._cv:
            return list(reversed(self._jobs.values()))

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._heap)

    def wait(self, job_id: int, timeout: Optional[float] = None) -> Job:
        """Block until the job reaches a terminal state (tests + inline
        callers); returns the job either way on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"unknown maintenance job {job_id}")
            while not job.terminal:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                self._cv.wait(left if left is not None else 0.5)
            return job

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Wait until no job is queued or running (tests/shutdown)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._heap or self._busy_regions:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    # ---- rollup rule registry ----------------------------------------------

    @staticmethod
    def _check_slot_collisions(rules) -> None:
        """Two distinct resolutions hashing to the same companion slot
        would share one plane region and double-count each other's
        leftover buckets — refuse loudly instead of corrupting results
        (~0.2% chance per pair; pick a different resolution)."""
        from greptimedb_tpu_torch.maintenance.rollup import rule_slot

        seen: dict[int, int] = {}
        for r in rules:
            slot = rule_slot(r.resolution_ms)
            other = seen.get(slot)
            if other is not None and other != r.resolution_ms:
                raise ValueError(
                    f"rollup resolutions {other}ms and "
                    f"{r.resolution_ms}ms collide on companion slot "
                    f"{slot}; choose a different resolution")
            seen[slot] = r.resolution_ms

    def _rules_path(self):
        data_dir = getattr(getattr(self.engine, "config", None),
                           "data_dir", None)
        if not data_dir:
            return None
        return os.path.join(data_dir, "maintenance_rules.json")

    def _load_adhoc_rules(self) -> list:
        from greptimedb_tpu_torch.maintenance.rollup import RollupRule

        path = self._rules_path()
        if path is None:
            return []
        if not os.path.exists(path):
            return []
        try:
            with open(path, encoding="utf-8") as f:
                return [RollupRule.from_dict(d)
                        for d in json.load(f).get("rollup", [])]
        except (OSError, ValueError):
            return []

    def _persist_adhoc_rule(self, rule) -> None:
        """Record an ADMIN-registered rule next to FORMAT.json so the
        next boot keeps substituting over its plane SSTs."""
        path = self._rules_path()
        if path is None:
            return
        known = {r.resolution_ms: r for r in self._load_adhoc_rules()}
        known[rule.resolution_ms] = rule
        payload = {"rollup": [
            {"resolution_ms": r.resolution_ms, "fields": list(r.fields),
             "auto": r.auto}
            for r in known.values()]}
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            pass  # best-effort: the rule still works this process

    def rule_for(self, resolution_ms: int):
        """(rule_slot, rule) for a resolution, registering (and
        persisting) an ad-hoc rule when no configured one matches
        (ADMIN rollup_table('t', '5m'))."""
        from greptimedb_tpu_torch.maintenance.rollup import RollupRule, rule_slot

        with self._cv:
            for r in self.rollup_rules:
                if r.resolution_ms == resolution_ms:
                    return rule_slot(resolution_ms), r
            # auto=False: an operator's one-off ADMIN rollup must enable
            # substitution, not sign every region up for recurring
            # re-encodes on each tick
            rule = RollupRule(resolution_ms=resolution_ms, auto=False)
            self._check_slot_collisions(self.rollup_rules + [rule])
            self.rollup_rules.append(rule)
        self._persist_adhoc_rule(rule)
        return rule_slot(resolution_ms), rule

    # ---- worker pool --------------------------------------------------------

    def _pop_eligible(self) -> Optional[Job]:
        # under self._cv: highest-priority job whose region is idle.
        # The heap array only orders index 0, so scan a SORTED view —
        # otherwise a busy head could hand the slot to a lower-priority
        # sibling while an eligible flush waits
        for entry in sorted(self._heap):
            job = entry[2]
            if job.region_id not in self._busy_regions:
                self._heap.remove(entry)
                heapq.heapify(self._heap)
                key = (job.kind, job.region_id,
                       tuple(sorted(job.params.items())))
                self._queued_keys.pop(key, None)
                MAINTENANCE_QUEUE_DEPTH.set(len(self._heap))
                return job
        return None

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                job = self._pop_eligible()
                while job is None:
                    if self._stopping:
                        return
                    # every submit, job end and stop() notifies; the
                    # timeout is a re-check, not the wakeup mechanism
                    self._cv.wait(5.0)
                    job = self._pop_eligible()
                self._busy_regions.add(job.region_id)
                self._region_owner[job.region_id] = threading.get_ident()
            try:
                self._run_job(job)
            finally:
                with self._cv:
                    self._busy_regions.discard(job.region_id)
                    self._region_owner.pop(job.region_id, None)
                    self._cv.notify_all()

    def _run_job(self, job: Job) -> None:
        job.state = "running"
        job.started_at = time.time()
        t0 = time.perf_counter()
        try:
            # chaos seam: a seeded schedule can fail or delay any job
            # class before it touches region state
            FAULTS.fire("maintenance.job", op=job.kind, phase="start")
            self._execute(job)
            job.state = "done"
        except Exception as e:  # noqa: BLE001 — a job must never kill a worker
            job.state = "failed"
            job.error = f"{type(e).__name__}: {e}"
            logger.warning("maintenance job %d (%s region=%d) failed: %s",
                           job.job_id, job.kind, job.region_id, job.error)
        finally:
            job.finished_at = time.time()
            MAINTENANCE_JOBS.inc(kind=job.kind, status=job.state)
            MAINTENANCE_JOB_SECONDS.observe(time.perf_counter() - t0,
                                            kind=job.kind)
            with self._cv:
                if job.state == "done" and job.params.get("auto") and \
                        job.detail.get("noop"):
                    # periodic-tick no-ops would otherwise flood the
                    # bounded history and evict real failure records
                    self._jobs.pop(job.job_id, None)
                self._cv.notify_all()

    def _execute(self, job: Job) -> None:
        region = self.engine.region(job.region_id)
        if job.kind == "flush":
            meta = region.flush()
            job.detail = {**job.detail, "flushed_rows":
                          0 if meta is None else meta.num_rows}
            # TWCS follow-up: only when flushing actually tipped a
            # window over its file limit (an unconditional submission
            # would churn the queue and make ADMIN job ids racy)
            if TwcsPicker().pick(list(region.files.values())):
                self.submit("compact", job.region_id)
        elif job.kind == "compact":
            out = region.compact(strategy=job.params.get("strategy", "twcs"))
            job.detail = {**job.detail, "merged_files": len(out)}
        elif job.kind == "rollup":
            from greptimedb_tpu_torch.maintenance.rollup import run_rollup_job

            idx, rule = self.rule_for(
                parse_duration_ms(job.params.get("resolution",
                                                 "60s")))
            job.detail = {**job.detail, **run_rollup_job(
                self.engine, job.region_id, idx, rule)}
        elif job.kind == "expire":
            from greptimedb_tpu_torch.maintenance.retention import run_expiry

            ttl_ms = int(job.params.get("ttl_ms", 0)) \
                or self.retention_ttl_ms
            job.detail = {**job.detail, **run_expiry(region, ttl_ms)}
            if not job.detail.get("removed"):
                job.detail = {**job.detail, "noop": True}
            else:
                # raw data below the cutoff is gone: rollup coverage
                # claiming that span must retreat too, or substituted
                # aggregates would resurrect TTL-deleted rows
                self._truncate_rollup_coverage(
                    job.region_id, region, job.detail.get("cutoff"))
        else:  # pragma: no cover — submit() validates kinds
            raise ValueError(f"unknown job kind {job.kind!r}")

    def _truncate_rollup_coverage(self, rid: int, region,
                                  cutoff) -> None:
        """Raise every companion's cov_lo to the expiry cutoff (rounded
        UP to the rule's resolution: a partially-expired bucket is no
        longer fully aggregatable from raw, so it must not be served)."""
        if cutoff is None:
            return
        from greptimedb_tpu_torch.maintenance.retention import ms_to_units
        from greptimedb_tpu_torch.maintenance.rollup import (
            read_state,
            rollup_region_id,
            rule_slot,
            write_state,
        )

        dtype = region.schema.time_index.dtype
        for rule in list(self.rollup_rules):
            rrid = rollup_region_id(rid, rule_slot(rule.resolution_ms))
            try:
                self.engine.region(rrid)
            except KeyError:
                try:
                    self.engine.open_region(rrid)
                except FileNotFoundError:  # no companion yet
                    continue
            companion = self.engine.region(rrid)
            store = region.store
            state = read_state(store, companion.region_dir)
            if state is None or state["cov_lo"] >= cutoff:
                continue
            r_units = max(1, ms_to_units(rule.resolution_ms, dtype))
            aligned = -(-int(cutoff) // r_units) * r_units  # ceil
            state["cov_lo"] = min(aligned, state["cov_hi"])
            # TTL horizon: later rollup runs must not re-roll (and
            # re-claim) below this, or a straddling SST's ts_min would
            # read as "older data appeared" and undo the retreat with a
            # full-span re-encode on every expiry
            state["expired_lo"] = max(int(aligned),
                                      int(state.get("expired_lo", 0)))
            write_state(store, companion.region_dir, state)

    # ---- periodic tick ------------------------------------------------------

    def tick(self) -> int:
        """One maintenance sweep over every open region: submit flush for
        over-threshold memtables, compaction where a window exceeds its
        file limit, rollup for configured rules, and expiry when a TTL is
        set. Returns the number of jobs submitted. Runs from the ticker
        thread; tests call it directly."""
        from greptimedb_tpu_torch.maintenance.rollup import ROLLUP_RID_FLAG

        n = 0
        threshold = getattr(self.engine.config, "flush_threshold_bytes",
                            256 << 20)
        for rid, region in list(getattr(self.engine, "regions", {}).items()):
            try:
                if region.memtable_bytes >= threshold:
                    self.submit("flush", rid)
                    n += 1
                files = list(region.files.values())
                if len(files) > 1 and TwcsPicker().pick(files):
                    self.submit("compact", rid)
                    n += 1
                if rid & ROLLUP_RID_FLAG:
                    # companion regions get flush/compact hygiene only:
                    # rolling a rollup would nest planes without bound,
                    # and expiring planes out from under a coverage
                    # claim would serve wrong substituted results
                    continue
                for rule in list(self.rollup_rules):
                    if rule.auto:
                        self.submit("rollup", rid, {
                            "resolution": rule.resolution_ms,
                            "auto": True})
                        n += 1
                if self.retention_ttl_ms > 0:
                    self.submit("expire", rid, {"auto": True})
                    n += 1
            except RuntimeError:  # stop() ran mid-sweep: submit refuses
                break
        return n

    def _tick_loop(self) -> None:
        while not self._stopping:
            with self._cv:
                self._cv.wait(self.tick_interval_s)
                if self._stopping:
                    return
            try:
                self.tick()
            except Exception:  # noqa: BLE001
                logger.exception("maintenance tick failed")

    # ---- lifecycle ----------------------------------------------------------

    def stop(self) -> None:
        """Let running jobs finish, drop the queued ones and join every
        worker and the tick thread. Queued-but-unstarted jobs are
        dropped: flush durability is the WAL's job, and reopen replays
        it."""
        with self._cv:
            self._stopping = True
            for _, _, job in self._heap:
                job.state = "failed"
                job.error = "scheduler stopped"
                job.finished_at = time.time()
            self._heap.clear()
            self._queued_keys.clear()
            MAINTENANCE_QUEUE_DEPTH.set(0)
            self._cv.notify_all()
        for t in self._workers:
            t.join()
        if self._ticker is not None:
            self._ticker.join()
