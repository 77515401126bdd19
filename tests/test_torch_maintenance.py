"""The port's maintenance plane (greptimedb_tpu_torch/maintenance/), on
the CPU: twins of tests/test_maintenance.py (scheduler, async flush and
write stalls, TWCS picker edges, rollup substitution, retention expiry,
crash mid-swap, the ADMIN job-id flow) run on the port, and the rollup
planes and substituted SQL held to the JAX package on the same seeded
inputs: the planes' rows, counts, minima and maxima bit for bit (groups
of only +-inf values included), sums to rtol 1e-12, and substituted rows
equal to raw rows in both packages."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.fault import FAULTS, Fault
from greptimedb_tpu_torch.maintenance import parse_duration_ms
from greptimedb_tpu_torch.maintenance.rollup import (
    rollup_region_id,
    rollup_schema,
)
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.compaction import (
    TIME_BUCKETS_S,
    TwcsOptions,
    TwcsPicker,
    infer_time_window_ms,
)
from greptimedb_tpu_torch.storage.sst import FileMeta

HOUR_MS = 3_600_000


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def fm(i, ts_min, ts_max, level=0):
    return FileMeta(file_id=f"f{i}", num_rows=100, ts_min=ts_min,
                    ts_max=ts_max, max_seq=i, level=level)


def make_db(tmp_path, **cfg):
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path), **cfg),
                          device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    return engine, qe


def ingest(qe, hosts=3, points=180, step_ms=1000, t0=0):
    rows = []
    for h in range(hosts):
        for i in range(points):
            rows.append(f"('h{h}', {float((h + 1) * (i % 7))}, "
                        f"{t0 + i * step_ms})")
    qe.execute_one("INSERT INTO cpu (host, v, ts) VALUES " + ",".join(rows))


def create_cpu(qe):
    qe.execute_one(
        "CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) "
        "TIME INDEX, PRIMARY KEY(host))")


def wait_jobs(qe, result, timeout=30):
    maint = qe.region_engine.maintenance
    return [maint.wait(int(r[0]), timeout=timeout) for r in result.rows()]


# ---- TwcsPicker edge cases (satellite) -------------------------------------


class TestTwcsPickerEdges:
    def test_empty_and_single_file(self):
        picker = TwcsPicker(TwcsOptions(time_window_ms=HOUR_MS))
        assert picker.pick([]) == []
        assert picker.pick([fm(1, 0, 100)]) == []

    def test_ts_max_exactly_on_window_boundary(self):
        """A file whose ts_max sits exactly on k*window belongs to window
        k (floor division) — it must NOT be grouped with window k-1."""
        picker = TwcsPicker(TwcsOptions(time_window_ms=HOUR_MS,
                                        max_inactive_window_files=1))
        boundary = fm(3, HOUR_MS - 50, HOUR_MS)  # exactly on the edge
        w0 = [fm(1, 0, 100), fm(2, 50, 200)]
        active = [fm(4, 3 * HOUR_MS, 3 * HOUR_MS + 1)]
        groups = picker.pick(w0 + [boundary] + active)
        # window 0 compacts alone; the boundary file is window 1's only
        # file and stays out of every group
        assert len(groups) == 1
        assert {f.file_id for f in groups[0]} == {"f1", "f2"}

    def test_inferred_window_straddles_bucket_entries(self):
        """Median span between TIME_BUCKETS_S entries picks the next
        bucket UP; beyond the largest clamps to the largest."""
        mid_s = (TIME_BUCKETS_S[0] + TIME_BUCKETS_S[1]) // 2  # 1h..2h
        files = [fm(1, 0, mid_s * 1000)]
        assert infer_time_window_ms(files) == TIME_BUCKETS_S[1] * 1000
        huge = [fm(1, 0, 2 * TIME_BUCKETS_S[-1] * 1000)]
        assert infer_time_window_ms(huge) == TIME_BUCKETS_S[-1] * 1000
        # exactly equal to a bucket span stays in that bucket
        exact = [fm(1, 0, TIME_BUCKETS_S[2] * 1000)]
        assert infer_time_window_ms(exact) == TIME_BUCKETS_S[2] * 1000

    def test_max_active_window_files_off_by_one(self):
        """The active window tolerates EXACTLY max_active_window_files;
        one more triggers the merge."""
        picker = TwcsPicker(TwcsOptions(time_window_ms=HOUR_MS,
                                        max_active_window_files=3))
        at_limit = [fm(i, 0, 1000 + i) for i in range(3)]
        assert picker.pick(at_limit) == []
        over = at_limit + [fm(9, 0, 2000)]
        groups = picker.pick(over)
        assert len(groups) == 1 and len(groups[0]) == 4

    def test_mixed_windows_multiple_groups(self):
        picker = TwcsPicker(TwcsOptions(time_window_ms=HOUR_MS,
                                        max_active_window_files=1))
        w0 = [fm(1, 0, 100), fm(2, 50, 200)]
        w2 = [fm(3, 2 * HOUR_MS, 2 * HOUR_MS + 10),
              fm(4, 2 * HOUR_MS + 5, 2 * HOUR_MS + 20)]
        groups = picker.pick(w0 + w2)
        assert len(groups) == 2
        assert {f.file_id for f in groups[0]} == {"f1", "f2"}
        assert {f.file_id for f in groups[1]} == {"f3", "f4"}


# ---- scheduler --------------------------------------------------------------


class TestScheduler:
    def test_submit_dedup_and_ids(self, tmp_path):
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        ingest(qe, points=10)
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        maint = engine.maintenance
        # hold the worker busy so queued jobs stay queued
        FAULTS.arm("maintenance.job",
                   Fault(kind="latency", arg=0.3, match={"phase": "start"}))
        j1 = maint.submit("flush", rid)
        j2 = maint.submit("flush", rid)  # identical while queued/held
        assert j2.job_id in (j1.job_id, j1.job_id + 1)
        maint.wait_idle(timeout=10)
        assert maint.wait(j1.job_id, timeout=10).state == "done"
        engine.close()

    def test_priority_flush_before_expire(self, tmp_path):
        engine, qe = make_db(tmp_path, maintenance_workers=1)
        create_cpu(qe)
        ingest(qe, points=10)
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        maint = engine.maintenance
        # first job occupies the single worker; the next two queue and
        # must pop in priority order (flush before expire) despite
        # submission order
        FAULTS.arm("maintenance.job",
                   Fault(kind="latency", arg=0.25, nth=1,
                         match={"phase": "start"}))
        blocker = maint.submit("compact", rid, {"strategy": "full"})
        time.sleep(0.05)
        e = maint.submit("expire", rid, {"ttl_ms": 10 ** 15})
        f = maint.submit("flush", rid)
        maint.wait(blocker.job_id, timeout=10)
        maint.wait(e.job_id, timeout=10)
        maint.wait(f.job_id, timeout=10)
        assert f.started_at <= e.started_at
        engine.close()

    def test_queue_full_runs_inline(self, tmp_path):
        engine, qe = make_db(tmp_path, maintenance_workers=1,
                             maintenance_queue=1)
        create_cpu(qe)
        ingest(qe, points=10)
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        maint = engine.maintenance
        FAULTS.arm("maintenance.job",
                   Fault(kind="latency", arg=0.3, nth=1,
                         match={"phase": "start"}))
        maint.submit("compact", rid, {"strategy": "full"})  # occupies worker
        time.sleep(0.05)
        maint.submit("expire", rid, {"ttl_ms": 10 ** 15})  # fills queue
        j = maint.submit("flush", rid)  # full -> inline on this thread
        assert j.terminal and j.detail.get("inline")
        engine.close()

    def test_tick_submits_threshold_jobs(self, tmp_path):
        engine, qe = make_db(
            tmp_path, flush_threshold_bytes=1,
            rollup_rules=[{"resolution_ms": 60_000}],
            retention_ttl_ms=10 ** 15)
        create_cpu(qe)
        ingest(qe)  # 3 minutes of data: a real inactive window to roll
        maint = engine.maintenance
        n = maint.tick()
        # rollup + expire from the tick (the write path already
        # submitted the flush when the 1-byte threshold tripped)
        assert n >= 2
        maint.wait_idle(timeout=30)
        kinds = {j.kind for j in maint.jobs()}
        # the expire was a no-op auto job: dropped from history so tick
        # churn can't evict real records
        assert {"flush", "rollup"} <= kinds
        assert not any(j.kind == "expire" for j in maint.jobs())
        engine.close()

    def test_colliding_rule_slots_refused(self, tmp_path):
        """Two resolutions hashing to one companion slot would share a
        plane region and double-count — refused loudly at boot."""
        with pytest.raises(ValueError, match="collide"):
            RegionEngine(EngineConfig(
                data_dir=str(tmp_path),
                rollup_rules=[{"resolution_ms": 6_000},
                              {"resolution_ms": 31_000}]), device="cpu")

    def test_failed_job_records_error(self, tmp_path):
        engine, qe = make_db(tmp_path)
        maint = engine.maintenance
        j = maint.submit("flush", 424242)  # region not open
        maint.wait(j.job_id, timeout=10)
        assert j.state == "failed" and "424242" in j.error
        engine.close()


# ---- async flush + write stall ---------------------------------------------


class TestAsyncFlushAndStall:
    def test_threshold_write_submits_flush_async(self, tmp_path):
        engine, qe = make_db(tmp_path, flush_threshold_bytes=1)
        create_cpu(qe)
        ingest(qe, points=50)
        maint = engine.maintenance
        assert maint.wait_idle(timeout=30)
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        region = engine.region(rid)
        assert region.files  # the plane flushed, not the writer
        assert any(j.kind == "flush" and j.state == "done"
                   for j in maint.jobs())
        assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[150]]
        engine.close()

    def test_writers_do_not_block_below_stall_threshold(self, tmp_path):
        """Acceptance: a running compaction must not add latency to
        writers under the stall threshold."""
        engine, qe = make_db(tmp_path, maintenance_workers=2)
        create_cpu(qe)
        ingest(qe, points=20)
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        engine.region(rid).flush()
        ingest(qe, points=20, t0=10 ** 6)
        engine.region(rid).flush()
        maint = engine.maintenance
        from greptimedb_tpu_torch.utils.metrics import WRITE_STALL_SECONDS

        stalled_before = WRITE_STALL_SECONDS.total()
        FAULTS.arm("maintenance.job",
                   Fault(kind="latency", arg=5.0,
                         match={"op": "compact", "phase": "start"}))
        slow = maint.submit("compact", rid, {"strategy": "full"})
        for i in range(15):
            qe.execute_one(
                f"INSERT INTO cpu (host, v, ts) VALUES ('w', 1.0, "
                f"{2 * 10 ** 6 + i})")
        # the invariant: every write completed while the compaction was
        # still in flight — no writer waited for it, and none stalled
        assert slow.state in ("queued", "running"), \
            "writes outlasted a 5s compaction: they must have blocked"
        assert WRITE_STALL_SECONDS.total() == stalled_before
        maint.wait(slow.job_id, timeout=30)
        assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[135]]
        engine.close()

    def test_hard_threshold_stalls_and_counts(self, tmp_path):
        engine, qe = make_db(
            tmp_path, flush_threshold_bytes=64,
            stall_memtable_bytes=128, stall_timeout_s=0.3)
        create_cpu(qe)
        maint = engine.maintenance
        # wedge the flush path so the stall engages until its timeout
        FAULTS.arm("maintenance.job",
                   Fault(kind="latency", arg=2.0,
                         match={"op": "flush", "phase": "start"}))
        from greptimedb_tpu_torch.utils.metrics import WRITE_STALL_SECONDS

        before = WRITE_STALL_SECONDS.total()
        ingest(qe, hosts=2, points=40)  # far past both thresholds
        assert WRITE_STALL_SECONDS.total() > before
        # the inline escape hatch kept memory bounded and data intact
        assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[80]]
        engine.close()


# ---- rollup ----------------------------------------------------------------


ROLLUP_SQL = (
    "SELECT host, date_bin(INTERVAL '1 minute', ts) AS b, min(v), max(v), "
    "count(v), sum(v), avg(v), count(*) FROM cpu "
    "WHERE ts >= 0 AND ts < 120000 GROUP BY host, b ORDER BY host, b")


def rollup_db(tmp_path, **cfg):
    cfg.setdefault("rollup_rules", [{"resolution_ms": 60_000}])
    engine, qe = make_db(tmp_path, **cfg)
    create_cpu(qe)
    ingest(qe)  # 3 hosts x 180s @1s: two full minutes + active minute
    wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
    return engine, qe


def run_rollup(qe):
    jobs = wait_jobs(qe, qe.execute_one("ADMIN rollup_table('cpu', '1m')"))
    assert all(j.state == "done" for j in jobs), [j.error for j in jobs]
    return jobs


class TestRollup:
    def oracle(self, qe, sql, monkeypatch):
        monkeypatch.setenv("GTPU_ROLLUP_SUBSTITUTE", "0")
        try:
            return qe.execute_one(sql)
        finally:
            monkeypatch.setenv("GTPU_ROLLUP_SUBSTITUTE", "1")

    def test_bit_for_bit_vs_raw_oracle(self, tmp_path, monkeypatch):
        engine, qe = rollup_db(tmp_path)
        jobs = run_rollup(qe)
        assert jobs[0].detail["rows_out"] > 0
        raw = self.oracle(qe, ROLLUP_SQL, monkeypatch)
        sub = qe.execute_one(ROLLUP_SQL)
        assert "+rollup" in (qe.executor.last_path or "")
        assert raw.rows() == sub.rows()
        assert raw.names == sub.names
        engine.close()

    def test_coarser_bucket_and_tag_filter(self, tmp_path, monkeypatch):
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        sql = ("SELECT date_bin(INTERVAL '2 minutes', ts) AS b, max(v), "
               "count(*) FROM cpu WHERE ts >= 0 AND ts < 120000 "
               "AND host = 'h1' GROUP BY b ORDER BY b")
        raw = self.oracle(qe, sql, monkeypatch)
        sub = qe.execute_one(sql)
        assert "+rollup" in (qe.executor.last_path or "")
        assert raw.rows() == sub.rows()
        # tags-only grouping is eligible too
        sql2 = ("SELECT host, min(v), count(v) FROM cpu "
                "WHERE ts >= 60000 AND ts < 120000 GROUP BY host "
                "ORDER BY host")
        raw2 = self.oracle(qe, sql2, monkeypatch)
        sub2 = qe.execute_one(sql2)
        assert "+rollup" in (qe.executor.last_path or "")
        assert raw2.rows() == sub2.rows()
        engine.close()

    def test_ineligible_falls_back_to_raw(self, tmp_path):
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        cases = [
            # unaligned lower bound
            "SELECT host, max(v) FROM cpu WHERE ts >= 500 AND ts < 60000 "
            "GROUP BY host",
            # range reaches into the active (uncovered) window
            "SELECT host, max(v) FROM cpu WHERE ts >= 0 AND ts < 180000 "
            "GROUP BY host",
            # unbounded range
            "SELECT host, max(v) FROM cpu GROUP BY host",
            # aggregate with no plane form
            "SELECT host, stddev(v) FROM cpu WHERE ts >= 0 AND "
            "ts < 60000 GROUP BY host",
            # field predicate cannot evaluate over plane rows
            "SELECT host, max(v) FROM cpu WHERE ts >= 0 AND ts < 60000 "
            "AND v > 1.0 GROUP BY host",
            # bucket not a multiple of the resolution
            "SELECT date_bin(INTERVAL '90 seconds', ts) AS b, max(v) "
            "FROM cpu WHERE ts >= 0 AND ts < 60000 GROUP BY b",
        ]
        for sql in cases:
            qe.execute_one(sql)
            assert "+rollup" not in (qe.executor.last_path or ""), sql
        engine.close()

    def test_late_write_disables_then_reroll_restores(self, tmp_path,
                                                      monkeypatch):
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        qe.execute_one(ROLLUP_SQL)
        assert "+rollup" in (qe.executor.last_path or "")
        # out-of-order write into a covered window: substitution must
        # turn itself off (the planes are stale)
        qe.execute_one(
            "INSERT INTO cpu (host, v, ts) VALUES ('h0', 99.0, 30000)")
        raw = self.oracle(qe, ROLLUP_SQL, monkeypatch)
        got = qe.execute_one(ROLLUP_SQL)
        assert "+rollup" not in (qe.executor.last_path or "")
        assert got.rows() == raw.rows()
        # re-rolling re-covers the window (LWW overwrites the planes)
        run_rollup(qe)
        sub = qe.execute_one(ROLLUP_SQL)
        assert "+rollup" in (qe.executor.last_path or "")
        assert sub.rows() == self.oracle(qe, ROLLUP_SQL, monkeypatch).rows()
        engine.close()

    def test_old_data_below_coverage_rerolls_whole_span(self, tmp_path,
                                                        monkeypatch):
        """Data appearing BELOW the covered span must trigger a full
        re-roll — coverage must never be claimed over a span that was
        not aggregated (the cov_lo-lowering bug)."""
        engine, qe = make_db(
            tmp_path, rollup_rules=[{"resolution_ms": 60_000}])
        create_cpu(qe)
        ingest(qe, t0=600_000)  # minutes 10..13
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        run_rollup(qe)  # coverage [600000, 720000)
        # older rows arrive below the covered floor, then get flushed
        ingest(qe, points=60, t0=0)  # minute 0
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        run_rollup(qe)
        sql = ("SELECT host, date_bin(INTERVAL '1 minute', ts) AS b, "
               "min(v), max(v), sum(v), count(*) FROM cpu "
               "WHERE ts >= 0 AND ts < 720000 GROUP BY host, b "
               "ORDER BY host, b")
        raw = self.oracle(qe, sql, monkeypatch)
        sub = qe.execute_one(sql)
        assert "+rollup" in (qe.executor.last_path or "")
        assert sub.rows() == raw.rows()
        engine.close()

    def test_rollup_survives_reopen(self, tmp_path, monkeypatch):
        engine, qe = rollup_db(tmp_path, rollup_rules=[])
        run_rollup(qe)  # ADMIN registers (and persists) the ad-hoc rule
        raw = self.oracle(qe, ROLLUP_SQL, monkeypatch).rows()
        engine.close()
        # NO configured rules: the persisted ad-hoc rule must be merged
        # back at boot so the planes keep serving after a restart
        engine2 = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                               device="cpu")
        assert any(r.resolution_ms == 60_000
                   for r in engine2.maintenance.rollup_rules)
        qe2 = QueryEngine(Catalog(MemoryKv()), engine2, device="cpu")
        create_cpu(qe2)  # catalog is fresh; region dir is reused
        sub = qe2.execute_one(ROLLUP_SQL)
        assert "+rollup" in (qe2.executor.last_path or "")
        assert sub.rows() == raw
        engine2.close()

    def test_deleted_group_not_resurrected_by_reroll(self, tmp_path,
                                                     monkeypatch):
        """Deleting every raw row of a group must propagate to the
        planes on re-roll: the companion's stale row is tombstoned, not
        left behind for substitution to resurrect."""
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        qe.execute_one("DELETE FROM cpu WHERE host = 'h1'")
        run_rollup(qe)  # re-roll tombstones h1's plane rows
        raw = self.oracle(qe, ROLLUP_SQL, monkeypatch)
        sub = qe.execute_one(ROLLUP_SQL)
        assert "+rollup" in (qe.executor.last_path or "")
        assert sub.rows() == raw.rows()
        hosts = {r[0] for r in sub.rows()}
        assert "h1" not in hosts and hosts == {"h0", "h2"}
        engine.close()

    def test_count_over_empty_covered_range(self, tmp_path, monkeypatch):
        """A covered range holding NO plane rows must substitute to
        count 0, not cast-NaN garbage (int64 min)."""
        engine, qe = make_db(
            tmp_path, rollup_rules=[{"resolution_ms": 60_000}])
        create_cpu(qe)
        qe.execute_one(
            "INSERT INTO cpu (host, v, ts) VALUES ('a', 1.0, 1000), "
            "('a', 2.0, 600000), ('a', 3.0, 660000)")
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        run_rollup(qe)
        # minutes 2..4 are inside coverage but hold no data
        sql = ("SELECT count(*), count(v), sum(v) FROM cpu "
               "WHERE ts >= 120000 AND ts < 240000")
        raw = self.oracle(qe, sql, monkeypatch)
        sub = qe.execute_one(sql)
        assert "+rollup" in (qe.executor.last_path or "")
        assert sub.rows() == raw.rows() == [[0, 0, None]]
        engine.close()

    def test_tick_never_rolls_companion_regions(self, tmp_path):
        """Periodic ticks must not submit rollup/expire for companion
        regions — rolling a rollup would nest plane regions forever."""
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        maint = engine.maintenance
        regions_after_rollup = set(engine.regions)
        for _ in range(3):
            maint.tick()
            assert maint.wait_idle(timeout=30)
        assert set(engine.regions) == regions_after_rollup
        # and no plane-of-plane schemas anywhere
        for region in engine.regions.values():
            assert not any("__min__" in n or "__sum__" in n
                           for n in region.schema.names)
        engine.close()

    def test_truncate_invalidates_rollup_coverage(self, tmp_path):
        """TRUNCATE must take the planes down: substituted aggregates
        over the old coverage would otherwise resurrect truncated
        rows."""
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        qe.execute_one("TRUNCATE TABLE cpu")
        sql = ("SELECT count(*) FROM cpu WHERE ts >= 0 AND ts < 120000")
        got = qe.execute_one(sql)
        assert "+rollup" not in (qe.executor.last_path or "")
        assert got.rows() == [[0]]
        engine.close()

    def test_drop_table_drops_companions(self, tmp_path):
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        from greptimedb_tpu_torch.maintenance.rollup import ROLLUP_RID_FLAG

        assert any(rid & ROLLUP_RID_FLAG for rid in engine.regions)
        qe.execute_one("DROP TABLE cpu")
        assert not any(rid & ROLLUP_RID_FLAG for rid in engine.regions)
        engine.close()

    def test_alter_add_column_keeps_substitution_safe(self, tmp_path,
                                                      monkeypatch):
        """Post-ALTER queries on a new column must not crash on the
        stale companion schema; the next rollup migrates the planes."""
        engine, qe = rollup_db(tmp_path)
        run_rollup(qe)
        qe.execute_one("ALTER TABLE cpu ADD COLUMN w DOUBLE")
        sql = ("SELECT sum(w) FROM cpu WHERE ts >= 0 AND ts < 120000")
        raw = self.oracle(qe, sql, monkeypatch)
        got = qe.execute_one(sql)  # pre-fix: PlanError (w__sum missing)
        assert got.rows() == raw.rows()
        # a re-roll migrates the companion schema; w is all-NULL so the
        # substituted sum stays NULL like the raw one
        run_rollup(qe)
        sub = qe.execute_one(sql)
        assert sub.rows() == raw.rows()
        engine.close()

    def test_rollup_schema_planes(self):
        from greptimedb_tpu_torch.datatypes.schema import Schema
        from greptimedb_tpu_torch.datatypes.types import DataType

        engine_schema = Schema.from_dict({"columns": [
            {"name": "host", "dtype": "string", "semantic": "tag",
             "nullable": True, "default": None},
            {"name": "ts", "dtype": "timestamp_ms", "semantic": "timestamp",
             "nullable": False, "default": None},
            {"name": "v", "dtype": "float64", "semantic": "field",
             "nullable": True, "default": None},
            {"name": "note", "dtype": "string", "semantic": "field",
             "nullable": True, "default": None},
        ]})
        rs = rollup_schema(engine_schema)
        names = rs.names
        # string fields get no planes; numeric fields get all four
        assert "v__min" in names and "v__count" in names
        assert not any(n.startswith("note__") for n in names)
        assert rs.column("v__sum").dtype is DataType.FLOAT64
        assert rs.column("v__count").dtype is DataType.INT64
        assert rs.column("rows__count").dtype is DataType.INT64


# ---- retention expiry -------------------------------------------------------


class TestRetention:
    def test_expiry_drops_whole_ssts_atomically(self, tmp_path):
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        rid_ms = int(time.time() * 1000)
        old = rid_ms - 10 * 86_400_000
        qe.execute_one(
            f"INSERT INTO cpu (host, v, ts) VALUES ('a', 1.0, {old}), "
            f"('a', 2.0, {old + 1000})")
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        qe.execute_one(
            f"INSERT INTO cpu (host, v, ts) VALUES ('a', 3.0, {rid_ms})")
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        assert len(engine.region(rid).files) == 2
        jobs = wait_jobs(qe, qe.execute_one("ADMIN expire_table('cpu', '7d')"))
        assert jobs[0].state == "done" and jobs[0].detail["removed"] == 1
        assert len(engine.region(rid).files) == 1
        assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[1]]
        engine.close()
        # the manifest edit is durable: reopen sees the post-expiry list
        engine2 = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                               device="cpu")
        engine2.open_region(rid)
        assert len(engine2.region(rid).files) == 1
        engine2.close()

    def test_expiry_truncates_rollup_coverage(self, tmp_path, monkeypatch):
        """TTL-deleted raw data must not be resurrected by rollup
        substitution: expiry retreats the companion's coverage."""
        engine, qe = make_db(
            tmp_path, rollup_rules=[{"resolution_ms": 60_000}])
        create_cpu(qe)
        ingest(qe)  # epoch-1970 timestamps: ancient vs wall-clock now
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        jobs = wait_jobs(qe, qe.execute_one("ADMIN rollup_table('cpu', '1m')"))
        assert jobs[0].detail["rows_out"] > 0
        sql = ("SELECT host, max(v), count(*) FROM cpu "
               "WHERE ts >= 0 AND ts < 120000 GROUP BY host ORDER BY host")
        assert qe.execute_one(sql).num_rows == 3  # planes serving
        jobs = wait_jobs(qe, qe.execute_one("ADMIN expire_table('cpu', '1d')"))
        assert jobs[0].detail["removed"] >= 1
        got = qe.execute_one(sql)
        assert "+rollup" not in (qe.executor.last_path or "")
        # raw truth after expiry: nothing left in that span
        monkeypatch.setenv("GTPU_ROLLUP_SUBSTITUTE", "0")
        oracle = qe.execute_one(sql)
        assert got.rows() == oracle.rows()
        engine.close()

    def test_straddling_sst_is_kept(self, tmp_path):
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        now = int(time.time() * 1000)
        old = now - 10 * 86_400_000
        # one SST spanning old..new must survive (expiry is metadata-only)
        qe.execute_one(
            f"INSERT INTO cpu (host, v, ts) VALUES ('a', 1.0, {old}), "
            f"('a', 2.0, {now})")
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        jobs = wait_jobs(qe, qe.execute_one("ADMIN expire_table('cpu', '7d')"))
        assert jobs[0].detail["removed"] == 0
        assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[2]]
        engine.close()


class TestManifestSeqSafety:
    def test_expiry_and_compact_preserve_unflushed_wal(self, tmp_path):
        """Compaction/expiry manifest edits must NOT advance flushed_seq:
        doing so marks unflushed acknowledged writes replay-obsolete
        (acked-write loss on crash)."""
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        now = int(time.time() * 1000)
        old = now - 10 * 86_400_000
        qe.execute_one(
            f"INSERT INTO cpu (host, v, ts) VALUES ('a', 1.0, {old}), "
            f"('a', 2.0, {old + 1000})")
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        qe.execute_one(
            f"INSERT INTO cpu (host, v, ts) VALUES ('b', 3.0, {old + 2}), "
            f"('b', 4.0, {old + 3})")
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        # acknowledged but UNFLUSHED rows (WAL + memtable only)
        qe.execute_one(
            f"INSERT INTO cpu (host, v, ts) VALUES ('c', 5.0, {now})")
        # background maintenance runs while the memtable is dirty
        wait_jobs(qe, qe.execute_one("ADMIN compact_table('cpu')"))
        jobs = wait_jobs(qe, qe.execute_one("ADMIN expire_table('cpu', '7d')"))
        assert jobs[0].detail["removed"] >= 1
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        engine.close()  # close does NOT flush: the 'c' row lives in WAL
        engine2 = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                               device="cpu")
        engine2.open_region(rid)
        region = engine2.region(rid)
        scan = region.scan()
        assert scan is not None and scan.num_rows >= 1
        # the unflushed acknowledged row MUST survive replay
        vals = set(np.asarray(scan.columns["v"]).tolist())
        assert 5.0 in vals, vals
        engine2.close()


class TestSchedulerReentrancy:
    def test_reentrant_inline_submit_queues_instead_of_deadlocking(
            self, tmp_path):
        """A running job submitting a follow-up for its OWN region while
        the queue is full must queue past the bound, never inline-wait
        on itself (permanent worker wedge pre-fix)."""
        import threading

        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        ingest(qe, points=10)
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        maint = engine.maintenance
        maint.queue_size = 0  # every submission degrades to inline
        with maint._cv:  # simulate "this thread is running a job on rid"
            maint._busy_regions.add(rid)
            maint._region_owner[rid] = threading.get_ident()
        job = maint.submit("compact", rid)  # pre-fix: hangs forever here
        assert job.state == "queued"
        with maint._cv:
            maint._busy_regions.discard(rid)
            maint._region_owner.pop(rid, None)
            maint._cv.notify_all()
        assert maint.wait(job.job_id, timeout=15).terminal
        engine.close()


# ---- chaos: crash mid-manifest-swap ----------------------------------------


class TestCompactionCrashMidSwap:
    @pytest.mark.chaos
    def test_injected_failure_leaves_old_file_list(self, tmp_path):
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        ingest(qe, points=30)
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        region = engine.region(rid)
        region.flush()
        ingest(qe, points=30, t0=10 ** 6)
        region.flush()
        before = set(region.files)
        oracle = qe.execute_one("SELECT count(*), sum(v) FROM cpu").rows()
        FAULTS.arm("maintenance.job",
                   Fault(kind="fail",
                         match={"op": "compact", "phase": "swap"}))
        jobs = wait_jobs(qe, qe.execute_one("ADMIN compact_table('cpu')"))
        assert jobs[0].state == "failed"
        assert "injected" in jobs[0].error
        # pre-compaction list authoritative, data fully readable
        assert set(region.files) == before
        assert qe.execute_one("SELECT count(*), sum(v) FROM cpu").rows() \
            == oracle
        FAULTS.reset()
        # and the same region reopened from disk agrees
        engine.close()
        engine2 = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                               device="cpu")
        engine2.open_region(rid)
        assert set(engine2.region(rid).files) == before
        engine2.close()

    @pytest.mark.chaos
    def test_process_crash_mid_swap_loses_nothing(self, tmp_path):
        """The full crash shape: a real process dies mid-compaction-swap
        (fault fired between SST write and manifest edit, then hard
        exit); a fresh process must read every acknowledged row."""
        script = r"""
import os, sys
sys.path.insert(0, sys.argv[2])
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

data_dir = sys.argv[1]
engine = RegionEngine(EngineConfig(data_dir=data_dir,
                                   maintenance_workers=0), device="cpu")
qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
qe.execute_one("CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) "
               "TIME INDEX, PRIMARY KEY(host))")
for base in (0, 10**6):
    qe.execute_one("INSERT INTO cpu (host, v, ts) VALUES " + ",".join(
        f"('h{i % 3}', {float(i)}, {base + i})" for i in range(50)))
    engine.region(qe.catalog.table("public", "cpu").region_ids[0]).flush()
print("ACK", flush=True)
try:
    engine.compact(qe.catalog.table("public", "cpu").region_ids[0])
except BaseException as e:
    print("FAULT", type(e).__name__, flush=True)
    os._exit(137)  # crash: no close(), no manifest cleanup
print("NOFAULT", flush=True)
os._exit(0)
"""
        env = dict(
            os.environ,
            GTPU_CHAOS="maintenance.job=fail,@op:compact,@phase:swap")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            [sys.executable, "-c", script, str(tmp_path), root],
            capture_output=True, text=True, timeout=300, env=env)
        assert "ACK" in r.stdout, r.stderr
        assert "FAULT FaultError" in r.stdout, r.stdout + r.stderr
        assert r.returncode == 137
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        # the fresh catalog re-CREATEs the table; re-OPEN the region so
        # it adopts the on-disk manifest (files) + WAL like a real boot
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        engine.regions.pop(rid).close()
        engine.open_region(rid)
        got = qe.execute_one("SELECT count(*) FROM cpu").rows()
        assert got == [[100]], got  # every acknowledged row survived
        engine.close()


# ---- ADMIN + surfaces (satellite) ------------------------------------------


class TestAdminAndSurfaces:
    def test_admin_returns_job_ids_and_status(self, tmp_path):
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        ingest(qe, points=20)
        r = qe.execute_one("ADMIN flush_table('cpu')")
        assert r.names == ["job_id"] and r.num_rows == 1
        jid = int(r.rows()[0][0])
        job = engine.maintenance.wait(jid, timeout=10)
        assert job.state == "done"
        st = qe.execute_one(f"ADMIN maintenance_status({jid})")
        row = dict(zip(st.names, st.rows()[0]))
        assert row["kind"] == "flush" and row["state"] == "done"
        assert json.loads(row["detail"])["flushed_rows"] == 60
        c = qe.execute_one("ADMIN compact_table('cpu')")
        assert c.names == ["job_id"]
        from greptimedb_tpu_torch.query.expr import PlanError

        with pytest.raises(PlanError):
            qe.execute_one("ADMIN maintenance_status(999999)")
        engine.close()

    def test_information_schema_maintenance_jobs(self, tmp_path):
        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        ingest(qe, points=10)
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        r = qe.execute_one(
            "SELECT job_id, kind, state, priority FROM "
            "information_schema.maintenance_jobs WHERE kind = 'flush'")
        assert r.num_rows >= 1
        assert r.rows()[0][1] == "flush"
        assert r.rows()[0][3] == 0  # flush has top priority
        engine.close()

    def test_http_maintenance_endpoint(self, tmp_path):
        from greptimedb_tpu_torch.servers import HttpServer

        engine, qe = make_db(tmp_path)
        create_cpu(qe)
        ingest(qe, points=10)
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/maintenance?limit=10",
                    timeout=10) as resp:
                body = json.loads(resp.read())
            assert body["enabled"] is True
            assert any(j["kind"] == "flush" and j["state"] == "done"
                       for j in body["jobs"])
            assert "write_stall_seconds" in body
        finally:
            srv.stop()
            engine.close()

    def test_rollup_table_admin(self, tmp_path):
        engine, qe = make_db(tmp_path, rollup_rules=[])
        create_cpu(qe)
        ingest(qe)
        wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
        jobs = wait_jobs(qe, qe.execute_one("ADMIN rollup_table('cpu', '1m')"))
        assert jobs[0].state == "done", jobs[0].error
        assert jobs[0].detail["rows_out"] > 0
        # the ad-hoc resolution registered a rule, so substitution works
        qe.execute_one(
            "SELECT host, max(v) FROM cpu WHERE ts >= 0 AND ts < 60000 "
            "GROUP BY host")
        assert "+rollup" in (qe.executor.last_path or "")
        engine.close()

    def test_parse_duration(self):
        assert parse_duration_ms("90s") == 90_000
        assert parse_duration_ms("1m") == 60_000
        assert parse_duration_ms("7d") == 7 * 86_400_000
        assert parse_duration_ms("250ms") == 250
        assert parse_duration_ms(5000) == 5000

    def test_maintenance_disabled_keeps_sync_admin(self, tmp_path):
        engine, qe = make_db(tmp_path, maintenance_workers=0)
        assert engine.maintenance is None
        create_cpu(qe)
        ingest(qe, points=10)
        r = qe.execute_one("ADMIN flush_table('cpu')")
        assert r.affected_rows == 0  # pre-plane synchronous shape
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        assert engine.region(rid).files
        engine.close()


def test_rollup_region_id_disjoint():
    """Rollup companion ids never collide with raw ids or each other."""
    raw = [(7 << 32) | i for i in range(4)]
    ids = set(raw)
    for rid in raw:
        for rule in range(3):
            rrid = rollup_region_id(rid, rule)
            assert rrid not in ids
            ids.add(rrid)


# ---- the port's planes and substitution held to the JAX package -----------

PARITY_DDL = ("CREATE TABLE m (host STRING, dc STRING, v DOUBLE, w BIGINT, "
              "x FLOAT, ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host, dc))")
PARITY_HOSTS = ["a", "b", "c", "inf", "ninf", None]


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def parity_batches(seed: int, integer_valued: bool):
    """Seeded writes: (kind, columns) in order, kind "put" or "delete".
    Keys repeat across batches (last-write-wins), ~10 % of v is NaN,
    host 'inf' holds only +inf values and NaN, 'ninf' a mix of -inf and
    finite values, host and dc carry NULLs; one delete batch removes
    some keys."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(4):
        n = 400
        host = [PARITY_HOSTS[i] for i in rng.integers(0, 6, n)]
        dc = [[None, "x", "y"][i] for i in rng.integers(0, 3, n)]
        ts = rng.integers(0, 300, n).astype(np.int64) * 1000 + \
            rng.integers(0, 3, n)
        if integer_valued:
            v = rng.integers(-50, 50, n).astype(np.float64)
        else:
            v = rng.normal(0.0, 1e3, n)
        v[rng.random(n) < 0.1] = np.nan
        h = np.asarray([x or "" for x in host], dtype=object)
        v[h == "inf"] = np.where(np.isnan(v[h == "inf"]), np.nan, np.inf)
        ninf = (h == "ninf") & (rng.random(n) < 0.5)
        v[ninf] = -np.inf
        w = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
        x = (rng.integers(-500, 500, n) / 4).astype(np.float32)
        out.append(("put", {"host": host, "dc": dc, "ts": ts, "v": v,
                            "w": w, "x": x}))
        if b == 2:
            k = rng.choice(n, 40, replace=False)
            out.append(("delete", {
                "host": [host[i] for i in k], "dc": [dc[i] for i in k],
                "ts": ts[k], "v": np.full(40, np.nan),
                "w": np.zeros(40, np.int64),
                "x": np.full(40, np.nan, np.float32)}))
    return out


def parity_engines(tmp_path, seed, integer_valued, **cfg):
    """The JAX engine and the port's over the same writes of
    parity_batches (a flush after the second batch): [(engine, qe, rid,
    package)] for JAX then the port."""
    from greptimedb_tpu import datatypes as jdt
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine

    from greptimedb_tpu_torch import datatypes as tdt

    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"), **cfg))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng)
    teng, tqe = make_db(tmp_path / "port", **cfg)
    sides = []
    for eng, qe, dt, pkg in ((jeng, jqe, jdt, "jax"),
                             (teng, tqe, tdt, "port")):
        qe.execute_one(PARITY_DDL)
        info = qe.catalog.table("public", "m")
        rid = info.region_ids[0]
        for i, (kind, cols) in enumerate(parity_batches(seed,
                                                        integer_valued)):
            batch = dt.RecordBatch(info.schema, {
                "host": dt.DictVector.encode(cols["host"]),
                "dc": dt.DictVector.encode(cols["dc"]),
                **{k: cols[k] for k in ("ts", "v", "w", "x")}})
            (eng.put if kind == "put" else eng.delete)(rid, batch)
            if i == 1:
                eng.region(rid).flush()
        sides.append((eng, qe, rid, pkg))
    return sides


def plane_table(batch) -> dict:
    """A plane RecordBatch as numpy columns sorted by (host, dc, ts),
    tags decoded."""
    cols = {}
    for name, col in batch.columns.items():
        cols[name] = col.decode() if hasattr(col, "decode") \
            else np.asarray(col)
    key = [np.asarray(["\0" if v is None else str(v) for v in cols[t]],
                      dtype=object) for t in ("host", "dc")]
    order = np.lexsort((cols["ts"], key[1], key[0]))
    return {k: v[order] for k, v in cols.items()}


@pytest.mark.parametrize("seed", [3, 11])
def test_rollup_planes_match_the_jax_aggregate(seed, tmp_path):
    """The port's `_aggregate` (one K2 call, its plain version on the
    CPU) against the JAX `_aggregate` on the same rows: rows, counts,
    minima and maxima bit for bit, the +inf-only and -inf groups
    included; sums to rtol 1e-12; integer and float32 planes in their
    dtypes."""
    from greptimedb_tpu.maintenance import rollup as jrollup

    from greptimedb_tpu_torch.maintenance import rollup as trollup
    from greptimedb_tpu_torch.ops import segment_kernels

    sides = parity_engines(tmp_path, seed, False, maintenance_workers=0)
    calls = []
    real = segment_kernels.fused_segment_agg

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    planes = []
    try:
        segment_kernels.fused_segment_agg = counted
        for (eng, _qe, rid, pkg), mod in zip(sides, (jrollup, trollup)):
            region = eng.region(rid)
            scan = region.scan(ts_range=(0, 240_000))
            batch = mod._aggregate(region, scan, mod.RollupRule(), 60_000,
                                   0, 240_000)
            planes.append(plane_table(batch))
    finally:
        segment_kernels.fused_segment_agg = real
        for eng, *_ in sides:
            eng.close()
    assert len(calls) == 1 and calls[0] == {"want_min": True,
                                            "want_max": True}
    j, t = planes
    assert list(t) == list(j)
    assert len(t["ts"]) == len(j["ts"]) > 0
    for name in j:
        if name.endswith("__sum"):
            np.testing.assert_allclose(t[name], j[name], rtol=1e-12,
                                       atol=0, equal_nan=True)
        else:
            assert t[name].dtype == j[name].dtype, name
            assert np.array_equal(t[name], j[name], equal_nan=t[
                name].dtype.kind == "f"), name
    hosts = set(t["host"].tolist())
    assert {"inf", "ninf", None} <= hosts
    inf_rows = t["host"] == "inf"
    assert np.all(np.isposinf(t["v__min"][inf_rows])
                  | (t["v__count"][inf_rows] == 0))


SUBSTITUTED_SQL = [
    "SELECT host, dc, date_bin(INTERVAL '1 minute', ts) AS b, min(v), "
    "max(v), count(v), sum(v), avg(v), count(*) FROM m WHERE ts >= 0 AND "
    "ts < 240000 GROUP BY host, dc, b ORDER BY host, dc, b",
    "SELECT host, max(w), min(x), count(*) FROM m WHERE ts >= 60000 AND "
    "ts < 180000 AND dc = 'x' GROUP BY host ORDER BY host",
    "SELECT date_bin(INTERVAL '2 minutes', ts) AS b, sum(v), count(w) "
    "FROM m WHERE ts >= 0 AND ts < 240000 GROUP BY b ORDER BY b",
]


def _plain(rows):
    return [[None if isinstance(v, float) and v != v else
             (v.item() if isinstance(v, np.generic) else v) for v in row]
            for row in rows]


@pytest.mark.parametrize("sql", SUBSTITUTED_SQL,
                         ids=["minute_planes", "tag_filter", "two_minutes"])
def test_substituted_sql_matches_raw_in_both_packages(sql, tmp_path,
                                                      monkeypatch):
    """On integer-valued data (exact sums) every substituted result
    equals its raw route in each package, and the port's equals the JAX
    engine's."""
    sides = parity_engines(tmp_path, 5, True,
                           rollup_rules=[{"resolution_ms": 60_000}])
    got = []
    try:
        for eng, qe, _rid, pkg in sides:
            r = qe.execute_one("ADMIN rollup_table('m', '1m')")
            job = eng.maintenance.wait(int(r.rows()[0][0]), timeout=60)
            assert job.state == "done", (pkg, job.error)
            sub = qe.execute_one(sql)
            assert "+rollup" in (qe.executor.last_path or ""), pkg
            monkeypatch.setenv("GTPU_ROLLUP_SUBSTITUTE", "0")
            raw = qe.execute_one(sql)
            monkeypatch.delenv("GTPU_ROLLUP_SUBSTITUTE")
            assert "+rollup" not in (qe.executor.last_path or ""), pkg
            assert sub.names == raw.names, pkg
            assert _plain(sub.rows()) == _plain(raw.rows()), pkg
            got.append((sub.names, _plain(sub.rows())))
    finally:
        for eng, *_ in sides:
            eng.close()
    assert got[1] == got[0]


def test_no_plane_thread_outlives_close(tmp_path):
    """The maintenance workers, the tick thread and the write workers
    are joined by RegionEngine.close(), with a job in flight."""
    import threading

    before = set(threading.enumerate())
    engine, qe = make_db(tmp_path, maintenance_workers=2,
                         maintenance_tick_s=0.05, write_workers=2,
                         flush_threshold_bytes=1)
    create_cpu(qe)
    ingest(qe, points=30)
    FAULTS.arm("maintenance.job",
               Fault(kind="latency", arg=0.3, match={"phase": "start"}))
    engine.maintenance.submit("compact", qe.catalog.table(
        "public", "cpu").region_ids[0], {"strategy": "full"})
    names = {t.name for t in set(threading.enumerate()) - before}
    assert {"gtpu-maint-0", "gtpu-maint-1", "gtpu-maint-tick",
            "gtpu-write-worker-0", "gtpu-write-worker-1"} <= names
    engine.close()
    assert set(threading.enumerate()) - before == set()


def test_job_surfaces_answer_as_the_jax_package(tmp_path):
    """information_schema.maintenance_jobs, ADMIN maintenance_status and
    /v1/maintenance give the JAX package's columns and keys, and the same
    job rows, after the same ADMIN flush on both packages."""
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.servers.http import HttpServer as JHttpServer
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine

    from greptimedb_tpu_torch.servers import HttpServer

    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax")))
    teng, tqe = make_db(tmp_path / "port")
    outs = []
    try:
        for eng, qe, server in (
                (jeng, JQueryEngine(JCatalog(JMemoryKv()), jeng),
                 JHttpServer), (teng, tqe, HttpServer)):
            create_cpu(qe)
            ingest(qe, points=10)
            (job,) = wait_jobs(qe, qe.execute_one("ADMIN flush_table('cpu')"))
            jobs = qe.execute_one(
                "SELECT job_id, kind, state, priority, error, detail FROM "
                "information_schema.maintenance_jobs")
            names = qe.execute_one(
                "SELECT * FROM information_schema.maintenance_jobs").names
            st = qe.execute_one(f"ADMIN maintenance_status({job.job_id})")
            srv = server(qe, port=0)
            port = srv.start()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/v1/maintenance?limit=5",
                        timeout=10) as resp:
                    body = json.loads(resp.read())
            finally:
                srv.stop()
            outs.append((names, [[v.item() if isinstance(v, np.generic)
                                  else v for v in r] for r in jobs.rows()],
                         st.names, sorted(body),
                         sorted(body["jobs"][0]), body["enabled"]))
    finally:
        jeng.close()
        teng.close()
    assert outs[1] == outs[0]
