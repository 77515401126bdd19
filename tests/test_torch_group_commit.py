"""The port's write plane on the CPU: group commit
(greptimedb_tpu_torch/storage/group_commit.py and the Region hooks) and
the write worker group (storage/worker.py).

Twins of tests/test_ingest.py's TestGroupCommitDifferential and
TestGroupCommitConcurrency (the fault seams through the port's FAULTS)
and of tests/test_worker_group.py run on the port; the group-commit
region's rows are held bit for bit to the serial path's and to the JAX
engine's on the same seeded writes. In place of the JAX package's
TestCrashMidGroupCommit (a ProcessCluster, ROADMAP A10): a child
process writes through group commit with `ingest.commit` latency armed
at the apply step, the test SIGKILLs it mid-commit, and the reopened
engine must hold every acknowledged row.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from greptimedb_tpu_torch.concurrency.admission import Overloaded
from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    DictVector,
    RecordBatch,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.fault import FAULTS, Fault, FaultError
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.worker import WorkerGroup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RID = 77


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def make_schema() -> Schema:
    return Schema([
        ColumnSchema("host", DataType.STRING, SemanticType.TAG),
        ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                     SemanticType.TIMESTAMP, nullable=False),
        ColumnSchema("v", DataType.FLOAT64, SemanticType.FIELD),
    ])


def make_engine(path, **cfg) -> RegionEngine:
    eng = RegionEngine(EngineConfig(data_dir=str(path), **cfg),
                       device="cpu")
    eng.create_region(RID, make_schema())
    return eng


def make_batch(i: int, n: int = 50) -> RecordBatch:
    return RecordBatch(make_schema(), {
        "host": DictVector.encode([f"h{(i + j) % 7}" for j in range(n)]),
        "ts": np.arange(i * n, (i + 1) * n, dtype=np.int64),
        "v": np.arange(n, dtype=np.float64) + i,
    })


def scan_tuple(eng: RegionEngine, rid: int = RID):
    sd = eng.region(rid).scan()
    if sd is None:
        return None
    cols = {k: np.asarray(v) for k, v in sd.columns.items()}
    return cols, np.asarray(sd.seq), np.asarray(sd.op_type)


class TestGroupCommitDifferential:
    def test_serial_vs_group_bit_for_bit(self, tmp_path):
        """The acceptance differential: the same write sequence through
        the legacy serial path and the group-commit path must produce
        identical region contents — same columns, same seq order, same
        flush boundary, same replay."""
        legacy = make_engine(tmp_path / "legacy",
                             ingest_group_commit=False)
        group = make_engine(tmp_path / "group")
        assert legacy.region(RID).committer is None
        assert group.region(RID).committer is not None
        for eng in (legacy, group):
            for i in range(12):
                eng.put(RID, make_batch(i))
        a, b = scan_tuple(legacy), scan_tuple(group)
        for x, y in zip(a[0].values(), b[0].values()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[1], b[1])  # seq ordering
        np.testing.assert_array_equal(a[2], b[2])
        # flush boundary: same rows land in the SST, same next_seq
        ml, mg = legacy.region(RID).flush(), group.region(RID).flush()
        assert ml.num_rows == mg.num_rows
        assert legacy.region(RID).next_seq == group.region(RID).next_seq
        # replay parity after reopen
        legacy.close()
        group.close()
        l2 = RegionEngine(EngineConfig(
            data_dir=str(tmp_path / "legacy"), ingest_group_commit=False),
            device="cpu")
        g2 = RegionEngine(EngineConfig(data_dir=str(tmp_path / "group")),
                          device="cpu")
        l2.open_region(RID)
        g2.open_region(RID)
        a, b = scan_tuple(l2), scan_tuple(g2)
        np.testing.assert_array_equal(a[1], b[1])
        for x, y in zip(a[0].values(), b[0].values()):
            np.testing.assert_array_equal(x, y)
        l2.close()
        g2.close()

    def test_counts_and_zero_row_batches(self, tmp_path):
        eng = make_engine(tmp_path)
        empty = RecordBatch(make_schema(), {
            "host": DictVector.encode([]),
            "ts": np.asarray([], dtype=np.int64),
            "v": np.asarray([], dtype=np.float64)})
        counts = eng.region(RID).write_many(
            [(make_batch(0, 5), 0), (empty, 0), (make_batch(1, 3), 0)])
        assert counts == [5, 0, 3]
        eng.close()

    def test_delete_rides_the_pipeline(self, tmp_path):
        """DELETE is an op_type on the same write path — tombstones must
        flow through group commit like puts."""
        eng = make_engine(tmp_path)
        eng.put(RID, make_batch(0, 10))
        from greptimedb_tpu_torch.storage.region import OP_DELETE

        eng.region(RID).write(make_batch(0, 10), OP_DELETE)
        sd = eng.region(RID).scan()
        assert (np.asarray(sd.op_type) == 1).sum() == 10
        eng.close()


class TestGroupCommitConcurrency:
    def test_concurrent_writers_amortize_fsyncs(self, tmp_path):
        eng = make_engine(tmp_path)
        errs: list = []

        def writer(k):
            try:
                for i in range(15):
                    eng.put(RID, make_batch(k * 15 + i))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        sd = eng.region(RID).scan()
        total = 8 * 15 * 50
        assert sd.num_rows == total
        # no seq gap, no duplicate: every row got exactly one sequence
        assert sorted(np.asarray(sd.seq).tolist()) == list(range(total))
        writes = 8 * 15
        assert eng.wal.sync_count < writes, (
            f"{eng.wal.sync_count} fsyncs for {writes} concurrent writes "
            "— group commit should coalesce")
        eng.close()

    def test_queue_overflow_is_typed_overloaded(self, tmp_path):
        eng = make_engine(tmp_path, ingest_queue_depth=2,
                          ingest_overlap=False)
        region = eng.region(RID)
        gate = threading.Event()
        entered = threading.Event()
        orig = region.group_commit

        def slow_commit(ticket, entries, blob=None):
            entered.set()
            gate.wait(10.0)
            return orig(ticket, entries, blob=blob)

        region.group_commit = slow_commit
        threads = []
        errs: list = []

        def write():
            try:
                eng.put(RID, make_batch(len(threads)))
            except Exception as e:  # noqa: BLE001 — collected
                errs.append(e)

        try:
            # leader enters the gated commit; two more fill the queue
            t0 = threading.Thread(target=write)
            t0.start()
            threads.append(t0)
            assert entered.wait(5.0)
            for _ in range(2):
                t = threading.Thread(target=write)
                t.start()
                threads.append(t)
            deadline = time.monotonic() + 5.0
            while region.committer._queue is not None \
                    and len(region.committer._queue) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            with pytest.raises(Overloaded):
                eng.put(RID, make_batch(99))
        finally:
            gate.set()
            for t in threads:
                t.join(10.0)
        assert not errs
        from greptimedb_tpu_torch.utils.metrics import (
            INGEST_GROUP_COMMIT_EVENTS,
        )

        assert INGEST_GROUP_COMMIT_EVENTS.total(event="overflow") >= 1
        eng.close()

    def test_append_fault_fails_writers_without_ack(self, tmp_path):
        """A fault at the WAL append boundary must surface to the
        writers (unacknowledged), leave no rows behind, and leave the
        pipeline healthy for the next write."""
        eng = make_engine(tmp_path)
        FAULTS.arm("ingest.commit",
                   Fault(kind="fail", nth=1, match={"op": "append"}))
        with pytest.raises(FaultError):
            eng.put(RID, make_batch(0))
        assert eng.region(RID).scan() is None  # nothing applied
        # pipeline recovered: the next write commits normally
        assert eng.put(RID, make_batch(1)) == 50
        sd = eng.region(RID).scan()
        assert sd.num_rows == 50
        # the burned reservation left a seq gap; replay tolerates it
        eng.close()
        e2 = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                          device="cpu")
        e2.open_region(RID)
        assert e2.region(RID).scan().num_rows == 50
        e2.close()

    def test_flush_during_inflight_commit_loses_nothing(self, tmp_path):
        """A flush racing the reserve→apply window must wait: flushing
        in between would record a flushed_seq past rows not yet in the
        memtable and skip their WAL entries on replay."""
        eng = make_engine(tmp_path)
        eng.put(RID, make_batch(0))
        # widen the dangerous window: the first commit sleeps between
        # the durable append and the memtable apply
        FAULTS.arm("ingest.commit",
                   Fault(kind="latency", arg=0.3, nth=1,
                         match={"op": "apply"}))
        t = threading.Thread(target=lambda: eng.put(RID, make_batch(1)))
        t.start()
        time.sleep(0.1)  # the writer is inside the latency window
        eng.region(RID).flush()
        t.join(10.0)
        assert eng.region(RID).scan().num_rows == 100
        eng.close()
        # crash-equivalent: reopen and replay — both batches survive
        e2 = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                          device="cpu")
        e2.open_region(RID)
        assert e2.region(RID).scan().num_rows == 100
        e2.close()

    def test_drop_during_commit_refuses_ack(self, tmp_path):
        eng = make_engine(tmp_path)
        FAULTS.arm("ingest.commit",
                   Fault(kind="latency", arg=0.3, nth=1,
                         match={"op": "apply"}))
        from greptimedb_tpu_torch.storage.region import RegionDroppedError

        errs: list = []

        def write():
            try:
                eng.put(RID, make_batch(0))
            except RegionDroppedError as e:
                errs.append(e)

        t = threading.Thread(target=write)
        t.start()
        time.sleep(0.1)
        eng.drop_region(RID)
        t.join(10.0)
        assert errs, "a write racing DROP must not be acknowledged"
        eng.close()




# ---- the write worker group (twins of tests/test_worker_group.py) -------

def wg_schema():
    return Schema([
        ColumnSchema("host", DataType.STRING, SemanticType.TAG),
        ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                     SemanticType.TIMESTAMP),
        ColumnSchema("v", DataType.FLOAT64),
    ])


def wg_batch(s, ts0, n, host="h"):
    return RecordBatch(s, {
        "host": DictVector.encode([host] * n),
        "ts": np.arange(ts0, ts0 + n, dtype=np.int64),
        "v": np.full(n, float(ts0)),
    })


def test_concurrent_writes_group_commit(tmp_path):
    """16 threads x 8 writes each through the worker group: every row
    lands exactly once, and the WAL fsync count is well below the write
    count (group commit actually grouped)."""
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path),
                                       write_workers=2), device="cpu")
    s = wg_schema()
    engine.create_region(1, s)
    n_threads, per_thread, rows_each = 16, 8, 10
    start = threading.Barrier(n_threads)
    errs = []

    def writer(t):
        try:
            start.wait()
            for i in range(per_thread):
                ts0 = (t * per_thread + i) * rows_each
                n = engine.put(1, wg_batch(s, ts0, rows_each, host=f"h{t}"))
                assert n == rows_each
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    total = n_threads * per_thread * rows_each
    scan = engine.scan(1)
    assert scan.num_rows == total
    # (host, ts) keys are all distinct -> no dedup losses
    writes = n_threads * per_thread
    assert engine.wal.sync_count < writes, (
        f"{engine.wal.sync_count} fsyncs for {writes} writes — "
        "no group commit happened")
    engine.close()


def test_worker_path_preserves_lww_order(tmp_path):
    """Same-key writes submitted in order from one caller keep
    last-write-wins semantics through the worker queue."""
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine

    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path),
                                       write_workers=1), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    qe.execute_one(
        "CREATE TABLE t (host STRING, ts TIMESTAMP(3) NOT NULL, v DOUBLE,"
        " TIME INDEX (ts), PRIMARY KEY (host))")
    for v in (1.0, 2.0, 3.0):
        qe.execute_one(f"INSERT INTO t VALUES ('h', 100, {v})")
    assert qe.execute_one("SELECT v FROM t").rows() == [[3.0]]
    engine.close()


def test_sharding_is_stable():
    class _Eng:
        pass

    wg = WorkerGroup(_Eng(), num_workers=4)
    try:
        rid = (7 << 32) | 3
        assert wg._shard(rid) == wg._shard(rid)
        shards = {wg._shard((t << 32) | r)
                  for t in range(8) for r in range(8)}
        assert shards == {0, 1, 2, 3}  # all workers used
    finally:
        wg.stop()


def test_write_error_propagates(tmp_path):
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path),
                                       write_workers=1), device="cpu")
    s = wg_schema()
    with pytest.raises(KeyError, match="not open"):
        engine.put(99, wg_batch(s, 0, 1))
    # the group survives the failure and keeps serving
    engine.create_region(1, s)
    assert engine.put(1, wg_batch(s, 0, 5)) == 5
    engine.close()


def test_crash_recovery_through_workers(tmp_path):
    """Rows acknowledged through the worker path survive reopen (WAL
    group commit is still WAL-first)."""
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path),
                                       write_workers=2), device="cpu")
    s = wg_schema()
    engine.create_region(1, s)
    for i in range(5):
        engine.put(1, wg_batch(s, i * 10, 10))
    # simulate crash: no close/flush — reopen over the same dir
    engine2 = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                           device="cpu")
    engine2.open_region(1)
    assert engine2.scan(1).num_rows == 50
    engine2.close()
    engine.close()


# ---- parity with the JAX engine, the crash mid-commit, threads ------------


def seeded_batches(seed: int, count: int) -> list:
    """(op, columns) of `count` seeded writes: hosts with NULLs, repeated
    (host, ts) keys (last-write-wins), NaN values, every fourth a
    delete of some earlier keys."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(1, 80))
        host = [[None, "a", "b", "c"][k] for k in rng.integers(0, 4, n)]
        ts = rng.integers(0, 500, n).astype(np.int64)
        v = rng.normal(0, 100, n)
        v[rng.random(n) < 0.1] = np.nan
        out.append((1 if i % 4 == 3 else 0,
                    {"host": host, "ts": ts, "v": v}))
    return out


def test_group_commit_rows_match_serial_and_the_jax_engine(tmp_path):
    """The same seeded writes, from 4 concurrent writers a region-id
    partition each, through the port's group commit, its serial path and
    the JAX engine's group commit: each region's deduplicated rows are
    equal bit for bit across the three."""
    from greptimedb_tpu import datatypes as jdt
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine

    from greptimedb_tpu_torch import datatypes as tdt

    writes = seeded_batches(9, 48)
    engines = [
        (JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                               maintenance_workers=0)), jdt),
        (RegionEngine(EngineConfig(data_dir=str(tmp_path / "group"),
                                   maintenance_workers=0),
                      device="cpu"), tdt),
        (RegionEngine(EngineConfig(data_dir=str(tmp_path / "serial"),
                                   maintenance_workers=0,
                                   ingest_group_commit=False),
                      device="cpu"), tdt)]
    rids = [RID + k for k in range(4)]
    tables = []
    for eng, dt in engines:
        schema = dt.Schema([
            dt.ColumnSchema("host", dt.DataType.STRING, dt.SemanticType.TAG),
            dt.ColumnSchema("ts", dt.DataType.TIMESTAMP_MILLISECOND,
                            dt.SemanticType.TIMESTAMP, nullable=False),
            dt.ColumnSchema("v", dt.DataType.FLOAT64,
                            dt.SemanticType.FIELD)])
        for rid in rids:
            eng.create_region(rid, schema)

        def writer(k, eng=eng, dt=dt, schema=schema):
            # writer k owns region rids[k]: its order is the write order
            for op, cols in writes[k::4]:
                b = dt.RecordBatch(schema, {
                    "host": dt.DictVector.encode(cols["host"]),
                    "ts": cols["ts"], "v": cols["v"]})
                (eng.delete if op else eng.put)(rids[k], b)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        per_region = []
        for rid in rids:
            sd = eng.region(rid).scan()
            host = np.asarray(sd.tag_dicts["host"], dtype=object)[
                np.asarray(sd.columns["host"])]
            host[np.asarray(sd.columns["host"]) < 0] = None
            ts = np.asarray(sd.columns["ts"])
            seq = np.asarray(sd.seq)
            op = np.asarray(sd.op_type)
            key = np.asarray(["\0" if h is None else h for h in host])
            order = np.lexsort((seq, ts, key))
            # last-write-wins survivors: the last row of each (host, ts)
            last = np.r_[(key[order][1:] != key[order][:-1])
                         | (ts[order][1:] != ts[order][:-1]), True]
            keep = order[last & (op[order] == 0)]
            per_region.append((host[keep].tolist(), ts[keep].tolist(),
                               np.asarray(sd.columns["v"])[keep]))
        tables.append(per_region)
        eng.close()
    for other in tables[1:]:
        for (h0, t0, v0), (h1, t1, v1) in zip(tables[0], other):
            assert h1 == h0 and t1 == t0
            assert np.array_equal(v1, v0, equal_nan=True)


CRASH_CHILD = r"""
import os, sys, threading
sys.path.insert(0, sys.argv[2])
from greptimedb_tpu_torch.datatypes import (ColumnSchema, DataType,
    DictVector, RecordBatch, Schema, SemanticType)
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
import numpy as np

schema = Schema([
    ColumnSchema("host", DataType.STRING, SemanticType.TAG),
    ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                 SemanticType.TIMESTAMP, nullable=False),
    ColumnSchema("v", DataType.FLOAT64, SemanticType.FIELD)])
eng = RegionEngine(EngineConfig(data_dir=sys.argv[1]), device="cpu")
eng.create_region(77, schema)
lock = threading.Lock()

def writer(w):
    for i in range(1000):
        k = w * 1000 + i
        eng.put(77, RecordBatch(schema, {
            "host": DictVector.encode([f"w{w}"] * 10),
            "ts": np.arange(k * 10, k * 10 + 10, dtype=np.int64),
            "v": np.full(10, float(k))}))
        with lock:
            print("ACK", k, flush=True)

threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join()
"""


def test_sigkill_mid_group_commit_keeps_every_acknowledged_row(tmp_path):
    """A child process writes through group commit from 4 threads with
    `ingest.commit` latency armed at the apply step of its 12th commit
    (the WAL append is durable, the memtable apply and the
    acknowledgement are not); it is SIGKILLed inside that window. The
    reopened engine holds every acknowledged batch and the WAL replays
    without a torn frame."""
    env = dict(os.environ,
               GTPU_CHAOS="ingest.commit=latency,arg:60,nth:12,@op:apply")
    proc = subprocess.Popen(
        [sys.executable, "-c", CRASH_CHILD, str(tmp_path), ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    acked = []
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            acked.append(int(line.split()[1]))
            if len(acked) >= 8:
                break
        # the commit holding the 12th ticket sleeps between its durable
        # append and its apply; the other writers queue behind its turn
        time.sleep(1.0)
        os.kill(proc.pid, signal.SIGKILL)
        rest, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    acked += [int(x.split()[1]) for x in rest.splitlines()
              if x.startswith("ACK")]
    assert proc.returncode == -signal.SIGKILL
    assert len(acked) >= 8, err
    eng = RegionEngine(EngineConfig(data_dir=str(tmp_path)), device="cpu")
    eng.open_region(RID)
    sd = eng.region(RID).scan()
    got = set(np.asarray(sd.columns["v"]).astype(int).tolist())
    missing = sorted(set(acked) - got)
    assert not missing, f"acknowledged writes lost: {missing}"
    # the kill landed inside the window: the sleeping group's append is
    # durable (replayed) though nobody acknowledged it
    assert got - set(acked)
    # every replayed batch is whole: 10 rows a value
    _, counts = np.unique(np.asarray(sd.columns["v"]), return_counts=True)
    assert np.all(counts == 10)
    eng.close()


def test_close_joins_every_write_plane_thread(tmp_path):
    """The write workers and the maintenance plane are joined by
    RegionEngine.close(), with writers and a flush in flight."""
    before = set(threading.enumerate())
    eng = make_engine(tmp_path, write_workers=3, flush_threshold_bytes=1)
    errs: list = []

    def writer(k):
        try:
            for i in range(10):
                eng.put(RID, make_batch(k * 10 + i))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs
    assert {t.name for t in set(threading.enumerate()) - before} >= {
        "gtpu-write-worker-0", "gtpu-write-worker-1", "gtpu-write-worker-2",
        "gtpu-maint-0"}
    eng.close()
    assert set(threading.enumerate()) - before == set()


def test_wal_blob_frames_are_append_many_bytes(tmp_path):
    """encode_entries + append_blob write the very bytes append_many
    wrote before the split (it is now the two of them), replay reads them
    back through the native scan and the Python walk alike, and a failed
    append_blob truncates its partial bytes."""
    from greptimedb_tpu_torch.storage import wal as walmod

    entries = [(0, 0, make_batch(0, 7)), (7, 1, make_batch(1, 5)),
               (12, 0, make_batch(2, 9))]
    a = walmod.Wal(str(tmp_path / "a"))
    b = walmod.Wal(str(tmp_path / "b"))
    a.append_many(RID, entries)
    b.append_blob(RID, walmod.Wal.encode_entries(RID, entries))
    b.append_blob(RID, b"".join(
        bytes(p) for p in walmod.Wal.encode_entries(RID, entries[:1])))
    a.append_many(RID, entries[:1])
    a.close()
    b.close()
    (pa,), (pb,) = ([p for _, p in w._segments(RID)] for w in (a, b))
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        data = fa.read()
        assert fb.read() == data
    # the frames: header <IIQQB> then the payload, CRC'd
    pos, seqs = 0, []
    while pos < len(data):
        plen, crc, rid, seq, op = walmod._HEADER.unpack_from(data, pos)
        body = data[pos + walmod._HEADER.size:
                    pos + walmod._HEADER.size + plen]
        assert rid == RID and len(body) == plen
        assert walmod.zlib.crc32(body) == crc
        seqs.append(seq)
        pos += walmod._HEADER.size + plen
    assert seqs == [0, 7, 12, 0]
    for lib in (walmod.native.try_load(), None):
        if lib is None:
            saved = walmod.native.try_load
            walmod.native.try_load = lambda: None
        try:
            got = [(e.seq, e.op_type, e.batch.num_rows)
                   for e in walmod.Wal(str(tmp_path / "b")).replay(RID)]
        finally:
            if lib is None:
                walmod.native.try_load = saved
        assert got == [(0, 0, 7), (7, 1, 5), (12, 0, 9), (0, 0, 7)]

    class Broken:
        """A piece the file refuses after the first pieces landed."""

    c = walmod.Wal(str(tmp_path / "c"))
    c.append_blob(RID, walmod.Wal.encode_entries(RID, entries[:1]))
    size = c._files[RID][1].tell()
    with pytest.raises(TypeError):
        c.append_blob(RID, walmod.Wal.encode_entries(RID, entries[1:])
                      + [Broken()])
    assert c._files[RID][1].tell() == size
    c.close()
    assert [e.seq for e in walmod.Wal(str(tmp_path / "c")).replay(RID)] \
        == [0]
