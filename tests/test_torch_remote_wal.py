"""The port's remote WAL (greptimedb_tpu_torch/storage/remote_wal.py) and
its WAL fault seams against the JAX package's, on the CPU.

The cases of tests/test_storage.py::TestRemoteWal, each run on both
packages' RemoteWal over their MemoryStore with the same writes (the
port frames its own numpy payloads, the JAX package Arrow IPC, under
the same `<IIQQB>` header and key layout): replay and obsolete, a
straddling segment kept, no listing in steady state, a corrupt object
that stops replay, an unreadable extent kept, replay skipping segments
by key, the failover engine, and one PUT a worker group commit. Then
the seams: a transient `objectstore.read` during replay is retried, an
enospc `wal.append` leaves no segment behind (remote) or no tail
(local), and a torn append is cut at replay (remote) or at once (local).
"""

import threading

import numpy as np
import pytest

import greptimedb_tpu.datatypes as J
from greptimedb_tpu.objectstore import MemoryStore as JMemoryStore
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu.storage.remote_wal import RemoteWal as JRemoteWal
from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    DictVector,
    RecordBatch,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.fault import FAULTS, Fault, FaultError
from greptimedb_tpu_torch.objectstore import MemoryStore, ObjectStoreError
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.remote_wal import RemoteWal
from greptimedb_tpu_torch.storage.wal import Wal
from greptimedb_tpu_torch.utils.metrics import RETRY_ATTEMPTS

_SPEC = [("ts", "timestamp_ms", "timestamp"), ("hostname", "string", "tag"),
         ("usage_user", "float64", "field")]


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


@pytest.fixture(autouse=True)
def _disarm():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _schema(pkg):
    if pkg == "jax":
        return J.Schema([J.ColumnSchema(n, J.DataType(d), J.SemanticType(s))
                         for n, d, s in _SPEC])
    return Schema([ColumnSchema(n, DataType(d), SemanticType(s))
                   for n, d, s in _SPEC])


def _batch(pkg, hosts, ts, usage):
    cols = {"ts": np.asarray(ts, dtype=np.int64),
            "usage_user": np.asarray(usage, dtype=np.float64)}
    if pkg == "jax":
        cols["hostname"] = J.DictVector.encode(hosts)
        return J.RecordBatch(_schema(pkg), cols)
    cols["hostname"] = DictVector.encode(hosts)
    return RecordBatch(_schema(pkg), cols)


def _wal(pkg):
    if pkg == "jax":
        return JRemoteWal(JMemoryStore(), prefix="wal")
    return RemoteWal(MemoryStore(), prefix="wal")


def _rows(entries) -> list:
    """(seq, op, [(host, ts, usage), ...]) of replayed entries."""
    out = []
    for e in entries:
        cols = e.batch.columns
        hosts = cols["hostname"].decode().tolist()
        out.append((e.seq, e.op_type, list(zip(
            hosts, cols["ts"].tolist(), cols["usage_user"].tolist()))))
    return out


def _both(fn):
    """fn(pkg) on both packages; the two results, JAX first."""
    return fn("jax"), fn("port")


def test_append_replay_obsolete():
    def run(pkg):
        wal, out = _wal(pkg), []
        wal.append(7, 0, 0, _batch(pkg, ["a", "b"], [10, 20], [1.0, 2.0]))
        wal.append(7, 2, 0, _batch(pkg, ["c"], [30], [3.0]))
        wal.append(8, 0, 0, _batch(pkg, ["z"], [99], [9.0]))
        out.append(_rows(wal.replay(7)))
        out.append(_rows(wal.replay(7, from_seq=1)))
        wal.obsolete(7, 2)
        out.append(_rows(wal.replay(7)))
        wal.delete_region(7)
        out.append(_rows(wal.replay(7)))
        out.append(_rows(wal.replay(8)))
        out.append(sorted(wal.store.list("wal/")))
        return out

    j, t = _both(run)
    assert t == j and [e[0] for e in t[0]] == [0, 2]


def test_corrupt_object_stops_replay():
    def run(pkg):
        wal = _wal(pkg)
        wal.append(1, 0, 0, _batch(pkg, ["a"], [10], [1.0]))
        wal.append(1, 1, 0, _batch(pkg, ["b"], [20], [2.0]))
        key = "wal/1/" + f"{1:020d}"
        wal.store.write(key, wal.store.read(key)[:-3])  # torn tail
        return _rows(wal.replay(1))

    j, t = _both(run)
    assert t == j and [e[0] for e in t] == [0]


def test_append_many_writes_one_object():
    def run(pkg):
        wal = _wal(pkg)
        writes = []
        inner = wal.store.write
        wal.store.write = lambda k, d: (writes.append(k), inner(k, d))[1]
        wal.append_many(5, [(i, 0, _batch(pkg, [f"h{i}"], [i * 10],
                                          [float(i)])) for i in range(64)])
        return writes, _rows(wal.replay(5))

    j, t = _both(run)
    assert t == j and len(t[0]) == 1 and len(t[1]) == 64


def test_obsolete_keeps_straddling_segment():
    def run(pkg):
        wal = _wal(pkg)
        wal.append_many(3, [(i, 0, _batch(pkg, ["a"], [i], [1.0]))
                            for i in range(4)])
        wal.append_many(3, [(9, 0, _batch(pkg, ["b"], [9], [2.0]))])
        wal.obsolete(3, 2)
        a = _rows(wal.replay(3, from_seq=2))
        wal.obsolete(3, 5)
        return a, _rows(wal.replay(3))

    j, t = _both(run)
    assert t == j
    assert [e[0] for e in t[0]] == [2, 3, 9] and [e[0] for e in t[1]] == [9]


def test_obsolete_uses_index_not_listing():
    def run(pkg):
        wal = _wal(pkg)
        wal.append_many(4, [(0, 0, _batch(pkg, ["a"], [1], [1.0]))])
        wal.append_many(4, [(1, 0, _batch(pkg, ["b"], [2], [1.0]))])
        lists = []
        inner = wal.store.list
        wal.store.list = lambda p: (lists.append(p), inner(p))[1]
        wal.obsolete(4, 1)
        wal.store.list = inner
        a = _rows(wal.replay(4))
        wal.obsolete(4, 2)
        return lists, a, _rows(wal.replay(4))

    j, t = _both(run)
    assert t == j and t[0] == []


def test_obsolete_read_error_keeps_segment():
    def run(pkg):
        wal = _wal(pkg)
        wal.append_many(6, [(i, 0, _batch(pkg, ["a"], [i], [1.0]))
                            for i in range(5, 21)])
        wal._segments.clear()  # unknown extents, as after a restart
        inner = wal.store.read
        err = ObjectStoreError if pkg == "port" else \
            __import__("greptimedb_tpu.objectstore",
                       fromlist=["ObjectStoreError"]).ObjectStoreError

        def failing_read(key):
            raise err("transient")

        wal.store.read = failing_read
        wal.obsolete(6, 10)  # straddling segment; extent unreadable
        wal.store.read = inner
        return _rows(wal.replay(6, from_seq=11))

    j, t = _both(run)
    assert t == j and [e[0] for e in t] == list(range(11, 21))


def test_obsolete_keeps_a_segment_whose_delete_failed(caplog):
    """A segment whose delete failed stays in the index, is logged, and
    the next obsolete deletes it; replay never reads its entries."""
    keys = [f"wal/7/{s:020d}" for s in (0, 1, 2)]

    class Refusing(MemoryStore):
        refuse = {keys[1]}

        def delete(self, key):
            if key in self.refuse:
                self.refuse.discard(key)
                raise ObjectStoreError(f"{key}: HTTP 403")
            super().delete(key)

    wal = RemoteWal(Refusing(), prefix="wal")
    for seq in (0, 1, 2):
        wal.append(7, seq, 0, _batch("port", ["a"], [seq], [1.0]))
    with caplog.at_level("WARNING",
                         logger="greptimedb_tpu_torch.storage.remote_wal"):
        wal.obsolete(7, 2)
    assert sorted(wal.store.list("wal/7/")) == [keys[1], keys[2]]
    assert f"segment {keys[1]} not deleted" in caplog.text
    assert [e.seq for e in wal.replay(7, from_seq=2)] == [2]
    wal.obsolete(7, 2)
    assert wal.store.list("wal/7/") == [keys[2]]


def test_replay_skips_fully_obsolete_segments_by_key():
    def run(pkg):
        wal = _wal(pkg)
        wal.append_many(7, [(0, 0, _batch(pkg, ["a"], [1], [1.0])),
                            (1, 0, _batch(pkg, ["a"], [2], [1.0]))])
        wal.append_many(7, [(2, 0, _batch(pkg, ["b"], [3], [1.0]))])
        reads = []
        inner = wal.store.read
        wal.store.read = lambda k: (reads.append(k), inner(k))[1]
        return _rows(wal.replay(7, from_seq=2)), reads

    j, t = _both(run)
    assert t == j and len(t[1]) == 1


def _engine(pkg, cfg_kw):
    if pkg == "jax":
        return JRegionEngine(JConfig(**cfg_kw))
    return RegionEngine(EngineConfig(**cfg_kw), device="cpu")


def test_engine_failover_replay_from_shared_store(tmp_path):
    """Node B opens a region node A wrote, replaying its unflushed write
    from the shared store; no local WAL file is written."""
    import glob

    def run(pkg):
        shared = str(tmp_path / pkg)
        kw = dict(data_dir=shared, wal_backend="remote")
        a = _engine(pkg, kw)
        a.create_region(1, _schema(pkg))
        a.put(1, _batch(pkg, ["x", "y"], [10, 20], [1.0, 2.0]))
        a.flush(1)
        a.put(1, _batch(pkg, ["z"], [30], [3.0]))  # unflushed
        a.close()
        assert glob.glob(f"{shared}/wal/*.wal") == []
        b = _engine(pkg, kw)
        b.open_region(1)
        region = b.region(1)
        scan = b.scan(1)
        seen = sorted(scan.tag_dicts["hostname"][c]
                      for c in scan.columns["hostname"])
        # the JAX region keeps no count of the entries it replayed
        replayed = getattr(region, "replayed_entries", 1)
        b.close()
        return seen, replayed

    j, t = _both(run)
    assert t == j and t[0] == ["x", "y", "z"] and t[1] == 1


def test_worker_group_commit_puts_one_object_a_commit(tmp_path):
    """Through the write worker group on the remote WAL: the WAL object
    PUTs stay below the writes (the JAX test counts keys under `wal/`,
    which the engine's prefix never matches; the port's counts its own
    prefix) and equal the group commits."""
    from greptimedb_tpu_torch.utils.metrics import INGEST_GROUP_COMMIT_EVENTS

    results = {}
    for pkg in ("jax", "port"):
        store = JMemoryStore() if pkg == "jax" else MemoryStore()
        puts = []
        inner = store.write
        store.write = lambda k, d, inner=inner, puts=puts: (
            puts.append(k), inner(k, d))[1]
        engine = _engine(pkg, dict(data_dir=str(tmp_path / pkg),
                                   wal_backend="remote", wal_store=store,
                                   write_workers=2))
        engine.create_region(1, _schema(pkg))
        leads0 = INGEST_GROUP_COMMIT_EVENTS.get(event="lead")
        n_threads, per_thread = 8, 8
        start = threading.Barrier(n_threads)
        errs = []

        def writer(t):
            try:
                start.wait()
                for i in range(per_thread):
                    base = (t * per_thread + i) * 4
                    engine.put(1, _batch(pkg, [f"h{t}"], [base], [1.0]))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errs
        wal_puts = [k for k in puts if "/remote_wal/" in k]
        results[pkg] = (engine.scan(1).num_rows, len(wal_puts))
        if pkg == "port":
            commits = INGEST_GROUP_COMMIT_EVENTS.get(event="lead") - leads0
            assert len(wal_puts) == commits
        engine.close()
    writes = 8 * 8
    assert results["port"][0] == results["jax"][0] == writes
    assert 0 < results["port"][1] <= writes


# ---- fault seams ---------------------------------------------------------------


def test_transient_read_during_remote_replay_is_retried():
    wal = _wal("port")
    wal.append(1, 0, 0, _batch("port", ["a"], [10], [1.0]))
    before = RETRY_ATTEMPTS.get(point="objectstore.read")
    FAULTS.arm("objectstore.read", Fault(kind="fail", nth=1))
    assert [e.seq for e in wal.replay(1)] == [0]
    FAULTS.arm("wal.replay", Fault(kind="fail", nth=1))
    assert [e.seq for e in wal.replay(1)] == [0]
    assert RETRY_ATTEMPTS.get(point="objectstore.read") == before + 1


def test_enospc_remote_append_leaves_no_segment():
    wal = _wal("port")
    wal.append(1, 0, 0, _batch("port", ["a"], [10], [1.0]))
    FAULTS.arm("wal.append", Fault(kind="enospc", arg=0.7))
    with pytest.raises(FaultError) as e:
        wal.append(1, 1, 0, _batch("port", ["b"], [20], [2.0]))
    assert e.value.kind == "enospc"
    FAULTS.reset()
    assert wal.store.list("wal/1/") == ["wal/1/" + f"{0:020d}"]
    assert [e.seq for e in wal.replay(1)] == [0]


def test_torn_remote_append_is_cut_at_replay():
    wal = _wal("port")
    wal.append_many(1, [(0, 0, _batch("port", ["a"], [10], [1.0]))])
    FAULTS.arm("wal.append", Fault(kind="torn", arg=0.9))
    with pytest.raises(FaultError):
        wal.append_many(1, [(1, 0, _batch("port", ["b"], [20], [2.0])),
                            (2, 0, _batch("port", ["c"], [30], [3.0]))])
    FAULTS.reset()
    # the partial segment stays (segments are separate objects); its
    # intact first frame replays, the torn second does not
    assert len(wal.store.list("wal/1/")) == 2
    assert [e.seq for e in wal.replay(1)] == [0, 1]
    wal.append_many(1, [(3, 0, _batch("port", ["d"], [40], [4.0]))])
    assert [e.seq for e in wal.replay(1)] == [0, 1, 3]


@pytest.mark.parametrize("kind", ["torn", "enospc", "short_read"])
def test_local_append_fault_leaves_only_whole_frames(tmp_path, kind):
    """The local WAL: a torn or enospc append (and a short write, which
    surfaces as torn) is truncated before the error surfaces; the next
    append and replay see only whole acknowledged frames."""
    wal = Wal(str(tmp_path / "wal"))
    wal.append(1, 0, 0, _batch("port", ["a"], [10], [1.0]))
    FAULTS.arm("wal.append", Fault(kind=kind, arg=0.5))
    with pytest.raises(FaultError):
        wal.append(1, 1, 0, _batch("port", ["b"], [20], [2.0]))
    FAULTS.reset()
    wal.append(1, 2, 0, _batch("port", ["c"], [30], [3.0]))
    assert [e.seq for e in wal.replay(1)] == [0, 2]
    wal.close()


def test_short_read_on_local_replay_rereads(tmp_path):
    wal = Wal(str(tmp_path / "wal"))
    wal.append(1, 0, 0, _batch("port", ["a"], [10], [1.0]))
    wal.close_region(1)
    before = RETRY_ATTEMPTS.get(point="wal.replay")
    FAULTS.arm("wal.replay", Fault(kind="short_read", nth=1, arg=0.5))
    assert [e.seq for e in wal.replay(1)] == [0]
    assert RETRY_ATTEMPTS.get(point="wal.replay") == before + 1
    wal.close()
