"""Durable storage of the port against the JAX package's, on the CPU.

The same seeded writes go into both packages' WALs, regions and engines
(each in its own data dir, each in its own encoding: the port writes
numpy buffers, the JAX package Arrow IPC and Parquet); after every step
both scans must hold the same rows, sequences and op types. Mirrors
tests/test_storage.py (TestWal, TestRegionEngine) and
tests/test_compaction_index.py (TestTwcsPicker, TestRegionCompaction),
plus the port's own format stamp, SST layout, manifest and device hot
set invalidation.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.catalog import Catalog, FileKv, MemoryKv
from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    DictVector,
    RecordBatch,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.objectstore import FsStore, MemoryStore
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.compaction import (
    TwcsOptions,
    TwcsPicker,
    infer_time_window_ms,
)
from greptimedb_tpu_torch.storage.format import (
    FORMAT_VERSIONS,
    FormatError,
    check_and_stamp,
)
from greptimedb_tpu_torch.storage.manifest import (
    CHECKPOINT_DISTANCE,
    ManifestManager,
)
from greptimedb_tpu_torch.storage.region import OP_DELETE
from greptimedb_tpu_torch.storage.sst import FileMeta, SstReader, SstWriter
from greptimedb_tpu_torch.storage.wal import Wal, decode_batch, encode_batch


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines here decode SST parts inline: the JAX package's
    process-wide decode pool would leave idle worker threads in this test
    process, and tests/test_profile_plane.py's sampler counts them when
    xdist runs that file later on the same worker."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


HOUR_MS = 3_600_000


# ---- one schema and one batch, in both packages -------------------------------


def _schemas():
    import greptimedb_tpu.datatypes as J

    spec = [("ts", "timestamp_ms", "timestamp"), ("hostname", "string", "tag"),
            ("usage_user", "float64", "field")]
    port = Schema([ColumnSchema(n, DataType(d), SemanticType(s))
                   for n, d, s in spec])
    jax_ = J.Schema([J.ColumnSchema(n, J.DataType(d), J.SemanticType(s))
                     for n, d, s in spec])
    return port, jax_


def _batches(hosts, ts, usage):
    """(port batch, JAX batch) over the same arrays."""
    import greptimedb_tpu.datatypes as J

    ps, js = _schemas()
    ts = np.asarray(ts, dtype=np.int64)
    usage = np.asarray(usage, dtype=np.float64)
    return (RecordBatch(ps, {"ts": ts, "hostname": DictVector.encode(hosts),
                             "usage_user": usage}),
            J.RecordBatch(js, {"ts": ts,
                               "hostname": J.DictVector.encode(hosts),
                               "usage_user": usage}))


class Engines:
    """A port RegionEngine and a JAX RegionEngine driven in lockstep."""

    def __init__(self, root, **cfg):
        self.root = root
        self.cfg = cfg
        self.open()

    def open(self):
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig

        self.port = RegionEngine(EngineConfig(
            data_dir=os.path.join(self.root, "port"), maintenance_workers=0,
            **self.cfg), device="cpu")
        self.jax = JRegionEngine(JConfig(
            data_dir=os.path.join(self.root, "jax"), maintenance_workers=0,
            **self.cfg))

    def reopen(self, rid):
        self.close()
        self.open()
        self.port.open_region(rid)
        self.jax.open_region(rid)

    def close(self):
        self.port.close()
        self.jax.close()

    def create(self, rid):
        ps, js = _schemas()
        self.port.create_region(rid, ps)
        self.jax.create_region(rid, js)

    def put(self, rid, hosts, ts, usage):
        p, j = _batches(hosts, ts, usage)
        assert self.port.put(rid, p) == self.jax.put(rid, j)

    def delete(self, rid, hosts, ts):
        p, j = _batches(hosts, ts, [np.nan] * len(ts))
        assert self.port.delete(rid, p) == self.jax.delete(rid, j)

    def call(self, name, rid):
        getattr(self.port, name)(rid)
        getattr(self.jax, name)(rid)

    def rows(self, rid, **scan_kw):
        """The port's scan rows, asserted equal to the JAX engine's."""
        got = _scan_rows(self.port.scan(rid, **scan_kw))
        assert got == _scan_rows(self.jax.scan(rid, **scan_kw))
        return got


def _scan_rows(scan):
    """A scan as sorted (host, ts, usage, seq, op) tuples."""
    if scan is None:
        return []
    d = scan.tag_dicts["hostname"]
    out = []
    for i in range(scan.num_rows):
        code = int(scan.columns["hostname"][i])
        u = float(scan.columns["usage_user"][i])
        out.append((None if code < 0 else str(d[code]),
                    int(scan.columns["ts"][i]),
                    None if u != u else u,
                    int(scan.seq[i]), int(scan.op_type[i])))
    return sorted(out, key=repr)


@pytest.fixture
def engines(tmp_path):
    e = Engines(str(tmp_path))
    yield e
    e.close()


# ---- WAL ------------------------------------------------------------------------


def _wal_pair(tmp_path, **kw):
    from greptimedb_tpu.storage.wal import Wal as JWal

    return Wal(str(tmp_path / "port"), **kw), JWal(str(tmp_path / "jax"),
                                                    **kw)


def _entries(wal, rid, **kw):
    out = []
    for e in wal.replay(rid, **kw):
        cols = e.batch.columns
        out.append((e.seq, e.op_type, cols["hostname"].decode().tolist(),
                    np.asarray(cols["ts"]).tolist(),
                    np.asarray(cols["usage_user"]).tolist()))
    return out


class TestWal:
    def test_append_replay(self, tmp_path):
        wals = _wal_pair(tmp_path)
        for w, k in zip(wals, (0, 1)):
            w.append(1, 0, 0, _batches(["a", "b"], [10, 20], [1.0, 2.0])[k])
            w.append(1, 2, 0, _batches(["c"], [30], [3.0])[k])
            w.append(2, 0, 0, _batches(["z"], [99], [9.0])[k])
        port, jax_ = wals
        got = _entries(port, 1)
        assert got == _entries(jax_, 1)
        assert [e[0] for e in got] == [0, 2]
        assert got[0][2] == ["a", "b"]
        assert _entries(port, 1, from_seq=1) == _entries(jax_, 1, from_seq=1)
        assert [e[0] for e in _entries(port, 1, from_seq=1)] == [2]
        for w in wals:
            w.close()

    def test_torn_tail_truncated(self, tmp_path):
        """A torn last frame is truncated; every whole entry before it
        replays."""
        wals = _wal_pair(tmp_path)
        for w, k in zip(wals, (0, 1)):
            for i in range(3):
                w.append(1, i, 0, _batches([f"h{i}"], [i * 10],
                                           [float(i)])[k])
            w.close()
        for sub in ("port", "jax"):
            [path] = glob.glob(str(tmp_path / sub / "region_1.*.wal"))
            with open(path, "r+b") as f:
                f.seek(0, 2)
                f.truncate(f.tell() - 7)  # corrupt the last frame
        port, jax_ = _wal_pair(tmp_path)
        got = _entries(port, 1)
        assert [e[0] for e in got] == [0, 1]
        assert got == _entries(jax_, 1)
        # the truncation is durable: the file now ends at the last whole
        # frame, and appends continue after it
        port.append(1, 2, 0, _batches(["x"], [5], [5.0])[0])
        assert [e[0] for e in _entries(port, 1)] == [0, 1, 2]
        port.close()
        jax_.close()

    def test_corrupt_payload_stops_replay(self, tmp_path):
        wal = Wal(str(tmp_path / "w"))
        for i in range(3):
            wal.append(1, i, 0, _batches([f"h{i}"], [i], [float(i)])[0])
        wal.close()
        [path] = glob.glob(str(tmp_path / "w" / "region_1.*.wal"))
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size * 2 // 3)
            b = f.read(1)
            f.seek(size * 2 // 3)
            f.write(bytes([b[0] ^ 0xFF]))  # a flipped byte in frame 3
        assert [e.seq for e in Wal(str(tmp_path / "w")).replay(1)] == [0, 1]

    def test_obsolete_drops_sealed_segments(self, tmp_path):
        wals = _wal_pair(tmp_path, segment_bytes=1)  # roll every append
        for w, k, sub in zip(wals, (0, 1), ("port", "jax")):
            for i in range(4):
                w.append(1, i, 0, _batches([f"h{i}"], [i * 10],
                                           [float(i)])[k])
            # 4 sealed segments + 1 empty active one
            assert len(glob.glob(str(tmp_path / sub / "region_1.*.wal"))) \
                == 5
            w.obsolete(1, 3)
            # segments holding seqs 0-2 deleted; seq-3 one + active kept
            assert len(glob.glob(str(tmp_path / sub / "region_1.*.wal"))) \
                == 2
        assert _entries(wals[0], 1, from_seq=3) \
            == _entries(wals[1], 1, from_seq=3)
        assert [e[0] for e in _entries(wals[0], 1, from_seq=3)] == [3]
        for w in wals:
            w.close()

    def test_segment_roll_and_replay_order(self, tmp_path):
        wals = _wal_pair(tmp_path, segment_bytes=1)
        for w, k in zip(wals, (0, 1)):
            for i in range(5):
                w.append(1, i, 0, _batches([f"h{i}"], [i], [float(i)])[k])
            w.close()
        port, jax_ = _wal_pair(tmp_path, segment_bytes=1)
        assert [e[0] for e in _entries(port, 1)] == [0, 1, 2, 3, 4]
        # appends continue after reopen, in the last segment
        port.append(1, 5, 0, _batches(["h5"], [5], [5.0])[0])
        jax_.append(1, 5, 0, _batches(["h5"], [5], [5.0])[1])
        got = _entries(port, 1)
        assert [e[0] for e in got] == [0, 1, 2, 3, 4, 5]
        assert got == _entries(jax_, 1)
        port.close()
        jax_.close()

    def test_sync_default_on(self, tmp_path):
        wal = Wal(str(tmp_path / "w"))
        assert wal.sync is True
        assert EngineConfig(data_dir="x").wal_sync is True
        wal.append(1, 0, 0, _batches(["a"], [1], [1.0])[0])
        assert wal.sync_count == 1  # one fsync at the append boundary
        wal.close()

    def test_codec_round_trip(self):
        """NULL tags (code -1), NULL floats (NaN), string, bool and int
        fields, and an empty batch survive the payload codec."""
        schema = Schema([
            ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                         SemanticType.TIMESTAMP),
            ColumnSchema("host", DataType.STRING, SemanticType.TAG),
            ColumnSchema("note", DataType.STRING, SemanticType.FIELD),
            ColumnSchema("ok", DataType.BOOL, SemanticType.FIELD),
            ColumnSchema("n", DataType.INT32, SemanticType.FIELD),
            ColumnSchema("v", DataType.FLOAT32, SemanticType.FIELD)])
        batch = RecordBatch(schema, {
            "ts": np.arange(4, dtype=np.int64),
            "host": DictVector.encode(["a", None, "b", "a"]),
            "note": np.asarray(["x", None, "y", "x"], dtype=object),
            "ok": np.asarray([True, False, True, True]),
            "n": np.asarray([1, -2, 3, 4], dtype=np.int32),
            "v": np.asarray([1.5, np.nan, -0.0, 2.0], dtype=np.float32)})
        blob = b"".join(bytes(p) for p in encode_batch(batch))
        out = decode_batch(blob)
        assert out.schema.to_dict() == schema.to_dict()
        assert out.columns["host"].decode().tolist() == ["a", None, "b", "a"]
        assert out.columns["note"].decode().tolist() == ["x", None, "y", "x"]
        for name in ("ts", "ok", "n", "v"):
            np.testing.assert_array_equal(out.columns[name],
                                          batch.columns[name])
            assert out.columns[name].dtype == batch.columns[name].dtype
        empty = decode_batch(b"".join(
            bytes(p) for p in encode_batch(batch.slice(0, 0))))
        assert empty.num_rows == 0

    def test_crash_mid_write_engine_recovery(self, tmp_path, engines):
        """Acknowledged rows survive a torn trailing frame after reopen."""
        engines.create(1)
        engines.put(1, ["a", "b"], [10, 20], [1.0, 2.0])
        engines.call("flush", 1)
        engines.put(1, ["c"], [30], [3.0])
        engines.put(1, ["d"], [40], [4.0])
        engines.close()
        for sub in ("port", "jax"):
            seg = sorted(glob.glob(str(tmp_path / sub / "wal"
                                       / "region_1.*.wal")))[-1]
            with open(seg, "r+b") as f:
                f.seek(0, 2)
                f.truncate(f.tell() - 5)
        engines.open()
        engines.port.open_region(1)
        engines.jax.open_region(1)
        rows = engines.rows(1)
        assert {r[0] for r in rows} == {"a", "b", "c"}


# ---- format stamp, SST, manifest ------------------------------------------------


class TestFormat:
    def test_port_refuses_a_jax_data_dir(self, tmp_path):
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig

        d = str(tmp_path / "jax")
        JRegionEngine(JConfig(data_dir=d, maintenance_workers=0)).close()
        with pytest.raises(FormatError, match="do not read each other"):
            RegionEngine(EngineConfig(data_dir=d), device="cpu")

    def test_jax_refuses_a_port_data_dir(self, tmp_path):
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig
        from greptimedb_tpu.storage.format import FormatError as JFormatError

        d = str(tmp_path / "port")
        RegionEngine(EngineConfig(data_dir=d), device="cpu").close()
        with pytest.raises(JFormatError):
            JRegionEngine(JConfig(data_dir=d, maintenance_workers=0))

    def test_unstamped_data_and_newer_versions_are_refused(self, tmp_path):
        d = tmp_path / "d"
        d.mkdir()
        (d / "wal").mkdir()
        with pytest.raises(FormatError, match="no FORMAT.json"):
            check_and_stamp(str(d))
        d2 = tmp_path / "d2"
        d2.mkdir()
        assert check_and_stamp(str(d2)) == FORMAT_VERSIONS
        stamp = json.loads((d2 / "FORMAT.json").read_text())
        stamp["versions"]["torch.sst"] += 1
        (d2 / "FORMAT.json").write_text(json.dumps(stamp))
        with pytest.raises(FormatError, match="newer build"):
            check_and_stamp(str(d2))


@pytest.mark.parametrize("store", [FsStore, MemoryStore])
def test_sst_round_trip_and_row_group_pruning(tmp_path, store):
    store = store()
    ps, _ = _schemas()
    n = 10
    cols = {"ts": np.arange(n, dtype=np.int64) * 100,
            "hostname": np.asarray([0, 1, -1, 0, 1, 0, 1, 0, 1, 0],
                                   dtype=np.int32),
            "usage_user": np.linspace(0, 1, n)}
    dicts = {"hostname": np.asarray(["a", "b"], dtype=object)}
    w = SstWriter(str(tmp_path), ps, row_group_size=4, store=store)
    meta = w.write(cols, dicts, np.arange(n, dtype=np.int64),
                   np.zeros(n, dtype=np.int8))
    assert (meta.num_rows, meta.ts_min, meta.ts_max, meta.max_seq) \
        == (10, 0, 900, 9)
    assert meta.null_tags == ["hostname"]
    path = str(tmp_path / (meta.file_id + ".sst"))
    # the SST and its inverted index (storage/index.py) beside it
    assert store.list(str(tmp_path) + os.sep) == sorted(
        [path, str(tmp_path / (meta.file_id + ".puffin"))])
    assert meta.size_bytes == store.size(path)
    r = SstReader(str(tmp_path), store)
    part = r.read(meta, ps)
    for name in cols:
        np.testing.assert_array_equal(part.columns[name], cols[name])
    assert part.dicts["hostname"].tolist() == ["a", "b"]
    # row groups [0,4) [4,8) [8,10): ts 400..799 reads only the middle one
    part = r.read(meta, ps, ts_range=(400, 800), projection=["usage_user"])
    np.testing.assert_array_equal(part.columns["ts"], cols["ts"][4:8])
    assert set(part.columns) == {"ts", "usage_user", "__seq", "__op_type"}
    assert r.read(meta, ps, ts_range=(5000, 6000)) is None
    empty = w.write({k: v[:0] for k, v in cols.items()}, dicts,
                    np.empty(0, np.int64), np.empty(0, np.int8))
    assert empty.num_rows == 0 and r.read(empty, ps) is None
    r.delete(meta.file_id)
    assert store.list(str(tmp_path) + os.sep) == [
        str(tmp_path / (empty.file_id + ".sst"))]


def test_manifest_checkpoint_and_flushed_seq(tmp_path):
    ps, _ = _schemas()
    m = ManifestManager(str(tmp_path / "manifest"))
    m.record_schema(ps)
    flushes = CHECKPOINT_DISTANCE - 2
    for i in range(flushes):
        m.record_flush([FileMeta(f"f{i}", 1, i, i, i)], flushed_seq=i + 1,
                       tag_dicts={"hostname": ["a"]})
    # a compaction edit (the tenth action): files swap, flushed_seq stays
    m.record_flush([FileMeta("merged", 2, 0, 1, 1, level=1)],
                   flushed_seq=None, tag_dicts={"hostname": ["a", "b"]},
                   removed=["f0", "f1"])
    assert m.state.flushed_seq == flushes
    # the checkpoint replaced the deltas before it
    assert os.listdir(tmp_path / "manifest") == [
        f"{CHECKPOINT_DISTANCE + 1:010d}.json"]
    again = ManifestManager(str(tmp_path / "manifest"))
    assert again.state.flushed_seq == flushes
    assert sorted(again.state.files) == sorted(
        ["merged"] + [f"f{i}" for i in range(2, flushes)])
    assert again.state.tag_dicts == {"hostname": ["a", "b"]}
    assert again.state.schema.to_dict() == ps.to_dict()


# ---- region engine ------------------------------------------------------------


class TestRegionEngine:
    def test_write_scan_memtable_only(self, engines):
        engines.create(1)
        engines.put(1, ["h0", "h1", "h0"], [10, 20, 30], [1.0, 2.0, 3.0])
        scan = engines.port.scan(1)
        assert scan.num_rows == 3
        assert scan.columns["hostname"].tolist() == [0, 1, 0]
        assert scan.tag_dicts["hostname"].tolist() == ["h0", "h1"]
        assert len(engines.rows(1)) == 3

    def test_flush_and_scan_sst(self, engines):
        engines.create(1)
        engines.put(1, ["h1", "h0"], [20, 10], [2.0, 1.0])
        engines.call("flush", 1)
        engines.put(1, ["h0"], [30], [3.0])
        rows = engines.rows(1)
        assert {(h, t) for h, t, *_ in rows} == {("h0", 10), ("h1", 20),
                                                  ("h0", 30)}
        scan = engines.port.scan(1)
        # one SST part, sorted by (tag, ts), then the memtable tail
        assert scan.sorted_part_offsets == (0, 2)
        assert len(scan.part_keys) == 1 and scan.part_keys[0][1:] \
            == (None, None)
        assert scan.columns["ts"][:2].tolist() == [10, 20]

    def test_time_range_pruning(self, engines):
        engines.create(1)
        engines.put(1, ["a"], [100], [1.0])
        engines.call("flush", 1)
        engines.put(1, ["a"], [5000], [2.0])
        engines.call("flush", 1)
        # the range covers less than half the span: an exact, narrowed scan
        rows = engines.rows(1, ts_range=(0, 1000))
        assert [r[1] for r in rows] == [100]
        assert engines.port.scan(1, ts_range=(99999, 100000)) is None

    def test_exact_ts_filter_on_sst_parts(self, engines):
        """One flushed file spans the range; the decoded part keeps only
        the window's rows (the JAX region's _decode_table_part)."""
        engines.create(1)
        engines.put(1, ["a"] * 10, list(range(0, 1000, 100)), [1.0] * 10)
        engines.call("flush", 1)
        rows = engines.rows(1, ts_range=(200, 400))
        assert [r[1] for r in rows] == [200, 300]
        scan = engines.port.scan(1, ts_range=(200, 400))
        assert scan.part_keys[0][1] == (200, 400)

    def test_reopen_replays_wal_and_manifest(self, tmp_path, engines):
        engines.create(7)
        engines.put(7, ["a", "b"], [10, 20], [1.0, 2.0])
        engines.call("flush", 7)
        engines.put(7, ["c"], [30], [3.0])  # only in WAL + memtable
        engines.delete(7, ["a"], [10])
        engines.reopen(7)
        rows = engines.rows(7)
        assert {r[0] for r in rows} == {"a", "b", "c"}
        region = engines.port.region(7)
        # codes stable across restart: 'a'->0, 'b'->1, 'c'->2
        assert region.registry.dict_array("hostname").tolist() \
            == ["a", "b", "c"]
        # only the entries past flushed_seq replayed
        assert region.manifest.state.flushed_seq == 2
        assert region.replayed_entries == 2
        assert region.next_seq == 4

    def test_registry_codes_survive_restart_in_snapshot_order(self,
                                                             engines):
        """Codes come from the flush's registry snapshot, in its order —
        not re-sorted — so file-anchored device blocks keep meaning."""
        engines.create(1)
        engines.put(1, ["zz", "aa"], [1, 2], [1.0, 2.0])
        engines.put(1, ["mm"], [3], [3.0])
        engines.call("flush", 1)
        before = engines.port.region(1).registry.dict_array("hostname")
        engines.reopen(1)
        after = engines.port.region(1).registry.dict_array("hostname")
        assert before.tolist() == after.tolist() == ["aa", "zz", "mm"]
        engines.rows(1)

    def test_delete_tombstone_visible_to_scan(self, engines):
        engines.create(1)
        engines.put(1, ["a"], [10], [1.0])
        engines.delete(1, ["a"], [10])
        scan = engines.port.scan(1)
        assert scan.op_type.tolist() == [0, OP_DELETE]
        assert scan.seq.tolist() == [0, 1]
        engines.rows(1)

    def test_compact_merges_and_dedups(self, engines):
        engines.create(1)
        engines.put(1, ["a", "b"], [10, 20], [1.0, 2.0])
        engines.call("flush", 1)
        engines.put(1, ["a"], [10], [9.0])  # overwrite
        engines.call("flush", 1)
        engines.call("compact", 1)
        assert len(engines.port.region(1).files) == 1
        rows = engines.rows(1)
        assert [(h, t, v) for h, t, v, _, _ in rows] == [("a", 10, 9.0),
                                                        ("b", 20, 2.0)]

    def test_compaction_never_advances_flushed_seq(self, engines):
        engines.create(1)
        engines.put(1, ["a"], [10], [1.0])
        engines.call("flush", 1)
        engines.put(1, ["b"], [20], [2.0])
        engines.call("flush", 1)
        engines.put(1, ["c"], [30], [3.0])  # acknowledged, unflushed
        region = engines.port.region(1)
        flushed = region.manifest.state.flushed_seq
        engines.call("compact", 1)
        assert region.manifest.state.flushed_seq == flushed == 2
        engines.reopen(1)
        assert {r[0] for r in engines.rows(1)} == {"a", "b", "c"}
        assert engines.port.region(1).replayed_entries == 1

    def test_projection_keeps_key_columns(self, engines):
        engines.create(1)
        engines.put(1, ["a"], [10], [1.0])
        scan = engines.port.scan(1, projection=["usage_user"])
        assert set(scan.columns) == {"hostname", "ts", "usage_user"}

    def test_auto_flush_and_twcs_at_the_threshold(self, tmp_path):
        """Past flush_threshold_bytes a write flushes, then TWCS runs;
        both engines flush at the same points."""
        e = Engines(str(tmp_path), flush_threshold_bytes=1)
        e.create(1)
        for i in range(6):
            e.put(1, ["a", "b"], [i * 10, i * 10 + 5], [float(i)] * 2)
            port_files = sorted(f.num_rows for f in
                                e.port.region(1).files.values())
            jax_files = sorted(f.num_rows for f in
                               e.jax.region(1).files.values())
            assert port_files == jax_files
            assert e.port.region(1).memtable.is_empty()
            e.rows(1)
        # the fifth L0 file in one window passed max_active_window_files
        assert len(e.port.region(1).files) < 6
        e.close()


# ---- TWCS ---------------------------------------------------------------------


def _fm(i, ts_min, ts_max, level=0):
    return FileMeta(file_id=f"f{i}", num_rows=100, ts_min=ts_min,
                    ts_max=ts_max, max_seq=i, level=level)


def _picks(files, **opts):
    """Groups picked by the port's TwcsPicker, asserted equal to the JAX
    picker's on the same files."""
    from greptimedb_tpu.storage import compaction as J
    from greptimedb_tpu.storage.sst import FileMeta as JFileMeta

    got = TwcsPicker(TwcsOptions(**opts)).pick(files)
    jfiles = [JFileMeta(**f.to_dict()) for f in files]
    want = J.TwcsPicker(J.TwcsOptions(**opts)).pick(jfiles)
    ids = [[f.file_id for f in g] for g in got]
    assert ids == [[f.file_id for f in g] for g in want]
    return ids


class TestTwcsPicker:
    def test_no_compaction_under_limits(self):
        assert _picks([_fm(1, 0, 100), _fm(2, 100, 200)],
                      time_window_ms=HOUR_MS) == []

    def test_active_window_compacts_over_limit(self):
        groups = _picks([_fm(i, 0, 1000 + i) for i in range(4)],
                        time_window_ms=HOUR_MS, max_active_window_files=2)
        assert len(groups) == 1 and len(groups[0]) == 4

    def test_inactive_window_compacts_at_two(self):
        old = [_fm(1, 0, 100), _fm(2, 50, 200)]  # window 0
        active = [_fm(3, 2 * HOUR_MS, 2 * HOUR_MS + 10)]  # window 2
        assert _picks(old + active, time_window_ms=HOUR_MS) \
            == [["f1", "f2"]]

    def test_window_inference(self):
        from greptimedb_tpu.storage import compaction as J

        for span, want in ((30 * 60 * 1000, HOUR_MS),
                           (5 * 24 * HOUR_MS, 7 * 24 * HOUR_MS)):
            assert infer_time_window_ms([_fm(1, 0, span)]) == want \
                == J.infer_time_window_ms([_fm(1, 0, span)])


# ---- compaction through SQL, both engines --------------------------------------


class Sql:
    """A JAX QueryEngine and a port QueryEngine over the same statements."""

    def __init__(self, root):
        from greptimedb_tpu.catalog import Catalog as JCatalog
        from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
        from greptimedb_tpu.query import QueryEngine as JQueryEngine
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig

        self.jengine = JRegionEngine(JConfig(
            data_dir=os.path.join(root, "jax"), maintenance_workers=0))
        self.j = JQueryEngine(JCatalog(JMemoryKv()), self.jengine)
        self.tengine = RegionEngine(
            EngineConfig(data_dir=os.path.join(root, "port"), maintenance_workers=0), device="cpu")
        self.t = QueryEngine(Catalog(MemoryKv()), self.tengine, device="cpu")
        self.both("CREATE TABLE cpu (host STRING, usage DOUBLE, "
                  "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host))")

    def both(self, sql):
        jr = self.j.execute_one(sql)
        tr = self.t.execute_one(sql)
        if jr.is_query:
            assert [[str(v) if isinstance(v, str) else v for v in r]
                    for r in tr.rows()] == jr.rows()
        return tr.rows() if tr.is_query else None

    def regions(self):
        rid = self.t.catalog.table("public", "cpu").region_ids[0]
        return self.tengine.region(rid), self.jengine.region(rid)

    def check(self):
        """Every row of both engines, through SQL and through the scans."""
        self.both("SELECT host, ts, usage FROM cpu ORDER BY host, ts")
        p, j = self.regions()
        assert _sql_scan_rows(p.scan()) == _sql_scan_rows(j.scan())

    def close(self):
        self.jengine.close()
        self.tengine.close()


def _sql_scan_rows(scan):
    if scan is None:
        return []
    d = scan.tag_dicts["host"]
    return sorted((str(d[c]), int(t), int(s), int(o)) for c, t, s, o in zip(
        scan.columns["host"], scan.columns["ts"], scan.seq, scan.op_type))


@pytest.fixture
def sql(tmp_path):
    s = Sql(str(tmp_path))
    yield s
    s.close()


class TestRegionCompaction:
    def test_twcs_merges_same_window(self, sql):
        for i in range(5):
            sql.both(f"INSERT INTO cpu (host, usage, ts) VALUES "
                     f"('h{i}', {i}.0, {1000 + i})")
            for r in sql.regions():
                r.flush()
            sql.check()
        p, j = sql.regions()
        assert len(p.files) == 5
        assert len(p.compact()) == len(j.compact()) == 1
        assert [f.level for f in p.files.values()] == [1]
        assert sql.both("SELECT count(*) FROM cpu") == [[5]]
        sql.check()

    def test_windowed_compaction_preserves_lww(self, sql):
        sql.both("INSERT INTO cpu (host, usage, ts) VALUES ('a', 1.0, 1000)")
        for r in sql.regions():
            r.flush()
        sql.both("INSERT INTO cpu (host, usage, ts) VALUES ('a', 9.0, 1000)")
        for r in sql.regions():
            r.flush()
        for i in range(3):
            sql.both(f"INSERT INTO cpu (host, usage, ts) VALUES "
                     f"('b', {i}.0, {2000 + i})")
            for r in sql.regions():
                r.flush()
        for r in sql.regions():
            r.compact()
        assert sql.both("SELECT usage FROM cpu WHERE host = 'a'") == [[9.0]]
        sql.check()

    def test_partial_compaction_keeps_tombstones(self, sql):
        """Put in file A, delete in file B, more in file C; merging only
        B and C keeps the tombstone (keep_tombstones=not covers_all)."""
        sql.both("INSERT INTO cpu (host, usage, ts) VALUES ('a', 1.0, 1000)")
        for r in sql.regions():
            r.flush()
        sql.both("DELETE FROM cpu WHERE host = 'a'")
        for r in sql.regions():
            r.flush()
        sql.both("INSERT INTO cpu (host, usage, ts) VALUES ('b', 2.0, 2000)")
        for r in sql.regions():
            r.flush()
        for r in sql.regions():
            r._merge_files(sorted(r.files.values(),
                                  key=lambda f: f.max_seq)[1:])
        assert sql.both("SELECT host FROM cpu ORDER BY host") == [["b"]]
        p, _ = sql.regions()
        assert sorted(f.num_rows for f in p.files.values()) == [1, 2]
        sql.check()

    def test_full_compaction_drops_tombstones(self, sql):
        sql.both("INSERT INTO cpu (host, usage, ts) VALUES ('a', 1.0, 1000)")
        for r in sql.regions():
            r.flush()
        sql.both("DELETE FROM cpu WHERE host = 'a'")
        for r in sql.regions():
            r.flush()
        sql.both("ADMIN compact_table('cpu')")
        p, _ = sql.regions()
        assert len(p.files) == 1
        assert sql.both("SELECT count(*) FROM cpu") == [[0]]
        # the merged file holds no tombstone rows
        assert list(p.files.values())[0].num_rows == 0
        sql.check()

    def test_alter_truncate_and_delete(self, sql):
        for i in range(4):
            sql.both(f"INSERT INTO cpu (host, usage, ts) VALUES "
                     f"('h{i % 2}', {i}.5, {1000 * i})")
        sql.both("ADMIN flush_table('cpu')")
        sql.both("ALTER TABLE cpu ADD COLUMN extra DOUBLE")
        sql.both("INSERT INTO cpu (host, usage, ts, extra) VALUES "
                 "('h2', 7.0, 9000, 1.25)")
        sql.both("SELECT host, ts, extra FROM cpu ORDER BY host, ts")
        sql.both("DELETE FROM cpu WHERE usage > 2")
        sql.both("SELECT host, count(*), count(extra) FROM cpu "
                 "GROUP BY host ORDER BY host")
        sql.both("ALTER TABLE cpu DROP COLUMN extra")
        sql.both("SELECT * FROM cpu ORDER BY host, ts")
        sql.both("ADMIN compact_table('cpu')")
        sql.check()
        sql.both("TRUNCATE TABLE cpu")
        assert sql.both("SELECT count(*) FROM cpu") == [[0]]
        sql.both("INSERT INTO cpu (host, usage, ts) VALUES ('z', 1.0, 5)")
        sql.check()


# ---- durable query engine and the device hot set --------------------------------


def test_reopened_catalog_serves_its_tables(tmp_path):
    """A FileKv catalog and a reopened engine open regions lazily."""
    def open_engine():
        engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d")),
                              device="cpu")
        return engine, QueryEngine(Catalog(FileKv(str(tmp_path / "c.json"))),
                                   engine, device="cpu")

    engine, qe = open_engine()
    qe.execute_one("CREATE TABLE t (h STRING, ts TIMESTAMP(3) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (h))")
    qe.execute_one("INSERT INTO t VALUES ('a', 1, 1.0), ('b', 2, 2.0)")
    engine.close()
    engine, qe = open_engine()
    assert engine.regions == {}
    assert qe.execute_one("SELECT h, v FROM t ORDER BY h").rows() \
        == [["a", 1.0], ["b", 2.0]]
    qe.execute_one("DROP TABLE t")
    engine.close()
    engine, qe = open_engine()
    assert not qe.catalog.table_exists("public", "t")
    engine.close()


def test_device_blocks_die_with_their_files(tmp_path):
    """File-anchored blocks survive writes (a newer snapshot retires only
    snapshot blocks), die exactly with the files a compaction removes,
    and all die on TRUNCATE."""
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path),
                                       maintenance_workers=0), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    qe.execute_one("CREATE TABLE t (h STRING, ts TIMESTAMP(3) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (h)) "
                   "WITH (append_mode = 'true')")
    rid = qe.catalog.table("public", "t").region_ids[0]
    region = engine.region(rid)
    cache = qe.executor.cache
    sql = "SELECT h, sum(v) FROM t GROUP BY h ORDER BY h"
    for k in range(3):
        qe.execute_one(f"INSERT INTO t VALUES ('a', {k}, 1.0), "
                       f"('b', {k}, 2.0)")
        region.flush()
    qe.execute_one("INSERT INTO t VALUES ('a', 100, 5.0)")  # memtable tail
    assert qe.execute_one(sql).rows() == [["a", 8.0], ["b", 6.0]]
    files = set(region.files)
    assert {k[2] for k in cache.file_keys(rid)} == files
    qe.execute_one("INSERT INTO t VALUES ('b', 101, 1.0)")
    assert qe.execute_one(sql).rows() == [["a", 8.0], ["b", 7.0]]
    assert {k[2] for k in cache.file_keys(rid)} == files  # not retired
    region.flush()
    qe.execute_one(sql)
    doomed = set(region.files)
    qe.execute_one("ADMIN compact_table('t')")
    (merged,) = region.files
    assert not {k[2] for k in cache.file_keys(rid)} & doomed
    assert qe.execute_one(sql).rows() == [["a", 8.0], ["b", 7.0]]
    assert {k[2] for k in cache.file_keys(rid)} == {merged}
    qe.execute_one("TRUNCATE TABLE t")
    assert cache.file_keys(rid) == [] and cache.resident_bytes == 0
    engine.close()


def test_compaction_runs_sort_dedup_on_the_engine_device(tmp_path,
                                                          monkeypatch):
    from greptimedb_tpu_torch.ops import dedup

    seen = []
    real = dedup.sort_dedup

    def spy(sid, *a, **kw):
        seen.append(sid.device)
        return real(sid, *a, **kw)

    monkeypatch.setattr(dedup, "sort_dedup", spy)
    e = Engines(str(tmp_path))
    e.create(1)
    for i in range(2):
        e.put(1, ["a"], [i], [1.0])
        e.call("flush", 1)
    e.call("compact", 1)
    assert seen == [torch.device("cpu")]
    e.close()


def test_block_plan_aligns_to_parts_and_falls_back():
    """Blocks never straddle SST parts and the memtable tail has no part
    identity; past _MAX_PLAN_BLOCKS parts the plan goes uniform."""
    from types import SimpleNamespace

    from greptimedb_tpu_torch.query.physical import (
        _MAX_PLAN_BLOCKS,
        _block_plan,
    )

    def scan(lens, tail):
        offs = np.cumsum([0] + lens).tolist()
        return SimpleNamespace(
            num_rows=offs[-1] + tail, sorted_part_offsets=tuple(offs),
            part_keys=tuple((f"f{i}", None, None) for i in range(len(lens))))

    plan = _block_plan(scan([3000, 500], 10))
    assert [(e.pkey and e.pkey[0], e.part_start, e.start, e.end, e.block)
            for e in plan] == [("f0", 0, 0, 3000, 4096),
                               ("f1", 3000, 3000, 3500, 1024),
                               (None, 3500, 3500, 3510, 1024)]
    many = _block_plan(scan([10] * (_MAX_PLAN_BLOCKS + 1), 0))
    assert [(e.pkey, e.start, e.end) for e in many] \
        == [(None, 0, 10 * (_MAX_PLAN_BLOCKS + 1))]


def test_string_int_and_bool_fields_survive_flush_restart_and_compaction(
        tmp_path):
    """Non-float fields through every encoding: WAL payload, SST dict
    and fixed-width columns, WAL replay, compaction."""
    from greptimedb_tpu_torch.catalog import FileKv as TFileKv

    def open_port():
        engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d")),
                              device="cpu")
        return engine, QueryEngine(Catalog(TFileKv(str(tmp_path / "c"))),
                                   engine, device="cpu")

    engine, qe = open_port()
    qe.execute_one("CREATE TABLE e (h STRING, ts TIMESTAMP(3) NOT NULL, "
                   "note STRING, n BIGINT, ok BOOLEAN, TIME INDEX (ts), "
                   "PRIMARY KEY (h))")
    qe.execute_one("INSERT INTO e VALUES ('a', 1, 'x', 5, true), "
                   "('b', 2, NULL, -3, false), (NULL, 3, 'y', 7, true)")
    qe.execute_one("ADMIN flush_table('e')")
    qe.execute_one("INSERT INTO e VALUES ('a', 4, 'z', 9, false)")
    sql = "SELECT h, ts, note, n, ok FROM e ORDER BY ts"
    want = [["a", 1, "x", 5, True], ["b", 2, None, -3, False],
            [None, 3, "y", 7, True], ["a", 4, "z", 9, False]]
    assert qe.execute_one(sql).rows() == want
    engine.close()
    engine, qe = open_port()
    assert qe.execute_one(sql).rows() == want
    qe.execute_one("ADMIN flush_table('e')")
    qe.execute_one("ADMIN compact_table('e')")
    assert qe.execute_one(sql).rows() == want
    engine.close()
