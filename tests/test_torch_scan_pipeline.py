"""The port's parallel scan decode against its own serial path and the
JAX region, on the CPU (twins of tests/test_scan_pipeline.py's
TestParallelDecode, the part-cache cases of TestPartCacheMutation,
TestFaultedDecode and TestStreamAndSeqMinParallel).

The same writes go into a port engine and a JAX engine. The port's
parallel result (decode_threads 4 on the engine's pool) must equal its
serial result (decode_threads 1) byte for byte, and both must hold the
JAX region's rows. The worker count is set through each engine's config,
never through GREPTIMEDB_TPU_SCAN_DECODE_THREADS: both packages read
that variable, so it would force the port serial along with the JAX
engine. The JAX engines decode inline (scan_decode_threads = 1), so no
JAX pool thread is left on the test worker. The JAX file's
test_process_cluster_parallel_decode_parity waits for the cluster slice
(ROADMAP A10).
"""

import threading
import time

import numpy as np
import pytest

from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    DictVector,
    RecordBatch,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.region import OP_DELETE
from greptimedb_tpu_torch.utils.metrics import SCAN_PART_CACHE_EVENTS

PARALLEL = 4


@pytest.fixture(autouse=True)
def _config_decides_the_workers(monkeypatch):
    monkeypatch.delenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", raising=False)


def _spec():
    return [("ts", "timestamp_ms", "timestamp"), ("host", "string", "tag"),
            ("v", "float64", "field")]


class Pair:
    """A port engine (parallel decode) and a JAX engine (inline decode)
    fed the same writes."""

    def __init__(self, root):
        import greptimedb_tpu.datatypes as J
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig

        self.J = J
        self.port = RegionEngine(EngineConfig(
            data_dir=str(root / "port"), maintenance_workers=0,
            scan_decode_threads=PARALLEL), device="cpu")
        self.jax = JRegionEngine(JConfig(
            data_dir=str(root / "jax"), maintenance_workers=0,
            scan_decode_threads=1))
        self.schema = Schema([ColumnSchema(n, DataType(d), SemanticType(s))
                              for n, d, s in _spec()])
        self.jschema = J.Schema([
            J.ColumnSchema(n, J.DataType(d), J.SemanticType(s))
            for n, d, s in _spec()])
        self.port.create_region(1, self.schema)
        self.jax.create_region(1, self.jschema)

    @property
    def region(self):
        return self.port.region(1)

    def put(self, hosts, ts, vals, delete=False):
        ts = np.asarray(ts, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        p = RecordBatch(self.schema, {"ts": ts, "v": vals,
                                      "host": DictVector.encode(hosts)})
        j = self.J.RecordBatch(self.jschema, {
            "ts": ts, "v": vals, "host": self.J.DictVector.encode(hosts)})
        if delete:
            self.port.delete(1, p)
            self.jax.delete(1, j)
        else:
            self.port.put(1, p)
            self.jax.put(1, j)

    def flush(self):
        self.port.flush(1)
        self.jax.flush(1)

    def fill(self, n_files=4, rows_per_file=300, hosts=6, t0=0):
        """n_files time-disjoint SSTs, every host in every file."""
        for f in range(n_files):
            self.put([f"h{i % hosts}" for i in range(rows_per_file)],
                     t0 + f * 1_000_000
                     + np.arange(rows_per_file, dtype=np.int64) * 10,
                     np.arange(rows_per_file, dtype=np.float64) + f * 1000)
            self.flush()

    def scan(self, threads=PARALLEL, **kw):
        """The port's scan at `threads` decode workers, caches cleared."""
        region = self.region
        region.decode_threads = threads
        clear_scan_caches(region)
        return self.port.scan(1, **kw)

    def jscan(self, **kw):
        region = self.jax.region(1)
        with region._lock:
            region._scan_cache.clear()
            region._scan_cache_sizes.clear()
            region._scan_cache_bytes = 0
        return self.jax.scan(1, **kw)

    def close(self):
        self.port.close()
        self.jax.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def clear_scan_caches(region):
    with region._lock:
        region._scan_cache_clear()
        region._part_cache.clear()
        region._part_cache_bytes = 0


def scans_equal(a, b) -> bool:
    """Byte for byte: offsets, every column, seq and op."""
    if a.num_rows != b.num_rows:
        return False
    if a.sorted_part_offsets != b.sorted_part_offsets:
        return False
    if set(a.columns) != set(b.columns):
        return False
    for k in a.columns:
        x, y = np.asarray(a.columns[k]), np.asarray(b.columns[k])
        if x.dtype != y.dtype or not np.array_equal(x, y):
            return False
    return (np.array_equal(a.seq, b.seq)
            and np.array_equal(a.op_type, b.op_type))


def decoded_rows(scan) -> list:
    """(host, ts, v, seq, op) rows with tags decoded, in scan order."""
    if scan is None:
        return []
    cols = {}
    for k, arr in scan.columns.items():
        arr = np.asarray(arr)
        if k in scan.tag_dicts:
            d = np.asarray(scan.tag_dicts[k], dtype=object)
            arr = np.where(arr >= 0, d[np.maximum(arr, 0)], None)
        cols[k] = arr.tolist()
    names = [n for n in ("host", "ts", "v") if n in cols]
    return list(zip(*(cols[n] for n in names),
                    np.asarray(scan.seq).tolist(),
                    np.asarray(scan.op_type).tolist()))


def same_as_jax(pair, port_scan, **kw) -> bool:
    return decoded_rows(port_scan) == decoded_rows(pair.jscan(**kw))


class TestParallelDecode:
    def test_parallel_matches_sequential_bit_for_bit(self, pair):
        pair.fill()
        seq = pair.scan(threads=1)
        assert seq.stats["decode_workers"] == 1
        par = pair.scan()
        assert scans_equal(seq, par)
        assert same_as_jax(pair, par)
        # ts-ranged and projected scans too
        for kwargs in ({"ts_range": (1_000_000, 2_000_500)},
                       {"projection": ["v"]}):
            a = pair.scan(threads=1, **kwargs)
            b = pair.scan(**kwargs)
            assert scans_equal(a, b)
            assert same_as_jax(pair, b, **kwargs)

    def test_decode_pool_actually_exercised(self, pair):
        """A multi-SST region's cold scan must run on more than one pool
        worker: a refactor that silently re-serializes the path fails
        here."""
        pair.fill(n_files=6)
        for _ in range(5):
            # tiny decodes can finish on one worker before the second
            # picks a unit up
            scan = pair.scan()
            if scan.stats["decode_workers"] > 1:
                break
        assert scan.stats["decode_workers"] > 1, scan.stats
        assert scan.stats["files_decoded"] == 6
        assert same_as_jax(pair, scan)

    def test_single_huge_file_splits_row_groups(self, pair):
        """ONE multi-row-group SST fans its row groups across the pool
        (order-preserving reassembly): byte for byte the one-worker
        result, ranged and projected scans included."""
        pair.region.sst_writer.row_group_size = 100  # 1 flush -> 9 groups
        pair.fill(n_files=1, rows_per_file=900)
        seq = pair.scan(threads=1)
        assert seq.stats["decode_workers"] == 1
        assert seq.num_rows == 900
        for _ in range(5):
            par = pair.scan()
            if par.stats["decode_workers"] > 1:
                break
        assert par.stats["decode_workers"] > 1, par.stats
        assert scans_equal(seq, par)
        assert same_as_jax(pair, par)
        for kwargs in ({"ts_range": (2_000, 5_005)}, {"projection": ["v"]}):
            a = pair.scan(threads=1, **kwargs)
            b = pair.scan(**kwargs)
            assert scans_equal(a, b)
            assert same_as_jax(pair, b, **kwargs)

    def test_single_row_group_file_takes_classic_path(self, pair,
                                                      monkeypatch):
        """A one-row-group file has nothing to split: it decodes through
        the whole-file path on the calling thread."""
        pair.fill(n_files=1)
        region = pair.region
        calls = []
        orig = region._decode_file_part

        def spy(*a, **k):
            calls.append(threading.current_thread().name)
            return orig(*a, **k)

        monkeypatch.setattr(region, "_decode_file_part", spy)
        scan = pair.scan()
        assert scan.num_rows == 300
        assert scan.stats["decode_workers"] == 1
        assert calls == [threading.current_thread().name]
        assert same_as_jax(pair, scan)

    def test_compaction_reads_through_part_cache(self, pair):
        pair.fill()
        warm = pair.port.scan(1)  # fills per-file parts
        before = SCAN_PART_CACHE_EVENTS.get(event="hit")
        pair.port.compact(1)
        pair.jax.compact(1)
        assert SCAN_PART_CACHE_EVENTS.get(event="hit") >= before + 4
        # merged output equals the pre-compaction rows (append region)
        after = pair.port.scan(1)
        assert after.num_rows == warm.num_rows
        assert sorted(decoded_rows(after)) == sorted(
            decoded_rows(pair.jscan()))


class TestPartCacheMutation:
    def test_parts_survive_unrelated_flush(self, pair):
        pair.fill(n_files=3)
        region = pair.region
        pair.port.scan(1)
        assert len(region._part_cache) == 3
        # unrelated flush: a NEW file appears, old entries stay
        pair.put(["h0"], [99_000_000], [5.0])
        pair.flush()
        scan = pair.port.scan(1)
        assert scan.stats["files_decoded"] == 1
        assert scan.stats["part_hits"] == 3
        assert scan.num_rows == 3 * 300 + 1
        assert same_as_jax(pair, scan)

    def test_delete_served_from_memtable_delta(self, pair):
        """DELETE writes tombstones to the memtable: cached per-file parts
        stay valid and the scan's memtable delta carries the tombstone."""
        pair.fill(n_files=2)
        pair.port.scan(1)
        pair.put(["h0"], [0], [0.0], delete=True)
        scan = pair.port.scan(1)
        assert scan.stats["files_decoded"] == 0  # parts reused
        assert (scan.op_type == OP_DELETE).sum() == 1
        assert same_as_jax(pair, scan)

    def test_byte_budget_evicts_lru(self, pair):
        pair.fill(n_files=4)
        region = pair.region
        full = pair.port.scan(1)
        one_part = region._part_cache[next(iter(region._part_cache))]
        # budget for about 2 parts: older entries must age out
        region.part_cache_budget = one_part.nbytes * 2 + 1
        before = SCAN_PART_CACHE_EVENTS.get(event="evict")
        scan = pair.scan()
        assert SCAN_PART_CACHE_EVENTS.get(event="evict") > before
        assert region._host_cache_bytes <= region.part_cache_budget \
            or len(region._scan_cache) == 1
        assert region._part_cache_bytes <= region.part_cache_budget
        assert scan.num_rows == full.num_rows  # eviction never drops rows
        assert same_as_jax(pair, scan)

    def test_snapshot_and_parts_share_one_budget(self, pair):
        """The whole-scan snapshot is a concatenated COPY of the parts:
        both draw on part_cache_budget, and when a snapshot lands, cold
        parts age out so the shared total fits (the newest snapshot is
        exempt: a bounded overshoot beats re-decoding the live table)."""
        pair.fill(n_files=4)
        region = pair.region
        jregion = pair.jax.region(1)
        pair.port.scan(1)
        pair.jax.scan(1)
        assert region._scan_cache_bytes > 0  # snapshots are accounted
        assert region._host_cache_bytes == (region._part_cache_bytes
                                            + region._scan_cache_bytes)
        # the JAX region accounts the same snapshot bytes
        assert region._scan_cache_bytes == jregion._scan_cache_bytes
        # budget below one snapshot: every cold part must age out, the
        # newest snapshot (still exempt) is the only resident entry
        region.part_cache_budget = max(1, region._scan_cache_bytes // 2)
        scan = pair.scan()
        assert scan.num_rows == 1200
        assert not region._part_cache
        assert len(region._scan_cache) == 1
        with region._lock:
            region._scan_cache_clear()
        assert region._host_cache_bytes == 0

    def test_truncate_drop_clears_caches(self, pair):
        pair.fill(n_files=2)
        region = pair.region
        pair.port.scan(1)
        assert region._part_cache and region._scan_cache
        pair.port.drop_region(1)
        assert not region._part_cache
        assert not region._scan_cache and region._scan_cache_bytes == 0


class TestFaultedDecode:
    """The port has no object-store fault seam yet (ROADMAP A12-io): the
    read fault is a failing `read_into` of the region's store, and the
    latency a seeded sleep in it."""

    def test_read_fault_degrades_typed_and_unpins(self, pair, monkeypatch):
        from greptimedb_tpu_torch.objectstore import ObjectStoreError

        pair.fill(n_files=4)
        region = pair.region
        store = region.sst_reader.store
        # the footers are read before the fault, as a planned scan has
        for m in region.files.values():
            region.sst_reader.footer(m.file_id)

        def fail(key, offset, buf):
            raise ObjectStoreError(f"object {key!r}: injected read fault")

        monkeypatch.setattr(store, "read_into", fail)
        with pytest.raises(ObjectStoreError, match="injected"):
            pair.scan()
        # every worker finished before the unpin: no file stays pinned
        assert not region._file_refs
        monkeypatch.undo()
        scan = pair.scan()
        assert scan.stats["files_decoded"] == 4
        assert same_as_jax(pair, scan)

    def test_latency_fault_keeps_results_identical(self, pair, monkeypatch):
        pair.fill(n_files=4)
        region = pair.region
        oracle = pair.scan(threads=1)
        store = region.sst_reader.store
        orig = store.read_into
        rng = np.random.default_rng(7)
        lock = threading.Lock()

        def slow(key, offset, buf):
            with lock:
                delay = 0.01 if rng.random() < 0.5 else 0.0
            time.sleep(delay)
            return orig(key, offset, buf)

        monkeypatch.setattr(store, "read_into", slow)
        jittered = pair.scan()
        assert scans_equal(oracle, jittered)
        assert same_as_jax(pair, jittered)


class TestStreamAndSeqMinParallel:
    """scan_stream and the seq_min slice ride the decode workers too:
    byte for byte the serial path, and the JAX region's rows."""

    @staticmethod
    def _stream(engine, rid, **kwargs):
        stream = engine.scan_stream(rid, **kwargs)
        assert stream is not None
        out = []
        try:
            for cols, n in stream.chunks():
                out.append(({k: np.asarray(v).copy()
                             for k, v in cols.items()}, n))
        finally:
            stream.close()
        return out

    def _port_stream(self, pair, threads, **kwargs):
        pair.region.decode_threads = threads
        return self._stream(pair.port, 1, **kwargs)

    @staticmethod
    def _chunks_equal(a, b):
        if [n for _, n in a] != [n for _, n in b]:
            return False
        for (ca, _), (cb, _) in zip(a, b):
            if set(ca) != set(cb):
                return False
            for k in ca:
                if not np.array_equal(ca[k], cb[k]):
                    return False
        return True

    def _rows(self, pair, chunks, engine):
        region = engine.region(1)
        d = np.asarray(region.registry.dict_array("host"), dtype=object)
        out = []
        for cols, _ in chunks:
            hosts = d[cols["host"]].tolist()
            out += list(zip(hosts, cols["ts"].tolist(),
                            *([cols["v"].tolist()] if "v" in cols else [])))
        return out

    def test_scan_stream_parallel_matches_serial_bit_for_bit(self, pair):
        """Chunk ORDER matters, not just content: file order, then chunk
        order within a file — exactly the serial loop's sequence."""
        pair.fill(n_files=6)
        for kwargs in ({}, {"ts_range": (1_000_000, 4_000_500)},
                       {"projection": ["v"]}):
            serial = self._port_stream(pair, 1, **kwargs)
            par = self._port_stream(pair, PARALLEL, **kwargs)
            assert self._chunks_equal(serial, par), kwargs
            jax_chunks = self._stream(pair.jax, 1, **kwargs)
            assert self._rows(pair, par, pair.port) == \
                self._rows(pair, jax_chunks, pair.jax), kwargs
        assert sum(n for _, n in serial) > 0

    def test_scan_stream_memtable_tail_after_parallel_files(self, pair):
        pair.fill(n_files=4)
        # unflushed rows ride the stream's tail chunk
        pair.put(["h9"] * 3, [9_000_000, 9_000_010, 9_000_020],
                 [1.0, 2.0, 3.0])
        serial = self._port_stream(pair, 1)
        par = self._port_stream(pair, PARALLEL)
        assert self._chunks_equal(serial, par)
        assert self._rows(pair, par, pair.port) == \
            self._rows(pair, self._stream(pair.jax, 1), pair.jax)

    def test_scan_stream_abandoned_midway_unpins(self, pair):
        """Abandoning a parallel stream stops and joins its producers and
        releases every file pin (compaction depends on it)."""
        pair.fill(n_files=6)
        region = pair.region
        region.decode_threads = PARALLEL
        stream = pair.port.scan_stream(1)
        it = stream.chunks()
        next(it)  # consume one chunk, then walk away
        it.close()
        stream.close()
        with region._lock:
            assert not region._file_refs
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("gtpu-stream-decode")]

    def test_seq_min_parallel_matches_serial_bit_for_bit(self, pair):
        pair.fill(n_files=5)
        full = pair.port.scan(1)
        boundaries = [0, int(full.seq.min()), int(np.median(full.seq)),
                      int(full.seq.max())]
        for s in boundaries:
            serial = pair.scan(threads=1, seq_min=s)
            par = pair.scan(seq_min=s)
            if serial is None or par is None:
                assert serial is None and par is None, s
                assert pair.jscan(seq_min=s) is None
                continue
            assert scans_equal(serial, par), s
            assert same_as_jax(pair, par, seq_min=s), s
            assert par.scan_fingerprint[-2:] == ("seq", s)

    def test_seq_min_rides_the_part_cache(self, pair):
        """A boundary-straddling file decodes ONCE, not once per tick: the
        second seq_min scan over the same files is all part-cache hits,
        the seq filter applies on copies (a later FULL scan still sees
        every row), and files wholly at or below the boundary are pruned
        before any read."""
        pair.fill(n_files=3)
        region = pair.region
        clear_scan_caches(region)
        first = pair.port.scan(1, seq_min=1)
        hits0 = SCAN_PART_CACHE_EVENTS.get(event="hit")
        miss0 = SCAN_PART_CACHE_EVENTS.get(event="miss")
        again = pair.port.scan(1, seq_min=1)
        assert SCAN_PART_CACHE_EVENTS.get(event="hit") > hits0
        assert SCAN_PART_CACHE_EVENTS.get(event="miss") == miss0
        assert scans_equal(first, again)
        assert same_as_jax(pair, again, seq_min=1)
        full = pair.port.scan(1)
        assert full.num_rows == 900  # cached parts stayed whole
        late = pair.port.scan(1, seq_min=int(full.seq.max()) - 10)
        assert late.stats["ssts_seq_pruned"] == 2
        assert late.num_rows == 10


def test_no_decode_thread_outlives_its_scan_close_or_stream(tmp_path):
    """A decode step joins its gtpu-scan-decode workers when it ends (none
    idles between scans, whatever engine later tests leave open), an
    abandoned parallel stream joins its gtpu-stream-decode producers
    before it lets go, and close() leaves none."""
    def decode_threads():
        return {t for t in threading.enumerate()
                if t.name.startswith(("gtpu-scan-decode",
                                      "gtpu-stream-decode"))}

    before = decode_threads()
    pair = Pair(tmp_path)
    try:
        pair.fill(n_files=6)
        pair.region.sst_writer.row_group_size = 64
        pair.fill(n_files=1, rows_per_file=1000, t0=50_000_000)
        for _ in range(5):
            scan = pair.scan()
            if scan.stats["decode_workers"] > 1:
                break
        assert scan.stats["decode_workers"] > 1
        assert decode_threads() <= before
        single = pair.scan(seq_min=int(scan.seq.max()) - 500)
        assert single.stats["files_decoded"] == 1
        assert decode_threads() <= before
        stream = pair.port.scan_stream(1)
        it = stream.chunks()
        next(it)
        it.close()
        stream.close()
        assert decode_threads() <= before
    finally:
        pair.close()
    assert decode_threads() <= before


def test_metric_and_file_regions_refuse_seq_min(tmp_path):
    """The typed seq_min refusals of the metric and file engines carry the
    JAX texts."""
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine

    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d"),
                                       maintenance_workers=0), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    try:
        qe.execute_one("CREATE TABLE m (host STRING, val DOUBLE, "
                       "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY (host)) "
                       "ENGINE = metric")
        qe.execute_one("INSERT INTO m VALUES ('a', 1.0, 1)")
        csv = tmp_path / "t.csv"
        csv.write_text("ts,v\n1,1.5\n")
        qe.execute_one(f"CREATE EXTERNAL TABLE x WITH (location = '{csv}')")
        for table, text in (
                ("m", "seq_min scans are not supported on metric-engine "
                      "logical regions"),
                ("x", "seq_min scans are not supported on external "
                      "tables")):
            rid = qe.catalog.table("public", table).region_ids[0]
            with pytest.raises(NotImplementedError) as e:
                engine.scan(rid, seq_min=0)
            assert str(e.value) == text
    finally:
        engine.close()


def test_decode_under_thread_switch_stress(pair, tmp_path):
    """More decode workers than cores and a tiny switch interval: the
    shared registry, the part cache and the reassembly still give the
    serial bytes, scan after scan, for whole files and for one file's
    row-group runs."""
    import sys

    pair.fill(n_files=6)
    seq = pair.scan(threads=1)
    single = Pair(tmp_path / "single")
    old = sys.getswitchinterval()
    try:
        single.region.sst_writer.row_group_size = 64
        single.fill(n_files=1, rows_per_file=1000)
        one = single.scan(threads=1)
        sys.setswitchinterval(1e-6)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 3.0:
            assert scans_equal(seq, pair.scan(threads=32))
            assert scans_equal(one, single.scan(threads=32))
    finally:
        sys.setswitchinterval(old)
        single.close()
