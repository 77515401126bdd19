"""The port's streaming aggregation (Region.scan_stream, SstReader.
iter_chunks, and physical.py's `_prefetch`, `_fold_stream` and
`_fold_stream_prepared`) against the JAX package's on the same writes,
mirroring tests/test_streaming_scan.py: every aggregate over an
append-mode table streams (GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS=1) in
blocks of 1,024 rows (GREPTIMEDB_TPU_STREAM_BLOCK_ROWS), both packages
reading the same variables. The table has three SSTs, a memtable tail
and NULL fields.

Each parity case must return the JAX engine's rows (floats within
rtol=1e-9: the port reduces in another order) and its `last_path`,
streamed or fallen back to the materialized route. The port-only cases
hold the chunking, the file pins, `_prefetch` and the thread hygiene: no
thread the port starts outlives its query.
"""

import os
import threading

import numpy as np
import pytest

from greptimedb_tpu_torch.query import physical as tph


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


@pytest.fixture(autouse=True)
def _stream_everything(monkeypatch):
    monkeypatch.setenv("GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS", "1")
    monkeypatch.setenv("GREPTIMEDB_TPU_STREAM_BLOCK_ROWS", "1024")


@pytest.fixture
def pair(tmp_path):
    from greptimedb_tpu.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
    from greptimedb_tpu.query import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage import RegionEngine as JRegionEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                 maintenance_workers=0))
    teng = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"), maintenance_workers=0),
                        device="cpu")
    yield (JQueryEngine(JCatalog(JMemoryKv()), jeng),
           QueryEngine(Catalog(MemoryKv()), teng, device="cpu"))
    jeng.close()
    teng.close()


def both(pair, sql):
    for qe in pair:
        qe.execute_one(sql)


def region_of(qe, name):
    return qe.region_engine.region(
        qe.catalog.table("public", name).region_ids[0])


HOSTS, POINTS, FILES = 6, 400, 3


def fill(pair, seed=9):
    """FILES flushed SSTs of HOSTS x POINTS rows (ts in seconds, files
    disjoint in time) with about 5 % NULL usage, then a memtable tail."""
    both(pair, "CREATE TABLE cpu (host STRING, usage DOUBLE, mem DOUBLE, "
         "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
         "WITH (append_mode = 'true')")
    rng = np.random.default_rng(seed)
    n = HOSTS * POINTS * FILES
    usage = np.round(rng.uniform(0, 100, n), 6)
    mem = np.round(rng.uniform(0, 64, n), 6)
    null = rng.random(n) < 0.05
    i = 0
    for f in range(FILES):
        rows = []
        for p in range(POINTS):
            for h in range(HOSTS):
                u = "NULL" if null[i] else repr(float(usage[i]))
                rows.append(f"('h{h}', {u}, {float(mem[i])!r}, "
                            f"{(f * POINTS + p) * 1000})")
                i += 1
        both(pair, "INSERT INTO cpu (host, usage, mem, ts) VALUES "
             + ",".join(rows))
        both(pair, "ADMIN flush_table('cpu')")
    both(pair, "INSERT INTO cpu (host, usage, mem, ts) VALUES "
         "('h0', 50.0, 32.0, 99999000), ('h3', NULL, 1.5, 99998000)")


def assert_rows(jres, tres):
    jr, tr = jres.rows(), tres.rows()
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        for x, y in zip(a, b):
            if isinstance(x, (float, np.floating)) and x == x:
                np.testing.assert_allclose(float(y), float(x), rtol=1e-9,
                                           atol=1e-12)
            elif isinstance(x, (float, np.floating)):
                assert y is None or y != y
            else:
                assert str(x) == str(y)


def parity(pair, sql, want_path):
    jqe, tqe = pair
    jres = jqe.execute_one(sql)
    tres = tqe.execute_one(sql)
    assert_rows(jres, tres)
    assert jqe.executor.last_path == tqe.executor.last_path == want_path
    return tres


SQL_PATH = {
    "double_groupby": (
        "SELECT host, date_bin(INTERVAL '1 minute', ts) AS m, avg(usage), "
        "count(usage), min(mem), max(mem), sum(usage) FROM cpu "
        "GROUP BY host, m ORDER BY host, m", "stream_prepared"),
    # max(ts) aggregates the time index, not a field: the general fold
    "global_where": (
        "SELECT sum(usage), count(mem), max(ts) FROM cpu "
        "WHERE host IN ('h1', 'h2') AND ts >= 100000", "stream"),
    # first/last pair values with ts: the general fold
    "first_last": (
        "SELECT host, last(usage), first(mem) FROM cpu GROUP BY host "
        "ORDER BY host", "stream"),
    # f64 sum of squares beside the plane
    "stddev": (
        "SELECT host, stddev(usage), variance(mem) FROM cpu GROUP BY host "
        "ORDER BY host", "stream_prepared"),
    # only the middle file overlaps the range
    "ts_pruned": (
        "SELECT host, count(*) AS c, avg(mem) FROM cpu "
        "WHERE ts >= 400000 AND ts < 800000 GROUP BY host ORDER BY host",
        "stream_prepared"),
}


@pytest.mark.parametrize("case", sorted(SQL_PATH))
def test_streamed_rows_and_path_match_jax(pair, case):
    fill(pair)
    sql, want = SQL_PATH[case]
    res = parity(pair, sql, want)
    assert res.num_rows > 0
    stats = pair[1].executor.last_stream_stats
    assert stats["blocks"] >= stats["chunks"] > 0


def test_stream_that_pruning_leaves_empty(pair):
    """The file's ts span covers the range but every row group lies
    outside it: the stream yields nothing and folds to identity planes."""
    both(pair, "CREATE TABLE gap (host STRING, v DOUBLE, "
         "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
         "WITH (append_mode = 'true')")
    for qe in pair:
        region_of(qe, "gap").sst_writer.row_group_size = 1000
    ts = np.concatenate([np.arange(2000), 10_000 + np.arange(2000)]) * 1000
    both(pair, "INSERT INTO gap (host, v, ts) VALUES "
         + ",".join(f"('h0', {i * 0.5}, {t})" for i, t in enumerate(ts)))
    both(pair, "ADMIN flush_table('gap')")
    where = "WHERE ts >= 5000000 AND ts < 6000000"
    res = parity(pair, f"SELECT count(*), sum(v), max(v) FROM gap {where}",
                 "stream_prepared")
    assert res.rows() == [[0, None, None]]
    assert pair[1].executor.last_stream_stats["chunks"] == 0
    res = parity(pair, f"SELECT host, count(*) FROM gap {where} "
                 "GROUP BY host", "stream")
    assert res.num_rows == 0


def test_alter_add_column_across_files(pair):
    fill(pair)
    both(pair, "ALTER TABLE cpu ADD COLUMN extra DOUBLE")
    both(pair, "INSERT INTO cpu (host, usage, mem, ts, extra) VALUES "
         + ",".join(f"('h{i % HOSTS}', {i}.5, 1.0, {2_000_000 + i * 1000}, "
                    f"{i * 2.0})" for i in range(50)))
    both(pair, "ADMIN flush_table('cpu')")
    parity(pair, "SELECT host, avg(extra), count(extra), max(usage) FROM cpu "
           "GROUP BY host ORDER BY host", "stream_prepared")


FALLBACKS = {
    "host_aggregate": "SELECT host, median(usage) FROM cpu GROUP BY host "
                      "ORDER BY host",
    "generic_key": "SELECT date_trunc('hour', ts) AS h, avg(usage) FROM cpu "
                   "GROUP BY h ORDER BY h",
    "sparse_cardinality": "SELECT host, date_bin(INTERVAL '1 minute', ts) "
                          "AS m, max(mem) FROM cpu GROUP BY host, m "
                          "ORDER BY host, m",
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_unstreamable_plans_take_the_materialized_route(pair, case,
                                                        monkeypatch):
    if case == "sparse_cardinality":
        monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "50")
    fill(pair)
    jqe, tqe = pair
    sql = FALLBACKS[case]
    jres, tres = jqe.execute_one(sql), tqe.execute_one(sql)
    assert_rows(jres, tres)
    assert jqe.executor.last_path == tqe.executor.last_path
    assert not tqe.executor.last_path.startswith("stream")
    assert tqe.executor.last_stream_stats is None


def test_non_append_table_does_not_stream(pair):
    both(pair, "CREATE TABLE d (host STRING, v DOUBLE, "
         "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host))")
    both(pair, "INSERT INTO d (host, v, ts) VALUES ('a', 1.0, 1000)")
    both(pair, "ADMIN flush_table('d')")
    both(pair, "INSERT INTO d (host, v, ts) VALUES ('a', 2.0, 1000)")
    jqe, tqe = pair
    sql = "SELECT host, max(v) FROM d GROUP BY host"
    jres, tres = jqe.execute_one(sql), tqe.execute_one(sql)
    assert tres.rows() == [["a", 2.0]]
    assert_rows(jres, tres)
    assert jqe.executor.last_path == tqe.executor.last_path
    assert not tqe.executor.last_path.startswith("stream")


# ---- port-only: chunks, pins, the prefetch pipeline, threads --------------


@pytest.fixture
def port(tmp_path):
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    eng = RegionEngine(EngineConfig(data_dir=str(tmp_path),
                                    maintenance_workers=0), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), eng, device="cpu")
    qe.execute_one("CREATE TABLE t (host STRING, v DOUBLE, "
                   "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
                   "WITH (append_mode = 'true')")
    region = region_of(qe, "t")
    region.sst_writer.row_group_size = 100
    for f in range(3):  # three files of 1,000 rows, ts disjoint
        qe.execute_one("INSERT INTO t (host, v, ts) VALUES " + ",".join(
            f"('h{i % 4}', {i}, {(f * 1000 + i) * 1000})"
            for i in range(1000)))
        qe.execute_one("ADMIN flush_table('t')")
    qe.execute_one("INSERT INTO t (host, v, ts) VALUES "
                   "('h1', 7.0, 9000000), ('h2', 8.0, 9001000)")
    yield qe, region
    eng.close()


def test_iter_chunks_yields_groups_per_chunk_row_groups(port):
    _, region = port
    meta = next(iter(region.files.values()))
    parts = list(region.sst_reader.iter_chunks(meta, region.schema,
                                               groups_per_chunk=3))
    assert [p.num_rows for p in parts] == [300, 300, 300, 100]
    # rows sort by (host, ts): h0's first row group ends before `lo`
    lo = meta.ts_min + 398_000
    groups = region.sst_reader.footer(meta.file_id)["row_groups"]
    keep = [rg["rows"] for rg in groups if rg["ts_max"] >= lo]
    assert 0 < len(keep) < len(groups)
    parts = list(region.sst_reader.iter_chunks(
        meta, region.schema, (lo, meta.ts_max + 1), ["v"], 3))
    assert [p.num_rows for p in parts] == [
        sum(keep[i:i + 3]) for i in range(0, len(keep), 3)]
    assert set(parts[0].columns) == {"v", "ts", "__seq", "__op_type"}


def test_scan_stream_yields_file_order_then_memtable(port):
    _, region = port
    stream = region.scan_stream(groups_per_chunk=4)
    assert stream.est_rows == 3002
    assert (stream.ts_min, stream.ts_max) == (0, 9_001_000)
    assert list(stream.tag_dicts["host"]) == ["h0", "h1", "h2", "h3"]
    chunks = list(stream.chunks())
    stream.close()
    assert [n for _, n in chunks] == [400, 400, 200] * 3 + [2]
    files = [region.files[f] for f in region.files]
    for i, meta in enumerate(files):
        ts = np.concatenate([c["ts"] for c, _ in chunks[3 * i:3 * i + 3]])
        assert (ts.min(), ts.max()) == (meta.ts_min, meta.ts_max)
    assert list(chunks[-1][0]["ts"]) == [9_000_000, 9_001_000]
    assert region._file_refs == {}


def test_pins_released_after_close_and_abandon(port):
    _, region = port
    stream = region.scan_stream()
    assert set(region._file_refs) == set(region.files)
    stream.close()
    stream.close()  # idempotent
    assert region._file_refs == {}
    stream = region.scan_stream(groups_per_chunk=1)
    it = stream.chunks()
    next(it)
    it.close()  # abandoned mid-iteration: the generator's finally unpins
    assert region._file_refs == {}
    stream.close()
    assert region._file_refs == {}


def test_compaction_purge_leaves_a_pinned_file_in_place(port):
    _, region = port
    old = list(region.files)
    stream = region.scan_stream(groups_per_chunk=1)
    it = stream.chunks()
    next(it)
    region.compact(strategy="full")
    assert set(region.files).isdisjoint(old)
    paths = [region.sst_reader.path(f) for f in old]
    assert all(os.path.exists(p) for p in paths)
    rows = 100 + sum(n for _, n in it)  # the pinned files still read
    assert rows == 3002
    assert region._file_refs == {}
    assert not any(os.path.exists(p) for p in paths)


def test_prefetch_keeps_order():
    assert list(tph._prefetch(iter(range(100)))) == list(range(100))


def test_prefetch_reraises_a_producer_error():
    def gen():
        yield 1
        raise RuntimeError("boom in producer")

    it = tph._prefetch(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)
    assert not _prefetch_threads()


def test_prefetch_stops_early_without_hanging():
    produced = []

    def gen():
        try:
            for i in range(500):
                produced.append(i)
                yield i
        finally:
            produced.append("closed")

    it = tph._prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    # joined on close: the producer stopped at its next put and closed
    # its source on its own thread
    assert not _prefetch_threads()
    assert produced[-1] == "closed" and len(produced) < 10


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "gtpu-stream-prefetch"]


def test_no_thread_outlives_a_streamed_query(port, monkeypatch):
    qe, region = port
    before = set(threading.enumerate())
    for sql in ("SELECT host, avg(v) FROM t GROUP BY host",
                "SELECT host, last(v), first(v) FROM t GROUP BY host"):
        qe.execute_one(sql)
        assert qe.executor.last_path.startswith("stream")
        assert set(threading.enumerate()) == before
    # a fold that fails mid-stream abandons its stream: the producer is
    # joined and the pins released before the error reaches the caller
    calls = []
    upload = tph.PhysicalExecutor._upload_block

    def failing(self, blk, stats):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("upload failed")
        return upload(self, blk, stats)

    monkeypatch.setattr(tph.PhysicalExecutor, "_upload_block", failing)
    with pytest.raises(RuntimeError, match="upload failed"):
        qe.execute_one("SELECT host, avg(v) FROM t GROUP BY host")
    assert set(threading.enumerate()) == before
    assert region._file_refs == {}


def test_host_bytes_in_flight_stay_bounded(port, monkeypatch):
    """A chunk and at most depth + 2 blocks are alive on the host."""
    monkeypatch.setenv("GREPTIMEDB_TPU_STREAM_BLOCK_ROWS", "64")
    qe, _ = port
    qe.execute_one("SELECT host, avg(v), max(v) FROM t GROUP BY host")
    st = qe.executor.last_stream_stats
    assert qe.executor.last_path == "stream_prepared"
    # each file in chunks of 8 and 2 row groups, then the memtable
    assert st["rows"] == 3002 and st["chunks"] == 3 * 2 + 1
    assert st["blocks"] == 3 * (-(-800 // 64) + -(-200 // 64)) + 1
    assert st["host_bytes"] == 0
    assert st["h2d_bytes"] == st["blocks"] * st["block_bytes_max"]
    assert st["peak_host_bytes"] <= (st["chunk_bytes_max"]
                                     + (st["depth"] + 2)
                                     * st["block_bytes_max"])


def test_stream_counters_balance_under_fast_thread_switches(port,
                                                            monkeypatch):
    """The producer and the consumer update one _StreamStats: with the
    interpreter switching threads every microsecond, every byte held is
    released and every block counted once."""
    import sys

    monkeypatch.setenv("GREPTIMEDB_TPU_STREAM_BLOCK_ROWS", "16")
    qe, _ = port
    want = qe.execute_one("SELECT host, sum(v) FROM t GROUP BY host "
                          "ORDER BY host").rows()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = qe.execute_one("SELECT host, sum(v) FROM t GROUP BY host "
                             "ORDER BY host").rows()
    finally:
        sys.setswitchinterval(interval)
    st = qe.executor.last_stream_stats
    assert got == want
    assert st["host_bytes"] == 0
    assert st["blocks"] == 3 * (800 // 16 + -(-200 // 16)) + 1
    assert st["h2d_bytes"] == st["blocks"] * st["block_bytes_max"]
