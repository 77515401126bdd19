"""The port's per-file inverted index (greptimedb_tpu_torch/storage/
{index,puffin}.py) held against the JAX package's on the CPU: the same
puffin and index blob bytes for the same codes and dictionaries, the
same row groups selected for the same predicates, and scans with
predicates that give the same rows through both engines in the
memtable, flushed, compacted and streamed states. The index dies with
its SST.

Twins of tests/test_index_puffin.py (its serialize round trip is left
with Flight, ROADMAP A9-flight: its twin checks the predicate
normalization both packages share) and of tests/test_compaction_index.py's
index cases.
"""

import io
import os
import re

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.objectstore import MemoryStore as JMemoryStore
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.storage import index as jindex
from greptimedb_tpu.storage import puffin as jpuffin
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    DictVector,
    RecordBatch,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.objectstore import MemoryStore
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.index import (
    IndexApplier,
    InSet,
    InvertedIndexWriter,
    Range,
    Regex,
    extract_tag_predicates,
    normalize_predicates,
    predicates_cache_key,
)
from greptimedb_tpu_torch.storage.puffin import (
    PuffinError,
    PuffinReader,
    PuffinWriter,
)


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


# ---- container -------------------------------------------------------------


def test_puffin_roundtrip_and_bytes():
    blobs = [("type-a", b"hello", {"column": "host"}),
             ("type-b", b"\x00\x01\x02" * 100, {"column": "dc"})]
    out = []
    for cls in (jpuffin.PuffinWriter, PuffinWriter):
        w = cls({"num_rows": 42})
        for t, data, props in blobs:
            w.add_blob(t, data, props)
        out.append(w.finish())
    assert out[1] == out[0]
    r = PuffinReader(io.BytesIO(out[1]))
    assert r.properties == {"num_rows": 42}
    assert [b.type for b in r.blobs] == ["type-a", "type-b"]
    assert r.read_blob(r.blobs[0]) == b"hello"
    assert r.read_blob(r.blobs[1]) == b"\x00\x01\x02" * 100
    assert r.blobs_of_type("type-b")[0].properties == {"column": "dc"}


def test_puffin_rejects_garbage():
    with pytest.raises(PuffinError):
        PuffinReader(io.BytesIO(b"not a puffin file at all"))


# ---- index build + applier -------------------------------------------------


def _appliers(codes_by_tag, values_by_tag, segment_rows, row_group_size,
              n=None):
    """The JAX and port writers over the same codes; returns both
    appliers and both stores' index bytes."""
    out = []
    for writer, applier, store in (
            (jindex.InvertedIndexWriter, jindex.IndexApplier, JMemoryStore()),
            (InvertedIndexWriter, IndexApplier, MemoryStore())):
        num = n if n is not None else len(next(iter(codes_by_tag.values())))
        writer("idx", store, segment_rows=segment_rows).write(
            "f1", {t: np.asarray(c, dtype=np.int32)
                   for t, c in codes_by_tag.items()},
            {t: np.asarray(v, dtype=object)
             for t, v in values_by_tag.items()}, row_group_size, num)
        raw = store.read(os.path.join("idx", "f1.puffin"))
        out.append((applier("idx", store), bytes(raw)))
    (jap, jraw), (ap, raw) = out
    assert raw == jraw
    return jap, ap


def _jax_preds(preds):
    """The same predicate map in the JAX package's classes."""
    def one(p):
        if isinstance(p, Range):
            return jindex.Range(p.lo, p.hi, p.lo_inc, p.hi_inc)
        if isinstance(p, Regex):
            return jindex.Regex(p.pattern)
        if isinstance(p, InSet):
            return jindex.InSet(p.values)
        return p
    return {k: v if isinstance(v, (set, frozenset, list))
            else tuple(one(p) for p in v) for k, v in preds.items()}


def _same(jap, ap, preds, counts=None):
    got = ap.apply("f1", preds, counts)
    assert got == jap.apply("f1", _jax_preds(preds), counts), preds
    return got


def test_eq_pruning_segments_to_row_groups():
    # 16 rows, segment_rows=4 -> 4 segments; row_group_size=8 -> 2 groups.
    # 'a' only in rows 0-3 (segment 0 -> group 0)
    jap, ap = _appliers({"host": [0] * 4 + [1] * 12},
                        {"host": ["a", "b"]}, 4, 8)
    assert _same(jap, ap, {"host": {"a"}}) == [0]
    assert _same(jap, ap, {"host": {"b"}}) in (None, [0, 1])
    assert _same(jap, ap, {"host": {"zz"}}) == []
    assert _same(jap, ap, {"other": {"x"}}) is None
    assert ap.apply("nope", {"host": {"a"}}) is None


def test_in_and_multi_tag_intersection():
    host = [0, 1, 2, 3] * 4   # every segment
    dc = [0] * 8 + [1] * 8    # half each
    jap, ap = _appliers({"host": host, "dc": dc},
                        {"host": ["h0", "h1", "h2", "h3"],
                         "dc": ["east", "west"]}, 4, 8)
    assert _same(jap, ap, {"dc": {"west"}}) == [1]
    assert _same(jap, ap, {"host": {"h1"}, "dc": {"east"}}) == [0]
    assert _same(jap, ap, {"host": {"h1", "h2"}, "dc": {"bogus"}}) == []


def test_range_predicate():
    jap, ap = _appliers({"host": [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4},
                        {"host": ["a", "b", "c", "d"]}, 4, 4)
    assert _same(jap, ap, {"host": (Range("b", "c"),)}) == [1, 2]
    assert _same(jap, ap, {"host": (Range("b", "c", lo_inc=False),)}) == [2]
    assert _same(jap, ap, {"host": (Range(None, "a"),)}) == [0]
    assert _same(jap, ap, {"host": (Range("e", None),)}) == []
    assert _same(jap, ap, {"host": (Range("a", "z"),)}) is None


def test_regex_predicate_and_null_semantics():
    jap, ap = _appliers(
        {"host": [0] * 4 + [1] * 4 + [2] * 4 + [-1] * 4},
        {"host": ["web-1", "web-2", "db-1"]}, 4, 4)
    assert _same(jap, ap, {"host": (Regex("web-.*"),)}) == [0, 1]
    assert _same(jap, ap, {"host": (Regex("db-\\d"),)}) == [2]
    # a pattern matching the empty string keeps NULL segments
    assert _same(jap, ap, {"host": (Regex("(web-1)?"),)}) == [0, 3]
    assert _same(jap, ap, {"host": {""}}) == [3]
    assert _same(jap, ap, {"host": (Regex("("),)}) is None


@pytest.mark.parametrize("seed,seg_rows,rg_rows", [
    (0, 32, 128), (1, 7, 50), (2, 8192, 1 << 20), (3, 1, 3)])
def test_pruning_never_drops_matching_rows_randomized(seed, seg_rows,
                                                      rg_rows):
    """Bytes, selections and row groups equal to the JAX writer's and
    applier's over random codes with NULLs (the port builds the bitmaps
    from (term, segment) pairs, the JAX writer from a dense matrix)."""
    rng = np.random.default_rng(seed)
    values = [f"v{i}" for i in range(17)]
    n = 1000 if rg_rows < 1000 else 20_000
    codes = rng.integers(-1, 17, n).astype(np.int32)
    if seed % 2:
        codes = np.sort(codes)  # long runs, as in a sorted SST
    dc = rng.integers(0, 3, n).astype(np.int32)
    jap, ap = _appliers({"host": codes, "dc": dc},
                        {"host": values, "dc": ["e", "w", "n"]},
                        seg_rows, rg_rows)
    counts = [min(rg_rows, n - s) for s in range(0, n, rg_rows)]
    for pred, match in [
        ({"host": {"v3", "v11"}}, lambda c, d: (c == 3) | (c == 11)),
        ({"host": (Range("v10", "v16"),)},
         lambda c, d: np.isin(c, [i for i in range(17)
                                  if "v10" <= f"v{i}" <= "v16"])),
        ({"host": (Regex("v1[0-3]"),)},
         lambda c, d: np.isin(c, [10, 11, 12, 13])),
        ({"host": {"v5"}, "dc": {"w"}}, lambda c, d: (c == 5) & (d == 1)),
    ]:
        for cnt in (None, counts):
            groups = _same(jap, ap, pred, cnt)
        sel = ap.select("f1", pred)
        jsel = jap.select("f1", _jax_preds(pred))
        np.testing.assert_array_equal(sel.mask, jsel.mask)
        if groups is None:
            continue
        kept = np.zeros(n, dtype=bool)
        for g in groups:
            kept[g * rg_rows:(g + 1) * rg_rows] = True
        assert not (match(codes, dc) & ~kept).any(), pred


# ---- predicate plumbing ----------------------------------------------------


def test_predicate_normalization_matches_jax():
    """The non-wire half of the JAX serialize round trip (the wire form
    is Flight's, A9-flight): normalization and cache keys agree."""
    preds = {"host": {"a", "b"}, "dc": (Range("x", None, lo_inc=False),
                                        Regex("e.*"))}
    jpreds = {"host": {"a", "b"}, "dc": (jindex.Range("x", None,
                                                      lo_inc=False),
                                         jindex.Regex("e.*"))}
    assert repr(normalize_predicates(preds)).replace(
        "greptimedb_tpu_torch", "") == repr(
            jindex.normalize_predicates(jpreds)).replace(
                "greptimedb_tpu", "")
    assert predicates_cache_key(preds) == \
        jindex.predicates_cache_key(jpreds)
    assert normalize_predicates({"host": ["b", "a"]}) == {
        "host": (InSet.of(["a", "b"]),)}


def _schema():
    return Schema([
        ColumnSchema("host", DataType.STRING, SemanticType.TAG),
        ColumnSchema("dc", DataType.STRING, SemanticType.TAG),
        ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                     SemanticType.TIMESTAMP),
        ColumnSchema("v", DataType.FLOAT64),
    ])


def test_extract_tag_predicates_rich():
    stmt = parse_sql(
        "SELECT v FROM t WHERE host = 'a' AND dc IN ('e','w') "
        "AND host >= 'a' AND host < 'm' AND dc LIKE 'e%' "
        "AND dc BETWEEN 'd' AND 'f' AND v > 3")[0]
    preds = extract_tag_predicates(stmt.where, _schema())
    assert InSet.of(["a"]) in preds["host"]
    assert Range("a", None, lo_inc=True) in preds["host"]
    assert Range(None, "m", hi_inc=False) in preds["host"]
    assert InSet.of(["e", "w"]) in preds["dc"]
    assert Regex("(?is)e.*") in preds["dc"]
    assert Range("d", "f") in preds["dc"]
    assert "v" not in preds and "ts" not in preds


def test_extract_tag_predicates_simple():
    schema = _schema()
    sel = parse_sql("SELECT * FROM cpu WHERE host = 'a' AND ts > 5")[0]
    assert extract_tag_predicates(sel.where, schema) == {
        "host": (InSet.of(["a"]),)}
    sel = parse_sql("SELECT * FROM cpu WHERE host IN ('a', 'b')")[0]
    assert extract_tag_predicates(sel.where, schema) == {
        "host": (InSet.of(["a", "b"]),)}
    sel = parse_sql("SELECT * FROM cpu WHERE host = 'a' OR v > 1")[0]
    assert extract_tag_predicates(sel.where, schema) == {}


# ---- through the engines -----------------------------------------------------


@pytest.fixture
def pair(tmp_path):
    je = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                               write_workers=0, maintenance_workers=0))
    jq = JQueryEngine(JCatalog(JMemoryKv()), je)
    te = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"),
                                   maintenance_workers=0), device="cpu")
    tq = QueryEngine(Catalog(MemoryKv()), te, device="cpu")
    yield jq, tq
    je.close()
    te.close()


def both(pair, sql):
    out = [qe.execute_one(sql).rows() for qe in pair]
    assert out[1] == out[0], sql
    return out[1]


def _region(qe, name):
    return qe.region_engine.region(qe.catalog.table("public", name)
                                   .region_ids[0])


def test_like_pruning_is_case_insensitive(pair):
    for qe in pair:
        qe.execute_one(
            "CREATE TABLE t (host STRING, ts TIMESTAMP(3) NOT NULL, "
            "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))")
        qe.execute_one(
            "INSERT INTO t VALUES ('apple', 1, 1.0), ('banana', 2, 2.0)")
        qe.region_engine.flush(qe.catalog.table("public", "t")
                               .region_ids[0])
    assert both(pair, "SELECT host FROM t WHERE host LIKE 'A%'") == [
        ["apple"]]


def test_scan_stream_close_releases_pins(tmp_path):
    schema = Schema([
        ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                     SemanticType.TIMESTAMP),
        ColumnSchema("host", DataType.STRING, SemanticType.TAG),
        ColumnSchema("v", DataType.FLOAT64),
    ])
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path),
                                       maintenance_workers=0), device="cpu")
    try:
        engine.create_region(1, schema)
        engine.put(1, RecordBatch(schema, {
            "ts": np.arange(100, dtype=np.int64),
            "host": DictVector.encode(["h"] * 100),
            "v": np.ones(100)}))
        engine.flush(1)
        region = engine.region(1)
        stream = region.scan_stream()
        assert any(region._file_refs.values())
        stream.close()
        assert not any(region._file_refs.values())
        stream.close()  # idempotent
        stream = region.scan_stream(tag_predicates={"host": {"h"}})
        assert sum(n for _, n in stream.chunks()) == 100
        assert not any(region._file_refs.values())
        stream.close()
        stream = engine.scan_stream(1, None, None, {"host": {"zz"}})
        assert sum(n for _, n in stream.chunks()) == 0
        stream.close()
    finally:
        engine.close()


WHERES = [
    "host = 'h3'",
    "host IN ('h1', 'h19')",
    "host LIKE 'h1%'",
    "host BETWEEN 'h10' AND 'h19'",
    "host >= 'h5' AND host < 'h7'",
    "host = 'nope'",
]


def _match(where, h):
    if where.startswith("host = "):
        return h == where.split("'")[1]
    if where.startswith("host IN"):
        return h in ("h1", "h19")
    if where.startswith("host LIKE"):
        return re.fullmatch("h1.*", h) is not None
    if where.startswith("host BETWEEN"):
        return "h10" <= h <= "h19"
    return "h5" <= h < "h7"


def test_sql_pruning_correctness_in_every_state(pair):
    """Rich predicates through both engines in the memtable, flushed
    (several files, small row groups), compacted and streamed states:
    the same rows as each other and as the Python oracle, with the
    port's index pruning row groups once the rows are in SSTs."""
    for qe in pair:
        qe.execute_one(
            "CREATE TABLE t (host STRING, ts TIMESTAMP(3) NOT NULL, "
            "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host)) "
            "WITH (append_mode = 'true')")
        _region(qe, "t").sst_writer.row_group_size = 32
    rows = [(f"h{i % 20}", 1000 + i, float(i)) for i in range(400)]

    def insert(lo, hi):
        for qe in pair:
            qe.execute_one("INSERT INTO t VALUES " + ", ".join(
                f"('{h}', {t}, {v})" for h, t, v in rows[lo:hi]))

    def check(state):
        for where in WHERES:
            got = both(pair, f"SELECT host, ts, v FROM t WHERE {where} "
                             f"ORDER BY host, ts")
            want = sorted([list(r) for r in rows[:n] if _match(where, r[0])],
                          key=lambda r: (r[0], r[1]))
            assert got == want, (state, where)
            both(pair, f"SELECT host, count(*), sum(v) FROM t "
                       f"WHERE {where} GROUP BY host ORDER BY host")

    n = 200
    insert(0, 200)
    check("memtable")
    for qe in pair:
        qe.execute_one("ADMIN flush_table('t')")
    n = 400
    insert(200, 400)
    for qe in pair:
        qe.execute_one("ADMIN flush_table('t')")
    region = _region(pair[1], "t")
    before = dict(region.prune_stats)
    check("flushed")
    gained = {k: region.prune_stats[k] - before[k] for k in before}
    assert gained["row_groups_pruned"] > 0 and gained["ssts_pruned"] > 0
    scan = region.scan(tag_predicates={"host": {"h3"}})
    assert scan.num_rows == 20
    assert scan.stats["row_groups_pruned"] > 0
    for qe in pair:
        qe.execute_one("ADMIN compact_table('t')")
    assert len(region.files) == 1
    check("compacted")
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS", "1")
    env.setenv("GREPTIMEDB_TPU_STREAM_BLOCK_ROWS", "1024")
    try:
        for where in WHERES:
            sql = (f"SELECT host, count(*), sum(v) FROM t WHERE {where} "
                   f"GROUP BY host ORDER BY host")
            got = both(pair, sql)
            assert pair[1].executor.last_path.startswith("stream"), sql
            want = {}
            for h, _t, v in rows:
                if _match(where, h):
                    c, s = want.get(h, (0, 0.0))
                    want[h] = (c + 1, s + v)
            assert got == [[h, c, s] for h, (c, s) in sorted(want.items())]
    finally:
        env.undo()


def test_index_prunes_row_groups(pair):
    """tests/test_compaction_index.py::TestInvertedIndex's case on both
    engines: one host a row group; the scan reads only its group."""
    for qe in pair:
        qe.execute_one(
            "CREATE TABLE t (host STRING, v DOUBLE, ts TIMESTAMP TIME "
            "INDEX, PRIMARY KEY(host))")
        _region(qe, "t").sst_writer.row_group_size = 8
        rows = [f"('host{h}', 1.0, {h * 1_000_000 + i})"
                for h in range(4) for i in range(8)]
        qe.execute_one("INSERT INTO t (host, v, ts) VALUES "
                       + ",".join(rows))
        _region(qe, "t").flush()
    jreg, reg = _region(pair[0], "t"), _region(pair[1], "t")
    jmeta = list(jreg.files.values())[0]
    meta = list(reg.files.values())[0]
    for pred, want in (({"host": {"host0"}}, [0]), ({"host": {"host3"}}, [3]),
                       ({"host": {"nope"}}, [])):
        assert reg.sst_reader.index_applier.apply(meta.file_id, pred) == \
            jreg.sst_reader.index_applier.apply(jmeta.file_id, pred) == want
    scan = reg.scan(tag_predicates={"host": {"host0"}})
    assert scan.num_rows == 8
    assert scan.stats == {"ssts": 1, "ssts_pruned": 0, "row_groups": 4,
                          "row_groups_pruned": 3}
    assert both(pair, "SELECT count(*) FROM t WHERE host = 'host0'") == [[8]]


def test_index_blobs_of_flushed_ssts_equal_jax(pair):
    """The same writes flushed by both engines leave index blobs with the
    same terms and bitmaps (the SST formats differ, the index does not;
    the container's properties carry the same row counts)."""
    for qe in pair:
        qe.execute_one(
            "CREATE TABLE t (host STRING, dc STRING, v DOUBLE, "
            "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host, dc))")
        qe.execute_one("INSERT INTO t VALUES " + ", ".join(
            f"('h{i % 7}', {'NULL' if i % 5 == 0 else repr('d%d' % (i % 3))},"
            f" {i}.0, {i * 1000})" for i in range(300)))
        _region(qe, "t").flush()
    blobs = []
    for qe in pair:
        reg = _region(qe, "t")
        meta = list(reg.files.values())[0]
        raw = reg.sst_reader.store.read(
            os.path.join(reg.sst_reader.sst_dir, meta.file_id + ".puffin"))
        r = (jpuffin if qe is pair[0] else
             __import__("greptimedb_tpu_torch.storage.puffin",
                        fromlist=["x"])).PuffinReader(io.BytesIO(bytes(raw)))
        blobs.append(({b.properties["column"]: r.read_blob(b)
                       for b in r.blobs}, r.properties))
    assert blobs[1] == blobs[0]


def test_index_dies_with_its_sst(pair, tmp_path):
    tq = pair[1]
    tq.execute_one("CREATE TABLE t (host STRING, v DOUBLE, ts TIMESTAMP "
                   "TIME INDEX, PRIMARY KEY(host))")
    region = _region(tq, "t")
    for i in range(3):
        tq.execute_one(f"INSERT INTO t VALUES ('h{i}', 1.0, {i * 1000})")
        region.flush()
    sst_dir = region.sst_reader.sst_dir

    def listing():
        return sorted(os.path.splitext(f) for f in os.listdir(sst_dir)
                      if not f.endswith(".tmp"))

    ids = set(region.files)
    assert listing() == sorted((fid, ext) for fid in ids
                               for ext in (".puffin", ".sst"))
    tq.execute_one("ADMIN compact_table('t')")
    (merged,) = region.files
    assert listing() == [(merged, ".puffin"), (merged, ".sst")]
    for fid in ids:
        assert region.sst_reader.index_applier.apply(
            fid, {"host": {"h1"}}) is None
    assert tq.execute_one("SELECT host FROM t WHERE host = 'h1'").rows() \
        == [["h1"]]
    tq.execute_one("DROP TABLE t")
    assert not os.path.exists(sst_dir) or listing() == []
