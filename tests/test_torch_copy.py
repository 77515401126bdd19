"""COPY TO / FROM, COPY DATABASE and the port's hand-written Parquet and
ORC codecs (greptimedb_tpu_torch/datasource/) against the JAX engine and
pyarrow, on the CPU.

- COPY TO in CSV, ndjson (and `.gz`), Parquet and ORC from the same
  table in both engines: the port's CSV and ndjson bytes equal the JAX
  engine's; pyarrow reads the port's Parquet and ORC files as the JAX
  engine's (schema and values).
- COPY FROM files the JAX engine wrote gives the JAX engine's rows;
  COPY DATABASE TO / FROM likewise.
- Files pyarrow writes in the variants the issue lists (Parquet: default
  2.6 / SNAPPY / dictionary, no compression, gzip, no dictionary, data
  page v2, small row groups and pages; ORC: none, zlib, snappy,
  dictionary strings, small stripes, 0.11) with NULLs in every column
  type, read by the port as pyarrow reads them; codecs the port cannot
  decode (zstd, lz4, brotli) refused naming the codec.
"""

import gzip
import io

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pyarrow.parquet as pq
import pytest

from greptimedb_tpu import datasource as jds
from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryContext as JContext
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch import datasource
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.datasource import convert, orc, parquet
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

DDL = ("CREATE TABLE t (host STRING, dc STRING, v DOUBLE, f FLOAT, "
       "i BIGINT, s SMALLINT, b BOOLEAN, ts TIMESTAMP(3) TIME INDEX, "
       "PRIMARY KEY(host))")
UNIT_DDL = "CREATE TABLE {} (host STRING, v DOUBLE, ts {} TIME INDEX, " \
    "PRIMARY KEY(host))"
UNITS = {"t_s": "TIMESTAMP(0)", "t_us": "TIMESTAMP(6)", "t_ns": "TIMESTAMP(9)"}
#: per unit table, a time with a fraction of a second in the unit (none
#: for seconds) and one day
UNIT_TIMES = {"t_s": (1_700_000_000, 86_400),
              "t_us": (1_700_000_000_123_456, 86_400_000_000),
              "t_ns": (1_700_000_000_123_456_789, 86_400_000_000_000)}


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _rows_sql(n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        dc = "NULL" if k % 5 == 0 else f"'dc\"{k % 3},x'"
        v = "NULL" if k % 7 == 0 else repr(float(rng.normal() * 10.0 **
                                                 rng.integers(-8, 12)))
        rows.append(f"('h{k % 4}', {dc}, {v}, {rng.uniform(-5, 5):.3f}, "
                    f"{int(rng.integers(-2**40, 2**40))}, "
                    f"{int(rng.integers(-300, 300))}, "
                    f"{'true' if k % 3 else 'false'}, "
                    f"{1_600_000_000_000 + k * 1500 + int(rng.integers(0, 999))})")
    return "INSERT INTO t VALUES " + ", ".join(rows)


@pytest.fixture
def pair(tmp_path):
    je = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                               maintenance_workers=0))
    jq = JQueryEngine(JCatalog(JMemoryKv()), je)
    te = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"),
                                   maintenance_workers=0), device="cpu")
    tq = QueryEngine(Catalog(MemoryKv()), te, device="cpu")
    for qe in (jq, tq):
        qe.execute_one(DDL)
        qe.execute_one(_rows_sql(60, 3))
        for name, ty in UNITS.items():
            qe.execute_one(UNIT_DDL.format(name, ty))
            t1, day = UNIT_TIMES[name]
            qe.execute_one(f"INSERT INTO {name} VALUES ('a', 1.5, 0), "
                           f"('b', NULL, {t1}), ('a', 2.5, {day})")
    yield jq, tq
    je.close()
    te.close()


def _nan_free(t: pa.Table) -> list:
    """Rows with NaN spelled "nan" (NaN != NaN would fail equal tables)."""
    return [{k: ("nan" if isinstance(v, float) and v != v else v)
             for k, v in r.items()} for r in t.to_pylist()]


def _plain(rows) -> list:
    return [[v.item() if hasattr(v, "item") else v for v in r] for r in rows]


def _read_text(path) -> bytes:
    data = open(path, "rb").read()
    return gzip.decompress(data) if path.endswith(".gz") else data


def _arrow(path) -> pa.Table:
    return pq.read_table(path) if path.endswith(".parquet") \
        else po.read_table(path)


@pytest.mark.parametrize("ext", ["csv", "csv.gz", "ndjson", "json.gz",
                                 "parquet", "orc"])
@pytest.mark.parametrize("table", ["t", "t_s", "t_us", "t_ns"])
def test_copy_to_writes_the_jax_file(pair, tmp_path, ext, table):
    jq, tq = pair
    paths = [str(tmp_path / f"{who}.{ext}") for who in ("jax", "port")]
    results = [qe.execute_one(f"COPY {table} TO '{p}'").affected_rows
               for qe, p in zip(pair, paths)]
    assert results[0] == results[1] > 0
    if ext in ("parquet", "orc"):
        jt, tt = _arrow(paths[0]), _arrow(paths[1])
        assert tt.schema.equals(jt.schema, check_metadata=False)
        assert _nan_free(tt) == _nan_free(jt)
    else:
        assert _read_text(paths[1]) == _read_text(paths[0])


@pytest.mark.parametrize("ext", ["csv", "csv.gz", "ndjson", "parquet",
                                 "orc"])
def test_copy_from_the_jax_file_gives_the_jax_rows(pair, tmp_path, ext):
    jq, tq = pair
    path = str(tmp_path / f"t.{ext}")
    jq.execute_one(f"COPY t TO '{path}'")
    for qe in pair:
        qe.execute_one(DDL.replace("TABLE t ", "TABLE t2 "))
    counts = [qe.execute_one(f"COPY t2 FROM '{path}'").affected_rows
              for qe in pair]
    assert counts[0] == counts[1] == 60
    q = "SELECT host, dc, v, f, i, s, b, ts FROM t2 ORDER BY ts, host"
    j, t = (_plain(qe.execute_one(q).rows()) for qe in pair)
    assert t == j


def test_copy_database_to_and_from_as_jax(pair, tmp_path):
    outs = []
    for who, qe, ctx in (("jax", pair[0], JContext()),
                         ("port", pair[1], QueryContext())):
        out = tmp_path / f"db_{who}"
        r = qe.execute_one(f"COPY DATABASE public TO '{out}' "
                           "WITH (format = 'parquet')", ctx)
        outs.append((r.affected_rows, sorted(p.name for p in out.iterdir())))
        qe.execute_one("CREATE DATABASE db2", ctx)
        c2 = JContext(db="db2") if who == "jax" else QueryContext(db="db2")
        qe.execute_one(DDL, c2)
        qe.execute_one(UNIT_DDL.format("t_ns", UNITS["t_ns"]), c2)
        src = tmp_path / "db_jax"  # both load the files the JAX one wrote
        r = qe.execute_one(f"COPY DATABASE db2 FROM '{src}'", c2)
        rows = qe.execute_one("SELECT count(*), sum(i) FROM t", c2).rows()
        outs.append((r.affected_rows, _plain(rows)))
    assert outs[2] == outs[0] and outs[3] == outs[1]


# ---- the codecs against pyarrow ------------------------------------------------


def _variety(n: int, seed: int) -> pa.Table:
    """Every column type the port reads, NULLs in each."""
    rng = np.random.default_rng(seed)

    def nulls(vals, t):
        mask = rng.random(n) < 0.15
        return pa.array([None if m else v for v, m in
                         zip(vals.tolist(), mask)], t)
    return pa.table({
        "s": nulls(np.array([f"host_{i % 23}" for i in range(n)]),
                   pa.string()),
        "u": pa.array([f"uniq{i}é" for i in range(n)]),
        "f64": nulls(rng.normal(size=n), pa.float64()),
        "f32": nulls(rng.random(n).astype(np.float32), pa.float32()),
        "i8": nulls(rng.integers(-128, 128, n), pa.int8()),
        "i16": nulls(rng.integers(-2**15, 2**15, n), pa.int16()),
        "i32": nulls(rng.integers(-2**31, 2**31, n), pa.int32()),
        "i64": nulls(rng.integers(-2**62, 2**62, n), pa.int64()),
        "b": nulls(rng.random(n) > 0.5, pa.bool_()),
        "ts_ms": nulls(rng.integers(-2**40, 2**41, n), pa.timestamp("ms")),
        "ts_us": nulls(rng.integers(0, 2**50, n),
                       pa.timestamp("us", tz="UTC")),
        "ts_ns": nulls(rng.integers(-2**60, 2**61, n), pa.timestamp("ns")),
        "d": nulls(rng.integers(-1000, 30000, n).astype(np.int32),
                   pa.date32()),
    })


_UNSIGNED = {"u8": pa.uint8(), "u16": pa.uint16(), "u32": pa.uint32(),
             "u64": pa.uint64()}


def _held_to(port_table, ref: pa.Table) -> None:
    assert port_table.names == ref.schema.names
    assert port_table.num_rows == ref.num_rows
    for name in ref.schema.names:
        field = ref.schema.field(name)
        col = port_table.column(name)
        want = ref.column(name)
        if pa.types.is_timestamp(field.type) or pa.types.is_date(field.type):
            assert col.type == ("date32" if pa.types.is_date(field.type)
                                else f"timestamp[{field.type.unit}]"), name
            want = want.cast(pa.int32() if pa.types.is_date(field.type)
                             else pa.int64())
            valid = col.valid if col.valid is not None else \
                np.ones(len(col), dtype=bool)
            got = [int(v) if ok else None
                   for v, ok in zip(col.values.tolist(), valid.tolist())]
        else:
            assert col.type == str(field.type).replace("large_", ""), name
            got = col.to_pylist()
        if pa.types.is_floating(field.type):
            got = [None if v is None else float(np.asarray(
                v, dtype=field.type.to_pandas_dtype())) for v in got]
        assert got == want.to_pylist(), name


@pytest.mark.parametrize("kw", [
    {}, {"compression": "none"}, {"compression": "gzip"},
    {"use_dictionary": False}, {"data_page_version": "2.0"},
    {"row_group_size": 97}, {"data_page_size": 256},
    {"data_page_version": "2.0", "compression": "gzip",
     "row_group_size": 333}],
    ids=["default", "none", "gzip", "no_dictionary", "page_v2",
         "row_groups", "small_pages", "v2_gzip_groups"])
def test_parquet_pyarrow_variants_read_as_pyarrow(kw):
    t = _variety(1000, 5)
    t = t.append_column("u64", pa.array(
        np.arange(1000, dtype=np.uint64) * (2**54), pa.uint64()))
    for name, typ in _UNSIGNED.items():
        if name != "u64":
            t = t.append_column(name, pa.array(
                np.arange(1000) % 200, typ))
    buf = io.BytesIO()
    pq.write_table(t, buf, **kw)
    _held_to(parquet.read(buf.getvalue()),
             pq.read_table(io.BytesIO(buf.getvalue())))


@pytest.mark.parametrize("kw", [
    {}, {"compression": "zlib"}, {"compression": "snappy"},
    {"dictionary_key_size_threshold": 1.0},
    {"stripe_size": 20000, "compression": "zlib"},
    {"file_version": "0.11"}],
    ids=["default", "zlib", "snappy", "dictionary", "stripes", "v0_11"])
def test_orc_pyarrow_variants_read_as_pyarrow(kw):
    t = _variety(3000, 6).drop(["ts_us"])
    # monotone, repeated and outlier-patched integers: every RLE v2
    # sub-encoding
    base = np.arange(3000, dtype=np.int64)
    t = t.append_column("mono", pa.array(base * 10_000 + 7, pa.int64()))
    t = t.append_column("rep", pa.array(np.repeat(base[::6] % 5, 6),
                                        pa.int64()))
    patched = base % 100
    patched[::97] = 10**15
    t = t.append_column("patched", pa.array(patched, pa.int64()))
    buf = io.BytesIO()
    po.write_table(t, buf, **kw)
    _held_to(orc.read(buf.getvalue()),
             po.read_table(io.BytesIO(buf.getvalue())))


@pytest.mark.parametrize("fmt,codec", [("parquet", "zstd"),
                                       ("parquet", "lz4"),
                                       ("parquet", "brotli"),
                                       ("orc", "zstd"), ("orc", "lz4")])
def test_undecodable_codecs_are_refused_naming_them(fmt, codec):
    t = _variety(50, 7)
    buf = io.BytesIO()
    (pq.write_table if fmt == "parquet" else po.write_table)(
        t.drop(["ts_us"]), buf, compression=codec)
    with pytest.raises(datasource.DataSourceError,
                       match=codec.upper().replace("LZ4", "LZ4")):
        (parquet.read if fmt == "parquet"
         else orc.read)(buf.getvalue())


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_port_files_read_by_pyarrow_as_written(fmt):
    """A table the port read from pyarrow's file, written back by the
    port (each codec), reads in pyarrow as pyarrow's own file."""
    t = _variety(700, 8)
    if fmt == "orc":
        t = t.drop(["ts_us"])
    buf = io.BytesIO()
    (pq.write_table if fmt == "parquet" else po.write_table)(t, buf)
    ref = (pq.read_table if fmt == "parquet" else po.read_table)(
        io.BytesIO(buf.getvalue()))
    mod = {"parquet": parquet, "orc": orc}[fmt]
    port = mod.read(buf.getvalue())
    for codec in (("snappy", "gzip", "none") if fmt == "parquet"
                  else ("none", "zlib", "snappy")):
        back = (pq.read_table if fmt == "parquet" else po.read_table)(
            io.BytesIO(mod.write(port, codec)))
        if fmt == "parquet":
            back = back.set_column(back.schema.get_field_index("ts_us"),
                                   "ts_us", back.column("ts_us").cast(
                                       pa.timestamp("us", tz="UTC")))
        assert back.schema.equals(ref.schema, check_metadata=False)
        assert back.to_pylist() == ref.to_pylist()


def test_orc_refuses_unsigned_and_null_columns_as_pyarrow(tmp_path):
    for t in (pa.table({"u": pa.array([1, 2], pa.uint32())}),
              pa.table({"n": pa.array([None, None], pa.null())})):
        with pytest.raises(Exception):
            po.write_table(t, str(tmp_path / "x.orc"))
        port = datasource.TextTable(
            t.schema.names, {t.schema.names[0]: datasource.TextColumn(
                np.zeros(2, dtype=np.int64), None,
                str(t.schema.field(0).type))}, 2)
        with pytest.raises(datasource.DataSourceError, match="refuses"):
            orc.write(port)


@pytest.mark.parametrize("ext", ["parquet", "orc", "csv", "ndjson"])
def test_table_to_result_as_jax(tmp_path, ext):
    t = pa.table({"host": ["a", None, "c"], "v": [1.5, None, 3.0],
                  "n": pa.array([1, None, 3], pa.int64()),
                  "ts": pa.array([1000, 2000, 3000], pa.timestamp("ms"))})
    path = str(tmp_path / f"x.{ext}")
    jds.write_file(t, path)
    j = jds.table_to_result(jds.read_file(path))
    p = convert.table_to_result(datasource.read_file(path))
    assert p.names == j.names
    assert [d.value for d in p.dtypes] == [d.value for d in j.dtypes]
    for a, b in zip(j.columns, p.columns):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "M":
            a = a.astype(np.int64)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(b.astype(np.float64), a)
        else:
            assert b.tolist() == a.tolist()
