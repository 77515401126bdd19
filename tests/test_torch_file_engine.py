"""The port's file engine and text readers (greptimedb_tpu_torch/
storage/file_engine.py, greptimedb_tpu_torch/datasource/) held against
the JAX package's on the CPU: the same CSV, ndjson and gzip'd files,
read by pyarrow in the JAX package and by hand in the port, give the
same columns, types, DESCRIBE output, rows and errors.

The twins of tests/test_file_engine.py's CSV, ndjson and .gz cases:
explicit and inferred schemas, the time filter, reopen (through the
opener and on a fresh engine), NULL tags, the read-only and TRUNCATE
errors, DROP. The text files are written here with plain Python; the
Parquet and ORC files (A12-io) by pyarrow, and the port reads them by
hand (tests/test_torch_copy.py holds every variant to pyarrow).
"""

import gzip
import json
import os

import numpy as np
import pytest

from greptimedb_tpu import datasource as jds
from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch import datasource
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine, UnsupportedStatement
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.file_engine import FileRegion


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


CPU_DDL = ("CREATE TABLE cpu (host STRING, usage DOUBLE, "
           "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host))")
CPU_ROWS = ("INSERT INTO cpu (host, usage, ts) VALUES "
            "('a', 1.0, 1000), ('a', 3.0, 61000), ('b', 10.0, 2000)")


@pytest.fixture
def pair(tmp_path):
    je = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                               write_workers=0, maintenance_workers=0))
    jq = JQueryEngine(JCatalog(JMemoryKv()), je)
    te = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"),
                                   maintenance_workers=0), device="cpu")
    tq = QueryEngine(Catalog(MemoryKv()), te, device="cpu")
    for qe in (jq, tq):
        qe.execute_one(CPU_DDL)
        qe.execute_one(CPU_ROWS)
    yield jq, tq
    je.close()
    te.close()


def both(pair, sql):
    out = [qe.execute_one(sql).rows() for qe in pair]
    assert out[1] == out[0], sql
    return out[1]


def both_err(pair, sql):
    errs = []
    for qe in pair:
        with pytest.raises(Exception) as ei:
            qe.execute_one(sql)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[1] == errs[0], sql
    return errs[1]


def write_csv(path, names, rows):
    text = ",".join(names) + "\n" + "".join(
        ",".join("" if v is None else str(v) for v in r) + "\n"
        for r in rows)
    data = text.encode()
    with open(path, "wb") as f:
        f.write(gzip.compress(data) if path.endswith(".gz") else data)
    return path


def write_ndjson(path, names, rows):
    text = "".join(json.dumps(dict(zip(names, r))) + "\n" for r in rows)
    data = text.encode()
    with open(path, "wb") as f:
        f.write(gzip.compress(data) if path.endswith(".gz") else data)
    return path


# ---- datasource ----------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ("/x/a.csv",), ("/x/a.json.gz",), ("/x/a.ndjson",), ("/x/a.jsonl",),
    ("/x/a.parquet",), ("/x/a.orc",), ("/x/a.bin", "CSV"),
    ("/x/a.bin", "ndjson"), ("/x/a.bin",), ("/x/a.csv", "avro"),
])
def test_format_inference_matches_jax(args):
    outs = []
    for mod in (jds, datasource):
        try:
            outs.append(mod.infer_format(*args))
        except mod.DataSourceError as e:
            outs.append(("DataSourceError", str(e)))
    assert outs[1] == outs[0]


MIXED = (["i", "f", "b", "s", "t", "ti", "n", "e"], [
    [1, 1.5, "true", "x", "2024-01-01T00:00:00", 10, None, "a,b"],
    [2, 2, "false", "y", "2024-01-02 03:04:05", 20, None, ""],
    [None, -0.25, "True", "z", "2024-01-03T00:00:00Z", 30, None, "c"],
])


@pytest.mark.parametrize("ext", ["csv", "csv.gz", "json", "ndjson.gz"])
def test_text_readers_match_pyarrow(tmp_path, ext):
    names, rows = MIXED
    if ext.startswith("csv"):
        # a quoted field takes the csv module's path
        rows = [r[:-1] + [f'"{r[-1]}"'] for r in rows]
        path = write_csv(str(tmp_path / f"t.{ext}"), names, rows)
    else:
        path = write_ndjson(str(tmp_path / f"t.{ext}"), names,
                            [[v in ("true", "True") if v in (
                                "true", "True", "false") else v
                              for v in r] for r in rows])
    jt = jds.read_file(path)
    pt = datasource.read_file(path)
    assert pt.names == list(jt.schema.names)
    assert pt.num_rows == jt.num_rows
    for f in jt.schema:
        col = pt.column(f.name)
        assert col.type == str(f.type).replace(", tz=UTC", ""), f.name
        got, want = col.to_pylist(), jt.column(f.name).to_pylist()
        want = [w.replace(tzinfo=None) if hasattr(w, "tzinfo") and w.tzinfo
                else w for w in want]
        assert got == want, f.name


def test_csv_null_spellings_and_strings(tmp_path):
    path = write_csv(str(tmp_path / "n.csv"), ["a", "b", "c", "d"], [
        [1, "N/A", "NULL", "x"], [2, "null", None, "NULL"],
        [None, "NaN", "-inf", ""]])
    jt, pt = jds.read_file(path), datasource.read_file(path)
    for f in jt.schema:
        assert pt.column(f.name).type == str(f.type), f.name
        assert pt.column(f.name).to_pylist() == \
            jt.column(f.name).to_pylist(), f.name


def test_mixed_json_kinds_are_refused(tmp_path):
    path = write_ndjson(str(tmp_path / "m.json"), ["a"], [[1], ["x"]])
    with pytest.raises(Exception):
        jds.read_file(path)
    with pytest.raises(datasource.DataSourceError, match="mixes"):
        datasource.read_file(path)


# ---- C9 and C10: the readers against pyarrow's types and values ---------------

#: (format, the column's values) for each case of ROADMAP C9 and C10, and
#: the spellings next to them; None is a NULL (an empty CSV field)
C9_C10 = {
    # C9: an int past int64 is a double column
    "csv_int_past_int64": ("csv", ["9223372036854775808", "1"]),
    "csv_int_below_int64": ("csv", ["-9223372036854775809", "-1"]),
    "csv_int64_edges": ("csv", ["9223372036854775807",
                                "-9223372036854775808"]),
    "json_int_past_int64": ("json", [2 ** 63, 1]),
    "json_int_below_int64_with_null": ("json", [-2 ** 63 - 1, None, 5]),
    # C9: matches the date or time shape, but is no real date or time
    "csv_no_such_day": ("csv", ["2024-02-30", "2024-01-01"]),
    "csv_no_such_leap_day": ("csv", ["2023-02-29"]),
    "csv_leap_second": ("csv", ["2024-12-31T23:59:60",
                                "2024-12-31T23:59:59"]),
    "csv_hour_24": ("csv", ["2024-12-31T24:00:00"]),
    "json_no_such_day": ("json", ["2024-02-30", "2024-01-01"]),
    "json_leap_second": ("json", ["2024-12-31T23:59:60"]),
    # C10: timestamps with and without a fraction in one column
    "csv_fraction_and_whole_seconds": ("csv", ["2024-01-01 00:00:00.5",
                                               "2024-01-01 00:00:01"]),
    "csv_fraction_and_date": ("csv", ["2024-01-01T00:00:00.25",
                                      "2024-01-02"]),
    "csv_fraction_zoned": ("csv", ["2024-01-01T00:00:00.5+01:00",
                                   "2024-01-01T00:00:01Z"]),
    "csv_hour_and_minute_precision": ("csv", ["2024-01-01T05",
                                              "2024-01-01 06:30"]),
    "csv_zone_hours_only": ("csv", ["2024-01-01T00:00:00+01",
                                    "2024-01-01T00:00:00-0130"]),
    "csv_zoned_and_naive": ("csv", ["2024-01-01T00:00:00Z",
                                    "2024-01-01T00:00:01"]),
    "json_fraction_is_string": ("json", ["2024-01-01T00:00:00.5",
                                         "2024-01-01T00:00:01"]),
    "json_zoned_and_naive": ("json", ["2024-01-01T00:00:00+01:00",
                                      "2024-01-01T00:00:01"]),
    # C10: number spellings
    "csv_plus_sign": ("csv", ["+5", "6"]),
    "csv_padded_int": ("csv", [" 5", "6 ", "\t7"]),
    "csv_hex_int": ("csv", ["0x10", "0XfF", "5"]),
    "csv_hex_wraps": ("csv", ["0xFFFFFFFFFFFFFFFF", "0x8000000000000000"]),
    "csv_signed_hex": ("csv", ["-0x10"]),
    "csv_hex_and_double": ("csv", ["0x10", "1.5"]),
    "csv_underscores": ("csv", ["1_000", "2"]),
    "csv_underscore_double": ("csv", ["1_0.5"]),
    "csv_double_spellings": ("csv", ["1e5", ".5", "5.", "-.5", "+1.5",
                                     " 2.5 ", "1E+05", "1e400"]),
    "csv_infinities": ("csv", ["inf", "-Infinity", "+INF", "1"]),
    "csv_not_numbers": ("csv", ["1.5e", "e5", "1d", "0b101"]),
    "csv_unicode_digits": ("csv", ["\u0661\u0662", "1"]),
    "csv_padded_date": ("csv", [" 2024-01-01", "2024-01-02 "]),
    "csv_int_with_nulls": ("csv", ["0x10", None, "NULL", "3"]),
}


def _pylist(col) -> list:
    """Python values, timestamps naive (pyarrow's zoned ones are UTC)."""
    return [v.replace(tzinfo=None) if getattr(v, "tzinfo", None) else v
            for v in col.to_pylist()]


def _write_case(tmp_path, fmt, values, with_ts=False):
    names = ["c", "ts"] if with_ts else ["c"]
    rows = [[v, 1000 * (i + 1)] if with_ts else [v]
            for i, v in enumerate(values)]
    write = write_csv if fmt == "csv" else write_ndjson
    return write(str(tmp_path / f"case.{fmt}"), names, rows)


@pytest.mark.parametrize("case", sorted(C9_C10))
def test_c9_c10_readers_match_pyarrow(case, tmp_path):
    """Each value grammar of ROADMAP C9 and C10 gets pyarrow's column type
    and values (ns timestamps compared as integers)."""
    fmt, values = C9_C10[case]
    path = _write_case(tmp_path, fmt, values)
    jt, pt = jds.read_file(path), datasource.read_file(path)
    want_type = str(jt.schema.field("c").type)
    col = pt.column("c")
    assert col.type == want_type.replace(", tz=UTC", "").replace(
        "date32[day]", "date32")
    if col.type == "timestamp[ns]":
        want = jt.column("c").cast("int64").to_pylist()
        assert col.values.tolist() == want
    else:
        assert _pylist(col) == _pylist(jt.column("c"))


@pytest.mark.parametrize("case", sorted(set(C9_C10) - {"csv_padded_date"}))
def test_c9_c10_external_tables_match_jax(case, pair, tmp_path):
    """The same files as inferred external tables answer alike in both
    engines: a C9 value no longer raises, a mixed-fraction timestamp
    column is the time index (C10). The date32 column is R8's (the JAX
    scan raises) and stays out."""
    fmt, values = C9_C10[case]
    path = _write_case(tmp_path, fmt, values, with_ts=True)
    both(pair, f"CREATE EXTERNAL TABLE e WITH (location = '{path}')")
    desc = both(pair, "DESCRIBE TABLE e")
    ts_col = next(r[0] for r in desc if r[5] == "TIMESTAMP")
    if "fraction_and" in case or "zone_hours" in case \
            or "hour_and_minute" in case or "fraction_zoned" in case:
        assert ts_col == "c"
    both(pair, f"SELECT * FROM e ORDER BY {ts_col}")
    both(pair, "SELECT count(*), count(c) FROM e")


@pytest.mark.parametrize("value,arrow", [({"a": 1}, "struct"),
                                         ([1, 2], "list")])
def test_nested_json_columns_get_their_own_refusal(tmp_path, value, arrow):
    """pyarrow reads ndjson objects and arrays as struct and list columns,
    which the port has no type for: a typed refusal naming the type, not
    the "mixes" text of a truly mixed column."""
    path = write_ndjson(str(tmp_path / "n.json"), ["c", "ts"],
                        [[value, 1000], [None, 2000]])
    assert str(jds.read_file(path).schema.field("c").type).startswith(arrow)
    with pytest.raises(datasource.NestedJsonColumn, match=arrow) as e:
        datasource.read_file(path)
    assert "mixes" not in str(e.value)


@pytest.mark.parametrize("ext", ["parquet", "orc"])
def test_parquet_and_orc_name_a12_io(tmp_path, ext):
    """Parquet and ORC read and write on the port now (A12-io): the case
    keeps its id and holds `read_file` / `write_file` to the JAX
    package's pyarrow on the same file."""
    import pyarrow as pa

    t = pa.table({"host": pa.array(["a", None, "b"]),
                  "v": pa.array([1.5, 2.5, None]),
                  "n": pa.array([1, None, 3], pa.int64()),
                  "ts": pa.array([1000, 2000, 3000], pa.timestamp("ms"))})
    path = str(tmp_path / f"t.{ext}")
    jds.write_file(t, path)
    got = datasource.read_file(path)
    want = jds.read_file(path)
    assert got.names == want.schema.names
    for name in got.names:
        want_type = str(want.schema.field(name).type)
        assert got.column(name).type == want_type, name
        if want_type.startswith("timestamp"):
            assert got.column(name).values.tolist() == \
                want.column(name).cast("int64").to_pylist()
        else:
            assert got.column(name).to_pylist() == \
                want.column(name).to_pylist(), name
    out = str(tmp_path / f"u.{ext}")
    assert datasource.write_file(got, out) == 3
    back, ref = jds.read_file(out), jds.read_file(path)
    assert back.schema.equals(ref.schema) and back.equals(ref)


# ---- the file engine ---------------------------------------------------------


def test_external_table_explicit_schema(pair, tmp_path):
    path = write_csv(str(tmp_path / "city.csv"), ["city", "pop", "ts"],
                     [["sf", 1.0, 1000], ["nyc", 2.0, 2000],
                      ["sf", 3.0, 3000]])
    both(pair, f"CREATE EXTERNAL TABLE city (city STRING, pop DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(city)) "
               f"WITH (location = '{path}', format = 'csv')")
    assert both(pair, "SELECT city, pop FROM city ORDER BY ts") == [
        ["sf", 1.0], ["nyc", 2.0], ["sf", 3.0]]
    assert both(pair, "SELECT city, sum(pop) FROM city GROUP BY city "
                      "ORDER BY city") == [["nyc", 2.0], ["sf", 4.0]]
    both(pair, "DESCRIBE TABLE city")
    both(pair, "SHOW CREATE TABLE city")


@pytest.mark.parametrize("ext", ["csv", "csv.gz", "ndjson", "json.gz"])
def test_external_table_inferred_schema(pair, tmp_path, ext):
    names = ["host", "v", "n", "ok", "ts"]
    rows = [["x", 1.5, 1, True, "2024-01-01T00:00:00"],
            ["y", 2.5, 2, False, "2024-01-01T00:00:10"],
            ["x", 3.5, 3, True, "2024-01-01T00:00:20"]]
    if ext.startswith("csv"):
        path = write_csv(str(tmp_path / f"infer.{ext}"), names,
                         [[str(v).lower() if isinstance(v, bool) else v
                           for v in r] for r in rows])
    else:
        path = write_ndjson(str(tmp_path / f"infer.{ext}"), names, rows)
    both(pair, f"CREATE EXTERNAL TABLE ext WITH (location = '{path}')")
    desc = both(pair, "DESCRIBE TABLE ext")
    sem = {row[0]: row[5] for row in desc}
    assert sem["host"] == "TAG" and sem["v"] == "FIELD"
    assert sem["ts"] == "TIMESTAMP"
    assert both(pair, "SELECT count(*) FROM ext") == [[3]]
    both(pair, "SELECT host, sum(v), max(n), count(ok) FROM ext "
               "GROUP BY host ORDER BY host")
    both(pair, "SELECT * FROM ext ORDER BY ts")


def test_infer_without_time_index_fails_alike(pair, tmp_path):
    path = write_csv(str(tmp_path / "nots.csv"), ["host", "v"],
                     [["x", 1.0]])
    kind, text = both_err(
        pair, f"CREATE EXTERNAL TABLE nots WITH (location = '{path}')")
    assert kind == "FileEngineError" and "time index" in text


def test_external_table_readonly(pair, tmp_path):
    path = write_csv(str(tmp_path / "ro.csv"), ["host", "v", "ts"],
                     [["x", 1.0, 1000]])
    both(pair, f"CREATE EXTERNAL TABLE ro (host STRING, v DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
               f"WITH (location = '{path}')")
    kind, text = both_err(
        pair, "INSERT INTO ro (host, v, ts) VALUES ('y', 2, 2000)")
    assert kind == "FileEngineError" and "read-only" in text


def test_external_table_time_filter(pair, tmp_path):
    path = write_ndjson(str(tmp_path / "tf.ndjson"), ["host", "v", "ts"],
                        [["x", 1.0, 1000], ["x", 2.0, 2000],
                         ["x", 3.0, 3000]])
    both(pair, f"CREATE EXTERNAL TABLE tf (host STRING, v DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
               f"WITH (location = '{path}')")
    assert both(pair, "SELECT v FROM tf WHERE ts >= 2000 ORDER BY ts") == [
        [2.0], [3.0]]
    # R3 (ROADMAP C): the JAX engine answers a second window over the
    # same file from the first window's device blocks (its file scans
    # carry no fingerprint); the port is held to the rows themselves,
    # which a fresh JAX engine gives
    second = "SELECT v FROM tf WHERE ts >= 1000 AND ts < 3000 ORDER BY ts"
    assert pair[1].execute_one(second).rows() == [[1.0], [2.0]]
    assert pair[0].execute_one(second).rows() == [[1.0]]
    je = JRegionEngine(JConfig(data_dir=str(tmp_path / "fresh"),
                               write_workers=0, maintenance_workers=0))
    try:
        jq = JQueryEngine(JCatalog(JMemoryKv()), je)
        jq.execute_one(f"CREATE EXTERNAL TABLE tf (host STRING, v DOUBLE, "
                       f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
                       f"WITH (location = '{path}')")
        assert jq.execute_one(second).rows() == [[1.0], [2.0]]
    finally:
        je.close()


def test_external_table_reopen(pair, tmp_path):
    """File region metadata survives in kv; the opener reopens it, and a
    second query is served from the mtime cache."""
    path = write_csv(str(tmp_path / "ro2.csv"), ["host", "v", "ts"],
                     [["x", 9.0, 1000]])
    both(pair, f"CREATE EXTERNAL TABLE ro2 (host STRING, v DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
               f"WITH (location = '{path}')")
    for qe in pair:
        rid = qe.catalog.table("public", "ro2").region_ids[0]
        qe.region_engine.regions.pop(rid)
        getattr(qe, "_open_regions", set()).discard(rid)
    assert both(pair, "SELECT v FROM ro2") == [[9.0]]
    region = pair[1].region_engine.region(
        pair[1].catalog.table("public", "ro2").region_ids[0])
    assert isinstance(region, FileRegion)
    loads = region.loads
    assert both(pair, "SELECT count(*) FROM ro2") == [[1]]
    assert region.loads == loads and region.cache_hits >= 1
    # a rewritten file is read again (data_version is its mtime)
    write_csv(path, ["host", "v", "ts"], [["x", 9.0, 1000],
                                          ["y", 1.0, 2000]])
    os.utime(path, ns=(10**18, 10**18))
    assert both(pair, "SELECT count(*) FROM ro2") == [[2]]
    assert region.loads == loads + 1


def test_truncate_external_rejected(pair, tmp_path):
    path = write_csv(str(tmp_path / "tr.csv"), ["host", "v", "ts"],
                     [["x", 1.0, 1000]])
    both(pair, f"CREATE EXTERNAL TABLE tr (host STRING, v DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
               f"WITH (location = '{path}')")
    kind, _ = both_err(pair, "TRUNCATE TABLE tr")
    assert kind == "PlanError"
    assert both(pair, "SELECT count(*) FROM tr") == [[1]]


def test_external_reopen_fresh_engine(pair, tmp_path):
    """A new RegionEngine + QueryEngine over the same kv registers the
    file opener eagerly and the external table still reads."""
    path = write_csv(str(tmp_path / "fresh.csv"), ["host", "v", "ts"],
                     [["z", 5.0, 1000]])
    sql = (f"CREATE EXTERNAL TABLE fr (host STRING, v DOUBLE, "
           f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
           f"WITH (location = '{path}')")
    both(pair, sql)
    engine2 = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d2"),
                                        maintenance_workers=0),
                           device="cpu")
    qe2 = QueryEngine(pair[1].catalog, engine2, device="cpu")
    try:
        assert qe2.execute_one("SELECT v FROM fr").rows() == [[5.0]]
    finally:
        engine2.close()


def test_null_tags_match_native_semantics(pair, tmp_path):
    path = write_ndjson(str(tmp_path / "nulls.json"), ["host", "v", "ts"],
                        [["x", 1.0, 1000], [None, 2.0, 2000]])
    both(pair, f"CREATE EXTERNAL TABLE nt (host STRING, v DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
               f"WITH (location = '{path}')")
    assert both(pair, "SELECT host, v FROM nt ORDER BY ts") == [
        ["x", 1.0], [None, 2.0]]
    both(pair, "SELECT host, count(*) FROM nt GROUP BY host ORDER BY host")


def test_drop_external_table(pair, tmp_path):
    path = write_csv(str(tmp_path / "dr.csv"), ["host", "v", "ts"],
                     [["x", 1.0, 1000]])
    both(pair, f"CREATE EXTERNAL TABLE dr (host STRING, v DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
               f"WITH (location = '{path}')")
    both(pair, "DROP TABLE dr")
    assert os.path.exists(path)  # dropping the table keeps the file
    assert "dr" not in [r[0] for r in both(pair, "SHOW TABLES")]
    entries = [sorted(qe.catalog.kv.range("__file_engine/"))
               for qe in pair]
    assert entries[1] == entries[0]


def test_kv_entries_and_information_schema(pair, tmp_path):
    path = write_csv(str(tmp_path / "kv.csv"), ["host", "v", "ts"],
                     [["x", 1.0, 1000]])
    for name in ("e1", "e2"):
        both(pair, f"CREATE EXTERNAL TABLE {name} (host STRING, v DOUBLE, "
                   f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
                   f"WITH (location = '{path}')")
    entries = [dict(qe.catalog.kv.range("__file_engine/")) for qe in pair]
    assert entries[1].keys() == entries[0].keys()
    for k in entries[0]:
        v0, v1 = entries[0][k], entries[1][k]
        assert (json.loads(v1) if v1.startswith("{") else v1) == \
            (json.loads(v0) if v0.startswith("{") else v0), k
    both(pair, "SELECT table_name, engine FROM information_schema.tables "
               "WHERE table_schema = 'public' ORDER BY table_name")
    both_err(pair, f"CREATE EXTERNAL TABLE e1 (host STRING, v DOUBLE, "
                   f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) "
                   f"WITH (location = '{path}')")
    both(pair, f"CREATE EXTERNAL TABLE IF NOT EXISTS e1 WITH "
               f"(location = '{path}')")
    both_err(pair, "CREATE EXTERNAL TABLE nl (host STRING, "
                   "ts TIMESTAMP(3) TIME INDEX)")


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_container_formats_refused_naming_a12_io(pair, tmp_path, fmt):
    """External tables over Parquet and ORC run on the port now (A12-io):
    the case keeps its id; over a file the JAX engine COPYs out, the
    declared and the inferred schema give the JAX engine's DESCRIBE and
    rows, and a missing file the JAX engine's error."""
    jq, tq = pair
    path = tmp_path / f"cpu.{fmt}"
    jq.execute_one(f"COPY cpu TO '{path}'")
    for name, sql in (
            ("p", f"CREATE EXTERNAL TABLE p (host STRING, usage DOUBLE, "
                  f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host)) WITH "
                  f"(location = '{path}')"),
            ("q", f"CREATE EXTERNAL TABLE q WITH (location = '{path}', "
                  f"format = '{fmt}')")):
        for qe in pair:
            qe.execute_one(sql)
        for q in (f"DESCRIBE {name}",
                  f"SELECT host, usage, ts FROM {name} ORDER BY ts",
                  f"SELECT host, max(usage), count(*) FROM {name} "
                  "GROUP BY host ORDER BY host"):
            assert tq.execute_one(q).rows() == jq.execute_one(q).rows(), q
    both_err(pair, f"CREATE EXTERNAL TABLE x WITH (location = "
                   f"'{tmp_path}/missing.{fmt}')")


@pytest.mark.parametrize("late", [None, "1.5", "", "nan", "x", "7", "+5"])
def test_csv_fast_path_matches_pyarrow(tmp_path, late):
    """Past the sample rows the numeric columns parse in C; a late value
    the sample did not foresee (a float in an int column, a NULL, a NaN
    spelling, a string) sends the file down the general path, and either
    way the columns are pyarrow's."""
    n = datasource._CSV_SAMPLE_ROWS + 600
    rng = np.random.default_rng(5)
    rows = [[f"h{i % 7}", i * 1000, repr(float(v)), int(v * 10)]
            for i, v in enumerate(rng.uniform(0, 100, n))]
    if late is not None:
        rows[-3][3] = late
        rows[-2][2] = late
    path = write_csv(str(tmp_path / "big.csv"), ["host", "ts", "f", "i"],
                     rows)
    jt, pt = jds.read_file(path), datasource.read_file(path)
    for f in jt.schema:
        col = pt.column(f.name)
        assert col.type == str(f.type), f.name
        assert col.to_pylist() == jt.column(f.name).to_pylist(), f.name


def test_inferred_table_parses_its_file_once(pair, tmp_path, monkeypatch):
    """CREATE's schema inference parses the file; the first scan coerces
    that parse instead of reading the file again, until its mtime
    changes."""
    path = write_ndjson(str(tmp_path / "once.ndjson"), ["host", "v", "ts"],
                        [["x", 1.0, 1000], ["y", 2.0, 2000]])
    calls = []
    read_file = datasource.read_file
    monkeypatch.setattr(datasource, "read_file",
                        lambda *a: calls.append(a) or read_file(*a))
    pair[1].execute_one(f"CREATE EXTERNAL TABLE once WITH "
                        f"(location = '{path}')")
    assert len(calls) == 1
    assert pair[1].execute_one("SELECT sum(v) FROM once").rows() == [[3.0]]
    assert pair[1].execute_one("SELECT count(*) FROM once").rows() == [[2]]
    assert len(calls) == 1
    write_ndjson(path, ["host", "v", "ts"], [["x", 5.0, 1000]])
    os.utime(path, ns=(10**18, 10**18))
    assert pair[1].execute_one("SELECT sum(v) FROM once").rows() == [[5.0]]
    assert len(calls) == 2
