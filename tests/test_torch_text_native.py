"""The text formats at native speed (ROADMAP C14): the native number text
(greptimedb_tpu_torch/native/src/text_format.cpp) against the Python
path byte for byte, whole CSV / ndjson outputs with and without the
native library and against pyarrow's writers, the quoted-CSV fast path
of the reader against the general path, and COPY TO / FROM CSV.gz and
ndjson through the port against the JAX engine's rows.
"""

from __future__ import annotations

import csv
import io
import json

import numpy as np
import pytest

from greptimedb_tpu_torch import datasource, native
from greptimedb_tpu_torch.datasource import TextColumn, TextTable
from greptimedb_tpu_torch.datasource import text_writer as tw

SEED = 23


@pytest.fixture(scope="module")
def lib():
    got = native.try_load()
    if got is None:
        pytest.fail("the native library did not build (g++ -std=c++17)")
    return got


def _corpus(dtype) -> np.ndarray:
    """~200 k values: random bit patterns, subnormals, +-0, NaN, +-inf,
    the style edges 1e-7 / 1e10 / 1e-4 / 1e16 and every decade with their
    neighbours on both sides, integers past 2^53."""
    rng = np.random.default_rng(SEED)
    uint = np.uint64 if dtype == np.float64 else np.uint32
    bits = np.iinfo(uint).bits
    rand = rng.integers(0, 2 ** bits, 150_000, dtype=np.uint64,
                        endpoint=False).astype(uint).view(dtype)
    mant = rng.integers(1, 2 ** (52 if bits == 64 else 23), 20_000,
                        dtype=np.uint64).astype(uint)
    sub = mant.view(dtype) * np.where(rng.random(20_000) < 0.5, -1, 1) \
        .astype(dtype)
    info = np.finfo(dtype)
    lo, hi = int(np.floor(np.log10(info.smallest_subnormal))), \
        int(np.ceil(np.log10(info.max)))
    with np.errstate(over="ignore"):
        decades = np.asarray([10.0 ** k for k in range(lo, hi)]) \
            .astype(dtype)
    edges = np.asarray([1e-7, 1e10, 1e-4, 1e16, 1e-5, 1e15, 1e9, 0.1,
                        100000.0, 123.0, 2.0 ** 53, 2.0 ** 53 + 2,
                        2.0 ** 60 + 2 ** 9, 2.0 ** 63, 9007199254740993.0,
                        1.5, 0.5, 1.0, 3.0e38, 1.17549435e-38])
    specials = np.asarray([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf],
                          dtype=dtype)
    base = np.concatenate([decades, edges.astype(dtype),
                           (rng.integers(2 ** 53, 2 ** 62, 2_000)
                            .astype(np.float64)).astype(dtype)])
    base = np.concatenate([base, np.nextafter(base, dtype(np.inf)),
                           np.nextafter(base, dtype(-np.inf))])
    base = np.concatenate([base, -base])
    scaled = (rng.integers(1, 10 ** 6, 20_000).astype(np.float64)
              * 10.0 ** rng.integers(-12, 20, 20_000)).astype(dtype)
    out = np.concatenate([rand, sub, base, specials, scaled])
    return out.astype(dtype)


def _native_texts(lib, values, style) -> list:
    buf, offs = lib.number_text(values, style)
    raw = buf.tobytes()
    return [raw[offs[i]:offs[i + 1]].decode() for i in range(len(values))]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("style", ["arrow", "repr"])
def test_native_float_text_matches_the_python_path(lib, dtype, style):
    vals = _corpus(dtype)
    assert len(vals) > 190_000
    assert np.isnan(vals).any() and np.isinf(vals).any()
    assert (np.abs(vals) < np.finfo(dtype).tiny).sum() > 10_000
    with np.errstate(invalid="ignore"):
        want = tw._float_texts(vals) if style == "arrow" \
            else tw._json_floats(vals)
    got = _native_texts(lib, vals, style)
    bad = [(i, vals[i], got[i], want[i]) for i in range(len(vals))
           if got[i] != want[i]]
    assert bad == [], bad[:10]


def test_native_int_text(lib):
    rng = np.random.default_rng(SEED)
    i64 = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 10_000,
                                       dtype=np.int64),
                          np.asarray([0, -1, 2 ** 63 - 1, -2 ** 63])])
    u64 = np.concatenate([rng.integers(0, 2 ** 64 - 1, 10_000,
                                       dtype=np.uint64),
                          np.asarray([0, 2 ** 64 - 1], dtype=np.uint64)])
    for vals in (i64, u64):
        assert _native_texts(lib, vals, "int") == list(map(str,
                                                          vals.tolist()))


# ---- whole outputs ----------------------------------------------------------


def _mixed_table(n: int) -> TextTable:
    """Every column kind the writers take, NULLs in each that may hold
    one, strings with quotes, commas, newlines and non-ASCII text."""
    rng = np.random.default_rng(SEED)
    cols = {}
    words = np.asarray(['a"b', "c,d", "é ü", "x\ny", "", "plain"],
                       dtype=object)
    cols["tag"] = TextColumn.of_codes(
        np.where(rng.random(n) < 0.1, -1, rng.integers(0, len(words), n)),
        words)
    cols["s"] = TextColumn(np.asarray(
        [None if i % 7 == 0 else f"s{i}\"q,{i % 3}" for i in range(n)],
        dtype=object), None, "string")
    cols["d"] = TextColumn(rng.normal(size=n) * 10.0 ** rng.integers(
        -9, 18, n), rng.random(n) > 0.1, "double")
    cols["f"] = TextColumn((rng.normal(size=n) * 10.0 ** rng.integers(
        -9, 12, n)).astype(np.float32), None, "float")
    cols["i"] = TextColumn(rng.integers(-2 ** 62, 2 ** 62, n),
                           rng.random(n) > 0.2, "int64")
    cols["u"] = TextColumn(rng.integers(0, 2 ** 63, n).astype(np.uint64)
                           * np.uint64(2), None, "uint64")
    cols["i16"] = TextColumn(rng.integers(-300, 300, n).astype(np.int16),
                             None, "int16")
    cols["b"] = TextColumn(rng.random(n) > 0.5, rng.random(n) > 0.3, "bool")
    cols["nothing"] = TextColumn(np.zeros(n, dtype=np.int64),
                                 np.zeros(n, dtype=bool), "null")
    for unit, per in (("timestamp[s]", 1), ("timestamp[ms]", 1000),
                      ("timestamp[us]", 10 ** 6),
                      ("timestamp[ns]", 10 ** 9)):
        v = 1_600_000_000 * per + rng.integers(0, 10 * per, n) \
            * rng.integers(0, 2, n)
        cols[unit] = TextColumn(v, rng.random(n) > 0.1, unit)
    cols["day"] = TextColumn(rng.integers(-1000, 30000, n).astype(np.int32),
                             None, "date32")
    return TextTable(list(cols), cols, n)


def _tsbs_hour(hosts: int) -> TextTable:
    """TSBS cpu's hour as COPY writes it: hostname (dictionary), ts in
    ms, ten DOUBLE fields of float32 values (the card's f32 columns)."""
    rng = np.random.default_rng(SEED)
    points = 360
    cols = {"hostname": TextColumn.of_codes(
        np.tile(np.arange(hosts), points),
        np.asarray([f"host_{i}" for i in range(hosts)], dtype=object)),
        "ts": TextColumn(np.repeat(1_456_790_400_000 + np.arange(points)
                                   * 10_000, hosts), None, "timestamp[ms]")}
    for k in range(10):
        cols[f"usage_{k}"] = TextColumn(
            rng.uniform(0, 100, hosts * points).astype(np.float32)
            .astype(np.float64), None, "double")
    return TextTable(list(cols), cols, hosts * points)


@pytest.mark.parametrize("table", ["mixed", "tsbs_hour", "empty"])
def test_whole_outputs_with_and_without_the_native_library(lib, table,
                                                           monkeypatch):
    t = {"mixed": lambda: _mixed_table(3000),
         "tsbs_hour": lambda: _tsbs_hour(400),
         "empty": lambda: TextTable(["a", "b"], {
             "a": TextColumn(np.zeros(0), None, "double"),
             "b": TextColumn(np.zeros(0, dtype=np.int64), None, "int64")},
             0)}[table]()
    native_out = (tw.csv_bytes(t), tw.ndjson_bytes(t))
    monkeypatch.setattr(native, "try_load", lambda: None)
    python_out = (tw.csv_bytes(t), tw.ndjson_bytes(t))
    assert native_out[0] == python_out[0]
    assert native_out[1] == python_out[1]
    assert native_out == (tw._csv_bytes_python(t), tw._ndjson_bytes_python(t))


def _arrow_table(t: TextTable):
    pa = pytest.importorskip("pyarrow")
    arrays = []
    for name in t.names:
        col = t.column(name)
        valid = np.ones(len(col), dtype=bool) if col.valid is None \
            else col.valid
        if col.dictionary is not None or col.type == "string":
            arr = pa.array(col.strings().tolist(), type=pa.string())
        elif col.type == "null":
            arr = pa.nulls(len(col))
        else:
            ty = {"double": pa.float64(), "float": pa.float32(),
                  "int64": pa.int64(), "uint64": pa.uint64(),
                  "int16": pa.int16(), "bool": pa.bool_(),
                  "date32": pa.date32()}.get(col.type)
            if ty is None:
                ty = pa.timestamp(col.type[len("timestamp["):-1])
            arr = pa.array(col.values, type=ty, mask=~valid)
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, names=list(t.names))


def test_whole_outputs_match_pyarrow(lib):
    """The JAX writers' bytes: pyarrow.csv.write_csv, and json.dumps of
    to_pylist() rows (default=str)."""
    pacsv = pytest.importorskip("pyarrow.csv")
    t = _mixed_table(2000)
    at = _arrow_table(t)
    buf = io.BytesIO()
    pacsv.write_csv(at, buf)
    assert tw.csv_bytes(t) == buf.getvalue()
    cols = {f.name: at.column(f.name).to_pylist() for f in at.schema}
    lines = [json.dumps({k: v[i] for k, v in cols.items()}, default=str)
             for i in range(at.num_rows)]
    assert tw.ndjson_bytes(t) == ("\n".join(lines) + "\n").encode()


def test_parallel_gzip_members_read_as_one_file(tmp_path):
    """Text past one member's size is gzipped a slice a thread into
    members laid end to end: Python's gzip and pyarrow read the file as
    the whole text."""
    import gzip

    text = "a,b\n" + "".join(f"host_{i},{i * 0.25}\n"
                             for i in range(1_200_000))
    data = text.encode()
    assert len(data) > 1.5 * datasource._GZIP_MEMBER_BYTES
    z = datasource._gzip(data)
    assert z.count(b"\x1f\x8b\x08") >= 2
    assert gzip.decompress(z) == data
    pacsv = pytest.importorskip("pyarrow.csv")
    path = tmp_path / "t.csv.gz"
    path.write_bytes(z)
    assert pacsv.read_csv(str(path)).num_rows == 1_200_000
    small = datasource._gzip(b"x,y\n")
    assert small.count(b"\x1f\x8b\x08") == 1
    assert gzip.decompress(small) == b"x,y\n"


# ---- the quoted-CSV fast path -----------------------------------------------


def _same_table(a: TextTable, b: TextTable) -> None:
    assert a.names == b.names and a.num_rows == b.num_rows
    for name in a.names:
        x, y = a.column(name), b.column(name)
        assert x.type == y.type, name
        assert (x.valid is None) == (y.valid is None), name
        if x.valid is not None:
            assert np.array_equal(x.valid, y.valid), name
        if x.values.dtype.kind == "f":
            assert np.array_equal(x.values, y.values, equal_nan=True), name
        else:
            assert x.values.tolist() == y.values.tolist(), name
        assert (x.dictionary is None) == (y.dictionary is None), name


def _csv_text(rows: list, header=("host", "v", "n", "ts", "note")) -> str:
    out = io.StringIO()
    w = csv.writer(out, quoting=csv.QUOTE_NONNUMERIC, lineterminator="\n")
    w.writerow(header)
    w.writerows(rows)
    return out.getvalue()


def _rows(n: int, note) -> list:
    rng = np.random.default_rng(SEED)
    return [[f"host_{i % 50}", float(rng.normal()), int(i),
             f"2024-01-0{1 + i % 9} 00:00:{i % 60:02d}", note(i)]
            for i in range(n)]


QUOTED = {
    "plain": lambda i: f"n{i}",
    "empty": lambda i: "" if i % 3 else f"n{i}",
    "doubled_quote": lambda i: 'say "hi"' if i == 4500 else f"n{i}",
    "comma": lambda i: "a,b" if i == 4999 else f"n{i}",
    "newline": lambda i: "a\nb" if i == 10 else f"n{i}",
    "carriage_return": lambda i: "a\rb" if i % 100 == 0 else f"n{i}",
    "quote_in_sample": lambda i: 'x"' if i == 3 else f"n{i}",
}


@pytest.mark.parametrize("case", list(QUOTED))
def test_quoted_csv_fast_path_gives_the_general_path(case, monkeypatch):
    text = _csv_text(_rows(6000, QUOTED[case]))
    taken = []
    real_fast = datasource._read_csv_fast

    def spy(*a, **kw):
        got = real_fast(*a, **kw)
        taken.append(got is not None)
        return got

    monkeypatch.setattr(datasource, "_read_csv_fast", spy)
    fast = datasource._read_csv(text)
    monkeypatch.setattr(datasource, "_read_csv_fast", lambda *a, **kw: None)
    general = datasource._read_csv(text)
    _same_table(fast, general)
    # a quoted "", ",", line break or carriage return takes the general
    # path (loadtxt ends a line at "\r")
    assert taken == [case in ("plain", "empty")]
    assert fast.column("v").type == "double"
    assert fast.column("n").type == "int64"
    pacsv = pytest.importorskip("pyarrow.csv")
    want = pacsv.read_csv(io.BytesIO(text.encode()))
    assert fast.column("note").strings().tolist() == \
        want.column("note").to_pylist()
    assert fast.column("v").values.tolist() == want.column("v").to_pylist()


def test_the_port_writers_csv_reads_back_through_the_fast_path(lib,
                                                               monkeypatch):
    t = _tsbs_hour(20)
    text = tw.csv_bytes(t).decode()
    assert text.count('"') >= 2 * t.num_rows  # every hostname quoted
    taken = []
    real_fast = datasource._read_csv_fast
    monkeypatch.setattr(datasource, "_read_csv_fast", lambda *a, **kw: (
        taken.append(1), real_fast(*a, **kw))[1])
    back = datasource._read_csv(text)
    assert taken == [1]
    assert back.column("hostname").strings().tolist() == \
        t.column("hostname").strings().tolist()
    for k in range(10):
        assert np.array_equal(back.column(f"usage_{k}").values,
                              t.column(f"usage_{k}").values)


# ---- the regular-ndjson fast path -------------------------------------------


NDJSON_CASES = {
    # the JAX writer's spacing, every value kind the scan takes
    "writer": lambda i: json.dumps({
        "h": f"host_{i % 7}", "ts": f"2024-01-02 03:04:{i % 60:02d}",
        "v": [1.5, -0.0, 1e300, 2.5e-320, float("nan"), float("inf"),
              -float("inf"), None][i % 8] if i % 3 else i * 0.25,
        "n": None if i % 11 == 0 else i - 500, "b": bool(i % 2),
        "mix": i if i % 2 else i / 3, "none": None}),
    "compact": lambda i: json.dumps({"a": i, "b": f"x{i}", "c": i * 0.5},
                                    separators=(",", ":")),
    "big_int_falls_back": lambda i: json.dumps(
        {"a": 2 ** 64 if i == 4000 else i}),
    "escape_falls_back": lambda i: json.dumps(
        {"a": 'q"uote' if i == 4000 else "plain", "b": 1}),
    "raw_utf8": lambda i: json.dumps(
        {"a": "é" if i == 3 else "e", "b": 1}, ensure_ascii=False),
    "key_order_falls_back": lambda i: json.dumps(
        {"a": 1, "b": 2} if i != 4000 else {"b": 2, "a": 1}),
    "mixed_kinds_fall_back": lambda i: json.dumps(
        {"a": "s" if i == 4000 else 1}),
    "bool_and_int_fall_back": lambda i: json.dumps(
        {"a": True if i == 10 else 1}),
    "nested_falls_back": lambda i: json.dumps({"a": {"x": i}}),
    "leading_zero_falls_back": lambda i: json.dumps({"a": 1}) if i != 5
    else '{"a": 01}',
}


@pytest.mark.parametrize("case", list(NDJSON_CASES))
def test_ndjson_fast_path_gives_the_general_path(lib, case, monkeypatch):
    """A regular ndjson body scans natively (native.ndjson_columns) into
    the general path's columns; a body the scan does not take (an int
    past int64, an escape, a key order, a kind mix, a nested value, an
    invalid number) takes the general path, which answers or raises as
    before."""
    text = "\n".join(NDJSON_CASES[case](i) for i in range(5000)) + "\n"
    taken = []
    real_fast = datasource._read_ndjson_fast

    def spy(body):
        got = real_fast(body)
        taken.append(got is not None)
        return got

    def read():
        try:
            return datasource._read_ndjson(text)
        except datasource.DataSourceError as e:
            return type(e).__name__, str(e)

    monkeypatch.setattr(datasource, "_read_ndjson_fast", spy)
    fast = read()
    monkeypatch.setattr(datasource, "_read_ndjson_fast", lambda body: None)
    general = read()
    assert taken == [case in ("writer", "compact", "raw_utf8")]
    if isinstance(general, tuple):
        assert fast == general
    else:
        _same_table(fast, general)
        for name in general.names:
            assert fast.column(name).values.dtype == \
                general.column(name).values.dtype


def test_the_port_writers_ndjson_reads_back_through_the_fast_path(
        lib, monkeypatch):
    t = _tsbs_hour(20)
    text = tw.ndjson_bytes(t).decode()
    taken = []
    real_fast = datasource._read_ndjson_fast
    monkeypatch.setattr(datasource, "_read_ndjson_fast", lambda b: (
        taken.append(1), real_fast(b))[1])
    back = datasource._read_ndjson(text)
    assert taken == [1] and back.num_rows == t.num_rows
    for k in range(10):
        assert np.array_equal(back.column(f"usage_{k}").values,
                              t.column(f"usage_{k}").values)


# ---- COPY round trips against the JAX engine --------------------------------


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


DDL = ("CREATE TABLE {} (hostname STRING, note STRING, usage_user DOUBLE, "
       "usage_idle DOUBLE, ts TIMESTAMP(3) TIME INDEX, "
       "PRIMARY KEY (hostname)) WITH (append_mode = 'true')")


@pytest.mark.parametrize("ext", ["csv.gz", "ndjson"])
@pytest.mark.parametrize("notes", ["plain", "specials"])
def test_copy_round_trip_gives_the_jax_rows(tmp_path, ext, notes):
    """COPY TO then COPY FROM in each engine (its own file), 5,000 rows:
    past the reader's 4,096-row sample, so a plain CSV takes the quoted
    fast path and one with quotes, commas and line breaks in a string the
    general path; both give the JAX engine's rows."""
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    rng = np.random.default_rng(SEED)
    n = 5000
    special = ['q"uote', "com,ma", "line\nbreak", "", None]
    values = []
    for i in range(n):
        note = special[i % 5] if notes == "specials" else f"n{i % 17}"
        note = "NULL" if note is None else "'" + note + "'"
        values.append(f"('host_{i % 100}', {note}, "
                      f"{float(np.float32(rng.uniform(0, 100)))!r}, "
                      f"{float(rng.normal()) * 1e-6!r}, "
                      f"{1_456_790_400_000 + (i // 100) * 10_000})")
    insert = "INSERT INTO {} VALUES " + ", ".join(values)
    je = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                               maintenance_workers=0))
    te = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"),
                                   maintenance_workers=0), device="cpu")
    engines = [JQueryEngine(JCatalog(JMemoryKv()), je),
               QueryEngine(Catalog(MemoryKv()), te, device="cpu")]
    try:
        rows = []
        for who, qe in zip(("jax", "port"), engines):
            path = str(tmp_path / f"{who}.{ext}")
            qe.execute_one(DDL.format("cpu"))
            qe.execute_one(insert.format("cpu"))
            assert qe.execute_one(f"COPY cpu TO '{path}'") \
                .affected_rows == n
            qe.execute_one(DDL.format("back"))
            assert qe.execute_one(f"COPY back FROM '{path}'") \
                .affected_rows == n
            rows.append(qe.execute_one(
                "SELECT hostname, note, usage_user, usage_idle, ts FROM "
                "back ORDER BY ts, hostname").rows())
        want = [[v.item() if hasattr(v, "item") else v for v in r]
                for r in rows[0]]
        got = [[v.item() if hasattr(v, "item") else v for v in r]
               for r in rows[1]]
        assert got == want and len(got) == n
    finally:
        je.close()
        te.close()
