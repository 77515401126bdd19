"""The port's Arrow IPC stream format (greptimedb_tpu_torch/datasource/
arrow_ipc.py, over utils/flatbuf.py) held to pyarrow's on the CPU:
streams pyarrow writes read back equal, and streams the port writes are
read by `pa.ipc.open_stream` as equal, for every type the port carries,
with NULLs, empty tables, several batches, dictionaries (replaced ones
too) and schema metadata, over a few seeds. A compressed body and a type
outside the list are refused with a typed error."""

import numpy as np
import pyarrow as pa
import pytest

from greptimedb_tpu_torch.datasource import TextColumn, TextTable, arrow_ipc
from greptimedb_tpu_torch.datasource.arrow_ipc import IpcError
from greptimedb_tpu_torch.utils import flatbuf

SEEDS = (3, 17, 2024)


def _random_table(seed: int, n: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.2
    words = np.asarray(["", "a", "bb", "héllo", "日本", "x" * 40],
                       dtype=object)
    ints = {f"i{b}": pa.array(rng.integers(-100, 100, n).astype(f"int{b}"),
                              mask=mask) for b in (8, 16, 32, 64)}
    uints = {f"u{b}": pa.array(rng.integers(0, 200, n).astype(f"uint{b}"),
                               mask=mask) for b in (8, 16, 32, 64)}
    strs = words[rng.integers(0, len(words), n)]
    codes = rng.integers(0, 4, n).astype(np.int32)
    cols = {
        "b": pa.array(rng.random(n) < 0.5, mask=mask),
        **ints, **uints,
        "f": pa.array(rng.random(n).astype(np.float32), mask=mask),
        "d": pa.array(np.where(rng.random(n) < 0.1, np.nan,
                               rng.normal(size=n)), mask=mask),
        "s": pa.array([None if m else v for v, m in zip(strs, mask)],
                      type=pa.string()),
        "ls": pa.array(list(strs), type=pa.large_string()),
        "bin": pa.array([v.encode() for v in strs], type=pa.binary()),
        "ts": pa.array(rng.integers(0, 10**12, n), type=pa.timestamp("ms"),
                       mask=mask),
        "tsz": pa.array(rng.integers(0, 10**15, n),
                        type=pa.timestamp("us", tz="UTC")),
        "tss": pa.array(rng.integers(0, 10**9, n), type=pa.timestamp("s")),
        "tsn": pa.array(rng.integers(0, 10**18, n), type=pa.timestamp("ns")),
        "dt": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                       type=pa.date32()),
        "nul": pa.nulls(n),
        "tag": pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=mask), pa.array(["h0", "h1", "h2", "h3"])),
    }
    return pa.table(cols).replace_schema_metadata(
        {b"schema": b'{"columns": []}', b"needs_dedup": b"1",
         b"k\xc3\xa9": b"v"})


def _pyarrow_stream(t: pa.Table, chunk: int) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t, max_chunksize=chunk)
    return sink.getvalue().to_pybytes()


#: the port's type name of each pyarrow type in `_random_table`
TYPE_NAMES = {"tag": "string", "f": "float", "d": "double", "b": "bool",
              "s": "string", "ls": "large_string", "bin": "binary",
              "ts": "timestamp[ms]", "tsz": "timestamp[us, tz=UTC]",
              "tss": "timestamp[s]", "tsn": "timestamp[ns]", "dt": "date32",
              "nul": "null"}


def _values(col: TextColumn) -> list:
    """A column's values, None for NULL, times as their integer units."""
    if col.dictionary is not None or col.type in ("null", "string",
                                                  "large_string", "binary"):
        return col.to_pylist()
    vals = col.values.tolist()
    if col.valid is None:
        return vals
    return [v if ok else None for v, ok in zip(vals, col.valid.tolist())]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,chunk", [(0, 8), (1, 8), (37, 8), (200, 1000)])
def test_pyarrow_stream_reads_back_and_round_trips(seed, n, chunk):
    want = _random_table(seed, n)
    t = arrow_ipc.read_stream(_pyarrow_stream(want, chunk))
    assert t.num_rows == n and t.names == want.column_names
    assert t.metadata == want.schema.metadata
    if n:
        assert list(t.column("tag").dictionary) == ["h0", "h1", "h2", "h3"]
    for name in want.column_names:
        col, w = t.column(name), want.column(name)
        assert col.type == TYPE_NAMES.get(name, name.replace(
            "i", "int").replace("u", "uint")), name
        if pa.types.is_timestamp(w.type) or pa.types.is_date32(w.type):
            w = w.cast(pa.int32() if pa.types.is_date32(w.type)
                       else pa.int64())
        got, expect = _values(col), w.to_pylist()
        if pa.types.is_floating(w.type):
            np.testing.assert_array_equal(
                np.asarray([np.nan if v is None else v for v in got], float),
                np.asarray([np.nan if v is None else v for v in expect],
                           float))
        else:
            assert got == expect, name
    back = pa.ipc.open_stream(arrow_ipc.write_stream(t, batch_rows=16)) \
        .read_all()
    assert back.schema.equals(want.schema, check_metadata=True)
    for name in want.column_names:  # NaN equal to NaN, unlike .equals
        assert _no_nan(back.column(name).to_pylist()) == \
            _no_nan(want.column(name).to_pylist()), name


def _no_nan(vals: list) -> list:
    return ["nan" if isinstance(v, float) and v != v else v for v in vals]


@pytest.mark.parametrize("seed", SEEDS)
def test_port_written_stream_reads_in_pyarrow(seed):
    rng = np.random.default_rng(seed)
    n = 50
    valid = rng.random(n) > 0.3
    codes = np.where(valid, rng.integers(0, 3, n), -1).astype(np.int32)
    table = TextTable(
        ["tag", "v", "n", "s", "ts", "ok"],
        {"tag": TextColumn.of_codes(codes, np.asarray(["x", "y", "z"],
                                                      dtype=object)),
         "v": TextColumn(rng.normal(size=n), None, "double"),
         "n": TextColumn(rng.integers(-5, 5, n), valid, "int64"),
         "s": TextColumn(np.asarray([str(i) for i in range(n)],
                                    dtype=object), valid, "string"),
         "ts": TextColumn(np.arange(n, dtype=np.int64) * 1000, None,
                          "timestamp[ms]"),
         "ok": TextColumn(rng.random(n) < 0.5, None, "bool")},
        n, {b"region_id": b"42"})
    got = pa.ipc.open_stream(arrow_ipc.write_stream(table, batch_rows=7)) \
        .read_all()
    assert got.schema.metadata == {b"region_id": b"42"}
    assert got.schema.field("tag").type == pa.dictionary(pa.int32(),
                                                         pa.string())
    assert got.column("tag").to_pylist() == table.column("tag").to_pylist()
    assert got.column("n").to_pylist() == table.column("n").to_pylist()
    assert got.column("s").to_pylist() == table.column("s").to_pylist()
    np.testing.assert_array_equal(got.column("v").to_numpy(),
                                  table.column("v").values)
    assert got.column("ts").type == pa.timestamp("ms")
    assert got.column("ok").to_pylist() == list(table.column("ok").values)
    # empty: one batch of 0 rows, the schema intact
    empty = TextTable(["v"], {"v": TextColumn(np.zeros(0), None, "double")},
                      0)
    got = pa.ipc.open_stream(arrow_ipc.write_stream(empty)).read_all()
    assert got.num_rows == 0 and got.schema.field("v").type == pa.float64()


def test_replaced_dictionaries_merge():
    """A stream whose batches carry different dictionaries (pyarrow sends
    a replacement before each) reads back as one dictionary."""
    a = pa.DictionaryArray.from_arrays(pa.array([0, 1, 0], pa.int32()),
                                       pa.array(["p", "q"]))
    b = pa.DictionaryArray.from_arrays(pa.array([1, None], pa.int32()),
                                       pa.array(["r", "p"]))
    schema = pa.schema([("t", a.type)])
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, schema) as w:
        w.write_batch(pa.record_batch([a], schema=schema))
        w.write_batch(pa.record_batch([b], schema=schema))
    t = arrow_ipc.read_stream(sink.getvalue().to_pybytes())
    assert t.column("t").to_pylist() == ["p", "q", "p", "p", None]


def test_refusals_are_typed():
    t = pa.table({"v": pa.array(np.arange(1000, dtype=np.float64))})
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema, options=pa.ipc.IpcWriteOptions(
            compression="zstd")) as w:
        w.write_table(t)
    with pytest.raises(IpcError, match="compressed"):
        arrow_ipc.read_stream(sink.getvalue().to_pybytes())
    import decimal

    for arr in (pa.array([[1, 2]]),
                pa.array([decimal.Decimal("1.5")], type=pa.decimal128(5, 2)),
                pa.array(np.ones(1, np.float16), type=pa.float16()),
                pa.array([1], type=pa.date64())):
        raw = _pyarrow_stream(pa.table({"c": arr}), 8)
        with pytest.raises(IpcError):
            arrow_ipc.read_stream(raw)
    with pytest.raises(IpcError):
        arrow_ipc.read_stream(b"\xff\xff\xff\xff\x10\x00\x00\x00"
                              + b"\x01" * 8)
    with pytest.raises(IpcError, match="no Arrow IPC type"):
        arrow_ipc.write_stream(TextTable(["c"], {"c": TextColumn(
            np.zeros(1, dtype=object), None, "python")}, 1))


def test_flatbuffer_reader_refuses_out_of_range_offsets():
    b = flatbuf.Builder()
    s = b.string("abc")
    root = b.table([(0, "ref", s), (1, "i64", 7), (2, "bool", True)])
    buf = b.finish(root)
    t = flatbuf.Table.root(buf)
    assert t.string(0) == b"abc" and t.scalar(1, "i64") == 7
    assert t.scalar(2, "bool") is True and t.scalar(5, "i32", -1) == -1
    with pytest.raises(flatbuf.FlatbufError):
        flatbuf.Table.root(buf[:6])
    bad = bytearray(buf)
    bad[0:4] = (len(buf) + 100).to_bytes(4, "little")
    with pytest.raises(flatbuf.FlatbufError):
        flatbuf.Table.root(bytes(bad))
