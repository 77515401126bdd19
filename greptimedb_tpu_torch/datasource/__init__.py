"""External file formats (counterpart of greptimedb_tpu/datasource/__init__.py,
which reads and writes every format through pyarrow; the port has no
pyarrow, so each is written here by hand with numpy): CSV and ndjson
(this module and `text_writer.py`), Parquet (`parquet.py`, over the
Thrift compact protocol of `thrift.py`) and ORC (`orc.py`). They back
COPY TO / FROM (`convert.py`: `result_to_table`, `insert_table`) and the
file engine.

`read_file` returns a `TextTable` (the port's column table, the JAX
package's `pa.Table`): column names, numpy columns, a validity mask
where a column holds NULLs, and each column's type under pyarrow's names
(bool, int8..int64, uint8..uint64, float, double, string, binary,
timestamp[s|ms|us|ns], date32, null), so the file engine infers the
schema the JAX engine infers for the same file. A string column may be
dictionary-encoded (`dictionary` set, `values` int32 codes, -1 NULL):
the Parquet and ORC readers and `result_to_table` keep tags and strings
that way, so a COPY of millions of rows stays columnar.

- CSV (pyarrow.csv's defaults): the header names the columns, empty
  lines are skipped; pyarrow's
  NULL spellings ("", "NULL", "NaN", "N/A", ...) are NULL outside
  string columns; a column is the first of int64, bool, date32,
  timestamp[s], timestamp[ns], double, string that holds every value,
  with pyarrow's value grammars: int64 is `-?digits` within int64 or
  `0x` and 1-16 hex digits (no sign, wrapped as uint64); double is
  `[+-]digits[.digits][e[+-]digits]` or inf / infinity / nan in any
  case; both, and date32, allow spaces and tabs around the value. A
  date is `YYYY-MM-DD` of a real calendar day; a timestamp is a date,
  optionally `T` or " " and `HH[:MM[:SS]]` (23:59:59 at most), a
  fraction of 1-9 digits for timestamp[ns] only, then optionally "Z"
  or `+-HH[[:]MM]`; zoned and naive values do not share a column. An
  int past int64 makes the column double; a date or time that is no
  real one makes it string. All-NULL is `null`.
- ndjson (pyarrow.json's): keys in order of first appearance; JSON
  ints are int64, double once one is past int64 or a float is among
  them; bools bool; strings are timestamp[s] when every one is a date
  or date-time of the CSV grammar without a fraction (zoned values
  convert to UTC), else string; null everywhere is `null`. Objects and
  arrays (pyarrow's struct and list) have no port type and raise
  `NestedJsonColumn`; a key whose values mix kinds is refused, as
  pyarrow refuses it.

Each reader has a fast path that gives exactly its general path's
table: a CSV past a 4,096-row sample parses its numeric columns with
`numpy.loadtxt` (quoted files too, while no field holds a `"` inside
its quotes), and a regular ndjson body (every line the first line's
keys in its order, no escapes) is one native scan
(`native.ndjson_columns`).

`.gz` text files are gunzipped on reading and gzipped on writing (as
parallel gzip members past 16 MiB); Parquet and ORC are containers with
their own codecs. `write_file` writes CSV bytes equal to
`pyarrow.csv.write_csv`'s and ndjson bytes equal to the JAX writer's
(`json.dumps` of each row's Python values).
"""

from __future__ import annotations

import csv
import datetime as dt
import gzip
import io
import json
import os
import re
from dataclasses import dataclass
from operator import itemgetter
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.datatypes.types import DataType

FORMATS = ("csv", "json", "parquet", "orc")

# pyarrow.csv.ConvertOptions' default null_values
_CSV_NULLS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"))
_CSV_TRUE = frozenset(("1", "True", "TRUE", "true"))
_CSV_FALSE = frozenset(("0", "False", "FALSE", "false"))
_BLANK = " \t"
_INT = re.compile(r"[ \t]*(-?[0-9]+|0[xX][0-9a-fA-F]{1,16})[ \t]*\Z")
_DOUBLE = re.compile(
    r"[ \t]*[+-]?(([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?"
    r"|(?i:inf|infinity|nan))[ \t]*\Z")
_DATE = re.compile(r"[ \t]*[0-9]{4}-(0[1-9]|1[0-2])-[0-9]{2}[ \t]*\Z")
#: date, then [T ]HH[:MM[:SS[.fraction]]], then Z or +-HH[[:]MM] (a
#: zone only after a time)
_TS = re.compile(
    r"(?P<naive>[0-9]{4}-(?:0[1-9]|1[0-2])-[0-9]{2}"
    r"(?:[T ](?P<time>(?:[01][0-9]|2[0-3])(?::[0-5][0-9](?::[0-5][0-9]"
    r"(?P<frac>\.[0-9]{1,9})?)?)?))?)"
    r"(?(time)(?P<zone>Z|[+-](?:[01][0-9]|2[0-3])(?::?[0-5][0-9])?)?)\Z")
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1

#: column type -> the DataType the JAX engine's DataType.from_arrow gives
TYPE_OF = {
    "bool": DataType.BOOL,
    "int8": DataType.INT8,
    "int16": DataType.INT16,
    "int32": DataType.INT32,
    "int64": DataType.INT64,
    "uint8": DataType.UINT8,
    "uint16": DataType.UINT16,
    "uint32": DataType.UINT32,
    "uint64": DataType.UINT64,
    "float": DataType.FLOAT32,
    "double": DataType.FLOAT64,
    "string": DataType.STRING,
    "binary": DataType.BINARY,
    "timestamp[s]": DataType.TIMESTAMP_SECOND,
    "timestamp[ms]": DataType.TIMESTAMP_MILLISECOND,
    "timestamp[us]": DataType.TIMESTAMP_MICROSECOND,
    "timestamp[ns]": DataType.TIMESTAMP_NANOSECOND,
    "date32": DataType.TIMESTAMP_MILLISECOND,
}
#: DataType -> its column type (the JAX `DataType.to_arrow`)
ARROW_NAME = {dt: name for name, dt in TYPE_OF.items() if name != "date32"}
#: nanoseconds a stored unit of each time type
_TIME_NS = {"timestamp[s]": 10**9, "timestamp[ms]": 10**6,
            "timestamp[us]": 10**3, "timestamp[ns]": 1,
            "date32": 86_400 * 10**9}
#: numpy dtype of each fixed-width column type
NUMPY_OF = {"bool": np.bool_, "int8": np.int8, "int16": np.int16,
            "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
            "uint16": np.uint16, "uint32": np.uint32, "uint64": np.uint64,
            "float": np.float32, "double": np.float64}


_TZ_SUFFIX = re.compile(r", tz=[^\]]*\]\Z")


def base_type(t: str) -> str:
    """A column type without what the port's DataTypes do not keep: a
    timestamp's time zone (its values are UTC already) and the 64-bit
    offsets of large_string / large_binary."""
    if t in ("large_string", "large_binary"):
        return t[len("large_"):]
    return _TZ_SUFFIX.sub("]", t)


class DataSourceError(Exception):
    pass


class NestedJsonColumn(DataSourceError):
    """An ndjson key whose values are objects or arrays (pyarrow's struct
    and list types): the port's tables have no nested column type."""


def infer_format(path: str, explicit: Optional[str] = None) -> str:
    """Format from the WITH (format=...) option or the file extension
    (reference file_format.rs `try_from` on extension)."""
    if explicit:
        f = explicit.lower()
        if f == "ndjson":
            f = "json"
        if f not in FORMATS:
            raise DataSourceError(f"unsupported format {explicit!r} "
                                  f"(supported: {', '.join(FORMATS)})")
        return f
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lstrip(".").lower()
    if ext in ("ndjson", "jsonl"):
        ext = "json"
    if ext in FORMATS:
        return ext
    raise DataSourceError(f"cannot infer format from {path!r}; "
                          "pass WITH (format = '...')")


@dataclass
class TextColumn:
    """One column: `values` (a fixed-width numpy array of the type, int64
    time units, object strings, or int32 codes into `dictionary`),
    `valid` (None when no NULL) and the type. A dictionary column's NULL
    is code -1 (and `valid` False there). Type "python" holds Python
    values as they are (COPY FROM's column defaults)."""

    values: np.ndarray
    valid: Optional[np.ndarray]
    type: str
    dictionary: Optional[np.ndarray] = None

    @staticmethod
    def of_codes(codes: np.ndarray, dictionary: np.ndarray,
                 type: str = "string") -> "TextColumn":
        codes = np.asarray(codes, dtype=np.int32)
        valid = codes >= 0
        return TextColumn(codes, None if valid.all() else valid, type,
                          np.asarray(dictionary, dtype=object))

    def __len__(self) -> int:
        return len(self.values)

    def strings(self) -> np.ndarray:
        """A string column's values as an object array, None for NULL."""
        if self.dictionary is not None:
            if not len(self.dictionary):
                return np.full(len(self.values), None, dtype=object)
            out = self.dictionary[np.maximum(self.values, 0)]
        else:
            out = np.asarray(self.values, dtype=object)
        if self.valid is not None:
            out = np.where(self.valid, out, None)
        return out

    def encoded(self) -> tuple[np.ndarray, np.ndarray]:
        """(int32 codes with -1 for NULL, dictionary) of a string column,
        encoding in first-seen order when it is not encoded yet."""
        if self.dictionary is not None:
            return self.values, self.dictionary
        seen: dict = {}
        vals = self.strings()
        codes = np.fromiter(
            (-1 if v is None else seen.setdefault(v, len(seen))
             for v in vals.tolist()), np.int32, len(vals))
        return codes, np.asarray(list(seen), dtype=object)

    def encoded_column(self) -> "TextColumn":
        """This string column dictionary-encoded."""
        if self.dictionary is not None:
            return self
        return TextColumn.of_codes(*self.encoded(), type=self.type)

    def to_pylist(self) -> list:
        """Python values as pyarrow's `to_pylist` gives them."""
        if self.type == "python":
            out = self.values.tolist()
            return out if self.valid is None else [
                v if ok else None for v, ok in zip(out, self.valid.tolist())]
        if self.dictionary is not None or self.type in ("string",
                                                        "binary"):
            return self.strings().tolist()
        if self.type.startswith("timestamp["):
            ns = _TIME_NS[self.type]
            epoch = dt.datetime(1970, 1, 1)
            out = [epoch + dt.timedelta(microseconds=int(v) * ns // 1000)
                   for v in self.values.tolist()]
        elif self.type == "date32":
            epoch = dt.date(1970, 1, 1)
            out = [epoch + dt.timedelta(days=int(v))
                   for v in self.values.tolist()]
        elif self.type == "null":
            return [None] * len(self.values)
        else:
            out = self.values.tolist()
        if self.valid is not None:
            out = [v if ok else None
                   for v, ok in zip(out, self.valid.tolist())]
        return out


@dataclass
class TextTable:
    names: list[str]
    columns: dict[str, TextColumn]
    num_rows: int
    #: the schema's key-value metadata (bytes to bytes), as an Arrow
    #: stream carries it (`datasource/arrow_ipc.py`)
    metadata: Optional[dict] = None

    def column(self, name: str) -> TextColumn:
        return self.columns[name]


def read_file(path: str, fmt: Optional[str] = None) -> TextTable:
    fmt = infer_format(path, fmt)
    if not os.path.exists(path):
        raise DataSourceError(f"file {path!r} not found")
    with open(path, "rb") as f:
        raw = f.read()
    if fmt == "parquet":
        from greptimedb_tpu_torch.datasource import parquet

        return parquet.read(raw)
    if fmt == "orc":
        from greptimedb_tpu_torch.datasource import orc

        return orc.read(raw)
    if path.endswith(".gz"):
        raw = gzip.decompress(raw)
    text = raw.decode("utf-8")
    if fmt == "csv":
        return _read_csv(text)
    return _read_ndjson(text)


def write_file(table: TextTable, path: str, fmt: Optional[str] = None) -> int:
    """Write a column table (`result_to_table`'s) as `fmt` (or the
    format the extension names); returns the rows written."""
    from greptimedb_tpu_torch.datasource import orc, parquet, text_writer

    fmt = infer_format(path, fmt)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    if fmt == "parquet":
        data = parquet.write(table)
    elif fmt == "orc":
        data = orc.write(table)
    else:
        data = text_writer.csv_bytes(table) if fmt == "csv" \
            else text_writer.ndjson_bytes(table)
        if path.endswith(".gz"):
            data = _gzip(data)
    with open(path, "wb") as f:
        f.write(data)
    return table.num_rows


#: bytes of text a gzip member holds when the writer compresses in parallel
_GZIP_MEMBER_BYTES = 16 << 20


def _gzip(data: bytes) -> bytes:
    """gzip of `data` at zlib's default level (the JAX writer's default is
    9; both decompress to the same text). Text past one member's size is
    compressed a slice a thread (zlib releases the GIL) into members laid
    end to end: a multi-member file decompresses to the concatenation
    (RFC 1952 2.2), as gzip, zcat, Python's gzip and pyarrow read it."""
    if len(data) <= _GZIP_MEMBER_BYTES:
        return gzip.compress(data, compresslevel=6)
    from concurrent.futures import ThreadPoolExecutor

    view = memoryview(data)
    parts = [view[i:i + _GZIP_MEMBER_BYTES]
             for i in range(0, len(data), _GZIP_MEMBER_BYTES)]
    with ThreadPoolExecutor(max_workers=min(len(parts),
                                            os.cpu_count() or 1),
                            thread_name_prefix="gtpu-gzip") as pool:
        members = list(pool.map(
            lambda part: gzip.compress(part, compresslevel=6), parts))
    return b"".join(members)


# ---- CSV ---------------------------------------------------------------------


#: rows the CSV reader infers from before it parses numeric columns in C
_CSV_SAMPLE_ROWS = 4096


def _read_csv(text: str) -> TextTable:
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    lines = [ln[:-1] if ln.endswith("\r") else ln for ln in lines]
    if not lines:
        raise DataSourceError("CSV file is empty (no header row)")
    quoted = '"' in text
    names = next(csv.reader(lines[:1])) if quoted else lines[0].split(",")
    body = lines[1:]
    if "" in body:
        # pyarrow skips empty lines (ignore_empty_lines)
        body = [ln for ln in body if ln]
    if len(body) > _CSV_SAMPLE_ROWS:
        fast = _read_csv_fast(names, body, "+" in text, quoted)
        if fast is not None:
            return fast
    if quoted:
        # csv.reader over the text itself, so a quoted field keeps its
        # line breaks (over the split lines it would lose them); empty
        # lines are skipped as above
        rows = [r for r in csv.reader(io.StringIO(text, newline="")) if r]
        names, rows = rows[0], rows[1:]
    else:
        rows = [ln.split(",") for ln in body]
    width = len(names)
    for i, r in enumerate(rows):
        if len(r) != width:
            raise DataSourceError(
                f"CSV parse error: expected {width} columns, got "
                f"{len(r)} in row {i + 1}")
    fields = list(zip(*rows)) if rows else [()] * width
    cols = {name: _csv_column(np.asarray(vals, dtype=object))
            for name, vals in zip(names, fields)}
    return TextTable(list(names), cols, len(rows))


def _read_csv_fast(names: list, body: list, has_plus: bool,
                   quoted: bool = False) -> Optional[TextTable]:
    """Columns a sample infers as int64 or double, with no NULL in it,
    parse in C (numpy.loadtxt) in one pass; the others as strings, then
    through `_csv_column`. None when the full parse disagrees with the
    sample (a NULL, a non-number, an int past its type, a NaN), and the
    caller takes the general path: the result is always the general
    path's. loadtxt reads "+5" as an int where pyarrow reads a double,
    so a file with a "+" anywhere (`has_plus`) and an int64 column takes
    the general path too.

    A `quoted` file takes this path while every field is either bare (no
    `"` in it) or one quoted run with no `"` inside (so no `""`, and a
    `,` or line break inside the quotes shows as a field that fails the
    test): the fields split on commas exactly as csv.reader splits them,
    and dropping the quotes gives csv.reader's values. The port's own
    writer quotes only strings, so its files stay here unless a string
    holds a `"`, `,` or line break."""
    import warnings

    sample = [ln.split(",") for ln in body[:_CSV_SAMPLE_ROWS]]
    if any(len(r) != len(names) for r in sample):
        return None
    kinds = []
    for c in zip(*sample):
        vals = np.asarray(c, dtype=object)
        if quoted:
            vals = _unquote(np.asarray(c, dtype=str))
            if vals is None:
                return None
        kinds.append(_csv_column(vals.astype(object)))
    numeric = [k for k, c in enumerate(kinds)
               if c.type in ("int64", "double") and c.valid is None]
    if has_plus and any(kinds[k].type == "int64" for k in numeric):
        return None
    others = [k for k in range(len(names)) if k not in numeric]
    cols: dict = {}
    try:
        with warnings.catch_warnings():
            # "1.5" in an int64 column: an error, not a truncation
            warnings.simplefilter("error")
            if numeric:
                nums = np.loadtxt(body, delimiter=",", usecols=numeric,
                                  dtype=[(f"c{k}", "i8" if kinds[k].type
                                          == "int64" else "f8")
                                         for k in numeric], ndmin=1,
                                  comments=None)
            if others:
                strs = np.loadtxt(body, delimiter=",", usecols=others,
                                  dtype=str, ndmin=2, comments=None)
            for j, k in enumerate(others):
                vals = strs[:, j]
                if quoted:
                    vals = _unquote(vals)
                    if vals is None:
                        return None
                cols[names[k]] = _csv_column(vals.astype(object))
    except (ValueError, DeprecationWarning):
        return None
    for k in numeric:
        arr = np.ascontiguousarray(nums[f"c{k}"])
        if arr.dtype.kind == "f" and np.isnan(arr).any():
            return None  # a NULL spelling parsed as NaN
        cols[names[k]] = TextColumn(arr, None, kinds[k].type)
    return TextTable(list(names), {n: cols[n] for n in names}, len(body))


def _unquote(fields: np.ndarray) -> Optional[np.ndarray]:
    """csv.reader's values of comma-split fields (a numpy str array) that
    are each bare (no `"`) or `"..."` with no `"` inside; None when one is
    neither (the general path then reads the file)."""
    quotes = np.char.count(fields, '"')
    if not quotes.any():
        return fields
    opened = np.char.startswith(fields, '"')
    simple = np.where(opened, (quotes == 2) & np.char.endswith(fields, '"')
                      & (np.char.str_len(fields) >= 2), quotes == 0)
    if not simple.all():
        return None
    return np.char.strip(fields, '"')


def _matches(rx, vals: np.ndarray) -> bool:
    """Every value matches `rx` (the first is tried alone first: most
    columns fail there)."""
    return bool(rx.match(vals[0])) and bool(
        np.frompyfunc(rx.match, 1, 1)(vals).astype(bool).all())


def _csv_column(raw: np.ndarray) -> TextColumn:
    n = len(raw)
    valid = ~np.frompyfunc(_CSV_NULLS.__contains__, 1, 1)(raw).astype(bool)
    vals = raw[valid]
    if not len(vals):
        return TextColumn(np.zeros(n, dtype=np.int64), valid, "null")

    def widen(arr, fill):
        out = np.full(n, fill, dtype=arr.dtype)
        out[valid] = arr
        return out

    mask = None if valid.all() else valid
    if _matches(_INT, vals):
        ints = _csv_ints(vals)
        if ints is not None:
            return TextColumn(widen(ints, 0), mask, "int64")
    bools = _CSV_TRUE | _CSV_FALSE
    if vals[0] in bools and bool(np.frompyfunc(bools.__contains__, 1, 1)(
            vals).astype(bool).all()):
        truth = np.frompyfunc(_CSV_TRUE.__contains__, 1, 1)(vals)
        return TextColumn(widen(truth.astype(bool), False), mask, "bool")
    if _matches(_DATE, vals):
        days = _to_datetime64(
            np.char.strip(vals.astype(str), _BLANK), "D")
        if days is not None:
            return TextColumn(widen(days, 0), mask, "date32")
    matches = _ts_matches(vals)
    for kind in ("timestamp[s]", "timestamp[ns]"):
        units = _timestamps(vals, kind, zones_mix=False, ms=matches)
        if units is not None:
            return TextColumn(widen(units, 0), mask, kind)
    if _matches(_DOUBLE, vals):
        floats = np.fromiter(map(float, vals), np.float64, len(vals))
        return TextColumn(widen(floats, np.nan), mask, "double")
    # a string column keeps every value: pyarrow's strings_can_be_null
    # is off, so its NULL spellings stay strings
    return TextColumn(raw, None, "string")


def _csv_int(v: str) -> int:
    v = v.strip(_BLANK)
    if v[1:2] in ("x", "X"):
        u = int(v[2:], 16)
        return u - (1 << 64) if u > _INT64_MAX else u
    return int(v)


def _csv_ints(vals: np.ndarray) -> Optional[np.ndarray]:
    """int64 values of strings that match `_INT`, or None when a decimal
    one is past int64 (pyarrow then reads the column as double)."""
    ints = list(map(_csv_int, vals))
    if min(ints) < _INT64_MIN or max(ints) > _INT64_MAX:
        return None
    return np.fromiter(ints, np.int64, len(ints))


def _to_datetime64(strs: np.ndarray, unit: str) -> Optional[np.ndarray]:
    """int64 units of ISO strings whose fields are in range, or None when
    one is no real calendar day (numpy refuses 2024-02-30)."""
    try:
        return strs.astype(f"datetime64[{unit}]").astype(np.int64)
    except ValueError:
        return None


def _ts_matches(vals: np.ndarray) -> Optional[list]:
    """`_TS`'s match of every value, or None when one does not match (the
    first is tried alone first: most columns fail there)."""
    if not _TS.match(vals[0]):
        return None
    ms = list(map(_TS.match, vals))
    return None if None in ms else ms


def _timestamps(vals: np.ndarray, kind: str, zones_mix: bool,
                ms: Optional[list] = None) -> Optional[np.ndarray]:
    """int64 seconds (timestamp[s]) or nanoseconds of values that all
    match `_TS` (no fraction for timestamp[s]), naive ones as UTC and
    zoned ones converted to UTC; None when one does not match, is no
    real date, or (unless `zones_mix`) zoned and naive values meet.
    `ms` is `_ts_matches(vals)` when the caller has it."""
    ms = _ts_matches(vals) if ms is None else ms
    if ms is None:
        return None
    if kind == "timestamp[s]" and any(m["frac"] for m in ms):
        return None
    zones = [m["zone"] for m in ms]
    zoned = sum(z is not None for z in zones)
    if not zones_mix and 0 < zoned < len(zones):
        return None
    unit = "s" if kind == "timestamp[s]" else "ns"
    naive = np.asarray([m["naive"] for m in ms]) if zoned else \
        vals.astype(str)
    out = _to_datetime64(naive, unit)
    if out is None or not zoned:
        return out
    per_s = 1 if unit == "s" else 10**9
    offsets = np.fromiter((_zone_seconds(z) for z in zones), np.int64,
                          len(zones))
    return out - offsets * per_s


def _zone_seconds(zone: Optional[str]) -> int:
    """Seconds east of UTC of "Z", "+HH", "+HHMM" or "+HH:MM" (0 for a
    naive value)."""
    if zone is None or zone == "Z":
        return 0
    digits = zone[1:].replace(":", "")
    secs = int(digits[:2]) * 3600 + int(digits[2:] or 0) * 60
    return -secs if zone[0] == "-" else secs


# ---- ndjson ------------------------------------------------------------------


def _read_ndjson(text: str) -> TextTable:
    body = text.strip()
    if body and "\r" not in body and "\n\n" not in body:
        fast = _read_ndjson_fast(body)
        if fast is not None:
            return fast
    if "\n\n" in body or "\r" in body:
        body = ",".join(ln for ln in body.split("\n") if ln.strip())
    else:
        body = body.replace("\n", ",")
    try:
        rows = json.loads("[" + body + "]")
    except json.JSONDecodeError as e:
        raise DataSourceError(f"JSON parse error: {e}") from None
    if not all(isinstance(r, dict) for r in rows):
        raise DataSourceError("JSON parse error: a line is not an object")
    first = rows[0].keys() if rows else {}.keys()
    if all(r.keys() == first for r in rows):
        # every line has the same keys: one C-level pass a column
        names = dict.fromkeys(first)
        cols = {name: _json_column(name, list(map(itemgetter(name), rows)))
                for name in names}
    else:
        names = {}
        for r in rows:
            names.update(dict.fromkeys(r))
        cols = {name: _json_column(name, [r.get(name) for r in rows])
                for name in names}
    return TextTable(list(names), cols, len(rows))


def _read_ndjson_fast(body: str) -> Optional[TextTable]:
    """A regular ndjson body (every line one object with the first line's
    keys in its order; numbers, strings without escapes, true, false,
    null, NaN, Infinity) through one native scan (native.ndjson_columns),
    each column as `_json_column` would type it: None when the native
    library is missing or the body leaves that shape, and the caller
    parses it with json. The result is always the general path's."""
    from greptimedb_tpu_torch import native

    lib = native.try_load()
    if lib is None:
        return None
    try:
        first = json.loads(body.partition("\n")[0])
    except json.JSONDecodeError:
        return None
    if not isinstance(first, dict) or not first \
            or not all(isinstance(k, str) for k in first):
        return None
    names = list(first)
    raw = body.encode()
    nrows = body.count("\n") + 1
    cells = lib.ndjson_columns(raw, names, nrows)
    if cells is None:
        return None
    cols = {}
    for name, kind, slot, length in zip(names, *cells):
        col = _json_cells_column(name, raw, kind, slot, length)
        if col is None:
            return None
        cols[name] = col
    return TextTable(names, cols, nrows)


def _json_cells_column(name: str, raw: bytes, kind: np.ndarray,
                       slot: np.ndarray, length: np.ndarray
                       ) -> Optional[TextColumn]:
    """`_json_column` of one column's native cells: numbers and bools
    typed here with numpy, strings handed to `_json_column` as the
    Python values; None for a mix `_json_column` refuses."""
    from greptimedb_tpu_torch import native

    seen = {k for k, c in enumerate(np.bincount(kind, minlength=5)) if c}
    nulls = kind == native.NDJSON_NULL
    valid = ~nulls if native.NDJSON_NULL in seen else None
    present = seen - {native.NDJSON_NULL}
    n = len(kind)
    if not present:
        return TextColumn(np.zeros(n, dtype=np.int64), valid, "null")
    if present == {native.NDJSON_BOOL}:
        return TextColumn(slot.astype(bool), valid, "bool")
    if present == {native.NDJSON_INT}:
        return TextColumn(np.where(nulls, 0, slot), valid, "int64")
    if present <= {native.NDJSON_INT, native.NDJSON_FLOAT}:
        vals = np.where(kind == native.NDJSON_FLOAT, slot.view(np.float64),
                        slot.astype(np.float64))
        return TextColumn(np.where(nulls, np.nan, vals), valid, "double")
    if present == {native.NDJSON_STR}:
        vals = [None if k == native.NDJSON_NULL else raw[o:o + m].decode()
                for k, o, m in zip(kind.tolist(), slot.tolist(),
                                   length.tolist())]
        return _json_column(name, vals)
    return None


def _json_column(name: str, vals: list) -> TextColumn:
    n = len(vals)
    nulls = vals.count(None)
    present = [v for v in vals if v is not None] if nulls else vals
    valid = np.asarray([v is not None for v in vals]) if nulls else None
    if not present:
        return TextColumn(np.zeros(n, dtype=np.int64), valid, "null")

    def widen(arr, fill):
        if valid is None:
            return arr
        out = np.full(n, fill, dtype=arr.dtype)
        out[valid] = arr
        return out

    kinds = set(map(type, present))
    if kinds == {bool}:
        return TextColumn(widen(np.asarray(present, dtype=bool), False),
                          valid, "bool")
    if kinds == {int} and _INT64_MIN <= min(present) \
            and max(present) <= _INT64_MAX:
        return TextColumn(widen(np.asarray(present, dtype=np.int64), 0),
                          valid, "int64")
    if kinds <= {int, float}:
        # an int past int64 makes the column double, as in pyarrow
        return TextColumn(widen(np.asarray(present, dtype=np.float64),
                                np.nan), valid, "double")
    if kinds == {str}:
        strs = np.asarray(present, dtype=object)
        secs = _timestamps(strs, "timestamp[s]", zones_mix=True)
        if secs is not None:
            return TextColumn(widen(secs, 0), valid, "timestamp[s]")
        return TextColumn(np.asarray(vals, dtype=object), valid, "string")
    for kind, arrow in ((dict, "struct"), (list, "list")):
        if kinds == {kind}:
            raise NestedJsonColumn(
                f"JSON column {name!r} holds {kind.__name__} values "
                f"(pyarrow's {arrow} type), which greptimedb_tpu_torch "
                "has no column type for")
    kind_names = sorted(k.__name__ for k in kinds)
    raise DataSourceError(
        f"JSON parse error: column {name!r} mixes {', '.join(kind_names)}")
