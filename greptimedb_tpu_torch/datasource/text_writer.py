"""The text writers behind `write_file` for CSV and ndjson (the JAX
package writes CSV through `pyarrow.csv.write_csv` and ndjson through
`json.dumps(row, default=str)` of `to_pylist()` values; the port builds
the same bytes column by column with numpy).

CSV, as pyarrow writes it: a header of quoted names; strings quoted
with `"` doubled inside; NULL empty; bools `true` / `false`; integers in
decimal; floats in their shortest round-trip digits, in positional form
when the decimal exponent is in [-7, 10) and as `d.ddde+XX` otherwise,
`nan` / `inf` / `-inf` / `-0`; timestamps `YYYY-MM-DD HH:MM:SS` with a
fraction of the unit's width (3, 6 or 9 digits). ndjson, as the JAX
writer writes it: `{"name": value, ...}` a line; floats as Python's repr
(of the double a float32 widens to), NaN / Infinity; timestamps as the
str() of the datetime pyarrow gives (`.ffffff` only when the
microseconds are not 0; nanosecond columns as pandas' Timestamp prints,
`.fffffffff` when the nanoseconds are not 0).

With the native library (`native.try_load()`), numbers are formatted in
C++ (`native.number_text`) and rows laid out from per-column texts
(`native.text_rows`): no Python object is made a numeric or time value,
only a string column's values (and a dictionary's entries) pass through
Python. Without it the Python path below writes the same bytes; the
tests hold one to the other.
"""

from __future__ import annotations

import json

import numpy as np

from greptimedb_tpu_torch import native

_UNIT_DIGITS = {"timestamp[s]": 0, "timestamp[ms]": 3,
                "timestamp[us]": 6, "timestamp[ns]": 9}
_NP_UNIT = {"timestamp[s]": "s", "timestamp[ms]": "ms",
            "timestamp[us]": "us", "timestamp[ns]": "ns"}


def _arrow_float(r: str) -> str:
    """pyarrow's CSV text of a float whose shortest round-trip text is
    `r` (Python repr form: digits, optional '.', optional e+-XX)."""
    if r in ("nan", "inf", "-inf"):
        return r
    sign = ""
    if r[0] == "-":
        sign, r = "-", r[1:]
    mant, _, exp = r.partition("e")
    ip, _, fp = mant.partition(".")
    raw = ip + fp
    digits = raw.lstrip("0")
    if not digits:
        return sign + "0"
    dp = len(ip) - (len(raw) - len(digits)) + (int(exp) if exp else 0)
    digits = digits.rstrip("0")
    n = len(digits)
    e10 = dp - 1
    if -7 < e10 < 10:
        if dp <= 0:
            out = "0." + "0" * (-dp) + digits
        elif dp >= n:
            out = digits + "0" * (dp - n)
        else:
            out = digits[:dp] + "." + digits[dp:]
    else:
        out = digits[0] + ("." + digits[1:] if n > 1 else "") + \
            ("e+" if e10 >= 0 else "e-") + str(abs(e10))
    return sign + out


def _float_texts(values: np.ndarray) -> list:
    """pyarrow's CSV text of each float of a float64 or float32 array."""
    if values.dtype == np.float32:
        return [_arrow_float(str(v)) for v in values]
    out = list(map(repr, values.tolist()))
    mag = np.abs(values)
    with np.errstate(invalid="ignore"):
        slow = ~((mag >= 1e-4) & (mag < 1e10))  # 0, nan and inf too
    for i in np.flatnonzero(slow).tolist():
        out[i] = _arrow_float(out[i])
    return [s[:-2] if s.endswith(".0") else s for s in out]


def _datetime_texts(values: np.ndarray, unit: str) -> np.ndarray:
    """'YYYY-MM-DD HH:MM:SS' of int64 times in `unit` (whole seconds)."""
    secs = np.floor_divide(values, _per_second(unit))
    txt = np.datetime_as_string(secs.astype("datetime64[s]"))
    return np.char.replace(txt, "T", " ")


def _per_second(unit: str) -> int:
    return 10 ** _UNIT_DIGITS[unit]


def _csv_column(col) -> list:
    t = col.type
    if col.dictionary is not None:
        # quote each dictionary entry once; code -1 (NULL) takes the ""
        quoted = np.asarray(['"' + str(v).replace('"', '""') + '"'
                             for v in col.dictionary.tolist()] + [""],
                            dtype=object)
        return quoted[np.where(col.values >= 0, col.values,
                               len(col.dictionary))].tolist()
    if t in ("string", "binary"):
        return ["" if v is None else '"' + str(v).replace('"', '""') + '"'
                for v in col.strings().tolist()]
    if t == "null":
        return [""] * len(col)
    if t == "bool":
        out = np.where(col.values, "true", "false").tolist()
    elif t in ("float", "double"):
        out = _float_texts(col.values)
    elif t in _UNIT_DIGITS or t == "date32":
        out = _csv_time_strs(col).tolist()
    else:
        out = list(map(str, col.values.tolist()))
    if col.valid is not None:
        out = [s if ok else "" for s, ok in zip(out, col.valid.tolist())]
    return out


def _csv_time_strs(col) -> np.ndarray:
    """CSV text of a timestamp or date32 column, a numpy str array."""
    if col.type == "date32":
        return np.datetime_as_string(col.values.astype("datetime64[D]"))
    txt = np.datetime_as_string(col.values.astype(np.int64).astype(
        f"datetime64[{_NP_UNIT[col.type]}]"))
    return np.char.replace(txt, "T", " ")


def csv_bytes(table) -> bytes:
    lib = native.try_load()
    if lib is None:
        return _csv_bytes_python(table)
    header = ",".join('"' + n.replace('"', '""') + '"' for n in table.names)
    cols = [_csv_texts(lib, table.column(n)) for n in table.names]
    k = len(cols)
    pieces = [""] + [","] * (k - 1) + ["\n"] if k else ["\n"]
    return (header + "\n").encode() + lib.text_rows(cols, pieces,
                                                   table.num_rows)


def _csv_bytes_python(table) -> bytes:
    header = ",".join('"' + n.replace('"', '""') + '"' for n in table.names)
    cols = [_csv_column(table.column(n)) for n in table.names]
    lines = [header] + [",".join(r) for r in zip(*cols)] \
        if table.num_rows else [header]
    return ("\n".join(lines) + "\n").encode()


def _json_floats(values: np.ndarray) -> list:
    out = list(map(repr, values.astype(np.float64).tolist()))
    if not np.isfinite(values).all():
        out = [{"nan": "NaN", "inf": "Infinity",
                "-inf": "-Infinity"}.get(s, s) for s in out]
    return out


def _json_time_strs(values: np.ndarray, t: str) -> np.ndarray:
    """JSON strings of str() of each time (or date32 day), as the JAX
    writer gives them, a numpy str array."""
    if t == "date32":
        days = np.datetime_as_string(values.astype("datetime64[D]"))
        return np.char.add(np.char.add('"', days), '"')
    per = _per_second(t)
    vals = values.astype(np.int64)
    base = _datetime_texts(vals, t)
    frac = vals - np.floor_divide(vals, per) * per
    if t == "timestamp[ns]":
        micro_only = frac % 1000 == 0
        tails = np.where(
            frac == 0, "",
            np.where(micro_only,
                     np.char.add(".", np.char.zfill(
                         (frac // 1000).astype(str), 6)),
                     np.char.add(".", np.char.zfill(frac.astype(str), 9))))
    else:
        micros = frac * (10 ** 6 // per) if per <= 10 ** 6 else frac
        tails = np.where(micros == 0, "",
                         np.char.add(".", np.char.zfill(
                             micros.astype(str), 6)))
    return np.char.add(np.char.add('"', np.char.add(base, tails)), '"')


def _json_column(col) -> list:
    t = col.type
    if col.dictionary is not None:
        quoted = np.asarray([json.dumps(v) for v in col.dictionary.tolist()]
                            + ["null"], dtype=object)
        return quoted[np.where(col.values >= 0, col.values,
                               len(col.dictionary))].tolist()
    if t in ("string", "binary"):
        return [json.dumps(v) for v in col.strings().tolist()]
    if t == "null":
        return ["null"] * len(col)
    if t == "bool":
        out = np.where(col.values, "true", "false").tolist()
    elif t in ("float", "double"):
        out = _json_floats(col.values)
    elif t in _UNIT_DIGITS or t == "date32":
        out = _json_time_strs(col.values, t).tolist()
    else:
        out = list(map(str, col.values.tolist()))
    if col.valid is not None:
        out = [s if ok else "null" for s, ok in zip(out, col.valid.tolist())]
    return out


def ndjson_bytes(table) -> bytes:
    lib = native.try_load()
    if lib is None:
        return _ndjson_bytes_python(table)
    if not table.num_rows:
        return b"\n"
    keys = [json.dumps(n) + ": " for n in table.names]
    cols = [_json_texts(lib, table.column(n)) for n in table.names]
    pieces = ["{" + keys[0]] + [", " + k for k in keys[1:]] + ["}\n"] \
        if keys else ["{}\n"]
    return lib.text_rows(cols, pieces, table.num_rows)


def _ndjson_bytes_python(table) -> bytes:
    keys = [json.dumps(n) + ": " for n in table.names]
    cols = [_json_column(table.column(n)) for n in table.names]
    lines = ["{" + ", ".join(k + v for k, v in zip(keys, r)) + "}"
             for r in zip(*cols)]
    return ("\n".join(lines) + "\n").encode()


# ---- the native path: a column's texts as (entries, offsets, index) ---------


def _entries(texts) -> tuple:
    """(buf, offs) of a sequence of Python strings (UTF-8)."""
    enc = [t.encode() for t in texts]
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    if enc:
        offs[1:] = np.cumsum(np.fromiter(map(len, enc), np.int64, len(enc)))
    return np.frombuffer(b"".join(enc), dtype=np.uint8), offs


def _char_entries(strs: np.ndarray) -> tuple:
    """(buf, offs) of a numpy str array of ASCII texts (dates, times)
    without a Python string a value: the fixed-width bytes, compacted."""
    fixed = np.ascontiguousarray(strs.astype("S"))
    n, width = len(fixed), fixed.dtype.itemsize
    lens = np.char.str_len(fixed).astype(np.int64)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    grid = fixed.view(np.uint8).reshape(n, width)
    return grid[np.arange(width) < lens[:, None]], offs


def _with_nulls(entries: tuple, valid, null_text: str) -> tuple:
    """Entries of each row plus a NULL entry, indexed so an invalid row
    takes it; as they are when every row is valid."""
    buf, offs = entries
    if valid is None:
        return buf, offs, None
    null = np.frombuffer(null_text.encode(), dtype=np.uint8)
    n = len(offs) - 1
    buf = np.concatenate([buf, null])
    offs = np.append(offs, offs[-1] + len(null))
    index = np.where(valid, np.arange(n, dtype=np.int32), np.int32(n))
    return buf, offs, index


def _dictionary_texts(col, texts: list, null_text: str) -> tuple:
    buf, offs = _entries(texts + [null_text])
    codes = col.values.astype(np.int32)
    return buf, offs, np.where(codes >= 0, codes, np.int32(len(texts)))


def _bool_texts(col, null_text: str) -> tuple:
    buf, offs = _entries(["false", "true", null_text])
    index = col.values.astype(np.int32)
    if col.valid is not None:
        index = np.where(col.valid, index, np.int32(2))
    return buf, offs, index


def _int_texts(lib, values: np.ndarray) -> tuple:
    if values.dtype != np.uint64:
        values = values.astype(np.int64)
    return lib.number_text(values, "int")


def _csv_texts(lib, col) -> tuple:
    t = col.type
    if col.dictionary is not None:
        return _dictionary_texts(
            col, ['"' + str(v).replace('"', '""') + '"'
                  for v in col.dictionary.tolist()], "")
    if t in ("string", "binary"):
        return (*_entries(_csv_column(col)), None)
    if t == "null":
        return *_entries([""]), np.zeros(len(col), dtype=np.int32)
    if t == "bool":
        return _bool_texts(col, "")
    if t in ("float", "double"):
        entries = lib.number_text(col.values, "arrow")
    elif t in _UNIT_DIGITS or t == "date32":
        entries = _char_entries(_csv_time_strs(col))
    elif col.values.dtype.kind in "iu":
        entries = _int_texts(lib, col.values)
    else:
        entries = _entries(_csv_column(col))
        return (*entries, None)
    return _with_nulls(entries, col.valid, "")


def _json_texts(lib, col) -> tuple:
    t = col.type
    if col.dictionary is not None:
        return _dictionary_texts(
            col, [json.dumps(v) for v in col.dictionary.tolist()], "null")
    if t in ("string", "binary"):
        return (*_entries(_json_column(col)), None)
    if t == "null":
        return *_entries(["null"]), np.zeros(len(col), dtype=np.int32)
    if t == "bool":
        return _bool_texts(col, "null")
    if t in ("float", "double"):
        entries = lib.number_text(col.values, "repr")
    elif t in _UNIT_DIGITS or t == "date32":
        entries = _char_entries(_json_time_strs(col.values, t))
    elif col.values.dtype.kind in "iu":
        entries = _int_texts(lib, col.values)
    else:
        return (*_entries(_json_column(col)), None)
    return _with_nulls(entries, col.valid, "null")
