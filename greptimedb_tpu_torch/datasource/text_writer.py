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
"""

from __future__ import annotations

import json

import numpy as np

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
    elif t in _UNIT_DIGITS:
        vals = col.values.astype(np.int64)
        out = np.datetime_as_string(
            vals.astype(f"datetime64[{_NP_UNIT[t]}]"))
        out = np.char.replace(out, "T", " ").tolist()
    elif t == "date32":
        out = np.datetime_as_string(
            col.values.astype("datetime64[D]")).tolist()
    else:
        out = list(map(str, col.values.tolist()))
    if col.valid is not None:
        out = [s if ok else "" for s, ok in zip(out, col.valid.tolist())]
    return out


def csv_bytes(table) -> bytes:
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


def _json_times(values: np.ndarray, t: str) -> list:
    """JSON strings of str() of each time, as the JAX writer gives them."""
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
    return ['"' + a + b + '"' for a, b in zip(base.tolist(), tails.tolist())]


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
    elif t in _UNIT_DIGITS:
        out = _json_times(col.values, t)
    elif t == "date32":
        out = ['"' + s + '"' for s in np.datetime_as_string(
            col.values.astype("datetime64[D]")).tolist()]
    else:
        out = list(map(str, col.values.tolist()))
    if col.valid is not None:
        out = [s if ok else "null" for s, ok in zip(out, col.valid.tolist())]
    return out


def ndjson_bytes(table) -> bytes:
    keys = [json.dumps(n) + ": " for n in table.names]
    cols = [_json_column(table.column(n)) for n in table.names]
    lines = ["{" + ", ".join(k + v for k, v in zip(keys, r)) + "}"
             for r in zip(*cols)]
    return ("\n".join(lines) + "\n").encode()
