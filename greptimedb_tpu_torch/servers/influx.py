"""InfluxDB line protocol ingestion (counterpart of
greptimedb_tpu/servers/influx.py; mirrors reference servers::influxdb +
operator Inserter auto-create, src/operator/src/insert.rs:112).

`measurement,tag=a,tag2=b field=1.0,field2=2i 1465839830100400200`

Tables are auto-created on first write (tags -> TAG STRING columns, fields
typed from the first-seen value, `ts` time index); later writes with new
fields auto-ALTER (all new columns in one schema swap).

Hot path: `write_lines` tries the columnar vector lane first
(`_vector_parse`, one native scan), then parses straight into per-table column
slabs (greptimedb_tpu_torch/ingest.py) — escape-free lines (the overwhelming
Telegraf/TSBS shape) take a split-based fast lane, escaped/quoted lines
fall back to the char-walking parser — and lands as one RecordBatch per
table on the bulk write path. Malformed lines reject the request with a
typed error naming every bad line NUMBER (a torn half-line from a
crashed client must 4xx loudly, not vanish with the rest of the batch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from greptimedb_tpu_torch import native
from greptimedb_tpu_torch.ingest import TableSlab, write_slabs
from greptimedb_tpu_torch.utils.metrics import INGEST_ROWS

__all__ = ["LineProtocolError", "Point", "parse_line_protocol",
           "parse_lines_columnar", "write_lines", "write_points"]


class LineProtocolError(Exception):
    """Malformed line-protocol input. `lines` carries the 1-based line
    numbers at fault (the HTTP layer renders them in its 400 body)."""

    def __init__(self, msg: str, lines: Optional[list[int]] = None):
        super().__init__(msg)
        self.lines = lines or []


@dataclass
class Point:
    measurement: str
    tags: list[tuple[str, str]]
    fields: list[tuple[str, object]]
    ts: Optional[int]  # raw integer timestamp (precision applied later)


def parse_line_protocol(text: str) -> list[Point]:
    points = []
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        points.append(_parse_line(line))
    return points


def _split_unescaped(s: str, sep: str, escapable: str) -> list[str]:
    parts, cur, i = [], [], 0
    in_quote = False
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            cur.append(ch)
            cur.append(s[i + 1])
            i += 2
            continue
        if ch == '"':
            in_quote = not in_quote
            cur.append(ch)
        elif ch == sep and not in_quote:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    parts.append("".join(cur))
    return parts


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _parse_line(line: str) -> Point:
    # split into measurement+tags | fields | timestamp on unescaped spaces
    sections = _split_unescaped(line, " ", ", ")
    sections = [s for s in sections if s != ""]
    if len(sections) < 2 or len(sections) > 3:
        # > 3: trailing junk after the timestamp — rejecting matches the
        # fast/fused lanes (silently dropping sections would make the
        # lanes diverge on escaped lines)
        raise LineProtocolError(f"malformed line: {line!r}")
    head = sections[0]
    fields_part = sections[1]
    ts = None
    if len(sections) >= 3:
        try:
            ts = int(sections[2])
        except ValueError:
            raise LineProtocolError(f"bad timestamp in {line!r}")
    head_parts = _split_unescaped(head, ",", " ,")
    measurement = _unescape(head_parts[0])
    tags = []
    for t in head_parts[1:]:
        if "=" not in t:
            raise LineProtocolError(f"bad tag {t!r}")
        k, v = t.split("=", 1)
        tags.append((_unescape(k), _unescape(v)))
    fields = []
    for f in _split_unescaped(fields_part, ",", " ,"):
        if "=" not in f:
            raise LineProtocolError(f"bad field {f!r}")
        k, v = f.split("=", 1)
        fields.append((_unescape(k), _parse_field_value(v)))
    if not fields:
        raise LineProtocolError(f"no fields in {line!r}")
    return Point(measurement, tags, fields, ts)


def _parse_field_value(v: str):
    if v.startswith('"') and v.endswith('"') and len(v) >= 2:
        return v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    if v in ("t", "T", "true", "True", "TRUE"):
        return True
    if v in ("f", "F", "false", "False", "FALSE"):
        return False
    try:
        if v.endswith("i") or v.endswith("u"):
            return int(v[:-1])
        out = float(v)
    except ValueError:
        raise LineProtocolError(f"bad field value {v!r}") from None
    if not math.isfinite(out):
        # the wire protocol has no NaN/inf literals — Python's float()
        # accepting "NaN"/"inf" silently would store poison values a
        # SUM/AVG then spreads over the whole window
        raise LineProtocolError(f"non-finite field value {v!r}")
    return out


# precision -> (numerator, denominator) for exact integer ts -> ms
# conversion (ns-epoch values exceed 2^53, so float math loses precision)
_PRECISION_TO_MS = {"ns": (1, 1_000_000), "u": (1, 1000), "us": (1, 1000),
                    "ms": (1, 1), "s": (1000, 1), "m": (60_000, 1),
                    "h": (3_600_000, 1)}


_NUM_LEAD = frozenset("0123456789-+.")


def _parse_line_fast(line: str):
    """Escape-free fast lane: plain str.split + an inlined numeric
    field decode — no char walking, no per-value function call for the
    overwhelming float case. Lines carrying backslashes or quotes take
    the full escape-aware parser. Returns
    (measurement, tags, fields, raw_ts)."""
    if "\\" in line or '"' in line:
        p = _parse_line(line)
        return p.measurement, p.tags, p.fields, p.ts
    sections = line.split(" ")
    ns = len(sections)
    if ns == 3:
        head, fields_part, ts_part = sections
        try:
            ts = int(ts_part)
        except ValueError:
            raise LineProtocolError(
                f"bad timestamp in {line!r}") from None
    elif ns == 2:
        head, fields_part = sections
        ts = None
    else:
        # consecutive unescaped spaces (or a lone measurement): re-split
        # tolerantly, then re-validate
        sections = [s for s in sections if s]
        if len(sections) < 2 or len(sections) > 3:
            raise LineProtocolError(f"malformed line: {line!r}")
        return _parse_line_fast(" ".join(sections))
    head_parts = head.split(",")
    measurement = head_parts[0]
    if not measurement:
        raise LineProtocolError(f"missing measurement in {line!r}")
    tags = []
    for t in head_parts[1:]:
        k, sep, v = t.partition("=")
        if not sep or not k:
            raise LineProtocolError(f"bad tag {t!r}")
        tags.append((k, v))
    fields = []
    for fkv in fields_part.split(","):
        k, sep, v = fkv.partition("=")
        if not sep or not k or not v:
            raise LineProtocolError(f"bad field {fkv!r}")
        if v[0] in _NUM_LEAD:
            try:
                if v[-1] in "iu":
                    fv = int(v[:-1])
                else:
                    fv = float(v)
                    if not math.isfinite(fv):
                        raise LineProtocolError(
                            f"non-finite field value {v!r}")
            except ValueError:
                raise LineProtocolError(
                    f"bad field value {v!r}") from None
        else:
            # bools, quoted strings, and float() spellings like "inf"
            # that must be rejected with the right message
            fv = _parse_field_value(v)
        fields.append((k, fv))
    return measurement, tags, fields, ts


def parse_lines_columnar(text: str, precision: str = "ns",
                         now_ms: Optional[int] = None
                         ) -> dict[str, TableSlab]:
    """Parse a whole request body straight into per-measurement column
    slabs. ANY malformed line rejects the request with a typed error
    listing every bad line number — partial/torn lines must never
    silently drop (or silently take the batch down with them).

    The regular shape (no escapes/quotes, 2-3 space-separated sections
    — the entire Telegraf/TSBS stream) takes a FUSED lane: split,
    numeric decode, and column append happen in one pass with no
    per-line function call and no intermediate (key, value) tuples.
    Irregular lines fall back to `_parse_line_fast` (which itself falls
    back to the escape-aware char walker); both lanes produce identical
    rows — the parse-fuzz suite pins that."""
    import time as _time

    scale = _PRECISION_TO_MS.get(precision)
    if scale is None:
        raise LineProtocolError(f"bad precision {precision!r}")
    num, den = scale
    if now_ms is None:
        now_ms = int(_time.time() * 1000)
    slabs: dict[str, TableSlab] = {}
    bad: list[tuple[int, str]] = []

    def slow_lane(line: str, line_no: int) -> None:
        try:
            measurement, tags, fields, ts = _parse_line_fast(line)
        except LineProtocolError as e:
            bad.append((line_no, str(e)))
            return
        slab = slabs.get(measurement)
        if slab is None:
            slab = slabs[measurement] = TableSlab()
        slab.add_row(tags, fields,
                     now_ms if ts is None else ts * num // den)

    for line_no, raw in enumerate(text.split("\n"), 1):
        line = raw.strip()
        if not line or line[0] == "#":
            continue
        if "\\" in line or '"' in line:
            slow_lane(line, line_no)
            continue
        sections = line.split(" ")
        ns = len(sections)
        if ns == 3:
            head, fields_part, ts_part = sections
            try:
                ts_ms = int(ts_part) * num // den
            except ValueError:
                bad.append((line_no, f"bad timestamp in {line!r}"))
                continue
        elif ns == 2:
            head, fields_part = sections
            ts_ms = now_ms
        else:
            slow_lane(line, line_no)  # double spaces / lone measurement
            continue
        head_parts = head.split(",")
        measurement = head_parts[0]
        if not measurement:
            bad.append((line_no, f"missing measurement in {line!r}"))
            continue
        slab = slabs.get(measurement)
        if slab is None:
            slab = slabs[measurement] = TableSlab()
        r = slab.rows
        tag_cols = slab.tags
        field_cols = slab.fields
        appended = 0
        nfields = 0
        err = None
        for t in head_parts[1:]:
            k, sep, v = t.partition("=")
            if not sep or not k:
                err = f"bad tag {t!r}"
                break
            col = tag_cols.get(k)
            if col is None:
                col = tag_cols[k] = [None] * r
            if len(col) == r:
                col.append(v)
                appended += 1
            else:
                col[-1] = v
        if err is None:
            for fkv in fields_part.split(","):
                k, sep, v = fkv.partition("=")
                if not sep or not k or not v:
                    err = f"bad field {fkv!r}"
                    break
                if v[0] in _NUM_LEAD:
                    try:
                        if v[-1] in "iu":
                            fv = int(v[:-1])
                        else:
                            fv = float(v)
                            if not math.isfinite(fv):
                                err = f"non-finite field value {v!r}"
                                break
                    except ValueError:
                        err = f"bad field value {v!r}"
                        break
                else:
                    try:
                        fv = _parse_field_value(v)
                    except LineProtocolError as e:
                        err = str(e)
                        break
                nfields += 1
                col = field_cols.get(k)
                if col is None:
                    col = field_cols[k] = [None] * r
                if len(col) == r:
                    col.append(fv)
                    appended += 1
                else:
                    col[-1] = fv
        if err is None and nfields == 0:
            err = f"no fields in {line!r}"
        if err is not None:
            # roll the partial row back out of the slab columns
            for col in tag_cols.values():
                if len(col) > r:
                    col.pop()
            for col in field_cols.values():
                if len(col) > r:
                    col.pop()
            bad.append((line_no, err))
            continue
        slab.ts.append(ts_ms)
        slab.rows = r + 1
        if appended != len(tag_cols) + len(field_cols):
            for col in tag_cols.values():
                if len(col) != slab.rows:
                    col.append(None)
            for col in field_cols.values():
                if len(col) != slab.rows:
                    col.append(None)
    if bad:
        shown = "; ".join(f"line {n}: {m}" for n, m in bad[:5])
        more = f" (+{len(bad) - 5} more)" if len(bad) > 5 else ""
        raise LineProtocolError(
            f"rejected {len(bad)} bad line(s): {shown}{more}",
            lines=[n for n, _ in bad])
    return slabs


def _vector_parse(text: str, num: int, den: int, now_ms: int):
    """Columnar lane for the regular single-measurement shape (the whole
    Telegraf/TSBS stream). The JAX package hands the body to Arrow's C
    CSV reader; the port has no pyarrow and scans it in one native pass
    instead (native/src/lp_columns.cpp, the GIL released): every line
    must carry the first line's keys in the first line's order, and the
    scan lands straight in float64 field columns, raw timestamps and the
    tag values' offsets, which dictionary-encode here.

    Returns {measurement: VectorSlab}, or None when ANY precondition
    fails, so that it never decides what the Python lanes would decide
    otherwise: escapes, quotes, comments, control or non-ASCII bytes,
    mixed measurements, ragged rows or misplaced separators, repeated
    keys, varying key order, values that are not plain decimals (ints,
    bools, strings, underscores), non-finite values, timestamps that are
    not plain integers or leave int64 — or no native library. The Python
    lanes then re-parse with exact per-line diagnostics. The parity
    tests pin both lanes to identical batches."""
    if "\\" in text or '"' in text or "#" in text:
        return None
    body = text.strip()
    if not body:
        return None
    lib = native.try_load()
    if lib is None:
        return None

    from greptimedb_tpu_torch.datatypes.vector import DictVector
    from greptimedb_tpu_torch.ingest import VectorSlab

    head = body.split("\n", 1)[0]
    try:
        measurement, first_tags, first_fields, first_ts = \
            _parse_line_fast(head)
    except LineProtocolError:
        return None
    if not first_fields or any(type(v) is not float
                               for _, v in first_fields):
        return None  # int/bool/string fields: the Python lanes decode
    tag_keys = [k for k, _ in first_tags]
    field_keys = [k for k, _ in first_fields]
    if len(set(tag_keys + field_keys)) != len(tag_keys) + len(field_keys):
        return None  # a repeated key: the last value wins, row by row
    # the scan stops at the first line of another measurement or shape
    # (a typical Telegraf batch mixes cpu/mem/disk...)
    n = body.count("\n") + 1
    has_ts = first_ts is not None
    scanned = lib.lp_columns(body.encode(), measurement, tag_keys,
                             field_keys, has_ts, n)
    if scanned is None:
        return None
    tag_off, tag_len, field_cols, raw_ts = scanned
    tags: dict = {}
    for key, off, ln in zip(tag_keys, tag_off, tag_len):
        # the body is ASCII (the scan checked): byte offsets are indexes
        vals = list(map(body.__getitem__,
                        map(slice, off.tolist(), (off + ln).tolist())))
        # DictVector.encode's codes (sorted distinct values), without its
        # per-value NULL test: the lane's tags are never NULL
        uniq, inv = np.unique(np.asarray(vals), return_inverse=True)
        tags[key] = DictVector(inv.astype(np.int32), uniq.astype(object))
    fields = dict(zip(field_keys, field_cols))
    if has_ts:
        ts = raw_ts
        if num != 1:
            lim = np.iinfo(np.int64).max // num
            if (ts > lim).any() or (ts < -lim).any():
                return None  # the exact product leaves int64
            ts = ts * num
        if den != 1:
            ts = ts // den  # floor, as the Python lanes' integer `//`
    else:
        ts = np.full(n, now_ms, dtype=np.int64)
    return {measurement: VectorSlab(n, tags, fields, ts)}


def write_lines(query_engine, db: str, text: str,
                precision: str = "ns") -> int:
    """The line-protocol front door: columnar parse + bulk write (one
    RecordBatch per measurement into its one region; the WAL append is
    synchronous, one fsync a request, until group commit is ported).
    Raises LineProtocolError (HTTP 400) on any malformed line."""
    import time as _time

    from greptimedb_tpu_torch.session import QueryContext

    scale = _PRECISION_TO_MS.get(precision)
    if scale is None:
        raise LineProtocolError(f"bad precision {precision!r}")
    now_ms = int(_time.time() * 1000)
    slabs = _vector_parse(text, scale[0], scale[1], now_ms)
    if slabs is None:
        slabs = parse_lines_columnar(text, precision, now_ms=now_ms)
    total = write_slabs(query_engine, QueryContext(db=db), slabs)
    INGEST_ROWS.inc(total, protocol="influxdb")
    return total


def write_points(query_engine, db: str, points: list[Point],
                 precision: str = "ns") -> int:
    """Point-object write surface (OTLP/OpenTSDB build Points
    programmatically): funnels into the same columnar bulk path as
    `write_lines`."""
    import time as _time

    from greptimedb_tpu_torch.session import QueryContext

    scale = _PRECISION_TO_MS.get(precision)
    if scale is None:
        raise LineProtocolError(f"bad precision {precision!r}")
    num, den = scale
    now_ms = int(_time.time() * 1000)
    slabs: dict[str, TableSlab] = {}
    for p in points:
        slab = slabs.get(p.measurement)
        if slab is None:
            slab = slabs[p.measurement] = TableSlab()
        slab.add_row(p.tags, p.fields,
                     now_ms if p.ts is None else int(p.ts) * num // den)
    total = write_slabs(query_engine, QueryContext(db=db), slabs)
    INGEST_ROWS.inc(total, protocol="influxdb")
    return total
