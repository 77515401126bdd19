"""Columnar result serialization for the protocol servers (copy of
greptimedb_tpu/servers/encode.py): the /v1/sql JSON body and the MySQL
resultset packets.

Deliberately light on imports (json/math/numpy and the metrics
registry): the encode pool's process mode (spawn) imports this module
in its workers, which must neither pay for torch nor initialise CUDA.

Two properties the tier-1 parity tests pin down:

- **byte identity**: the columnar fast path produces exactly the bytes
  the per-value path produced (same null mapping: NaN/Inf -> null, same
  C `json.dumps` on native Python objects), so responses are identical
  whether encoding runs inline, on a pool thread, or in a worker
  process;
- **one materialization per batch group**: results that came out of the
  cross-query batcher share an `encode_memo` dict — the first encoder
  to run stores the materialized row list, the other members of the
  coalesced group reuse it instead of re-walking the columns.
"""

from __future__ import annotations

import json
import math
import struct

import numpy as np

from greptimedb_tpu_torch.utils.metrics import ENCODE_SECONDS


def _json_safe(v):
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def json_rows(r) -> list:
    """`r.rows()` with JSON-safe values, built column-wise: numeric
    columns convert through ONE numpy object cast (a C loop yielding
    native Python scalars) + a vectorized non-finite -> None mask,
    instead of a Python-level `_json_safe` call per value. Object/
    string columns keep the per-value loop (they may hold anything).
    Memoized in the result's batch-group `encode_memo` when present."""
    memo = getattr(r, "encode_memo", None)
    if memo is not None:
        rows = memo.get("json_rows")
        if rows is not None:
            return rows
    cols = []
    for col in r.columns:
        a = np.asarray(col)
        if a.dtype.kind == "f":
            o = a.astype(object)
            bad = ~np.isfinite(a)
            if bad.any():
                o[bad] = None
            cols.append(o.tolist())
        elif a.dtype.kind in "iub":
            cols.append(a.astype(object).tolist())
        else:
            cols.append([_json_safe(v) for v in a.tolist()])
    rows = [list(t) for t in zip(*cols)] if cols else []
    if memo is not None:
        # benign race: concurrent encoders compute identical values
        memo["json_rows"] = rows
    return rows


def records_json(r) -> dict:
    schema = {"column_schemas": [
        {"name": n, "data_type": (dt.value if dt else "string")}
        for n, dt in zip(r.names, r.dtypes)
    ]}
    return {"schema": schema, "rows": json_rows(r),
            "total_rows": r.num_rows}


#: memoized pre-serialized schema headers, keyed by the result shape —
#: dashboards repeat a handful of shapes, and re-dumping the identical
#: column_schemas fragment per response was pure per-request overhead.
#: Plain dict under the GIL (benign race: equal values); bounded by a
#: wholesale clear.
_SCHEMA_CACHE: dict = {}


def schema_header_json(names, dtypes) -> str:
    key = (tuple(names),
           tuple(dt.value if dt else None for dt in dtypes))
    cached = _SCHEMA_CACHE.get(key)
    if cached is None:
        cached = json.dumps({"column_schemas": [
            {"name": n, "data_type": (dt.value if dt else "string")}
            for n, dt in zip(names, dtypes)]})
        if len(_SCHEMA_CACHE) > 512:
            _SCHEMA_CACHE.clear()
        _SCHEMA_CACHE[key] = cached
    return cached


def encode_sql_payload(results, elapsed_ms: float) -> bytes:
    """The full /v1/sql response body — built and dumped in one place
    so the pool can run it off the request thread. Assembled from the
    memoized schema-header fragment + one C `json.dumps` of the rows;
    byte-identical to dumping the whole document (json.dumps emits
    `", "`/`": "` separators — pinned by the tier-1 parity test)."""
    with ENCODE_SECONDS.time(protocol="http"):
        out = []
        for r in results:
            if not r.is_query:
                out.append('{"affectedrows": %d}' % r.affected_rows)
            else:
                out.append(
                    '{"records": {"schema": %s, "rows": %s, '
                    '"total_rows": %d}}'
                    % (schema_header_json(r.names, r.dtypes),
                       json.dumps(json_rows(r)), r.num_rows))
        return ('{"code": 0, "output": [%s], "execution_time_ms": %s}'
                % (", ".join(out), json.dumps(elapsed_ms))).encode()


# ---- MySQL wire fragments --------------------------------------------------
# (moved here from servers/mysql.py so the resultset encoding can run on
# encode-pool workers without importing the engine)

MYSQL_TYPE_VAR_STRING = 253


def lenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenc_str(s: bytes) -> bytes:
    return lenc_int(len(s)) + s


def _eof() -> bytes:
    return b"\xfe" + struct.pack("<H", 0) + struct.pack("<H", 0x0002)


def _coldef(name: str, ftype: int) -> bytes:
    return (
        lenc_str(b"def")
        + lenc_str(b"")  # schema
        + lenc_str(b"")  # table
        + lenc_str(b"")  # org_table
        + lenc_str(name.encode())
        + lenc_str(name.encode())
        + bytes([0x0C])  # fixed-length fields length
        + struct.pack("<H", 0x21)  # charset utf8
        + struct.pack("<I", 1024)  # column length
        + bytes([ftype])
        + struct.pack("<H", 0)  # flags
        + bytes([0x1F])  # decimals
        + b"\x00\x00"
    )


def _fmt(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def memo_rows(result) -> list:
    """`QueryResult.rows()` through the batch-group memo: coalesced
    members materialize the Python row objects once."""
    memo = getattr(result, "encode_memo", None)
    if memo is not None:
        rows = memo.get("rows")
        if rows is not None:
            return rows
    rows = result.rows()
    if memo is not None:
        memo["rows"] = rows
    return rows


def encode_mysql_result(result, binary: bool = False) -> list[bytes]:
    """Resultset packets straight from a QueryResult: the row
    materialization (`memo_rows` — the GIL-heaviest half of MySQL
    serialization) runs HERE, so offloading this function moves it off
    the session thread along with the packet assembly."""
    return encode_mysql_rows(list(result.names), memo_rows(result),
                             binary)


#: memoized resultset header packets (column count + column definitions
#: + EOF) keyed by the column-name tuple — every repeat of a dashboard
#: shape re-encoded identical coldef packets. Benign-race dict, bounded
#: by a wholesale clear.
_HEADER_CACHE: dict = {}


def mysql_header_packets(names) -> list[bytes]:
    key = tuple(names)
    cached = _HEADER_CACHE.get(key)
    if cached is None:
        cached = [lenc_int(len(names))] \
            + [_coldef(n, MYSQL_TYPE_VAR_STRING) for n in names] \
            + [_eof()]
        if len(_HEADER_CACHE) > 512:
            _HEADER_CACHE.clear()
        _HEADER_CACHE[key] = cached
    return list(cached)


def encode_mysql_rows(names, rows, binary: bool = False) -> list[bytes]:
    """Resultset packet payloads for one query result (column count,
    column definitions, EOF, row packets, EOF) — the session loop only
    stamps sequence numbers and writes. Row payloads accumulate in a
    reusable bytearray (amortized append) instead of quadratic bytes
    concatenation; the emitted packets are byte-identical."""
    with ENCODE_SECONDS.time(protocol="mysql"):
        packets = mysql_header_packets(names)
        for row in rows:
            payload = bytearray()
            if binary:
                # binary row: 0x00 header + null bitmap (offset 2) + values
                nb = bytearray((len(row) + 7 + 2) // 8)
                for i, v in enumerate(row):
                    if v is None or (isinstance(v, float) and np.isnan(v)):
                        nb[(i + 2) // 8] |= 1 << ((i + 2) % 8)
                    else:
                        s = _fmt(v).encode()
                        payload += lenc_int(len(s))
                        payload += s
                packets.append(b"\x00" + bytes(nb) + bytes(payload))
            else:
                for v in row:
                    if v is None or (isinstance(v, float) and np.isnan(v)):
                        payload += b"\xfb"  # NULL
                    else:
                        s = _fmt(v).encode()
                        payload += lenc_int(len(s))
                        payload += s
                packets.append(bytes(payload))
        packets.append(_eof())
        return packets
