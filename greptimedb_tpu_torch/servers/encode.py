"""Columnar result serialization for the protocol servers (the JSON
half of greptimedb_tpu/servers/encode.py; the MySQL packet fragments
come with the MySQL server, ROADMAP.md A9).

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
