"""Device expression evaluation of the port (greptimedb_tpu_torch/query/
expr.py::eval_device) against the JAX package's, on the same bound
expressions and numpy columns: comparisons, IN, boolean logic, tag
predicates, arithmetic and date_bin over negative timestamps (floor, not
truncation). Results must be equal; float results within 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greptimedb_tpu.datatypes.schema import ColumnSchema as JCol, Schema as JSchema
from greptimedb_tpu.datatypes.types import DataType as JDT, SemanticType as JSem
from greptimedb_tpu.query import expr as jexpr
from greptimedb_tpu.sql import parse_sql as jparse
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.query import expr as texpr
from greptimedb_tpu_torch.sql import parse_sql

_COLS = [("host", "string", "tag"), ("ts", "timestamp_ms", "timestamp"),
         ("v", "float64", "field"), ("k", "int64", "field")]
_TAGS = np.asarray(["a", "b", "c", "d"], dtype=object)


def _schemas():
    j = JSchema([JCol(n, JDT(d), JSem(s)) for n, d, s in _COLS])
    t = Schema([ColumnSchema(n, DataType(d), SemanticType(s))
                for n, d, s in _COLS])
    return j, t


def _data(n=257, seed=0):
    rng = np.random.default_rng(seed)
    host = rng.integers(-1, 4, n).astype(np.int32)  # -1: NULL tag
    ts = rng.integers(-10_000_000, 10_000_000, n).astype(np.int64)
    v = np.round(rng.uniform(-100, 100, n), 1)
    v[rng.uniform(0, 1, n) < 0.1] = np.nan
    k = rng.integers(-50, 50, n).astype(np.int64)
    return {"host": host, "ts": ts, "v": v, "k": k}


@pytest.mark.parametrize("where", [
    "v > 10",
    "v <= -3.5 OR k = 7",
    "NOT (k >= 0) AND v < 50",
    "k IN (1, 2, 3, -4)",
    "k NOT IN (1, 2, 3)",
    "host = 'b'",
    "host != 'c'",
    "host IN ('a', 'd', 'zz')",
    "host >= 'b'",
    "host LIKE 'c%'",
    "host IS NULL",
    "v IS NOT NULL AND host IS NOT NULL",
    "k BETWEEN -10 AND 10",
    "ts >= -3600000 AND ts < 3600000",
    "k % 7 = 3",
    "k / 7 = -2",
    "date_bin(INTERVAL '1 hour', ts) = -3600000",
    "date_bin(INTERVAL '15 minutes', ts) < -900000",
    "abs(v) > 50 AND k * 2 > 0",
])
def test_where_mask_matches_jax(where):
    sql = f"SELECT * FROM t WHERE {where}"
    jw = jparse(sql)[0].where
    tw = parse_sql(sql)[0].where
    jschema, tschema = _schemas()
    cols = _data()
    jb = jexpr.bind_expr(jw, jexpr.BindContext(jschema, {"host": _TAGS}))
    tb = texpr.bind_expr(tw, texpr.BindContext(tschema, {"host": _TAGS}))
    want = np.asarray(jexpr.eval_device(
        jb, {k: jnp.asarray(v) for k, v in cols.items()},
        frozenset({"host"}), jschema))
    got = texpr.eval_device(
        tb, {k: torch.from_numpy(v) for k, v in cols.items()},
        frozenset({"host"}), tschema).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("expr", [
    "date_bin(INTERVAL '1 hour', ts)",
    "date_bin(INTERVAL '1 minute', ts, 7)",
    "date_trunc('week', ts)",
    "v * 2 + k",
    "k / 3",
    "k % 4",
    "coalesce(v, -1.0)",
    "round(v, 1)",
    "CASE WHEN k > 0 THEN v ELSE 0.0 END",
    "greatest(v, k)",
])
def test_values_match_jax(expr):
    sql = f"SELECT {expr} FROM t"
    jschema, tschema = _schemas()
    cols = _data(seed=1)
    je = jexpr.bind_expr(jparse(sql)[0].items[0].expr,
                         jexpr.BindContext(jschema, {"host": _TAGS}))
    te = texpr.bind_expr(parse_sql(sql)[0].items[0].expr,
                         texpr.BindContext(tschema, {"host": _TAGS}))
    want = np.asarray(jexpr.eval_device(
        je, {k: jnp.asarray(v) for k, v in cols.items()},
        frozenset({"host"}), jschema))
    got = texpr.eval_device(
        te, {k: torch.from_numpy(v) for k, v in cols.items()},
        frozenset({"host"}), tschema).numpy()
    assert got.dtype == want.dtype
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_literal_takes_the_column_dtype():
    _, tschema = _schemas()
    cols = {"v": torch.ones(4, dtype=torch.float32),
            "k": torch.ones(4, dtype=torch.int32)}
    e = parse_sql("SELECT v + 1.5, k + 2 FROM t")[0].items
    assert texpr.eval_device(e[0].expr, cols, frozenset(), tschema).dtype \
        == torch.float32
    assert texpr.eval_device(e[1].expr, cols, frozenset(), tschema).dtype \
        == torch.int32
