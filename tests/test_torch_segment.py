"""Plain segment reductions and dedup of the port (greptimedb_tpu_torch/
ops/segment.py, ops/dedup.py) against the JAX package's
(greptimedb_tpu/ops/segment.py, ops/dedup.py) on the same numpy inputs.

f64 sums and means: rtol=1e-10, atol=1e-9 (tests/test_pallas.py's
tolerance; scatter order differs); counts, rows, min, max, first, last
and their timestamps: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greptimedb_tpu.ops import dedup as jdedup
from greptimedb_tpu.ops import segment as jseg
from greptimedb_tpu_torch.ops import dedup as tdedup
from greptimedb_tpu_torch.ops import segment as tseg

_EXACT = ("count", "rows", "min", "max", "first", "last", "first_ts",
          "last_ts")


def _case(n, f, g, seed):
    rng = np.random.default_rng(seed)
    vals = np.round(rng.uniform(-10, 10, (n, f)), 0)  # many ties
    vals[rng.uniform(0, 1, (n, f)) < 0.2] = np.nan
    ids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.uniform(0, 1, n) < 0.8
    # coarse timestamps: many rows of one group share an instant, so the
    # first/last tie-breaks by row index decide
    ts = rng.integers(-5, 5, n).astype(np.int64) * 1000
    return vals, ids, mask, ts


def _compare(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        gv = got[k].numpy()
        if k in _EXACT:
            np.testing.assert_array_equal(gv, w, err_msg=k)
        else:
            np.testing.assert_allclose(gv, w, rtol=1e-10, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("ops", [
    ("sum", "count"),
    ("mean", "rows"),
    ("min", "max"),
    ("first",),
    ("last",),
    ("first", "last", "sum"),
    ("sum", "sumsq", "count"),
])
@pytest.mark.parametrize("n,f,g", [(400, 3, 7), (64, 1, 40)])
def test_segment_agg_matches_jax(ops, n, f, g):
    vals, ids, mask, ts = _case(n, f, g, seed=n * 31 + f + g)
    want = jseg.segment_agg(jnp.asarray(vals), jnp.asarray(ids),
                            jnp.asarray(mask), g, ops=ops,
                            ts=jnp.asarray(ts))
    got = tseg.segment_agg(torch.from_numpy(vals), torch.from_numpy(ids),
                           torch.from_numpy(mask), g, ops=ops,
                           ts=torch.from_numpy(ts))
    _compare(got, want)


def test_segment_agg_1d_values_squeeze():
    vals, ids, mask, ts = _case(100, 1, 5, seed=9)
    v = vals[:, 0]
    want = jseg.segment_agg(jnp.asarray(v), jnp.asarray(ids),
                            jnp.asarray(mask), 5, ops=("sum", "count", "max"))
    got = tseg.segment_agg(torch.from_numpy(v), torch.from_numpy(ids),
                           torch.from_numpy(mask), 5,
                           ops=("sum", "count", "max"))
    assert got["sum"].dim() == 1
    _compare(got, want)


def test_segment_agg_f32_moments_accumulate_in_f64():
    vals, ids, mask, _ = _case(300, 2, 4, seed=5)
    v32 = vals.astype(np.float32)
    got = tseg.segment_agg(torch.from_numpy(v32), torch.from_numpy(ids),
                           torch.from_numpy(mask), 4,
                           ops=("sum", "sumsq", "count"))
    assert got["sum"].dtype == torch.float64
    assert got["sumsq"].dtype == torch.float64
    want = jseg.segment_agg(jnp.asarray(v32), jnp.asarray(ids),
                            jnp.asarray(mask), 4,
                            ops=("sum", "sumsq", "count"))
    _compare(got, want)


def test_time_bucket_and_group_ids_match_jax():
    ts = np.array([-3601, -3600, -1, 0, 1, 3599, 3600, 7201], dtype=np.int64)
    np.testing.assert_array_equal(
        tseg.time_bucket(torch.from_numpy(ts), 3600, origin=1).numpy(),
        np.asarray(jseg.time_bucket(jnp.asarray(ts), 3600, origin=1)))
    a = np.array([0, 1, 2, 3], dtype=np.int32)
    b = np.array([3, 2, 1, 0], dtype=np.int32)
    for dt, jdt in ((torch.int32, jnp.int32), (torch.int64, jnp.int64)):
        got = tseg.combine_group_ids(
            [torch.from_numpy(a), torch.from_numpy(b)], (4, 5), dtype=dt)
        want = jseg.combine_group_ids([jnp.asarray(a), jnp.asarray(b)],
                                      (4, 5), dtype=jdt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("assume_unique_ts,keep_tombstones", [
    (False, False), (False, True), (True, False)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_dedup_matches_jax(seed, assume_unique_ts, keep_tombstones):
    rng = np.random.default_rng(seed)
    n = 300
    sid = rng.integers(0, 12, n).astype(np.int32)
    ts = rng.integers(0, 20, n).astype(np.int64)
    seq = rng.permutation(n).astype(np.int64)
    op = (rng.uniform(0, 1, n) < 0.25).astype(np.int8)
    mask = rng.uniform(0, 1, n) < 0.9
    jo, jk = jdedup.sort_dedup(
        jnp.asarray(sid), jnp.asarray(ts), jnp.asarray(seq),
        jnp.asarray(op), jnp.asarray(mask),
        assume_unique_ts=assume_unique_ts, keep_tombstones=keep_tombstones)
    to, tk = tdedup.sort_dedup(
        torch.from_numpy(sid), torch.from_numpy(ts), torch.from_numpy(seq),
        torch.from_numpy(op), torch.from_numpy(mask),
        assume_unique_ts=assume_unique_ts, keep_tombstones=keep_tombstones)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
