"""The port's segment-reduction kernels (greptimedb_tpu_torch/ops/
segment_kernels.py) against the JAX package's Pallas kernels
(greptimedb_tpu/ops/pallas_segment.py), run in interpret mode on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions to the TPU kernels' contract; the
CUDA kernels are held to the plain versions on the card by chip_smoke.py.
Both sides skip or zero the dead segment G-1 differently (the Pallas
kernel accumulates it, every caller slices it away), so rows [:G-1] are
compared. f64 sums: rtol=1e-10, atol=1e-9 (the reference's own tolerance,
tests/test_pallas.py); counts, rows, min and max: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greptimedb_tpu.ops.pallas_segment import (
    pallas_dense_segment_sum,
    pallas_fused_segment_agg,
)
from greptimedb_tpu_torch.ops import segment_kernels as sk


def _inputs(n, w, gsz, seed, nan_frac=0.0, dead_frac=0.2, empty=()):
    rng = np.random.default_rng(seed)
    vals = np.round(rng.uniform(-50, 50, (n, w)), 1)  # rounding: ties
    if nan_frac:
        vals[rng.uniform(0, 1, (n, w)) < nan_frac] = np.nan
    ids = rng.integers(0, gsz - 1, n).astype(np.int32)
    for g in empty:  # groups no row reaches
        ids[ids == g] = gsz - 1
    ids[rng.uniform(0, 1, n) < dead_frac] = gsz - 1
    return vals, ids


@pytest.mark.parametrize("n,w,gsz", [
    (1000, 21, 61),   # single-groupby plane: 2F+1 lanes, 60 buckets + dead
    (777, 11, 9),     # no-NaN plane width, ragged rows
    (300, 1, 400),    # more groups than rows: empty groups
    (5, 3, 8),        # tiny
])
def test_segment_sum_plain_matches_pallas(n, w, gsz):
    plane, ids = _inputs(n, w, gsz, seed=n + w + gsz)
    plane[ids == gsz - 1] = 0.0  # the Pallas caller's dead-row contract
    want = np.asarray(pallas_dense_segment_sum(
        jnp.asarray(plane), jnp.asarray(ids), gsz, interpret=True))
    got = sk.segment_sum(torch.from_numpy(plane), torch.from_numpy(ids), gsz)
    np.testing.assert_allclose(got.numpy()[:gsz - 1], want[:gsz - 1],
                               rtol=1e-10, atol=1e-9)
    # the dead segment is skipped, not accumulated
    assert (got.numpy()[gsz - 1] == 0).all()


def test_segment_sum_skips_dead_and_out_of_range_rows():
    plane = torch.ones((6, 2), dtype=torch.float64)
    ids = torch.tensor([0, 1, 3, 3, -1, 7], dtype=torch.int32)
    out = sk.segment_sum(plane, ids, 4)
    assert out.tolist() == [[1, 1], [1, 1], [0, 0], [0, 0]]


@pytest.mark.parametrize("want_min,want_max,want_sumsq", [
    (True, True, False),
    (False, False, True),
    (True, True, True),
    (False, False, False),
])
@pytest.mark.parametrize("n,f,gsz", [
    (600, 3, 61),
    (257, 1, 9),
    (90, 4, 50),
])
def test_fused_plain_matches_pallas(n, f, gsz, want_min, want_max,
                                    want_sumsq):
    vals, ids = _inputs(n, f, gsz, seed=3 * n + f, nan_frac=0.15,
                        empty=(2,))
    want = pallas_fused_segment_agg(
        jnp.asarray(vals), jnp.asarray(ids), gsz, want_min=want_min,
        want_max=want_max, want_sumsq=want_sumsq, interpret=True)
    got = sk.fused_segment_agg(torch.from_numpy(vals), torch.from_numpy(ids),
                               gsz, want_min, want_max, want_sumsq)
    live = slice(0, gsz - 1)
    np.testing.assert_allclose(got["sum"].numpy()[live],
                               np.asarray(want["sum"])[live],
                               rtol=1e-10, atol=1e-9)
    np.testing.assert_array_equal(got["count"].numpy()[live],
                                  np.asarray(want["count"])[live])
    np.testing.assert_array_equal(got["rows"].numpy()[live],
                                  np.asarray(want["rows"])[live])
    for k in ("min", "max"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy()[live],
                                          np.asarray(want[k])[live])
        else:
            assert k not in got
    if want_sumsq:
        np.testing.assert_allclose(got["sumsq"].numpy()[live],
                                   np.asarray(want["sumsq"])[live],
                                   rtol=1e-10, atol=1e-9)
    # empty and dead groups: 0 counts and +-inf extremes
    assert got["count"][2].sum() == 0 and got["rows"][2] == 0
    assert got["rows"][gsz - 1] == 0
    if want_min:
        assert torch.isinf(got["min"][2]).all()


def test_fused_all_null_group_keeps_rows():
    vals = torch.tensor([[np.nan], [np.nan], [1.0]], dtype=torch.float64)
    ids = torch.tensor([0, 0, 1], dtype=torch.int32)
    out = sk.fused_segment_agg(vals, ids, 3, want_min=True, want_max=True)
    assert out["rows"].tolist() == [2, 1, 0]
    assert out["count"][:, 0].tolist() == [0, 1, 0]
    assert out["min"][0, 0] == float("inf") and out["max"][0, 0] == -float("inf")


@pytest.mark.parametrize("bad", [
    lambda: (torch.ones((4, 2), dtype=torch.int64),
             torch.zeros(4, dtype=torch.int32)),
    lambda: (torch.ones((4, 2)), torch.zeros(4, dtype=torch.int64)),
    lambda: (torch.ones(4), torch.zeros(4, dtype=torch.int32)),
    lambda: (torch.ones((4, 2)), torch.zeros(3, dtype=torch.int32)),
    lambda: (torch.ones((2, 4)).t(), torch.zeros(4, dtype=torch.int32)),
])
@pytest.mark.parametrize("kernel", ["segment_sum", "fused_segment_agg"])
def test_wrappers_refuse_bad_inputs(kernel, bad):
    vals, ids = bad()
    with pytest.raises((TypeError, ValueError)):
        getattr(sk, kernel)(vals, ids, 3)


def test_cpu_tensors_never_count_as_launches():
    before = (sk.segment_sum.launches, sk.fused_segment_agg.launches)
    x = torch.ones((8, 2), dtype=torch.float64)
    ids = torch.zeros(8, dtype=torch.int32)
    sk.segment_sum(x, ids, 2)
    sk.fused_segment_agg(x, ids, 2)
    assert (sk.segment_sum.launches, sk.fused_segment_agg.launches) == before
