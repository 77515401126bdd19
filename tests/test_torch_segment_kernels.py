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


def _layout_ids(layout, n, gsz, rng, dead_frac=0.1):
    """Group ids in the orders the CUDA kernel branches on (its window,
    sorted-chunk and run paths): a time-major host x hour scan (ids rise
    row by row within a timestamp), run-major buckets (long runs of one
    id), host-major rows (ids jump by a bucket's width every row), and ids
    below 0 or at and past G, which every side skips."""
    r = np.arange(n)
    if layout == "time_major":  # 30 hosts, id = hour * 31 + host + 1
        ids = (r // 30 // 4) * 31 + r % 30 + 1
    elif layout == "run_major":  # runs of 50 rows, buckets cycling
        ids = r // 50 % (gsz - 1)
    elif layout == "host_major":  # 3 hours a host, hour varies fastest
        ids = (r % 3) * 31 + (r // 3) % 30 + 1
    else:  # out_of_range: random ids, a share below 0 or >= G
        ids = rng.integers(0, gsz - 1, n)
        bad = rng.uniform(0, 1, n)
        ids[bad < 0.1] = -rng.integers(1, 5, n)[bad < 0.1]
        ids[bad > 0.9] = gsz + rng.integers(0, 20, n)[bad > 0.9]
    ids = ids.astype(np.int32)
    ids[rng.uniform(0, 1, n) < dead_frac] = gsz - 1
    return ids


@pytest.mark.parametrize("n,w,gsz,layout", [
    # single-groupby plane: 2F+1 lanes, 60 buckets + dead
    pytest.param(1000, 21, 61, "random", id="1000-21-61"),
    # no-NaN plane width, ragged rows
    pytest.param(777, 11, 9, "random", id="777-11-9"),
    # more groups than rows: empty groups
    pytest.param(300, 1, 400, "random", id="300-1-400"),
    pytest.param(5, 3, 8, "random", id="5-3-8"),  # tiny
    pytest.param(360, 11, 94, "time_major", id="time_major-360-11-94"),
    pytest.param(600, 21, 7, "run_major", id="run_major-600-21-7"),
    pytest.param(360, 11, 94, "host_major", id="host_major-360-11-94"),
    pytest.param(500, 11, 40, "out_of_range", id="out_of_range-500-11-40"),
])
def test_segment_sum_plain_matches_pallas(n, w, gsz, layout):
    if layout == "random":
        plane, ids = _inputs(n, w, gsz, seed=n + w + gsz)
    else:
        rng = np.random.default_rng(n + w + gsz)
        plane = np.round(rng.uniform(-50, 50, (n, w)), 1)
        ids = _layout_ids(layout, n, gsz, rng)
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
@pytest.mark.parametrize("n,f,gsz,layout", [
    pytest.param(600, 3, 61, "random", id="600-3-61"),
    pytest.param(257, 1, 9, "random", id="257-1-9"),
    pytest.param(90, 4, 50, "random", id="90-4-50"),
    pytest.param(360, 3, 94, "time_major", id="time_major-360-3-94"),
    pytest.param(600, 2, 7, "run_major", id="run_major-600-2-7"),
    pytest.param(360, 3, 94, "host_major", id="host_major-360-3-94"),
    pytest.param(500, 3, 40, "out_of_range", id="out_of_range-500-3-40"),
    # runs of one id with 30 % of rows masked at random: the kernel's
    # warps mix live and dead lanes
    pytest.param(700, 2, 9, "masked_runs", id="masked_runs-700-2-9"),
])
def test_fused_plain_matches_pallas(n, f, gsz, layout, want_min, want_max,
                                    want_sumsq):
    if layout == "random":
        vals, ids = _inputs(n, f, gsz, seed=3 * n + f, nan_frac=0.15,
                            empty=(2,))
    else:
        rng = np.random.default_rng(3 * n + f)
        vals = np.round(rng.uniform(-50, 50, (n, f)), 1)
        vals[rng.uniform(0, 1, (n, f)) < 0.15] = np.nan
        masked = layout == "masked_runs"
        ids = _layout_ids("run_major" if masked else layout, n, gsz, rng,
                          dead_frac=0.3 if masked else 0.1)
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
    if layout == "random":
        assert got["count"][2].sum() == 0 and got["rows"][2] == 0
        if want_min:
            assert torch.isinf(got["min"][2]).all()
    assert got["rows"][gsz - 1] == 0 and got["count"][gsz - 1].sum() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g,f", [(7, 3), (61, 1)])
@pytest.mark.parametrize("flags", range(8))
def test_fused_outputs_share_one_aligned_buffer(flags, g, f, dtype):
    """K2's one output buffer: a contiguous, 16-byte-aligned view of the
    right shape and dtype for each output, in the dict order callers have
    always seen, no two views overlapping."""
    want = ["sum", "count", "rows"] + [k for k, bit in (
        ("min", 1), ("max", 2), ("sumsq", 4)) if flags & bit]
    buf, out = sk._fused_outputs(torch.zeros((5, f), dtype=dtype), g, flags)
    assert list(out) == want
    end = buf.data_ptr() + buf.numel() * buf.element_size()
    for k, x in out.items():
        assert x.is_contiguous()
        assert x.data_ptr() % 16 == 0
        assert buf.data_ptr() <= x.data_ptr()
        assert x.data_ptr() + x.numel() * x.element_size() <= end
        assert x.shape == ((g,) if k == "rows" else (g, f))
        assert x.dtype == (torch.int32 if k in ("count", "rows") else dtype)
    for i, x in enumerate(out.values()):
        x.fill_(i + 1)
    for i, x in enumerate(out.values()):
        assert (x == i + 1).all(), list(out)[i]


def test_fused_empty_input_keeps_identities():
    vals = torch.zeros((0, 2), dtype=torch.float32)
    out = sk.fused_segment_agg(vals, torch.zeros(0, dtype=torch.int32), 3,
                               want_min=True, want_max=True, want_sumsq=True)
    assert out["sum"].eq(0).all() and out["sumsq"].eq(0).all()
    assert out["count"].eq(0).all() and out["rows"].eq(0).all()
    assert out["min"].eq(float("inf")).all()
    assert out["max"].eq(float("-inf")).all()


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
