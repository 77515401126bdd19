"""Windowed (range-vector) ops over a regular evaluation grid
(counterpart of greptimedb_tpu/ops/window.py), as plain functions on
torch tensors.

Samples are bucketed onto the step grid with one segment reduction,
then:

  - window sums/counts  = cumulative-sum differences along the bucket axis
  - last/first sample   = latest/earliest-nonempty-bucket gathers (cummax /
                          reverse-cummin) + exact timestamp validation
  - window min/max      = w-step unrolled running fmin/fmax over bucket mins

The bucket reduction is `segment_agg_fused`: one K2 call
(ops/segment_kernels.py) for sums, counts, mins and maxes, torch scatter
for first/last. Range windows require the range to be a multiple of the
step (buckets tile windows exactly); instant-selector lookback is exact
for any length because the gathered last-sample timestamp is
re-validated against the true window edge.

Shapes: samples [N] -> bucket grid [S, B, C] -> windows [S, T, C], where
S = series, T = eval steps, B = T + w buckets, C = value channels.
Times are float64 seconds.
"""

from __future__ import annotations

import torch

from greptimedb_tpu_torch.ops.segment import segment_agg_fused

BIG = torch.iinfo(torch.int32).max
_I64 = torch.iinfo(torch.int64)
_NAN = float("nan")


def window_stats(
    sidx: torch.Tensor,  # [N] int32 series index
    ts: torch.Tensor,  # [N] float64 sample time (seconds)
    channels: torch.Tensor,  # [N, C] float value channels
    valid: torch.Tensor,  # [N] bool
    t0: float,  # first eval timestamp (seconds)
    step: float,  # eval step (seconds)
    num_series: int,
    num_steps: int,
    w: int,  # window length in steps
    stats: tuple = ("sum", "count", "last"),
    sorted_input: bool = False,
) -> dict:
    """Per-(series, eval-step) window statistics. Window j covers
    (t0 + (j-w)*step, t0 + j*step], i.e. w whole step-buckets ending at
    eval time j. Outputs [S, T, C] (ts outputs [S, T]).

    sorted_input=True asserts rows are sorted by (series, ts) and
    bucketizes with cumulative-sum differences and boundary gathers
    over searchsorted bucket edges instead of one segment reduction
    (the JAX package's TPU flavour)."""
    S, T, B = num_series, num_steps, num_steps + w
    n, C = channels.shape
    dev = channels.device

    # bucket: a sample at exactly an eval time belongs to that step's
    # bucket; the clamp keeps far-off samples out of range before the
    # int cast
    q = torch.ceil(true_div(ts - t0, step)).clamp(-w, B)
    b = q.to(torch.int32) + (w - 1)
    ok = valid & (b >= 0) & (b < B)

    seg_ops = []
    if "sum" in stats or "count" in stats:
        seg_ops += ["sum", "count"]
    for op in ("last", "first", "min", "max"):
        if op in stats:
            seg_ops.append(op)
    seg_ops = tuple(seg_ops)
    if sorted_input:
        per_bucket = _bucketize_sorted(sidx, ts, channels, ok, b, S, B,
                                       seg_ops)
    else:
        gid = torch.where(ok, sidx.to(torch.int32) * B + b,
                          torch.full_like(b, S * B))
        edge = "first" in seg_ops or "last" in seg_ops
        per_bucket = segment_agg_fused(
            channels, gid, ok, S * B, ops=seg_ops,
            ts=_ts_to_int(ts) if edge else None)

    out: dict = {}
    j = torch.arange(T, device=dev)
    buckets = torch.arange(B, device=dev)

    def grid(x, c=None):
        return x.reshape(S, B) if c is None else x.reshape(S, B, c)

    bcount = grid(per_bucket["count"], C) if "count" in per_bucket else None

    if "sum" in stats:
        cs = exclusive_cumsum(grid(per_bucket["sum"], C))
        out["sum"] = cs[:, w:w + T] - cs[:, 0:T]
    if "count" in stats:
        cc = exclusive_cumsum(bcount.to(torch.int64))
        out["count"] = cc[:, w:w + T] - cc[:, 0:T]

    nonempty = None
    if bcount is not None:
        nonempty = bcount[:, :, 0] > 0  # row presence: channel 0 mask
    if "last" in stats:
        lv = grid(per_bucket["last"], C)
        lt = grid(per_bucket["last_ts"])
        nb = torch.where(nonempty, buckets[None, :], -1)
        lb = torch.cummax(nb, dim=1).values[:, w - 1:w - 1 + T]  # [S, T]
        has = lb >= j[None, :]
        safe = lb.clamp(0, B - 1)
        lval = torch.gather(lv, 1, safe[:, :, None].expand(-1, -1, C))
        lts = _ts_to_float(torch.gather(lt, 1, safe))
        out["last"] = torch.where(has[:, :, None], lval, _NAN)
        out["last_ts"] = torch.where(has, lts, float("-inf"))
    if "first" in stats:
        fv = grid(per_bucket["first"], C)
        ft = grid(per_bucket["first_ts"])
        fb = torch.where(nonempty, buckets[None, :], BIG)
        earliest = torch.flip(
            torch.cummin(torch.flip(fb, (1,)), dim=1).values, (1,))
        fbj = earliest[:, 0:T]
        has = fbj <= (j[None, :] + w - 1)
        safe = fbj.clamp(0, B - 1)
        fval = torch.gather(fv, 1, safe[:, :, None].expand(-1, -1, C))
        fts = _ts_to_float(torch.gather(ft, 1, safe))
        out["first"] = torch.where(has[:, :, None], fval, _NAN)
        out["first_ts"] = torch.where(has, fts, float("inf"))
    for op, fold in (("min", torch.fmin), ("max", torch.fmax)):
        if op in stats:
            bx = grid(per_bucket[op], C)
            acc = bx[:, 0:T]
            for k in range(1, w):
                acc = fold(acc, bx[:, k:k + T])
            out[op] = acc
    return out


def _bucketize_sorted(sidx, ts, channels, ok, b, S, B, seg_ops):
    """Per-bucket stats for (series, ts)-SORTED samples, matching
    segment_agg's output contract over gsz = S*B segments.

    Valid rows' bucket ids are non-decreasing, so bucket edges come from
    one searchsorted over a monotone id envelope (cummax carries the last
    valid id across invalid rows), sums/counts are cumulative-sum
    differences and first/last rows are gathers at the edges. min/max
    keep the segment reduction (K2)."""
    n, C = channels.shape
    dev = channels.device
    gsz = S * B
    gid = sidx.to(torch.int64) * B + b.to(torch.int64)
    gid_mono = torch.cummax(torch.where(ok, gid, -1), dim=0).values
    targets = torch.arange(gsz, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(gid_mono, targets, right=False)
    ends = torch.searchsorted(gid_mono, targets, right=True)
    zero1 = torch.zeros(1, dtype=torch.int64, device=dev)
    okc = torch.cat([zero1, torch.cumsum(ok.to(torch.int64), 0)])
    present = (okc[ends] - okc[starts]) > 0

    per_bucket: dict = {}
    if "sum" in seg_ops or "count" in seg_ops:
        elem = ok[:, None] & ~torch.isnan(channels)
        zc = torch.where(elem, channels, torch.zeros((), dtype=channels.dtype,
                                                     device=dev))
        cs = torch.cat([torch.zeros((1, C), dtype=zc.dtype, device=dev),
                        torch.cumsum(zc, 0)])
        per_bucket["sum"] = cs[ends] - cs[starts]
        ec = torch.cat([torch.zeros((1, C), dtype=torch.int64, device=dev),
                        torch.cumsum(elem.to(torch.int64), 0)])
        per_bucket["count"] = ec[ends] - ec[starts]
    idxs = torch.arange(n, dtype=torch.int64, device=dev)
    ts_int = _ts_to_int(ts)
    if "last" in seg_ops:
        lastpos = torch.cummax(torch.where(ok, idxs, -1), dim=0).values
        li = lastpos[(ends - 1).clamp(0, n - 1)]
        pv = present & (li >= 0)
        safe = li.clamp(0, n - 1)
        per_bucket["last"] = torch.where(pv[:, None], channels[safe], _NAN)
        per_bucket["last_ts"] = torch.where(pv, ts_int[safe], _I64.min)
    if "first" in seg_ops:
        firstpos = torch.flip(torch.cummin(
            torch.flip(torch.where(ok, idxs, n), (0,)), dim=0).values, (0,))
        fi = firstpos[starts.clamp(0, n - 1)]
        pv = present & (fi < n)
        safe = fi.clamp(0, n - 1)
        per_bucket["first"] = torch.where(pv[:, None], channels[safe], _NAN)
        per_bucket["first_ts"] = torch.where(pv, ts_int[safe], _I64.max)
    mm = tuple(o for o in ("min", "max") if o in seg_ops)
    if mm:
        gid32 = torch.where(ok, gid, gsz).to(torch.int32)
        per_bucket.update(segment_agg_fused(channels, gid32, ok, gsz, ops=mm))
    return per_bucket


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. On CUDA, torch divides
    by a Python (CPU) scalar as a multiplication by its reciprocal, which
    is one rounding off: a sample exactly on a bucket edge, (ts - t0) / step
    = k, can come out a hair above k and land in the next bucket. A
    divisor on the tensor's device divides per element, as numpy and XLA
    do."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _ts_to_int(ts: torch.Tensor) -> torch.Tensor:
    # segment first/last need an integer time key; milliseconds keeps
    # ordering at PromQL resolution
    return (ts * 1000.0).to(torch.int64)


def _ts_to_float(t_int: torch.Tensor) -> torch.Tensor:
    return true_div(t_int.to(torch.float64), 1000.0)


def counter_adjust(sidx_sorted: torch.Tensor,
                   values_sorted: torch.Tensor) -> torch.Tensor:
    """Reset-corrected counter values. Input MUST be sorted by (series,
    ts). adjusted[i] = v[i] + cumulative resets before i; within-series
    differences of `adjusted` equal PromQL's reset-corrected deltas."""
    v, s = values_sorted, sidx_sorted
    prev_v = torch.cat([v[:1], v[:-1]])
    prev_s = torch.cat([s[:1], s[:-1]])
    reset = torch.where((s == prev_s) & (v < prev_v), prev_v,
                        torch.zeros((), dtype=v.dtype, device=v.device))
    # a global cumsum is per-series-correct for differences: rows are
    # series-contiguous
    return v + torch.cumsum(reset, 0)


def extrapolated_delta(first_val, first_ts, last_val, last_ts, count,
                       window_start, window_end, is_counter: bool,
                       is_rate: bool, range_s: float = 1.0):
    """PromQL extrapolation (reference extrapolate_rate.rs:85-92): the
    raw last-first delta is extrapolated toward the window edges, limited
    to half an average sample interval when the edge is far. All inputs
    [S, T] (broadcastable)."""
    sampled = last_ts - first_ts
    delta = last_val - first_val
    cnt = count.to(first_val.dtype)
    ok = (cnt >= 2) & (sampled > 0)
    avg_interval = sampled / torch.clamp(cnt - 1, min=1)
    to_start = first_ts - window_start
    to_end = window_end - last_ts
    if is_counter:
        # counters can't be negative: limit start extrapolation to the
        # zero crossing
        slope = delta / torch.clamp(sampled, min=1e-10)
        zero_limit = torch.where(slope > 0, first_val / slope,
                                 float("inf"))
        to_start = torch.minimum(to_start, zero_limit)
    threshold = avg_interval * 1.1
    ext_start = torch.where(to_start < threshold, to_start, avg_interval / 2)
    ext_end = torch.where(to_end < threshold, to_end, avg_interval / 2)
    factor = (sampled + ext_start + ext_end) / torch.clamp(sampled,
                                                           min=1e-10)
    result = delta * factor
    if is_rate:
        result = true_div(result, range_s)
    return torch.where(ok, result, _NAN)


def window_edges(
    sidx: torch.Tensor,  # [N] int32 series index, sorted major
    ts: torch.Tensor,  # [N] float64 sample time (seconds), sorted within
    channels: torch.Tensor,  # [N, C] float value channels (NaN-free)
    t0: float,
    step: float,
    num_series: int,
    num_steps: int,
    w: int,
) -> dict:
    """first/last/count per (series, eval-window) via composite-key
    searchsorted: two binary-search probes into one monotone
    (series, ts) key per window. Window j covers
    (t0 + (j-w)·step, t0 + j·step], matching window_stats. Requires
    NaN-free channels. Returns {"first": [S,T,C], "first_ts": [S,T],
    "last": [S,T,C], "last_ts": [S,T], "count": [S,T,1]}."""
    S, T = num_series, num_steps
    n, C = channels.shape
    dev = channels.device
    f64 = torch.float64
    ts = ts.to(f64)
    base = ts.min()
    # series band width: larger than any in-band offset OR window edge
    K = (ts.max() - base) + (num_steps + w + 2) * abs(step) + 2.0
    key = (sidx.to(f64) * K + (ts - base)).contiguous()
    j = torch.arange(T, dtype=f64, device=dev)

    def clip_band(x):
        # an out-of-range window must not probe a neighbouring series
        return torch.minimum(x.clamp(min=-0.5), K - 1.0)

    lo_off = clip_band(t0 + (j - w) * step - base)
    hi_off = clip_band(t0 + j * step - base)
    s_base = torch.arange(S, dtype=f64, device=dev) * K
    i0 = torch.searchsorted(  # first sample with ts > lo (exclusive edge)
        key, (s_base[:, None] + lo_off[None, :]).reshape(-1),
        right=True).reshape(S, T)
    i1 = torch.searchsorted(  # one past the last sample with ts <= hi
        key, (s_base[:, None] + hi_off[None, :]).reshape(-1),
        right=True).reshape(S, T)
    count = i1 - i0
    has = count > 0
    fi = i0.clamp(0, max(n - 1, 0))
    li = (i1 - 1).clamp(0, max(n - 1, 0))
    return {"first": torch.where(has[..., None], channels[fi], _NAN),
            "first_ts": torch.where(has, ts[fi], _NAN),
            "last": torch.where(has[..., None], channels[li], _NAN),
            "last_ts": torch.where(has, ts[li], _NAN),
            "count": count.to(torch.int64)[..., None]}


def _grid_probes(grid, t0, step, num_steps, w):
    """(i0, i1): per eval window, the first grid index past its
    exclusive lower edge and one past its last index."""
    j = torch.arange(num_steps, dtype=torch.float64, device=grid.device)
    i0 = torch.searchsorted(grid, t0 + (j - w) * step, right=True)
    i1 = torch.searchsorted(grid, t0 + j * step, right=True)
    return i0, i1


def window_edges_grid(
    grid: torch.Tensor,  # [P] float64 shared sample grid (seconds, sorted)
    mat: torch.Tensor,  # [S, P, C] values pivoted onto the grid (NaN-free)
    t0: float,
    step: float,
    num_steps: int,
    w: int,
) -> dict:
    """window_edges when every series shares ONE complete sample grid:
    window edges become T probes into the [P] grid, and first/last are
    column gathers from the pivoted matrix. Same output contract as
    window_edges."""
    S, P, C = mat.shape
    T = num_steps
    i0, i1 = _grid_probes(grid, t0, step, T, w)
    count = i1 - i0  # [T], identical for every series (complete grid)
    has = count > 0
    fi = i0.clamp(0, max(P - 1, 0))
    li = (i1 - 1).clamp(0, max(P - 1, 0))
    return {
        "first": torch.where(has[None, :, None], mat[:, fi, :], _NAN),
        "first_ts": torch.where(has, grid[fi], _NAN)[None, :].expand(S, T),
        "last": torch.where(has[None, :, None], mat[:, li, :], _NAN),
        "last_ts": torch.where(has, grid[li], _NAN)[None, :].expand(S, T),
        "count": count.to(torch.int64)[None, :, None].expand(S, T, 1)}


def window_sums_grid(
    grid: torch.Tensor,  # [P] float64 shared sample grid (seconds, sorted)
    cs: torch.Tensor,  # [S, P+1, C] exclusive prefix sums over the pivot
    t0: float,
    step: float,
    num_steps: int,
    w: int,
) -> dict:
    """Window sums/counts on a complete shared grid: every (window,
    series) sum is a two-gather difference of the cached prefix sums.
    Window j covers (t0 + (j-w)·step, t0 + j·step]."""
    S = cs.shape[0]
    T = num_steps
    i0, i1 = _grid_probes(grid, t0, step, T, w)
    count = i1 - i0
    return {"sum": cs[:, i1, :] - cs[:, i0, :],
            "count": count.to(torch.int64)[None, :, None].expand(S, T, 1)}


def exclusive_cumsum(mat: torch.Tensor) -> torch.Tensor:
    """[S, P, C] -> [S, P+1, C] exclusive prefix sums along axis 1."""
    S, _, C = mat.shape
    return torch.cat([torch.zeros((S, 1, C), dtype=mat.dtype,
                                  device=mat.device),
                      torch.cumsum(mat, dim=1)], dim=1)
