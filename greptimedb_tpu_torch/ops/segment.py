"""Segment reductions: the group-by of the port (counterpart of
greptimedb_tpu/ops/segment.py).

Group-by over dictionary-encoded tags and time buckets is a segment
reduction: group ids are computed arithmetically from dense int keys,
then reduced by segment. Masked and padding rows go to a dead segment;
NaN field values are SQL NULL and excluded from sum/count/min/max/avg.

`segment_agg` is the plain PyTorch reduction every op runs through off
the two kernel paths; `dense_segment_sum` routes the prepared planes to
the CUDA segment-sum kernel (ops/segment_kernels.py) on a CUDA tensor.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from greptimedb_tpu_torch.ops import segment_kernels

def time_bucket(ts: torch.Tensor, interval: int, origin: int = 0) -> torch.Tensor:
    """Floor-align int64 timestamps into buckets of `interval` (same
    unit); floor division, so timestamps before the origin bucket as SQL
    date_bin does."""
    return torch.div(ts - origin, interval, rounding_mode="floor")


def combine_group_ids(keys: Sequence[torch.Tensor], sizes: Sequence[int],
                      dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Fuse dense int keys into one dense id: ((k0 * s1 + k1) * s2 + k2)...
    Row-major, so the order of the combined id is the lexicographic order
    of the keys. Use dtype=torch.int64 when the product of sizes can
    exceed 2^31."""
    if len(keys) != len(sizes) or not keys:
        raise ValueError("combine_group_ids needs one size per key")
    gid = keys[0].to(dtype)
    for k, s in zip(keys[1:], sizes[1:]):
        gid = gid * s + k.to(dtype)
    return gid


def pallas_mode() -> str:
    """GREPTIMEDB_TPU_PALLAS: `auto` (default) takes the fused route on
    CUDA; `on` also takes it on the CPU, through the fused kernel's plain
    version (how the CPU tests cover that route). It never sends a CUDA
    tensor to a plain version."""
    return os.environ.get("GREPTIMEDB_TPU_PALLAS", "auto").lower()


def dense_segment_sum(plane: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Segment sum of a prepared [N, W] plane into num_segments rows, the
    last being the dead segment (left at zero). On a CUDA tensor the
    hand-written kernel runs for any G: the TPU's G <= 4096 and
    finite-values gates belonged to its one-hot matmul."""
    return segment_kernels.segment_sum(plane, ids, num_segments)


def _identity(dtype: torch.dtype, largest: bool):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def _null_of(dtype: torch.dtype):
    return float("nan") if dtype.is_floating_point else 0


def _seg_reduce(src: torch.Tensor, ids: torch.Tensor, gsz: int, how: str,
                fill) -> torch.Tensor:
    """scatter_reduce_ of `src` ([N] or [N, F]) by `ids` into `gsz`
    segments filled with `fill` (the reduction's identity)."""
    out = torch.full((gsz,) + tuple(src.shape[1:]), fill, dtype=src.dtype,
                     device=src.device)
    idx = ids.long()
    if src.dim() == 2:
        idx = idx[:, None].expand(-1, src.shape[1])
    return out.scatter_reduce_(0, idx, src, how, include_self=True)


def _seg_sum(src: torch.Tensor, ids: torch.Tensor, gsz: int) -> torch.Tensor:
    out = torch.zeros((gsz,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    return out.index_add_(0, ids, src)


def segment_agg(
    values: torch.Tensor,  # [N] or [N, F] field values (float)
    seg_ids: torch.Tensor,  # [N] int32 dense group ids
    mask: torch.Tensor,  # [N] bool validity (padding & filter)
    num_segments: int,
    ops: tuple = ("sum", "count"),
    ts: Optional[torch.Tensor] = None,  # [N] int64, required for first/last
) -> dict:
    """Masked segment reduction. Returns {op: [G] or [G, F]}.

    NULL handling: NaN values are excluded per element (SQL aggregate
    semantics); `mask` excludes whole rows (padding / WHERE / dedup)."""
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    n = values.shape[0]
    dev = values.device
    row_mask = mask
    if values.dtype.is_floating_point:
        elem_mask = row_mask[:, None] & ~torch.isnan(values)
    else:
        elem_mask = row_mask[:, None].expand(values.shape)
    # invalid rows go to a dead segment G (G+1 are allocated, one dropped)
    ids = torch.where(row_mask, seg_ids.to(torch.int32),
                      torch.full_like(seg_ids, num_segments, dtype=torch.int32))
    gsz = num_segments + 1
    zero = torch.zeros((), dtype=values.dtype, device=dev)

    out: dict = {}
    need_sum = any(o in ops for o in ("sum", "mean"))
    need_count = any(o in ops for o in ("count", "mean"))
    # variance = (sumsq - sum^2/n) cancels catastrophically: both moments
    # accumulate in f64 whatever the compute dtype
    moment_vals = values
    if ("sumsq" in ops and values.dtype.is_floating_point
            and values.dtype != torch.float64):
        moment_vals = values.to(torch.float64)
    sums = counts = None
    if need_sum or "sumsq" in ops:
        sums = _seg_sum(torch.where(elem_mask, moment_vals,
                                    zero.to(moment_vals.dtype)), ids, gsz)
    if need_count:
        # int32: exact per block; the cross-block combine upcasts to int64
        counts = _seg_sum(elem_mask.to(torch.int32), ids, gsz)
    if "sum" in ops:
        out["sum"] = sums
    if "count" in ops:
        out["count"] = counts
    if "rows" in ops:
        out["rows"] = _seg_sum(row_mask.to(torch.int32)[:, None], ids, gsz)
    if "sumsq" in ops:
        out["sumsq"] = _seg_sum(
            torch.where(elem_mask, moment_vals * moment_vals,
                        zero.to(moment_vals.dtype)), ids, gsz)
    if "mean" in ops:
        denom = torch.clamp(counts, min=1).to(values.dtype)
        mean = sums.to(values.dtype) / denom
        out["mean"] = torch.where(counts > 0, mean,
                                  torch.full_like(mean, float("nan")))
    if "min" in ops:
        big = _identity(values.dtype, largest=True)
        mins = _seg_reduce(torch.where(elem_mask, values,
                                       torch.full_like(values, big)),
                           ids, gsz, "amin", big)
        out["min"] = torch.where(mins == big,
                                 torch.full_like(mins, _null_of(values.dtype)),
                                 mins)
    if "max" in ops:
        small = _identity(values.dtype, largest=False)
        maxs = _seg_reduce(torch.where(elem_mask, values,
                                       torch.full_like(values, small)),
                           ids, gsz, "amax", small)
        out["max"] = torch.where(maxs == small,
                                 torch.full_like(maxs, _null_of(values.dtype)),
                                 maxs)
    if "first" in ops or "last" in ops:
        if ts is None:
            raise ValueError("first/last need the time column")
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        i64 = torch.iinfo(torch.int64)
        null = torch.full((), _null_of(values.dtype), dtype=values.dtype,
                          device=dev)
        if "last" in ops:
            # argmax of ts per segment; ties go to the highest row index
            best_ts = _seg_reduce(
                torch.where(row_mask, ts, torch.full_like(ts, i64.min)),
                ids, gsz, "amax", i64.min)
            at_best = row_mask & (ts == best_ts[ids.long()])
            best_idx = _seg_reduce(
                torch.where(at_best, idx, torch.full_like(idx, -1)),
                ids, gsz, "amax", -1)
            vals = values[best_idx.clamp(0, max(n - 1, 0))] if n else \
                values.new_zeros((gsz, values.shape[1]))
            out["last"] = torch.where(best_idx[:, None] >= 0, vals, null)
            out["last_ts"] = best_ts
        if "first" in ops:
            # argmin of ts per segment; ties go to the lowest row index,
            # the mirror of `last` (the JAX package's rule)
            best_ts = _seg_reduce(
                torch.where(row_mask, ts, torch.full_like(ts, i64.max)),
                ids, gsz, "amin", i64.max)
            at_best = row_mask & (ts == best_ts[ids.long()])
            best_idx = _seg_reduce(
                torch.where(at_best, idx, torch.full_like(idx, n)),
                ids, gsz, "amin", n)
            vals = values[best_idx.clamp(0, max(n - 1, 0))] if n else \
                values.new_zeros((gsz, values.shape[1]))
            out["first"] = torch.where(best_idx[:, None] < n, vals, null)
            out["first_ts"] = best_ts

    # drop the dead segment; restore the caller's rank
    trimmed = {}
    for k, v in out.items():
        v = v[:num_segments]
        if squeeze and v.dim() == 2:
            v = v[:, 0]
        trimmed[k] = v
    return trimmed


#: segment_agg ops that K2 computes; first/last stay on the torch code
_FUSED_OPS = frozenset({"sum", "count", "rows", "min", "max", "sumsq",
                        "mean"})


def segment_agg_fused(
    values: torch.Tensor,  # [N] or [N, F] float field values
    seg_ids: torch.Tensor,  # [N] int32 dense group ids
    mask: torch.Tensor,  # [N] bool validity
    num_segments: int,
    ops: tuple = ("sum", "count"),
    ts: Optional[torch.Tensor] = None,  # [N] int64, required for first/last
) -> dict:
    """`segment_agg`'s contract through one K2 call
    (segment_kernels.fused_segment_agg) over num_segments + 1 segments,
    the dead segment last: masked rows go there. sum, count, rows, min,
    max, sumsq and mean come from K2; first and last from segment_agg's
    torch code. K2's +inf min and -inf max of an empty group become NaN, as
    segment_agg's `mins == big` does (so a group whose values are all
    +inf has a NaN min there too). The PromQL window and label
    reductions and RANGE ... ALIGN's windows call it; the other SQL
    routes call the kernels themselves."""
    if not values.dtype.is_floating_point:
        raise TypeError(f"segment_agg_fused: float values only, got "
                        f"{values.dtype}")
    squeeze = values.dim() == 1
    vals = values[:, None] if squeeze else values
    if "sumsq" in ops and vals.dtype != torch.float64:
        # the moments accumulate in f64 whatever the compute dtype
        vals = vals.to(torch.float64)
    out: dict = {}
    if _FUSED_OPS.intersection(ops):
        dead = torch.full_like(seg_ids, num_segments, dtype=torch.int32)
        ids = torch.where(mask, seg_ids.to(torch.int32), dead)
        k2 = segment_kernels.fused_segment_agg(
            vals.contiguous(), ids.contiguous(), num_segments + 1,
            want_min="min" in ops, want_max="max" in ops,
            want_sumsq="sumsq" in ops)
        counts = k2["count"][:num_segments]
        for op in ("sum", "count", "sumsq"):
            if op in ops:
                out[op] = k2[op][:num_segments]
        if "rows" in ops:
            # [G, 1], as segment_agg gives it for [N, F] values
            out["rows"] = k2["rows"][:num_segments, None]
        if "mean" in ops:
            denom = torch.clamp(counts, min=1).to(vals.dtype)
            mean = k2["sum"][:num_segments] / denom
            out["mean"] = torch.where(counts > 0, mean,
                                      torch.full_like(mean, float("nan")))
        for op, empty in (("min", float("inf")), ("max", float("-inf"))):
            if op in ops:
                x = k2[op][:num_segments]
                out[op] = torch.where(x == empty,
                                      torch.full_like(x, float("nan")), x)
        if squeeze:
            out = {k: v[:, 0] for k, v in out.items()}
    rest = tuple(o for o in ops if o in ("first", "last"))
    if rest:
        out.update(segment_agg(values, seg_ids, mask, num_segments,
                               ops=rest, ts=ts))
    return out
