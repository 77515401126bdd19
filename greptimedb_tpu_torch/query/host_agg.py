"""Order-statistic aggregates computed host-side (mirrors reference
common/function UDAFs: argmax, argmin, percentile, median, polyval —
src/common/function/src/scalars/aggregate/).

These need the full value multiset per group (not a streaming segment
reduction), so they run as a vectorized numpy pass over the scan's host
columns — sort rows by (group, value) once, then per-group answers come
from segment boundaries. The device segment kernels stay untouched for
the hot streaming aggregates; host aggs compose with them in one query.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: aggregate funcs routed through this module
HOST_AGGS = frozenset({"argmax", "argmin", "median", "percentile", "polyval"})


def compute_host_agg(func: str, gid: np.ndarray, values: np.ndarray,
                     mask: np.ndarray, num_groups: int,
                     extra: tuple = ()) -> np.ndarray:
    """Return a per-group array (length num_groups) for `func`.

    gid: int group id per row; values: float per row; mask: row validity.
    Rows with NaN values are excluded (SQL NULL semantics).
    """
    values = np.asarray(values, dtype=np.float64)
    valid = mask & ~np.isnan(values)
    gid_v = gid[valid]
    val_v = values[valid]
    idx_v = np.flatnonzero(valid)

    out = np.full(num_groups, np.nan)
    if gid_v.size == 0:
        return out

    if func in ("argmax", "argmin"):
        # sort by (gid, value); last row of each group's run is the max.
        # lexsort is stable, so ties resolve to the later row for argmax
        # (matching "last occurrence of the extreme") and the earlier row
        # for argmin via the reversed value order.
        order = np.lexsort((idx_v, val_v, gid_v))
        g_sorted = gid_v[order]
        # last position of each gid run
        last = np.flatnonzero(np.r_[g_sorted[1:] != g_sorted[:-1], True])
        first = np.r_[0, last[:-1] + 1]
        pick = last if func == "argmax" else first
        out[g_sorted[pick]] = idx_v[order][pick]
        return out

    if func in ("median", "percentile"):
        q = float(extra[0]) if func == "percentile" else 50.0
        if not 0.0 <= q <= 100.0:
            from greptimedb_tpu_torch.query.expr import PlanError
            raise PlanError(f"percentile {q} out of [0, 100]")
        order = np.lexsort((val_v, gid_v))
        g_sorted = gid_v[order]
        v_sorted = val_v[order]
        last = np.flatnonzero(np.r_[g_sorted[1:] != g_sorted[:-1], True])
        first = np.r_[0, last[:-1] + 1]
        counts = last - first + 1
        # linear interpolation at q/100 * (n-1), vectorized over groups
        pos = first + (q / 100.0) * (counts - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.ceil(pos).astype(np.int64)
        frac = pos - lo
        vals = v_sorted[lo] * (1 - frac) + v_sorted[hi] * frac
        out[g_sorted[first]] = vals
        return out

    if func == "polyval":
        # rows of each group are polynomial coefficients (highest degree
        # first, in row order); evaluate at x = extra[0]
        x = float(extra[0])
        order = np.lexsort((idx_v, gid_v))
        g_sorted = gid_v[order]
        v_sorted = val_v[order]
        last = np.flatnonzero(np.r_[g_sorted[1:] != g_sorted[:-1], True])
        first = np.r_[0, last[:-1] + 1]
        counts = last - first + 1
        pos_in_group = np.arange(g_sorted.size) - np.repeat(first, counts)
        degree = np.repeat(counts, counts) - 1 - pos_in_group
        terms = v_sorted * np.power(x, degree.astype(np.float64))
        sums = np.add.reduceat(terms, first)
        out[g_sorted[first]] = sums
        return out

    from greptimedb_tpu_torch.query.expr import PlanError
    raise PlanError(f"unknown host aggregate {func!r}")


def row_group_ids(keys, strides, scan, extra_cols) -> np.ndarray:
    """Per-row group id on host, replicating the device key formula
    (physical._agg_block): tag → code+1, bucket → col//step − base,
    pre → factorized codes."""
    some = next(iter(scan.columns.values()))
    gid = np.zeros(len(some), dtype=np.int64)
    for k, stride in zip(keys, strides):
        col = extra_cols.get(k.column)
        if col is None:
            col = scan.columns[k.column]
        col = np.asarray(col)
        if k.kind == "tag":
            arr = (col + 1).astype(np.int64)
        elif k.kind == "bucket":
            arr = (col // k.step - k.base).astype(np.int64)
        else:
            arr = col.astype(np.int64)
        gid += np.clip(arr, 0, k.size - 1) * stride
    return gid


def host_row_mask(scan, bound_where, schema, mask_len: int,
                  dedup_mask: Optional[np.ndarray]) -> np.ndarray:
    """Row validity on host: the BOUND WHERE predicate evaluated over the
    raw scan columns (tag codes, coerced ts ints — device semantics),
    plus the last-write-wins dedup mask."""
    mask = np.ones(mask_len, dtype=bool)
    if dedup_mask is not None:
        mask &= np.asarray(dedup_mask)[:mask_len]
    if bound_where is not None:
        from greptimedb_tpu_torch.query.expr import eval_host

        w = eval_host(bound_where, scan.columns, schema, None, mask_len)
        mask &= np.broadcast_to(np.asarray(w, dtype=bool), (mask_len,))
    return mask


def decoded_columns(scan) -> dict:
    """scan columns with tag codes decoded to strings (host eval space)."""
    out = {}
    for name, col in scan.columns.items():
        if name in scan.tag_dicts:
            d = scan.tag_dicts[name]
            codes = np.asarray(col)
            vals = np.empty(len(codes), dtype=object)
            ok = codes >= 0
            vals[ok] = d[codes[ok]]
            vals[~ok] = None
            out[name] = vals
        else:
            out[name] = np.asarray(col)
    return out


def compute_host_agg_str(func: str, gid: np.ndarray, values: np.ndarray,
                         ts: Optional[np.ndarray], mask: np.ndarray,
                         num_groups: int) -> np.ndarray:
    """String-typed first/last/min/max: the device segment kernel only
    reduces numbers (tag codes are dictionary positions, not orderable
    values), so these pick per group from the decoded host values.
    Returns an object array with None for empty groups."""
    valid = mask & np.asarray(
        [v is not None and not (isinstance(v, float) and v != v)
         for v in values])
    if func == "count":
        # count of non-NULL string values per group (the device planes
        # only count numerics)
        return np.bincount(gid[valid], minlength=num_groups)[
            :num_groups].astype(np.int64)
    if func == "count_distinct":
        out_i = np.zeros(num_groups, dtype=np.int64)
        if valid.any():
            gid_v = gid[valid]
            key = np.asarray([str(v) for v in values[valid]])
            order = np.lexsort((key, gid_v))
            g_s, k_s = gid_v[order], key[order]
            new = np.r_[True, (g_s[1:] != g_s[:-1]) | (k_s[1:] != k_s[:-1])]
            np.add.at(out_i, g_s[new], 1)
        return out_i
    out = np.full(num_groups, None, dtype=object)
    if not valid.any():
        return out
    gid_v = gid[valid]
    val_v = values[valid]
    if func in ("first", "last"):
        ts_v = np.asarray(ts)[valid]
        order = np.lexsort((ts_v, gid_v))
    else:  # min / max — lexicographic over the string values
        order = np.lexsort((val_v.astype(str), gid_v))
    g_sorted = gid_v[order]
    last = np.flatnonzero(np.r_[g_sorted[1:] != g_sorted[:-1], True])
    first = np.r_[0, last[:-1] + 1]
    pick = first if func in ("first", "min") else last
    out[g_sorted[pick]] = val_v[order][pick]
    return out
