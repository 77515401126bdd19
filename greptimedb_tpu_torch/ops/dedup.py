"""Sort-based merge-dedup (counterpart of greptimedb_tpu/ops/dedup.py).

The reference merges memtable and SST iterators with a k-way heap and
keeps the highest sequence per (primary key, timestamp)
(mito2 read/merge.rs:39-115). The device form of the same rule:

    lexsort by (series, ts, seq) -> run-boundary mask
    -> keep the last (highest-seq) row of each (series, ts) run
    -> drop rows whose winner is a DELETE tombstone (read.rs:59-73)

The output is a permutation plus a keep-mask in sorted order. This is
not a kernel of the TPU package (no Pallas), so it stays plain PyTorch.
"""

from __future__ import annotations

import torch

OP_PUT = 0
OP_DELETE = 1


def _lexsort(keys: tuple) -> torch.Tensor:
    """Indices sorting by the LAST key first, earlier keys breaking ties
    (numpy.lexsort's order), via stable sorts from the least significant
    key up."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def sort_dedup(
    series_ids: torch.Tensor,  # [N] integer series / primary-key ids
    ts: torch.Tensor,  # [N] int64
    seq: torch.Tensor,  # [N] int64 write sequence (monotone per region)
    op_type: torch.Tensor,  # [N] int8 OP_PUT / OP_DELETE
    mask: torch.Tensor,  # [N] bool validity
    assume_unique_ts: bool = False,
    keep_tombstones: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (order, keep): `order` sorts rows by (series, ts, seq);
    `keep` marks, in sorted order, the last-write-wins survivors.

    With `assume_unique_ts` (append-mode regions) only the sort remains
    and `keep` is the validity mask."""
    big = torch.iinfo(series_ids.dtype).max
    # invalid rows sort to the end so the valid prefix stays dense
    s = torch.where(mask, series_ids, torch.full_like(series_ids, big))
    order = _lexsort((seq, ts, s))
    s_sorted = s[order]
    if assume_unique_ts:
        return order, s_sorted != big
    t_sorted = ts[order]
    op_sorted = op_type[order]
    # run boundary: row i is the last of its (series, ts) run
    nxt_s = torch.cat([s_sorted[1:], s_sorted.new_full((1,), big)])
    nxt_t = torch.cat([t_sorted[1:],
                       t_sorted.new_full((1,), torch.iinfo(torch.int64).min)])
    is_last = (s_sorted != nxt_s) | (t_sorted != nxt_t)
    keep = is_last & (s_sorted != big)
    if not keep_tombstones:
        keep = keep & (op_sorted != OP_DELETE)
    return order, keep
