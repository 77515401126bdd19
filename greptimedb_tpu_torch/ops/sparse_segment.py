"""Sparse sort-compact aggregation (counterpart of
greptimedb_tpu/ops/sparse_segment.py): the route every aggregate takes
past its dense cardinality budget.

The dense routes hold [G, F] planes indexed by the full group key
PRODUCT. A high-cardinality scan (millions of small series) blows that
budget while OBSERVING at most one group a row. This module compacts the
observed groups instead of allocating the product:

    gid   = combined int64 group id per row (masked rows -> sentinel)
    order = stable sort of gid
    new   = first row of each equal-gid run in sorted order
    cid   = cumsum(new) - 1           # dense rank in [0, U)
    uniq  = gid at each run start     # rank -> global id decode table

and segment-reduces over the compacted ranks. The port reads the
observed count U on the host once and sizes every output to it, so its
planes are [U, F] and the dead slot (masked rows) is U.

Two reductions consume the compaction:

* `sparse_segment_agg`: plain `ops/segment.py::segment_agg` over the
  sorted rows, for every op (first/last and expressions included).
* `fused_sparse_segment_agg`: ONE call of the fused CUDA kernel
  (ops/segment_kernels.py::fused_segment_agg, K2) over U + 1 segments.
  The JAX package tiles its Pallas kernel into 4,088-segment windows
  under a fori_loop because the MXU kernel caps G at 4,096; K2 has no
  such cap, so the port needs no tile and no window.

Partials of different parts or shards combine in GID space
(`combine_sparse_gid_partials`, numpy): global ids do not depend on which
rows a part holds, so a union and an indexed fold is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from greptimedb_tpu_torch.ops import segment_kernels
from greptimedb_tpu_torch.ops.segment import segment_agg

#: sorts after every real combined group id (key products are guarded
#: upstream to stay below it)
GID_SENTINEL = 1 << 62


@dataclasses.dataclass(frozen=True)
class SparseGroupSpec:
    """Shape contract of one sparse aggregation: the slot budget
    (`cap`), the dense key product it replaced (`num_groups`), and the
    per-key domain sizes the tail uses to decode global ids back into key
    values (mixed radix, row-major: the strides the dense routes index
    with)."""

    cap: int
    num_groups: int
    sizes: tuple = ()

    @classmethod
    def plan(cls, num_groups: int, n_pad: int,
             sizes: tuple = ()) -> "SparseGroupSpec":
        """Slot budget for a scan of `n_pad` padded rows: observed groups
        never exceed the row count, so the cap is the row count clamped
        by config.sparse_groups_max() (overflow raises, never clips)."""
        from greptimedb_tpu_torch import config

        return cls(cap=min(n_pad, config.sparse_groups_max()),
                   num_groups=num_groups, sizes=tuple(sizes))

    def decode(self, gids: np.ndarray, key_idx: int) -> np.ndarray:
        """Key-component index of each global id (host-side tail)."""
        strides = [1] * len(self.sizes)
        for i in range(len(self.sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * self.sizes[i + 1]
        return (gids // strides[key_idx]) % self.sizes[key_idx]


def sort_compact(gid: torch.Tensor, mask: torch.Tensor, cap: int,
                 scope: str = "query"):
    """Sort-compact observed group ids to dense ranks.

    Returns (order, ids, valid_s, uniq, n_groups): the stable sort
    permutation, per-SORTED-row int32 compact ids (masked rows -> U, the
    dead slot), the sorted-row validity, the rank -> global-id table
    ([U] int64, ascending) and U as a Python int: the one host read.
    More than `cap` observed groups raise PlanError ("`scope` observed
    ..."); a clipped result is never served."""
    sentinel = torch.full_like(gid, GID_SENTINEL)
    sg, order = torch.sort(torch.where(mask, gid, sentinel), stable=True)
    valid_s = sg != GID_SENTINEL
    new = valid_s.clone()
    new[1:] &= sg[1:] != sg[:-1]
    u = int(new.sum().item())
    if u > cap:
        from greptimedb_tpu_torch.query.expr import PlanError

        raise PlanError(
            f"{scope} observed {u} distinct groups, exceeding the sparse "
            f"cap {cap}; raise GREPTIMEDB_TPU_SPARSE_GROUPS_MAX or add "
            "predicates")
    cid = torch.cumsum(new, 0, dtype=torch.int64) - 1
    ids = torch.where(valid_s, cid, torch.full_like(cid, u)).to(torch.int32)
    return order, ids, valid_s, sg[new], u


def sparse_segment_agg(values: torch.Tensor, gid: torch.Tensor,
                       mask: torch.Tensor, cap: int,
                       ops: tuple = ("sum", "count"), ts=None,
                       scope: str = "query"):
    """Masked segment reduction over sort-compacted ranks, `segment_agg`
    semantics exactly (NaN = NULL; first/last break ts ties by sorted
    position, which the stable sort keeps in scan order). Returns (part,
    uniq, n_groups) with part planes [U, ...]."""
    order, ids, valid_s, uniq, u = sort_compact(gid, mask, cap, scope)
    part = segment_agg(values[order], ids, valid_s, u, ops=ops,
                       ts=None if ts is None else ts[order])
    return part, uniq, u


def fused_sparse_segment_agg(vals: torch.Tensor, ids: torch.Tensor,
                             n_groups: int, want_min: bool = False,
                             want_max: bool = False,
                             want_sumsq: bool = False) -> dict:
    """The fused kernel over sort-compacted ranks: `vals` [N, F] sorted
    raw field values (NaN = NULL, finite otherwise), `ids` the compact
    ids of sort_compact (dead rows -> n_groups). One K2 call over
    n_groups + 1 segments; returns its planes without the dead slot:
    empty groups come back as 0 counts and +-inf extremes, as K2 gives
    them."""
    out = segment_kernels.fused_segment_agg(
        vals, ids, n_groups + 1, want_min=want_min, want_max=want_max,
        want_sumsq=want_sumsq)
    return {k: v[:n_groups] for k, v in out.items()}


def combine_sparse_gid_partials(parts: list) -> tuple:
    """Merge per-shard (or per-part) sparse partials in GID space.

    Each partial is {"gids": int64 [u] ascending-unique observed ids,
    "planes": {op: [u] or [u, F] host arrays}}. Compact ranks differ per
    part, the global ids they decode to do not, so the exact combine is
    a union and an indexed fold, op by op as the dense block chain
    folds: additive planes add (counts and rows in int64), min/max fold
    NaN-ignoring (NaN marks an empty group), first/last pick by their
    companion ts with the PARTIAL ORDER breaking exact-ts ties (first:
    earliest partial wins; last: latest). Returns (gids [U] ascending,
    planes)."""
    parts = [p for p in parts if len(p["gids"])]
    if not parts:
        return np.zeros((0,), np.int64), {}
    uniq = np.unique(np.concatenate([p["gids"] for p in parts]))
    n = len(uniq)

    def shaped(plane):
        return (n,) + np.asarray(plane).shape[1:]

    out: dict = {}
    p0 = parts[0]["planes"]
    for op, plane in p0.items():
        sh = shaped(plane)
        if op in ("count", "rows"):
            out[op] = np.zeros(sh, np.int64)
        elif op in ("sum", "sumsq"):
            out[op] = np.zeros(sh, np.asarray(plane).dtype)
        elif op in ("min", "max", "first", "last"):
            out[op] = np.full(sh, np.nan, np.asarray(plane).dtype)
        elif op == "last_ts":
            out[op] = np.full(sh, np.iinfo(np.int64).min, np.int64)
        elif op == "first_ts":
            out[op] = np.full(sh, np.iinfo(np.int64).max, np.int64)
        else:
            raise ValueError(f"cannot combine sparse partial op {op}")
    for p in parts:
        idx = np.searchsorted(uniq, p["gids"])
        pl = p["planes"]
        for op in out:
            if op in ("first", "last", "first_ts", "last_ts"):
                continue  # pairs, below
            v = np.asarray(pl[op])
            if op in ("count", "rows"):
                out[op][idx] = out[op][idx] + v.astype(np.int64)
            elif op in ("sum", "sumsq"):
                out[op][idx] = out[op][idx] + v
            elif op == "min":
                out[op][idx] = np.fmin(out[op][idx], v)
            else:  # max
                out[op][idx] = np.fmax(out[op][idx], v)
        if "last" in out:
            ts, cur = np.asarray(pl["last_ts"]), out["last_ts"][idx]
            newer = ts > cur  # strict: an exact-ts tie keeps the earlier
            sel = newer[:, None] if out["last"].ndim == 2 else newer
            out["last"][idx] = np.where(sel, np.asarray(pl["last"]),
                                        out["last"][idx])
            out["last_ts"][idx] = np.where(newer, ts, cur)
        if "first" in out:
            ts, cur = np.asarray(pl["first_ts"]), out["first_ts"][idx]
            older = ts < cur
            sel = older[:, None] if out["first"].ndim == 2 else older
            out["first"][idx] = np.where(sel, np.asarray(pl["first"]),
                                         out["first"][idx])
            out["first_ts"][idx] = np.where(older, ts, cur)
    return uniq, out


def compaction_ratio(n_groups: int, n_rows: int) -> float:
    """Observed groups per scanned row (1.0 = no compaction: every row
    its own group)."""
    return float(n_groups) / float(max(n_rows, 1))
