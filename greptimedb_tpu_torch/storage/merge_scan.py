"""Merge per-region scans into one columnar scan: the MergeScan gather
(counterpart of greptimedb_tpu/storage/merge_scan.py).

Mirrors reference src/query/src/dist_plan/merge_scan.rs:122-259: the
frontend gathers each region's scan and concatenates. The whole scans
concatenate on the host, and each region's tag dictionary codes remap
into a union dictionary with one vectorized searchsorted pass, so the
result feeds the same device routes (K1, K2) as a single-region scan.
Partial-aggregate pushdown happens above this layer
(query/dist_agg.py): when the plan prefix commutes, regions return
partial planes instead of rows.
"""

from __future__ import annotations

import numpy as np

from greptimedb_tpu_torch.storage.region import ScanData


def merge_scans(parts: list[ScanData]) -> ScanData | None:
    parts = [p for p in parts if p is not None and p.num_rows > 0]
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    schema = parts[0].schema

    # union tag dictionaries + code remap per region
    tag_names = list(parts[0].tag_dicts.keys())
    union_dicts: dict[str, np.ndarray] = {}
    remaps: list[dict[str, np.ndarray]] = [dict() for _ in parts]
    for name in tag_names:
        all_vals = np.concatenate([p.tag_dicts[name] for p in parts])
        union = np.unique(all_vals.astype(str))
        union_dicts[name] = union
        for i, p in enumerate(parts):
            local = p.tag_dicts[name].astype(str)
            remaps[i][name] = np.searchsorted(union, local).astype(np.int32)

    columns: dict[str, np.ndarray] = {}
    for cname in parts[0].columns:
        if cname in union_dicts:
            mapped = []
            for i, p in enumerate(parts):
                codes = p.columns[cname]
                remap = remaps[i][cname]
                out = np.where(codes >= 0, remap[np.clip(codes, 0, None)], -1)
                mapped.append(out.astype(np.int32))
            columns[cname] = np.concatenate(mapped)
        else:
            columns[cname] = np.concatenate([p.columns[cname] for p in parts])

    # sequences are per-region counters; partitioned tables have disjoint
    # keys across regions, so cross-region last-write-wins never arises
    seq = np.concatenate([p.seq for p in parts])
    op_type = np.concatenate([p.op_type for p in parts])
    return ScanData(
        schema=schema,
        columns=columns,
        seq=seq,
        op_type=op_type,
        tag_dicts=union_dicts,
        num_rows=int(sum(p.num_rows for p in parts)),
        needs_dedup=any(p.needs_dedup for p in parts),
        region_id=-1,
        data_version=0,
        # each part's identity, its region instance included: a region
        # recreated by TRUNCATE restarts its data version
        scan_fingerprint=tuple(
            (p.region_id, p.incarnation, p.data_version, p.scan_fingerprint)
            for p in parts
        ),
    )
