"""Table partition rules: shard rows to regions (counterpart of
greptimedb_tpu/partition/rule.py; `to_json` writes the JAX package's
JSON byte for byte, so either package reads the other's catalog).

Mirrors reference src/partition/src/multi_dim.rs:37-74 (multi-dimensional
range partitioning on tag columns) and splitter.rs (row batches → per-region
batches). The reference walks rows one at a time through the rule; the
TPU-native version is vectorized — region assignment for a whole RecordBatch
is a single `np.searchsorted` over the partition bounds per dimension, so
write sharding (operator/src/insert.rs:114-118 analog) costs O(n log r) numpy
time with no Python-per-row work.

Bounds use the reference's semantics: region i covers
[bound[i-1], bound[i]) with the last region unbounded (MAXVALUE).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass
class PartitionBound:
    """Upper-exclusive bound of one region along the partition columns
    (lexicographic when multiple columns)."""

    values: tuple  # one value per partition column; () == MAXVALUE

    @property
    def is_maxvalue(self) -> bool:
        return len(self.values) == 0


class PartitionRule:
    columns: list[str]

    def num_regions(self) -> int:
        raise NotImplementedError

    def find_regions(self, cols: Sequence[np.ndarray]) -> np.ndarray:
        """Vectorized: one array per partition column → int32 region index
        per row."""
        raise NotImplementedError

    def split(
        self, cols: Sequence[np.ndarray], n_rows: Optional[int] = None
    ) -> dict[int, np.ndarray]:
        """Row splitter (partition/src/splitter.rs analog): region index →
        row positions, computed with one argsort over find_regions."""
        if self.num_regions() == 1:
            n = len(cols[0]) if cols else (n_rows or 0)
            return {0: np.arange(n)}
        regions = self.find_regions(cols, n_rows)
        order = np.argsort(regions, kind="stable")
        sorted_regions = regions[order]
        out: dict[int, np.ndarray] = {}
        uniq, starts = np.unique(sorted_regions, return_index=True)
        bounds = list(starts) + [len(order)]
        for i, r in enumerate(uniq):
            out[int(r)] = order[bounds[i]:bounds[i + 1]]
        return out

    def to_json(self) -> str:
        raise NotImplementedError


class RangePartitionRule(PartitionRule):
    """N ordered regions split by upper bounds on partition columns.

    Single-column: bounds are scalars, assignment is searchsorted.
    Multi-column: lexicographic comparison via rank-composition (each
    column's values are mapped through the bound values' order, then
    combined into one sortable key) — still fully vectorized.
    """

    def __init__(self, columns: list[str], bounds: list[PartitionBound]):
        # bounds: one per region; last must be MAXVALUE
        if not bounds or not bounds[-1].is_maxvalue:
            raise ValueError("last partition bound must be MAXVALUE")
        for b in bounds[:-1]:
            if len(b.values) != len(columns):
                raise ValueError("bound arity != partition column count")
        self.columns = columns
        self.bounds = bounds

    def num_regions(self) -> int:
        return len(self.bounds)

    def find_regions(
        self, cols: Sequence[np.ndarray], n_rows: Optional[int] = None
    ) -> np.ndarray:
        if len(cols) != len(self.columns):
            raise ValueError("column count mismatch")
        n = len(cols[0]) if cols else (n_rows or 0)
        if len(self.bounds) == 1:
            return np.zeros(n, dtype=np.int32)
        finite = [b.values for b in self.bounds[:-1]]
        if len(self.columns) == 1:
            edges = np.asarray([v[0] for v in finite])
            vals = np.asarray(cols[0])
            if edges.dtype.kind in ("U", "S", "O") or vals.dtype.kind in ("U", "S", "O"):
                vals = vals.astype(str)
                edges = edges.astype(str)
            return np.searchsorted(edges, vals, side="right").astype(np.int32)
        # multi-dim: compare row tuples against bound tuples lexicographically.
        # region(row) = count of bounds <= row  (bounds are sorted ascending)
        region = np.zeros(n, dtype=np.int32)
        for bound in finite:
            # le_mask: bound tuple <= row tuple (lexicographic)
            le = np.zeros(n, dtype=bool)
            eq = np.ones(n, dtype=bool)
            for c, bv in zip(cols, bound):
                cv = np.asarray(c)
                if cv.dtype.kind in ("U", "S", "O"):
                    cv = cv.astype(str)
                    bv = str(bv)
                le |= eq & (cv > bv)
                eq &= cv == bv
            le |= eq  # bound == row counts as bound <= row
            region += le.astype(np.int32)
        return region

    def to_json(self) -> str:
        return json.dumps(
            {
                "type": "range",
                "columns": self.columns,
                "bounds": [list(b.values) for b in self.bounds],
            }
        )

    @staticmethod
    def from_json(s: str) -> "RangePartitionRule":
        d = json.loads(s)
        return RangePartitionRule(
            d["columns"], [PartitionBound(tuple(v)) for v in d["bounds"]]
        )


def _hash_column(vals: np.ndarray) -> np.ndarray:
    """Stable vectorized per-value hash (uint64). Strings factorize once
    and crc32 the uniques (crc32 is stable across processes — required:
    write scatter must agree between any frontend and any replay);
    integers run a splitmix64-style scramble so adjacent series ids
    don't all land on adjacent regions."""
    import zlib

    vals = np.asarray(vals)
    if vals.dtype.kind in ("U", "S", "O"):
        s = vals.astype(str)
        uniq, inv = np.unique(s, return_inverse=True)
        hu = np.asarray([zlib.crc32(u.encode("utf-8")) for u in uniq],
                        dtype=np.uint64)
        return hu[inv]
    x = np.asarray(vals)
    if x.dtype.kind == "f":
        x = x.astype(np.float64).view(np.uint64)
    else:
        x = x.astype(np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


class HashPartitionRule(PartitionRule):
    """N regions by a stable hash of the partition columns — the write
    scatter for workloads without a natural range key. Every region owns
    WHOLE series (all rows of one partition-column tuple hash alike), so
    LWW dedup, lastpoint pruning, and window-partition pushdown keep
    their per-region arguments; the reference's HASH PARTITION analog."""

    def __init__(self, columns: list[str], num_regions: int):
        if not columns:
            raise ValueError("hash partitioning needs >=1 column")
        if int(num_regions) < 1:
            raise ValueError("hash partitioning needs >=1 region")
        self.columns = list(columns)
        self._n = int(num_regions)

    def num_regions(self) -> int:
        return self._n

    def find_regions(
        self, cols: Sequence[np.ndarray], n_rows: Optional[int] = None
    ) -> np.ndarray:
        if len(cols) != len(self.columns):
            raise ValueError("column count mismatch")
        n = len(cols[0]) if cols else (n_rows or 0)
        if self._n == 1:
            return np.zeros(n, dtype=np.int32)
        h = np.zeros(n, dtype=np.uint64)
        with np.errstate(over="ignore"):
            for c in cols:
                h = h * np.uint64(1000003) ^ _hash_column(c)
        return (h % np.uint64(self._n)).astype(np.int32)

    def to_json(self) -> str:
        return json.dumps({"type": "hash", "columns": self.columns,
                           "regions": self._n})

    @staticmethod
    def from_json(s: str) -> "HashPartitionRule":
        d = json.loads(s)
        return HashPartitionRule(d["columns"], d["regions"])


def rule_from_json(obj) -> PartitionRule:
    """Rule loader by type tag ("range" is the pre-hash default for
    manifests written before the tag existed). Accepts a JSON string or
    the already-decoded dict the catalog stores."""
    d = json.loads(obj) if isinstance(obj, str) else obj
    if d.get("type") == "hash":
        return HashPartitionRule(d["columns"], d["regions"])
    return RangePartitionRule(
        d["columns"], [PartitionBound(tuple(v)) for v in d["bounds"]])


def single_region_rule() -> RangePartitionRule:
    return RangePartitionRule(columns=[], bounds=[PartitionBound(())])


def rule_from_partition_ast(cols: list[str], exprs: list) -> RangePartitionRule:
    """Build a RangePartitionRule from parsed PARTITION ON COLUMNS bound
    expressions (reference src/sql partition syntax → multi_dim rule).

    Recognized per-region shapes: `col < lit` (upper bound), conjunctions
    `col >= lit AND col < lit2` (upper bound lit2), and anything else —
    `col >= lit`, MAXVALUE — as the unbounded tail region. Bounds are
    sorted ascending, so region order matches bound order regardless of how
    the user listed them.
    """
    from greptimedb_tpu_torch.sql import ast as _ast

    uppers: list = []
    tail = 0
    for e in exprs:
        b = _upper_bound_of(e, cols)
        if b is None:
            tail += 1
        else:
            uppers.append(b)
    if tail == 0:
        # no explicit catch-all: the last bound's region absorbs the tail
        if not uppers:
            raise ValueError("PARTITION clause needs at least one bound")
        uppers = sorted(uppers)[:-1]
    uppers.sort()
    bounds = [PartitionBound(tuple(u) if isinstance(u, list) else (u,)) for u in uppers]
    bounds.append(PartitionBound(()))
    return RangePartitionRule(cols, bounds)


def _upper_bound_of(e, cols: list[str]):
    from greptimedb_tpu_torch.sql import ast as _ast

    if isinstance(e, _ast.BinaryOp):
        if e.op in ("and",):
            rb = _upper_bound_of(e.right, cols)
            return rb if rb is not None else _upper_bound_of(e.left, cols)
        if e.op in ("<", "<=") and isinstance(e.left, _ast.Column) and isinstance(e.right, _ast.Literal):
            return e.right.value
        if e.op in (">", ">=") and isinstance(e.right, _ast.Column) and isinstance(e.left, _ast.Literal):
            return e.left.value
    return None
