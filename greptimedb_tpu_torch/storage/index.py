"""Inverted index: sorted term dictionary + segment bitmaps, per SST
(counterpart of greptimedb_tpu/storage/index.py; the blob and its puffin
container are byte for byte the JAX writer's).

Mirrors reference `src/index/src/inverted_index` (format.rs:28: an FST of
tag values mapping to bitmaps of row-segment positions) stored in a puffin
container next to each SST (reference `src/puffin`), and mito2's applier
integration (sst/parquet/reader.rs:335-425 prune path; predicate kinds
Eq/In/Range/Regex per search/index_apply.rs:26-58).

Per SST file, one puffin blob per tag column holds:
  - the sorted distinct UTF-8 *values* present (the FST analog — binary
    search replaces FST lookup, an ordered slice replaces FST range scan),
  - one packed bitmap per value over fixed-size row segments
    (``segment_rows`` rows each, finer than the SST's row groups).

Scan-time predicates (Eq/In from ``=``/``IN``, Range from comparisons and
BETWEEN, Regex from LIKE and PromQL ``=~``) intersect those bitmaps to
skip whole row groups — and whole files — before any column chunk is
read (storage/sst.py maps segments onto the footer's row groups).
Pruning is purely an IO reduction: the region's exact tag in-set filter
(storage/region.py::_tag_inset_mask) and the device WHERE still run on
every row that is read.

Values (not per-file codes) key the index so it stays valid as the region
tag registry grows.

Blob binary layout (little-endian, blob type "gtpu-inverted-index-v1"):

    u32 n_terms | u32 n_segments | u32 segment_rows | u8 has_null | pad[3]
    u32 term_offsets[n_terms + 1]        # into the term byte stream
    term bytes (utf-8, concatenated)
    bitmaps: (n_terms + has_null) rows x ceil(n_segments/8) bytes,
             packbits(bitorder="little"); the NULL bitmap is last

The writer sets each bit from the (term, segment) pairs the rows hold,
one pass over the rows: the JAX writer's dense [terms x segments] matrix
would take gigabytes at a million terms. The bytes are the same.
"""

from __future__ import annotations

import io
import os
import re
import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from greptimedb_tpu_torch.objectstore import ObjectStoreError, default_store
from greptimedb_tpu_torch.storage.puffin import PuffinReader, PuffinWriter

BLOB_TYPE = "gtpu-inverted-index-v1"
DEFAULT_SEGMENT_ROWS = 8192

# ---- predicates ------------------------------------------------------------


@dataclass(frozen=True)
class InSet:
    """value ∈ {…} — from ``tag = 'v'`` and ``tag IN (…)``."""

    values: tuple[str, ...]  # sorted

    @staticmethod
    def of(values) -> "InSet":
        return InSet(tuple(sorted(str(v) for v in values)))


@dataclass(frozen=True)
class Range:
    """lo (<|<=) value (<|<=) hi over the tag's string ordering — from
    comparisons and BETWEEN on tag columns. Either bound may be None."""

    lo: Optional[str]
    hi: Optional[str]
    lo_inc: bool = True
    hi_inc: bool = True


@dataclass(frozen=True)
class Regex:
    """value matches an anchored regular expression — from LIKE and
    PromQL ``=~`` matchers."""

    pattern: str


Predicate = Union[InSet, Range, Regex]

# A predicate map is tag name -> tuple of Predicates (ANDed), but a plain
# set of values (the historical form, still produced by callers like
# metric_engine and the Flight wire) is accepted anywhere and treated as
# one InSet.
PredicateMap = dict[str, object]


def _norm_preds(v) -> tuple[Predicate, ...]:
    if isinstance(v, (set, frozenset, list)) and not isinstance(v, tuple):
        return (InSet.of(v),)
    if isinstance(v, (InSet, Range, Regex)):
        return (v,)
    out = []
    for p in v:
        out.extend(_norm_preds(p))
    return tuple(out)


def normalize_predicates(preds: Optional[PredicateMap]) \
        -> dict[str, tuple[Predicate, ...]]:
    if not preds:
        return {}
    return {k: _norm_preds(v) for k, v in preds.items()}


def predicates_cache_key(preds: Optional[PredicateMap]):
    """Hashable, order-independent key for scan caches."""
    if not preds:
        return None
    return tuple(sorted(
        (k, tuple(sorted(map(repr, v))))
        for k, v in normalize_predicates(preds).items()
    ))


# ---- build side ------------------------------------------------------------


def _index_path(sst_dir: str, file_id: str) -> str:
    return os.path.join(sst_dir, f"{file_id}.puffin")


class InvertedIndexWriter:
    """Build + persist the per-file index at SST write time (reference
    create/sort_create.rs role; here the values arrive already
    dictionary-encoded, so 'external sort' reduces to the (term, segment)
    pairs of the code column)."""

    def __init__(self, sst_dir: str, store=None,
                 segment_rows: int = DEFAULT_SEGMENT_ROWS):
        self.sst_dir = sst_dir
        self.store = default_store(store)
        self.segment_rows = int(segment_rows)

    def path(self, file_id: str) -> str:
        return _index_path(self.sst_dir, file_id)

    def write(
        self,
        file_id: str,
        tag_codes: dict[str, np.ndarray],  # tag -> int codes per row
        tag_dicts: dict[str, np.ndarray],  # tag -> value table
        row_group_size: int,
        num_rows: int,
    ) -> None:
        if not tag_codes or num_rows == 0:
            return
        seg = self.segment_rows
        n_segments = (num_rows + seg - 1) // seg
        w = PuffinWriter({"num_rows": num_rows,
                          "row_group_size": int(row_group_size)})
        for tag, codes in tag_codes.items():
            blob = self._build_blob(
                np.asarray(codes), np.asarray(tag_dicts[tag], dtype=object),
                n_segments)
            w.add_blob(BLOB_TYPE, blob, {"column": tag})
        self.store.write(self.path(file_id), w.finish())

    def _build_blob(self, codes: np.ndarray, values: np.ndarray,
                    n_segments: int) -> bytes:
        seg = self.segment_rows
        codes = codes.astype(np.int64, copy=False)
        n = len(codes)
        null_rows = codes < 0
        has_null = bool(null_rows.any())

        # distinct codes present, mapped to their sorted-term order
        present = np.unique(codes[~null_rows]) if has_null \
            else np.unique(codes)
        terms = np.asarray([str(values[c]) for c in present], dtype=object)
        order = np.argsort(terms, kind="stable")
        terms = terms[order]
        present = present[order]
        n_terms = len(terms)

        # bitmap rows [n_terms (+null)] x width bytes, bit s % 8 of byte
        # s // 8 for segment s: packbits(bitorder="little")'s layout
        width = (n_segments + 7) // 8
        packed = np.zeros((n_terms + (1 if has_null else 0)) * width,
                          dtype=np.uint8)
        if n:
            rank = np.full(int(values.shape[0]) + 1, -1, dtype=np.int64)
            rank[present] = np.arange(n_terms)
            rows = rank[np.where(null_rows, len(values), codes)]
            rows[null_rows] = n_terms
            seg_ids = np.arange(n, dtype=np.int64) // seg
            # one pair a run: sorted SSTs hold long runs of one code
            first = np.ones(n, dtype=bool)
            first[1:] = (rows[1:] != rows[:-1]) | (seg_ids[1:] != seg_ids[:-1])
            r, s = rows[first], seg_ids[first]
            np.bitwise_or.at(packed, r * width + (s >> 3),
                             np.left_shift(1, s & 7).astype(np.uint8))

        term_bytes = [t.encode() for t in terms]
        offsets = np.zeros(n_terms + 1, dtype=np.uint32)
        offsets[1:] = np.cumsum([len(b) for b in term_bytes])
        return b"".join([
            struct.pack("<IIIB3x", n_terms, n_segments, seg,
                        1 if has_null else 0),
            offsets.tobytes(),
            b"".join(term_bytes),
            packed.tobytes(),
        ])

    def delete(self, file_id: str) -> None:
        self.store.delete(self.path(file_id))


# ---- search side -----------------------------------------------------------


class _TagIndex:
    """Parsed in-memory form of one tag's blob. Bitmaps stay *packed*
    (one byte row per 8 segments); only the term rows a predicate actually
    hits are unpacked — O(hits), not O(n_terms * n_segments)."""

    __slots__ = ("terms", "_sorted", "_packed", "_n_terms", "_has_null",
                 "n_segments", "segment_rows")

    def __init__(self, data: bytes):
        n_terms, n_segments, seg_rows, has_null = \
            struct.unpack_from("<IIIB", data, 0)
        off = 16
        offsets = np.frombuffer(data, dtype=np.uint32, count=n_terms + 1,
                                offset=off)
        off += 4 * (n_terms + 1)
        blob = data[off:off + int(offsets[-1])]
        self.terms = [
            blob[offsets[i]:offsets[i + 1]].decode()
            for i in range(n_terms)
        ]
        # the term list as one array, built once: searchsorted over a
        # list would convert it on every predicate
        self._sorted = np.asarray(self.terms, dtype=object)
        off += int(offsets[-1])
        width = (n_segments + 7) // 8
        rows = n_terms + (1 if has_null else 0)
        self._packed = np.frombuffer(
            data, dtype=np.uint8, count=rows * width, offset=off
        ).reshape(rows, width)
        self._n_terms = n_terms
        self._has_null = bool(has_null)
        self.n_segments = n_segments
        self.segment_rows = seg_rows

    # each evaluator returns a bool[n_segments] of segments that MAY match

    def eval(self, pred: Predicate) -> np.ndarray:
        if isinstance(pred, InSet):
            return self._eval_in(pred.values)
        if isinstance(pred, Range):
            return self._eval_range(pred)
        return self._eval_regex(pred.pattern)

    def _or_rows(self, rows: np.ndarray, with_null: bool) -> np.ndarray:
        idx = list(np.asarray(rows, dtype=np.int64))
        if with_null and self._has_null:
            idx.append(self._n_terms)
        if not idx:
            return np.zeros(self.n_segments, dtype=bool)
        merged = np.bitwise_or.reduce(self._packed[idx], axis=0)
        return np.unpackbits(merged, bitorder="little")[:self.n_segments] \
            .astype(bool)

    def _eval_in(self, values: Sequence[str]) -> np.ndarray:
        terms = self.terms
        lo = np.searchsorted(self._sorted,
                             np.asarray(list(values), dtype=object))
        hits = [
            i for v, i in zip(values, lo)
            if i < len(terms) and terms[i] == v
        ]
        # an absent tag is NULL here but the empty string in PromQL's
        # data model — `host=""` must keep NULL segments
        return self._or_rows(np.asarray(hits, dtype=np.int64),
                             with_null="" in values)

    def _eval_range(self, p: Range) -> np.ndarray:
        terms = self._sorted
        lo = 0 if p.lo is None else int(np.searchsorted(
            terms, p.lo, side="left" if p.lo_inc else "right"))
        hi = len(terms) if p.hi is None else int(np.searchsorted(
            terms, p.hi, side="right" if p.hi_inc else "left"))
        return self._or_rows(np.arange(lo, max(lo, hi), dtype=np.int64),
                             with_null=False)

    def _eval_regex(self, pattern: str) -> np.ndarray:
        try:
            rx = re.compile(pattern)
        except re.error:
            return np.ones(self.n_segments, dtype=bool)  # can't prune
        hits = np.asarray(
            [i for i, t in enumerate(self.terms) if rx.fullmatch(t)],
            dtype=np.int64)
        return self._or_rows(hits, with_null=rx.fullmatch("") is not None)


@dataclass
class SegmentSelection:
    """Which fixed-size row segments of a file may contain matches."""

    mask: np.ndarray  # bool[n_segments]
    segment_rows: int

    @property
    def is_empty(self) -> bool:
        return not bool(self.mask.any())

    @property
    def all_set(self) -> bool:
        return bool(self.mask.all())

    def row_groups(self, group_row_counts: Sequence[int]) -> list[int]:
        """Map surviving segments onto row groups given each group's row
        count (the SST footer's; reference row-selection analog)."""
        keep = []
        start = 0
        seg = self.segment_rows
        for g, rows in enumerate(group_row_counts):
            s0 = start // seg
            s1 = (start + rows - 1) // seg + 1 if rows else s0
            if self.mask[s0:min(s1, len(self.mask))].any():
                keep.append(g)
            start += rows
        return keep


class IndexApplier:
    """Evaluate tag predicates against a file's index.

    Returns the allowed row-group indices, or None when the file has no
    index / nothing is pruned (scan everything), or [] when provably
    empty. Parsed indexes are kept in an LRU shared by the region's
    concurrent scans (hence the lock)."""

    CACHE_FILES = 64  # parsed per-file indexes kept (LRU)

    def __init__(self, sst_dir: str, store=None):
        self.sst_dir = sst_dir
        self.store = default_store(store)
        self._cache: "OrderedDict[str, Optional[dict]]" = OrderedDict()
        self._lock = threading.Lock()

    def _load(self, file_id: str) -> Optional[dict]:
        with self._lock:
            if file_id in self._cache:
                self._cache.move_to_end(file_id)
                return self._cache[file_id]
        entry = None
        try:
            raw = self.store.read(_index_path(self.sst_dir, file_id))
        except (ObjectStoreError, FileNotFoundError):
            raw = None
        if raw is not None:
            reader = PuffinReader(io.BytesIO(raw))
            entry = {"tags": {}, "props": reader.properties}
            for blob in reader.blobs_of_type(BLOB_TYPE):
                entry["tags"][blob.properties.get("column")] = \
                    _TagIndex(reader.read_blob(blob))
        with self._lock:
            self._cache[file_id] = entry
            while len(self._cache) > self.CACHE_FILES:
                self._cache.popitem(last=False)
        return entry

    def select(self, file_id: str,
               predicates: Optional[PredicateMap]) -> Optional[SegmentSelection]:
        preds = normalize_predicates(predicates)
        if not preds:
            return None
        data = self._load(file_id)
        if data is None:
            return None
        mask = None
        for tag, plist in preds.items():
            tix: Optional[_TagIndex] = data["tags"].get(tag)
            if tix is None:
                continue  # tag not indexed in this file
            for p in plist:
                m = tix.eval(p)
                mask = m if mask is None else (mask & m)
                if not mask.any():
                    return SegmentSelection(mask, tix.segment_rows)
        if mask is None:
            return None
        seg_rows = next(iter(data["tags"].values())).segment_rows
        return SegmentSelection(mask, seg_rows)

    def apply(
        self, file_id: str, predicates: Optional[PredicateMap],
        group_row_counts: Optional[Sequence[int]] = None,
    ) -> Optional[list[int]]:
        """Row-group form of `select`. Without `group_row_counts` (footer
        not read yet) the groups come from the index's own row_group_size
        and num_rows properties."""
        sel = self.select(file_id, predicates)
        if sel is None:
            return None
        if sel.is_empty:
            return []
        if sel.all_set:
            return None
        if group_row_counts is None:
            props = self._load(file_id)["props"]
            rg = int(props.get("row_group_size", 0))
            num = int(props.get("num_rows", 0))
            if not rg or not num:
                return None
            group_row_counts = [min(rg, num - s) for s in range(0, num, rg)]
        return sel.row_groups(group_row_counts)

    def invalidate(self, file_id: str) -> None:
        with self._lock:
            self._cache.pop(file_id, None)


# ---- predicate extraction from SQL -----------------------------------------


def _sql_like_to_regex(pat: str) -> str:
    # inline (?is): the query-side LIKE filter compiles with
    # re.IGNORECASE | re.DOTALL (query/expr.py _like_to_regex) — index
    # pruning must never be stricter than the filter it serves
    out = ["(?is)"]
    for ch in pat:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def extract_tag_predicates(where, schema) -> dict[str, tuple]:
    """Conservatively extract tag constraints from the top-level
    conjunction of a raw (pre-bind) WHERE AST: `tag = 'v'`, `tag IN (…)`,
    `tag  (<|<=|>|>=)  'v'`, `tag BETWEEN a AND b`, `tag LIKE 'p%'`.
    Anything not provably restrictive is ignored — pruning must never
    drop rows."""
    from greptimedb_tpu_torch.sql import ast

    tags = {c.name for c in schema.tag_columns}
    out: dict[str, list] = {}

    def add(name: str, pred: Predicate):
        out.setdefault(name, []).append(pred)

    def tag_lit(e):
        """(column, literal) if e is `tag OP literal` in either order,
        plus whether the operands were swapped."""
        l, r = e.left, e.right
        swapped = False
        if isinstance(r, ast.Column) and isinstance(l, ast.Literal):
            l, r, swapped = r, l, True
        if isinstance(l, ast.Column) and l.name in tags \
                and isinstance(r, ast.Literal) and r.value is not None:
            return l.name, str(r.value), swapped
        return None

    def walk(e):
        if isinstance(e, ast.BinaryOp) and e.op == "and":
            walk(e.left)
            walk(e.right)
            return
        if isinstance(e, ast.BinaryOp) and e.op == "=":
            hit = tag_lit(e)
            if hit:
                add(hit[0], InSet.of([hit[1]]))
            return
        if isinstance(e, ast.BinaryOp) and e.op in ("<", "<=", ">", ">="):
            hit = tag_lit(e)
            if hit:
                name, v, swapped = hit
                op = e.op
                if swapped:  # 'v' < tag  ==  tag > 'v'
                    op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
                if op in ("<", "<="):
                    add(name, Range(None, v, hi_inc=(op == "<=")))
                else:
                    add(name, Range(v, None, lo_inc=(op == ">=")))
            return
        if isinstance(e, ast.BinaryOp) and e.op == "like":
            if isinstance(e.left, ast.Column) and e.left.name in tags \
                    and isinstance(e.right, ast.Literal) \
                    and e.right.value is not None:
                add(e.left.name, Regex(_sql_like_to_regex(str(e.right.value))))
            return
        if (
            isinstance(e, ast.Between)
            and not getattr(e, "negated", False)
            and isinstance(e.expr, ast.Column)
            and e.expr.name in tags
            and isinstance(e.low, ast.Literal)
            and isinstance(e.high, ast.Literal)
            and e.low.value is not None
            and e.high.value is not None
        ):
            add(e.expr.name, Range(str(e.low.value), str(e.high.value)))
            return
        if (
            isinstance(e, ast.InList)
            and not e.negated
            and isinstance(e.expr, ast.Column)
            and e.expr.name in tags
            and all(isinstance(i, ast.Literal) for i in e.items)
        ):
            add(e.expr.name,
                InSet.of([str(i.value) for i in e.items
                          if i.value is not None]))

    if where is not None:
        walk(where)
    return {k: tuple(v) for k, v in out.items()}
