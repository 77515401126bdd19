"""SST files: sorted columnar row groups with a JSON footer (counterpart
of greptimedb_tpu/storage/sst.py, which writes Parquet; the port writes
plain numpy buffers so it needs no Arrow).

Rows arrive sorted by (tags..., ts, seq) — flush and compaction sort
first. Internal columns `__seq` (write sequence) and `__op_type`
(PUT/DELETE) ride beside the schema's columns. Layout of one file:

    row group 0: each column's fixed-width buffer, 8-byte aligned
    row group 1: ...
    footer: JSON — format name and version, the region schema, column
            dtypes, the file's dictionaries, and per row group its row
            count, ts min/max and column offsets
    trailer: <Q footer length> + MAGIC

Tag and string columns are int32 codes into the file's dictionaries
(code -1 is NULL); the region remaps them into its registry on read.
Row groups default to 1M rows; the footer's ts min/max prune whole row
groups, and the region applies the exact ts row filter after decode.

Beside each SST the writer puts its inverted index (`<file_id>.puffin`,
storage/index.py, the JAX package's blobs over segments of
min(8192, row_group_size) rows). Scans with tag predicates ask the
index first: a file it rules out is never opened, and only the row
groups its surviving segments touch are read (the segments map onto
the footer's row counts).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import uuid
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.datatypes.types import SemanticType
from greptimedb_tpu_torch.datatypes.vector import DictVector
from greptimedb_tpu_torch.objectstore import default_store
from greptimedb_tpu_torch.utils import tracing
from greptimedb_tpu_torch.storage.format import (
    FORMAT_NAME,
    FORMAT_VERSIONS,
    FormatError,
    check_version,
)
from greptimedb_tpu_torch.storage.index import (
    DEFAULT_SEGMENT_ROWS,
    IndexApplier,
    InvertedIndexWriter,
)

SEQ_COL = "__seq"
OP_COL = "__op_type"
DEFAULT_ROW_GROUP = 1 << 20
MAGIC = b"GTTSST01"
_TRAILER = struct.Struct("<Q")
SUFFIX = ".sst"


@dataclass
class FileMeta:
    """Catalog entry for one SST (reference sst/file.rs FileMeta)."""

    file_id: str
    num_rows: int
    ts_min: int
    ts_max: int
    max_seq: int
    level: int = 0
    size_bytes: int = 0
    # tag columns holding any NULL (-1) code in this file, or None when
    # unknown; the lastpoint pruner of a later slice reads it
    null_tags: Optional[list] = None

    def to_dict(self) -> dict:
        return self.__dict__.copy()

    @staticmethod
    def from_dict(d: dict) -> "FileMeta":
        return FileMeta(**d)


def _is_dict_column(c) -> bool:
    return c.semantic is SemanticType.TAG or c.dtype.is_string


class SstWriter:
    def __init__(self, sst_dir: str, schema: Schema,
                 row_group_size: int = DEFAULT_ROW_GROUP, store=None):
        self.sst_dir = sst_dir
        self.schema = schema
        self.row_group_size = row_group_size
        self.store = default_store(store)

    def write(self, columns: dict[str, np.ndarray],
              tag_dicts: dict[str, np.ndarray], seq: np.ndarray,
              op_type: np.ndarray, level: int = 0) -> FileMeta:
        """Write pre-sorted columns (tags as int32 codes against
        `tag_dicts`; string fields as values) to a new SST file."""
        ts_name = self.schema.time_index.name
        n = len(columns[ts_name])
        arrays: dict[str, np.ndarray] = {}
        dicts: dict[str, list] = {}
        for c in self.schema.columns:
            col = columns[c.name]
            if c.semantic is SemanticType.TAG:
                arrays[c.name] = np.ascontiguousarray(col, dtype=np.int32)
                dicts[c.name] = _json_strings(tag_dicts[c.name])
            elif c.dtype.is_string:
                dv = col if isinstance(col, DictVector) \
                    else DictVector.encode(np.asarray(col, dtype=object))
                arrays[c.name] = np.ascontiguousarray(dv.codes)
                dicts[c.name] = _json_strings(dv.values)
            else:
                arrays[c.name] = np.ascontiguousarray(col)
        arrays[SEQ_COL] = np.ascontiguousarray(seq, dtype=np.int64)
        arrays[OP_COL] = np.ascontiguousarray(op_type, dtype=np.int8)
        names = list(arrays)

        pieces: list = []
        groups = []
        pos = 0
        ts = arrays[ts_name]
        for g0 in range(0, n, self.row_group_size):
            g1 = min(g0 + self.row_group_size, n)
            offsets = []
            for name in names:
                chunk = arrays[name][g0:g1]
                offsets.append(pos)
                pieces.append(memoryview(chunk).cast("B"))
                pad = -chunk.nbytes % 8
                if pad:
                    pieces.append(b"\0" * pad)
                pos += chunk.nbytes + pad
            groups.append({"rows": g1 - g0, "ts_min": int(ts[g0:g1].min()),
                           "ts_max": int(ts[g0:g1].max()),
                           "offsets": offsets})
        footer = json.dumps({
            "format": FORMAT_NAME,
            "version": FORMAT_VERSIONS["torch.sst"],
            "schema": self.schema.to_dict(),
            "num_rows": n,
            "columns": [[name, arrays[name].dtype.str] for name in names],
            "dicts": dicts,
            "row_groups": groups,
        }).encode()
        pieces += [footer, _TRAILER.pack(len(footer)), MAGIC]
        file_id = uuid.uuid4().hex
        path = os.path.join(self.sst_dir, file_id + SUFFIX)
        self.store.write(path, [p for p in pieces if len(p)])
        # the per-file inverted index (tag value -> segment bitmap)
        InvertedIndexWriter(
            self.sst_dir, self.store,
            segment_rows=min(DEFAULT_SEGMENT_ROWS, self.row_group_size),
        ).write(
            file_id,
            {c.name: arrays[c.name] for c in self.schema.tag_columns},
            tag_dicts, self.row_group_size, n)
        null_tags = [c.name for c in self.schema.tag_columns
                     if n and bool((arrays[c.name] < 0).any())]
        return FileMeta(
            file_id=file_id, num_rows=n,
            ts_min=int(ts.min()) if n else 0,
            ts_max=int(ts.max()) if n else 0,
            max_seq=int(arrays[SEQ_COL].max()) if n else 0,
            level=level, size_bytes=self.store.size(path),
            null_tags=null_tags)


def _json_strings(values) -> list:
    return [None if v is None else str(v) for v in values]


@dataclass
class SstPart:
    """Decoded row groups of one file: `columns` holds the requested
    schema columns present in the file (tag and string columns as file
    codes) plus `__seq` and `__op_type`; `dicts` the file dictionaries."""

    columns: dict[str, np.ndarray]
    dicts: dict[str, np.ndarray]
    num_rows: int


class SstReader:
    def __init__(self, sst_dir: str, store=None):
        self.sst_dir = sst_dir
        self.store = default_store(store)
        # footers of immutable files, parsed once
        self._footers: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.index_applier = IndexApplier(sst_dir, self.store)

    def path(self, file_id: str) -> str:
        return os.path.join(self.sst_dir, file_id + SUFFIX)

    def footer(self, file_id: str) -> dict:
        with self._lock:
            ft = self._footers.get(file_id)
        if ft is not None:
            return ft
        path = self.path(file_id)
        size = self.store.size(path)
        tail = bytearray(_TRAILER.size + len(MAGIC))
        self.store.read_into(path, size - len(tail), tail)
        if bytes(tail[_TRAILER.size:]) != MAGIC:
            raise FormatError(f"sst {file_id} is not a {FORMAT_NAME} file")
        (flen,) = _TRAILER.unpack_from(tail, 0)
        raw = bytearray(flen)
        self.store.read_into(path, size - len(tail) - flen, raw)
        ft = json.loads(bytes(raw))
        if ft.get("format") != FORMAT_NAME:
            raise FormatError(f"sst {file_id} has format {ft.get('format')!r}")
        check_version("torch.sst", ft["version"], f"sst {file_id}")
        ft["dicts"] = {k: np.asarray(v, dtype=object)
                       for k, v in ft["dicts"].items()}
        with self._lock:
            self._footers[file_id] = ft
        return ft

    def plan_groups(self, meta: FileMeta, schema: Schema,
                    ts_range: Optional[tuple[int, int]] = None,
                    projection: Optional[Sequence[str]] = None,
                    tag_predicates: Optional[dict] = None,
                    stats: Optional[dict] = None) -> Optional[tuple]:
        """Pruning phase of `read`: (footer, row-group indices, column
        names to read, row groups the index pruned) or None when the
        file or every row group falls outside `ts_range`, or the index
        rules the file out (then the footer is not read). Columns the
        file predates (ALTER ADD) are left out; the region backfills
        them. `stats` (optional) counts ssts / ssts_pruned / row_groups /
        row_groups_pruned, the pruned ones by the index."""
        if ts_range is not None and (meta.ts_max < ts_range[0]
                                     or meta.ts_min >= ts_range[1]):
            return None
        if stats is not None:
            stats["ssts"] = stats.get("ssts", 0) + 1
        # inverted-index pruning first: may rule the file out with no
        # footer read at all (reference reader.rs:335-425)
        sel = None
        if tag_predicates:
            sel = self.index_applier.select(meta.file_id, tag_predicates)
            if sel is not None and sel.is_empty:
                if stats is not None:
                    stats["ssts_pruned"] = stats.get("ssts_pruned", 0) + 1
                return None
        ft = self.footer(meta.file_id)
        groups = self._prune_row_groups(ft, ts_range)
        pruned = 0
        if sel is not None and not sel.all_set:
            allowed = set(sel.row_groups(
                [rg["rows"] for rg in ft["row_groups"]]))
            kept = [g for g in groups if g in allowed]
            pruned = len(groups) - len(kept)
            groups = kept
        if stats is not None:
            stats["row_groups"] = stats.get("row_groups", 0) \
                + len(groups) + pruned
            stats["row_groups_pruned"] = \
                stats.get("row_groups_pruned", 0) + pruned
        if not groups:
            if stats is not None and pruned:
                stats["ssts_pruned"] = stats.get("ssts_pruned", 0) + 1
            return None
        avail = [name for name, _ in ft["columns"]]
        want = avail if projection is None else list(dict.fromkeys(
            list(projection) + [schema.time_index.name, SEQ_COL, OP_COL]))
        cols = [n for n in want if n in avail]
        return ft, groups, cols, pruned

    def read(self, meta: FileMeta, schema: Schema,
             ts_range: Optional[tuple[int, int]] = None,
             projection: Optional[Sequence[str]] = None,
             tag_predicates: Optional[dict] = None,
             ) -> Optional[SstPart]:
        """Read the row groups that survive ts and index pruning; None
        when none do. Internal columns are always read."""
        # one span a file read, as the JAX reader's `open_input`
        with tracing.span("objectstore_read", backend=self.store.name):
            plan = self.plan_groups(meta, schema, ts_range, projection,
                                    tag_predicates)
            if plan is None:
                return None
            _ft, groups, cols, _pruned = plan
            return self.read_groups(meta, groups, cols)

    def iter_chunks(self, meta: FileMeta, schema: Schema,
                    ts_range: Optional[tuple[int, int]] = None,
                    projection: Optional[Sequence[str]] = None,
                    groups_per_chunk: int = 8,
                    tag_predicates: Optional[dict] = None):
        """Lazily yield the file as SstParts of `groups_per_chunk` row
        groups each, with `read`'s ts and index pruning: a streamed scan
        holds one chunk's columns at a time, whatever the file's size.
        The device WHERE mask stays exact."""
        # the span holds no yield: it covers the footer and the plan
        with tracing.span("objectstore_read", backend=self.store.name):
            plan = self.plan_groups(meta, schema, ts_range, projection,
                                    tag_predicates)
        if plan is None:
            return
        _ft, groups, cols, _pruned = plan
        for i in range(0, len(groups), groups_per_chunk):
            yield self.read_groups(meta, groups[i:i + groups_per_chunk],
                                   cols)

    def read_groups(self, meta: FileMeta, groups: Sequence[int],
                    columns: Sequence[str],
                    into: Optional[dict] = None) -> SstPart:
        """Specific row groups and columns: each column chunk lands in
        its output array with one read. `into` (column -> array of the
        groups' rows and the column's dtype) receives the chunks in place
        of new arrays: parallel decode reads contiguous runs of one file
        straight into slices of the whole part's columns."""
        ft = self.footer(meta.file_id)
        path = self.path(meta.file_id)
        index = {name: (i, np.dtype(dt))
                 for i, (name, dt) in enumerate(ft["columns"])}
        rgs = [ft["row_groups"][g] for g in groups]
        n = sum(rg["rows"] for rg in rgs)
        out = {}
        for name in columns:
            i, dt = index[name]
            arr = np.empty(n, dtype=dt) if into is None else into[name]
            pos = 0
            for rg in rgs:
                k = rg["rows"]
                if k:
                    self.store.read_into(path, rg["offsets"][i],
                                         arr[pos:pos + k])
                pos += k
            out[name] = arr
        dicts = {k: v for k, v in ft["dicts"].items() if k in out}
        return SstPart(out, dicts, n)

    @staticmethod
    def _prune_row_groups(ft: dict, ts_range) -> list[int]:
        rgs = ft["row_groups"]
        if ts_range is None:
            return list(range(len(rgs)))
        return [g for g, rg in enumerate(rgs)
                if not (rg["ts_max"] < ts_range[0]
                        or rg["ts_min"] >= ts_range[1])]

    def delete(self, file_id: str) -> None:
        self.store.delete(self.path(file_id))
        InvertedIndexWriter(self.sst_dir, self.store).delete(file_id)
        self.index_applier.invalidate(file_id)
        with self._lock:
            self._footers.pop(file_id, None)
