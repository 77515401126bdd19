"""Region: one LSM instance on disk (counterpart of
greptimedb_tpu/storage/region.py).

Write path: the WAL append is the durability boundary, then the memtable
ingests and the sequence advances. Scan path: memtable rows plus the
SSTs that overlap the time range, tags remapped from each file's
dictionary into the region registry, concatenated into host columns for
the device tier — dedup and aggregation happen on the device. Flush:
memtable -> sorted SST, manifest edit, WAL truncation. Compaction:
merge SSTs through the torch sort-dedup on the engine's device.

Kept from the JAX region because they decide what a query sees:
- `_widen_covering_range`: windows covering at least half the region's
  span serve the canonical full scan;
- the exact ts row filter on decoded SST parts (`_decode_table_part`);
  memtable rows are filtered coarsely, as the JAX region does, and the
  device WHERE is exact on both;
- the exact tag in-set row filter (`_tag_inset_mask`) for =/IN tag
  predicates;
- `ScanData.sorted_part_offsets` and `part_keys`: each SST part's row
  range and identity, so the device hot set keys its blocks by file.

`scan_stream` is the bounded-memory twin of `scan` (the JAX region's
`scan_stream`): files pinned and the memtable's chunk list snapshotted up
front, then lazy chunks of a few row groups each, decoded serially in
file order, and the memtable's rows last.

`scan_last` is the lastpoint scan (the JAX region's `scan_last`): SSTs
newest-first, stopping once every series' newest row is in hand.

Left for later slices (ROADMAP.md): group commit and write workers, the
parallel decode pool (and with it the parallel stream decode), seq_min
incremental scans and the inverted index.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.datatypes.types import SemanticType
from greptimedb_tpu_torch.datatypes.vector import DictVector, remap_codes
from greptimedb_tpu_torch.ops import dedup
from greptimedb_tpu_torch.ops.segment import combine_group_ids
from greptimedb_tpu_torch.storage.compaction import TwcsPicker
from greptimedb_tpu_torch.storage.index import (
    InSet,
    normalize_predicates,
    predicates_cache_key,
)
from greptimedb_tpu_torch.storage.manifest import ManifestManager
from greptimedb_tpu_torch.storage.memtable import Memtable, TagRegistry
from greptimedb_tpu_torch.storage.sst import (
    OP_COL,
    SEQ_COL,
    FileMeta,
    SstReader,
    SstWriter,
)
from greptimedb_tpu_torch.storage.wal import Wal

OP_PUT = 0
OP_DELETE = 1


class RegionDroppedError(RuntimeError):
    """Write raced a DROP: the region is gone; the write did not happen."""


@dataclass
class _PartEntry:
    """One decoded SST part under a (ts_range, names) shape: (cols, seq,
    op), or None when the file prunes to nothing."""

    part: Optional[tuple]
    nbytes: int


def _part_nbytes(part: Optional[tuple]) -> int:
    if part is None:
        return 64  # bookkeeping floor for cached pruned-empty entries
    cols, seq, op = part
    return sum(int(a.nbytes) for a in cols.values()) \
        + int(seq.nbytes) + int(op.nbytes)


@dataclass
class ScanData:
    """Host-side scan output: concatenated columns ready for device blocks
    (the JAX package's ScanData fields, region.py:80-131).

    Tags are int32 codes against `tag_dicts`; rows are not deduplicated:
    `seq`/`op_type` ride along for the sort-dedup step (last-write-wins
    and tombstones)."""

    schema: Schema
    columns: dict[str, np.ndarray]
    seq: np.ndarray
    op_type: np.ndarray
    tag_dicts: dict[str, np.ndarray]
    num_rows: int
    needs_dedup: bool = True
    # identity for the device hot set: (region_id, incarnation,
    # data_version, scan_fingerprint) names an immutable column snapshot
    region_id: int = -1
    data_version: int = 0
    incarnation: int = 0
    scan_fingerprint: tuple = ()
    # rows [offsets[i], offsets[i+1]) are SST part i, sorted by (tags...,
    # ts, seq); rows past offsets[-1] are the memtable's, unordered
    sorted_part_offsets: tuple = ()
    # (file_id, ts_range, pred_key) of each SST part, in row order: the
    # device hot set keys a part's blocks by it, so they outlive data
    # version bumps for the life of the file
    part_keys: tuple = ()
    # the lastpoint scan's counters (Region.scan_last): ssts,
    # ssts_pruned, lastpoint_visited, cache_hits
    stats: Optional[dict] = None


@dataclass
class ScanStream:
    """Lazy scan (the JAX package's ScanStream, region.py:133-160):
    metadata up front, columns delivered as bounded chunks, so host
    memory stays flat whatever the scan's size. Tag dictionaries come
    from the region's registry, complete without touching the data. Only
    append-mode scans stream: last-write-wins needs the whole scan in one
    sort."""

    est_rows: int
    ts_min: int  # over the pruned files and the memtable snapshot
    ts_max: int
    _tag_dicts: object  # () -> tag name -> registry values
    _chunks: object  # () -> iterator of (columns dict, rows)
    _close: object  # idempotent; releases the file pins

    @functools.cached_property
    def tag_dicts(self) -> dict[str, np.ndarray]:
        """Read from the registry on first use, so a stream that stays
        under the streaming threshold never copies a large dictionary.
        The registry only appends, so codes keep their meaning."""
        return self._tag_dicts()

    def chunks(self):
        return self._chunks()

    def close(self):
        """Release the snapshot's SST pins. Idempotent, and required when
        the stream is abandoned before or instead of being iterated: a
        generator that never started never runs its finally."""
        self._close()


#: process-wide Region instance ids: a recreated region restarts its
#: data_version, so snapshot identity also carries WHICH instance made it
_REGION_INCARNATIONS = itertools.count(1)


class Region:
    def __init__(self, region_id: int, region_dir: str, schema: Schema,
                 wal: Wal, store=None, manifest: ManifestManager = None,
                 device: torch.device = torch.device("cpu"), caches=()):
        self.region_id = region_id
        self.incarnation = next(_REGION_INCARNATIONS)
        self.region_dir = region_dir
        self.schema = schema
        self.wal = wal
        self.device = device
        # query-layer caches (device hot sets, the partial-aggregate
        # cache) to tell when files or the region die
        self.caches = caches
        self.manifest = manifest if manifest is not None else \
            ManifestManager(os.path.join(region_dir, "manifest"), store)
        self.sst_writer = SstWriter(os.path.join(region_dir, "sst"), schema,
                                    store=store)
        self.sst_reader = SstReader(os.path.join(region_dir, "sst"), store)
        self.registry = TagRegistry([c.name for c in schema.tag_columns])
        self.memtable = Memtable(schema, self.registry)
        self.next_seq = 0
        self.files: dict[str, FileMeta] = {}
        # WAL entries the last open replayed
        self.replayed_entries = 0
        self.dropped = False
        # one lock serializes mutations; scans snapshot under it and
        # decode outside
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()
        # compacted-away SSTs are deleted once no scan pins them
        self._purge_queue: list[str] = []
        self._file_refs: dict[str, int] = {}
        # bumped on every mutation; device hot-set snapshot keys carry it
        self.data_version = 0
        # whole-scan snapshots keyed by (data_version, ts_range, columns,
        # predicates): repeated dashboard queries reuse the host columns
        self._scan_cache: "OrderedDict[tuple, ScanData]" = OrderedDict()
        self.scan_cache_entries = 4
        # decoded SST parts keyed by (file_id, ts_range, names),
        # byte-budgeted: SSTs are immutable, so a post-flush scan decodes
        # only the new file. Tag predicates filter after the concat, so
        # one part serves every predicate.
        self._part_cache: "OrderedDict[tuple, _PartEntry]" = OrderedDict()
        self._part_cache_bytes = 0
        self.part_cache_budget = 1 << 30

    # ---- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, region_id: int, region_dir: str, schema: Schema,
               wal: Wal, **kw) -> "Region":
        region = cls(region_id, region_dir, schema, wal, **kw)
        region.manifest.record_schema(schema)
        return region

    @classmethod
    def open(cls, region_id: int, region_dir: str, wal: Wal, store=None,
             **kw) -> "Region":
        """Replay the manifest (checkpoint + deltas), restore the tag
        registry snapshot of the last flush, then replay the WAL from
        flushed_seq."""
        manifest = ManifestManager(os.path.join(region_dir, "manifest"),
                                   store)
        st = manifest.state
        if st.schema is None:
            raise FileNotFoundError(
                f"region {region_id} has no manifest at {region_dir}")
        region = cls(region_id, region_dir, st.schema, wal, store,
                     manifest=manifest, **kw)
        region.files = dict(st.files)
        # the snapshot re-encodes in its order, so every code keeps its
        # meaning: file-anchored device blocks hold codes
        for name, values in st.tag_dicts.items():
            region.registry.extend(name, values)
        region.next_seq = st.flushed_seq
        for entry in wal.replay(region_id, from_seq=st.flushed_seq):
            n = region.memtable.write(entry.batch, entry.seq, entry.op_type)
            region.next_seq = max(region.next_seq, entry.seq + n)
            region.replayed_entries += 1
        return region

    def drop(self) -> None:
        with self._lock:
            self.dropped = True
            self._drain_purge(force=True)
            self.wal.delete_region(self.region_id)
            for fid in list(self.files):
                self.sst_reader.delete(fid)
            self._invalidate_file_parts(list(self.files))
            self._notify("invalidate_region")
            self.manifest.destroy()
            self.files.clear()
            self._scan_cache.clear()
            self.memtable = Memtable(self.schema, self.registry)

    def close(self) -> None:
        """Release deferred resources (compacted-away SSTs) and the
        caches' entries of the region: a reopen starts cold."""
        with self._lock:
            self._drain_purge(force=True)
            self._notify("invalidate_region")
        self.wal.close_region(self.region_id)

    def _drain_purge(self, force: bool = False) -> None:
        """Delete deferred SSTs no scan pins (caller holds the lock)."""
        keep = []
        for fid in self._purge_queue:
            if self._file_refs.get(fid, 0) > 0 and not force:
                keep.append(fid)
            else:
                self.sst_reader.delete(fid)
        self._purge_queue = keep

    def _pin_files(self, metas) -> None:
        for m in metas:
            self._file_refs[m.file_id] = self._file_refs.get(m.file_id, 0) + 1

    def _unpin_files(self, metas) -> None:
        with self._lock:
            for m in metas:
                n = self._file_refs.get(m.file_id, 0) - 1
                if n <= 0:
                    self._file_refs.pop(m.file_id, None)
                else:
                    self._file_refs[m.file_id] = n
            if self._purge_queue:
                self._drain_purge()

    def _notify(self, fn_name: str, *args) -> None:
        """Invalidation fan-out to the query layer's caches keyed by file
        or region identity (the device hot sets and the partial-aggregate
        cache). A failure raises: no seam is skipped silently."""
        for cache in list(self.caches):
            getattr(cache, fn_name)(self.region_id, *args)

    # ---- write -------------------------------------------------------------

    def write(self, batch: RecordBatch, op_type: int = OP_PUT) -> int:
        """Durable write: WAL append and fsync, then the memtable.
        Returns the rows written."""
        n = batch.num_rows
        if n == 0:
            return 0
        with self._lock:
            if self.dropped:
                raise RegionDroppedError(
                    f"region {self.region_id} is dropped")
            self.wal.append(self.region_id, self.next_seq, op_type, batch)
            self.memtable.write(batch, self.next_seq, op_type)
            self.next_seq += n
            self.data_version += 1
        return n

    def load(self, columns: dict[str, np.ndarray],
             tag_dicts: dict[str, np.ndarray], seq: np.ndarray,
             op_type: np.ndarray) -> int:
        """Bulk-load already-encoded rows with their own sequences
        (interop.load_table): tag dictionaries seed the registry in their
        order so the codes keep their meaning, and the rows are flushed
        at once into an SST — they never pass through the WAL, whose
        frames carry contiguous sequences."""
        with self._lock:
            for name, values in tag_dicts.items():
                if self.registry.cardinality(name):
                    raise ValueError(f"region {self.region_id} already holds "
                                     f"tag values of {name!r}")
                self.registry.extend(name, values)
            n = self.memtable.append_encoded(columns, seq, op_type)
            if n:
                self.next_seq = max(self.next_seq, int(np.max(seq)) + 1)
                self.data_version += 1
                self._flush_locked()
        return n

    # ---- flush -------------------------------------------------------------

    def flush(self) -> Optional[FileMeta]:
        """Memtable -> sorted SST; manifest edit; WAL truncation."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> Optional[FileMeta]:
        self._drain_purge()
        data = self.memtable.concat()
        if data is None:
            return None
        cols, seq, op = data
        order = self._sort_order(cols, seq)
        sorted_cols = {k: v[order] for k, v in cols.items()}
        tag_dicts = {c.name: self.registry.dict_array(c.name)
                     for c in self.schema.tag_columns}
        meta = self.sst_writer.write(sorted_cols, tag_dicts, seq[order],
                                     op[order])
        self.files[meta.file_id] = meta
        self.manifest.record_flush([meta], flushed_seq=self.next_seq,
                                   tag_dicts=self.registry.snapshot())
        self.memtable = Memtable(self.schema, self.registry)
        self.wal.obsolete(self.region_id, self.next_seq)
        self.data_version += 1
        return meta

    def _sort_order(self, cols: dict[str, np.ndarray],
                    seq: np.ndarray) -> np.ndarray:
        keys = [seq, cols[self.schema.time_index.name]]
        for c in reversed(self.schema.tag_columns):
            keys.append(cols[c.name])
        return np.lexsort(keys)

    # ---- compaction (TWCS: merge within time windows) ----------------------

    def compact(self, strategy: str = "twcs") -> list[FileMeta]:
        """Compact SSTs. "twcs": time-window groups picked by TwcsPicker;
        "full": every file into one (ADMIN compact_table)."""
        with self._compact_lock:
            with self._lock:
                files = list(self.files.values())
            if strategy == "full":
                groups = [files] if len(files) > 1 else []
            else:
                groups = TwcsPicker().pick(files)
            out = []
            for group in groups:
                meta = self._merge_files(group)
                if meta is not None:
                    out.append(meta)
            return out

    def _merge_files(self, group: list[FileMeta]) -> Optional[FileMeta]:
        """Read `group`'s SSTs, sort-dedup on the engine's device, write
        one L1 file, swap it in through the manifest."""
        names = self.schema.names
        with self._lock:
            self._pin_files(group)
        try:
            entries = self._cached_parts(group, None, names, insert=False)
        finally:
            self._unpin_files(group)
        parts = [e.part for e in entries if e.part is not None]
        if not parts:
            return None
        columns = {n: np.concatenate([p[0][n] for p in parts])
                   for n in names}
        seq = np.concatenate([p[1] for p in parts])
        op = np.concatenate([p[2] for p in parts])
        n_rows = len(seq)

        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        tag_names = [c.name for c in self.schema.tag_columns]
        sizes = [max(self.registry.cardinality(n), 1) + 1 for n in tag_names]
        if tag_names:
            # int64: the cardinality product of several tags can pass 2^31
            sid = combine_group_ids([up(columns[n]) + 1 for n in tag_names],
                                    sizes, dtype=torch.int64)
        else:
            sid = torch.zeros(n_rows, dtype=torch.int64, device=dev)
        covers_all = len(group) == len(self.files)
        order, keep = dedup.sort_dedup(
            sid, up(columns[self.schema.time_index.name]), up(seq), up(op),
            torch.ones(n_rows, dtype=torch.bool, device=dev),
            keep_tombstones=not covers_all)
        order = order[keep].cpu().numpy()
        cols = {k: v[order] for k, v in columns.items()}
        tag_dicts = {n: self.registry.dict_array(n) for n in tag_names}
        meta = self.sst_writer.write(cols, tag_dicts, seq[order], op[order],
                                     level=1)
        removed = [f.file_id for f in group]
        with self._lock:
            for fid in removed:
                self.files.pop(fid, None)
            self.files[meta.file_id] = meta
            # the inputs' decoded parts and device blocks die with them
            self._invalidate_file_parts(removed)
            # flushed_seq=None: this edit persists no memtable rows;
            # advancing it would mark unflushed writes replay-obsolete
            self.manifest.record_flush([meta], flushed_seq=None,
                                       tag_dicts=self.registry.snapshot(),
                                       removed=removed)
            # deferred deletion: a concurrent scan may still read them
            self._purge_queue.extend(removed)
            self._drain_purge()
            self.data_version += 1
        return meta

    # ---- decoded-part cache ------------------------------------------------

    def _part_cache_put(self, key: tuple, ent: _PartEntry) -> None:
        """Insert under the byte budget (caller holds the lock)."""
        if ent.nbytes > self.part_cache_budget:
            return
        old = self._part_cache.pop(key, None)
        if old is not None:
            self._part_cache_bytes -= old.nbytes
        self._part_cache[key] = ent
        self._part_cache_bytes += ent.nbytes
        while self._part_cache_bytes > self.part_cache_budget:
            _, e = self._part_cache.popitem(last=False)
            self._part_cache_bytes -= e.nbytes

    def _invalidate_file_parts(self, file_ids) -> None:
        """Drop decoded parts and device blocks of removed SSTs
        (compaction swap, DROP/TRUNCATE). Caller holds the lock."""
        gone = set(file_ids)
        for k in [k for k in self._part_cache if k[0] in gone]:
            self._part_cache_bytes -= self._part_cache.pop(k).nbytes
        self._notify("invalidate_files", gone)

    def _cached_parts(self, file_list, ts_range, names,
                      insert: bool = True) -> list[_PartEntry]:
        """Decoded parts of `file_list` (pinned by the caller) through
        the part cache. `insert=False` reuses hits but keeps misses out
        (compaction reads its doomed inputs once)."""
        keys = [(m.file_id, ts_range, tuple(names)) for m in file_list]
        out: list = [None] * len(file_list)
        with self._lock:
            for i, k in enumerate(keys):
                ent = self._part_cache.get(k)
                if ent is not None:
                    self._part_cache.move_to_end(k)
                    out[i] = ent
        for i, meta in enumerate(file_list):
            if out[i] is not None:
                continue
            part = self._decode_file_part(meta, ts_range, names)
            out[i] = _PartEntry(part, _part_nbytes(part))
            with self._lock:
                # a file compacted away while it decoded must not strand
                # its part in the budget
                if insert and meta.file_id in self.files:
                    self._part_cache_put(keys[i], out[i])
        return out

    def _decode_file_part(self, meta: FileMeta, ts_range,
                          names) -> Optional[tuple]:
        """One SST's rows under the shape: (cols, seq, op) or None."""
        part = self.sst_reader.read(meta, self.schema, ts_range, names)
        if part is None or part.num_rows == 0:
            return None
        return self._decode_table_part(part, ts_range, names)

    def _decode_table_part(self, part, ts_range, names) -> Optional[tuple]:
        """Decoded row groups -> (cols, seq, op) with the exact ts row
        filter: SSTs sort by (tags, ts), so a row group of one large flush
        spans the whole time range and its stats cannot prune it; the
        filter keeps device transfer and kernels to the queried window.
        All versions and tombstones of an instant share its ts, so the
        dedup still sees every candidate."""
        cols = self._decode_sst(part, names)
        seq = part.columns[SEQ_COL]
        op = part.columns[OP_COL]
        if ts_range is not None:
            tsv = cols[self.schema.time_index.name]
            # [lo, hi): extract_ts_bounds emits half-open upper bounds
            m = (tsv >= ts_range[0]) & (tsv < ts_range[1])
            if not m.all():
                if not m.any():
                    return None
                cols = {n: v[m] for n, v in cols.items()}
                seq = seq[m]
                op = op[m]
        return cols, seq, op

    def _decode_sst(self, part, names) -> dict[str, np.ndarray]:
        """File columns -> region columns: tags remapped into the
        registry, string fields decoded, columns the file predates
        (ALTER ADD) backfilled with the default, else NULL."""
        cols: dict[str, np.ndarray] = {}
        n = part.num_rows
        for c in self.schema.columns:
            if c.name not in names:
                continue
            arr = part.columns.get(c.name)
            if arr is None:
                if c.semantic is SemanticType.TAG:
                    cols[c.name] = np.full(n, -1, dtype=np.int32)
                elif c.dtype.is_string:
                    cols[c.name] = np.full(n, c.default, dtype=object)
                elif c.dtype.is_float:
                    fill = np.nan if c.default is None else float(c.default)
                    cols[c.name] = np.full(n, fill, dtype=c.dtype.to_numpy())
                else:
                    fill = c.default if c.default is not None else 0
                    cols[c.name] = np.full(n, fill, dtype=c.dtype.to_numpy())
            elif c.semantic is SemanticType.TAG:
                mapping = self.registry.remap_dict(c.name,
                                                   part.dicts[c.name])
                cols[c.name] = remap_codes(arr, mapping)
            elif c.dtype.is_string:
                cols[c.name] = DictVector(arr, part.dicts[c.name]).decode()
            else:
                cols[c.name] = arr
        return cols

    # ---- scan --------------------------------------------------------------

    def _tag_inset_mask(self, tag_predicates, columns):
        """Row mask for the InSet (=/IN) parts of the tag predicates over
        region-code columns, or None when no InSet applies. Range/Regex
        predicates stay with the device filter."""
        keep = None
        for tag, preds in normalize_predicates(tag_predicates).items():
            if tag not in columns:
                continue
            allowed = None
            for p in preds:
                if isinstance(p, InSet):
                    s = set(p.values)
                    allowed = s if allowed is None else (allowed & s)
            if allowed is None:
                continue
            d = self.registry.dict_array(tag)
            codes = [c for v in allowed
                     for c in np.flatnonzero(d == v).tolist()]
            m = np.isin(columns[tag], np.asarray(codes, dtype=np.int64))
            keep = m if keep is None else (keep & m)
        return keep

    def _widen_covering_range(self, ts_range):
        """None when `ts_range` covers at least half of the region's data
        span (serve the canonical full scan), else unchanged."""
        if ts_range is None:
            return None
        ext = self.ts_extent()
        if ext is None:
            return ts_range
        lo, hi = ts_range
        glo, ghi = ext
        if lo <= glo and hi > ghi:
            return None  # covers everything: exactly the full scan
        covered = min(hi, ghi + 1) - max(lo, glo)
        return None if 2 * covered >= (ghi + 1 - glo) else ts_range

    def scan(
        self,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
        tag_predicates: Optional[dict] = None,
    ) -> Optional[ScanData]:
        """Memtable + pruned SSTs as concatenated host columns, or None
        when there are no rows. Tag predicates keep whole series, so
        last-write-wins and tombstones stay intact; the device WHERE
        still evaluates every predicate exactly."""
        names = self._scan_columns(projection)
        pred_key = predicates_cache_key(tag_predicates)
        if not tag_predicates:
            ts_range = self._widen_covering_range(ts_range)
        with self._lock:
            version = self.data_version
            cache_key = (version, ts_range, tuple(names), pred_key)
            cached = self._scan_cache.get(cache_key)
            if cached is not None:
                self._scan_cache.move_to_end(cache_key)
                return cached
            file_list = list(self.files.values())
            self._pin_files(file_list)
            mem = self.memtable.concat(ts_range)
        try:
            entries = self._cached_parts(file_list, ts_range, names)
        finally:
            self._unpin_files(file_list)
        parts_cols, parts_seq, parts_op = [], [], []
        part_lens, part_keys = [], []
        for meta, ent in zip(file_list, entries):
            if ent.part is None:
                continue
            cols, seq_col, op_col = ent.part
            parts_cols.append(cols)
            parts_seq.append(seq_col)
            parts_op.append(op_col)
            part_lens.append(len(seq_col))
            part_keys.append((meta.file_id, ts_range, pred_key))
        if mem is not None:
            mcols, mseq, mop = mem
            parts_cols.append({n: mcols[n] for n in names})
            parts_seq.append(mseq)
            parts_op.append(mop)
        if not parts_cols:
            return None
        if len(parts_cols) == 1:
            columns = dict(parts_cols[0])
            seq, op = parts_seq[0], parts_op[0]
        else:
            columns = {n: np.concatenate([p[n] for p in parts_cols])
                       for n in names}
            seq = np.concatenate(parts_seq)
            op = np.concatenate(parts_op)
        part_offsets = np.cumsum([0] + part_lens)
        if tag_predicates:
            keep = self._tag_inset_mask(tag_predicates, columns)
            if keep is not None and not keep.all():
                idx = np.flatnonzero(keep)
                if idx.size == 0:
                    return None
                columns = {n: v[idx] for n, v in columns.items()}
                seq, op = seq[idx], op[idx]
                # an ascending gather keeps each part's order; its
                # boundaries shift to the kept rows before each offset
                part_offsets = np.searchsorted(idx, part_offsets)
        tag_dicts = {c.name: self.registry.dict_array(c.name)
                     for c in self.schema.tag_columns if c.name in names}
        result = ScanData(
            schema=self.schema, columns=columns, seq=seq, op_type=op,
            tag_dicts=tag_dicts, num_rows=len(seq),
            region_id=self.region_id, data_version=version,
            incarnation=self.incarnation,
            scan_fingerprint=(ts_range, tuple(names), pred_key),
            sorted_part_offsets=tuple(int(o) for o in part_offsets),
            part_keys=tuple(part_keys))
        with self._lock:
            self._scan_cache_put(cache_key, result)
        return result

    def _scan_cache_put(self, key: tuple, result: ScanData) -> None:
        """Insert a snapshot, evicting the oldest past the entry budget
        (caller holds the lock)."""
        self._scan_cache[key] = result
        while len(self._scan_cache) > self.scan_cache_entries:
            self._scan_cache.popitem(last=False)

    def scan_last(self, group_tag: str,
                  projection: Optional[Sequence[str]] = None,
                  ) -> Optional[ScanData]:
        """Lastpoint-pruned scan (the JAX region's scan_last): visit SSTs
        newest-first and stop once every series grouped by `group_tag`
        provably holds its last row in the visited set.

        Files go in descending (ts_max, max_seq, file_id), so every
        unvisited file holds only rows with ts <= the next file's ts_max.
        Once a series has a candidate with ts STRICTLY above that bound
        (an equal ts in an older file could carry a higher seq and win
        last-write-wins), no unvisited file holds its winner. The known
        series are the registry's codes (a superset of live values: a
        code with no rows blocks the early stop, which costs pruning,
        never correctness). The NULL group waits while an unvisited file
        may hold it (FileMeta.null_tags; None means unknown, assumed to).
        Decoding is serial, so the stop test runs after every file.

        Returns None when any DELETE tombstone is in the memtable or a
        visited file (the newest row may be a tombstone, making an
        interior row the answer): the caller runs the full scan."""
        names = self._scan_columns(projection)
        tag_names = [c.name for c in self.schema.tag_columns]
        if group_tag not in tag_names or group_tag not in names:
            return None
        pred_key = predicates_cache_key(None)
        ts_name = self.schema.time_index.name
        with self._lock:
            version = self.data_version
            cache_key = ("lastpoint", version, group_tag, tuple(names))
            cached = self._scan_cache.get(cache_key)
            if cached is not None:
                self._scan_cache.move_to_end(cache_key)
                cached.stats["cache_hits"] += 1
                return cached
            file_list = sorted(
                self.files.values(),
                key=lambda m: (m.ts_max, m.max_seq, m.file_id),
                reverse=True)
            self._pin_files(file_list)
            mem = self.memtable.concat(None)
            card = self.registry.cardinality(group_tag)
        # suffix_null[i]: may any of file_list[i:] hold a NULL group_tag?
        suffix_null = [False] * (len(file_list) + 1)
        for i in range(len(file_list) - 1, -1, -1):
            m = file_list[i]
            has = m.null_tags is None or group_tag in m.null_tags
            suffix_null[i] = suffix_null[i + 1] or has
        # best[0]: newest ts seen for the NULL group, best[1 + code] for
        # each registry code; int64 min = never seen
        floor = np.iinfo(np.int64).min
        best = np.full(card + 1, floor, dtype=np.int64)

        def fold(codes: np.ndarray, ts: np.ndarray) -> None:
            nonlocal best
            if codes.size == 0:
                return
            slot = codes.astype(np.int64) + 1
            mx = int(slot.max())
            if mx >= best.size:
                # codes the registry snapshot predates: seen here, so
                # their entries are live
                best = np.concatenate(
                    [best, np.full(mx + 1 - best.size, floor,
                                   dtype=np.int64)])
            np.maximum.at(best, slot, ts.astype(np.int64))

        aborted = False
        if mem is not None:
            mcols, _mseq, mop = mem
            if bool((mop != OP_PUT).any()):
                aborted = True
            else:
                fold(mcols[group_tag], mcols[ts_name])
        visited_entries: list = []
        try:
            while not aborted and len(visited_entries) < len(file_list):
                meta = file_list[len(visited_entries)]
                (ent,) = self._cached_parts([meta], None, names)
                visited_entries.append(ent)
                if ent.part is not None:
                    cols, _seq_col, op_col = ent.part
                    if bool((op_col != OP_PUT).any()):
                        aborted = True
                        break
                    fold(cols[group_tag], cols[ts_name])
                visited = len(visited_entries)
                if visited >= len(file_list):
                    break
                nxt = file_list[visited].ts_max
                if bool((best[1:] > nxt).all()) and \
                        (not suffix_null[visited] or best[0] > nxt):
                    break
        finally:
            self._unpin_files(file_list)
        if aborted:
            return None
        parts_cols, parts_seq, parts_op = [], [], []
        part_lens, part_keys = [], []
        for meta, ent in zip(file_list, visited_entries):
            if ent.part is None:
                continue
            cols, seq_col, op_col = ent.part
            parts_cols.append(cols)
            parts_seq.append(seq_col)
            parts_op.append(op_col)
            part_lens.append(len(seq_col))
            # whole-file parts (no window, no predicates): their device
            # blocks are the full scan's blocks of the same file
            part_keys.append((meta.file_id, None, pred_key))
        if mem is not None:
            mcols, mseq, mop = mem
            parts_cols.append({n: mcols[n] for n in names})
            parts_seq.append(mseq)
            parts_op.append(mop)
        if not parts_cols:
            return None
        if len(parts_cols) == 1:
            columns = dict(parts_cols[0])
            seq, op = parts_seq[0], parts_op[0]
        else:
            columns = {n: np.concatenate([p[n] for p in parts_cols])
                       for n in names}
            seq = np.concatenate(parts_seq)
            op = np.concatenate(parts_op)
        visited = len(visited_entries)
        result = ScanData(
            schema=self.schema, columns=columns, seq=seq, op_type=op,
            tag_dicts={c.name: self.registry.dict_array(c.name)
                       for c in self.schema.tag_columns if c.name in names},
            num_rows=len(seq), region_id=self.region_id,
            data_version=version, incarnation=self.incarnation,
            # distinct from every full scan: the row set is pruned, so
            # snapshot-keyed device blocks are never shared with one
            scan_fingerprint=("lastpoint", group_tag, tuple(names)),
            sorted_part_offsets=tuple(
                int(o) for o in np.cumsum([0] + part_lens)),
            part_keys=tuple(part_keys),
            stats={"ssts": len(file_list),
                   "ssts_pruned": len(file_list) - visited,
                   "lastpoint_visited": visited, "cache_hits": 0})
        with self._lock:
            self._scan_cache_put(cache_key, result)
        return result

    def scan_stream(
        self,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
        groups_per_chunk: int = 8,
    ) -> Optional[ScanStream]:
        """Lazy bounded-memory scan (see ScanStream), or None when the time
        range prunes every file and the memtable. Chunks come in file
        order, then the memtable's rows; each file chunk is
        `groups_per_chunk` row groups through `_decode_sst` (tags remapped
        into the registry, ALTER ADD columns backfilled). Rows are not
        ts-filtered: the device WHERE is exact."""
        names = self._scan_columns(projection)
        with self._lock:
            snapshot_files = list(self.files.values())
            self._pin_files(snapshot_files)
            # memtable chunks are immutable once appended: the list is the
            # snapshot, concatenated only when the stream reaches it
            mem = self.memtable
            mem_chunks = list(mem.chunks)
            mem_bounds = (mem.ts_min, mem.ts_max)
        if mem_chunks and ts_range is not None and (
                mem_bounds[1] < ts_range[0] or mem_bounds[0] >= ts_range[1]):
            mem_chunks = []  # the coarse range check of Memtable.concat
        files = [m for m in snapshot_files
                 if ts_range is None
                 or (m.ts_max >= ts_range[0] and m.ts_min < ts_range[1])]
        if not files and not mem_chunks:
            self._unpin_files(snapshot_files)
            return None
        bounds = [(m.ts_min, m.ts_max) for m in files]
        mem_rows = sum(len(c.seq) for c in mem_chunks)
        if mem_rows:
            bounds.append(mem_bounds)
        unpinned = [False]

        def unpin_once():
            if not unpinned[0]:
                unpinned[0] = True
                self._unpin_files(snapshot_files)

        def gen():
            try:
                for meta in files:
                    for part in self.sst_reader.iter_chunks(
                            meta, self.schema, ts_range, names,
                            groups_per_chunk):
                        n = part.num_rows
                        cols = self._decode_sst(part, names)
                        # hold one decoded chunk at a time
                        del part
                        if n:
                            yield cols, n
                        del cols
                if mem_rows:
                    yield {n: np.concatenate([c.columns[n]
                                              for c in mem_chunks])
                           for n in names}, mem_rows
            finally:
                unpin_once()

        def tag_dicts():
            return {c.name: self.registry.dict_array(c.name)
                    for c in self.schema.tag_columns if c.name in names}

        return ScanStream(
            est_rows=sum(m.num_rows for m in files) + mem_rows,
            ts_min=min(b[0] for b in bounds),
            ts_max=max(b[1] for b in bounds),
            _tag_dicts=tag_dicts, _chunks=gen, _close=unpin_once)

    def _scan_columns(self, projection: Optional[Sequence[str]]) -> list[str]:
        ts_name = self.schema.time_index.name
        if projection is None:
            return self.schema.names
        names = list(dict.fromkeys(projection))
        if ts_name not in names:
            names.append(ts_name)
        # dedup correctness needs the full primary key
        for c in self.schema.tag_columns:
            if c.name not in names:
                names.append(c.name)
        return [n for n in self.schema.names if n in names]

    # ---- stats -------------------------------------------------------------

    def ts_extent(self) -> Optional[tuple[int, int]]:
        """(min, max) timestamp over SST metas + memtable, or None when
        the region is empty: metadata only, no data read."""
        with self._lock:
            bounds = [(m.ts_min, m.ts_max) for m in self.files.values()]
            if self.memtable.ts_min is not None:
                bounds.append((self.memtable.ts_min, self.memtable.ts_max))
        if not bounds:
            return None
        return (min(b[0] for b in bounds), max(b[1] for b in bounds))

    @property
    def memtable_bytes(self) -> int:
        return self.memtable.bytes_estimate

    @property
    def sst_bytes(self) -> int:
        with self._lock:
            return sum(m.size_bytes for m in self.files.values())
