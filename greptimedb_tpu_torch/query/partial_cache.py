"""Partial-aggregate cache (counterpart of
greptimedb_tpu/query/partial_cache.py): per-part partial planes and
delta-only folding.

An immutable SST part's contribution to a given aggregate shape is a
FIXED plane: its rows never change until compaction or DROP rewrites the
file, so re-reducing the part on every query is waste. This module
memoizes the aggregated partials themselves, so an eligible aggregate
runs as

    gather cached part partials
      -> compute partials only for uncached parts + the memtable delta
         (on the card: K1 or K2, the route the classic path takes)
      -> combine by group-key VALUE (query/dist_agg.combine_partials)
      -> the shared final step (PhysicalExecutor._finalize_combined_agg)

Entries are value-space partials, ``{"keys": [per-key decoded value
arrays], "planes": {op: [G_part, F]}}``. Caching VALUES (not dictionary
codes) makes entries immune to tag-dictionary growth between flushes.

Keys ``("part", region_id, file_id, part_ts_range, pred_key, shape_fp)``
anchor to the immutable file (and the window/predicate that selected its
rows) and a canonical plan-shape fingerprint. They survive data-version
bumps, so a flush leaves every cached partial valid and adds only the
new file's rows to the delta, and they die through the region seams that
kill the device hot set's file blocks (storage/region.py: compaction
swap, DROP, TRUNCATE, close): the executor adds the process-wide cache
to RegionEngine.caches beside its hot set.

DELETE voids the per-part decomposition (a tombstone may mask rows in a
different part), so the executor falls back to the classic whole-scan
fold: a typed decision (PartialCacheIneligible), never an error.

The cache counts its events in `events` ("hit", "miss", "evict",
"invalidate" and the executor's "fallback") and its resident bytes in
`bytes`, mirrored in the JAX package's `partial_agg_cache_*` series and
the request ledger's `cache.partial_agg.*`. This module imports numpy
and the port's light utils only.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.utils import ledger
from greptimedb_tpu_torch.utils.metrics import (
    PARTIAL_AGG_CACHE_BYTES,
    PARTIAL_AGG_CACHE_EVENTS,
)

class PartialCacheIneligible(Exception):
    """This scan/shape cannot ride the incremental per-part fold; the
    executor serves it through the classic whole-scan routes (a typed
    decision about the plan: the same rows, another `last_path`)."""


def enabled() -> bool:
    """[query] partial_cache / GREPTIMEDB_TPU_PARTIAL_CACHE; on by
    default."""
    return os.environ.get("GREPTIMEDB_TPU_PARTIAL_CACHE", "1").lower() \
        not in ("0", "false", "off")


def budget_bytes() -> int:
    """[query] partial_cache_bytes / GREPTIMEDB_TPU_PARTIAL_CACHE_BYTES
    (<= 0 = auto, matching the option doc); partials are [G, F] planes
    (KBs each), so a modest default covers thousands of (part, shape)
    combinations."""
    env = os.environ.get("GREPTIMEDB_TPU_PARTIAL_CACHE_BYTES")
    try:
        v = int(env) if env else 0
    except ValueError:
        v = 0
    return v if v > 0 else (256 << 20)


def groups_max() -> int:
    """Largest dense group count the incremental path materializes per
    part ([G, F] readback per part; beyond this the classic single-
    readback fold wins)."""
    return int(os.environ.get("GREPTIMEDB_TPU_PARTIAL_CACHE_GROUPS_MAX",
                              str(1 << 16)))


#: accounted floor per entry: dict/tuple overhead + the key itself —
#: without it, empty partials cost 0 accounted bytes and the byte budget
#: would never bound their COUNT
_ENTRY_OVERHEAD = 512


def partial_nbytes(partial: dict) -> int:
    """Approximate host bytes of one cached partial (planes + decoded
    key columns; object arrays estimate ~48 B/element for the boxed
    strings the pointer-width nbytes hides)."""
    total = _ENTRY_OVERHEAD
    for arr in partial.get("planes", {}).values():
        total += int(np.asarray(arr).nbytes)
    for arr in partial.get("keys", ()):
        a = np.asarray(arr)
        total += int(a.nbytes) + (48 * len(a) if a.dtype == object else 0)
    return total


class PartialAggCache:
    """Bytes-budgeted LRU of host-side partial-aggregate planes.
    Thread-safe; `put` runs under the same dead-file tombstone guard as
    the device hot set — a partial computed for a file that died while
    the fold was in flight never becomes resident."""

    _DEAD_FILES_CAP = 4096

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget if budget is not None else budget_bytes()
        #: counts by event: hit, miss, evict, invalidate, fallback
        self.events = {"hit": 0, "miss": 0, "evict": 0, "invalidate": 0,
                       "fallback": 0}
        self._lru: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> (partial, nbytes)
        self._bytes = 0
        self._lock = threading.Lock()
        self._dead_files: "OrderedDict[tuple, None]" = OrderedDict()
        # per-region epoch: data versions and files restart after
        # TRUNCATE recreates the region, so invalidate_region bumps the
        # epoch and in-flight puts started under the old one are refused
        self._region_epoch: dict[int, int] = {}

    def epoch(self, region_id: int) -> int:
        with self._lock:
            return self._region_epoch.get(region_id, 0)

    def get(self, key: tuple) -> Optional[dict]:
        with self._lock:
            hit = self._lru.get(key)
            if hit is None:
                self.events["miss"] += 1
            else:
                self._lru.move_to_end(key)
                self.events["hit"] += 1
        event = "miss" if hit is None else "hit"
        PARTIAL_AGG_CACHE_EVENTS.inc(event=event)
        ledger.cache_event("partial_agg", event)
        return None if hit is None else hit[0]

    def count_event(self, event: str, n: int = 1) -> None:
        with self._lock:
            self.events[event] += n
        PARTIAL_AGG_CACHE_EVENTS.inc(float(n), event=event)

    def put(self, key: tuple, partial: dict,
            epoch: Optional[int] = None) -> None:
        nbytes = partial_nbytes(partial)
        if nbytes > self.budget:
            return  # an entry that can never fit must not wipe the cache
        evictions = 0
        with self._lock:
            region = key[1]  # ("part", region_id, file_id, ...)
            if (region, key[2]) in self._dead_files:
                # the file died while this partial was computing: the
                # caller's scan pinned it (its result is fine), but the
                # dead key must never become resident
                return
            if epoch is not None \
                    and self._region_epoch.get(region, 0) != epoch:
                # region invalidated (TRUNCATE/DROP/close) mid-compute
                return
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._lru[key] = (partial, nbytes)
            self._bytes += nbytes
            while self._bytes > self.budget and self._lru:
                _, (_, nb) = self._lru.popitem(last=False)
                self._bytes -= nb
                evictions += 1
            self.events["evict"] += evictions
            PARTIAL_AGG_CACHE_BYTES.set(float(self._bytes))
        if evictions:
            PARTIAL_AGG_CACHE_EVENTS.inc(float(evictions), event="evict")

    def _drop_locked(self, pred) -> int:
        doomed = [k for k in self._lru if pred(k)]
        for k in doomed:
            _, nb = self._lru.pop(k)
            self._bytes -= nb
        if doomed:
            PARTIAL_AGG_CACHE_BYTES.set(float(self._bytes))
            PARTIAL_AGG_CACHE_EVENTS.inc(float(len(doomed)),
                                         event="invalidate")
        return len(doomed)

    def invalidate_files(self, region_id: int, file_ids) -> None:
        """Drop the part entries of dead SSTs (compaction swap) and
        refuse later puts for them."""
        gone = set(file_ids)
        with self._lock:
            for fid in gone:
                self._dead_files[(region_id, fid)] = None
                self._dead_files.move_to_end((region_id, fid))
            while len(self._dead_files) > self._DEAD_FILES_CAP:
                self._dead_files.popitem(last=False)
            n = self._drop_locked(
                lambda k: k[1] == region_id and k[2] in gone)
            self.events["invalidate"] += n

    def invalidate_region(self, region_id: int) -> None:
        """Drop every entry of a region (DROP, TRUNCATE, close) and bump
        its epoch."""
        with self._lock:
            n = self._drop_locked(lambda k: k[1] == region_id)
            self._region_epoch[region_id] = \
                self._region_epoch.get(region_id, 0) + 1
            self.events["invalidate"] += n

    def part_keys(self, region_id: Optional[int] = None) -> list:
        """Resident part-anchored keys (diagnostics + tests)."""
        with self._lock:
            return [k for k in self._lru
                    if region_id is None or k[1] == region_id]

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._bytes = 0
        PARTIAL_AGG_CACHE_BYTES.set(0.0)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes


_GLOBAL: Optional[PartialAggCache] = None
_GLOBAL_LOCK = threading.Lock()


def global_cache() -> PartialAggCache:
    """The process-wide cache: every executor shares ONE byte budget
    (per-executor budgets would multiply under threaded servers)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = PartialAggCache()
        return _GLOBAL


def canonical_key(k, kexpr) -> tuple:
    """Canonical form of one group key for the shape fingerprint: tag
    cardinality and bucket base/size are EXCLUDED on purpose — cached
    partials hold decoded VALUES, which are invariant to dictionary
    growth and to the scan extent the dense id spaces derive from.
    Generic ("pre") keys canonicalize by the ORIGINAL expression, not
    the per-scan factorized column name. Only what changes the per-part
    VALUES may enter the fingerprint."""
    if k.kind == "tag":
        return ("tag", k.column)
    if k.kind == "bucket":
        return ("bucket", k.column, k.step)
    return ("pre", repr(kexpr))


def shape_fingerprint(bound_where, keys, key_exprs, arg_exprs, ops,
                      acc_dtype) -> tuple:
    """Canonical plan-shape fingerprint: everything that changes a
    part's [G, F] partial VALUES. `bound_where` reprs with tag literals
    already rewritten to dictionary codes — append-only dictionaries
    keep those codes stable, and TRUNCATE (which resets them) kills the
    region's entries wholesale."""
    return (
        tuple(canonical_key(k, e) for k, e in zip(keys, key_exprs)),
        repr(bound_where),
        tuple(repr(a) for a in arg_exprs),
        tuple(ops),
        str(acc_dtype),
    )
