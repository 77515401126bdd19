"""Downsample/rollup jobs + query-time rollup substitution (copy of
greptimedb_tpu/maintenance/rollup.py).

A rollup job re-encodes a raw region's INACTIVE time windows (everything
strictly before the resolution bucket holding the newest raw timestamp)
into a coarser-resolution "plane" region: one row per (tags..., bucket)
carrying, for every numeric field `f`, the planes `f__min`, `f__max`,
`f__sum` (float64) and `f__count` (int64), plus `rows__count` (the raw
row count, for count(*)). On the engine's device the rows go through the
sort-dedup (ops/dedup.py), the (tags, bucket) groups fall out of the
sorted order as runs, and ONE K2 call
(ops/segment_kernels.fused_segment_agg on the [N x F] float64 field
plane, with min and max) yields every plane: the JAX package's four
segment reductions a field. The plane rows are then written through the
ordinary region write/flush path: rollup SSTs are plain SSTs in a hidden
companion region whose id embeds the raw region id and the rule slot.

Query-time substitution: an aggregate query whose group keys are tags
and/or a `date_bin`/`time_bucket` key at a multiple of the rollup
resolution, whose aggregates are min/max/sum/count/avg over plain field
columns, and whose WHERE is (aligned time range) AND (tag-only
predicates) is rewritten to scan the rollup region instead — e.g.
`avg(v)` becomes `sum(v__sum) / sum(v__count)`. Coverage and staleness
are checked per region: the queried range must sit inside the rolled-up
span, and any raw data newer than the rollup's `as_of_seq` overlapping
that span (a late/out-of-order write) disqualifies the substitution
until the next rollup run re-covers it. Re-runs are idempotent: rollup
rows share the (tags, bucket) primary key, so last-write-wins dedup
makes the newest run authoritative.

Crash safety: the coverage state file is written only AFTER the rollup
SST is durable; a crash mid-job leaves coverage un-advanced (the raw
data keeps serving queries) and the next run overwrites the partial
rows.

The distributed substitution: a cluster frontend (whose router offers
`rollup_probe`) classifies the statement, asks each raw region's owner
which rules cover the window (`probe_region_rollups`, the datanode half,
over Flight's `rollup_probe` action on a wire router), and, when every
region's companion covers it at a common resolution, re-plans over the
companion region ids: the fragments the router ships are ordinary
partial-agg fragments over the plane regions (`last_path`
`pushdown+rollup`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.datatypes.vector import DictVector
from greptimedb_tpu_torch.fault import FAULTS
from greptimedb_tpu_torch.maintenance.retention import ms_to_units
from greptimedb_tpu_torch.objectstore import ObjectStoreError
from greptimedb_tpu_torch.ops import dedup, segment_kernels
from greptimedb_tpu_torch.ops.segment import combine_group_ids
from greptimedb_tpu_torch.utils.metrics import ROLLUP_SUBSTITUTIONS

#: bit added to a raw region id to name its rollup companion; the rule
#: SLOT rides in bits 20.. so several resolutions coexist. Raw region
#: ids are (table_id << 32) | region_idx with small region_idx, so the
#: flag can't collide with a real region.
ROLLUP_RID_FLAG = 1 << 30
ROWS_COL = "rows__count"

_STATE_FILE = "rollup_state.json"


def rule_slot(resolution_ms: int) -> int:
    """Stable slot for a resolution: derived from the resolution itself
    (not list position), so the rollup region id survives restarts and
    config reordering. Collisions across distinct resolutions are
    possible but self-correcting — the region's state file records its
    resolution and a mismatch reads as 'no coverage'."""
    return zlib.crc32(b"rollup:%d" % int(resolution_ms)) % 509


@dataclass
class RollupRule:
    """One [[maintenance.rollup]] entry: the target resolution and which
    fields get planes (empty = every numeric field)."""

    resolution_ms: int = 60_000
    fields: tuple = ()
    #: submitted automatically on every scheduler tick (vs ADMIN-only)
    auto: bool = True

    @staticmethod
    def from_dict(d: dict) -> "RollupRule":
        from greptimedb_tpu_torch.maintenance.scheduler import (
            parse_duration_ms,
        )

        res = d.get("resolution_ms") or parse_duration_ms(
            d.get("resolution", "1m"))
        return RollupRule(resolution_ms=int(res),
                          fields=tuple(d.get("fields", ())),
                          auto=bool(d.get("auto", True)))


def rollup_region_id(raw_rid: int, rule_idx: int = 0) -> int:
    return raw_rid + ROLLUP_RID_FLAG + (rule_idx << 20)


def plane_fields(schema, rule: Optional[RollupRule] = None) -> list:
    """The raw FIELD columns that get rollup planes: numeric, and listed
    in the rule (when the rule names fields)."""
    out = []
    for c in schema.field_columns:
        if not (c.dtype.is_float or c.dtype.value.startswith(("int", "uint"))):
            continue
        if rule is not None and rule.fields and c.name not in rule.fields:
            continue
        out.append(c)
    return out


def rollup_schema(raw_schema, rule: Optional[RollupRule] = None):
    """Derive the plane schema: same tags + time index, plane fields."""
    cols = [dataclasses.replace(c) for c in raw_schema.tag_columns]
    cols.append(dataclasses.replace(raw_schema.time_index))
    for f in plane_fields(raw_schema, rule):
        cols.append(ColumnSchema(f"{f.name}__min", f.dtype,
                                 SemanticType.FIELD, True))
        cols.append(ColumnSchema(f"{f.name}__max", f.dtype,
                                 SemanticType.FIELD, True))
        cols.append(ColumnSchema(f"{f.name}__sum", DataType.FLOAT64,
                                 SemanticType.FIELD, True))
        cols.append(ColumnSchema(f"{f.name}__count", DataType.INT64,
                                 SemanticType.FIELD, True))
    cols.append(ColumnSchema(ROWS_COL, DataType.INT64,
                             SemanticType.FIELD, True))
    return Schema(cols)


# ---- coverage state ---------------------------------------------------------


def _state_path(region_dir: str) -> str:
    return os.path.join(region_dir, _STATE_FILE)


#: read_state cache: path -> (monotonic deadline, state). Substitution
#: probes coverage on EVERY eligible aggregate query; on a remote object
#: store that is a GET per region per rule per query without this. The
#: short TTL only delays when a FRESH rollup becomes visible — staleness
#: in the other direction (late raw writes) is caught by the metadata
#: _late_data_since check, which never touches the store.
_STATE_TTL_S = 2.0
_state_cache: dict = {}
_state_lock = threading.Lock()

#: bumped on every rollup-substitution state change (a finished roll, a
#: dropped companion). The frontend plan cache stamps its memoized
#: "substitution ineligible — skip the probe" decisions with this
#: version, so a state change evicts those stale shapes immediately.
_sub_state_version = 0


def substitution_state_version() -> int:
    with _state_lock:
        return _sub_state_version


def _bump_substitution_state() -> None:
    global _sub_state_version
    with _state_lock:
        _sub_state_version += 1


def read_state(store, region_dir: str) -> Optional[dict]:
    path = _state_path(region_dir)
    now = time.monotonic()
    with _state_lock:
        hit = _state_cache.get(path)
        if hit is not None and hit[0] > now:
            return hit[1]
    try:
        state = json.loads(store.read(path).decode())
    except (ObjectStoreError, ValueError):  # absent or corrupt: no coverage
        state = None
    with _state_lock:
        _state_cache[path] = (now + _STATE_TTL_S, state)
    return state


def write_state(store, region_dir: str, state: dict) -> None:
    path = _state_path(region_dir)
    store.write(path, json.dumps(state).encode())
    with _state_lock:
        _state_cache[path] = (time.monotonic() + _STATE_TTL_S, dict(state))
    _bump_substitution_state()


# ---- the job ---------------------------------------------------------------


def _ensure_rollup_region(engine, raw_region, rule_idx: int,
                          rule: RollupRule):
    rrid = rollup_region_id(raw_region.region_id, rule_idx)
    region = None
    try:
        region = engine.region(rrid)
    except KeyError:
        try:
            engine.open_region(rrid)
        except FileNotFoundError:
            engine.create_region(rrid,
                                 rollup_schema(raw_region.schema, rule))
        region = engine.region(rrid)
    # ALTER drift: a companion created before an ADD/DROP COLUMN must
    # follow the raw schema, or re-rolls would write mismatched batches
    # and substituted queries would reference absent plane columns
    want = rollup_schema(raw_region.schema, rule)
    if [(c.name, c.dtype) for c in region.schema.columns] != \
            [(c.name, c.dtype) for c in want.columns]:
        engine.alter_region_schema(rrid, want)
        region = engine.region(rrid)
    return region


def drop_companions(engine, raw_rid: int) -> int:
    """Drop every companion region of `raw_rid` (DROP/TRUNCATE TABLE
    must take the planes and their coverage down with the raw data, or
    substitution would resurrect it). Returns companions dropped."""
    maint = getattr(engine, "maintenance", None)
    if maint is None:
        return 0
    n = 0
    for rule in list(maint.rollup_rules):
        rrid = rollup_region_id(raw_rid, rule_slot(rule.resolution_ms))
        try:
            engine.region(rrid)
        except KeyError:
            try:
                engine.open_region(rrid)
            except FileNotFoundError:  # no companion on disk
                continue
        region = engine.region(rrid)
        store = region.manifest.store
        region_dir = region.region_dir
        engine.drop_region(rrid)
        # erase coverage + manifest so a future companion at this id
        # starts clean instead of replaying ghost file entries (a store
        # delete of an absent key is a no-op)
        state_path = _state_path(region_dir)
        store.delete(state_path)
        for key in store.list(os.path.join(region_dir, "manifest") + os.sep):
            store.delete(key)
        with _state_lock:
            _state_cache.pop(state_path, None)
            _state_cache.pop(f"open-miss:{rrid}", None)
        n += 1
    if n:
        _bump_substitution_state()
    return n


def _late_data_since(region, lo: int, hi: int, as_of_seq: int) -> bool:
    """Any raw source newer than `as_of_seq` overlapping [lo, hi)?
    Metadata-only: SST (max_seq, ts range) + memtable extent. `as_of_seq`
    is a next_seq snapshot, so rows with seq >= as_of_seq are late."""
    with region._lock:
        for m in region.files.values():
            if m.max_seq >= as_of_seq and m.ts_max >= lo and m.ts_min < hi:
                return True
        mem = region.memtable
        if mem.ts_min is not None and mem.ts_max >= lo and \
                mem.ts_min < hi and mem.max_seq >= as_of_seq:
            return True
    return False


def run_rollup_job(engine, raw_rid: int, rule_idx: int,
                   rule: RollupRule) -> dict:
    """Roll the raw region's un-covered inactive span into plane rows.
    Returns a detail dict for the job record."""
    if raw_rid & ROLLUP_RID_FLAG:
        # never roll a companion region (rollup-of-rollup would nest
        # plane regions without bound)
        return {"rows_in": 0, "rows_out": 0, "noop": True,
                "reason": "companion region"}
    region = engine.region(raw_rid)
    dtype = region.schema.time_index.dtype
    r_units = max(1, ms_to_units(rule.resolution_ms, dtype))
    extent = region.ts_extent()
    if extent is None:
        return {"rows_in": 0, "rows_out": 0, "noop": True,
                "reason": "empty region"}
    data_lo, data_hi = extent
    # the bucket holding the newest raw timestamp is the ACTIVE window:
    # it keeps taking writes, so it stays raw-only until it goes quiet
    cutoff = (data_hi // r_units) * r_units
    floor_lo = (data_lo // r_units) * r_units
    rollup_region = _ensure_rollup_region(engine, region, rule_idx, rule)
    store = region.store
    # snapshot the sequence BEFORE the staleness check: a write landing
    # between the check and the snapshot must read as late (seq >=
    # as_of) next time, not be silently claimed as covered
    as_of_seq = region.next_seq
    state = read_state(store, rollup_region.region_dir)
    expired_lo = None
    if state is not None and state.get("resolution_units") == r_units:
        # never roll below the retention horizon: data under it is
        # being TTL'd away, and claiming coverage there would resurrect
        # expired rows through substitution
        expired_lo = state.get("expired_lo")
        if expired_lo is not None:
            floor_lo = max(floor_lo, int(expired_lo))
    lo = floor_lo
    cov_lo_out = floor_lo
    if state is not None and state.get("resolution_units") == r_units:
        covered_lo, covered_hi = state["cov_lo"], state["cov_hi"]
        if floor_lo >= covered_lo and not _late_data_since(
                region, covered_lo, covered_hi,
                state.get("as_of_seq", -1)):
            # coverage is still authoritative: only extend forward, and
            # never CLAIM below what was actually rolled
            lo = max(floor_lo, covered_hi)
            cov_lo_out = covered_lo
        # else: late writes landed inside the covered span, or older
        # data appeared BELOW it — re-roll the whole inactive span so
        # the claimed coverage is really aggregated; LWW on
        # (tags, bucket) overwrites
    if lo >= cutoff:
        return {"rows_in": 0, "rows_out": 0, "noop": True,
                "reason": "no inactive span", "cutoff": int(cutoff)}
    # host milliseconds by stage, in the job's detail
    stages: dict = {}
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        now = time.perf_counter()
        stages[name] = round((now - t) * 1e3, 3)
        t = now

    scan = region.scan(ts_range=(int(lo), int(cutoff)))
    stage("scan_ms")
    rows_out = 0
    batch = None
    if scan is not None and scan.num_rows:
        batch = _aggregate(region, scan, rule, r_units,
                           int(lo), int(cutoff))
    stage("aggregate_ms")
    # a re-roll must also TOMBSTONE plane rows whose group vanished
    # (every raw row deleted, or a colliding old resolution's buckets):
    # LWW overwrite alone would let substituted aggregates resurrect
    # deleted data forever
    stale = _delete_stale_planes(rollup_region, int(lo), int(cutoff),
                                 batch)
    stage("stale_ms")
    wrote = stale > 0
    if batch is not None and batch.num_rows:
        rows_out = batch.num_rows
        rollup_region.write(batch)
        wrote = True
    stage("write_ms")
    if wrote:
        rollup_region.flush()
        # chaos seam: crash between the durable plane SST and the
        # coverage-state swap — coverage stays un-advanced, the next
        # run overwrites the rows (idempotent)
        FAULTS.fire("maintenance.job", op="rollup", phase="swap")
    stage("flush_ms")
    new_state = {
        "raw_region_id": raw_rid,
        "resolution_units": int(r_units),
        "resolution_ms": int(rule.resolution_ms),
        "cov_lo": int(cov_lo_out),
        "cov_hi": int(cutoff),
        "as_of_seq": int(as_of_seq),
    }
    if expired_lo is not None:
        new_state["expired_lo"] = int(expired_lo)
    write_state(store, rollup_region.region_dir, new_state)
    return {"rows_in": 0 if scan is None else int(scan.num_rows),
            "rows_out": int(rows_out), "lo": int(lo),
            "cutoff": int(cutoff), **stages}


def _delete_stale_planes(rollup_region, lo: int, hi: int,
                         new_batch) -> int:
    """Tombstone companion rows in [lo, hi) whose (tags, bucket) key is
    not re-produced by `new_batch`. Returns the number of keys deleted.
    Re-deleting an already-dead key is harmless (LWW), so this works
    from the raw (pre-dedup) companion scan."""
    from greptimedb_tpu_torch.storage.region import OP_DELETE

    scan = rollup_region.scan(ts_range=(lo, hi))
    if scan is None or not scan.num_rows:
        return 0
    schema = rollup_region.schema
    tag_names = [c.name for c in schema.tag_columns]
    ts_name = schema.time_index.name

    def batch_keys():
        if new_batch is None or not new_batch.num_rows:
            return set()
        cols = []
        for t in tag_names:
            v = new_batch.columns[t]
            cols.append(v.decode() if isinstance(v, DictVector)
                        else np.asarray(v, dtype=object))
        ts = np.asarray(new_batch.columns[ts_name], dtype=np.int64)
        return {tuple(list(vals) + [int(b)])
                for *vals, b in zip(*cols, ts.tolist())}

    keep = batch_keys()
    tag_vals = []
    for t in tag_names:
        d = scan.tag_dicts[t]
        codes = np.asarray(scan.columns[t])
        tag_vals.append([None if c < 0 else d[c] for c in codes.tolist()])
    ts_vals = np.asarray(scan.columns[ts_name], dtype=np.int64).tolist()
    stale = sorted({k for k in (
        tuple(list(vals) + [int(b)])
        for *vals, b in zip(*tag_vals, ts_vals)) if k not in keep},
        key=lambda k: tuple(map(str, k)))
    if not stale:
        return 0
    cols: dict = {}
    for i, t in enumerate(tag_names):
        cols[t] = DictVector.encode([k[i] for k in stale])
    cols[ts_name] = np.asarray([k[-1] for k in stale], dtype=np.int64)
    for c in schema.columns:
        if c.semantic is SemanticType.FIELD:
            fill = np.nan if c.dtype.is_float else 0
            cols[c.name] = np.full(len(stale), fill,
                                   dtype=c.dtype.to_numpy())
    rollup_region.write(RecordBatch(schema, cols), OP_DELETE)
    return len(stale)


def _up(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _aggregate(region, scan, rule: RollupRule, r_units: int,
               lo: int, hi: int):
    """ScanData (raw, needs dedup) -> one plane RecordBatch covering
    [lo, hi) only: the scan may have served a WIDER cached snapshot
    (covering-range widening), and active-window rows must not leak
    into the planes.

    On the region's device: last-write-wins dedup with tombstones
    applied (ops/dedup.sort_dedup, the kernel compaction runs), whose
    order sorts the survivors by (series, ts), so the (tags..., bucket)
    groups are runs in that order and come out in np.unique's
    lexicographic order; then ONE K2 call over the [N x F] float64 field
    plane gives sum, count, min and max for every field and the raw row
    count. The JAX `_aggregate`'s NaN-for-empty and integer-field rules
    are applied on the host: emptiness comes from count == 0, so a group
    whose valid values are all +inf keeps min = +inf."""
    schema = region.schema
    ts_name = schema.time_index.name
    tag_names = [c.name for c in schema.tag_columns]
    n = scan.num_rows
    dev = region.device

    # 1. last-write-wins dedup + tombstone apply
    sizes = [max(len(scan.tag_dicts[t]), 1) + 1 for t in tag_names]
    if tag_names:
        sid = combine_group_ids(
            [_up(scan.columns[t], dev) + 1 for t in tag_names], sizes,
            dtype=torch.int64)
    else:
        sid = torch.zeros(n, dtype=torch.int64, device=dev)
    ts_all = _up(scan.columns[ts_name], dev).to(torch.int64)
    in_range = (ts_all >= lo) & (ts_all < hi)
    order, keep = dedup.sort_dedup(
        sid, ts_all, _up(scan.seq, dev), _up(scan.op_type, dev), in_range,
        keep_tombstones=False)
    idx = order[keep]
    m = int(idx.numel())
    if m == 0:
        return None
    ts = ts_all[idx]
    # integer floor division by a device scalar (exact, negative ts too)
    step = torch.tensor(r_units, dtype=torch.int64, device=dev)
    bucket = torch.div(ts, step, rounding_mode="floor") * step

    # 2. (tags..., bucket) groups: runs of the (series, ts)-sorted rows
    s_k = sid[idx]
    new = torch.ones(m, dtype=torch.bool, device=dev)
    if m > 1:
        new[1:] = (s_k[1:] != s_k[:-1]) | (bucket[1:] != bucket[:-1])
    seg = torch.cumsum(new, 0) - 1
    first = torch.nonzero(new).squeeze(1)
    num_groups = int(first.numel())

    fields = plane_fields(schema, rule)
    vals = torch.empty((m, len(fields)), dtype=torch.float64, device=dev)
    for j, f in enumerate(fields):
        vals[:, j] = _up(scan.columns[f.name], dev)[idx].to(torch.float64)
    # 3. ONE K2 call: segment num_groups is the dead one (no row in it);
    # looked up on the module at call time
    out = segment_kernels.fused_segment_agg(
        vals, seg.to(torch.int32), num_groups + 1, want_min=True,
        want_max=True)

    first_rows = idx[first].cpu().numpy()
    cols: dict = {}
    for t in tag_names:
        codes = np.asarray(scan.columns[t])[first_rows].astype(np.int64)
        d = np.asarray(scan.tag_dicts[t], dtype=object)
        # compact dictionary of the values present (NULL stays -1)
        used = np.zeros(len(d) + 1, dtype=bool)
        used[codes + 1] = True
        used[0] = False
        remap = np.cumsum(used) - 1
        cols[t] = DictVector(
            np.where(codes < 0, -1, remap[codes + 1]).astype(np.int32),
            d[used[1:]])
    cols[ts_name] = bucket[first].cpu().numpy().astype(np.int64)
    cols[ROWS_COL] = out["rows"][:num_groups].cpu().numpy().astype(np.int64)
    count = out["count"][:num_groups].cpu().numpy().astype(np.int64)
    vsum = out["sum"][:num_groups].cpu().numpy()
    vmin = out["min"][:num_groups].cpu().numpy()
    vmax = out["max"][:num_groups].cpu().numpy()
    for j, f in enumerate(fields):
        cnt = count[:, j]
        empty = cnt == 0
        np_min = np.where(empty, np.nan, vmin[:, j])
        np_max = np.where(empty, np.nan, vmax[:, j])
        np_sum = np.where(empty, np.nan, vsum[:, j])
        out_dtype = f.dtype.to_numpy()
        if f.dtype.is_float:
            cols[f"{f.name}__min"] = np_min.astype(out_dtype)
            cols[f"{f.name}__max"] = np_max.astype(out_dtype)
        else:
            cols[f"{f.name}__min"] = np.where(empty, 0, np_min).astype(
                out_dtype)
            cols[f"{f.name}__max"] = np.where(empty, 0, np_max).astype(
                out_dtype)
        cols[f"{f.name}__sum"] = np_sum
        cols[f"{f.name}__count"] = cnt
    return RecordBatch(rollup_schema(schema, rule), cols)


# ---- query-time substitution -----------------------------------------------


def substitution_enabled() -> bool:
    return os.environ.get("GTPU_ROLLUP_SUBSTITUTE", "1").lower() \
        not in ("0", "false", "off")


def _conjuncts(e) -> list:
    from greptimedb_tpu_torch.query.expr import split_conjuncts

    return split_conjuncts(e)


def _where_ok(where, schema) -> bool:
    """WHERE must be a conjunction of (a) range comparisons between the
    time index and a literal (never '=' — an instant predicate is not
    expressible over bucket rows) and (b) predicates touching only tag
    columns, which evaluate identically on rollup rows (every raw row of
    a (tags, bucket) group shares its tag values)."""
    from greptimedb_tpu_torch.query.expr import collect_columns
    from greptimedb_tpu_torch.sql import ast

    ts_name = schema.time_index.name
    tag_names = {c.name for c in schema.tag_columns}
    for atom in _conjuncts(where):
        refs: set = set()
        collect_columns(atom, refs)
        if ts_name not in refs:
            if refs <= tag_names:
                continue
            return False
        # time-index atom: one comparison or BETWEEN against literals
        if isinstance(atom, ast.Between) and not atom.negated and \
                isinstance(atom.expr, ast.Column) and \
                atom.expr.name == ts_name and \
                isinstance(atom.low, ast.Literal) and \
                isinstance(atom.high, ast.Literal):
            continue
        if isinstance(atom, ast.BinaryOp) and \
                atom.op in ("<", "<=", ">", ">="):
            lc, rc = atom.left, atom.right
            if (isinstance(lc, ast.Column) and lc.name == ts_name
                    and isinstance(rc, ast.Literal)) or \
               (isinstance(rc, ast.Column) and rc.name == ts_name
                    and isinstance(lc, ast.Literal)):
                continue
        return False
    return True


def _group_keys_ok(sel, info, r_units_of) -> Optional[list]:
    """Validate group keys (tags and/or aligned date_bin on the time
    index). Returns the list of bucket steps in column units (possibly
    empty), or None when ineligible."""
    from greptimedb_tpu_torch.query import planner as _planner
    from greptimedb_tpu_torch.query.expr import (
        PlanError,
        _interval_in_col_unit,
    )
    from greptimedb_tpu_torch.sql import ast

    schema = info.schema
    ts_name = schema.time_index.name
    tag_names = {c.name for c in schema.tag_columns}
    items = [(it.alias or _planner._default_name(it.expr), it.expr)
             for it in sel.items]
    alias_map = {name: expr for name, expr in items}
    steps: list[int] = []
    for g in sel.group_by:
        try:
            g = _planner._resolve_group_expr(g, items, alias_map)
        except PlanError:
            return None
        if isinstance(g, ast.Column) and g.name in tag_names:
            continue
        if isinstance(g, ast.FuncCall) and \
                g.name in ("date_bin", "time_bucket") and \
                len(g.args) in (2, 3) and \
                isinstance(g.args[1], ast.Column) and \
                g.args[1].name == ts_name:
            try:
                step = _interval_in_col_unit(g.args[0], g.args[1], schema)
            except PlanError:  # unparseable interval
                return None
            origin = 0
            if len(g.args) == 3:
                if not isinstance(g.args[2], ast.Literal):
                    return None
                try:
                    origin = int(g.args[2].value)
                except (TypeError, ValueError):
                    return None
            r = r_units_of
            if step <= 0 or step % r or origin % r:
                return None
            steps.append(int(step))
            continue
        return None
    return steps


def _rewrite_aggs(sel, info, rule: RollupRule):
    """Rewrite every aggregate call over the raw table into its plane
    equivalent; returns the rewritten Select or None when any aggregate
    has no plane form. Output column names are preserved (the rewrite is
    invisible to the client)."""
    from greptimedb_tpu_torch.query import planner as _planner
    from greptimedb_tpu_torch.query.engine import _rewrite_tree
    from greptimedb_tpu_torch.query.expr import collect_aggregates
    from greptimedb_tpu_torch.sql import ast

    schema = info.schema
    plane_names = {c.name for c in plane_fields(schema, rule)}
    float_planes = {c.name for c in plane_fields(schema, rule)
                    if c.dtype.is_float}

    calls: list = []
    for it in sel.items:
        collect_aggregates(it.expr, calls)
    collect_aggregates(sel.having, calls)
    for o in sel.order_by:
        collect_aggregates(o.expr, calls)
    if not calls:
        return None

    def plane_agg(func: str, col: str) -> ast.Expr:
        return ast.FuncCall(func, (ast.Column(col),))

    def plane_count(col: str) -> ast.Expr:
        # sum over ZERO plane rows is NaN; raw count over zero rows is
        # 0 — coalesce before the integer cast (NaN->int is garbage)
        return ast.Cast(
            ast.FuncCall("coalesce",
                         (plane_agg("sum", col), ast.Literal(0))),
            "bigint")

    replacements: dict = {}
    for call in calls:
        if call in replacements:
            continue
        if call.distinct or call.order_within is not None \
                or call.over is not None:
            # window calls are diverted before substitution, but guard
            # anyway: rewriting sum(v) OVER () to a plain aggregate
            # would change the result SHAPE, not just the value
            return None
        fname = call.name.lower()
        if fname in ("count",) and len(call.args) == 1 and \
                isinstance(call.args[0], ast.Star):
            replacements[call] = plane_count(ROWS_COL)
            continue
        if len(call.args) != 1 or not isinstance(call.args[0], ast.Column):
            return None
        col = call.args[0].name
        if col not in plane_names:
            return None
        if fname == "min":
            replacements[call] = plane_agg("min", f"{col}__min")
        elif fname == "max":
            replacements[call] = plane_agg("max", f"{col}__max")
        elif fname == "count":
            replacements[call] = plane_count(f"{col}__count")
        elif fname == "sum" and col in float_planes:
            replacements[call] = plane_agg("sum", f"{col}__sum")
        elif fname in ("avg", "mean") and col in float_planes:
            replacements[call] = ast.BinaryOp(
                "/", plane_agg("sum", f"{col}__sum"),
                plane_agg("sum", f"{col}__count"))
        else:
            return None

    def leaf(e):
        if isinstance(e, ast.FuncCall) and e in replacements:
            return replacements[e]
        return NotImplemented

    new_items = [
        dataclasses.replace(
            it, expr=_rewrite_tree(it.expr, leaf),
            alias=it.alias or _planner._default_name(it.expr))
        for it in sel.items
    ]
    return dataclasses.replace(
        sel,
        items=new_items,
        having=_rewrite_tree(sel.having, leaf) if sel.having else None,
        order_by=[dataclasses.replace(o, expr=_rewrite_tree(o.expr, leaf))
                  for o in sel.order_by],
    )


def _companion_state(engine, region, rid: int, rule_idx: int,
                     r_units: int):
    """Locate `rid`'s rollup companion at this rule slot and read its
    coverage state. Returns (rollup_rid, state) or (None, None) when no
    companion with matching-resolution coverage exists. Shares the
    negative-open TTL cache with the query path (an absent rollup must
    not cost a manifest probe per region per rule per query)."""
    rrid = rollup_region_id(rid, rule_idx)
    try:
        engine.region(rrid)
    except KeyError:
        miss_key = f"open-miss:{rrid}"
        now = time.monotonic()
        with _state_lock:
            hit = _state_cache.get(miss_key)
        if hit is not None and hit[0] > now:
            return None, None
        try:
            engine.open_region(rrid)
        except FileNotFoundError:  # no rollup yet
            with _state_lock:
                _state_cache[miss_key] = (now + _STATE_TTL_S, None)
            return None, None
    rollup_region = engine.region(rrid)
    state = read_state(region.store, rollup_region.region_dir)
    if state is None or state.get("resolution_units") != r_units:
        return None, None
    return rrid, state


def probe_region_rollups(engine, region_id: int, lo: int,
                         hi: int) -> list:
    """Datanode-side rollup eligibility probe — the Partial half of
    DISTRIBUTED substitution. For each configured rule, answer whether
    this region's companion fully covers [lo, hi) with no late raw
    writes. Returns [{"resolution_ms", "rollup_rid", "fields"}] sorted
    coarsest-first; the frontend intersects the per-region answers,
    rewrites the aggregates to plane form, and ships ordinary
    partial-agg PlanFragments to the COMPANION regions — [G, F] planes
    come back, never raw rows (the cluster-mode analog of the local
    `try_substitute` fast path)."""
    from greptimedb_tpu_torch.storage.region import Region

    maint = getattr(engine, "maintenance", None)
    if maint is None or not maint.rollup_rules or \
            not substitution_enabled():
        return []
    try:
        region = engine.region(region_id)
    except KeyError:  # not open here (stale route)
        return []
    if not isinstance(region, Region):
        return []
    dtype = region.schema.time_index.dtype
    out = []
    for rule in sorted(maint.rollup_rules, key=lambda r: -r.resolution_ms):
        rule_idx = rule_slot(rule.resolution_ms)
        r_units = max(1, ms_to_units(rule.resolution_ms, dtype))
        if lo % r_units or hi % r_units:
            continue
        rrid, state = _companion_state(engine, region, region_id,
                                       rule_idx, r_units)
        if rrid is None:
            continue
        if not (state["cov_lo"] <= lo and hi <= state["cov_hi"]):
            continue
        if _late_data_since(region, lo, hi, state.get("as_of_seq", -1)):
            continue
        out.append({"resolution_ms": int(rule.resolution_ms),
                    "rollup_rid": int(rrid),
                    "fields": list(rule.fields)})
    return out


def try_substitute(qe, sel, info, ctx, shape_note=None):
    """Serve an eligible aggregate SELECT from rollup planes instead of
    raw SSTs. Returns a QueryResult, or None to fall through to the raw
    path. Never raises for ineligibility — any doubt means raw.

    `shape_note` (optional dict): on a None return,
    shape_note["memoizable"] says whether the fall-through was
    STRUCTURAL — no parameter values could make this statement shape
    substitute under the current rollup state. The frontend plan cache
    may memoize only those: coverage/alignment/late-data failures
    depend on the query's literal values (one probe over the live
    uncovered hour must not disable substitution for the same shape
    over fully-rolled history)."""
    from greptimedb_tpu_torch.catalog.catalog import TableInfo
    from greptimedb_tpu_torch.query.expr import PlanError, extract_ts_bounds
    from greptimedb_tpu_torch.query.planner import plan_select
    from greptimedb_tpu_torch.storage.region import Region

    if shape_note is not None:
        shape_note["memoizable"] = True
    engine = qe.region_engine
    maint = getattr(engine, "maintenance", None)
    if maint is None or not maint.rollup_rules:
        # distributed frontend: no local maintenance plane, but the
        # region owners have one — classify eligibility here, probe the
        # datanodes, and serve from the companion plane regions
        if hasattr(engine, "rollup_probe") and substitution_enabled():
            return _try_substitute_distributed(qe, sel, info, ctx,
                                               shape_note)
        return None
    if not substitution_enabled():
        return None
    if sel.distinct or sel.joins or sel.ctes or sel.from_subquery is not None:
        return None
    schema = info.schema
    dtype = schema.time_index.dtype
    if not _where_ok(sel.where, schema):
        return None
    bounds = extract_ts_bounds(sel.where, schema.time_index.name, dtype)
    if bounds is None or bounds[0] is None or bounds[1] is None:
        # an unbounded scan always touches the active (raw-only) window
        return None
    lo, hi = int(bounds[0]), int(bounds[1])

    def value_dependent():
        # this shape COULD substitute with other literal values (or
        # after transient region/coverage state settles): the negative
        # outcome must not be memoized against the shape
        if shape_note is not None:
            shape_note["memoizable"] = False

    # coarsest eligible rule wins: fewest plane rows scanned
    rules = sorted(maint.rollup_rules, key=lambda r: -r.resolution_ms)
    for rule in rules:
        rule_idx = rule_slot(rule.resolution_ms)
        r_units = max(1, ms_to_units(rule.resolution_ms, dtype))
        steps = _group_keys_ok(sel, info, r_units)
        if steps is None:
            continue
        if lo % r_units or hi % r_units:
            value_dependent()
            continue
        plane_schema = rollup_schema(schema, rule)
        rollup_rids = []
        ok = True
        for rid in info.region_ids:
            try:
                region = engine.region(rid)
            except KeyError:  # not open (a concurrent DROP): re-probe later
                value_dependent()
                return None
            if not isinstance(region, Region):
                return None  # frontend router: planes live datanode-side
            rrid, state = _companion_state(engine, region, rid, rule_idx,
                                           r_units)
            if rrid is None:
                ok = False
                break
            if not (state["cov_lo"] <= lo and hi <= state["cov_hi"]):
                ok = False  # THESE bounds uncovered; others may be
                value_dependent()
                break
            if _late_data_since(region, lo, hi,
                                state.get("as_of_seq", -1)):
                ok = False  # out-of-order write not yet re-rolled
                value_dependent()
                break
            if engine.region(rrid).schema.names != plane_schema.names:
                # ALTER drift: the companion predates a column change;
                # the next rollup run migrates it
                ok = False
                value_dependent()
                break
            rollup_rids.append(rrid)
        if not ok:
            continue
        new_sel = _rewrite_aggs(sel, info, rule)
        if new_sel is None:
            continue
        rollup_info = TableInfo(
            table_id=info.table_id, name=info.name, db=info.db,
            schema=plane_schema, options={}, region_ids=rollup_rids)
        try:
            plan = plan_select(new_sel, rollup_info)
        except PlanError:  # an odd rewrite: the raw path is always right
            value_dependent()
            continue
        # the substituted query's own failures (a kernel, the scan) raise:
        # nothing turns them into the raw route
        ex = qe.executor
        ex.last_path = None
        res = ex.execute(plan)
        ROLLUP_SUBSTITUTIONS.inc(table=info.name,
                                 resolution_ms=rule.resolution_ms)
        ex.last_path = (ex.last_path or "") + "+rollup"
        ex.statement_paths.append(ex.last_path)
        return res
    return None


def _try_substitute_distributed(qe, sel, info, ctx, shape_note=None):
    """Cluster-mode rollup substitution: the frontend classifies the
    shape, fans a `rollup_probe` to each raw region's owner and, when
    every region's companion covers the window at a common resolution,
    re-plans over the COMPANION region ids. The router then ships
    ordinary partial-agg fragments to the plane regions: [G, F] partial
    planes over pre-aggregated rows cross the wire, never raw scans.
    A failed probe RPC answers None (the raw route is always right); a
    failure of the substituted query itself raises."""
    from concurrent.futures import ThreadPoolExecutor

    from greptimedb_tpu_torch.catalog.catalog import TableInfo
    from greptimedb_tpu_torch.fault import FaultError, Unavailable
    from greptimedb_tpu_torch.query.expr import PlanError, extract_ts_bounds
    from greptimedb_tpu_torch.query.planner import plan_select
    from greptimedb_tpu_torch.servers.flight import FlightError
    from greptimedb_tpu_torch.utils import deadline as dl
    from greptimedb_tpu_torch.utils import tracing
    from greptimedb_tpu_torch.utils.metrics import FRAGMENT_PUSHDOWNS

    # the structural gates first (as the local path's): a shape failing
    # THESE may be memoized as ineligible
    if sel.distinct or sel.joins or sel.ctes or sel.from_subquery is not None:
        return None
    schema = info.schema
    dtype = schema.time_index.dtype
    if not _where_ok(sel.where, schema):
        return None
    bounds = extract_ts_bounds(sel.where, schema.time_index.name, dtype)
    if bounds is None or bounds[0] is None or bounds[1] is None:
        return None
    lo, hi = int(bounds[0]), int(bounds[1])
    # from here every outcome depends on the regions' coverage state:
    # the plan cache must keep probing
    if shape_note is not None:
        shape_note["memoizable"] = False
    engine = qe.region_engine
    rids = list(info.region_ids)
    one = dl.propagate(tracing.propagate(
        lambda rid: engine.rollup_probe(rid, lo, hi)))
    try:
        with ThreadPoolExecutor(max_workers=min(8, len(rids)),
                                thread_name_prefix="gtpu-frag") as pool:
            per_region = list(pool.map(one, rids))
    except (FlightError, FaultError, Unavailable, KeyError, OSError):
        return None  # a probe RPC failed: the raw route is right
    # a resolution serves only when EVERY region's companion covers the
    # window, with the same fields (a disagreement is a rollout drift)
    common: Optional[dict] = None
    for lst in per_region:
        here = {e["resolution_ms"]: e for e in lst or ()}
        if common is None:
            common = {k: [v] for k, v in here.items()}
        else:
            common = {k: v + [here[k]] for k, v in common.items()
                      if k in here
                      and here[k].get("fields") == v[0].get("fields")}
    if not common:
        return None
    for res_ms in sorted(common, reverse=True):  # the coarsest first
        r_units = max(1, ms_to_units(res_ms, dtype))
        if lo % r_units or hi % r_units:
            continue
        if _group_keys_ok(sel, info, r_units) is None:
            continue
        rule = RollupRule(resolution_ms=int(res_ms),
                          fields=tuple(common[res_ms][0].get("fields", ())))
        new_sel = _rewrite_aggs(sel, info, rule)
        if new_sel is None:
            continue
        rollup_info = TableInfo(
            table_id=info.table_id, name=info.name, db=info.db,
            schema=rollup_schema(schema, rule), options={},
            region_ids=[e["rollup_rid"] for e in common[res_ms]])
        try:
            plan = plan_select(new_sel, rollup_info)
        except PlanError:  # an odd rewrite: the raw path is always right
            continue
        ex = qe.executor
        ex.last_path = None
        res = ex.execute(plan)
        ROLLUP_SUBSTITUTIONS.inc(table=info.name, resolution_ms=res_ms)
        FRAGMENT_PUSHDOWNS.inc(mode="rollup")
        ex.last_path = (ex.last_path or "") + "+rollup"
        ex.statement_paths.append(ex.last_path)
        return res
    return None
