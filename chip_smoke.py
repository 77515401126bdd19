#!/usr/bin/env python3
"""Chip smoke test of greptimedb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. The first run builds the kernels into
greptimedb_tpu_torch/_build/. Phases:

1. Device: the card's name and power limit, torch and CUDA versions, the
   kernel build time.
2. Kernels against their plain versions, on the card, at the shapes the
   main path gives them (plus a contention case): inputs from a seeded
   torch.Generator with NaNs, dead rows and ties. Counts, rows, min and
   max must match exactly; sums must lie within the stated tolerance of
   the plain version run on float64 copies of the same inputs. Each
   kernel is timed with CUDA events (median of 7 after a warm-up) beside
   its plain version, one library call where PyTorch has one, and the
   least time the card could take (and its share of that time). K2 is
   also timed at the sparse route's shape, at PromQL's two float64
   shapes (the label aggregation, [10,000 x 241] into G+1 = 2, and the
   window buckets, [17,280,000 x 1] into 4,000 x 157 + 1 with max), at
   the RANGE query's ([12 x 17,280,000 x 2] f64 slot-replicated rows into
   4,096 x 256 + 1 with min and max) and at lastpoint's boundary subsets
   ([524,288 x 10] and [8,192 x 10] f32 into 4,002). K1 also
   runs cases that reach each branch of its windowed design (host-major
   ids, frequent window re-bases, column groups, tiny and ragged n, all
   rows dead, G = 2), logs the plan it launched and its device counters,
   and must show on the headline that its window is sized from the
   card's opt-in shared memory and that its adds stay in that window.
   Each wrapper must refuse an int64 input.
3. The main path at TSBS scale, on disk: the `cpu` table bench.py builds
   (4,000 hosts x 12 h at 10 s = 17,280,000 rows, 10 DOUBLE fields, one
   `hostname` tag, append mode) written through RegionEngine.put into a
   disk-backed engine under a temporary directory, the WAL fsynced at
   every put and the 256 MB auto-flush writing SSTs. Then, through
   QueryEngine.execute_one on cuda, bench.py's six `cpu` queries in three
   storage states — after the ingest (timed: cold, warm p50, a profile),
   after ADMIN flush_table and a restart of the engine in this process,
   and after ADMIN compact_table (a full merge, sort-dedup on the card).
   Every value is held against a float64 numpy oracle over the same
   arrays; `last_path` and each state's kernel launch counts show the
   route. lastpoint takes `lastscan+boundary+dense_fused` in every state:
   Region.scan_last visits the SSTs newest-first and stops early, and
   the boundary gather keeps two rows a host and the memtable's; the
   SSTs visited and pruned and the rows before and after the gather are
   printed, and fewer SSTs than the region holds must be visited. Between the first two states a small write (one more 10 s step
   for every host) and a re-query of double_groupby_all must upload only
   the memtable tail's blocks: the SST parts' blocks are keyed by file
   and hit. The compaction must drop exactly the old files' device
   blocks. These checks run with the partial-aggregate cache off
   (GREPTIMEDB_TPU_PARTIAL_CACHE=0, set in this process around them).
   Then, each with its kernels' counts zeroed just before and read just
   after, on the same table:
   - the sparse route: hostname x minute (2,880,000 groups past the
     dense budget) takes `sparse_fused`, one K2 call and no K1, cache
     off; with the cache on it folds per-part sparse partials
     (`incremental_sparse`): every part misses cold, hits warm, and the
     warm repeat launches K2 only for the memtable tail;
   - the six queries with the cache on in each storage state (a cold
     fill, the warm repeat folding only the tail, still all hits after
     the small write, misses again after the restart, the classic route
     for scans of the compacted file past one device block), warm p50
     beside the cache-off p50;
   - host order statistics: median and percentile beside an avg on K2,
     and a sparse query with a median, exact under host_agg.py's rule.
   - RANGE ... ALIGN at full width, after the ingest (cold, warm p50 of
     5, peak device bytes, a CUPTI profile, a cProfile breakdown) and
     after the compaction: 1 h avg and max and 10 min min at 5 min for
     every host, two K2 calls (one a distinct range) over 12 x 17.28 M
     slot-replicated float64 rows and no K1, every window against numpy
     (avg to rtol 1e-9, min and max exactly, NULL where a window is
     empty); and a FILL PREV / FILL LINEAR query on 8 hosts over the
     first hour at 5 s, one K2 call, against numpy.
   - the host SQL surface, partial cache off: seven dashboard statements
     through execute_sql, each cold, five times warm and once under
     torch.profiler: a CTE top-10 drill-down with IN (SELECT ...), lag
     and rank over the 48,000-group hourly aggregate (the second over a
     derived table), a ROWS moving average over the last hour's 1.44 M
     raw rows, a join of two CTE aggregates, an INSERT ... SELECT
     rollup into cpu_1h and its count, and a SELECT over an aggregate
     view. Every value against numpy (max exactly, avg to rtol 1e-5,
     lag equal to the previous row's avg, ranks from the returned
     avgs); every inner aggregate on K1 or K2, on the route the same
     statement takes alone, with that kernel launched.
   - PromQL through PromqlEngine.eval_matrix on the card, float64, at a
     5 min step with 1 h windows: max_over_time(cpu{__field__=
     "usage_user"}[1h]) buckets the 17.28 M rows into 4,000 x 157 + 1
     segments through one K2 call (window_stats' scatter flavour),
     stddev(avg_over_time(...)) takes the sums grid path and one K2 call
     with sumsq over the hosts, topk(5, max_over_time(...)) keeps the
     five largest; each against numpy, with its K2 launches, window path,
     a CUPTI profile and a cProfile breakdown.
   Then bench.py's high-cardinality table (config #5: 1,000,000 tags x
   10 points through RegionEngine.put, flushed), `SELECT tag, sum(v)`
   through K1 at G = 1,000,002 with the cache off and K2 a part with it
   on. Then a small non-append table with duplicate keys and
   tombstones, flushed between its write batches and then compacted,
   goes through last-write-wins dedup and is held against a Python
   oracle. Then bench.py's PromQL table (config #3, bench.py:375-475):
   prom_cpu, 10,000 counter series x 24 h at 15 s = 57,600,000 rows in
   28 puts, a flush every 3 and one at the end, and its three TQL EVAL
   queries through execute_one: sum(rate(prom_cpu[360s])) over the day
   at a 360 s step (241 steps, the edges grid path), the trailing 10 min
   sum(rate(prom_cpu[2m])), and avg(avg_over_time(prom_cpu[360s])) (the
   sums grid path), each one K2 call for its label aggregation, held
   against numpy on the generated matrix at rtol 1e-9 (bench.py's
   promql_anchor.eval_rate with the counter zero-crossing limit, and a
   window mean). The data directories are removed at the end.
4. Streaming beyond device memory, last: BASELINE.json configs[1]
   (bench.py's bench_double_groupby_100m, bench.py:750-845), cpu_big,
   4,000 hosts x 25,000 points at 10 s = 100,000,000 rows (seed 23),
   puts of 524 points through RegionEngine.put with the WAL fsynced, a
   flush every 4 puts and one at the end. Its double-groupby-all (hour x
   hostname, avg of the 10 fields, 280,000 groups) runs through
   execute_one cold and three times warm, partial cache at its default:
   each run must take `stream_prepared` (lazy SST chunks, blocks of 2 Mi
   rows built on a producer thread, one K1 call a block into an
   accumulator on the card), launch K1 once a block and K2 never, never
   call Region.scan, leave the hot set as it was, keep its host bytes in
   flight within one decoded chunk and depth + 2 blocks, and match a
   float64 numpy oracle (per-put np.bincount sums) at rtol 1e-5. Then one
   profiled and one cProfiled run, and the materialized route on the same
   table (cache off: dense_prepared, K1 over the hot set) cold and warm,
   held to the same oracle, unless MemAvailable is under 3x the scan's
   host bytes. The row count is cut, and the cut printed, only when the
   disk or the run's time limit forces it. The kernel phase times K1 at
   this query's block shape too ([2 Mi x 21] f32, host-major ids over
   G + 1 = 280,071).
5. A `kernels` JSON line (with each kernel's launches on every path, the
   PromQL queries', the streamed query's, the RANGE queries' and the
   host SQL statements' included,
   lastpoint's by state, K1's time at the stream's shape and K2's at the
   sparse route's, PromQL's, RANGE's and lastpoint's shapes), the card
   line, and the result line.

Exits non-zero, and prints no result line, when CUDA is unavailable, the
port is not beside this script, or any check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's memory rate and float32 rate (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# bench.py's cpu-only TSBS shape (bench.py:70-86, 149-203)
HOSTS = 4000
HOURS = 12
STEP_S = 10
# the sparse query's shape on that table: hostname x minute groups, and
# the whole scan padded as ops/blocks.py::block_size_for pads it (the
# ingest's rows, 1M-row buckets past 1M)
SPARSE_U = HOSTS * HOURS * 60
SPARSE_PAD_ROWS = -(-HOSTS * HOURS * 3600 // STEP_S // (1 << 20)) * (1 << 20)
#: the memtable tail the ingest leaves (9 puts of 524 points a host, an
#: auto-flush every two): the last put's 128 points a host
LASTPOINT_TAIL_ROWS = 128 * HOSTS
T0_MS = 1456790400000  # 2016-03-01T00:00:00Z
POINTS = HOURS * 3600 // STEP_S
# bench.py's config #3 (bench.py:375-475; BASELINE.json configs[2]):
# prom_cpu, 10,000 counter series x 24 h at 15 s, values 50 * point +
# U(0, 50) from seed 11; `sum(rate(prom_cpu[360s]))` at a 360 s step
# over the whole day is 241 eval steps
PROM_SERIES = 10_000
PROM_HOURS = 24
PROM_STEP_S = 15
PROM_SEED = 11
PROM_EVAL_STEP_S = max(60, PROM_HOURS * 3600 // 240)
PROM_STEPS = PROM_HOURS * 3600 // PROM_EVAL_STEP_S + 1
# the `cpu` table's PromQL queries: 1 h windows at a 5 min step over the
# 12 h, so window_stats buckets each series into 145 + 12 buckets
CPU_EVAL_STEP_S = 300
CPU_RANGE_S = 3600
CPU_STEPS = HOURS * 3600 // CPU_EVAL_STEP_S + 1
CPU_BUCKETS = CPU_STEPS + CPU_RANGE_S // CPU_EVAL_STEP_S
# BASELINE.json configs[1], bench.py's bench_double_groupby_100m
# (bench.py:750-845): cpu_big, 4,000 hosts x 25,000 points at 10 s =
# 100,000,000 rows from seed 23, puts of 524 points (1 << 21 rows over
# 4,000 hosts), a flush every 4 puts and one at the end
STREAM_HOSTS = 4000
STREAM_ROWS = 100_000_000
STREAM_SEED = 23
STREAM_FLUSH_EVERY = 4
STREAM_PUT_POINTS = (1 << 21) // STREAM_HOSTS
STREAM_HOURS = -(-(STREAM_ROWS // STREAM_HOSTS) * STEP_S // 3600)
# host bytes of a scanned row: hostname code, ts, 10 DOUBLE fields, the
# write sequence and the op type (an SST holds the same)
STREAM_ROW_BYTES = 4 + 8 + 8 * 10 + 8 + 1
# the ingest stops at a put boundary once the run is this old, so the
# whole script stays inside its time limit; a cut is printed
STREAM_INGEST_DEADLINE_S = 650.0
T_START = time.perf_counter()
FIELDS = [f"usage_{n}" for n in (
    "user", "system", "idle", "nice", "iowait", "irq", "softirq",
    "steal", "guest", "guest_nice")]
SEED = 7


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- timing ----------------------------------------------------------------


def cuda_ms(fn, runs: int = 7) -> float:
    """Median milliseconds of `fn` over `runs` runs on the card, CUDA
    events around each run, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    import torch

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = F64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 2: kernels against plain versions -------------------------------


def time_major_ids(n, nbuckets, run, dead_frac, gen, device):
    """Group ids as a time-major scan produces them: `run` consecutive
    rows per bucket, buckets cycling, a share of rows masked into the dead
    segment `nbuckets`."""
    import torch

    ids = (torch.arange(n, device=device) // run % nbuckets).to(torch.int32)
    dead = torch.rand(n, generator=gen, device=device) < dead_frac
    return torch.where(dead, torch.full_like(ids, nbuckets), ids)


def host_hour_ids(n, hosts, points_per_hour, hours, dead_frac, gen, device):
    """double_groupby_all's ids: rows time-major over `hosts`, id =
    hour * (hosts + 1) + host + 1, dead segment G - 1 = hours * (hosts +
    1). Returns (ids, G)."""
    import torch

    g = hours * (hosts + 1) + 1
    r = torch.arange(n, device=device)
    hour = r // hosts // points_per_hour
    ids = (hour * (hosts + 1) + r % hosts + 1).to(torch.int32)
    dead = torch.rand(n, generator=gen, device=device) < dead_frac
    return torch.where(dead, torch.full_like(ids, g - 1), ids), g


def host_major_ids(n, hosts, hours, dead_frac, gen, device):
    """Ids as a host-major scan produces them: the hour varies fastest, so
    neighbouring rows lie a bucket's width (hosts + 1) apart and a chunk's
    ids span every hour, wider than the kernel's window. Returns (ids,
    G)."""
    import torch

    g = hours * (hosts + 1) + 1
    r = torch.arange(n, device=device)
    ids = ((r % hours) * (hosts + 1) + (r // hours) % hosts + 1).to(
        torch.int32)
    dead = torch.rand(n, generator=gen, device=device) < dead_frac
    return torch.where(dead, torch.full_like(ids, g - 1), ids), g


def stream_block_ids(n, device):
    """The ids of the streamed cpu_big query's first block: a file's rows
    sorted by (host, ts), STREAM_FLUSH_EVERY puts of points a host, id =
    hour * (hosts + 1) + host + 1, every row live, so the id jumps by
    hosts + 1 at each hour. Returns (ids, G + 1)."""
    import torch

    per_host = STREAM_FLUSH_EVERY * STREAM_PUT_POINTS
    r = torch.arange(n, device=device)
    hour = (r % per_host) * STEP_S // 3600
    ids = (hour * (STREAM_HOSTS + 1) + r // per_host + 1).to(torch.int32)
    return ids, STREAM_HOURS * (STREAM_HOSTS + 1) + 1


def cpu_bucket_ids(device):
    """The bucket ids window_stats gives K2 for a 1 h window at a 5 min
    step over the `cpu` table: rows sorted by (host, ts), id = host * B +
    ceil(offset / step) + w - 1 (ops/window.py), every row live."""
    import torch

    r = torch.arange(HOSTS * POINTS, device=device)
    host, point = r // POINTS, r % POINTS
    w = CPU_RANGE_S // CPU_EVAL_STEP_S
    b = -(-(point * STEP_S) // CPU_EVAL_STEP_S) + w - 1
    return (host * CPU_BUCKETS + b).to(torch.int32)


def range_ids(device):
    """The ids of the full-width RANGE query's 1 h call (every slot in
    range): the compacted table's rows sorted by (host, ts), replicated
    over RANGE_SLOTS slots, slot j of a row in window (its 5 min slot +
    11 - j) of its host's rank in hostname order: 4,096 x 256 groups.
    Returns (ids [S·N], G + 1)."""
    import torch

    per = ALIGN_S // STEP_S
    lead = RANGE_SLOTS - 1
    cap_b = 1 << (lead + -(-POINTS // per) - 1).bit_length()
    cap_s = 1 << (HOSTS - 1).bit_length()
    rank = torch.from_numpy(np.argsort(host_order())).to(device)
    r = torch.arange(HOSTS * POINTS, device=device)
    host, point = r // POINTS, r % POINTS
    rel = point // per + lead
    j = torch.arange(RANGE_SLOTS, device=device)[:, None]
    ids = (rank[host] * cap_b + rel - j).reshape(-1).to(torch.int32)
    return ids, cap_s * cap_b + 1


def lastpoint_ids(tail_rows, device):
    """The ids of the lastpoint query's K2 call over its boundary subset:
    the visited SST's run start and end of every host (host-major), then
    `tail_rows` memtable rows (time-major, every host a step), id =
    registry code + 1, padded to the subset's block with dead rows.
    Returns (ids, G + 1)."""
    import torch

    from greptimedb_tpu_torch.ops.blocks import block_size_for

    h = torch.arange(HOSTS, device=device, dtype=torch.int32) + 1
    tail = h.repeat(tail_rows // HOSTS)
    live = torch.cat([h.repeat_interleave(2), tail])
    n = block_size_for(len(live))
    g = HOSTS + 2
    pad = torch.full((n - len(live),), g - 1, dtype=torch.int32,
                     device=device)
    return torch.cat([live, pad]), g


def values(n, w, dtype, gen, device, nan_frac=0.0, ties=False):
    import torch

    x = torch.rand((n, w), generator=gen, device=device,
                   dtype=torch.float64) * 100.0
    if ties:
        x = torch.round(x)  # repeated values: ties for min/max
    x = x.to(dtype)
    if nan_frac:
        x[torch.rand((n, w), generator=gen, device=device) < nan_frac] = \
            float("nan")
    return x


def sum_ok(got, want64, absx, dtype) -> tuple[bool, float]:
    """Sum tolerance per cell. f32: |got - want| <= 1e-5 * sum|x|, the
    f32 rounding of an order-free sum of this many terms, with `want` the
    plain version on float64 copies (atomics reorder the additions from
    run to run; an f32 index_add_ reference carries its own sequential
    error, larger than the tolerance at 140 k rows a cell). f64:
    |got - want| <= 1e-12 * sum|x|.
    A cell whose reference is +-inf or NaN (values with infinities) must
    match it exactly."""
    import torch

    got = got.to(torch.float64)
    finite = torch.isfinite(want64)
    same = (got == want64) | (torch.isnan(got) & torch.isnan(want64))
    err = torch.where(finite, (got - want64).abs(), torch.zeros_like(got))
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    ok = bool(((err <= rel * absx) | ~finite).all()
              and (same | finite).all())
    return ok, float(err.max().item()) if err.numel() else 0.0


K1_PLAN_KEYS = ("optin_bytes", "window_ids", "columns_a_group",
                "column_groups", "rows_a_chunk", "staged", "blocks_x",
                "blocks_an_sm", "smem_bytes")
K1_STAT_KEYS = ("rebases", "window_flush_atomics", "direct_global_adds",
                "live_chunks", "sorted_chunks")


def bind_k1_probes(lib):
    """ctypes signatures of segment_sum.cu's two inspection entries, which
    the port itself never calls."""
    import ctypes

    lib.gtpu_segment_sum_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.gtpu_segment_sum_plan.restype = ctypes.c_int
    lib.gtpu_segment_sum_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gtpu_segment_sum_stats.restype = ctypes.c_int


K2_PLAN_KEYS = ("blocks", "rows_per_warp", "smem_bytes", "privatized",
                "blocks_an_sm")


def bind_k2_probes(lib):
    """ctypes signature of fused_segment_agg.cu's inspection entry, which
    the port itself never calls."""
    import ctypes

    lib.gtpu_fused_segment_agg_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.gtpu_fused_segment_agg_plan.restype = ctypes.c_int


def k2_plan(lib, n, f, g, dtype, flags) -> dict:
    """The grid and accumulators K2 launches for this call."""
    import ctypes

    import torch

    out = (ctypes.c_longlong * len(K2_PLAN_KEYS))()
    rc = lib.gtpu_fused_segment_agg_plan(n, f, g, int(dtype == torch.float64),
                                         flags, out)
    check(rc == 0, f"gtpu_fused_segment_agg_plan: CUDA error {rc}")
    return dict(zip(K2_PLAN_KEYS, list(out)))


def k2_global_g(f, dtype, flags) -> int:
    """The least G whose privatized accumulators pass the 48 KB a block
    takes without the opt-in (fused_segment_agg.cu::plan_fused)."""
    import torch

    es = 8 if dtype == torch.float64 else 4
    planes = 1 + bin(flags).count("1")
    return 48 * 1024 // (f * (planes * es + 4) + 4) + 1


def k2_values(n, f, dtype, kind, ids, gen, device):
    """K2's values: ties and 5 % NaN; for `specials`, +inf in group 1,
    -inf in group 2, both in group 3, zeros of both signs in group 4 and
    only -0.0 in group 5."""
    import torch

    vals = values(n, f, dtype, gen, device, nan_frac=0.05, ties=True)
    if kind == "specials":
        coin = torch.rand((n, f), generator=gen, device=device)
        g = ids[:, None].expand(-1, f)
        inf = float("inf")
        vals[(g == 1) & (coin < 0.01)] = inf
        vals[(g == 2) & (coin < 0.01)] = -inf
        vals[(g == 3) & (coin < 0.01)] = inf
        vals[(g == 3) & (coin > 0.99)] = -inf
        vals[(g == 4) & (coin < 0.5)] = -0.0
        vals[(g == 4) & (coin >= 0.5)] = 0.0
        vals[g == 5] = -0.0
    return vals


def check_zero_signs(got, want64, what) -> None:
    """The sign of every zero cell of sum, min and max matches the plain
    version, but for min and max of group 4: which of -0.0 and +0.0 an
    extreme over both keeps depends on the order of the compares, in the
    plain version as in the kernel. Group 5 (only -0.0) keeps -0.0 for
    min and max; every sum starts from the +0.0 identity, so stays +0.0."""
    import torch

    for k in ("sum", "min", "max"):
        if k not in got:
            continue
        w = want64[k]
        zero = w == 0
        if k != "sum":
            zero[4] = False
        check(bool(zero.any()), f"fused {k} {what}: no zero cells")
        check(torch.equal(torch.signbit(got[k].double()[zero]),
                          torch.signbit(w[zero])),
              f"fused {k} {what}: sign of zero")
    if "min" in got:
        check(bool(torch.signbit(want64["min"][5]).all()),
              f"fused min {what}: group 5 is not -0.0")


def device_ms_a_call(fn, torch, calls: int = 10) -> float:
    """CUPTI device time of `fn`'s launches, averaged over `calls` calls."""
    return device_breakdown(lambda: [fn() for _ in range(calls)],
                            torch)["device_ms"] / calls


def check_k2_call(sk, vals, ids, g, want, torch) -> dict:
    """After a warm-up, one K2 call on the card makes exactly one
    allocation and launches exactly two kernels, both K2's own: no fill
    kernel from Python remains."""
    from torch.profiler import ProfilerActivity, profile

    sk.fused_segment_agg(vals, ids, g, *want)
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    sk.fused_segment_agg(vals, ids, g, *want)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sk.fused_segment_agg(vals, ids, g, *want)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {"allocations": allocs, "device_launches": len(names),
           "kernels": [k[:48] for k in names]}
    log("K2 one call: " + json.dumps(res))
    check(allocs == 1, f"K2 call made {allocs} allocations, expected 1")
    check(len(names) == 2 and "fused_init_kernel" in names[0]
          and "fused_agg_kernel" in names[1],
          f"K2 call launched {names}, expected its two kernels")
    return res


def k2_host_cost(sk, lib, vals, ids, g, want, torch,
                 calls: int = 1000) -> dict:
    """Host microseconds a call (perf_counter over `calls` calls, no
    synchronise) of the whole wrapper, of the C side's launch plan through
    ctypes, and of the port's output views (`_fused_outputs`)."""
    import ctypes

    flags = sk._flags(*want)
    n, f = vals.shape
    plan_out = (ctypes.c_longlong * len(K2_PLAN_KEYS))()
    is_double = int(vals.dtype == torch.float64)
    ways = {"wrapper": lambda: sk.fused_segment_agg(vals, ids, g, *want),
            "plan_entry": lambda: lib.gtpu_fused_segment_agg_plan(
                n, f, g, is_double, flags, plan_out),
            "views_as_strided": lambda: sk._fused_outputs(vals, g, flags)}
    res = {}
    for name, fn in ways.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        res[name] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    log("K2 host us a call: " + json.dumps(res))
    return res


def k1_plan(lib, n, w, g, dtype, plane, ids) -> dict:
    """The window, column groups and grid K1 launches for this call."""
    import ctypes

    import torch

    out = (ctypes.c_longlong * len(K1_PLAN_KEYS))()
    aligned = (plane.data_ptr() | ids.data_ptr()) % 16 == 0
    rc = lib.gtpu_segment_sum_plan(n, w, g, int(dtype == torch.float64),
                                   int(aligned), out)
    check(rc == 0, f"gtpu_segment_sum_plan: CUDA error {rc}")
    return dict(zip(K1_PLAN_KEYS, list(out)))


def k1_stats(lib, reset: bool) -> dict:
    """K1's device counters summed over launches since the last reset."""
    import ctypes

    out = (ctypes.c_ulonglong * len(K1_STAT_KEYS))()
    rc = lib.gtpu_segment_sum_stats(out, int(reset))
    check(rc == 0, f"gtpu_segment_sum_stats: CUDA error {rc}")
    return dict(zip(K1_STAT_KEYS, list(out)))


def check_k1_window(case, torch) -> None:
    """The headline runs the windowed branch: its window is sized from the
    card's opt-in shared memory (not the 48 KB a block gets without it),
    most of its chunks add without atomics, and its global atomics are
    window flushes, far fewer than one per live row and column."""
    plan, stats = case["plan"], case["stats"]
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", plan["optin_bytes"])
    es = 8 if "float64" in case["dtype"] else 4
    window = plan["window_ids"] * plan["columns_a_group"] * es
    n, w = case["shape"]
    cells = n * w
    log("K1 headline window: " + json.dumps({
        "optin_bytes": plan["optin_bytes"], "device_optin_bytes": optin,
        "window_bytes": window, "smem_bytes": plan["smem_bytes"],
        "global_atomics": stats["window_flush_atomics"]
        + stats["direct_global_adds"], "row_cells": cells,
        "sorted_chunk_share": stats["sorted_chunks"]
        / max(stats["live_chunks"], 1)}))
    check(plan["optin_bytes"] == optin and optin > 48 * 1024,
          f"K1 plan reads opt-in {plan['optin_bytes']}, device {optin}")
    check(window > 48 * 1024 and plan["smem_bytes"] <= optin,
          f"K1 window {window} B is not sized past 48 KB")
    check(stats["sorted_chunks"] * 2 > stats["live_chunks"],
          "K1 headline chunks mostly took the atomic path")
    check(stats["direct_global_adds"] * 100 < cells
          and stats["window_flush_atomics"] * 4 < cells,
          f"K1 headline global atomics {stats}: not the windowed branch")


def k2_phase(sk, lib, torch, gen, dev) -> dict:
    """K2 against its float64 plain version, case by case."""
    # K2: fused_segment_agg over raw values. Main-path shapes: the padded
    # blocks of single_groupby_1_1_1 (1,024 rows, F=1, G+1=61),
    # cpu_max_all_8 (32,768 rows, F=10, G+1=9) and groupby_orderby_limit
    # (131,072 rows, F=1, G+1=6); then the contention case (k2[3] is the
    # headline). Then cases that reach each branch: accumulators past
    # 48 KB (global atomics), random ids (peer groups in every warp), tiny
    # and ragged n, every row dead, and infinities and signed zeros.
    bind_k2_probes(lib)
    f32, f64 = torch.float32, torch.float64
    mm, mmq, none = (True, True, False), (True, True, True), \
        (False, False, False)
    gf32, gf64 = (k2_global_g(10, dt, sk._flags(*mmq)) for dt in (f32, f64))
    k2 = []
    cases = [
        # (n, F, G+1, buckets, run, dead share, dtype, (min, max, sumsq),
        #  ids: time-major runs or random; values: plain or specials)
        (1024, 1, 61, 60, 6, 0.65, f32, mm, "runs"),
        (32768, 10, 9, 8, 360 * 8, 0.3, f32, mmq, "runs"),
        (32768, 10, 9, 8, 360 * 8, 0.3, f32, none, "runs"),
        (131072, 1, 6, 5, 6 * HOSTS, 0.08, f32, mm, "runs"),
        (8_388_608, 1, 721, 720, 6 * HOSTS, 0.1, f32, mm, "runs"),
        (32768, 10, 9, 8, 360 * 8, 0.3, f64, mmq, "runs"),
        (8_388_608, 1, 721, 720, 6 * HOSTS, 0.1, f64, mmq, "runs"),
        (262_144, 10, gf32, gf32 - 1, 64, 0.2, f32, mmq, "runs"),
        (262_144, 10, gf64, gf64 - 1, 64, 0.2, f64, mmq, "runs"),
        (131072, 1, 61, 60, 1, 0.1, f32, mm, "random"),
        (1, 1, 6, 5, 6, 0.0, f32, mm, "runs"),
        (31, 1, 6, 5, 6, 0.3, f32, mm, "runs"),
        (1_000_001, 3, 9, 8, 360 * 8, 0.3, f32, mmq, "runs"),
        (100_000, 10, 9, 8, 360 * 8, 1.0, f32, mmq, "runs"),
        (65536, 4, 9, 8, 360 * 8, 0.1, f32, mmq, "specials"),
        # F = 40 (the JAX kernel's cap with sumsq): two 32-field rounds
        (65536, 40, 9, 8, 360 * 8, 0.3, f32, mmq, "runs"),
        # peer groups with every plane, in f64
        (131072, 10, 61, 60, 1, 0.1, f64, mmq, "random"),
        # F = 1 past 48 KB: the global branch's one-lane instance
        (1_000_000, 1, 4097, 4096, 64, 0.2, f32, mmq, "runs"),
        (1_000_000, 1, 4097, 4096, 1, 0.2, f64, mm, "random"),
        # PromQL's two shapes, f64: the label aggregation of bench.py's
        # sum(rate(prom_cpu[360s])) (10,000 series x 241 steps, every row
        # in segment 0, G+1 = 2), and the window buckets of
        # max_over_time(cpu{__field__="usage_user"}[1h]) at step 5 m on
        # the `cpu` table (series-major rows, S x B + 1 segments, max)
        (PROM_SERIES, PROM_STEPS, 2, 1, PROM_SERIES, 0.0, f64, none,
         "runs"),
        (HOSTS * POINTS, 1, HOSTS * CPU_BUCKETS + 1, HOSTS * CPU_BUCKETS,
         0, 0.0, f64, (False, True, False), "prom_buckets"),
        # the sparse route's one call (check 1 of the main path): the
        # padded whole scan of the `cpu` table sorted by hostname x minute,
        # compact ids rising by one every 6 rows, U = 2,880,000 groups +
        # the dead slot, F = 2 (avg(usage_user), max(usage_system))
        (SPARSE_PAD_ROWS, 2, SPARSE_U + 1, SPARSE_U, 6, 0.0, f32,
         (False, True, False), "compact"),
        # the full-width RANGE query's 1 h call: [12 x 17,280,000 x 2]
        # slot-replicated f64 rows (usage_user, usage_system), G+1 =
        # 1,048,577, sum, count, min and max
        (RANGE_SLOTS * HOSTS * POINTS, 2, None, None, 0, 0.0, f64, mm,
         "range"),
        # lastpoint's boundary subsets, the 10 fields in f32 over G+1 =
        # HOSTS + 2: after the ingest (two rows a host of the newest SST
        # and the memtable tail) and after a flush (two rows a host)
        (None, 10, None, None, LASTPOINT_TAIL_ROWS, 0.0, f32, none,
         "lastpoint"),
        (None, 10, None, None, 0, 0.0, f32, none, "lastpoint"),
    ]
    branches = set()  # (dtype, F > 1, privatized) of the cases run
    for idx, (n, f, g, nb, run, dead, dtype, want, kind) in enumerate(cases):
        mn, mx, sq = want
        if kind == "random":
            ids = torch.randint(0, nb, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            ids[torch.rand(n, generator=gen, device=dev) < dead] = nb
        elif kind == "compact":  # sorted; the padding rows dead at the end
            ids = torch.clamp(torch.arange(n, device=dev) // run,
                              max=nb).to(torch.int32)
        elif kind == "prom_buckets":
            ids = cpu_bucket_ids(dev)
        elif kind == "range":
            ids, g = range_ids(dev)
        elif kind == "lastpoint":
            ids, g = lastpoint_ids(run, dev)
            n = len(ids)
        else:
            ids = time_major_ids(n, nb, run, dead, gen, dev)
        vals = k2_values(n, f, dtype, kind, ids, gen, dev)
        got = sk.fused_segment_agg(vals, ids, g, mn, mx, sq)
        torch.cuda.synchronize()
        want64 = sk.fused_segment_agg_plain(vals.double(), ids, g, mn, mx,
                                            sq)
        absx = sk.fused_segment_agg_plain(vals.double().abs(), ids, g,
                                          False, False, sq)
        what = f"{n}x{f} G={g} {dtype} {kind}"
        for k in ("count", "rows"):
            check(torch.equal(got[k], want64[k]), f"fused {k} {what}")
        for k in ("min", "max"):
            if k in got:
                check(torch.equal(got[k].double(), want64[k]),
                      f"fused {k} {what}")
        if kind == "specials":
            check_zero_signs(got, want64, what)
        ok, err = sum_ok(got["sum"], want64["sum"], absx["sum"], dtype)
        check(ok, f"fused sum {what}: max err {err}")
        if sq:
            ok_q, err_q = sum_ok(got["sumsq"], want64["sumsq"],
                                 absx["sumsq"], dtype)
            check(ok_q, f"fused sumsq {what}: err {err_q}")
        live_mask = (ids >= 0) & (ids < g - 1)
        live = int(live_mask.sum().item())
        es = vals.element_size()
        outs = g * f * (es + 4) + g * 4 + g * f * es * (mn + mx + sq)
        nbytes = 4 * n + live * f * es + outs
        b_ms, b_by = bound(nbytes, live * f * (2 + mn + mx + 2 * sq), dtype)
        def call():
            return sk.fused_segment_agg(vals, ids, g, mn, mx, sq)

        k_ms = cuda_ms(call)
        d_ms = device_ms_a_call(call, torch)
        p_ms = cuda_ms(lambda: sk.fused_segment_agg_plain(vals, ids, g, mn,
                                                          mx, sq), runs=5)
        plan = k2_plan(lib, n, f, g, dtype, sk._flags(*want))
        smem = g * f * ((1 + mn + mx + sq) * es + 4) + g * 4
        check(plan["smem_bytes"] == smem
              and plan["privatized"] == int(smem <= 48 * 1024),
              f"K2 {what}: plan {plan}")
        branches.add((dtype, f > 1, plan["privatized"]))
        case = {"shape": [n, f], "G": g, "dtype": str(dtype),
                "want": {"min": mn, "max": mx, "sumsq": sq}, "ids": kind,
                "live_rows": live, "run": run, "max_abs_err": err,
                "ms": k_ms, "device_ms": d_ms, "bound_share": b_ms / k_ms,
                "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                "bound_by": b_by, "plan": plan}
        log("K2 fused_segment_agg " + json.dumps(case))
        k2.append(case)
        if idx == 3:
            case["one_call"] = check_k2_call(sk, vals, ids, g, want, torch)
            case["host_us"] = k2_host_cost(sk, lib, vals, ids, g, want,
                                           torch)
        del vals, ids, got, want64, absx
        torch.cuda.empty_cache()
    # every instance of the kernel ran: f32 and f64, F = 1 and F > 1,
    # privatized and global
    check(len(branches) == 8, f"K2 branches run: {sorted(map(str, branches))}")
    return {"cases": k2, "headline": k2[3], "sparse": k2[-4],
            "promql_label": k2[-6], "promql_buckets": k2[-5],
            "range": k2[-3], "lastpoint_ingest": k2[-2],
            "lastpoint_flushed": k2[-1]}


def kernel_phase(sk, lib, torch) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # K1: segment_sum over prepared planes. The five main-path shapes first
    # (k1[0] is the headline), then cases that reach each branch of the
    # windowed kernel.
    k1 = []
    n = 8_388_608
    cases = [(n, 11, torch.float32, "hosthour"),
             (n, 21, torch.float32, "hosthour"),
             (n, 11, torch.float32, "minute"),
             (n, 21, torch.float32, "minute"),
             (n, 11, torch.float64, "hosthour"),
             # the window never holds a chunk's ids: adds go to global memory
             (2_097_152, 11, torch.float32, "hostmajor"),
             # host x hour at two points an hour: the window re-bases often
             (2_097_152, 11, torch.float32, "fewpoints"),
             # W = 33 f32: the columns split into groups
             (2_097_152, 33, torch.float32, "hosthour"),
             # tiny and ragged n (a chunk is 256 rows at W = 11)
             (1, 11, torch.float32, "hosthour"),
             (31, 11, torch.float32, "hosthour"),
             (1000, 11, torch.float32, "hosthour"),
             (257, 11, torch.float32, "hosthour"),
             (100_000, 11, torch.float32, "alldead"),
             (100_000, 11, torch.float32, "g2"),
             # not 16-byte aligned, and rows too wide for the ring: the
             # kernel reads rows and ids from global memory
             (1_000_001, 11, torch.float32, "unaligned"),
             (262_144, 300, torch.float32, "hosthour"),
             # the streamed cpu_big query's block: [2 Mi x 21] host-major
             # rows over G + 1 = 280,071 segments
             (2_097_152, 21, torch.float32, "stream")]
    for n, w, dtype, kind in cases:
        if kind == "hosthour":
            ids, g = host_hour_ids(n, HOSTS, 3600 // STEP_S, HOURS, 0.1, gen,
                                   dev)
        elif kind == "minute":
            g = 61
            ids = time_major_ids(n, 60, 6 * HOSTS, 0.1, gen, dev)
        elif kind == "hostmajor":
            ids, g = host_major_ids(n, HOSTS, HOURS, 0.1, gen, dev)
        elif kind == "fewpoints":
            ids, g = host_hour_ids(n, HOSTS, 2, n // (2 * HOSTS) + 1, 0.1,
                                   gen, dev)
        elif kind == "alldead":
            g = HOURS * (HOSTS + 1) + 1
            ids = torch.full((n,), g - 1, dtype=torch.int32, device=dev)
        elif kind == "g2":  # one live group and the dead segment
            g = 2
            ids = time_major_ids(n, 1, 7, 0.3, gen, dev)
        elif kind == "stream":
            ids, g = stream_block_ids(n, dev)
        if kind == "unaligned":  # views one row into their buffers
            ids, g = host_hour_ids(n + 1, HOSTS, 3600 // STEP_S, HOURS, 0.1,
                                   gen, dev)
            ids = ids[1:]
            plane = values(n + 1, w, dtype, gen, dev).reshape(-1)[w:].view(
                n, w)
        else:
            plane = values(n, w, dtype, gen, dev)
        k1_stats(lib, reset=True)
        got = sk.segment_sum(plane, ids, g)
        torch.cuda.synchronize()
        stats = k1_stats(lib, reset=True)
        want = sk.segment_sum_plain(plane.double(), ids, g)
        absx = sk.segment_sum_plain(plane.double().abs(), ids, g)
        ok, err = sum_ok(got, want, absx, dtype)
        f32_plain_err = float((sk.segment_sum_plain(plane, ids, g).double()
                               - want).abs().max().item())
        check(ok, f"segment_sum {n}x{w} G={g} {dtype} {kind}: max err {err}")
        live = int(((ids >= 0) & (ids < g - 1)).sum().item())
        es = plane.element_size()
        nbytes = 4 * n + live * w * es + g * w * es
        b_ms, b_by = bound(nbytes, live * w, dtype)
        k_ms = cuda_ms(lambda: sk.segment_sum(plane, ids, g))
        p_ms = cuda_ms(lambda: sk.segment_sum_plain(plane, ids, g), runs=5)
        lib_out = torch.zeros((g, w), dtype=dtype, device=dev)
        l_ms = cuda_ms(lambda: lib_out.index_add_(0, ids, plane), runs=5)
        case = {"shape": [n, w], "G": g, "dtype": str(dtype), "ids": kind,
                "max_abs_err": err, "f32_plain_max_abs_err": f32_plain_err,
                "ms": k_ms, "bound_share": b_ms / k_ms, "plain_ms": p_ms,
                "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                "plan": k1_plan(lib, n, w, g, dtype, plane, ids),
                "stats": stats}
        log("K1 segment_sum " + json.dumps(case))
        check(case["plan"]["staged"] == int(kind != "unaligned" and w < 300),
              f"K1 {kind} W={w}: staged {case['plan']['staged']}")
        k1.append(case)
        del plane, ids, got, want, absx, lib_out
        torch.cuda.empty_cache()
    results["segment_sum"] = {"cases": k1, "headline": k1[0],
                              "stream": k1[-1]}
    check(k1[0]["G"] == 48013, "K1 headline shape")
    check(k1[-1]["G"] == 280_071, "K1 stream shape")
    check_k1_window(k1[0], torch)

    results["fused_segment_agg"] = k2_phase(sk, lib, torch, gen, dev)

    # refusals: an int64 plane / value matrix is not a kernel input
    bad = torch.ones((64, 3), dtype=torch.int64, device=dev)
    bad_ids = torch.zeros(64, dtype=torch.int32, device=dev)
    for name, fn in (("segment_sum", lambda: sk.segment_sum(bad, bad_ids, 2)),
                     ("fused_segment_agg",
                      lambda: sk.fused_segment_agg(bad, bad_ids, 2))):
        try:
            fn()
        except TypeError as e:
            log(f"{name} refuses int64: {e}")
        else:
            raise CheckFailed(f"{name} accepted an int64 input")
    return results


# ---- phase 3: the main path at TSBS scale, on disk ---------------------------

#: the device the engines run on: the card (None). A rehearsal on the CPU
#: at a small HOSTS and HOURS sets "cpu".
DEVICE = None
#: decoded SST parts a region keeps on the host: the whole table's parts
#: under every projection the six queries use stay decoded
PART_CACHE_BYTES = 16 << 30
#: the partial-aggregate cache's byte budget in this run
PARTIAL_CACHE_BYTES = 2 << 30
#: rows a put (about 2M, as bench.py batches) and the auto-flush
#: threshold (EngineConfig's default, 256 MB of memtable)
BATCH_ROWS = 1 << 21
FLUSH_THRESHOLD_BYTES = 256 << 20


def open_engine(root):
    """A disk-backed engine (WAL fsynced at every put) and a query engine
    over a catalog persisted beside it, both on DEVICE."""
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    engine = RegionEngine(EngineConfig(
        data_dir=os.path.join(root, "data"), wal_sync=True,
        flush_threshold_bytes=FLUSH_THRESHOLD_BYTES,
        scan_part_cache_bytes=PART_CACHE_BYTES), device=DEVICE)
    qe = QueryEngine(Catalog(FileKv(os.path.join(root, "catalog.json"))),
                     engine, device=DEVICE)
    return engine, qe


def put_points(engine, info, rng, p0, p1, host_names, fields) -> int:
    """One put of points [p0, p1) for every host; appends the field values
    to `fields` for the oracle."""
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    n = (p1 - p0) * HOSTS
    cols = {
        "hostname": DictVector(np.tile(np.arange(HOSTS, dtype=np.int32),
                                       p1 - p0), host_names),
        "ts": np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64)
                        * STEP_S * 1000, HOSTS),
    }
    for f in FIELDS:
        cols[f] = rng.uniform(0.0, 100.0, n)
        fields[f].append(cols[f])
    return engine.put(info.region_ids[0], RecordBatch(info.schema, cols))


def build_and_ingest(root, rng):
    engine, qe = open_engine(root)
    field_defs = ",\n  ".join(f"{f} DOUBLE" for f in FIELDS)
    qe.execute_one(f"""
        CREATE TABLE cpu (
          hostname STRING,
          ts TIMESTAMP(3) NOT NULL,
          {field_defs},
          TIME INDEX (ts),
          PRIMARY KEY (hostname)
        ) WITH (append_mode = 'true')
    """)
    info = qe.catalog.table("public", "cpu")
    points = HOURS * 3600 // STEP_S
    host_names = np.asarray([f"host_{i}" for i in range(HOSTS)], dtype=object)
    slice_points = max(1, BATCH_ROWS // HOSTS)
    fields = {f: [] for f in FIELDS}
    t0 = time.perf_counter()
    rows = 0
    for p0 in range(0, points, slice_points):
        rows += put_points(engine, info, rng, p0,
                           min(p0 + slice_points, points), host_names, fields)
    ingest_s = time.perf_counter() - t0
    # [points, hosts] views of the same values, for the oracle
    grid = {f: np.concatenate(fields[f]).reshape(points, HOSTS)
            for f in FIELDS}
    region = engine.region(info.region_ids[0])
    log("ingest: " + json.dumps({
        "rows": rows, "seconds": ingest_s, "rows_per_s": rows / ingest_s,
        "puts": -(-points // slice_points), "wal_fsyncs": engine.wal.sync_count,
        "sst_files": len(region.files), "sst_bytes": region.sst_bytes,
        "wal_bytes_written": engine.wal.bytes_written,
        "wal_bytes_on_disk": engine.wal.region_bytes(region.region_id),
        "memtable_rows": region.memtable.num_rows}))
    return engine, qe, rows, grid, host_names


def tsbs_queries():
    """bench.py's six `cpu` queries (bench.py:233-372): name -> (SQL,
    last_path on the card, rows or None when the oracle counts them)."""
    t_end = T0_MS + HOURS * 3600 * 1000
    cutoff = T0_MS + (HOURS * 3600 * 1000) * 3 // 4
    avg_list = ", ".join(f"avg({f})" for f in FIELDS)
    max_list = ", ".join(f"max({f})" for f in FIELDS)
    lv_list = ", ".join(f"last_value({f} ORDER BY ts)" for f in FIELDS)
    hosts8 = ", ".join(f"'host_{i}'" for i in range(8))
    return {
        "single_groupby_1_1_1": (
            "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
            "max(usage_user) FROM cpu "
            f"WHERE hostname = 'host_0' AND ts >= {T0_MS} "
            f"AND ts < {T0_MS + 3600 * 1000} "
            "GROUP BY minute ORDER BY minute", "dense_fused", 60),
        "cpu_max_all_8": (
            f"SELECT date_bin(INTERVAL '1 hour', ts) AS hour, {max_list} "
            f"FROM cpu WHERE hostname IN ({hosts8}) "
            f"AND ts >= {T0_MS} AND ts < {T0_MS + 8 * 3600 * 1000} "
            "GROUP BY hour ORDER BY hour", "dense_fused", 8),
        "groupby_orderby_limit": (
            "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
            f"max(usage_user) FROM cpu WHERE ts < {cutoff} "
            "GROUP BY minute ORDER BY minute DESC LIMIT 5",
            "bucket_topk+dense_fused", 5),
        "double_groupby_all": (
            f"SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
            f"{avg_list} FROM cpu WHERE ts >= {T0_MS} AND ts < {t_end} "
            f"GROUP BY hour, hostname ORDER BY hour, hostname",
            "dense_prepared", HOSTS * HOURS),
        # SSTs newest-first (Region.scan_last), then the series-run
        # boundary rows (_boundary_firstlast): K2 over G+1 = 4,002
        # segments of that subset
        "lastpoint": (
            f"SELECT hostname, {lv_list} FROM cpu GROUP BY hostname",
            "lastscan+boundary+dense_fused", HOSTS),
        # a raw scan: no aggregate, so no last_path
        "high_cpu_all": (
            f"SELECT * FROM cpu WHERE usage_user > 90.0 "
            f"AND ts >= {T0_MS} AND ts < {t_end}", None, None),
    }


def f32_exact(x: np.ndarray) -> np.ndarray:
    """The float64 oracle as the f32 kernels see it: max of f32-cast
    values is the f32 cast of the f64 max."""
    return x.astype(np.float32).astype(np.float64)


def host_index(names: np.ndarray) -> np.ndarray:
    """'host_<i>' strings -> i."""
    uniq, inv = np.unique(names.astype(str), return_inverse=True)
    return np.asarray([int(u[5:]) for u in uniq], dtype=np.int64)[inv]


def check_result(name, res, grid):
    """Every value of `res` against the float64 oracle over `grid`
    ([points, hosts] per field; the first HOURS of points are the
    dashboard window, a later point may follow it)."""
    per_hour = 3600 // STEP_S
    window = HOURS * per_hour
    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    if name == "single_groupby_1_1_1":
        want = grid["usage_user"][:per_hour, 0].reshape(60, 6).max(axis=1)
        check(np.array_equal(cols["minute"],
                             T0_MS + np.arange(60) * 60_000), name + " keys")
        check(np.array_equal(cols["max(usage_user)"].astype(np.float64),
                             f32_exact(want)), name + " max")
    elif name == "cpu_max_all_8":
        check(np.array_equal(cols["hour"], T0_MS + np.arange(8) * 3_600_000),
              name + " keys")
        for f in FIELDS:
            want = grid[f][:8 * per_hour, :8].reshape(8, -1).max(axis=1)
            check(np.array_equal(cols[f"max({f})"].astype(np.float64),
                                 f32_exact(want)), f"{name} max({f})")
    elif name == "groupby_orderby_limit":
        cut_pt = window * 3 // 4
        minutes = np.arange(cut_pt // 6 - 1, cut_pt // 6 - 6, -1)
        want = np.asarray([grid["usage_user"][m * 6:(m + 1) * 6].max()
                           for m in minutes])
        check(np.array_equal(cols["minute"], T0_MS + minutes * 60_000),
              name + " keys")
        check(np.array_equal(cols["max(usage_user)"].astype(np.float64),
                             f32_exact(want)), name + " max")
    elif name == "double_groupby_all":
        order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                           kind="stable")
        hours = np.repeat(np.arange(HOURS), HOSTS)
        check(np.array_equal(cols["hour"], T0_MS + hours * 3_600_000),
              name + " hour keys")
        check(np.array_equal(host_index(cols["hostname"]),
                             np.tile(order, HOURS)), name + " hostname keys")
        for f in FIELDS:
            want = grid[f][:window].reshape(HOURS, per_hour, HOSTS).mean(
                axis=1)[:, order].reshape(-1)
            got = cols[f"avg({f})"].astype(np.float64)
            check(np.allclose(got, want, rtol=1e-5, atol=0),
                  f"{name} avg({f}): max rel err "
                  f"{np.max(np.abs(got - want) / np.abs(want))}")
    elif name == "lastpoint":
        hosts = host_index(cols["hostname"])
        check(np.array_equal(np.sort(hosts), np.arange(HOSTS)),
              name + " hostname keys")
        for f, col in zip(FIELDS, res.names[1:]):
            check(np.array_equal(cols[col].astype(np.float64),
                                 f32_exact(grid[f][-1, hosts])),
                  f"{name} {col}")
    else:  # high_cpu_all: raw rows, any order, values exact
        hit = grid["usage_user"][:window] > 90.0
        want = np.flatnonzero(hit.reshape(-1))  # point * HOSTS + host
        pts = (cols["ts"].astype(np.int64) - T0_MS) // (STEP_S * 1000)
        got = pts * HOSTS + host_index(cols["hostname"])
        order = np.argsort(got, kind="stable")
        check(np.array_equal(got[order], want),
              f"{name}: {len(got)} rows, {len(want)} expected")
        p, h = np.divmod(want, HOSTS)
        for f in FIELDS:
            check(np.array_equal(cols[f].astype(np.float64)[order],
                                 grid[f][p, h]), f"{name} {f}")


def device_breakdown(fn, torch) -> dict:
    """One run of `fn` under torch.profiler: host wall ms, summed device
    activity ms (kernels and copies, CUPTI), the device's idle share of
    the wall time, and the five largest device activities."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
            "top": [[k[:60], v] for k, v in top]}


def host_breakdown(fn, top: int = 8) -> dict:
    """One run of `fn` under cProfile: host wall ms and the `top`
    functions by own time (ms), to say where a host-bound query's time
    goes. The profiler slows Python calls, so the shares matter, not the
    sum."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.runcall(fn)
    wall_ms = (time.perf_counter() - t) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2], f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
                   for k, v in stats.items()), reverse=True)[:top]
    return {"wall_ms": wall_ms,
            "top_own_ms": [[name, own * 1e3] for own, name in rows]}


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_queries(qe, sk, torch, grid, state, timed, lib=None) -> dict:
    """The six queries in one storage state, each checked against the
    oracle and its last_path. The kernels' counts are zeroed just before
    and read just after; each state must launch both kernels. `timed`
    adds five warm runs and a profiled one a query."""
    if lib is not None:
        k1_stats(lib, reset=True)
    sk.segment_sum.launches = 0
    sk.fused_segment_agg.launches = 0
    out = {}
    for name, (sql, want_path, want_rows) in tsbs_queries().items():
        k1, k2 = sk.segment_sum.launches, sk.fused_segment_agg.launches
        sync(torch)
        t = time.perf_counter()
        res = qe.execute_one(sql)
        sync(torch)
        cold_ms = (time.perf_counter() - t) * 1e3
        path = qe.executor.last_path
        check(want_rows is None or res.num_rows == want_rows,
              f"{state} {name}: {res.num_rows} rows, expected {want_rows}")
        check(path == want_path, f"{state} {name}: last_path {path}, "
              f"expected {want_path}")
        check_result(name, res, grid)
        out[name] = {"cold_ms": cold_ms, "rows": res.num_rows,
                     "last_path": path,
                     "k1_launches": sk.segment_sum.launches - k1,
                     "k2_launches": sk.fused_segment_agg.launches - k2}
        if timed:
            warm = []
            for _ in range(5):
                t = time.perf_counter()
                qe.execute_one(sql)
                warm.append((time.perf_counter() - t) * 1e3)
            out[name]["warm_p50_ms"] = float(np.median(warm))
        if name == "lastpoint":
            out[name]["scan_last"] = lastpoint_scan(qe, sql)
        log(f"{state} query {name}: " + json.dumps(out[name]))
        if timed and torch.cuda.is_available():
            prof = device_breakdown(lambda: qe.execute_one(sql), torch)
            if name == "lastpoint":
                # the whole-scan route's device ms before lastpoint
                # pruning (PERF.md §5), for comparison
                prof["whole_scan_device_ms_before_pruning"] = 16.570
            out[name]["profile"] = prof
            log(f"{state} profile {name} (one warm run, profiler on): "
                + json.dumps(prof))
        if timed and name == "double_groupby_all":
            log(f"{state} host breakdown of a warm {name}: "
                + json.dumps(host_breakdown(lambda: qe.execute_one(sql))))
    launches = {"segment_sum": sk.segment_sum.launches,
                "fused_segment_agg": sk.fused_segment_agg.launches}
    log(f"{state} launches: " + json.dumps(launches))
    if lib is not None:
        log(f"{state} K1 counters: " + json.dumps(k1_stats(lib, reset=True)))
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched in the {state} state")
    return {"launches": launches, "queries": out}


def lastpoint_scan(qe, sql) -> dict:
    """One more run of the lastpoint query, reading the pruned scan it
    asks the region for: SSTs visited and pruned, rows before and after
    the boundary gather. Fewer SSTs visited than the region holds."""
    got = []
    real = qe.region_engine.scan_last

    def spy(*a, **k):
        got.append(real(*a, **k))
        return got[-1]

    qe.region_engine.scan_last = spy
    try:
        qe.execute_one(sql)
    finally:
        del qe.region_engine.scan_last
    check(len(got) == 1 and got[0] is not None,
          "lastpoint: no pruned scan served the query")
    scan = got[0]
    reduced = scan.__dict__.get("_boundary_fl_cache")
    check(bool(reduced), "lastpoint: no boundary gather on its scan")
    st = scan.stats
    out = {"ssts": st["ssts"], "visited": st["lastpoint_visited"],
           "pruned": st["ssts_pruned"], "rows_scanned": scan.num_rows,
           "rows_after_gather": reduced.num_rows}
    check(st["ssts"] < 2 or st["lastpoint_visited"] < st["ssts"],
          f"lastpoint visited every SST: {out}")
    return out


def hot_set_line(qe, torch) -> str:
    cache = qe.executor.cache
    return json.dumps({
        "resident_bytes": cache.resident_bytes, "h2d_bytes": cache.h2d_bytes,
        "h2d_by_anchor": cache.h2d_by_anchor, "hits": cache.hits,
        "misses": cache.misses,
        "max_memory_allocated": torch.cuda.max_memory_allocated()
        if torch.cuda.is_available() else None})


def main_path_phase(sk, torch, lib=None) -> dict:
    """Ingest through the WAL and auto-flushes, the six queries, a small
    write and its re-query, flush + restart, full compaction: every state
    held against the oracle. The data dir is removed at the end."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch import config
    from greptimedb_tpu_torch.ops.blocks import (
        DEFAULT_BLOCK_ROWS,
        block_size_for,
    )

    # whether the compacted file of the whole table spans several device
    # blocks (the fold's one-block-per-part gate)
    full_multi = block_size_for(HOSTS * (HOURS * 3600 // STEP_S + 1)) \
        > DEFAULT_BLOCK_ROWS
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        du = shutil.disk_usage(root)
        log(f"disk at {root}: total {du.total}, free {du.free} bytes")
        rng = np.random.default_rng(SEED)
        # 1. ingest
        engine, qe, rows, grid, host_names = build_and_ingest(root, rng)
        check(rows == HOSTS * HOURS * 3600 // STEP_S, "ingested rows")
        info = qe.catalog.table("public", "cpu")
        rid = info.region_ids[0]
        check(len(engine.region(rid).files) >= 2,
              "ingest: the auto-flush left fewer than two SSTs")
        # 2. the six queries on the classic routes (the partial cache
        # off): the main path's launch counts come from here
        with partial_cache(False):
            main = run_queries(qe, sk, torch, grid, "ingest", True, lib)
        log("hot set after the queries: " + hot_set_line(qe, torch))
        # the sparse route, cache off then on; the six queries and the
        # host aggregates with the cache on
        sparse = sparse_phase(qe, sk, torch, grid, engine.region(rid))
        cached = {"ingest": run_cached_queries(
            qe, sk, torch, grid, "ingest", main["queries"],
            engine.region(rid), full_multi)}
        with partial_cache(True):
            host_aggs = host_agg_phase(qe, sk, torch, grid)
        promql_cpu = promql_cpu_phase(qe, sk, torch, grid)
        ranges = {"ingest": range_phase(qe, sk, torch, grid, "ingest", True),
                  "fill": range_fill_phase(qe, sk, torch, grid)}
        host_sql = host_sql_phase(qe, sk, torch, grid)

        # 3. one more 10 s step for every host, then the re-query: the SST
        # parts' file-anchored blocks hit, only the memtable tail uploads
        fields = {f: [] for f in FIELDS}
        points = HOURS * 3600 // STEP_S
        put_points(engine, info, rng, points, points + 1, host_names, fields)
        grid = {f: np.concatenate([grid[f], fields[f][0][None, :]])
                for f in FIELDS}
        cache = qe.executor.cache
        before = dict(cache.h2d_by_anchor)
        h2d0, hits0 = cache.h2d_bytes, cache.hits
        sql = tsbs_queries()["double_groupby_all"][0]
        with partial_cache(False):
            res = qe.execute_one(sql)
        check_result("double_groupby_all", res, grid)
        tail_rows = engine.region(rid).memtable.num_rows
        elem = torch.finfo(config.compute_dtype(qe.device)).bits // 8
        # hostname int32 + ts int64 + the [values | ones] plane (no NULLs)
        want = block_size_for(tail_rows) * (4 + 8 + (len(FIELDS) + 1) * elem)
        step3 = {"h2d_bytes": cache.h2d_bytes - h2d0,
                 "h2d_file": cache.h2d_by_anchor["file"] - before["file"],
                 "h2d_snap": cache.h2d_by_anchor["snap"] - before["snap"],
                 "tail_rows": tail_rows, "tail_bytes_expected": want,
                 "hits": cache.hits - hits0,
                 "resident_bytes": cache.resident_bytes}
        log("post-flush write, re-query double_groupby_all: "
            + json.dumps(step3))
        check(step3["h2d_file"] == 0 and step3["h2d_snap"] == want
              and step3["h2d_bytes"] == want,
              "the re-query after a small write uploaded more than the "
              "memtable tail's blocks")
        cached["write"] = run_cached_queries(
            qe, sk, torch, grid, "write", {}, engine.region(rid), full_multi)

        # 4. flush, close, reopen on the same data dir in this process
        t = time.perf_counter()
        qe.execute_one("ADMIN flush_table('cpu')")
        flush_s = time.perf_counter() - t
        engine.close()
        t = time.perf_counter()
        engine, qe = open_engine(root)
        region = engine.open_region(rid)
        reopen_s = time.perf_counter() - t
        log("flush + reopen: " + json.dumps({
            "flush_s": flush_s, "reopen_s": reopen_s,
            "wal_entries_replayed": region.replayed_entries,
            "sst_files": len(region.files), "sst_bytes": region.sst_bytes,
            "memtable_rows": region.memtable.num_rows}))
        with partial_cache(False):
            reopened = run_queries(qe, sk, torch, grid, "reopened", False,
                                   lib)
        cached["reopened"] = run_cached_queries(
            qe, sk, torch, grid, "reopened", {}, region, full_multi)

        # 5. full compaction: sort_dedup on the engine's device
        cache = qe.executor.cache
        old = set(region.files)
        check({k[2] for k in cache.file_keys(rid)} == old,
              "reopened: the SST blocks are not all resident")
        t = time.perf_counter()
        with partial_cache(False):
            qe.execute_one("ADMIN compact_table('cpu')")
        compact_s = time.perf_counter() - t
        left = {k[2] for k in cache.file_keys(rid)}
        log("compaction: " + json.dumps({
            "seconds": compact_s, "files_before": len(old),
            "files_after": len(region.files), "sst_bytes": region.sst_bytes,
            "stale_blocks_left": len(left & old)}))
        check(len(region.files) == 1 and not left & old,
              "compaction: the old files' device blocks outlived them")
        with partial_cache(False):
            compacted = run_queries(qe, sk, torch, grid, "compacted", False,
                                    lib)
        check({k[2] for k in cache.file_keys(rid)} == set(region.files),
              "compacted: the merged file's blocks were not rebuilt")
        ranges["compacted"] = range_phase(qe, sk, torch, grid, "compacted",
                                          False)
        cached["compacted"] = run_cached_queries(
            qe, sk, torch, grid, "compacted", {}, region, full_multi)
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": main["launches"], "queries": main["queries"],
            "reopened": reopened, "compacted": compacted, "sparse": sparse,
            "cached": cached, "host_aggs": host_aggs,
            "promql_cpu": promql_cpu, "range": ranges, "host_sql": host_sql}


# ---- RANGE ... ALIGN on the `cpu` table --------------------------------------

#: the full-width RANGE query's step and its slots: 1 h windows at 5 min
ALIGN_S = 300
RANGE_SLOTS = 3600 // ALIGN_S
#: the FILL query: these first hosts over the first hour, 5 s windows
FILL_HOSTS = 8


def range_sql() -> str:
    """A 12 h panel of 1 h moving averages and maxima, and 10 min minima,
    at 5 min resolution for every host."""
    return ("SELECT ts, hostname, avg(usage_user) RANGE '1h', "
            "max(usage_user) RANGE '1h', min(usage_system) RANGE '10m' "
            "FROM cpu ALIGN '5m' BY (hostname)")


def fill_sql() -> str:
    hosts = ", ".join(f"'host_{i}'" for i in range(FILL_HOSTS))
    return ("SELECT ts, hostname, last_value(usage_user) RANGE '5s' "
            "FILL PREV, avg(usage_system) RANGE '5s' FILL LINEAR FROM cpu "
            f"WHERE hostname IN ({hosts}) AND ts >= {T0_MS} "
            f"AND ts < {T0_MS + 3600 * 1000} ALIGN '5s' BY (hostname)")


def check_range_result(res, grid, what) -> int:
    """The RANGE query against float64 numpy over `grid` ([points, hosts]
    per field): one row per host and window from the 11 leading partial
    windows to the last point's, series-major in hostname order; avg to
    rtol 1e-9, max and min exactly, NULL where a 10 min window saw no
    row. Returns the windows a host."""
    pts = grid["usage_user"].shape[0]
    per = ALIGN_S // STEP_S
    lead = RANGE_SLOTS - 1
    n_win = lead + -(-pts // per)
    check(res.num_rows == HOSTS * n_win,
          f"{what}: {res.num_rows} rows, expected {HOSTS * n_win}")
    ts, names, avg, mx, mn = (np.asarray(c) for c in res.columns)
    order = check_host_blocks(names, n_win, what)
    check(np.array_equal(ts.astype(np.int64), np.tile(
        T0_MS + (np.arange(n_win) - lead) * ALIGN_S * 1000, HOSTS)),
        f"{what}: window timestamps")
    want = np.full((3, n_win, HOSTS), np.nan)
    for k in range(n_win):
        a = max((k - lead) * per, 0)
        hour = grid["usage_user"][a:(k - lead + RANGE_SLOTS) * per]
        want[0, k] = hour.mean(axis=0)
        want[1, k] = hour.max(axis=0)
        ten = grid["usage_system"][a:max((k - lead + 2) * per, 0)]
        if len(ten):
            want[2, k] = ten.min(axis=0)
    want = want[:, :, order].transpose(0, 2, 1).reshape(3, -1)
    got_avg = avg.astype(np.float64)
    check(np.allclose(got_avg, want[0], rtol=1e-9, atol=0),
          f"{what} avg: max rel err "
          f"{np.max(np.abs(got_avg - want[0]) / np.abs(want[0]))}")
    check(np.array_equal(mx.astype(np.float64), want[1]), f"{what} max")
    check(np.array_equal(mn.astype(np.float64), want[2], equal_nan=True),
          f"{what} min (NULL where the 10 min window is empty)")
    check(int(np.isnan(mn.astype(np.float64)).sum()) == HOSTS * (lead - 1),
          f"{what}: NULL min count")
    return n_win


def range_phase(qe, sk, torch, grid, state, timed) -> dict:
    """The full-width RANGE query through execute_one: two distinct
    ranges, so two K2 calls over [S·N] = [12 x 17.28 M] slot-replicated
    float64 rows into 4,096 x 256 + 1 segments, and no K1; the counts
    zeroed just before and read just after. `timed` adds five warm runs,
    a CUPTI profile and a cProfile breakdown."""
    sql = range_sql()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    zero_launches(sk)
    res, cold = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    n_win = check_range_result(res, grid, f"{state} range")
    check(k1 == 0 and k2 == 2, f"{state} range: K1 {k1}, K2 {k2} launches, "
          "expected K2 twice (one a distinct range) and no K1")
    out = {"rows": res.num_rows, "windows_a_host": n_win, "cold_ms": cold,
           "k1_launches": k1, "k2_launches": k2,
           "max_memory_allocated": torch.cuda.max_memory_allocated()
           if torch.cuda.is_available() else None}
    if timed:
        warm = [timed_query(qe, sql, torch)[1] for _ in range(5)]
        out["warm_p50_ms"] = float(np.median(warm))
        if torch.cuda.is_available():
            out["profile"] = device_breakdown(lambda: qe.execute_one(sql),
                                              torch)
        out["host"] = host_breakdown(lambda: qe.execute_one(sql))
    log(f"{state} range query: " + json.dumps(out))
    return out


def range_fill_phase(qe, sk, torch, grid) -> dict:
    """RANGE with FILL on the card: FILL_HOSTS hosts over the first hour
    at 5 s windows. Every other window is empty (10 s samples):
    last_value FILL PREV repeats the window before, avg FILL LINEAR takes
    the midpoint of its neighbours; one K2 call (one distinct range),
    `last` through segment_agg's torch code."""
    sql = fill_sql()
    zero_launches(sk)
    res, ms = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    per_host = 2 * 360 - 1  # 5 s windows from the first to the last point
    check(res.num_rows == FILL_HOSTS * per_host,
          f"range fill: {res.num_rows} rows")
    check(k1 == 0 and k2 == 1, f"range fill: K1 {k1}, K2 {k2} launches")
    ts, names, last, avg = (np.asarray(c) for c in res.columns)
    check(list(names) == [f"host_{h}" for h in range(FILL_HOSTS)
                          for _ in range(per_host)], "range fill: hostnames")
    check(np.array_equal(ts.astype(np.int64), np.tile(
        T0_MS + np.arange(per_host) * 5000, FILL_HOSTS)),
        "range fill: window timestamps")
    even = np.arange(0, per_host, 2)
    odd = np.arange(1, per_host, 2)
    for h in range(FILL_HOSTS):
        user = grid["usage_user"][:360, h]
        system = grid["usage_system"][:360, h]
        want_last = np.repeat(user, 2)[:per_host]
        want_avg = np.empty(per_host)
        want_avg[even] = system
        want_avg[odd] = np.interp(odd, even, system)
        rows = slice(h * per_host, (h + 1) * per_host)
        check(np.array_equal(last[rows].astype(np.float64), want_last),
              f"range fill: last_value FILL PREV of host_{h}")
        check(np.allclose(avg[rows].astype(np.float64), want_avg,
                          rtol=1e-12, atol=0),
              f"range fill: avg FILL LINEAR of host_{h}")
    out = {"rows": res.num_rows, "ms": ms, "k1_launches": k1,
           "k2_launches": k2}
    log("range fill query: " + json.dumps(out))
    return out


# ---- the host SQL surface on the `cpu` table --------------------------------

#: Q1's top-N hosts by their peak usage_user
TOP_N = 10
#: the routes a host SQL query's inner aggregates may take: K1 or K2
DEVICE_ROUTES = ("dense_prepared", "dense_fused")
HOURLY_SQL = ("SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS h, "
              "avg(usage_user) AS a FROM cpu GROUP BY hostname, h")


def host_sql_queries(top_hosts) -> dict:
    """The seven dashboard statements: name -> (setup SQL run once before
    it, the SQL timed (one execute_sql call), the statements whose device
    aggregates run inside it, each as it runs alone). `top_hosts` are
    the oracle's top-N names, for Q1's literal IN-list twin."""
    last_hour = T0_MS + (HOURS - 1) * 3600 * 1000
    top_sql = ("SELECT hostname, max(usage_user) AS m FROM cpu GROUP BY "
               f"hostname ORDER BY m DESC, hostname LIMIT {TOP_N}")
    drill = ("SELECT date_bin(INTERVAL '1 hour', ts) AS h, hostname, "
             "avg(usage_user) AS a FROM cpu WHERE hostname IN ({}) "
             "GROUP BY h, hostname ORDER BY h, hostname")
    by_host = ("SELECT hostname, {}({}) AS {} FROM cpu GROUP BY hostname")
    return {
        "top_hosts_drilldown": (
            None, f"WITH top AS ({top_sql}) "
            + drill.format("SELECT hostname FROM top"),
            [top_sql, drill.format(", ".join(f"'{h}'" for h in top_hosts))]),
        "hourly_delta": (
            None, "SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS h, "
            "avg(usage_user) AS a, lag(avg(usage_user)) OVER (PARTITION BY "
            "hostname ORDER BY date_bin(INTERVAL '1 hour', ts)) AS prev "
            "FROM cpu GROUP BY hostname, h ORDER BY hostname, h",
            [HOURLY_SQL]),
        "hourly_rank": (
            None, "SELECT h, hostname, a, rank() OVER (PARTITION BY h ORDER "
            f"BY a DESC) AS r FROM ({HOURLY_SQL}) t ORDER BY h, r, hostname",
            [HOURLY_SQL]),
        "moving_avg": (
            None, "SELECT hostname, ts, avg(usage_user) OVER (PARTITION BY "
            "hostname ORDER BY ts ROWS BETWEEN 5 PRECEDING AND CURRENT ROW) "
            f"AS ma FROM cpu WHERE ts >= {last_hour} ORDER BY hostname, ts",
            []),
        "user_vs_system": (
            None, f"WITH u AS ({by_host.format('avg', 'usage_user', 'a')}), "
            f"s AS ({by_host.format('max', 'usage_system', 'm')}) "
            "SELECT u.hostname, u.a, s.m FROM u JOIN s ON "
            "u.hostname = s.hostname ORDER BY u.hostname",
            [by_host.format("avg", "usage_user", "a"),
             by_host.format("max", "usage_system", "m")]),
        # cpu_1h keys on (hostname, h) without append mode: a repeated
        # INSERT overwrites its rows (last write wins)
        "rollup_insert": (
            "CREATE TABLE cpu_1h (hostname STRING, h TIMESTAMP(3) NOT NULL, "
            "a DOUBLE, TIME INDEX (h), PRIMARY KEY (hostname))",
            f"INSERT INTO cpu_1h {HOURLY_SQL}; "
            "SELECT count(*), avg(a) FROM cpu_1h",
            [HOURLY_SQL, "SELECT count(*), avg(a) FROM cpu_1h"]),
        "view_hourly": (
            f"CREATE VIEW hourly AS {HOURLY_SQL}",
            "SELECT hostname, max(a) FROM hourly GROUP BY hostname "
            "ORDER BY hostname", [HOURLY_SQL]),
    }


def check_host_sql(name, results, grid, top_hosts) -> None:
    """Every value of one host SQL query against float64 numpy over
    `grid`: max and min exactly (as the f32 kernels see them), averages
    to rtol 1e-5, counts exactly, lag equal to the previous row's
    returned avg, ranks recomputed from the returned avgs."""
    res = results[-1]
    per_hour = 3600 // STEP_S
    user = grid["usage_user"][:HOURS * per_hour]
    hourly = user.reshape(HOURS, per_hour, HOSTS).mean(axis=1)
    lex = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                     kind="stable")
    cols = [np.asarray(c) for c in res.columns]

    def close(got, want, rtol, what):
        got = np.asarray(got, dtype=np.float64)
        check(got.shape == want.shape and np.allclose(got, want, rtol=rtol,
                                                      atol=0),
              f"host sql {name} {what}: max rel err "
              f"{np.max(np.abs(got - want) / np.abs(want))}")

    if name == "top_hosts_drilldown":
        hosts = np.sort(np.asarray(top_hosts))
        idx = host_index(hosts)
        check(res.num_rows == HOURS * TOP_N, f"{name}: {res.num_rows} rows")
        hours = np.repeat(np.arange(HOURS), TOP_N)
        check(np.array_equal(cols[0].astype(np.int64),
                             T0_MS + hours * 3_600_000), f"{name} hours")
        check(list(cols[1].astype(str)) == list(hosts) * HOURS,
              f"{name} hostnames")
        close(cols[2], hourly[hours, np.tile(idx, HOURS)], 1e-5, "avg")
    elif name in ("hourly_delta", "hourly_rank"):
        check(res.num_rows == HOSTS * HOURS, f"{name}: {res.num_rows} rows")
        if name == "hourly_delta":
            host, hour, a, prev = cols
            want_host = np.repeat(lex, HOURS)
            want_hour = np.tile(np.arange(HOURS), HOSTS)
        else:
            hour, host, a, r = cols
            want_hour = np.repeat(np.arange(HOURS), HOSTS)
            want_host = None
        check(np.array_equal(hour.astype(np.int64),
                             T0_MS + want_hour * 3_600_000), f"{name} hours")
        hidx = host_index(host)
        if want_host is not None:
            check(np.array_equal(hidx, want_host), f"{name} hostnames")
        else:
            check(np.array_equal(np.sort(hidx.reshape(HOURS, HOSTS), axis=1),
                                 np.tile(np.arange(HOSTS), (HOURS, 1))),
                  f"{name}: every host in every hour")
        a = a.astype(np.float64)
        close(a, hourly[want_hour, hidx], 1e-5, "avg")
        if name == "hourly_delta":
            first = want_hour == 0
            check(all(v is None for v in prev[first]),
                  f"{name}: lag is NULL on each host's first hour")
            check(np.array_equal(prev[~first].astype(np.float64),
                                 a[np.flatnonzero(~first) - 1]),
                  f"{name}: lag equals the previous row's avg")
        else:
            blocks = a.reshape(HOURS, HOSTS)
            check(bool(np.all(np.diff(blocks, axis=1) <= 0)),
                  f"{name}: avg not descending within an hour")
            pos = np.tile(np.arange(1, HOSTS + 1), (HOURS, 1))
            new = np.concatenate([np.ones((HOURS, 1), bool),
                                  np.diff(blocks, axis=1) != 0], axis=1)
            want_r = np.maximum.accumulate(np.where(new, pos, 0), axis=1)
            check(np.array_equal(r.astype(np.int64).reshape(HOURS, HOSTS),
                                 want_r), f"{name}: ranks")
    elif name == "moving_avg":
        x = user[-per_hour:]  # [points of the last hour, hosts]
        check(res.num_rows == per_hour * HOSTS, f"{name}: {res.num_rows} rows")
        check(np.array_equal(host_index(cols[0]), np.repeat(lex, per_hour)),
              f"{name} hostnames")
        check(np.array_equal(cols[1].astype(np.int64), np.tile(
            T0_MS + (HOURS * per_hour - per_hour + np.arange(per_hour))
            * STEP_S * 1000, HOSTS)), f"{name} timestamps")
        cs = np.concatenate([np.zeros((1, HOSTS)), np.cumsum(x, axis=0)])
        p = np.arange(per_hour)
        lo = np.maximum(p - 5, 0)
        want = (cs[p + 1] - cs[lo]) / (p + 1 - lo)[:, None]
        # the window sums as cumulative-sum differences over the whole
        # relation: about 1e-8 relative error at 1.44 M rows
        close(cols[2], want[:, lex].T.reshape(-1), 1e-5, "moving avg")
    elif name == "user_vs_system":
        check(res.num_rows == HOSTS, f"{name}: {res.num_rows} rows")
        check(np.array_equal(host_index(cols[0]), lex), f"{name} hostnames")
        close(cols[1], user.mean(axis=0)[lex], 1e-5, "avg")
        system = grid["usage_system"][:HOURS * per_hour]
        check(np.array_equal(cols[2].astype(np.float64),
                             f32_exact(system.max(axis=0))[lex]),
              f"{name} max")
    elif name == "rollup_insert":
        check(results[0].affected_rows == HOSTS * HOURS,
              f"{name}: {results[0].affected_rows} rows written")
        check(int(cols[0][0]) == HOSTS * HOURS, f"{name}: count {cols[0][0]}")
        close(cols[1], np.asarray([hourly.mean()]), 1e-5, "avg")
    else:  # view_hourly
        check(res.num_rows == HOSTS, f"{name}: {res.num_rows} rows")
        check(np.array_equal(host_index(cols[0]), lex), f"{name} hostnames")
        close(cols[1], hourly.max(axis=0)[lex], 1e-5, "max of avg")


def host_sql_phase(qe, sk, torch, grid) -> dict:
    """The seven host SQL statements at full width on the `cpu` table,
    partial cache off: each cold (its first run in this process; the
    hot set already holds the table's blocks), five times warm, once
    under torch.profiler, every value against numpy. Each one's inner
    aggregates must take K1 or K2 (DEVICE_ROUTES), each the route the
    same statement takes alone, with that kernel launched; Q4's raw scan
    takes none. The counts are zeroed just before each cold run and read
    just after it. cpu_1h and the view are dropped at the end."""
    t_phase = time.perf_counter()
    user = grid["usage_user"][:HOURS * 3600 // STEP_S]
    peak = f32_exact(user.max(axis=0))
    top = sorted(range(HOSTS), key=lambda i: (-peak[i], f"host_{i}"))[:TOP_N]
    top_hosts = [f"host_{i}" for i in top]
    out: dict = {}
    total = {"segment_sum": 0, "fused_segment_agg": 0}
    with partial_cache(False):
        for name, (setup, sql, alone) in host_sql_queries(top_hosts).items():
            if setup is not None:
                qe.execute_one(setup)
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            zero_launches(sk)
            sync(torch)
            t = time.perf_counter()
            results = qe.execute_sql(sql)
            sync(torch)
            cold = (time.perf_counter() - t) * 1e3
            k1, k2 = launches(sk)
            paths = list(qe.executor.statement_paths)
            check_host_sql(name, results, grid, top_hosts)
            q = {"cold_ms": cold, "rows": results[-1].num_rows,
                 "paths": paths, "k1_launches": k1, "k2_launches": k2,
                 "peak_device_bytes": torch.cuda.max_memory_allocated()
                 if torch.cuda.is_available() else None}
            total["segment_sum"] += k1
            total["fused_segment_agg"] += k2
            warm = []
            for _ in range(5):
                sync(torch)
                t = time.perf_counter()
                qe.execute_sql(sql)
                sync(torch)
                warm.append((time.perf_counter() - t) * 1e3)
            q["warm_p50_ms"] = float(np.median(warm))
            if torch.cuda.is_available():
                prof = device_breakdown(lambda: qe.execute_sql(sql), torch)
                q["device_ms"] = prof["device_ms"]
                q["idle_share"] = prof["idle_share"]
                q["device_top"] = prof["top"]
            if name == "moving_avg":
                q["host"] = host_breakdown(lambda: qe.execute_sql(sql))
            # each inner statement alone: its route is the one it took
            # inside the query, and that route is a kernel's
            q["alone_paths"] = []
            for stmt in alone:
                qe.execute_one(stmt)
                q["alone_paths"].append(qe.executor.last_path)
            check(paths == q["alone_paths"],
                  f"host sql {name}: routes {paths}, alone "
                  f"{q['alone_paths']}")
            check(all(p in DEVICE_ROUTES for p in paths),
                  f"host sql {name}: an inner aggregate left the K1/K2 "
                  f"routes: {paths}")
            check(("dense_prepared" not in paths or k1 > 0)
                  and ("dense_fused" not in paths or k2 > 0)
                  and (k1 + k2 > 0) == bool(paths),
                  f"host sql {name}: K1 {k1}, K2 {k2} launches for routes "
                  f"{paths}")
            out[name] = q
            log(f"host sql {name}: " + json.dumps(q))
        qe.execute_one("DROP VIEW hourly")
        qe.execute_one("DROP TABLE cpu_1h")
    check(total["segment_sum"] > 0 or total["fused_segment_agg"] > 0,
          "host sql: no kernel was launched")
    log("host sql launches (cold runs): " + json.dumps(total)
        + f", phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": total, "queries": out}


# ---- the slice-3 routes: sparse, incremental, host aggregates --------------


class env_value:
    """An environment variable set in this process for a block, restored
    after it."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.saved
        return False


class partial_cache(env_value):
    """GREPTIMEDB_TPU_PARTIAL_CACHE set in this process for a block: the
    JAX package's own switch of the incremental fold (default on)."""

    def __init__(self, on: bool):
        super().__init__("GREPTIMEDB_TPU_PARTIAL_CACHE", "1" if on else "0")


def sparse_sql() -> str:
    return ("SELECT hostname, date_bin(INTERVAL '1 minute', ts) AS minute, "
            "avg(usage_user), max(usage_system), count(*) FROM cpu "
            "GROUP BY hostname, minute ORDER BY hostname, minute")


def host_order() -> np.ndarray:
    """Host indices in the order ORDER BY hostname gives them."""
    return np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                      kind="stable")


def check_host_blocks(col, per: int, what: str) -> np.ndarray:
    """`col` holds HOSTS runs of `per` equal hostnames in ORDER BY order:
    returns the run heads' host indices after checking every row."""
    names = np.asarray(col, dtype=object).reshape(HOSTS, per)
    check(bool((names == names[:, :1]).all()), f"{what}: hostname runs")
    heads = host_index(names[:, 0])
    check(np.array_equal(heads, host_order()), f"{what}: hostname order")
    return heads


def check_sparse_result(res, grid, what) -> None:
    """The sparse query against the float64 oracle over every point in
    `grid`, on arrays: keys, avg (f32 compute, rtol 1e-5), max (the f32
    cast of the f64 max, exact) and count (exact)."""
    pts = next(iter(grid.values())).shape[0]
    minutes = -(-pts // 6)
    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    check(res.num_rows == HOSTS * minutes,
          f"{what}: {res.num_rows} rows, expected {HOSTS * minutes}")
    order = check_host_blocks(cols["hostname"], minutes, what)
    check(np.array_equal(cols["minute"].astype(np.int64),
                         np.tile(T0_MS + np.arange(minutes) * 60_000,
                                 HOSTS)), f"{what}: minute keys")

    def per_minute(f, how):
        x = grid[f]
        pad = minutes * 6 - pts
        if pad:  # the last minute holds fewer points
            x = np.concatenate([x, np.full((pad, HOSTS), np.nan)])
        return how(x.reshape(minutes, 6, HOSTS), axis=1)[:, order].T \
            .reshape(-1)

    want_avg = per_minute("usage_user", np.nanmean)
    got = cols["avg(usage_user)"].astype(np.float64)
    check(np.allclose(got, want_avg, rtol=1e-5, atol=0),
          f"{what}: avg max rel err "
          f"{np.max(np.abs(got - want_avg) / np.abs(want_avg))}")
    check(np.array_equal(cols["max(usage_system)"].astype(np.float64),
                         f32_exact(per_minute("usage_system", np.nanmax))),
          f"{what}: max")
    want_n = per_minute("usage_user", lambda a, axis: (~np.isnan(a)).sum(
        axis=axis))
    check(np.array_equal(cols["count(*)"].astype(np.int64), want_n),
          f"{what}: count")


def launches(sk) -> tuple:
    return sk.segment_sum.launches, sk.fused_segment_agg.launches


def zero_launches(sk) -> None:
    sk.segment_sum.launches = 0
    sk.fused_segment_agg.launches = 0


def timed_query(qe, sql, torch):
    sync(torch)
    t = time.perf_counter()
    res = qe.execute_one(sql)
    sync(torch)
    return res, (time.perf_counter() - t) * 1e3


def sparse_phase(qe, sk, torch, grid, region) -> dict:
    """Check 1 (cache off): the hostname x minute query over the whole
    scan takes `sparse_fused`, one K2 call over U + 1 segments, no K1.
    Check 2 (cache on): the same query folds per-part sparse partials
    (`incremental_sparse`): every part misses cold and hits warm, and the
    warm repeat launches K2 only for the memtable tail."""
    from greptimedb_tpu_torch.ops.blocks import DEFAULT_BLOCK_ROWS

    sql = sparse_sql()
    out = {}
    with partial_cache(False):
        zero_launches(sk)
        res, cold = timed_query(qe, sql, torch)
        k1, k2 = launches(sk)
        path = qe.executor.last_path
        st = qe.executor.last_sparse_stats
        check(path == "sparse_fused", f"sparse: last_path {path}")
        check(k2 == 1 and k1 == 0, f"sparse: K1 {k1}, K2 {k2} launches, "
              "expected K2 once and no K1")
        check_sparse_result(res, grid, "sparse")
        check(st["groups"] == res.num_rows, f"sparse: observed {st}")
        warm = [timed_query(qe, sql, torch)[1] for _ in range(3)]
        prof = device_breakdown(lambda: qe.execute_one(sql), torch) \
            if torch.cuda.is_available() else None
        out["sparse"] = {"last_path": path, "k1_launches": k1,
                         "k2_launches": k2, "cold_ms": cold,
                         "warm_p50_ms": float(np.median(warm)), **st,
                         "profile": prof,
                         "host": host_breakdown(lambda: qe.execute_one(sql))}
        log("sparse query: " + json.dumps(out["sparse"]))
        want = res
    with partial_cache(True):
        runs = []
        for label in ("cold", "warm"):
            zero_launches(sk)
            res, ms = timed_query(qe, sql, torch)
            k1, k2 = launches(sk)
            st = dict(qe.executor.last_partial_stats or {})
            runs.append({"run": label, "last_path": qe.executor.last_path,
                         "ms": ms, "k1_launches": k1, "k2_launches": k2,
                         **st})
            check(runs[-1]["last_path"] == "incremental_sparse",
                  f"incremental sparse {label}: {runs[-1]['last_path']}")
            check_sparse_result(res, grid, f"incremental sparse {label}")
            if label == "cold":
                cold_res = res
        cold, warm = runs
        mem_rows = region.memtable.num_rows
        mem_blocks = -(-mem_rows // DEFAULT_BLOCK_ROWS)
        check(cold["parts"] == len(region.files) and cold["part_hits"] == 0
              and cold["part_misses"] == cold["parts"],
              f"incremental sparse cold: {cold}")
        check(warm["part_hits"] == warm["parts"] and warm["part_misses"] == 0
              and warm["delta_rows"] == warm["memtable_rows"] == mem_rows,
              f"incremental sparse warm: {warm}")
        check(warm["k2_launches"] == mem_blocks and warm["k1_launches"] == 0
              and cold["k2_launches"] == cold["parts"] + mem_blocks,
              f"incremental sparse launches: cold {cold}, warm {warm}")
        # the warm serve reuses the cached partials: equal to the cold one
        for a, b in zip(cold_res.columns, res.columns):
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  "incremental sparse: warm differs from cold")
        # the fold and the whole-scan route give the same groups
        for name in ("hostname", "minute", "count(*)", "max(usage_system)"):
            i = res.names.index(name)
            check(np.array_equal(np.asarray(res.columns[i]),
                                 np.asarray(want.columns[i])),
                  f"incremental sparse {name} differs from sparse_fused")
        warm_ms = [timed_query(qe, sql, torch)[1] for _ in range(2)]
        warm["warm_p50_ms"] = float(np.median([warm["ms"]] + warm_ms))
        warm["host"] = host_breakdown(lambda: qe.execute_one(sql))
        out["incremental_sparse"] = runs
        log("incremental sparse: " + json.dumps(runs))
    return out


def cached_expectations(state, full_multi_block) -> dict:
    """Route of each of the six queries with the partial cache on.
    Compacted: one file; a query whose scan keeps the whole file spans
    several device blocks past 8M rows, and the fold takes the classic
    route ("multi-block part"), as in the JAX package."""
    want = {name: ("bucket_topk+incremental" if name ==
                   "groupby_orderby_limit" else
                   None if name == "high_cpu_all" else "incremental")
            for name in tsbs_queries()}
    if state == "compacted" and full_multi_block:
        want["double_groupby_all"] = tsbs_queries()["double_groupby_all"][1]
    # the boundary gather reduces the lastpoint scan before the fold is
    # tried, in every state (the JAX package's order)
    want["lastpoint"] = tsbs_queries()["lastpoint"][1]
    return want


def run_cached_queries(qe, sk, torch, grid, state, off, region,
                       full_multi_block) -> dict:
    """The six queries with the partial cache on: a cold run and three
    warm repeats each, rows against the oracle, route and part stats
    checked. `state`: "ingest" (a cold fill; warm folds only the tail),
    "write" (after a small write: still all hits), "reopened" (the
    region's entries died with its close: misses again), "compacted".
    `off` has the same state's cache-off results (their warm p50 sits
    beside this one's)."""
    from greptimedb_tpu_torch.ops.blocks import DEFAULT_BLOCK_ROWS
    from greptimedb_tpu_torch.query import partial_cache as pc

    want = cached_expectations(state, full_multi_block)
    cache = pc.global_cache()
    out = {}
    with partial_cache(True):
        zero_launches(sk)
        for name, (sql, _, want_rows) in tsbs_queries().items():
            k0 = launches(sk)
            fb0 = cache.events["fallback"]
            res, cold = timed_query(qe, sql, torch)
            k1 = launches(sk)
            path = qe.executor.last_path
            st = qe.executor.last_partial_stats
            check(path == want[name], f"cache on, {state} {name}: last_path "
                  f"{path}, expected {want[name]}")
            check(want_rows is None or res.num_rows == want_rows,
                  f"cache on, {state} {name}: {res.num_rows} rows")
            check_result(name, res, grid)
            warm, wst = [], None
            for _ in range(3):
                w0 = launches(sk)
                wres, ms = timed_query(qe, sql, torch)
                warm.append(ms)
                w1 = launches(sk)
                wst = qe.executor.last_partial_stats
            check_result(name, wres, grid)
            if state == "ingest" and name == "double_groupby_all":
                log("cache on, host breakdown of a warm double_groupby_all: "
                    + json.dumps(host_breakdown(lambda: qe.execute_one(sql))))
            rec = {"last_path": path, "cold_ms": cold,
                   "warm_p50_ms": float(np.median(warm)),
                   "cache_off_warm_p50_ms": off.get(name, {}).get(
                       "warm_p50_ms"),
                   "cold_launches": [k1[0] - k0[0], k1[1] - k0[1]],
                   "warm_launches": [w1[0] - w0[0], w1[1] - w0[1]],
                   "cold_stats": st, "warm_stats": wst}
            out[name] = rec
            log(f"cache on, {state} query {name}: " + json.dumps(rec))
            if path is None:
                continue
            if "boundary+" in path:
                # a reduced scan never asks the cache
                check(st is None and cache.events["fallback"] == fb0,
                      f"cache on, {state} {name}: the fold was tried")
                continue
            if "incremental" not in path:
                check(st is None and cache.events["fallback"] > fb0,
                      f"cache on, {state} {name}: no typed fallback")
                continue
            mem_blocks = -(-wst["memtable_rows"] // DEFAULT_BLOCK_ROWS)
            check(wst["part_misses"] == 0
                  and wst["delta_rows"] == wst["memtable_rows"]
                  and sum(rec["warm_launches"]) == mem_blocks,
                  f"cache on, {state} {name}: the warm repeat folded more "
                  f"than the memtable tail: {rec}")
            if state == "write":
                check(st["part_misses"] == 0,
                      f"cache on, write {name}: a write missed parts: {st}")
            elif name != "groupby_orderby_limit":
                # bucket top-k's narrowed first scan is new to every state
                check(st["part_hits"] == 0 and st["part_misses"] > 0,
                      f"cache on, {state} {name}: cold run hit: {st}")
    total = launches(sk)
    log(f"cache on, {state} launches: " + json.dumps(
        {"segment_sum": total[0], "fused_segment_agg": total[1]}))
    if state in ("ingest", "reopened"):
        check(total[0] > 0 and total[1] > 0,
              f"cache on, {state}: a kernel was not launched: {total}")
    return {"launches": {"segment_sum": total[0],
                         "fused_segment_agg": total[1]}, "queries": out}


def host_agg_oracle(x: np.ndarray, q: float, first: np.ndarray) -> np.ndarray:
    """host_agg.py's percentile rule over the k groups of x [n, k]: linear
    interpolation of the sorted values at pos = first + q/100 * (n - 1),
    as lo * (1 - frac) + hi * frac. `first` is each group's offset in the
    module's sorted array (groups in global-id order, n rows each): the
    rounding of pos, and so frac, depends on it."""
    s = np.sort(x, axis=0)
    pos = first + (q / 100.0) * (s.shape[0] - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    frac = pos - lo
    k = np.arange(s.shape[1])
    return s[lo - first, k] * (1 - frac) + s[hi - first, k] * frac


def host_agg_phase(qe, sk, torch, grid) -> dict:
    """Check 5: median and percentile on the host beside an avg on K2,
    over the last hour by hostname; then a sparse query that carries a
    median (the host pass maps its rows onto the compact slots). Order
    statistics exact under host_agg.py's rule; avg rtol 1e-5."""
    from greptimedb_tpu_torch.query import partial_cache as pc

    per_hour = 3600 // STEP_S
    pts = HOURS * per_hour
    out = {}
    # host index -> the rank of its tag code in the region's dictionary
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    codes = host_index(np.asarray(
        qe.region_engine.region(rid).registry.dict_array("hostname")))
    code_rank = np.empty(HOSTS, dtype=np.int64)
    code_rank[codes] = np.arange(HOSTS)
    lo = T0_MS + (HOURS - 1) * 3600 * 1000
    sql = ("SELECT hostname, avg(usage_user), median(usage_user), "
           f"percentile(usage_system, 95) FROM cpu WHERE ts >= {lo} "
           f"AND ts < {T0_MS + pts * STEP_S * 1000} "
           "GROUP BY hostname ORDER BY hostname")
    fb0 = pc.global_cache().events["fallback"]
    zero_launches(sk)
    res, ms = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    path = qe.executor.last_path
    check(path == "dense_fused" and k2 >= 1 and k1 == 0,
          f"host aggs: {path}, K1 {k1}, K2 {k2}")
    check(pc.global_cache().events["fallback"] == fb0 + 1,
          "host aggs: the fold did not fall back (a typed decision)")
    host, avg, med, p95 = (np.asarray(c) for c in res.columns)
    order = host_order()
    check(np.array_equal(host_index(host), order),
          "host aggs: hostname keys")
    win = {f: grid[f][pts - per_hour:pts][:, order]
           for f in ("usage_user", "usage_system")}
    # the groups sort by tag code: host_<i>'s run starts at its code's
    # rank (every code is present), per_hour rows a run
    first = code_rank[order] * per_hour
    check(np.array_equal(med.astype(np.float64),
                         host_agg_oracle(win["usage_user"], 50.0, first)),
          "host aggs: median")
    check(np.array_equal(p95.astype(np.float64),
                         host_agg_oracle(win["usage_system"], 95.0, first)),
          "host aggs: p95")
    check(np.allclose(avg.astype(np.float64),
                      win["usage_user"].mean(axis=0), rtol=1e-5, atol=0),
          "host aggs: avg")
    out["by_host"] = {"last_path": path, "ms": ms, "k1_launches": k1,
                      "k2_launches": k2, "rows": res.num_rows}
    # a sparse key space (270 minutes x 4,001 > the 1M dense budget)
    minutes = 270
    lo = T0_MS + (pts * STEP_S * 1000) - minutes * 60_000
    sql = ("SELECT hostname, date_bin(INTERVAL '1 minute', ts) AS minute, "
           "median(usage_user), avg(usage_user) FROM cpu "
           f"WHERE ts >= {lo} AND ts < {T0_MS + pts * STEP_S * 1000} "
           "GROUP BY hostname, minute ORDER BY hostname, minute")
    zero_launches(sk)
    res, ms = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    path = qe.executor.last_path
    check(path == "sparse_fused" and k2 == 1 and k1 == 0,
          f"sparse host aggs: {path}, K1 {k1}, K2 {k2}")
    host, _, med, avg = (np.asarray(c) for c in res.columns)
    check(res.num_rows == HOSTS * minutes, "sparse host aggs: rows")
    order = check_host_blocks(host, minutes, "sparse host aggs")
    x = grid["usage_user"][pts - minutes * 6:pts].reshape(minutes, 6, HOSTS)
    x = x[:, :, order].transpose(1, 2, 0).reshape(6, -1)  # [6, host*min]
    first = (np.repeat(code_rank[order], minutes) * minutes
             + np.tile(np.arange(minutes), HOSTS)) * 6
    check(np.array_equal(med.astype(np.float64),
                         host_agg_oracle(x, 50.0, first)),
          "sparse host aggs: median")
    check(np.allclose(avg.astype(np.float64), x.mean(axis=0), rtol=1e-5,
                      atol=0), "sparse host aggs: avg")
    out["sparse"] = {"last_path": path, "ms": ms, "k1_launches": k1,
                     "k2_launches": k2, "rows": res.num_rows,
                     **qe.executor.last_sparse_stats}
    log("host aggregates: " + json.dumps(out))
    return out


# ---- high cardinality: BASELINE config #5 ----------------------------------

#: bench.py's config #5 (bench.py:562-620): 1,000,000 tags x 10 points
HC_COMBOS = 1_000_000
HC_POINTS = 10
#: explicit flushes every this many rows (bench.py flushes every 30M rows
#: and at the end): each SST part stays inside one 8M-row device block,
#: the incremental fold's one-block-per-part gate
HC_FLUSH_ROWS = 4_000_000


def hc_phase(sk, torch) -> dict:
    """Check 4: the `hc` table (tag STRING, v DOUBLE, ts; append mode)
    built through RegionEngine.put with the WAL fsynced, in slices of up
    to 1 << 21 rows, flushed; then `SELECT tag, sum(v) FROM hc GROUP BY
    tag` with the cache off (dense_prepared: K1 at G = 1,000,002) and on
    (incremental_sparse: K2 a part), both held against numpy."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    root = tempfile.mkdtemp(prefix="chip_smoke_hc_")
    out = {}
    try:
        engine, qe = open_engine(root)
        qe.execute_one("CREATE TABLE hc (tag STRING, v DOUBLE, "
                       "ts TIMESTAMP(3) NOT NULL, TIME INDEX (ts), "
                       "PRIMARY KEY (tag)) WITH (append_mode = 'true')")
        info = qe.catalog.table("public", "hc")
        rid = info.region_ids[0]
        rng = np.random.default_rng(13)
        names = np.asarray([f"t{i:07d}" for i in range(HC_COMBOS)],
                           dtype=object)
        per_slice = max(1, (1 << 21) // HC_POINTS)
        vs = []
        rows = flushed = 0
        t = time.perf_counter()
        for c0 in range(0, HC_COMBOS, per_slice):
            c1 = min(c0 + per_slice, HC_COMBOS)
            n = (c1 - c0) * HC_POINTS
            v = rng.uniform(0, 1, n)
            vs.append(v)
            engine.put(rid, RecordBatch(info.schema, {
                "tag": DictVector(np.repeat(np.arange(c1 - c0,
                                                      dtype=np.int32),
                                            HC_POINTS), names[c0:c1]),
                "ts": np.tile(T0_MS + np.arange(HC_POINTS, dtype=np.int64)
                              * 1000, c1 - c0),
                "v": v}))
            rows += n
            if rows - flushed >= HC_FLUSH_ROWS:
                engine.flush(rid)
                flushed = rows
        engine.flush(rid)
        ingest_s = time.perf_counter() - t
        region = engine.region(rid)
        out["ingest"] = {"rows": rows, "seconds": ingest_s,
                         "rows_per_s": rows / ingest_s,
                         "sst_files": len(region.files),
                         "wal_fsyncs": engine.wal.sync_count}
        log("hc ingest: " + json.dumps(out["ingest"]))
        want = np.concatenate(vs).reshape(HC_COMBOS, HC_POINTS).sum(axis=1)
        del vs
        sql = "SELECT tag, sum(v) FROM hc GROUP BY tag"
        for on, want_path in ((False, "dense_prepared"),
                              (True, "incremental_sparse")):
            with partial_cache(on):
                runs = []
                for _ in range(3):
                    zero_launches(sk)
                    res, ms = timed_query(qe, sql, torch)
                    runs.append({"ms": ms, "launches": list(launches(sk)),
                                 "stats": qe.executor.last_partial_stats})
                path = qe.executor.last_path
                check(path == want_path, f"hc cache {on}: {path}")
                check(res.num_rows == HC_COMBOS, f"hc: {res.num_rows} rows")
                cols = dict(zip(res.names, res.columns))
                tags = np.asarray(cols["tag"]).astype(str)
                idx = np.char.lstrip(tags, "t").astype(np.int64)
                check(np.array_equal(np.sort(idx), np.arange(HC_COMBOS)),
                      "hc: tag keys")
                got = np.asarray(cols["sum(v)"], dtype=np.float64)
                check(np.allclose(got, want[idx], rtol=1e-5, atol=0),
                      f"hc cache {on}: sum max rel err "
                      f"{np.max(np.abs(got - want[idx]) / want[idx])}")
                cold, warm = runs[0], runs[1:]
                k1, k2 = cold["launches"]
                if on:
                    check(k1 == 0 and k2 == len(region.files),
                          f"hc cache on: cold launches {cold}")
                    check(all(w["launches"] == [0, 0]
                              and w["stats"]["part_hits"] == len(region.files)
                              for w in warm), f"hc cache on: warm {warm}")
                else:
                    check(k1 >= 1 and k2 == 0, f"hc cache off: {cold}")
                out["cache_on" if on else "cache_off"] = {
                    "last_path": path, "cold_ms": cold["ms"],
                    "warm_p50_ms": float(np.median([w["ms"] for w in warm])),
                    "cold_launches": cold["launches"],
                    "warm_launches": warm[-1]["launches"],
                    "groups": res.num_rows, "cold_stats": cold["stats"]}
                log(f"hc query, cache {'on' if on else 'off'}: "
                    + json.dumps(out["cache_on" if on else "cache_off"]))
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def dedup_phase(torch) -> None:
    """A non-append table with duplicate keys and tombstones, flushed
    between write batches so tombstones span files, then compacted; held
    against a Python last-write-wins oracle before and after."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    root = tempfile.mkdtemp(prefix="chip_smoke_dedup_")
    try:
        engine, qe = open_engine(root)
        qe.execute_one("CREATE TABLE t (host STRING, ts TIMESTAMP(3) NOT "
                       "NULL, v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))")
        info = qe.catalog.table("public", "t")
        rid = info.region_ids[0]
        rng = np.random.default_rng(SEED)
        live: dict = {}
        for i in range(40):
            n = 64
            hosts = rng.integers(0, 12, n)
            ts = rng.integers(0, 30, n) * 1000
            v = np.round(rng.uniform(0, 100, n), 1)
            cols = {"host": DictVector.encode([f"h{h}" for h in hosts]),
                    "ts": ts.astype(np.int64), "v": v}
            if rng.random() < 0.3:
                engine.delete(rid, RecordBatch(info.schema, cols))
                for h, t in zip(hosts, ts):
                    live.pop((f"h{h}", int(t)), None)
            else:
                engine.put(rid, RecordBatch(info.schema, cols))
                for h, t, x in zip(hosts, ts, v):
                    live[(f"h{h}", int(t))] = float(x)
            if i % 10 == 9:
                engine.flush(rid)
        per: dict = {}
        for (h, _), x in live.items():
            c, m = per.get(h, (0, -np.inf))
            per[h] = (c + 1, max(m, x))
        want_raw = sorted((h, t, x) for (h, t), x in live.items())
        want_agg = sorted((h, c, float(np.float32(m)))
                          for h, (c, m) in per.items())
        files = len(engine.region(rid).files)
        for state in ("flushed", "compacted"):
            if state == "compacted":
                qe.execute_one("ADMIN compact_table('t')")
            res = qe.execute_one("SELECT host, ts, v FROM t ORDER BY host, ts")
            got = [(str(h), int(t), float(x)) for h, t, x in res.rows()]
            check(got == want_raw, f"dedup {state} raw scan: {len(got)} "
                  f"rows, {len(want_raw)} expected")
            res = qe.execute_one("SELECT host, count(v), max(v) FROM t "
                                 "GROUP BY host ORDER BY host")
            got = [(str(h), int(c), float(m)) for h, c, m in res.rows()]
            check(got == want_agg, f"dedup {state} aggregate")
        log(f"dedup: {len(live)} live keys after tombstones over {files} "
            f"SSTs and a memtable, then one compacted file; last_path "
            f"{qe.executor.last_path}")
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- PromQL: bench.py's prom_cpu and the `cpu` table ---------------------------


def window_index(grid_s, times, range_s):
    """Per eval time t, (i0, i1): the window (t - range_s, t] is
    grid_s[i0:i1] of the sorted sample times."""
    i0 = np.searchsorted(grid_s, times - range_s, side="right")
    i1 = np.searchsorted(grid_s, times, side="right")
    return i0, i1


def rate_oracle(mat, grid_s, times, range_s) -> np.ndarray:
    """sum(rate(m[range])) per eval time over `mat` [S, P] (every series
    on the grid `grid_s`): bench.py's promql_anchor.eval_rate
    (bench.py:518-541), with the counter zero-crossing limit on the start
    extrapolation that Prometheus applies (extrapolate_rate.rs) and the
    anchor leaves out. NaN where a window holds fewer than 2 samples."""
    out = np.full(len(times), np.nan)
    i0s, i1s = window_index(grid_s, times, range_s)
    for k, (t, i0, i1) in enumerate(zip(times, i0s, i1s - 1)):
        if i1 <= i0:
            continue
        first, last = mat[:, i0], mat[:, i1]
        tf, tl = grid_s[i0], grid_s[i1]
        sampled = tl - tf
        slope = (last - first) / sampled
        avg_gap = sampled / (i1 - i0)
        zero = np.where(slope > 0, first / np.where(slope > 0, slope, 1.0),
                        np.inf)
        head = np.minimum(tf - (t - range_s), zero)
        tail = t - tl
        duration = sampled \
            + np.where(head < 1.1 * avg_gap, head, avg_gap / 2) \
            + (tail if tail < 1.1 * avg_gap else avg_gap / 2)
        out[k] = float(np.sum(slope * duration)) / range_s
    return out


def window_means(mat, grid_s, times, range_s) -> np.ndarray:
    """[S, T] per-series window means (NaN where a window is empty)."""
    out = np.full((mat.shape[0], len(times)), np.nan)
    for k, (i0, i1) in enumerate(zip(*window_index(grid_s, times,
                                                   range_s))):
        if i1 > i0:
            out[:, k] = mat[:, i0:i1].sum(axis=1) / (i1 - i0)
    return out


def window_maxes(mat, grid_s, times, range_s) -> np.ndarray:
    out = np.full((mat.shape[0], len(times)), np.nan)
    for k, (i0, i1) in enumerate(zip(*window_index(grid_s, times,
                                                   range_s))):
        if i1 > i0:
            out[:, k] = mat[:, i0:i1].max(axis=1)
    return out


def check_close(got, want, rtol, what) -> float:
    """Equal NaN positions and values within rtol; the max relative
    error."""
    got = np.asarray(got, dtype=np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape}, expected "
          f"{want.shape}")
    nan = np.isnan(want)
    check(np.array_equal(np.isnan(got), nan), f"{what}: NaN positions")
    err = np.abs(got[~nan] - want[~nan]) / np.maximum(np.abs(want[~nan]),
                                                      1e-300)
    worst = float(err.max()) if err.size else 0.0
    check(worst <= rtol, f"{what}: max rel err {worst} > {rtol}")
    return worst


def run_promql(name, fn, sk, torch, want_paths, paths_of) -> tuple:
    """One PromQL query: cold, then 5 warm runs, K2's launches in each
    (zeroed just before, read just after), the window path taken, a
    CUPTI profile and a cProfile breakdown of one more warm run.
    Returns the record and the cold result."""
    sk.fused_segment_agg.launches = 0
    sync(torch)
    t = time.perf_counter()
    res = fn()
    sync(torch)
    cold_ms = (time.perf_counter() - t) * 1e3
    k2_cold = sk.fused_segment_agg.launches
    paths = paths_of()
    warm, k2_warm = [], []
    for _ in range(5):
        sk.fused_segment_agg.launches = 0
        sync(torch)
        t = time.perf_counter()
        fn()
        sync(torch)
        warm.append((time.perf_counter() - t) * 1e3)
        k2_warm.append(sk.fused_segment_agg.launches)
    rec = {"cold_ms": cold_ms, "warm_p50_ms": float(np.median(warm)),
           "window_paths": paths, "k2_launches_cold": k2_cold,
           "k2_launches_warm": k2_warm}
    check(paths == want_paths, f"promql {name}: window paths {paths}, "
          f"expected {want_paths}")
    check(k2_cold == 1 and k2_warm == [1] * 5,
          f"promql {name}: K2 launches cold {k2_cold}, warm {k2_warm}; "
          "expected one a run")
    if torch.cuda.is_available():
        rec["profile"] = device_breakdown(fn, torch)
    rec["host"] = host_breakdown(fn)
    log(f"promql {name}: " + json.dumps(rec))
    return rec, res


def promql_cpu_phase(qe, sk, torch, grid) -> dict:
    """PromQL over the `cpu` table as ingested (4,000 hosts x 12 h at
    10 s, SSTs and a memtable), through PromqlEngine.eval_matrix at a
    5 min step with 1 h windows: max_over_time buckets 17.28 M rows into
    4,000 x 157 + 1 segments through K2 (the scatter flavour of
    window_stats); stddev(avg_over_time) takes the sums grid path and one
    K2 call with sumsq over the hosts; topk(5, max_over_time) keeps the
    five largest window maxes. Each held against numpy over `grid`."""
    from greptimedb_tpu_torch.promql.engine import PromqlEngine

    prom = PromqlEngine(qe)
    t0 = T0_MS // 1000
    t_end = t0 + HOURS * 3600
    times = t0 + np.arange(CPU_STEPS) * float(CPU_EVAL_STEP_S)
    user = grid["usage_user"][:POINTS].T  # [hosts, points]
    grid_s = t0 + np.arange(POINTS) * float(STEP_S)
    maxes = window_maxes(user, grid_s, times, CPU_RANGE_S)
    means = window_means(user, grid_s, times, CPU_RANGE_S)
    sel = f'cpu{{__field__="usage_user"}}[{CPU_RANGE_S // 3600}h]'
    queries = {
        "max_over_time": (f"max_over_time({sel})", ["window_stats"]),
        "stddev_avg_over_time": (f"stddev(avg_over_time({sel}))",
                                 ["sums"]),
        "topk_max_over_time": (f"topk(5, max_over_time({sel}))",
                               ["window_stats"]),
    }
    out = {}
    for name, (q, want_paths) in queries.items():
        rec, (got_times, m) = run_promql(
            name, lambda q=q: prom.eval_matrix(q, t0, t_end,
                                               float(CPU_EVAL_STEP_S)),
            sk, torch, want_paths, lambda: qe.executor.last_promql_paths)
        check(np.array_equal(got_times, times), f"promql {name}: times")
        vals = m.values.cpu().numpy()
        if name == "stddev_avg_over_time":
            check(m.labels == [{}], f"promql {name}: labels {m.labels[:3]}")
            rec["max_rel_err"] = check_close(
                vals[0], means.std(axis=0), 1e-9, f"promql {name}")
        else:
            hosts = host_index(np.asarray([lab["hostname"]
                                           for lab in m.labels]))
            check(np.array_equal(np.sort(hosts), np.arange(HOSTS)),
                  f"promql {name}: hostname labels")
            want = maxes[hosts]
            if name == "topk_max_over_time":
                thresh = -np.sort(-want, axis=0)[4]
                want = np.where(want >= thresh[None, :], want, np.nan)
                check(int((~np.isnan(vals)).sum()) >= 5 * CPU_STEPS,
                      f"promql {name}: fewer than 5 series a step")
            check(np.array_equal(np.isnan(vals), np.isnan(want))
                  and np.array_equal(vals[~np.isnan(vals)],
                                     want[~np.isnan(want)]),
                  f"promql {name}: window maxes differ from numpy")
        out[name] = rec
    return out


def prom_ingest(root):
    """bench.py's bench_promql ingest (bench.py:393-426) through
    RegionEngine.put with the WAL fsynced: puts of 209 points x 10,000
    series, a flush every 3 puts and one at the end. Returns the engines
    and the values as [series, points]."""
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    engine, qe = open_engine(root)
    qe.execute_one(
        "CREATE TABLE prom_cpu (host STRING, val DOUBLE, "
        "ts TIMESTAMP(3) NOT NULL, TIME INDEX (ts), PRIMARY KEY (host)) "
        "WITH (append_mode = 'true')")
    info = qe.catalog.table("public", "prom_cpu")
    rid = info.region_ids[0]
    rng = np.random.default_rng(PROM_SEED)
    points = PROM_HOURS * 3600 // PROM_STEP_S
    names = np.asarray([f"s{i}" for i in range(PROM_SERIES)], dtype=object)
    slice_points = max(1, (1 << 21) // PROM_SERIES)
    flush_every = max(1, points // (slice_points * 8))
    mat = np.empty((points, PROM_SERIES))
    rows = puts = 0
    t = time.perf_counter()
    for i, p0 in enumerate(range(0, points, slice_points)):
        p1 = min(p0 + slice_points, points)
        npts = p1 - p0
        n = npts * PROM_SERIES
        codes = np.tile(np.arange(PROM_SERIES, dtype=np.int32), npts)
        ts = np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64)
                       * PROM_STEP_S * 1000, PROM_SERIES)
        base = np.repeat(np.arange(p0, p1, dtype=np.float64) * 50.0,
                         PROM_SERIES)
        vals = base + rng.uniform(0, 50.0, n)
        mat[p0:p1] = vals.reshape(npts, PROM_SERIES)
        engine.put(rid, RecordBatch(info.schema, {
            "host": DictVector(codes, names), "ts": ts, "val": vals}))
        rows += n
        puts += 1
        if (i + 1) % flush_every == 0:
            engine.flush(rid)
    engine.flush(rid)
    ingest_s = time.perf_counter() - t
    region = engine.region(rid)
    log("prom_cpu ingest: " + json.dumps({
        "rows": rows, "seconds": ingest_s, "rows_per_s": rows / ingest_s,
        "puts": puts, "wal_fsyncs": engine.wal.sync_count,
        "sst_files": len(region.files), "sst_bytes": region.sst_bytes}))
    check(rows == PROM_SERIES * points, "prom_cpu ingested rows")
    return engine, qe, mat.T


def promql_phase(sk, torch) -> dict:
    """bench.py's config #3 at its full size: prom_cpu ingested to disk,
    then its three TQL EVAL queries through QueryEngine.execute_one on the
    card, each held against numpy on the generated matrix at rtol 1e-9:
    sum(rate(prom_cpu[360s])) over the day at a 360 s step (the edges
    path), the trailing 10 min sum(rate(prom_cpu[2m])) at 60 s, and
    avg(avg_over_time(prom_cpu[360s])) over the day (the sums path). Each
    query's label aggregation is one K2 call."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_prom_")
    out = {}
    try:
        engine, qe, mat = prom_ingest(root)
        t0 = T0_MS // 1000
        t_end = t0 + PROM_HOURS * 3600
        step = PROM_EVAL_STEP_S
        rng_s = -(-max(120, step) // step) * step  # bench.py's window
        grid_s = t0 + np.arange(mat.shape[1]) * float(PROM_STEP_S)
        queries = {
            "rate_day": (t0, t_end, step,
                         f"sum(rate(prom_cpu[{rng_s}s]))", ["edges"]),
            "rate_tail": (t_end - 600, t_end, 60, "sum(rate(prom_cpu[2m]))",
                          ["edges"]),
            "avg_day": (t0, t_end, step,
                        f"avg(avg_over_time(prom_cpu[{rng_s}s]))",
                        ["sums"]),
        }
        for name, (a, b, st, q, want_paths) in queries.items():
            tql = f"TQL EVAL ({a}, {b}, '{st}s') {q}"
            rec, res = run_promql(
                name, lambda tql=tql: qe.execute_one(tql), sk, torch,
                want_paths, lambda: qe.executor.last_promql_paths)
            times = a + np.arange((b - a) // st + 1) * float(st)
            if name == "avg_day":
                want = window_means(mat, grid_s, times, rng_s).mean(axis=0)
            else:
                win = rng_s if name == "rate_day" else 120
                want = rate_oracle(mat, grid_s, times, win)
            cols = dict(zip(res.names, res.columns))
            keep = ~np.isnan(want)
            check(np.array_equal(np.asarray(cols["ts"], dtype=np.int64),
                                 (times[keep] * 1000).astype(np.int64)),
                  f"promql {name}: eval steps")
            rec["steps"] = int(keep.sum())
            rec["max_rel_err"] = check_close(cols["value"], want[keep],
                                             1e-9, f"promql {name}")
            log(f"promql {name} check: {rec['steps']} steps, max rel err "
                f"{rec['max_rel_err']}")
            out[name] = rec
        if torch.cuda.is_available():
            log("promql max_memory_allocated: "
                f"{torch.cuda.max_memory_allocated()}")
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 4: streaming beyond device memory -----------------------------------


def stream_sql() -> str:
    avg_list = ", ".join(f"avg({f})" for f in FIELDS)
    return ("SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
            f"{avg_list} FROM cpu_big GROUP BY hour, hostname")


def stream_rows_for(root) -> tuple:
    """The row count the disk at `root` holds: STREAM_ROWS, or fewer
    (whole puts) when its SSTs, a WAL of STREAM_FLUSH_EVERY puts and 2 GB
    of margin do not fit. Returns (rows, the cut or None)."""
    import shutil

    free = shutil.disk_usage(root).free
    put_rows = STREAM_PUT_POINTS * STREAM_HOSTS
    wal = 2 * STREAM_FLUSH_EVERY * put_rows * STREAM_ROW_BYTES
    fit = (free - wal - (2 << 30)) // STREAM_ROW_BYTES
    if fit >= STREAM_ROWS:
        return STREAM_ROWS, None
    rows = max(fit // put_rows, 1) * put_rows
    return rows, (f"disk: {free} bytes free at {root} hold {rows} of "
                  f"{STREAM_ROWS} rows")


def stream_ingest(root, rows_target):
    """bench.py's cpu_big ingest through RegionEngine.put on a disk-backed
    engine, the WAL fsynced, a flush every STREAM_FLUSH_EVERY puts and one
    at the end (the memtable never reaches the auto-flush). The oracle
    accumulates float64 sums and counts per (hour, host) with np.bincount
    over each put, so it never holds the rows. Returns (engine, qe, rows,
    sums [hours * hosts, F], counts, the cut or None)."""
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    engine = RegionEngine(EngineConfig(
        data_dir=os.path.join(root, "data"), wal_sync=True,
        flush_threshold_bytes=1 << 40), device=DEVICE)
    qe = QueryEngine(Catalog(FileKv(os.path.join(root, "catalog.json"))),
                     engine, device=DEVICE)
    field_defs = ", ".join(f"{f} DOUBLE" for f in FIELDS)
    qe.execute_one(
        f"CREATE TABLE cpu_big (hostname STRING, ts TIMESTAMP(3) NOT NULL, "
        f"{field_defs}, TIME INDEX (ts), PRIMARY KEY (hostname)) "
        "WITH (append_mode = 'true')")
    info = qe.catalog.table("public", "cpu_big")
    rid = info.region_ids[0]
    rng = np.random.default_rng(STREAM_SEED)
    names = np.asarray([f"host_{i}" for i in range(STREAM_HOSTS)],
                       dtype=object)
    points = rows_target // STREAM_HOSTS
    g = -(-points * STEP_S // 3600) * STREAM_HOSTS
    sums = np.zeros((g, len(FIELDS)))
    counts = np.zeros(g, dtype=np.int64)
    rows = puts = 0
    cut = None
    engine_s = 0.0
    t_wall = time.perf_counter()
    for i, p0 in enumerate(range(0, points, STREAM_PUT_POINTS)):
        if time.perf_counter() - T_START > STREAM_INGEST_DEADLINE_S:
            cut = (f"time: the ingest stopped at {rows} rows, "
                   f"{STREAM_INGEST_DEADLINE_S} s into the run")
            break
        p1 = min(p0 + STREAM_PUT_POINTS, points)
        n = (p1 - p0) * STREAM_HOSTS
        codes = np.tile(np.arange(STREAM_HOSTS, dtype=np.int32), p1 - p0)
        ts = np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64)
                       * STEP_S * 1000, STREAM_HOSTS)
        cols = {"hostname": DictVector(codes, names), "ts": ts}
        gid = (ts - T0_MS) // 3_600_000 * STREAM_HOSTS + codes
        counts += np.bincount(gid, minlength=g)
        for j, f in enumerate(FIELDS):
            cols[f] = rng.uniform(0.0, 100.0, n)
            sums[:, j] += np.bincount(gid, weights=cols[f], minlength=g)
        t = time.perf_counter()
        engine.put(rid, RecordBatch(info.schema, cols))
        rows += n
        puts += 1
        if (i + 1) % STREAM_FLUSH_EVERY == 0:
            engine.flush(rid)
        engine_s += time.perf_counter() - t
    t = time.perf_counter()
    engine.flush(rid)
    engine_s += time.perf_counter() - t
    region = engine.region(rid)
    log("stream ingest (cpu_big): " + json.dumps({
        "rows": rows, "target_rows": STREAM_ROWS, "puts": puts,
        "engine_seconds": engine_s, "rows_per_s": rows / engine_s,
        "wall_seconds_with_oracle": time.perf_counter() - t_wall,
        "wal_fsyncs": engine.wal.sync_count,
        "sst_files": len(region.files), "sst_bytes": region.sst_bytes,
        "memtable_rows": region.memtable.num_rows, "cut": cut}))
    return engine, qe, rows, sums, counts, cut


def stream_blocks(region, block: int) -> int:
    """The blocks a stream of the whole region folds: each file's chunks
    of 8 row groups (Region.scan_stream's groups_per_chunk) in blocks of
    `block` rows, then the memtable's rows."""
    n = 0
    for meta in region.files.values():
        rgs = region.sst_reader.footer(meta.file_id)["row_groups"]
        for i in range(0, len(rgs), 8):
            n += -(-sum(rg["rows"] for rg in rgs[i:i + 8]) // block)
    return n + -(-region.memtable.num_rows // block)


def check_stream_result(res, sums, counts, hours, what) -> float:
    """280,000 (hour, host) rows, each avg within rtol 1e-5 of the float64
    oracle; returns the largest relative error."""
    check(res.num_rows == STREAM_HOSTS * hours,
          f"{what}: {res.num_rows} rows, expected {STREAM_HOSTS * hours}")
    cols = dict(zip(res.names, res.columns))
    hour = (np.asarray(cols["hour"], dtype=np.int64) - T0_MS) // 3_600_000
    gid = hour * STREAM_HOSTS + host_index(np.asarray(cols["hostname"]))
    check(np.array_equal(np.sort(gid), np.arange(STREAM_HOSTS * hours)),
          f"{what}: (hour, hostname) keys")
    worst = 0.0
    for j, f in enumerate(FIELDS):
        want = sums[gid, j] / counts[gid]
        got = np.asarray(cols[f"avg({f})"], dtype=np.float64)
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        check(np.allclose(got, want, rtol=1e-5, atol=0),
              f"{what} avg({f}): max rel err {err}")
        worst = max(worst, err)
    return worst


def proc_status_bytes(key: str) -> int:
    """A size line of /proc/self/status (VmRSS: resident now)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise CheckFailed(f"/proc/self/status has no {key}")


class rss_peak:
    """This process's resident set before a block and its peak during it,
    sampled every 10 ms on a thread joined when the block ends."""

    def __enter__(self):
        import threading

        self.before = self.peak = proc_status_bytes("VmRSS")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, proc_status_bytes("VmRSS"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, proc_status_bytes("VmRSS"))
        return False


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def stream_phase(sk, torch, lib=None) -> dict:
    """BASELINE.json configs[1] at its full size: cpu_big ingested to disk,
    then its double-groupby-all through QueryEngine.execute_one on the
    card with the partial cache at its default. Each run (cold, then warm
    p50 of 3) must stream (`stream_prepared`), launch K1 once a block and
    K2 never, call Region.scan never, leave the hot set as it was, keep
    its host bytes in flight within one chunk and depth + 2 blocks, and
    hold every avg to the oracle at rtol 1e-5. Then one torch.profiler
    run and one cProfile run, and the materialized route (cold and warm,
    cache off: dense_prepared over the hot set) on the same table, held
    to the same oracle, unless the host lacks the memory for it."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch import config

    base = max((tempfile.gettempdir(), HERE),
               key=lambda d: shutil.disk_usage(d).free)
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_", dir=base)
    out: dict = {}
    try:
        rows_target, disk_cut = stream_rows_for(root)
        engine, qe, rows, sums, counts, time_cut = stream_ingest(
            root, rows_target)
        out["cut"] = disk_cut or time_cut
        hours = -(-(rows // STREAM_HOSTS) * STEP_S // 3600)
        region = engine.region(qe.catalog.table(
            "public", "cpu_big").region_ids[0])
        check(region.memtable.num_rows == 0 and len(region.files) >= 2,
              "cpu_big: the ingest left no flushed files")
        threshold = config.stream_threshold_rows()
        if rows < threshold:  # only after a cut: stream what landed
            threshold = rows
            log(f"stream threshold lowered to {rows} rows for the cut")
        scans = []
        real_scan = region.scan

        def counting_scan(*a, **kw):
            scans.append(1)
            return real_scan(*a, **kw)

        region.scan = counting_scan
        sql = stream_sql()
        want_blocks = stream_blocks(region, config.stream_block_rows())
        cache = qe.executor.cache
        cuda = torch.cuda.is_available()
        runs = []
        with env_value("GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS",
                       str(threshold)):
            for i in range(4):
                zero_launches(sk)
                if lib is not None:
                    k1_stats(lib, reset=True)
                resident = cache.resident_bytes
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                with rss_peak() as rss:
                    res, ms = timed_query(qe, sql, torch)
                st = qe.executor.last_stream_stats
                run = {"ms": ms, "rows_per_s": rows / ms * 1e3,
                       "host_rss_before": rss.before,
                       "host_rss_peak": rss.peak,
                       "last_path": qe.executor.last_path,
                       "k1_launches": sk.segment_sum.launches,
                       "k2_launches": sk.fused_segment_agg.launches,
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated() if cuda else None,
                       "resident_bytes_delta": cache.resident_bytes
                       - resident, "region_scans": len(scans),
                       "stream": st}
                if lib is not None and i == 0:
                    run["k1_counters"] = k1_stats(lib, reset=True)
                what = "stream cold" if i == 0 else f"stream warm {i}"
                check(run["last_path"] == "stream_prepared",
                      f"{what}: last_path {run['last_path']}")
                check(run["k1_launches"] == want_blocks == st["blocks"],
                      f"{what}: K1 {run['k1_launches']} launches, "
                      f"{st['blocks']} blocks, {want_blocks} expected")
                check(run["k2_launches"] == 0, f"{what}: K2 launched")
                check(not scans, f"{what}: Region.scan was called")
                check(run["resident_bytes_delta"] == 0,
                      f"{what}: the hot set changed")
                check(st["peak_host_bytes"] <= st["chunk_bytes_max"]
                      + (st["depth"] + 2) * st["block_bytes_max"],
                      f"{what}: {st['peak_host_bytes']} host bytes in flight")
                run["max_rel_err"] = check_stream_result(
                    res, sums, counts, hours, what)
                log(f"{what}: " + json.dumps(run))
                runs.append(run)
            if cuda:
                log("stream profile (one warm run, profiler on): "
                    + json.dumps(device_breakdown(
                        lambda: qe.execute_one(sql), torch)))
            log("stream host breakdown (one warm run, every thread): "
                + json.dumps(host_breakdown(
                    lambda: qe.execute_one(sql))))
            check(qe.executor.last_path == "stream_prepared" and not scans,
                  "stream: the profiled runs left the streaming route")
        out["rows"] = rows
        out["cold"] = runs[0]
        out["warm_p50_ms"] = float(np.median([r["ms"] for r in runs[1:]]))
        log("stream summary: " + json.dumps({
            "rows": rows, "blocks": want_blocks, "cold_ms": runs[0]["ms"],
            "warm_p50_ms": out["warm_p50_ms"],
            "warm_rows_per_s": rows / out["warm_p50_ms"] * 1e3,
            "h2d_bytes": runs[0]["stream"]["h2d_bytes"],
            "max_memory_allocated": runs[0]["max_memory_allocated"],
            "peak_host_bytes": runs[0]["stream"]["peak_host_bytes"],
            "host_rss_before": runs[0]["host_rss_before"],
            "host_rss_peak": runs[0]["host_rss_peak"],
            "cut": out["cut"]}))

        # the materialized route on the same table, for comparison
        avail, need = mem_available(), 3 * rows * STREAM_ROW_BYTES
        if avail < need:
            out["materialized"] = {"skipped": f"MemAvailable {avail} < "
                                   f"3 x the scan's {need // 3} bytes"}
            log("stream materialized comparison skipped: "
                + out["materialized"]["skipped"])
        else:
            mat = {}
            with partial_cache(False), env_value(
                    "GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS", str(1 << 62)):
                for tag in ("cold", "warm"):
                    zero_launches(sk)
                    if cuda:
                        torch.cuda.reset_peak_memory_stats()
                    with rss_peak() as rss:
                        res, ms = timed_query(qe, sql, torch)
                    rec = {"ms": ms, "last_path": qe.executor.last_path,
                           "host_rss_before": rss.before,
                           "host_rss_peak": rss.peak,
                           "k1_launches": sk.segment_sum.launches,
                           "k2_launches": sk.fused_segment_agg.launches,
                           "max_memory_allocated":
                           torch.cuda.max_memory_allocated() if cuda
                           else None,
                           "resident_bytes": cache.resident_bytes}
                    check(rec["last_path"] == "dense_prepared",
                          f"materialized {tag}: {rec['last_path']}")
                    rec["max_rel_err"] = check_stream_result(
                        res, sums, counts, hours, f"materialized {tag}")
                    log(f"stream materialized {tag} (cache off): "
                        + json.dumps(rec))
                    mat[tag] = rec
            out["materialized"] = mat
        del res
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


# ---- entry point -------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from greptimedb_tpu_torch.ops import _build
        from greptimedb_tpu_torch.ops import segment_kernels as sk
    except ImportError as e:
        print(f"chip_smoke: greptimedb_tpu_torch not found beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    lib = _build.library()
    bind_k1_probes(lib)
    log(f"kernels built in {_build.build_seconds:.2f} s "
        f"(load {time.perf_counter() - t:.2f} s): {_build.LIB_PATH}")
    # the sparse query's per-part partials (about 0.3 GB of keys and
    # planes for 2.9M groups) pass the partial cache's 256 MB default
    os.environ.setdefault("GREPTIMEDB_TPU_PARTIAL_CACHE_BYTES",
                          str(PARTIAL_CACHE_BYTES))
    try:
        kres = kernel_phase(sk, lib, torch)
        main = main_path_phase(sk, torch, lib)
        hc = hc_phase(sk, torch)
        with partial_cache(False):
            dedup_phase(torch)
        prom = promql_phase(sk, torch)
        stream = stream_phase(sk, torch, lib)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    by_path = {"main (cache off, after ingest)": main["launches"],
               "sparse_fused": {
                   "segment_sum": main["sparse"]["sparse"]["k1_launches"],
                   "fused_segment_agg":
                   main["sparse"]["sparse"]["k2_launches"]},
               "incremental (cache on, after ingest)":
               main["cached"]["ingest"]["launches"],
               "hc dense_prepared": dict(zip(
                   ("segment_sum", "fused_segment_agg"),
                   hc["cache_off"]["cold_launches"])),
               "hc incremental_sparse": dict(zip(
                   ("segment_sum", "fused_segment_agg"),
                   hc["cache_on"]["cold_launches"])),
               "promql prom_cpu (cold runs)": {
                   "segment_sum": 0, "fused_segment_agg": sum(
                       r["k2_launches_cold"] for r in prom.values())},
               "promql cpu (cold runs)": {
                   "segment_sum": 0, "fused_segment_agg": sum(
                       r["k2_launches_cold"]
                       for r in main["promql_cpu"].values())},
               "stream_prepared (cpu_big)": {
                   "segment_sum": stream["cold"]["k1_launches"],
                   "fused_segment_agg": stream["cold"]["k2_launches"]}}
    for state in ("ingest", "compacted"):
        r = main["range"][state]
        by_path[f"range (cpu, after {state})"] = {
            "segment_sum": r["k1_launches"],
            "fused_segment_agg": r["k2_launches"]}
    by_path["range fill (cpu, 8 hosts)"] = {
        "segment_sum": main["range"]["fill"]["k1_launches"],
        "fused_segment_agg": main["range"]["fill"]["k2_launches"]}
    by_path["host sql (cpu, 7 queries, cold runs)"] = main["host_sql"][
        "launches"]
    for state, res in (("ingest", main), ("reopened", main["reopened"]),
                       ("compacted", main["compacted"])):
        q = res["queries"]["lastpoint"]
        by_path[f"lastpoint lastscan+boundary (after {state})"] = {
            "segment_sum": q["k1_launches"],
            "fused_segment_agg": q["k2_launches"]}
    later_paths = ("promql prom_cpu (cold runs)", "promql cpu (cold runs)",
                   "stream_prepared (cpu_big)", "range (cpu, after ingest)",
                   "range fill (cpu, 8 hosts)",
                   "host sql (cpu, 7 queries, cold runs)")
    sources = {"segment_sum": ("greptimedb_tpu_torch/csrc/segment_sum.cu",
                               "greptimedb_tpu/ops/pallas_segment.py:119"),
               "fused_segment_agg": (
                   "greptimedb_tpu_torch/csrc/fused_segment_agg.cu",
                   "greptimedb_tpu/ops/pallas_segment.py:263")}
    kernels = []
    for name, (src, replaces) in sources.items():
        h = kres[name]["headline"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main["launches"][name]
            + sum(by_path[k][name] for k in later_paths),
            "max_abs_err": h["max_abs_err"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "shape": h["shape"], "G": h["G"],
            "launches_by_path": {k: v[name] for k, v in by_path.items()}})
        if name == "segment_sum":
            kernels[-1]["stream_shape"] = {
                k: kres[name]["stream"][k] for k in (
                    "shape", "G", "dtype", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "stats")}
        if name == "fused_segment_agg":
            for key, case in (("sparse_shape", "sparse"),
                              ("promql_label_shape", "promql_label"),
                              ("promql_buckets_shape", "promql_buckets"),
                              ("range_shape", "range"),
                              ("lastpoint_ingest_shape", "lastpoint_ingest"),
                              ("lastpoint_flushed_shape",
                               "lastpoint_flushed")):
                sp = kres[name][case]
                kernels[-1][key] = {
                    k: sp[k] for k in ("shape", "G", "dtype", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms",
                                       "bound_by")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
