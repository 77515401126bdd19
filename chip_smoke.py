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
   least time the card could take. Each wrapper must refuse an int64
   input.
3. The main path at TSBS scale: the `cpu` table bench.py builds (4,000
   hosts x 12 h at 10 s = 17,280,000 rows, 10 DOUBLE fields, one
   `hostname` tag, append mode), written through RegionEngine.put and
   queried with bench.py's four dashboard SQL strings through
   QueryEngine.execute_one on cuda. Every value is held against a float64
   numpy oracle over the same arrays; `last_path` and the kernels' launch
   counts show the route. Then a small non-append table with duplicate
   keys and tombstones goes through last-write-wins dedup and is held
   against a Python oracle.
4. A `kernels` JSON line, the card line, and the result line.

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
T0_MS = 1456790400000  # 2016-03-01T00:00:00Z
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
    |got - want| <= 1e-12 * sum|x|."""
    import torch

    err = (got.to(torch.float64) - want64).abs()
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    return bool((err <= rel * absx).all()), float(err.max().item())


def kernel_phase(sk, torch) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # K1: segment_sum over prepared planes
    k1 = []
    for w, dtype, kind in ((11, torch.float32, "hosthour"),
                           (21, torch.float32, "hosthour"),
                           (11, torch.float32, "minute"),
                           (21, torch.float32, "minute"),
                           (11, torch.float64, "hosthour")):
        n = 8_388_608
        if kind == "hosthour":
            ids, g = host_hour_ids(n, HOSTS, 3600 // STEP_S, HOURS, 0.1, gen,
                                   dev)
        else:
            g = 61
            ids = time_major_ids(n, 60, 6 * HOSTS, 0.1, gen, dev)
        plane = values(n, w, dtype, gen, dev)
        got = sk.segment_sum(plane, ids, g)
        torch.cuda.synchronize()
        want = sk.segment_sum_plain(plane.double(), ids, g)
        absx = sk.segment_sum_plain(plane.double().abs(), ids, g)
        ok, err = sum_ok(got, want, absx, dtype)
        f32_plain_err = float((sk.segment_sum_plain(plane, ids, g).double()
                               - want).abs().max().item())
        check(ok, f"segment_sum {n}x{w} G={g} {dtype}: max err {err}")
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
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        log("K1 segment_sum " + json.dumps(case))
        k1.append(case)
        del plane, ids, got, want, absx, lib_out
        torch.cuda.empty_cache()
    results["segment_sum"] = {"cases": k1, "headline": k1[0]}
    check(k1[0]["G"] == 48013, "K1 headline shape")

    # K2: fused_segment_agg over raw values. Main-path shapes: the padded
    # blocks of single_groupby_1_1_1 (1,024 rows, F=1, G+1=61),
    # cpu_max_all_8 (32,768 rows, F=10, G+1=9) and groupby_orderby_limit
    # (131,072 rows, F=1, G+1=6); then the contention case.
    k2 = []
    cases = [
        (1024, 1, 61, 60, 6, 0.65, torch.float32, (True, True, False)),
        (32768, 10, 9, 8, 360 * 8, 0.3, torch.float32, (True, True, True)),
        (32768, 10, 9, 8, 360 * 8, 0.3, torch.float32, (False, False, False)),
        (131072, 1, 6, 5, 6 * HOSTS, 0.08, torch.float32, (True, True, False)),
        (8_388_608, 1, 721, 720, 6 * HOSTS, 0.1, torch.float32,
         (True, True, False)),
        (32768, 10, 9, 8, 360 * 8, 0.3, torch.float64, (True, True, True)),
        (8_388_608, 1, 721, 720, 6 * HOSTS, 0.1, torch.float64,
         (True, True, True)),
    ]
    for n, f, g, nb, run, dead, dtype, (mn, mx, sq) in cases:
        ids = time_major_ids(n, nb, run, dead, gen, dev)
        vals = values(n, f, dtype, gen, dev, nan_frac=0.05, ties=True)
        got = sk.fused_segment_agg(vals, ids, g, mn, mx, sq)
        torch.cuda.synchronize()
        want = sk.fused_segment_agg_plain(vals.double(), ids, g, mn, mx, sq)
        absx = sk.fused_segment_agg_plain(vals.double().abs(), ids, g,
                                          False, False, sq)
        for k in ("count", "rows"):
            check(torch.equal(got[k], want[k]),
                  f"fused {k} {n}x{f} G={g} {dtype}")
        for k in ("min", "max"):
            if k in got:
                check(torch.equal(got[k].double(), want[k]),
                      f"fused {k} {n}x{f} G={g} {dtype}")
        ok, err = sum_ok(got["sum"], want["sum"], absx["sum"], dtype)
        check(ok, f"fused sum {n}x{f} G={g} {dtype}: max err {err}")
        if sq:
            ok_q, err_q = sum_ok(got["sumsq"], want["sumsq"],
                                 absx["sumsq"], dtype)
            check(ok_q, f"fused sumsq {n}x{f} G={g} {dtype}: err {err_q}")
        live_mask = (ids >= 0) & (ids < g - 1)
        live = int(live_mask.sum().item())
        es = vals.element_size()
        outs = g * f * (es + 4) + g * 4 + g * f * es * (mn + mx + sq)
        nbytes = 4 * n + live * f * es + outs
        b_ms, b_by = bound(nbytes, live * f * (2 + mn + mx + 2 * sq), dtype)
        k_ms = cuda_ms(lambda: sk.fused_segment_agg(vals, ids, g, mn, mx, sq))
        p_ms = cuda_ms(lambda: sk.fused_segment_agg_plain(vals, ids, g, mn,
                                                          mx, sq), runs=5)
        case = {"shape": [n, f], "G": g, "dtype": str(dtype),
                "want": {"min": mn, "max": mx, "sumsq": sq},
                "live_rows": live, "run": run, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by}
        log("K2 fused_segment_agg " + json.dumps(case))
        k2.append(case)
        del vals, ids, got, want, absx
        torch.cuda.empty_cache()
    results["fused_segment_agg"] = {"cases": k2, "headline": k2[3]}

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


# ---- phase 3: the main path at TSBS scale -----------------------------------


def build_and_ingest(torch):
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import RegionEngine

    engine = RegionEngine()
    qe = QueryEngine(Catalog(MemoryKv()), engine)  # device: the CUDA card
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
    rid = info.region_ids[0]
    rng = np.random.default_rng(SEED)
    points = HOURS * 3600 // STEP_S
    host_names = np.asarray([f"host_{i}" for i in range(HOSTS)], dtype=object)
    slice_points = max(1, (1 << 21) // HOSTS)  # ~2M rows a batch
    fields = {f: [] for f in FIELDS}
    t0 = time.perf_counter()
    rows = 0
    for p0 in range(0, points, slice_points):
        p1 = min(p0 + slice_points, points)
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
        rows += engine.put(rid, RecordBatch(info.schema, cols))
    ingest_s = time.perf_counter() - t0
    # [points, hosts] views of the same values, for the oracle
    grid = {f: np.concatenate(fields[f]).reshape(points, HOSTS)
            for f in FIELDS}
    return qe, rows, ingest_s, grid, host_names


def tsbs_queries():
    t_end = T0_MS + HOURS * 3600 * 1000
    cutoff = T0_MS + (HOURS * 3600 * 1000) * 3 // 4
    avg_list = ", ".join(f"avg({f})" for f in FIELDS)
    max_list = ", ".join(f"max({f})" for f in FIELDS)
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
    }


def f32_exact(x: np.ndarray) -> np.ndarray:
    """The float64 oracle as the f32 kernels see it: max of f32-cast
    values is the f32 cast of the f64 max."""
    return x.astype(np.float32).astype(np.float64)


def check_result(name, res, grid, host_names):
    per_hour = 3600 // STEP_S
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
        cut_pt = HOURS * per_hour * 3 // 4
        minutes = np.arange(cut_pt // 6 - 1, cut_pt // 6 - 6, -1)
        want = np.asarray([grid["usage_user"][m * 6:(m + 1) * 6].max()
                           for m in minutes])
        check(np.array_equal(cols["minute"], T0_MS + minutes * 60_000),
              name + " keys")
        check(np.array_equal(cols["max(usage_user)"].astype(np.float64),
                             f32_exact(want)), name + " max")
    else:
        order = np.argsort(host_names.astype(str), kind="stable")
        hours = np.repeat(np.arange(HOURS), HOSTS)
        check(np.array_equal(cols["hour"], T0_MS + hours * 3_600_000),
              name + " hour keys")
        check(np.array_equal(cols["hostname"].astype(str),
                             np.tile(host_names[order].astype(str), HOURS)),
              name + " hostname keys")
        for f in FIELDS:
            want = grid[f].reshape(HOURS, per_hour, HOSTS).mean(axis=1)
            want = want[:, order].reshape(-1)
            got = cols[f"avg({f})"].astype(np.float64)
            check(np.allclose(got, want, rtol=1e-5, atol=0),
                  f"{name} avg({f}): max rel err "
                  f"{np.max(np.abs(got - want) / np.abs(want))}")


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


def main_path_phase(sk, torch) -> dict:
    qe, rows, ingest_s, grid, host_names = build_and_ingest(torch)
    check(rows == HOSTS * HOURS * 3600 // STEP_S, "ingested rows")
    log(f"ingest: {rows} rows in {ingest_s:.3f} s "
        "(cpu table, 10 DOUBLE fields, one hostname tag of TSBS's ten)")
    queries = tsbs_queries()
    # the main path's launch counts: zeroed just before, read just after
    sk.segment_sum.launches = 0
    sk.fused_segment_agg.launches = 0
    timings = {}
    for name, (sql, want_path, want_rows) in queries.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = qe.execute_one(sql)
        cold_ms = (time.perf_counter() - t) * 1e3
        path = qe.executor.last_path
        check(res.num_rows == want_rows,
              f"{name}: {res.num_rows} rows, expected {want_rows}")
        check(path == want_path, f"{name}: last_path {path}, "
              f"expected {want_path}")
        check_result(name, res, grid, host_names)
        warm = []
        for _ in range(5):
            t = time.perf_counter()
            qe.execute_one(sql)
            warm.append((time.perf_counter() - t) * 1e3)
        timings[name] = {"cold_ms": cold_ms, "warm_p50_ms":
                         float(np.median(warm)), "rows": res.num_rows,
                         "last_path": path}
        log(f"query {name}: " + json.dumps(timings[name]))
        log(f"profile {name} (one warm run, profiler on): " + json.dumps(
            device_breakdown(lambda: qe.execute_one(sql), torch)))
    launches = {"segment_sum": sk.segment_sum.launches,
                "fused_segment_agg": sk.fused_segment_agg.launches}
    log("main path launches: " + json.dumps(launches))
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched on the main path")
    cache = qe.executor.cache
    log("hot set: " + json.dumps({
        "resident_bytes": cache.resident_bytes, "h2d_bytes": cache.h2d_bytes,
        "hits": cache.hits, "misses": cache.misses,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    return {"launches": launches, "queries": timings}


def dedup_phase(torch) -> None:
    """A non-append table with duplicate keys and tombstones, held against
    a Python last-write-wins oracle."""
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import RegionEngine

    engine = RegionEngine()
    qe = QueryEngine(Catalog(MemoryKv()), engine)
    qe.execute_one("CREATE TABLE t (host STRING, ts TIMESTAMP(3) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))")
    info = qe.catalog.table("public", "t")
    rng = np.random.default_rng(SEED)
    live: dict = {}
    for _ in range(40):
        n = 64
        hosts = rng.integers(0, 12, n)
        ts = rng.integers(0, 30, n) * 1000
        v = np.round(rng.uniform(0, 100, n), 1)
        cols = {"host": DictVector.encode([f"h{h}" for h in hosts]),
                "ts": ts.astype(np.int64), "v": v}
        if rng.random() < 0.3:
            engine.delete(info.region_ids[0], RecordBatch(info.schema, cols))
            for h, t in zip(hosts, ts):
                live.pop((f"h{h}", int(t)), None)
        else:
            engine.put(info.region_ids[0], RecordBatch(info.schema, cols))
            for h, t, x in zip(hosts, ts, v):
                live[(f"h{h}", int(t))] = float(x)
    res = qe.execute_one("SELECT host, ts, v FROM t ORDER BY host, ts")
    want = sorted((h, t, x) for (h, t), x in live.items())
    got = [(str(h), int(t), float(x)) for h, t, x in res.rows()]
    check(got == want, f"dedup raw scan: {len(got)} rows, {len(want)} "
          "expected")
    res = qe.execute_one("SELECT host, count(v), max(v) FROM t "
                         "GROUP BY host ORDER BY host")
    per: dict = {}
    for (h, _), x in live.items():
        c, m = per.get(h, (0, -np.inf))
        per[h] = (c + 1, max(m, x))
    want = sorted((h, c, float(np.float32(m))) for h, (c, m) in per.items())
    got = [(str(h), int(c), float(m)) for h, c, m in res.rows()]
    check(got == want, "dedup aggregate")
    log(f"dedup: {len(live)} live keys after tombstones, last_path "
        f"{qe.executor.last_path}")


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
    _build.library()
    log(f"kernels built in {_build.build_seconds:.2f} s "
        f"(load {time.perf_counter() - t:.2f} s): {_build.LIB_PATH}")
    try:
        kres = kernel_phase(sk, torch)
        main = main_path_phase(sk, torch)
        dedup_phase(torch)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
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
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": h["max_abs_err"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "shape": h["shape"], "G": h["G"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
