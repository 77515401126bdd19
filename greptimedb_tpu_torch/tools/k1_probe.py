#!/usr/bin/env python3
"""Probe the K1 segment-sum kernel (csrc/segment_sum.cu) on the card.

    python3 greptimedb_tpu_torch/tools/k1_probe.py [--baseline OLD.cu]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
For each of chip_smoke.py's five K1 cases it times, with CUDA events
(median of 7 after a warm-up):

- base: the kernel as it is, checked against the float64 plain sum;
- baseline (with --baseline, an earlier segment_sum.cu, e.g. from
  `git show <commit>:greptimedb_tpu_torch/csrc/segment_sum.cu`), in the
  order baseline, base, base, baseline, and checked the same way;
- copy_only: the chunk loop stages every chunk and summarizes its ids but
  adds nothing (the staging pipeline alone);
- no_adds: everything but the adds (staging, summaries, window upkeep);
- phases: clock64 cycles a chunk spent in each part of the chunk loop,
  for warp 0 (which starts the copies) and warp 15 (which summarizes).

copy_only, no_adds and phases are timing probes: their sums are wrong on
purpose. Each variant builds from an edited copy of the source whose
namespace is renamed, so the libraries load side by side; builds go to
greptimedb_tpu_torch/_build/probe/. Prints the card line, then one JSON
line a case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from greptimedb_tpu_torch.ops import _build  # noqa: E402
from greptimedb_tpu_torch.ops import segment_kernels as sk  # noqa: E402

PROBE_DIR = os.path.join(_build.BUILD_DIR, "probe")
FETCH = "    fetch(k + kStages - 1);\n"
SORTED = "      if (sorted) {  // distinct ids: plain adds\n"
RUNS = "      } else if (run_row < nr) {  // runs: one add per id change\n"
# q0 before the loop's barrier, then a stamp after each part; the barrier's
# wait shows after it (the warp stalls at its next instructions), so the
# first part holds the barrier, the copy start and the chunk's summary
PHASE_NAMES = ("barrier_fetch_summary", "plane_wait", "adds", "next_summary")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"k1_probe: segment_sum.cu no longer contains "
                         f"{old.strip()!r}; update the probe")
    return src.replace(old, new, 1)


def _renamed(src: str, tag: str) -> str:
    return src.replace("namespace k1 {", f"namespace k1_{tag} {{").replace(
        "gtpu::k1::", f"gtpu::k1_{tag}::")


def _phases(src: str) -> str:
    """clock64 stamps around the parts of the chunk loop, summed for
    threads 0 and 480 into a device array read by k1_phases()."""
    src = _sub(src, "__device__ unsigned long long stats[5];",
               "__device__ unsigned long long stats[5];\n"
               "__device__ unsigned long long phase_cycles[10];")
    src = _sub(src, "  for (int k = 0; k < nchunks; ++k) {\n"
               "    __syncthreads();  // chunk k's summary is out; chunk "
               "k-1's slots are free\n" + FETCH,
               "  unsigned long long P[5] = {0, 0, 0, 0, 0};\n"
               "  for (int k = 0; k < nchunks; ++k) {\n"
               "    const long long q0 = clock64();\n"
               "    __syncthreads();\n" + FETCH)
    src = _sub(src, "    // every chunk's copy is waited for",
               "    const long long q1 = clock64();\n"
               "    // every chunk's copy is waited for")
    src = _sub(src, "    if (kStaged) mbar_wait(plane_bar + k % kStages, "
               "(k / kStages) & 1);\n",
               "    if (kStaged) mbar_wait(plane_bar + k % kStages, "
               "(k / kStages) & 1);\n    const long long q2 = clock64();\n")
    src = _sub(src, "    summarize(k + 1);\n  }\n",
               "    const long long q3 = clock64();\n"
               "    summarize(k + 1);\n"
               "    const long long q4 = clock64();\n"
               "    P[0] += q1 - q0; P[1] += q2 - q1; P[2] += q3 - q2;\n"
               "    P[3] += q4 - q3; P[4] += 1;\n  }\n")
    src = _sub(src, "  if (tid == 0) {\n    atomicAdd(&stats[0], rebases);",
               "  if (tid == 0 || tid == 480)\n"
               "    for (int i = 0; i < 5; ++i)\n"
               "      atomicAdd(&phase_cycles[(tid ? 5 : 0) + i], P[i]);\n"
               "  if (tid == 0) {\n    atomicAdd(&stats[0], rebases);")
    return src + """
extern "C" int k1_phases(unsigned long long* out10) {
  cudaError_t e = cudaMemcpyFromSymbol(out10, gtpu::k1::phase_cycles,
                                       sizeof(gtpu::k1::phase_cycles));
  const unsigned long long zero[10] = {};
  cudaMemcpyToSymbol(gtpu::k1::phase_cycles, zero, sizeof(zero));
  return (int)e;
}
"""


def _variants(baseline: str | None) -> dict:
    with open(os.path.join(_build.CSRC, "segment_sum.cu"),
              encoding="utf-8") as f:
        src = f.read()
    out = {
        "base": src,
        "copy_only": _sub(src, FETCH, FETCH + (
            "    if (kStaged) mbar_wait(plane_bar + k % kStages, "
            "(k / kStages) & 1);\n    summarize(k + 1);\n    continue;\n")),
        "no_adds": _sub(_sub(src, SORTED, "      if (false) {\n"), RUNS,
                        "      } else if (false) {\n"),
        "phases": _phases(src),
    }
    if baseline:
        with open(baseline, encoding="utf-8") as f:
            out["baseline"] = f.read()
    # Kernels of one name in two libraries clash when launched with more
    # than 48 KB of shared memory, so every copy but base gets its own.
    return {k: (v if k == "base" else _renamed(v, k)) for k, v in out.items()}


def _build_all(sources: dict) -> dict:
    """One nvcc a variant, all started together; returns loaded libs."""
    os.makedirs(PROBE_DIR, exist_ok=True)
    for name in os.listdir(_build.CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, name), PROBE_DIR)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in sources.items():
        path = os.path.join(PROBE_DIR, f"k1_{name}.cu")
        with open(path, "w", encoding="utf-8") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", path, "-o",
             path[:-3] + ".so"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"k1_probe: nvcc failed for {name}:\n"
                             f"{out.decode()}")
        lib = ctypes.CDLL(os.path.join(PROBE_DIR, f"k1_{name}.so"))
        fn = lib.gtpu_segment_sum
        fn.argtypes = _build._SIGNATURES["gtpu_segment_sum"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    libs["phases"].k1_phases.argtypes = [ctypes.c_void_p]
    return libs


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an earlier segment_sum.cu to time "
                    "beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 2
    libs = _build_all(_variants(args.baseline))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    n = 8_388_608
    for w, dtype, kind in ((11, torch.float32, "hosthour"),
                           (21, torch.float32, "hosthour"),
                           (11, torch.float32, "minute"),
                           (21, torch.float32, "minute"),
                           (11, torch.float64, "hosthour")):
        if kind == "hosthour":
            ids, g = cs.host_hour_ids(n, cs.HOSTS, 3600 // cs.STEP_S,
                                      cs.HOURS, 0.1, gen, dev)
        else:
            g = 61
            ids = cs.time_major_ids(n, 60, 6 * cs.HOSTS, 0.1, gen, dev)
        plane = cs.values(n, w, dtype, gen, dev)

        def run(name):
            out = torch.zeros((g, w), dtype=dtype, device=dev)
            rc = libs[name].gtpu_segment_sum(
                plane.data_ptr(), ids.data_ptr(), out.data_ptr(), n, w, g,
                int(dtype == torch.float64),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"k1_probe: {name}: CUDA error {rc}")
            return out

        want = sk.segment_sum_plain(plane.double(), ids, g)
        absx = sk.segment_sum_plain(plane.double().abs(), ids, g)
        ok = {name: cs.sum_ok(run(name), want, absx, dtype)[0]
              for name in ("base", "baseline") if name in libs}
        ms = {}
        order = (["baseline", "base", "base", "baseline"] if "baseline" in
                 libs else ["base"]) + ["copy_only", "no_adds"]
        for name in order:
            ms.setdefault(name, []).append(cs.cuda_ms(lambda: run(name)))
        run("phases")
        torch.cuda.synchronize()
        cyc = (ctypes.c_ulonglong * 10)()
        libs["phases"].k1_phases(cyc)  # reset after the warm-up
        run("phases")
        torch.cuda.synchronize()
        libs["phases"].k1_phases(cyc)
        v = list(cyc)
        phases = {}
        for who, off in (("warp0", 0), ("warp15", 5)):
            chunks = max(v[off + 4], 1)
            phases[who] = {p: v[off + i] / chunks
                           for i, p in enumerate(PHASE_NAMES)}
        live = int(((ids >= 0) & (ids < g - 1)).sum().item())
        es = plane.element_size()
        b_ms, _ = cs.bound(4 * n + live * w * es + g * w * es, live * w,
                           dtype)
        print(json.dumps({
            "case": {"shape": [n, w], "G": g, "dtype": str(dtype),
                     "ids": kind},
            "ok": ok, "ms": {k: float(np.median(x)) for k, x in ms.items()},
            "ms_runs": ms, "bound_ms": b_ms,
            "phase_cycles_a_chunk": phases}), flush=True)
        del plane, ids, want, absx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
