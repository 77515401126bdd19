"""Build and load the port's CUDA kernels.

The sources in greptimedb_tpu_torch/csrc/ are compiled at first use with
nvcc for Hopper (`sm_90a`) into one shared library with a plain C
interface, `greptimedb_tpu_torch/_build/libsegment_kernels.so`, and bound
with ctypes. Each source compiles in its own nvcc process, all started
together, then one link step joins the objects. A library whose recorded
source hash matches the sources is reused; anything else is rebuilt.

Nothing here runs at import: the CPU tests import every module of the
port, and a machine without nvcc never reaches `library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libsegment_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
#: seconds the last build took (0.0 when a matching library was reused)
build_seconds = 0.0

_C = ctypes.c_void_p
_SIGNATURES = {
    # plane, ids, out, n, w, g, is_double, stream
    "gtpu_segment_sum": [_C, _C, _C, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, _C],
    # vals, ids, n, f, g, is_double, flags, out, stream
    "gtpu_fused_segment_agg": [_C, _C, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, _C,
                               _C],
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "greptimedb_tpu_torch build on a machine with "
                           "the CUDA toolkit")
    return found


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless an up-to-date library is
    there; returns its path."""
    global build_seconds
    digest = _digest()
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp, encoding="utf-8") as f:
            if f.read().strip() == digest:
                build_seconds = 0.0
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, os.path.basename(p)[:-3] + ".o")
            for p in cus]
    procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, *CFLAGS, "-c", src,
                               "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for src, obj in zip(cus, objs)]
    errors = []
    for src, p in zip(cus, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{os.path.basename(src)}:\n{out.decode()}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode())
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w", encoding="utf-8") as f:
        f.write(digest)
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
