"""Roofline accountant: fold a query's resource ledger into bandwidth.

The per-query :mod:`ledger` already counts every byte a statement moves
(H2D/D2H transfers from device_telemetry, decoded scan bytes from the
storage plane) and every millisecond its device spans ran.  This module
folds those raw counts into the three numbers ROADMAP item 1 names as
the headline capture metric:

- ``achieved_gbps``  — bytes moved / device time, in GB/s.  The bytes
  are ``h2d_bytes + d2h_bytes + bytes_decoded`` (link traffic plus the
  decode read stream); the denominator prefers device span time
  (``device_ms``), falling back to aggregate time and finally to the
  caller-supplied wall duration.
- ``arithmetic_intensity`` — estimated FLOPs per byte.  The workloads
  here are streaming reductions (~one multiply-accumulate per scanned
  row), so intensity lands well under 1 FLOP/B: bandwidth-bound, which
  is exactly why achieved GB/s is the number that matters.
- ``roofline_fraction`` — achieved_gbps / the card's peak memory
  bandwidth, read from the card itself (2 x memory clock x bus width,
  ``csrc/device_info.cu`` through the kernel library; an H100 SXM
  reads 3.35 TB/s); overridable for golden tests via
  ``GTPU_ROOFLINE_PEAK_GBPS``.  A CPU engine gets a host stand-in.

Everything is a pure fold over a ledger snapshot dict — no sampling, no
probes at account() time — so the stamped numbers agree with the ledger
byte counts exactly, and golden tests can hand-compute fixtures.

Copy of greptimedb_tpu/utils/roofline.py; the peak is the port's own:
the device the last QueryEngine was built on (`note_device`), read once
per card, and no tunnel clamp (the card is always co-located).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

#: host stand-in peak, GB/s: a typical dual-channel DDR5 host, so CPU
#: runs still get a finite fraction. A card's peak is read from the card
_PEAKS = {"cpu": 100.0}

#: the device queries run on (QueryEngine registers its own) and the
#: peaks read per card index
_DEVICE = None
_CARD_PEAKS: dict = {}
_peak_lock = threading.Lock()

#: estimated FLOPs per scanned row — one multiply-accumulate, the
#: honest floor for the streaming SUM/AVG reductions this engine runs
_EST_FLOPS_PER_ROW = 2.0

#: ledger keys folded into the byte numerator, in stamp order
BYTE_KEYS = ("h2d_bytes", "d2h_bytes", "bytes_decoded")


def note_device(device) -> None:
    """Record the device the engine's queries run on (QueryEngine
    calls this; the last engine built wins)."""
    global _DEVICE
    _DEVICE = device


def _link() -> dict:
    """The port's own device: backend "gpu" for a CUDA engine (with its
    card index), "cpu" otherwise or before any engine exists."""
    dev = _DEVICE
    if dev is not None and getattr(dev, "type", None) == "cuda":
        return {"backend": "gpu", "colocated": True,
                "index": 0 if dev.index is None else int(dev.index)}
    return {"backend": "cpu", "colocated": True}


def card_peak_gbps(index: int = 0) -> float:
    """The card's own peak memory bandwidth in GB/s: 2 x memory clock x
    bus width, through cudaDeviceGetAttribute in the kernel library
    (built on first use). Read once per card."""
    with _peak_lock:
        got = _CARD_PEAKS.get(index)
        if got is None:
            from greptimedb_tpu_torch.ops import _build

            out = ctypes.c_double(0.0)
            rc = _build.library().gtpu_device_peak_bytes_per_s(
                int(index), ctypes.byref(out))
            if rc != 0 or out.value <= 0:
                raise RuntimeError(
                    f"cudaDeviceGetAttribute failed for card {index} "
                    f"(error {rc}): no memory clock or bus width")
            got = _CARD_PEAKS[index] = out.value / 1e9
        return got


def peak_gbps(backend: Optional[str] = None) -> float:
    """Attainable peak bandwidth in GB/s for the active backend: the
    card's own peak on a CUDA engine, the host stand-in otherwise.
    ``GTPU_ROOFLINE_PEAK_GBPS`` overrides everything — used by golden
    tests for determinism and by operators whose parts differ."""
    env = os.environ.get("GTPU_ROOFLINE_PEAK_GBPS", "").strip()
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            pass
    link = _link()
    if backend is None:
        backend = str(link.get("backend", "cpu"))
    if backend == "gpu":
        return card_peak_gbps(int(link.get("index", 0)))
    return _PEAKS.get(backend, _PEAKS["cpu"])


def account(led: dict, duration_ms: Optional[float] = None,
            peak: Optional[float] = None) -> Optional[dict]:
    """Fold a ledger snapshot/diff dict into roofline terms.

    Returns None when the ledger moved no bytes or recorded no usable
    time window — host-only statements (DDL, information_schema) have
    no meaningful bandwidth and must not stamp a misleading zero.
    """
    bytes_total = 0.0
    for k in BYTE_KEYS:
        try:
            bytes_total += float(led.get(k, 0) or 0)
        except (TypeError, ValueError):
            continue
    ms = led.get("device_ms") or led.get("agg_ms") or duration_ms
    try:
        ms = float(ms) if ms is not None else 0.0
    except (TypeError, ValueError):
        ms = 0.0
    if bytes_total <= 0 or ms <= 0:
        return None
    gbps = bytes_total / (ms / 1e3) / 1e9
    if peak is None:
        peak = peak_gbps()
    try:
        rows = float(led.get("rows_scanned", 0) or 0)
    except (TypeError, ValueError):
        rows = 0.0
    return {
        "achieved_gbps": gbps,
        "roofline_fraction": gbps / peak if peak > 0 else 0.0,
        "arithmetic_intensity": (_EST_FLOPS_PER_ROW * rows) / bytes_total,
        "bytes_total": int(bytes_total),
        "window_ms": ms,
        "peak_gbps": peak,
    }


def stamp(attrs: dict, led: dict,
          duration_ms: Optional[float] = None) -> Optional[dict]:
    """account() + write the two headline numbers into a span's attrs.

    The full fold is returned so callers (slow-query records, ANALYZE)
    can surface the supporting terms too.
    """
    rf = account(led, duration_ms)
    if rf is not None:
        attrs["achieved_gbps"] = round(rf["achieved_gbps"], 6)
        attrs["roofline_fraction"] = round(rf["roofline_fraction"], 9)
    return rf


def format_line(rf: dict) -> str:
    """One ANALYZE-style text line for a fold, stable for tooling."""
    return (f"achieved_gbps={rf['achieved_gbps']:.6g} "
            f"roofline_fraction={rf['roofline_fraction']:.6g} "
            f"arithmetic_intensity={rf['arithmetic_intensity']:.6g} "
            f"bytes={rf['bytes_total']} window_ms={rf['window_ms']:.6g} "
            f"peak_gbps={rf['peak_gbps']:g}")
