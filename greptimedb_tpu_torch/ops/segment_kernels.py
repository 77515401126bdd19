"""Hand-written CUDA segment-reduction kernels and their plain versions.

Port of greptimedb_tpu/ops/pallas_segment.py, whose two Pallas TPU
kernels carry the dense aggregation path:

- `segment_sum` replaces `pallas_dense_segment_sum` (kernel `_kernel`):
  out[G, W] = per-group row sums of a prepared [values | validity | ones]
  plane (csrc/segment_sum.cu).
- `fused_segment_agg` replaces `pallas_fused_segment_agg` (kernel
  `_fused_kernel`): sum, count, rows and optional min, max and sum of
  squares straight from raw values, NaN as SQL NULL
  (csrc/fused_segment_agg.cu).

The TPU kernels are one-hot matmuls shaped for the MXU, which brings the
4096-segment cap, the field caps and the finite-values contract. The CUDA
kernels reduce by segment directly and have none of those.

Contract shared by kernel and plain version: ids are int32 group ids, the
last segment G-1 is the dead segment that masked and padding rows go to,
and rows in it (or with an id outside [0, G-1)) are skipped. The output
keeps segment G-1 at zero sums and counts and +-inf extremes; every
caller slices it away.

Each wrapper runs the plain PyTorch version only for tensors on the CPU.
On a CUDA tensor it launches its kernel or raises. `launches` on each
wrapper counts kernel launches and nothing else, under a lock, so
concurrent request threads lose no count; `thread_launches()` gives the
calling thread's own launches, counted at the same place (a datanode's
fragment span reports its K2 launches from them).
"""

from __future__ import annotations

import functools
import threading

import torch

from greptimedb_tpu_torch.utils.metrics import PALLAS_DISPATCHES

_FLOATS = (torch.float32, torch.float64)


def _check(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
           what: str) -> None:
    if values.dtype not in _FLOATS:
        raise TypeError(f"{what}: values must be float32 or float64, "
                        f"got {values.dtype}")
    if values.dim() != 2:
        raise ValueError(f"{what}: values must be [N, W], got "
                         f"{tuple(values.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"{what}: ids must be a 1-d int32 tensor, got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    if ids.shape[0] != values.shape[0]:
        raise ValueError(f"{what}: {ids.shape[0]} ids for "
                         f"{values.shape[0]} rows")
    if ids.device != values.device:
        raise ValueError(f"{what}: ids on {ids.device}, values on "
                         f"{values.device}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {values.device}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if not 1 <= num_segments < 2 ** 31:
        raise ValueError(f"{what}: num_segments {num_segments} out of range")
    if values.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: {values.shape[0]} rows overflow the "
                         "int32 counts")


def _live(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_segments - 1)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


#: the launch counts are read-modify-writes from every request thread of
#: a server: without the lock two concurrent launches can count once
_count_lock = threading.Lock()
#: the calling thread's own launches (K1, K2): a span reads the delta
#: over its body, exact while other threads launch too
_thread_counts = threading.local()


def thread_launches() -> tuple[int, int]:
    """(K1, K2) launches made by the calling thread so far."""
    return (getattr(_thread_counts, "k1", 0),
            getattr(_thread_counts, "k2", 0))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


# ---- K1: dense segment sum -------------------------------------------------


def segment_sum_plain(plane: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain version of `segment_sum`: `index_add_` of the live rows into
    a [G, W] zero tensor."""
    live = _live(ids, num_segments)
    out = torch.zeros((num_segments, plane.shape[1]), dtype=plane.dtype,
                      device=plane.device)
    out.index_add_(0, ids[live], plane[live])
    return out


def segment_sum(plane: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[g, :] = sum of plane[i, :] over rows with ids[i] == g, for
    g < num_segments - 1; row num_segments - 1 (the dead segment) is 0.
    Any G: the kernel has no segment cap."""
    _check(plane, ids, num_segments, "segment_sum")
    if plane.device.type == "cpu":
        return segment_sum_plain(plane, ids, num_segments)
    from greptimedb_tpu_torch.ops import _build

    lib = _build.library()
    out = torch.zeros((num_segments, plane.shape[1]), dtype=plane.dtype,
                      device=plane.device)
    n = plane.shape[0]
    if n:
        rc = lib.gtpu_segment_sum(
            plane.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
            plane.shape[1], num_segments,
            int(plane.dtype == torch.float64), _stream(plane.device))
        _raise_on(rc, "segment_sum")
        with _count_lock:
            segment_sum.launches += 1
        _thread_counts.k1 = getattr(_thread_counts, "k1", 0) + 1
        PALLAS_DISPATCHES.inc(kernel="segment_sum")
    return out


segment_sum.launches = 0


# ---- K2: fused masked segment aggregation ----------------------------------

# K2's outputs live in one buffer a call, carved into planes (the same rule
# as csrc/fused_segment_agg.cu::carve): first the value-typed planes, in the
# order sum | sumsq? | min? | max?, G*F each; then the int32 planes, count
# (G*F) and rows (G). Every plane starts 16-byte aligned. The kernel's C
# entry writes the identities (0, +inf, -inf) itself, so the buffer is
# allocated with torch.empty and never filled from Python.
_FLAG_MIN, _FLAG_MAX, _FLAG_SUMSQ = 1, 2, 4
_KEY_ORDER = ("sum", "count", "rows", "min", "max", "sumsq")  # dict order


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


@functools.lru_cache(maxsize=256)
def _layout(g: int, f: int, es: int, flags: int):
    """(buffer length in value elements, [(name, is_int, offset in its
    dtype's elements, shape, stride)]) for one call's output buffer."""
    cells = g * f
    vplane = _align16(cells * es)
    names = ["sum"] + [k for k, bit in (("sumsq", _FLAG_SUMSQ),
                                        ("min", _FLAG_MIN),
                                        ("max", _FLAG_MAX)) if flags & bit]
    views = [(k, False, i * vplane // es, (g, f), (f, 1))
             for i, k in enumerate(names)]
    ints = len(names) * vplane
    views.append(("count", True, ints // 4, (g, f), (f, 1)))
    rows = ints + _align16(cells * 4)
    views.append(("rows", True, rows // 4, (g,), (1,)))
    views.sort(key=lambda v: _KEY_ORDER.index(v[0]))
    return _align16(rows + g * 4) // es, tuple(views)


def _fused_buffer(vals, num_segments, flags):
    """One uninitialized buffer in the layout above, and its views' spec."""
    n_elems, views = _layout(num_segments, vals.shape[1],
                             vals.element_size(), flags)
    return torch.empty(n_elems, dtype=vals.dtype, device=vals.device), views


def _fused_views(buf, views) -> dict:
    """The output dict: views of `buf`. Of the ways measured on the card
    (PERF.md, K2 host cost), as_strided is the cheapest."""
    ibuf = buf.view(torch.int32)
    return {k: (ibuf if is_int else buf).as_strided(shape, stride, off)
            for k, is_int, off, shape, stride in views}


def _fused_outputs(vals, num_segments, flags):
    """One uninitialized buffer and its views."""
    buf, views = _fused_buffer(vals, num_segments, flags)
    return buf, _fused_views(buf, views)


def _flags(want_min: bool, want_max: bool, want_sumsq: bool) -> int:
    return (_FLAG_MIN * bool(want_min) | _FLAG_MAX * bool(want_max)
            | _FLAG_SUMSQ * bool(want_sumsq))


def fused_segment_agg_plain(vals: torch.Tensor, ids: torch.Tensor,
                            num_segments: int, want_min: bool = False,
                            want_max: bool = False,
                            want_sumsq: bool = False) -> dict:
    """Plain version of `fused_segment_agg`: identities written with torch
    fills into the kernel's buffer layout, `index_add_` for sum, count,
    rows and sumsq, `scatter_reduce_` amin/amax. Neither call skips NaN,
    so NaN is masked first."""
    _, out = _fused_outputs(vals, num_segments,
                            _flags(want_min, want_max, want_sumsq))
    for k, x in out.items():
        x.fill_({"min": float("inf"), "max": float("-inf")}.get(k, 0))
    live = _live(ids, num_segments)
    v, i = vals[live], ids[live].long()
    valid = ~torch.isnan(v)
    z = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))
    out["sum"].index_add_(0, i, z)
    out["count"].index_add_(0, i, valid.to(torch.int32))
    out["rows"].index_add_(0, i, torch.ones_like(i, dtype=torch.int32))
    idx = i[:, None].expand(-1, vals.shape[1])
    if want_min:
        out["min"].scatter_reduce_(
            0, idx, torch.where(valid, v, float("inf")), "amin",
            include_self=True)
    if want_max:
        out["max"].scatter_reduce_(
            0, idx, torch.where(valid, v, float("-inf")), "amax",
            include_self=True)
    if want_sumsq:
        out["sumsq"].index_add_(0, i, z * z)
    return out


_fused_entry = None  # the bound C entry, after the first call on the card


def fused_segment_agg(vals: torch.Tensor, ids: torch.Tensor,
                      num_segments: int, want_min: bool = False,
                      want_max: bool = False,
                      want_sumsq: bool = False) -> dict:
    """{"sum" [G, F], "count" [G, F] int32, "rows" [G] int32, and on
    request "min"/"max" [G, F] (NaN skipped, +-inf for an empty group)
    and "sumsq" [G, F]} over the live rows (ids in [0, G-1)).

    On the card one call makes one allocation and one ctypes call, which
    launches two kernels: the identities, then the aggregation."""
    global _fused_entry
    _check(vals, ids, num_segments, "fused_segment_agg")
    if vals.device.type == "cpu":
        return fused_segment_agg_plain(vals, ids, num_segments, want_min,
                                       want_max, want_sumsq)
    if _fused_entry is None:
        from greptimedb_tpu_torch.ops import _build

        _fused_entry = _build.library().gtpu_fused_segment_agg
    flags = _flags(want_min, want_max, want_sumsq)
    buf, views = _fused_buffer(vals, num_segments, flags)
    rc = _fused_entry(vals.data_ptr(), ids.data_ptr(), vals.shape[0],
                      vals.shape[1], num_segments,
                      int(vals.dtype == torch.float64), flags,
                      buf.data_ptr(), _stream(vals.device))
    _raise_on(rc, "fused_segment_agg")
    with _count_lock:
        fused_segment_agg.launches += 1
    _thread_counts.k2 = getattr(_thread_counts, "k2", 0) + 1
    PALLAS_DISPATCHES.inc(kernel="fused_agg")
    return _fused_views(buf, views)  # after the launch: host work only


fused_segment_agg.launches = 0
