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
wrapper counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

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
        segment_sum.launches += 1
    return out


segment_sum.launches = 0


# ---- K2: fused masked segment aggregation ----------------------------------


def _fused_outputs(vals, num_segments, want_min, want_max, want_sumsq):
    g, f = num_segments, vals.shape[1]
    kw = {"dtype": vals.dtype, "device": vals.device}
    out = {
        "sum": torch.zeros((g, f), **kw),
        "count": torch.zeros((g, f), dtype=torch.int32, device=vals.device),
        "rows": torch.zeros(g, dtype=torch.int32, device=vals.device),
    }
    if want_min:
        out["min"] = torch.full((g, f), float("inf"), **kw)
    if want_max:
        out["max"] = torch.full((g, f), float("-inf"), **kw)
    if want_sumsq:
        out["sumsq"] = torch.zeros((g, f), **kw)
    return out


def fused_segment_agg_plain(vals: torch.Tensor, ids: torch.Tensor,
                            num_segments: int, want_min: bool = False,
                            want_max: bool = False,
                            want_sumsq: bool = False) -> dict:
    """Plain version of `fused_segment_agg`: `index_add_` for sum, count,
    rows and sumsq, `scatter_reduce_` amin/amax into +-inf-filled planes.
    Neither call skips NaN, so NaN is masked first."""
    out = _fused_outputs(vals, num_segments, want_min, want_max, want_sumsq)
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


def fused_segment_agg(vals: torch.Tensor, ids: torch.Tensor,
                      num_segments: int, want_min: bool = False,
                      want_max: bool = False,
                      want_sumsq: bool = False) -> dict:
    """{"sum" [G, F], "count" [G, F] int32, "rows" [G] int32, and on
    request "min"/"max" [G, F] (NaN skipped, +-inf for an empty group)
    and "sumsq" [G, F]} over the live rows (ids in [0, G-1))."""
    _check(vals, ids, num_segments, "fused_segment_agg")
    if vals.device.type == "cpu":
        return fused_segment_agg_plain(vals, ids, num_segments, want_min,
                                       want_max, want_sumsq)
    from greptimedb_tpu_torch.ops import _build

    lib = _build.library()
    out = _fused_outputs(vals, num_segments, want_min, want_max, want_sumsq)
    n = vals.shape[0]
    if n:
        def ptr(k):
            return out[k].data_ptr() if k in out else None

        rc = lib.gtpu_fused_segment_agg(
            vals.data_ptr(), ids.data_ptr(), n, vals.shape[1], num_segments,
            int(vals.dtype == torch.float64), ptr("sum"), ptr("count"),
            ptr("rows"), ptr("min"), ptr("max"), ptr("sumsq"),
            _stream(vals.device))
        _raise_on(rc, "fused_segment_agg")
        fused_segment_agg.launches += 1
    return out


fused_segment_agg.launches = 0
