"""Runtime configuration of the port (counterpart of
greptimedb_tpu/config.py): the device every tensor lives on, the compute
dtype of field values inside kernels, the group budgets of the dense
and sparse aggregation routes, and the streaming route's threshold and
block shape.

The device is explicit: entry points take `device=` and carry it down to
every tensor they make. `None` means the CUDA card; a missing card raises
instead of dropping to the CPU, which only an explicit `device="cpu"`
selects (the tests do).
"""

from __future__ import annotations

import os

import torch


def device(name=None) -> torch.device:
    """The device a query engine runs on: `name` (e.g. "cpu", "cuda:0"),
    or the CUDA card when None. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "greptimedb_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the host")
    return dev


def compute_dtype(dev: torch.device) -> torch.dtype:
    """Float dtype of field values inside the kernels: f32 on the
    accelerator, f64 on the CPU so results are bit-comparable with numpy
    oracles in tests (the JAX package's rule, config.py:20-30).

    Override with GREPTIMEDB_TPU_COMPUTE_DTYPE=float32|float64."""
    env = os.environ.get("GREPTIMEDB_TPU_COMPUTE_DTYPE")
    if env:
        dt = getattr(torch, env, None)
        if dt not in (torch.float32, torch.float64):
            raise ValueError(
                f"GREPTIMEDB_TPU_COMPUTE_DTYPE={env!r}: the port computes "
                "in float32 or float64")
        return dt
    return torch.float64 if dev.type == "cpu" else torch.float32


def dense_groups_max() -> int:
    """Largest dense group-id product the aggregate materializes as
    [G, F] planes (1M groups x 10 fields). Beyond it the sparse
    sort-compact route runs (ops/sparse_segment.py)."""
    return int(os.environ.get("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", str(1 << 20)))


def sparse_groups_max() -> int:
    """Cap on *observed* distinct groups in the sparse aggregate route
    (output planes are [U, F]); a query observing more raises."""
    return int(os.environ.get("GREPTIMEDB_TPU_SPARSE_GROUPS_MAX", str(1 << 22)))


def sparse_groups_min() -> int:
    """Key products at or above this ALSO take the sparse route even when
    they fit the dense budget (0 = off, the default: dense wins while its
    planes fit)."""
    return int(os.environ.get("GREPTIMEDB_TPU_SPARSE_GROUPS_MIN", "0"))


def device_cache_bytes(dev: torch.device) -> int:
    """Byte budget of the device hot set (query/device_cache.py)."""
    env = os.environ.get("GREPTIMEDB_TPU_DEVICE_CACHE_BYTES")
    if env:
        return int(env)
    if dev.type == "cuda":
        # half the card: the rest holds kernel temporaries and outputs
        return torch.cuda.get_device_properties(dev).total_memory // 2
    return 4 << 30


def stream_threshold_rows() -> int:
    """Aggregate scans of append-mode tables at or above this row
    estimate take the streaming route: lazy SST chunks become fixed-shape
    device blocks folded into an accumulator on the device, so the scan
    is never materialized on the host (query/physical.py,
    `_execute_agg_stream`). Below it the materialized route keeps
    file-anchored blocks in the hot set across repeated queries."""
    return int(os.environ.get("GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS",
                              str(32 << 20)))


def stream_block_rows() -> int:
    """Rows of one streamed device block (the padded block shape)."""
    return int(os.environ.get("GREPTIMEDB_TPU_STREAM_BLOCK_ROWS",
                              str(2 << 20)))


def default_hash_partitions() -> int:
    """Hash-partition count for cluster CREATE TABLE without an explicit
    PARTITION clause ([partition] default_hash_regions); 0 or 1 = one
    region (the standalone default)."""
    return int(os.environ.get("GREPTIMEDB_TPU_DEFAULT_HASH_REGIONS", "0"))


def hash_partition_columns() -> list:
    """Columns for default hash partitioning ([partition] hash_columns,
    comma-separated); empty = the table's leading tag column."""
    env = os.environ.get("GREPTIMEDB_TPU_HASH_PARTITION_COLUMNS", "")
    return [s.strip() for s in env.split(",") if s.strip()]
