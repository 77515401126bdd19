"""Runtime configuration of the port (counterpart of
greptimedb_tpu/config.py): the device every tensor lives on, the compute
dtype of field values inside kernels, and the dense group budget.

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
    [G, F] planes. Beyond it the JAX package runs its sparse
    sort-compact path, which the port does not have yet."""
    return int(os.environ.get("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", str(1 << 20)))


def device_cache_bytes(dev: torch.device) -> int:
    """Byte budget of the device hot set (query/device_cache.py)."""
    env = os.environ.get("GREPTIMEDB_TPU_DEVICE_CACHE_BYTES")
    if env:
        return int(env)
    if dev.type == "cuda":
        # half the card: the rest holds kernel temporaries and outputs
        return torch.cuda.get_device_properties(dev).total_memory // 2
    return 4 << 30
