"""Fixed-shape column blocks.

XLA traces/compiles once per shape; ragged scan output must therefore be
padded into a small set of block shapes. We bucket row counts to powers of
two (floor 1024, cap via streaming in the scan layer), so a region scan
compiles at most ~20 kernel variants regardless of data size. The validity
mask rides alongside the data; kernels never compact (dynamic shapes) —
they mask.
"""

from __future__ import annotations

import math

import numpy as np

MIN_BLOCK_ROWS = 1024
# Streaming block cap: few dispatches per query (round-trips dominate on
# remote-attached devices) while keeping kernel temporaries ([block, F]
# stacked values + element masks) well under HBM: 2^23 rows x 10 f32
# fields ~= 335 MiB per temporary.
DEFAULT_BLOCK_ROWS = 1 << 23
_COARSE = 1 << 20


def block_size_for(n: int, min_rows: int = MIN_BLOCK_ROWS) -> int:
    """Block shape bucket for n rows: powers of two up to 1M rows, then
    multiples of 1M (pow2 padding wastes up to 2x at scan scale; 1M-step
    buckets keep the jit cache small AND the padding <6%)."""
    if n <= min_rows:
        return min_rows
    if n >= _COARSE:
        return ((n + _COARSE - 1) // _COARSE) * _COARSE
    return 1 << math.ceil(math.log2(n))


def pad_rows(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    """Pad axis 0 of `arr` to `size` with `fill`."""
    n = arr.shape[0]
    if n == size:
        return arr
    assert n < size, (n, size)
    pad_width = [(0, size - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)

