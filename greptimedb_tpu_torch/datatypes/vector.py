"""Column vectors. Mirrors the reference's Vector hierarchy
(src/datatypes/src/vectors.rs:88) but collapsed to two host representations:

- plain numpy arrays (numeric/timestamp/bool), nullable via a separate mask
- `DictVector` for strings/tags: int32 codes + a value table. The device
  kernel ABI only ever sees the codes (SURVEY.md §7: dictionary-encoded tag
  ids end-to-end, matching mito2's dictionary-encoded primary keys,
  reference sst/parquet/format.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass
class DictVector:
    """Dictionary-encoded string column: codes[i] indexes values.

    code -1 encodes NULL.
    """

    codes: np.ndarray  # int32 [N]
    values: np.ndarray  # object/str [K]

    def __post_init__(self):
        self.codes = np.asarray(self.codes, dtype=np.int32)
        self.values = np.asarray(self.values, dtype=object)

    def __len__(self) -> int:
        return len(self.codes)

    def decode(self) -> np.ndarray:
        """Materialize the string values (host-side, edges only)."""
        out = np.empty(len(self.codes), dtype=object)
        valid = self.codes >= 0
        out[valid] = self.values[self.codes[valid]]
        out[~valid] = None
        return out

    def take(self, indices: np.ndarray) -> "DictVector":
        return DictVector(self.codes[indices], self.values)

    def compact(self) -> "DictVector":
        """Shrink the dictionary to the values the codes actually use
        (NULL codes preserved). The partition write scatter calls this
        per region slice: without it every region's tag registry learns
        every OTHER region's series too, which silently disables any
        optimization that reasons over the registry's value set
        (lastpoint's newest-first termination waits forever for series
        that can never appear in that region)."""
        used = np.unique(self.codes)
        used = used[used >= 0]
        if len(used) == len(self.values):
            return self
        remap = np.full(len(self.values) + 1, -1, dtype=np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        # index -1 hits the sentinel slot (remap[-1] == last) — keep
        # NULLs NULL by writing the sentinel last
        remap[-1] = -1
        return DictVector(remap[self.codes], self.values[used])

    @staticmethod
    def encode(strings: Sequence, values: Optional[np.ndarray] = None) -> "DictVector":
        """Encode a sequence of strings (None == NULL) against an optional
        pre-existing dictionary; new values are appended. Vectorized via
        np.unique — only distinct values touch Python."""
        arr = np.asarray(strings, dtype=object)
        table: dict = {}
        vals: list = []
        if values is not None:
            vals = list(values)
            table = {v: i for i, v in enumerate(vals)}
        if len(arr) == 0:
            return DictVector(np.empty(0, np.int32), np.asarray(vals, dtype=object))
        null_mask = np.frompyfunc(lambda x: x is None, 1, 1)(arr).astype(bool)
        codes = np.full(len(arr), -1, dtype=np.int32)
        present = ~null_mask
        if present.any():
            uniq, inv = np.unique(arr[present].astype(str), return_inverse=True)
            mapping = np.empty(len(uniq), dtype=np.int32)
            for i, s in enumerate(uniq):
                code = table.get(s)
                if code is None:
                    code = len(vals)
                    table[s] = code
                    vals.append(s)
                mapping[i] = code
            codes[present] = mapping[inv]
        return DictVector(codes, np.asarray(vals, dtype=object))

    def remap(self, mapping: np.ndarray) -> "DictVector":
        """Rewrite codes through `mapping` (old code -> new code), used when
        merging per-SST dictionaries into a region-global dictionary."""
        return DictVector(remap_codes(self.codes, mapping), self.values)


def remap_codes(codes: np.ndarray, mapping: np.ndarray) -> np.ndarray:
    """codes -> mapping[codes] with NULL (-1) preserved. Safe for an empty
    mapping — an all-NULL tag column has an empty dictionary, and indexing
    an empty array even with clipped codes raises."""
    codes = np.asarray(codes)
    if mapping.size == 0:
        return np.full(len(codes), -1, dtype=np.int32)
    return np.where(codes >= 0,
                    mapping[np.clip(codes, 0, None)], -1).astype(np.int32)
