"""On-disk format stamp of the port (counterpart of
greptimedb_tpu/storage/format.py).

The port writes its own encodings (numpy buffers, not Arrow IPC or
Parquet), so a data dir belongs to exactly one package. `FORMAT.json` at
the data-dir root names the format and the versions of its components:

    {"format": "greptimedb_tpu_torch", "versions": {"torch.wal": 1, ...}}

The port refuses a dir stamped by another format (the JAX package's
stamp carries no format name), a dir stamped with newer versions than it
reads, and an unstamped dir that already holds data. The version keys
are names the JAX package does not know; its own check counts unknown
keys as newer versions, so it refuses the port's dirs in turn.
"""

from __future__ import annotations

import json
import os

FORMAT_NAME = "greptimedb_tpu_torch"

#: current writer versions, per component
FORMAT_VERSIONS = {"torch.layout": 1, "torch.sst": 1, "torch.wal": 1,
                   "torch.manifest": 1}

_STAMP = "FORMAT.json"


class FormatError(RuntimeError):
    """Data dir written by another package or by a newer build."""


def check_and_stamp(data_dir: str) -> dict:
    """Validate `data_dir`'s stamp against this build and (re)write it.
    Returns the versions the dir was written with."""
    path = os.path.join(data_dir, _STAMP)
    found = dict(FORMAT_VERSIONS)
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                stamp = json.load(f)
        except (OSError, ValueError) as e:
            raise FormatError(f"unreadable format stamp {path}: {e}") from e
        if stamp.get("format") != FORMAT_NAME:
            raise FormatError(
                f"data dir {data_dir} holds format "
                f"{stamp.get('format', 'greptimedb_tpu')!r}, not "
                f"{FORMAT_NAME!r}; the packages do not read each other's "
                "files")
        found.update(stamp.get("versions", {}))
    elif any(n != _STAMP for n in os.listdir(data_dir)):
        raise FormatError(
            f"data dir {data_dir} holds files but no {_STAMP} stamp; it "
            f"was not written by {FORMAT_NAME}")
    newer = {k: v for k, v in found.items()
             if v > FORMAT_VERSIONS.get(k, 0)}
    if newer:
        raise FormatError(
            f"data dir {data_dir} was written by a newer build "
            f"({newer}); this build supports {FORMAT_VERSIONS}")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"format": FORMAT_NAME, "versions": FORMAT_VERSIONS}, f)
    os.replace(tmp, path)
    return found


def check_version(component: str, version: int, what: str) -> None:
    """Refuse a file stamped with a newer `component` version."""
    if version > FORMAT_VERSIONS[component]:
        raise FormatError(
            f"{what} has {component} format v{version}; this build reads "
            f"<= v{FORMAT_VERSIONS[component]}")
