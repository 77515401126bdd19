"""Region manifest: a JSON action log with periodic checkpoints (copy of
greptimedb_tpu/storage/manifest.py under the port's format stamp).

Every mutation of the region's file set or schema is an action appended
as `<version>.json`; every `CHECKPOINT_DISTANCE` actions a full
checkpoint is written and older deltas are pruned. Region open replays
checkpoint + deltas, then the WAL from `flushed_seq`.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.objectstore import default_store
from greptimedb_tpu_torch.storage.format import FORMAT_VERSIONS, check_version
from greptimedb_tpu_torch.storage.sst import FileMeta

CHECKPOINT_DISTANCE = 10
_DELTA_RE = re.compile(r"^(\d{10})\.json$")


@dataclass
class RegionManifestState:
    """Replayed manifest state."""

    schema: Optional[Schema] = None
    files: dict[str, FileMeta] = field(default_factory=dict)
    flushed_seq: int = 0  # WAL entries below this are obsolete
    manifest_version: int = 0
    tag_dicts: dict[str, list] = field(default_factory=dict)

    def apply(self, action: dict) -> None:
        check_version("torch.manifest", action.get("format", 1),
                      "manifest action")
        kind = action["kind"]
        if kind == "change":
            self.schema = Schema.from_dict(action["schema"])
        elif kind == "edit":
            for f in action.get("files_to_add", []):
                fm = FileMeta.from_dict(f)
                self.files[fm.file_id] = fm
            for fid in action.get("files_to_remove", []):
                self.files.pop(fid, None)
            if action.get("flushed_seq") is not None:
                self.flushed_seq = max(self.flushed_seq,
                                       action["flushed_seq"])
            if action.get("tag_dicts") is not None:
                self.tag_dicts = action["tag_dicts"]
        elif kind == "truncate":
            self.files.clear()
            self.flushed_seq = max(self.flushed_seq,
                                   action.get("truncated_seq",
                                              self.flushed_seq))
        elif kind == "checkpoint":
            self.schema = Schema.from_dict(action["schema"]) \
                if action.get("schema") else None
            self.files = {f["file_id"]: FileMeta.from_dict(f)
                          for f in action["files"]}
            self.flushed_seq = action["flushed_seq"]
            self.tag_dicts = action.get("tag_dicts", {})
        else:
            raise ValueError(f"unknown manifest action {kind!r}")


class ManifestManager:
    def __init__(self, manifest_dir: str, store=None):
        self.dir = manifest_dir
        self.store = default_store(store)
        self.state = RegionManifestState()
        self._replay()

    # ---- replay ------------------------------------------------------------

    def _versions(self) -> list[int]:
        out = []
        for key in self.store.list(self.dir + os.sep):
            m = _DELTA_RE.match(os.path.basename(key))
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _replay(self) -> None:
        for v in self._versions():
            self.state.apply(json.loads(self.store.read(self._path(v))))
            self.state.manifest_version = v

    def _path(self, version: int) -> str:
        return os.path.join(self.dir, f"{version:010d}.json")

    # ---- append ------------------------------------------------------------

    def append(self, action: dict) -> None:
        action.setdefault("format", FORMAT_VERSIONS["torch.manifest"])
        v = self.state.manifest_version + 1
        # FsStore.write is atomic (tmp + rename)
        self.store.write(self._path(v), json.dumps(action).encode())
        self.state.apply(action)
        self.state.manifest_version = v
        if v % CHECKPOINT_DISTANCE == 0:
            self._checkpoint()

    def _checkpoint(self) -> None:
        st = self.state
        action = {
            "format": FORMAT_VERSIONS["torch.manifest"],
            "kind": "checkpoint",
            "schema": st.schema.to_dict() if st.schema else None,
            "files": [f.to_dict() for f in st.files.values()],
            "flushed_seq": st.flushed_seq,
            "tag_dicts": st.tag_dicts,
        }
        v = st.manifest_version + 1
        self.store.write(self._path(v), json.dumps(action).encode())
        st.manifest_version = v
        for old in self._versions():
            if old < v:
                self.store.delete(self._path(old))

    def destroy(self) -> None:
        """Delete every delta and checkpoint (DROP, TRUNCATE)."""
        for v in self._versions():
            self.store.delete(self._path(v))
        self.state = RegionManifestState()

    # ---- convenience -------------------------------------------------------

    def record_schema(self, schema: Schema) -> None:
        self.append({"kind": "change", "schema": schema.to_dict()})

    def record_flush(self, added: list[FileMeta], flushed_seq: Optional[int],
                     tag_dicts: dict[str, list],
                     removed: Optional[list[str]] = None) -> None:
        """Record a file-set edit. `flushed_seq` must be None unless the
        memtable was persisted up to that sequence: replay skips WAL
        entries below it, so a compaction edit passing next_seq here
        would drop unflushed acknowledged writes on the next open."""
        self.append({
            "kind": "edit",
            "files_to_add": [f.to_dict() for f in added],
            "files_to_remove": removed or [],
            "flushed_seq": flushed_seq,
            "tag_dicts": tag_dicts,
        })
