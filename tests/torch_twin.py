"""Twins of the JAX package's test classes for the port.

`twin(path, names)` reads a JAX test module's source, points its imports
at `greptimedb_tpu_torch`, gives every Cluster / RegionEngine /
QueryEngine it builds `device="cpu"`, and runs it as a module of its
own. The named test classes and fixtures come back, to be bound into a
port test module's globals: pytest collects them there, so each JAX test
runs once more, unchanged, against the port.
"""

from __future__ import annotations

import os
import re
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

_SUBS = (
    # the port runs on the card unless told otherwise
    (r"Cluster\(str\(tmp_path\)", 'Cluster(str(tmp_path), device="cpu"'),
    (r"RegionEngine\(EngineConfig\(data_dir=str\(tmp_path / \"d\"\)\)\)",
     'RegionEngine(EngineConfig(data_dir=str(tmp_path / "d")), '
     'device="cpu")'),
    (r"QueryEngine\(Catalog\(MemoryKv\(\)\), engine\)",
     'QueryEngine(Catalog(MemoryKv()), engine, device="cpu")'),
    (r"\bgreptimedb_tpu\.", "greptimedb_tpu_torch."),
    (r"from greptimedb_tpu import", "from greptimedb_tpu_torch import"),
    # the port's own tests are collected by tier-1 whole
    (r"(?m)^[ \t]*@pytest\.mark\.slow\n", ""),
)


def twin(filename: str, names, subs=()) -> dict:
    """{name: object} of the JAX test module `tests/<filename>` rewritten
    for the port (`subs`: extra (pattern, replacement) pairs)."""
    path = os.path.join(ROOT, filename)
    with open(path) as f:
        src = f.read()
    for pat, rep in tuple(_SUBS) + tuple(subs):
        src = re.sub(pat, rep, src)
    assert "greptimedb_tpu." not in src.replace("greptimedb_tpu_torch.", "")
    mod = types.ModuleType(f"torch_twin_{filename[:-3]}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return {name: getattr(mod, name) for name in names}
