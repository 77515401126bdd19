"""The port's boundaries: greptimedb_tpu_torch and chip_smoke.py import
nothing of JAX or of the JAX package (and no top-level pyarrow); engines
run on CUDA unless asked for the CPU and raise when CUDA is absent; the
hot set makes a warm repeat upload nothing; statements outside this
slice raise a typed error."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch import config
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine, UnsupportedStatement
from greptimedb_tpu_torch.query.expr import PlanError
from greptimedb_tpu_torch.storage import RegionEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "greptimedb_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return out


def _imports(tree):
    """(module, top_level) for every import in the file."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_no_jax_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for mod, top_level in _imports(tree):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "greptimedb_tpu"), (path, mod)
        assert not (root == "pyarrow" and top_level), (path, mod)


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import greptimedb_tpu_torch.query, "
            "greptimedb_tpu_torch.interop, greptimedb_tpu_torch.storage; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'greptimedb_tpu', 'pyarrow')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _engine(device="cpu"):
    return QueryEngine(Catalog(MemoryKv()), RegionEngine(), device=device)


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryEngine(Catalog(MemoryKv()), RegionEngine())
    with pytest.raises(RuntimeError):
        config.device("cuda:0")
    assert _engine().device == torch.device("cpu")


def test_compute_dtype_follows_device_and_env(monkeypatch):
    monkeypatch.delenv("GREPTIMEDB_TPU_COMPUTE_DTYPE", raising=False)
    assert config.compute_dtype(torch.device("cpu")) == torch.float64
    assert config.compute_dtype(torch.device("cuda")) == torch.float32
    monkeypatch.setenv("GREPTIMEDB_TPU_COMPUTE_DTYPE", "float32")
    assert config.compute_dtype(torch.device("cpu")) == torch.float32
    monkeypatch.setenv("GREPTIMEDB_TPU_COMPUTE_DTYPE", "bfloat16")
    with pytest.raises(ValueError):
        config.compute_dtype(torch.device("cpu"))


def _cpu_table(qe, n_hosts=4, points=50):
    qe.execute_one("CREATE TABLE cpu (host STRING, ts TIMESTAMP(3) NOT NULL, "
                   "u DOUBLE, s DOUBLE, TIME INDEX (ts), PRIMARY KEY (host)) "
                   "WITH (append_mode = 'true')")
    rows = []
    rng = np.random.default_rng(1)
    for p in range(points):
        for h in range(n_hosts):
            rows.append(f"('h{h}', {p * 10_000}, {rng.uniform(0, 100):.3f}, "
                        f"{rng.uniform(0, 100):.3f})")
    qe.execute_one("INSERT INTO cpu VALUES " + ", ".join(rows))


def test_warm_repeat_uploads_nothing():
    qe = _engine()
    _cpu_table(qe)
    sql = ("SELECT date_bin(INTERVAL '1 minute', ts) AS m, host, avg(u), "
           "max(s) FROM cpu GROUP BY m, host ORDER BY m, host")
    first = qe.execute_one(sql).rows()
    cache = qe.executor.cache
    uploaded = cache.h2d_bytes
    assert uploaded > 0 and cache.resident_bytes > 0
    assert qe.execute_one(sql).rows() == first
    assert cache.h2d_bytes == uploaded
    assert cache.hits > 0
    # a write retires the region's older blocks on the next upload
    qe.execute_one("INSERT INTO cpu VALUES ('h0', 999000, 1.0, 2.0)")
    qe.execute_one(sql)
    assert cache.h2d_bytes > uploaded
    assert cache.resident_bytes <= 2 * uploaded


def test_drop_table_frees_region_and_blocks():
    qe = _engine()
    _cpu_table(qe)
    qe.execute_one("SELECT host, sum(u) FROM cpu GROUP BY host")
    assert qe.executor.cache.resident_bytes > 0
    qe.execute_one("DROP TABLE cpu")
    assert qe.executor.cache.resident_bytes == 0
    assert qe.region_engine.regions == {}
    _cpu_table(qe)  # the name is free again
    assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[200]]


@pytest.mark.parametrize("sql", [
    "ALTER TABLE cpu ADD COLUMN x DOUBLE",
    "SHOW TABLES",
    "DELETE FROM cpu WHERE host = 'h0'",
    "TQL EVAL (0, 10, '5s') up",
    "SELECT a.u FROM cpu a JOIN cpu b ON a.ts = b.ts",
])
def test_statements_outside_the_slice_raise_typed_errors(sql):
    qe = _engine()
    _cpu_table(qe, points=2)
    with pytest.raises(UnsupportedStatement, match="slice"):
        qe.execute_one(sql)


def test_group_space_past_the_dense_budget_raises(monkeypatch):
    qe = _engine()
    _cpu_table(qe)
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "10")
    with pytest.raises(PlanError, match="sparse"):
        qe.execute_one("SELECT date_bin(INTERVAL '10 seconds', ts) AS b, "
                       "host, max(u) FROM cpu GROUP BY b, host")


def test_host_aggregates_raise_until_ported():
    qe = _engine()
    _cpu_table(qe, points=2)
    with pytest.raises(PlanError, match="not in this slice"):
        qe.execute_one("SELECT host, median(u) FROM cpu GROUP BY host")


def test_select_without_table_and_empty_scan():
    qe = _engine()
    assert qe.execute_one("SELECT 1 + 2").rows() == [[3]]
    qe.execute_one("CREATE TABLE e (h STRING, ts TIMESTAMP(3) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (h))")
    assert qe.execute_one("SELECT count(v) FROM e").rows() == [[0]]
    assert qe.execute_one("SELECT h, max(v) FROM e GROUP BY h").rows() == []
    assert qe.execute_one("SELECT * FROM e").rows() == []
