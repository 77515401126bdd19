"""The port's boundaries: greptimedb_tpu_torch and chip_smoke.py import
nothing of JAX, of the JAX package or of pyarrow, at any level; engines
run on CUDA unless asked for the CPU and raise when CUDA is absent; the
hot set makes a warm repeat upload nothing; the host SQL surface gives
the JAX engine's results; statements outside this slice raise a typed
error naming the slice that brings them."""

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
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

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
        # pyarrow is absent on the card's machine: a lazy import would
        # fail there only
        assert root not in ("jax", "jaxlib", "greptimedb_tpu", "pyarrow"), \
            (path, mod, top_level)


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import greptimedb_tpu_torch.query, "
            "greptimedb_tpu_torch.interop, greptimedb_tpu_torch.storage; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'greptimedb_tpu', 'pyarrow')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _engine(data_dir, device="cpu"):
    engine = RegionEngine(EngineConfig(data_dir=str(data_dir)), device=device)
    return QueryEngine(Catalog(MemoryKv()), engine, device=device)


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RegionEngine(EngineConfig(data_dir=str(tmp_path / "a")))
    cpu_engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "b")),
                              device="cpu")
    assert cpu_engine.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryEngine(Catalog(MemoryKv()), cpu_engine)
    with pytest.raises(RuntimeError):
        config.device("cuda:0")
    assert _engine(tmp_path / "c").device == torch.device("cpu")


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


def test_warm_repeat_uploads_nothing(tmp_path):
    qe = _engine(tmp_path)
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


def test_drop_table_frees_region_and_blocks(tmp_path):
    qe = _engine(tmp_path)
    _cpu_table(qe)
    qe.execute_one("SELECT host, sum(u) FROM cpu GROUP BY host")
    assert qe.executor.cache.resident_bytes > 0
    qe.execute_one("DROP TABLE cpu")
    assert qe.executor.cache.resident_bytes == 0
    assert qe.region_engine.regions == {}
    _cpu_table(qe)  # the name is free again
    assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[200]]


@pytest.mark.parametrize("sql,slice_name", [
    ("COPY cpu TO 'cpu.parquet'", "COPY import and export"),
    # SHOW TABLES runs on the port now (the host SQL surface); the case
    # keeps its id and checks a SHOW statement that stays outside
    ("SHOW FLOWS", "servers and CLI"),
    ("ADMIN rollup_table('cpu', '1m')", "maintenance plane"),
    # TQL EVAL runs on the port now; the case keeps its id and checks the
    # TQL statement that stays outside the slice
    ("TQL ANALYZE (0, 10, '5s') up", "servers and CLI"),
    # joins run on the port now; the case keeps its id and checks a
    # runtime information_schema table, which stays outside
    ("SELECT * FROM information_schema.slow_queries", "servers and CLI"),
], ids=["COPY cpu TO 'cpu.parquet'", "SHOW TABLES",
        "ADMIN rollup_table('cpu', '1m')", "TQL EVAL (0, 10, '5s') up",
        "SELECT a.u FROM cpu a JOIN cpu b ON a.ts = b.ts"])
def test_statements_outside_the_slice_raise_typed_errors(sql, slice_name,
                                                         tmp_path):
    qe = _engine(tmp_path)
    _cpu_table(qe, points=2)
    with pytest.raises(UnsupportedStatement,
                       match=f"the {slice_name}.* brings"):
        qe.execute_one(sql)


# statements a case needs to have run first, on both engines
_SETUP = {"USE db2": "CREATE DATABASE db2",
          "DROP VIEW v": "CREATE VIEW v AS SELECT host FROM cpu"}


@pytest.mark.parametrize("sql", [
    # the five queries of ROADMAP C1 that the JAX engine answers
    "SELECT host, row_number() OVER (PARTITION BY host ORDER BY ts) AS rn "
    "FROM cpu",
    "SELECT host, avg(u) OVER (PARTITION BY host) FROM cpu",
    "SELECT host, count(*) FROM cpu WHERE host IN "
    "(SELECT host FROM cpu WHERE u > 99) GROUP BY host",
    "SELECT count(*) FROM cpu WHERE u > (SELECT avg(u) FROM cpu)",
    "SELECT table_name FROM information_schema.tables",
    # one statement of each kind the host SQL surface slice brings
    "SELECT count(*) FROM cpu UNION SELECT count(*) FROM cpu",
    "SHOW TABLES",
    "SHOW DATABASES",
    "SHOW CREATE TABLE cpu",
    "DESCRIBE TABLE cpu",
    "CREATE DATABASE db2",
    "USE db2",
    "SET time_zone = 'UTC'",
    "CREATE VIEW v AS SELECT host FROM cpu",
    "DROP VIEW v",
    "SHOW VIEWS",
    "EXPLAIN SELECT count(*) FROM cpu",
])
def test_host_sql_surface_matches_the_jax_engine(sql, tmp_path):
    """Each statement of the host SQL surface gives the JAX engine's
    column names and rows (or affected-row count) on the port."""
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine

    jengine = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                    maintenance_workers=0))
    try:
        outcomes = []
        for qe in (JQueryEngine(JCatalog(JMemoryKv()), jengine),
                   _engine(tmp_path / "port")):
            _cpu_table(qe, points=2)
            if sql in _SETUP:
                qe.execute_one(_SETUP[sql])
            r = qe.execute_one(sql)
            outcomes.append((r.affected_rows, list(r.names), [
                [v.item() if isinstance(v, np.generic) else v for v in row]
                for row in r.rows()]))
        assert outcomes[0] == outcomes[1]
    finally:
        jengine.close()


def test_explain_analyze_names_the_servers_slice(tmp_path):
    """EXPLAIN ANALYZE needs the tracing spans, as TQL ANALYZE does."""
    qe = _engine(tmp_path)
    _cpu_table(qe, points=2)
    with pytest.raises(UnsupportedStatement, match="servers and CLI"):
        qe.execute_one("EXPLAIN ANALYZE SELECT count(*) FROM cpu")


def test_group_space_past_the_dense_budget_raises(monkeypatch, tmp_path):
    """Past the dense budget the key space goes sparse; more observed
    groups than the sparse cap raise, with the JAX package's message."""
    qe = _engine(tmp_path)
    _cpu_table(qe)
    sql = ("SELECT date_bin(INTERVAL '10 seconds', ts) AS b, host, max(u) "
           "FROM cpu GROUP BY b, host")
    want = qe.execute_one(sql + " ORDER BY b, host").rows()
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "10")
    assert qe.execute_one(sql + " ORDER BY b, host").rows() == want
    assert qe.executor.last_path == "sparse"
    assert qe.executor.last_sparse_stats["groups"] == 200
    monkeypatch.setenv("GREPTIMEDB_TPU_SPARSE_GROUPS_MAX", "100")
    with pytest.raises(PlanError, match="observed 200 distinct groups, "
                       "exceeding the sparse cap 100"):
        qe.execute_one(sql)


def test_host_aggregates_raise_until_ported(tmp_path):
    """Order statistics are served on the host (query/host_agg.py); an
    invalid percentile still raises."""
    qe = _engine(tmp_path)
    _cpu_table(qe, points=3)
    rows = qe.execute_one("SELECT host, median(u), percentile(s, 50), "
                          "count(DISTINCT u) FROM cpu GROUP BY host "
                          "ORDER BY host").rows()
    raw = qe.execute_one("SELECT host, u, s FROM cpu").rows()
    for host, med, p50, nd in rows:
        u = [r[1] for r in raw if r[0] == host]
        s = [r[2] for r in raw if r[0] == host]
        assert med == np.median(u) and p50 == np.median(s) and nd == 3
    with pytest.raises(PlanError, match="out of"):
        qe.execute_one("SELECT percentile(u, 150) FROM cpu")


def test_select_without_table_and_empty_scan(tmp_path):
    qe = _engine(tmp_path)
    assert qe.execute_one("SELECT 1 + 2").rows() == [[3]]
    qe.execute_one("CREATE TABLE e (h STRING, ts TIMESTAMP(3) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (h))")
    assert qe.execute_one("SELECT count(v) FROM e").rows() == [[0]]
    assert qe.execute_one("SELECT h, max(v) FROM e GROUP BY h").rows() == []
    assert qe.execute_one("SELECT * FROM e").rows() == []
