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
            "greptimedb_tpu_torch.interop, greptimedb_tpu_torch.storage, "
            "greptimedb_tpu_torch.ingest, greptimedb_tpu_torch.native, "
            "greptimedb_tpu_torch.servers.influx, "
            "greptimedb_tpu_torch.servers.prom_store, "
            "greptimedb_tpu_torch.servers.otlp, "
            "greptimedb_tpu_torch.servers.opentsdb, "
            "greptimedb_tpu_torch.servers.http, "
            "greptimedb_tpu_torch.servers.flight; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'greptimedb_tpu', 'pyarrow', 'grpc', 'h2', 'hpack', "
            "'hyperframe', 'flatbuffers') or m.startswith("
            "'google.protobuf')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines here decode SST parts inline: the JAX package's
    process-wide decode pool would leave idle worker threads in this test
    process, and tests/test_profile_plane.py's sampler counts them when
    xdist runs that file later on the same worker."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _engine(data_dir, device="cpu", **cfg):
    engine = RegionEngine(EngineConfig(data_dir=str(data_dir), **cfg),
                          device=device)
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
    # COPY runs on the port now (A12-io): the case keeps its id and holds
    # the statement to the JAX engine (slice_name None)
    ("COPY cpu TO '{out}/cpu.parquet'", None),
    # SHOW TABLES, then SHOW FLOWS (the flow engine) run on the port
    # now, and the cluster tables and PARTITION ON since A10-cluster: the
    # cases keep their ids and hold the statements to the JAX engine
    ("SELECT region_id, peer_id, peer_addr, is_leader, status FROM "
     "information_schema.region_peers", None),
    ("SELECT peer_id, peer_type, peer_addr FROM "
     "information_schema.cluster_info", None),
    ("SELECT * FROM information_schema.partitions", None),
    ("CREATE TABLE p (a STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
     "PRIMARY KEY (a)) PARTITION ON COLUMNS (a) (a < 'm', a >= 'm')",
     None),
    # external tables over the container formats run on the port now
    # (A12-io): the two cases keep their ids and are held to the JAX
    # engine over files it wrote
    ("CREATE EXTERNAL TABLE x (ts TIMESTAMP TIME INDEX, host STRING) WITH "
     "(location = '{src}/cpu.orc', format = 'orc')", None),
    ("CREATE EXTERNAL TABLE x (ts TIMESTAMP TIME INDEX, host STRING) WITH "
     "(location = '{src}/cpu.parquet', format = 'parquet')", None),
    # COPY DATABASE runs on the port now; the case keeps its id
    ("COPY DATABASE public TO '{out}/db_out/' "
     "WITH (format = 'parquet')", None),
], ids=["COPY cpu TO 'cpu.parquet'", "SHOW TABLES",
        "TQL EVAL (0, 10, '5s') up",
        "SELECT a.u FROM cpu a JOIN cpu b ON a.ts = b.ts",
        "PARTITION ON", "ENGINE = metric", "CREATE EXTERNAL TABLE",
        "ADMIN flush_flow"])
def test_statements_outside_the_slice_raise_typed_errors(sql, slice_name,
                                                         tmp_path):
    if slice_name is None:
        return _same_as_jax(sql, tmp_path)
    qe = _engine(tmp_path)
    _cpu_table(qe, points=2)
    with pytest.raises(UnsupportedStatement,
                       match=f"the {slice_name}.* brings"):
        qe.execute_one(sql)


def _same_as_jax(sql, tmp_path):
    """The statement (with `{out}` an output directory of each engine's
    own and `{src}` files the JAX engine wrote) gives the JAX engine's
    outcome; files written are read back by pyarrow as the JAX files,
    and an external table answers as the JAX engine's."""
    import pyarrow.parquet as pq

    _je, jqe = _jax_engine(tmp_path / "jax")
    tqe = _engine(tmp_path / "port")
    src = tmp_path / "src"
    src.mkdir()
    for qe in (jqe, tqe):
        _cpu_table(qe, points=3)
    jqe.execute_one(f"COPY cpu TO '{src}/cpu.parquet'")
    jqe.execute_one(f"COPY cpu TO '{src}/cpu.orc'")
    outs = []
    for name, qe in (("jax", jqe), ("port", tqe)):
        out = tmp_path / f"out_{name}"
        out.mkdir()
        r = qe.execute_one(sql.format(out=out, src=src))
        outs.append((r.affected_rows, out,
                     [list(row) for row in r.rows()] if r.is_query
                     else None))
    assert outs[0][0] == outs[1][0]
    assert outs[0][2] == outs[1][2]
    outs = [o[:2] for o in outs]
    if "PARTITION" in sql:
        q = "SELECT * FROM information_schema.partitions"
        assert tqe.execute_one(q).rows() == jqe.execute_one(q).rows()
    for (_n, jout), (_m, tout) in [outs]:
        for root, _dirs, files in os.walk(jout):
            for f in files:
                jt = pq.read_table(os.path.join(root, f))
                tt = pq.read_table(os.path.join(
                    str(tout) + root[len(str(jout)):], f))
                assert tt.schema.equals(jt.schema, check_metadata=False)
                assert tt.to_pylist() == jt.to_pylist()
    if "EXTERNAL" in sql:
        q = "SELECT host, ts FROM x ORDER BY ts, host"
        assert tqe.execute_one(q).rows() == jqe.execute_one(q).rows()


def _jax_engine(data_dir):
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine

    jengine = JRegionEngine(JConfig(data_dir=str(data_dir),
                                    maintenance_workers=0))
    return jengine, JQueryEngine(JCatalog(JMemoryKv()), jengine)


@pytest.mark.parametrize("sql", [
    "ADMIN bogus('cpu')",
    "CREATE EXTERNAL TABLE x (a STRING) WITH "
    "(location = '/nonexistent/x.csv', format = 'csv')",
    "CREATE TABLE p (a STRING, v DOUBLE) PARTITION ON COLUMNS (a) "
    "(a < 'm', a >= 'm')",
    "CREATE TABLE m (a STRING) ENGINE = metric",
])
def test_statements_the_jax_engine_refuses_raise_its_error(sql, tmp_path):
    """Where the JAX engine's own validation refuses a statement, the
    port raises the same error type and text (ROADMAP C3): the JAX
    validation runs before the port's refusals."""
    jengine, jqe = _jax_engine(tmp_path / "jax")
    try:
        errors = []
        for qe in (jqe, _engine(tmp_path / "port")):
            _cpu_table(qe, points=2)
            with pytest.raises(Exception) as ei:
                qe.execute_one(sql)
            errors.append((type(ei.value).__name__, str(ei.value)))
        assert errors[1] == errors[0]
        assert errors[1][0] == "PlanError"
    finally:
        jengine.close()


@pytest.mark.parametrize("fn", ["flush_region", "compact_region"])
def test_region_flush_and_compaction_match_the_jax_engine(fn, tmp_path):
    """ADMIN flush_region / compact_region run synchronously, as on a
    JAX engine without a maintenance plane (ROADMAP C2): 0 affected rows,
    the region's files change the same way, and the rows stay the JAX
    rows."""
    jengine, jqe = _jax_engine(tmp_path / "jax")
    try:
        outcomes = []
        for qe, eng in ((jqe, jengine),
                        (_engine(tmp_path / "port", maintenance_workers=0),
                         None)):
            eng = eng or qe.region_engine
            _cpu_table(qe, points=4)
            info = qe.catalog.table("public", "cpu")
            rid = info.region_ids[0]
            qe.execute_one(f"ADMIN flush_region({rid})")
            qe.execute_one("INSERT INTO cpu VALUES ('h0', 999000, 1.0, 2.0)")
            if fn == "compact_region":
                qe.execute_one(f"ADMIN flush_region({rid})")
            r = qe.execute_one(f"ADMIN {fn}({rid})")
            region = eng.region(rid)
            rows = qe.execute_one("SELECT * FROM cpu ORDER BY host, ts")
            outcomes.append((r.affected_rows, len(region.files),
                             region.memtable.num_rows, list(rows.names), [
                [v.item() if isinstance(v, np.generic) else v for v in row]
                for row in rows.rows()]))
        assert outcomes[1] == outcomes[0]
        assert outcomes[1][0] == 0
        assert outcomes[1][1] == (1 if fn == "compact_region" else 2)
    finally:
        jengine.close()


@pytest.mark.parametrize("sql", [
    "ADMIN rollup_table('cpu', '1m')", "ADMIN expire_table('cpu', '1d')",
    "ADMIN maintenance_status(1)"])
def test_maintenance_functions_without_the_plane_match_the_jax_engine(
        sql, tmp_path):
    """With maintenance_workers=0 the plane's functions raise the JAX
    engine's PlanError, text for text (they were refusals naming A12
    before the plane was ported)."""
    jengine, jqe = _jax_engine(tmp_path / "jax")
    try:
        qe = _engine(tmp_path / "port", maintenance_workers=0)
        errors = []
        for q in (jqe, qe):
            _cpu_table(q, points=2)
            with pytest.raises(Exception) as e:
                q.execute_one(sql)
            errors.append((type(e.value).__name__, str(e.value)))
        assert errors[1] == errors[0]
        assert errors[1][0] == "PlanError"
        qe.region_engine.close()
    finally:
        jengine.close()


@pytest.mark.parametrize("fn", ["flush_table", "compact_table",
                                "rollup_table", "expire_table"])
def test_admin_functions_return_job_ids_on_the_plane(fn, tmp_path):
    """With the JAX defaults (one maintenance worker) each table function
    returns one job id a region, as the JAX engine does, and the job
    finishes."""
    qe = _engine(tmp_path)
    _cpu_table(qe, points=20)
    args = {"rollup_table": ", '1m'", "expire_table": ", '1d'"}.get(fn, "")
    r = qe.execute_one(f"ADMIN {fn}('cpu'{args})")
    assert r.names == ["job_id"] and r.num_rows == 1
    job = qe.region_engine.maintenance.wait(int(r.rows()[0][0]), timeout=30)
    assert job.state == "done", job.error
    st = qe.execute_one(f"ADMIN maintenance_status({job.job_id})")
    assert dict(zip(st.names, st.rows()[0]))["state"] == "done"
    qe.region_engine.close()


def test_distributed_rollup_substitution_names_a10(tmp_path):
    """A frontend whose regions live on datanodes (an engine with a
    rollup_probe and no local plane) probes them for companion coverage
    (A10-proc): every region is asked about the statement's window, and
    with no covering rollup the raw route answers."""
    qe = _engine(tmp_path, maintenance_workers=0)
    _cpu_table(qe, points=2)
    asked = []
    qe.region_engine.rollup_probe = \
        lambda rid, lo, hi: asked.append((rid, lo, hi)) or []
    sql = ("SELECT host, max(u) FROM cpu WHERE ts >= 0 AND ts < 60000 "
           "GROUP BY host ORDER BY host")
    res = qe.execute_one(sql)
    assert asked == [(rid, 0, 60000) for rid in
                     qe.catalog.table("public", "cpu").region_ids]
    assert "rollup" not in (qe.executor.last_path or "")
    del qe.region_engine.rollup_probe
    assert res.rows() == qe.execute_one(sql).rows()
    qe.region_engine.close()


def test_standalone_defaults_run_the_write_plane(tmp_path):
    """standalone start's default options: cpu/2 write workers, group
    commit with overlap and one maintenance worker, as the JAX package
    runs them; close() joins every thread of the plane."""
    import threading

    from greptimedb_tpu_torch import options

    opts = options.StandaloneOptions()
    options.check_port_support(opts)
    cfg = options.engine_config(opts, str(tmp_path / "data"))
    assert cfg.write_workers == -1 and cfg.ingest_group_commit
    assert cfg.ingest_overlap and cfg.maintenance_workers == 1
    before = set(threading.enumerate())
    qe = QueryEngine(Catalog(MemoryKv()), RegionEngine(cfg, device="cpu"),
                     device="cpu")
    eng = qe.region_engine
    assert eng.workers is not None and eng.workers.n == max(
        1, (os.cpu_count() or 2) // 2)
    assert eng.maintenance is not None
    _cpu_table(qe, points=3)
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    assert eng.region(rid).committer is not None
    assert qe.execute_one("SELECT count(*) FROM cpu").rows() == [[12]]
    assert set(threading.enumerate()) - before
    eng.close()
    assert set(threading.enumerate()) - before == set()


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
    # an engine name neither engine knows makes a plain table on both
    "CREATE TABLE e (ts TIMESTAMP TIME INDEX, v DOUBLE) ENGINE = mito2",
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
