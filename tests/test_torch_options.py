"""The port's layered options (greptimedb_tpu_torch/options.py) against
the JAX package's: every TOML of tests/test_options.py through both
`load_options` (the same values, or the same ConfigError text), the
environment and flag layers, `dump-config` equal to the JAX text and
loading back, the boot check refusing a key of an unported subsystem by
its slice, and the CLI: `standalone start --device cpu -c <toml>` with
MySQL, Postgres and a static user answering on all three protocols and
exiting 0 on SIGTERM, and `repl` answering statements on stdin.
"""

import base64
import dataclasses
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.parse
import urllib.request

import pytest

from tests.test_torch_auth import AuthMiniMysql
from tests import test_auth as jauth_tests

from greptimedb_tpu import cli as jcli
from greptimedb_tpu import options as jopt
from greptimedb_tpu_torch import cli, options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def outcome(fn):
    try:
        return ("ok", dataclasses.asdict(fn()))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


#: (TOML text or None, env, overrides): tests/test_options.py's layers
CASES = {
    "defaults": (None, {}, None),
    "toml_layer": ("default_timezone = 'u+8'\n[http]\naddr = '0.0.0.0:9999'\n"
                   "[wal]\nsync = false\nsegment_bytes = 1024\n"
                   "[storage.s3]\nbucket = 'b'\n", {}, None),
    "env_overrides_toml": ("[http]\naddr = '0.0.0.0:9999'\n", {
        "GREPTIMEDB_TPU__HTTP__ADDR": "1.2.3.4:80",
        "GREPTIMEDB_TPU__MYSQL__ENABLE": "true",
        "GREPTIMEDB_TPU__MYSQL__TLS__MODE": "require",
        "UNRELATED": "x"}, None),
    "flags_override_env": (None, {"GREPTIMEDB_TPU__HTTP__ADDR": "1.2.3.4:80"},
                           {"http": {"addr": "flag:1"}}),
    "unknown_key": ("[http]\nadddr = 'typo'\n", {}, None),
    "unknown_override": (None, {}, {"nope": 1}),
    "type_error_int": ("[wal]\nsegment_bytes = 'lots'\n", {}, None),
    "type_error_bool": (None, {"GREPTIMEDB_TPU__WAL__SYNC": "maybe"}, None),
    "engine_mapping": (None, {
        "GREPTIMEDB_TPU__WAL__SYNC": "false",
        "GREPTIMEDB_TPU__STORAGE__TYPE": "memory",
        "GREPTIMEDB_TPU__ENGINE__FLUSH_THRESHOLD_BYTES": "123"}, None),
    "s3_kwargs": (None, {
        "GREPTIMEDB_TPU__STORAGE__TYPE": "s3",
        "GREPTIMEDB_TPU__STORAGE__CACHE_BYTES": "1024",
        "GREPTIMEDB_TPU__STORAGE__S3__BUCKET": "b",
        "GREPTIMEDB_TPU__STORAGE__S3__ROOT": "data/x",
        "GREPTIMEDB_TPU__STORAGE__S3__ENDPOINT": "http://127.0.0.1:9",
        "GREPTIMEDB_TPU__STORAGE__S3__ACCESS_KEY_ID": "ak",
        "GREPTIMEDB_TPU__STORAGE__S3__SECRET_ACCESS_KEY": "sk"}, None),
    "stream_block_rows": (None, {
        "GREPTIMEDB_TPU__QUERY__STREAM_BLOCK_ROWS": "4096"}, None),
    "static_users": (None, {"GREPTIMEDB_TPU__AUTH__STATIC_USERS": "a=x,b=y"},
                     None),
    "boot_with_config": ("[storage]\ndata_home = '/tmp/x/data'\n"
                         "[http]\naddr = '127.0.0.1:0'\n", {}, None),
    "rollup_rules": ("[[maintenance.rollup]]\nresolution = '1h'\n"
                     "fields = 'v'\n[[maintenance.rollup]]\n", {}, None),
    "rollup_not_a_table": ("[maintenance]\nrollup = [1, 2]\n", {}, None),
    "section_not_a_table": ("http = 3\n", {}, None),
    "bad_toml": ("[http\naddr = 1\n", {}, None),
    "env_scalar_conflict": (None, {"GREPTIMEDB_TPU__HTTP": "x",
                                   "GREPTIMEDB_TPU__HTTP__ADDR": "y"}, None),
    "float_and_str": ("[concurrency]\nqueue_timeout_s = 2\ntenant_weights = "
                      "'a=3'\n[query]\ncompute_dtype = 'float64'\n", {}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_options_matches_jax(case, tmp_path):
    text, env, overrides = CASES[case]
    path = None
    if text is not None:
        path = tmp_path / "cfg.toml"
        path.write_text(text)
        path = str(path)
    got = outcome(lambda: options.load_options(path, env=env,
                                               overrides=overrides))
    want = outcome(lambda: jopt.load_options(path, env=env,
                                             overrides=overrides))
    assert got == want


def test_missing_file_matches_jax():
    got = outcome(lambda: options.load_options("/nonexistent/cfg.toml",
                                               env={}))
    assert got == outcome(lambda: jopt.load_options("/nonexistent/cfg.toml",
                                                    env={}))
    assert "config file not found" in got[2]


def test_dump_config_equals_jax_and_loads_back(tmp_path, capsys):
    assert cli.main(["dump-config"]) == 0
    text = capsys.readouterr().out
    assert text == jopt.example_toml() == options.example_toml()
    p = tmp_path / "example.toml"
    p.write_text(text)
    opts = options.load_options(str(p), env={})
    assert opts == options.StandaloneOptions()
    options.check_port_support(opts)  # the defaults boot


STORE = "object stores and the remote WAL"


def _same_store_config(opts, jopts):
    """The port's EngineConfig carries the JAX package's store and WAL
    fields for the same options."""
    cfg = options.engine_config(opts, "/d")
    jcfg = jopt.engine_config(jopts, "/d")
    for f in ("object_store", "object_store_cache_bytes",
              "object_store_kwargs", "wal_backend", "wal_store"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("key,value,slice_name", [
    # Arrow Flight runs on the port now (A9-flight): the case keeps its
    # id and boots (slice_name FLIGHT: accepted)
    pytest.param("grpc.enable", "true", "Arrow Flight",
                 id="grpc.enable-true-A9: Flight"),
    # object stores, the read cache and the remote WAL run on the port
    # now (A12-io): the cases keep their ids, boot, and map to the JAX
    # package's EngineConfig fields (slice_name STORE: accepted)
    pytest.param("storage.type", "'s3'", STORE,
                 id="storage.type-'s3'-A12: object stores"),
    pytest.param("storage.s3.bucket", "'b'", STORE,
                 id="storage.s3.bucket-'b'-A12: object stores"),
    pytest.param("wal.backend", "'remote'", STORE,
                 id="wal.backend-'remote'-A12: object stores"),
    pytest.param("storage.cache_bytes", "1", STORE,
                 id="scan.decode_threads-4-A12: the parallel decode pool"),
    ("query.mesh", "'2x2'", "A10"),
    ("query.tier_admission", "false", "A11"),
    # [cluster] runs on the port now (A10-proc): the case keeps its id,
    # boots, and apply_cluster switches the router's hedging as the JAX
    # options layer does
    pytest.param("cluster.hedge_enabled", "false", "cluster",
                 id="cluster.hedge_enabled-false-A10"),
    ("parallel.mesh_min_rows", "1", "A10"),
    # partitioned tables run on the port now (A10-cluster): the case keeps
    # its id, boots, and apply_query_env writes the JAX env twin
    pytest.param("partition.default_hash_regions", "4", "partition",
                 id="partition.default_hash_regions-4-A10"),
    # flows, scripts, plugins and the shm fabric run on the port now: the
    # case keeps its id, boots [shm] and checks the env twins apply_shm
    # sets (slice_name None: accepted)
    pytest.param("shm.fabric", "true", None,
                 id="shm.fabric-true-A9: flows, scripts, plugins and shm"),
])
def test_unported_key_refused_naming_its_slice(key, value, slice_name,
                                               tmp_path, monkeypatch):
    section, name = key.rsplit(".", 1)
    p = tmp_path / "cfg.toml"
    p.write_text(f"[{section}]\n{name} = {value}\n")
    opts = options.load_options(str(p), env={})
    jopt.load_options(str(p), env={})  # the JAX package loads it
    if slice_name is None:
        _check_shm_boots(tmp_path, monkeypatch)
        return
    if slice_name is STORE:
        options.check_port_support(opts)
        _same_store_config(opts, jopt.load_options(str(p), env={}))
        return
    if slice_name == "partition":
        options.check_port_support(opts)
        # recorded, so the teardown removes what apply_query_env writes
        monkeypatch.setenv("GREPTIMEDB_TPU_DEFAULT_HASH_REGIONS", "")
        monkeypatch.delenv("GREPTIMEDB_TPU_DEFAULT_HASH_REGIONS")
        options.apply_query_env(opts)
        from greptimedb_tpu_torch import config as port_config

        assert port_config.default_hash_partitions() == 4
        return
    if slice_name == "cluster":
        return _check_cluster_applies(opts, tmp_path, monkeypatch)
    if slice_name == "Arrow Flight":
        options.check_port_support(opts)
        assert opts.grpc.enable is True
        return
    with pytest.raises(options.ConfigError) as e:
        options.check_port_support(opts)
    assert f"option '{key}'" in str(e.value)
    assert slice_name in str(e.value) and "not in this slice" in str(e.value)


def _check_cluster_applies(opts, tmp_path, monkeypatch):
    """[cluster] boots; apply_cluster writes the JAX env twins of
    hedge_enabled and hedge_delay_ms (GTPU_HEDGE=off, what the JAX layer
    writes for the same file); a router built with hedge_budget_pct
    earns its hedges at that rate."""
    from greptimedb_tpu_torch.cluster import cluster as port_cluster

    options.check_port_support(opts)
    for k in ("GTPU_HEDGE", "GTPU_HEDGE_DELAY_MS"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    monkeypatch.setattr(options, "_APPLIED_ENV_KEYS", set())
    options.apply_cluster(opts)
    assert os.environ.get("GTPU_HEDGE") == "off"
    assert not port_cluster._HedgePlane.enabled()
    p = tmp_path / "budget.toml"
    p.write_text("[cluster]\nhedge_budget_pct = 50.0\n"
                 "hedge_delay_ms = 7\n")
    budget = options.load_options(str(p), env={})
    options.apply_cluster(budget)
    assert os.environ.get("GTPU_HEDGE") is None
    assert os.environ.get("GTPU_HEDGE_DELAY_MS") == "7"
    plane = port_cluster._HedgePlane(budget.cluster.hedge_budget_pct)
    plane._credit = 0.0
    plane.accrue()
    plane.accrue()
    assert plane.try_fire()  # two requests earn one hedge at 50 %


def _check_shm_boots(tmp_path, monkeypatch):
    """[shm] boots, and apply_shm sets the GTPU_SHM_FABRIC* twins the
    JAX apply_shm sets for the same file (and leaves an operator-set one
    alone)."""
    keys = ("GTPU_SHM_FABRIC", "GTPU_SHM_FABRIC_BYTES", "GTPU_SHM_FABRIC_DIR")
    # record each key's state first, so the undo restores it: a later
    # delenv records the value apply_shm wrote, and an enabled fabric
    # would leak into the next engine this worker builds
    for k in keys:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    # the keys each options layer wrote stay this test's own
    monkeypatch.setattr(options, "_APPLIED_ENV_KEYS", set())
    monkeypatch.setattr(jopt, "_APPLIED_ENV_KEYS", set())
    p = tmp_path / "shm.toml"
    p.write_text(f"[shm]\nfabric = true\nfabric_bytes = {8 << 20}\n"
                 f"fabric_dir = '{tmp_path / 'fab'}'\n")
    opts = options.load_options(str(p), env={})
    options.check_port_support(opts)
    twins = []
    for apply_shm, o in ((options.apply_shm, opts),
                         (jopt.apply_shm, jopt.load_options(str(p), env={}))):
        for k in keys:
            monkeypatch.delenv(k, raising=False)
        apply_shm(o)
        twins.append({k: os.environ.get(k) for k in keys})
        for k in keys:
            monkeypatch.delenv(k, raising=False)
    assert twins[0] == twins[1] == {
        "GTPU_SHM_FABRIC": "1", "GTPU_SHM_FABRIC_BYTES": str(8 << 20),
        "GTPU_SHM_FABRIC_DIR": str(tmp_path / "fab")}
    monkeypatch.setattr(options, "_APPLIED_ENV_KEYS", set())
    monkeypatch.setenv("GTPU_SHM_FABRIC_DIR", "/operator/set")
    options.apply_shm(opts)
    assert os.environ["GTPU_SHM_FABRIC_DIR"] == "/operator/set"


@pytest.mark.parametrize("key,value", [
    ("engine.write_workers", "4"), ("maintenance.workers", "2"),
    ("maintenance.retention_ttl", "'7d'"), ("ingest.max_batch_rows", "10"),
    ("ingest.group_commit", "false"), ("ingest.overlap", "false"),
    ("maintenance.stall_timeout_s", "0.5"),
    ("scan.decode_threads", "4"), ("scan.decode_threads", "1"),
])
def test_write_plane_keys_boot_and_map_as_the_jax_package(key, value,
                                                          tmp_path):
    """The write plane's options (write workers, [ingest], [maintenance])
    boot, and reach EngineConfig as the JAX engine_config maps them."""
    section, name = key.rsplit(".", 1)
    p = tmp_path / "cfg.toml"
    p.write_text(f"[{section}]\n{name} = {value}\n")
    opts = options.load_options(str(p), env={})
    options.check_port_support(opts)
    cfg = options.engine_config(opts, "/tmp/x")
    jcfg = jopt.engine_config(jopt.load_options(str(p), env={}), "/tmp/x")
    for f in ("write_workers", "ingest_group_commit", "ingest_max_batch_rows",
              "ingest_max_batch_bytes", "ingest_queue_depth",
              "ingest_overlap", "maintenance_workers", "maintenance_queue",
              "maintenance_tick_s", "stall_memtable_bytes", "stall_l0_files",
              "stall_timeout_s", "retention_ttl_ms", "rollup_rules",
              "scan_decode_threads", "scan_part_cache_bytes"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_rollup_rules_refused_and_port_values_accepted(tmp_path):
    """Rollup rules boot (the maintenance plane runs them) and reach
    EngineConfig as the JAX package maps them."""
    p = tmp_path / "cfg.toml"
    p.write_text("[[maintenance.rollup]]\nresolution = '1h'\n"
                 "fields = 'v, w'\n")
    opts = options.load_options(str(p), env={})
    options.check_port_support(opts)
    assert options.engine_config(opts, "/tmp/x").rollup_rules == \
        jopt.engine_config(jopt.load_options(str(p), env={}),
                           "/tmp/x").rollup_rules == [
            {"resolution_ms": 3_600_000, "fields": ["v", "w"],
             "auto": True}]
    # values that ask for what the port does, XLA-only keys, and every
    # key the port runs boot
    p.write_text(
        "default_timezone = '+08:00'\n"
        "[http]\naddr = '0.0.0.0:1'\ntimeout_s = 5\n"
        "[mysql]\nenable = true\n[mysql.tls]\nmode = 'prefer'\n"
        "[postgres]\nenable = true\naddr = '127.0.0.1:0'\n"
        "[wal]\nsync = false\nsegment_bytes = 4096\n"
        "[storage]\ndata_home = '/tmp/d'\n"
        "[engine]\nflush_threshold_bytes = 1\nwrite_workers = 0\n"
        "compaction = 'lcs'\n"
        "[scan]\ndecode_threads = 1\npart_cache_bytes = 5\n"
        "upload_prefetch = false\n"
        "[ingest]\ngroup_commit = false\n"
        "[concurrency]\nfast_lane = false\nplan_cache_entries = 0\n"
        "[query]\ncompilation_cache_dir = 'off'\nprewarm = 'on'\n"
        "dense_groups_max = 7\ndefault_timeout_ms = 9\n"
        "[tracing]\nenabled = false\n[profiling]\nenabled = false\n"
        "[auth]\nstatic_users = 'a=b'\n")
    options.check_port_support(options.load_options(str(p), env={}))


def test_engine_config_and_env_layers(monkeypatch):
    opts = options.load_options(env={
        "GREPTIMEDB_TPU__WAL__SYNC": "false",
        "GREPTIMEDB_TPU__WAL__SEGMENT_BYTES": "4096",
        "GREPTIMEDB_TPU__ENGINE__FLUSH_THRESHOLD_BYTES": "123",
        "GREPTIMEDB_TPU__SCAN__PART_CACHE_BYTES": "77"})
    cfg = options.engine_config(opts, "/tmp/x")
    jcfg = jopt.engine_config(jopt.load_options(env={
        "GREPTIMEDB_TPU__WAL__SYNC": "false",
        "GREPTIMEDB_TPU__WAL__SEGMENT_BYTES": "4096",
        "GREPTIMEDB_TPU__ENGINE__FLUSH_THRESHOLD_BYTES": "123",
        "GREPTIMEDB_TPU__SCAN__PART_CACHE_BYTES": "77"}), "/tmp/x")
    for f in ("data_dir", "wal_sync", "wal_segment_bytes",
              "flush_threshold_bytes", "scan_part_cache_bytes"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    # operator-set kernel env vars beat config defaults; non-default
    # config values are written, defaults are not
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "100")
    monkeypatch.delenv("GREPTIMEDB_TPU_STREAM_BLOCK_ROWS", raising=False)
    monkeypatch.delenv("GTPU_QUERY_DEFAULT_TIMEOUT_MS", raising=False)
    options.apply_query_env(options.load_options(env={}))
    assert os.environ["GREPTIMEDB_TPU_DENSE_GROUPS_MAX"] == "100"
    assert "GREPTIMEDB_TPU_STREAM_BLOCK_ROWS" not in os.environ
    options.apply_query_env(options.load_options(env={
        "GREPTIMEDB_TPU__QUERY__STREAM_BLOCK_ROWS": "4096",
        "GREPTIMEDB_TPU__QUERY__DEFAULT_TIMEOUT_MS": "250"}))
    assert os.environ["GREPTIMEDB_TPU_STREAM_BLOCK_ROWS"] == "4096"
    assert os.environ["GTPU_QUERY_DEFAULT_TIMEOUT_MS"] == "250"
    # a re-applied default drops the values this layer wrote
    options.apply_query_env(options.load_options(env={}))
    assert "GREPTIMEDB_TPU_STREAM_BLOCK_ROWS" not in os.environ
    assert "GTPU_QUERY_DEFAULT_TIMEOUT_MS" not in os.environ


def test_concurrency_section_reaches_the_plane(monkeypatch):
    from greptimedb_tpu_torch import concurrency as conc

    for name in ("GTPU_FAST_LANE", "GTPU_PLAN_CACHE_ENTRIES",
                 "GTPU_FAST_LANE_ENTRIES", "GTPU_ENCODE_PROCESS_MODE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(conc, "_config", conc.ConcurrencyConfig())
    options.apply_concurrency(options.load_options(env={
        "GREPTIMEDB_TPU__CONCURRENCY__FAST_LANE": "false",
        "GREPTIMEDB_TPU__CONCURRENCY__PLAN_CACHE_ENTRIES": "7",
        "GREPTIMEDB_TPU__CONCURRENCY__ENCODE_PROCESS_POOL": "true"}))
    cfg = conc.current_config()
    assert (cfg.fast_lane, cfg.plan_cache_entries, cfg.fast_lane_entries,
            cfg.encode_process_mode) == (False, 7, 512, "on")
    monkeypatch.setenv("GTPU_PLAN_CACHE_ENTRIES", "3")
    monkeypatch.setenv("GTPU_FAST_LANE", "1")
    cfg = conc.current_config()
    assert (cfg.fast_lane, cfg.plan_cache_entries) == (True, 3)
    plane = conc.ConcurrencyPlane(cfg)
    assert plane.fast_lane.enabled and plane.plan_cache.capacity == 3
    plane.shutdown()


def test_cli_helpers_match_jax():
    ok = options.load_options(env={"GREPTIMEDB_TPU__AUTH__STATIC_USERS":
                                   "a=x,b=y"})
    assert cli._user_provider(ok)._users == jcli._user_provider(
        jopt.load_options(env={"GREPTIMEDB_TPU__AUTH__STATIC_USERS":
                               "a=x,b=y"}))._users
    for users in ("admin", "a=x,a=y", "=x"):
        env = {"GREPTIMEDB_TPU__AUTH__STATIC_USERS": users}
        with pytest.raises(options.ConfigError) as e:
            cli._user_provider(options.load_options(env=env))
        with pytest.raises(jopt.ConfigError) as je:
            jcli._user_provider(jopt.load_options(env=env))
        assert str(e.value) == str(je.value)
    assert cli._tls(options.TlsOptions()) is None
    with pytest.raises(options.ConfigError) as e:
        cli._tls(options.TlsOptions(mode="require"))
    with pytest.raises(jopt.ConfigError) as je:
        jcli._tls(jopt.TlsOptions(mode="require"))
    assert str(e.value) == str(je.value)
    assert cli._tls(options.TlsOptions("c.pem", "k.pem", "prefer")).mode \
        == "prefer"


# ---- the CLI -------------------------------------------------------------------


def _spawn(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-m", "greptimedb_tpu_torch",
                             *args], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            **kw)


def test_standalone_with_config_serves_three_protocols(tmp_path):
    """HTTP, MySQL and Postgres, and Arrow Flight beside them."""
    cfg = tmp_path / "standalone.toml"
    cfg.write_text(
        f"default_timezone = '+08:00'\n"
        f"[storage]\ndata_home = '{tmp_path}/home'\n"
        "[http]\naddr = '127.0.0.1:0'\n"
        "[grpc]\nenable = true\naddr = '127.0.0.1:0'\n"
        "[mysql]\nenable = true\naddr = '127.0.0.1:0'\n"
        "[postgres]\nenable = true\naddr = '127.0.0.1:0'\n"
        "[auth]\nstatic_users = 'alice=s3cret'\n")
    proc = _spawn(["standalone", "start", "--device", "cpu", "-c", str(cfg)])
    try:
        lines = [proc.stdout.readline() for _ in range(4)]
        assert "listening on http://127.0.0.1:" in lines[0], \
            (lines, proc.stderr.read() if proc.poll() is not None else "")
        http_port = int(lines[0].rsplit(":", 1)[1])
        assert lines[1].startswith("flight on grpc://127.0.0.1:")
        assert lines[2].startswith("mysql on 127.0.0.1:")
        assert lines[3].startswith("postgres on 127.0.0.1:")
        flight_port = int(lines[1].rsplit(":", 1)[1])
        my_port = int(lines[2].rsplit(":", 1)[1])
        pg_port = int(lines[3].rsplit(":", 1)[1])

        url = f"http://127.0.0.1:{http_port}/v1/sql"

        def http_sql(sql, user=None):
            req = urllib.request.Request(
                url, data=urllib.parse.urlencode({"sql": sql}).encode())
            if user:
                req.add_header("Authorization", "Basic " + base64.b64encode(
                    user.encode()).decode())
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        assert http_sql("SELECT 1")[0] == 401
        assert http_sql("SELECT 1", "alice:nope")[0] == 401
        status, doc = http_sql(
            "CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) TIME "
            "INDEX, PRIMARY KEY(host))", "alice:s3cret")
        assert status == 200
        http_sql("INSERT INTO cpu VALUES ('a', 1.5, 0), ('b', 2.5, 1000)",
                 "alice:s3cret")
        status, doc = http_sql("SELECT host, v, timezone() FROM cpu ORDER "
                               "BY host", "alice:s3cret")
        assert doc["output"][0]["records"]["rows"] == [
            ["a", 1.5, "+08:00"], ["b", 2.5, "+08:00"]]
        c = AuthMiniMysql(my_port, "alice", "s3cret")
        assert c.query("SELECT host, v FROM cpu ORDER BY host") == (
            "rows", ["host", "v"], [["a", "1.5"], ["b", "2.5"]])
        c.close()
        with pytest.raises(RuntimeError, match="mysql error 1045"):
            AuthMiniMysql(my_port, "alice", "wrong")
        assert jauth_tests.TestPostgresAuth()._login(pg_port, "alice",
                                                     "s3cret")
        assert not jauth_tests.TestPostgresAuth()._login(pg_port, "alice",
                                                         "nope")
        from greptimedb_tpu_torch.servers import flight

        fc = flight.FlightQueryClient(f"127.0.0.1:{flight_port}", "alice",
                                      "s3cret")
        assert fc.sql("SELECT host, v FROM cpu ORDER BY host").rows() == [
            ["a", 1.5], ["b", 2.5]]
        fc.close()
        with pytest.raises(flight.FlightUnauthenticatedError):
            flight.FlightQueryClient(f"127.0.0.1:{flight_port}", "alice",
                                     "wrong")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_standalone_refuses_an_unported_option(tmp_path):
    cfg = tmp_path / "standalone.toml"
    cfg.write_text("[query]\nmesh = '2x2'\n")
    proc = _spawn(["standalone", "start", "--device", "cpu", "-c", str(cfg),
                   "--data-home", str(tmp_path / "home")])
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 2 and out == ""
    assert "option 'query.mesh' = '2x2' is not in this slice" in err
    assert "A10" in err


def test_repl_answers_statements_on_stdin(tmp_path):
    proc = _spawn(["repl", "--device", "cpu", "--data-home",
                   str(tmp_path)], stdin=subprocess.PIPE)
    out, err = proc.communicate(
        "CREATE TABLE t (h STRING, v DOUBLE, ts TIMESTAMP(3) TIME INDEX, "
        "PRIMARY KEY(h))\nINSERT INTO t VALUES ('a', 1.5, 0)\n"
        "SELECT h, v FROM t\nSELECT nope FROM t\n\\q\n", timeout=60)
    assert proc.returncode == 0, err
    assert "OK, 1 rows affected" in out
    assert "h\tv\na\t1.5" in out
    assert "error: " in out
