"""The port's storage engine on each object store against the JAX
engine's (the twin of tests/test_objectstore.py::test_engine_on_backend,
on `memory` and on the fake S3 of tests/torch_store_fakes.py, with the
read cache off and on).

Both engines take the same writes, a flush, more writes, a restart (on
the fake S3, whose bucket outlives the engine, with the remote WAL too)
and a full compaction; every SQL answer must be the JAX engine's. When
the store is not `fs`, no SST, manifest or index file lands under
`data_dir` (only the format stamp and a local WAL), and the kinds of keys
the two engines write correspond one to one (file ids and the SST suffix
aside).

The JAX engine cannot flush to S3 (ROADMAP C, R10: its S3Store hands
urllib the pyarrow Buffer the SST writer produces, and urllib's
`data != None` check raises TypeError), so in the S3 cases the JAX
engine runs on `memory` with the remote WAL and the port on the fake
S3; the JAX answers before the restart are the oracle after it.
"""

import os
import re

import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.objectstore import LruCacheLayer
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.remote_wal import RemoteWal

import torch_store_fakes as fakes

DDL = ("CREATE TABLE cpu (host STRING, usage DOUBLE, n BIGINT, "
       "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host))")
QUERIES = ("SELECT host, usage, n FROM cpu ORDER BY ts, host",
           "SELECT count(*) FROM cpu",
           "SELECT host, max(usage), sum(n), count(*) FROM cpu "
           "GROUP BY host ORDER BY host",
           "SELECT date_bin(INTERVAL '1 minute', ts) AS m, avg(usage) "
           "FROM cpu GROUP BY m ORDER BY m")


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _insert(rows):
    return "INSERT INTO cpu (host, usage, n, ts) VALUES " + ", ".join(
        f"('{h}', {u}, {n}, {ts})" for h, u, n, ts in rows)


def _rows(r) -> list:
    return [[v.item() if hasattr(v, "item") else v for v in row]
            for row in r.rows()]


class _Pair:
    def __init__(self, tmp_path, backend, cache, fake):
        self.tmp_path = tmp_path
        self.backend, self.cache, self.fake = backend, cache, fake
        self.kvs = (JMemoryKv(), MemoryKv())
        self.open()

    def _cfg(self, pkg):
        kw = dict(data_dir=str(self.tmp_path / pkg),
                  object_store=self.backend,
                  object_store_cache_bytes=self.cache,
                  maintenance_workers=0)
        if self.backend == "s3":
            kw["wal_backend"] = "remote"
            if pkg == "jax":  # R10: the JAX engine runs on memory
                kw["object_store"] = "memory"
            else:
                kw["object_store_kwargs"] = fakes.store_kwargs(
                    "s3", self.fake, "root/port")
        return kw

    def open(self, port_only=False):
        if not port_only:
            self.je = JRegionEngine(JConfig(**self._cfg("jax")))
            self.jq = JQueryEngine(JCatalog(self.kvs[0]), self.je)
        self.te = RegionEngine(EngineConfig(**self._cfg("port")),
                               device="cpu")
        self.tq = QueryEngine(Catalog(self.kvs[1]), self.te, device="cpu")

    def close(self):
        self.je.close()
        self.te.close()

    def same(self):
        """Every query answers as the JAX engine; the answers."""
        out = []
        for q in QUERIES:
            j = _rows(self.jq.execute_one(q))
            assert _rows(self.tq.execute_one(q)) == j, q
            out.append(j)
        return out


def _kinds(keys, root) -> set:
    """Keys relative to the engine's data dir, file ids and the SST
    suffix (JAX .parquet, port .sst) normalized."""
    out = set()
    for k in keys:
        k = k.lstrip("/")
        rel = k[k.index(root.lstrip("/")) + len(root.lstrip("/")):]
        rel = re.sub(r"[0-9a-f]{32}", "<id>", rel)
        rel = re.sub(r"\d{10}\.json$", "<v>.json", rel)
        rel = re.sub(r"remote_wal/(\d+)/\d{20}$", r"remote_wal/\1/<seq>",
                     rel)
        out.add(re.sub(r"\.(parquet|sst)$", ".<sst>", rel))
    return out


@pytest.mark.parametrize("backend,cache", [("memory", 0),
                                           ("memory", 64 << 20),
                                           ("s3", 0), ("s3", 64 << 20)])
def test_engine_on_backend_answers_as_jax(tmp_path, backend, cache):
    fake = fakes.serve("s3") if backend == "s3" else None
    pair = _Pair(tmp_path, backend, cache, fake)
    try:
        assert isinstance(pair.te.store, LruCacheLayer) == bool(cache)
        for qe in (pair.jq, pair.tq):
            qe.execute_one(DDL)
            qe.execute_one(_insert([("a", 1.0, 1, 1000), ("b", 2.0, 2, 2000),
                                    ("a", 1.5, 3, 61000)]))
            qe.execute_one("ADMIN flush_table('cpu')")
            qe.execute_one(_insert([("c", 3.0, 4, 3000),
                                    ("b", 2.5, 5, 62000)]))
        pair.same()
        for qe in (pair.jq, pair.tq):
            qe.execute_one("ADMIN flush_table('cpu')")
            qe.execute_one(_insert([("d", 4.0, 6, 4000)]))
        answers = pair.same()
        # no SST, manifest or index file under data_dir
        for pkg in ("jax", "port"):
            left = [os.path.relpath(os.path.join(d, f), tmp_path / pkg)
                    for d, _, fs in os.walk(tmp_path / pkg) for f in fs]
            assert all(p == "FORMAT.json" or p.startswith("wal" + os.sep)
                       for p in left), left
        jkeys = pair.je.store.list("")
        tkeys = pair.te.store.list("")
        if backend == "s3":
            assert isinstance(pair.te.wal, RemoteWal)
            assert sorted("/" + k[len("root/port/"):] for k in fake.objects
                          if k.startswith("root/port/")) == sorted(
                "/" + k.lstrip("/") for k in tkeys)
            # a restart of the port: the bucket and its remote WAL
            # outlive the engine
            pair.te.close()
            pair.open(port_only=True)
            assert [_rows(pair.tq.execute_one(q)) for q in QUERIES] == \
                answers
        assert _kinds(tkeys, str(tmp_path / "port")) == \
            _kinds(jkeys, str(tmp_path / "jax"))
        for qe in (pair.jq, pair.tq):
            qe.execute_one("ADMIN compact_table('cpu')")
        pair.same()
    finally:
        pair.close()
        if fake is not None:
            fake.close()
