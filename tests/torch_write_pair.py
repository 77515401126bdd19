"""A JAX HttpServer and the port's HttpServer (on the CPU) over empty
engines, for the write-protocol parity tests
(tests/test_torch_{prom_store,opentsdb}.py): `post` sends one body to
both and returns both answers, `rows` runs one SQL statement on both
engines.
"""

import urllib.error
import urllib.request

import numpy as np

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.servers.http import HttpServer as JHttpServer
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.servers import HttpServer
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine


class Pair:
    def __init__(self, root):
        self.jeng = JRegionEngine(JConfig(data_dir=str(root / "jax"),
                                          maintenance_workers=0))
        self.jqe = JQueryEngine(JCatalog(JMemoryKv()), self.jeng)
        self.teng = RegionEngine(EngineConfig(data_dir=str(root / "port")),
                                 device="cpu")
        self.tqe = QueryEngine(Catalog(MemoryKv()), self.teng, device="cpu")
        self.jsrv, self.tsrv = JHttpServer(self.jqe, port=0), \
            HttpServer(self.tqe, port=0)
        self.ports = (self.jsrv.start(), self.tsrv.start())

    def close(self):
        for srv, qe, eng in ((self.jsrv, self.jqe, self.jeng),
                             (self.tsrv, self.tqe, self.teng)):
            srv.stop()
            qe.concurrency.shutdown()
            eng.close()

    def post(self, path, body: bytes, headers=None) -> list:
        """[(status, headers, body)] of the JAX server, then the port's."""
        out = []
        for port in self.ports:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                headers=headers or {})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    out.append((r.status, r.headers, r.read()))
            except urllib.error.HTTPError as e:
                out.append((e.code, e.headers, e.read()))
        return out

    def rows(self, sql) -> tuple:
        """(JAX rows, port rows) of `sql`, cells as plain values."""
        return tuple(plain_rows(qe.execute_one(sql))
                     for qe in (self.jqe, self.tqe))


def plain_rows(res) -> list:
    out = []
    for row in res.rows():
        cells = []
        for v in row:
            if isinstance(v, (bool, np.bool_)):
                v = bool(v)
            elif isinstance(v, (float, np.floating)):
                v = None if v != v else float(v)
            elif isinstance(v, (int, np.integer)):
                v = int(v)
            cells.append(v)
        out.append(cells)
    return out
