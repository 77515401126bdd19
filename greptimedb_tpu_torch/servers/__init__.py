"""Protocol servers of the port (counterpart of greptimedb_tpu/servers):
the HTTP server — /v1/sql, the Prometheus query API, the write
protocols, /metrics, /health, /v1/queries — the MySQL
(`servers.mysql.MysqlServer`) and PostgreSQL
(`servers.postgres.PostgresServer`) wire servers, with TLS
(`servers.tls`), and the OpenTSDB telnet server
(`servers.opentsdb.OpentsdbServer`). The write protocols' parsers are
`servers.influx`, `servers.prom_store` and `servers.otlp`. Flight comes
later (ROADMAP.md A9-flight).

`HttpServer` is exported lazily (PEP 562): the HTTP server imports the
query engine (torch), but the encode pool's spawn-mode workers import
only the sibling `servers.encode`.
"""

__all__ = ["HttpServer"]


def __getattr__(name: str):
    if name == "HttpServer":
        from greptimedb_tpu_torch.servers.http import HttpServer

        return HttpServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
