"""Protocol servers of the port (counterpart of greptimedb_tpu/servers):
the HTTP server — /v1/sql, the Prometheus query API, the write
protocols, /metrics, /health, /v1/queries — the MySQL
(`servers.mysql.MysqlServer`) and PostgreSQL
(`servers.postgres.PostgresServer`) wire servers, with TLS
(`servers.tls`), and the OpenTSDB telnet server
(`servers.opentsdb.OpentsdbServer`). The write protocols' parsers are
`servers.influx`, `servers.prom_store` and `servers.otlp`. Arrow Flight
(`servers.flight.FlightServer` and its clients) runs over the port's own
gRPC (`servers.grpc`), HTTP/2 (`servers.h2`), HPACK (`servers.hpack`)
and Flight messages (`servers.flight_proto`).

`HttpServer` and `FlightServer` are exported lazily (PEP 562): both
import the query engine (torch), but the encode pool's spawn-mode
workers import only the sibling `servers.encode`.
"""

__all__ = ["FlightServer", "HttpServer"]


def __getattr__(name: str):
    if name == "HttpServer":
        from greptimedb_tpu_torch.servers.http import HttpServer

        return HttpServer
    if name == "FlightServer":
        from greptimedb_tpu_torch.servers.flight import FlightServer

        return FlightServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
