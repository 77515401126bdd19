"""Session state of the port (copy of greptimedb_tpu/session; mirrors
reference `src/session`: `QueryContext` with catalog/schema/timezone/
channel, src/session/src/context.rs:39).

`QueryContext` travels with every statement from the wire protocol down
through the query engine; servers stamp the channel and authenticated
user, `USE <db>` mutates the current schema, and the timezone feeds
timestamp rendering/coercion.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.catalog.catalog import DEFAULT_DB

__all__ = ["Channel", "QueryContext", "DEFAULT_DB"]


class Channel(enum.Enum):
    """Wire protocol a request arrived on (reference
    src/session/src/context.rs Channel enum)."""

    UNKNOWN = "unknown"
    HTTP = "http"
    GRPC = "grpc"
    MYSQL = "mysql"
    POSTGRES = "postgres"
    INFLUX = "influx"
    OPENTSDB = "opentsdb"
    PROMETHEUS = "prometheus"
    OTLP = "otlp"
    FLOW = "flow"


@dataclass
class QueryContext:
    """Per-request session context (reference QueryContext,
    src/session/src/context.rs:39 — catalog/schema/timezone/channel,
    plus the authenticated user)."""

    db: str = DEFAULT_DB
    # None = "not set by the client" — QueryEngine.execute_sql resolves it
    # to the engine's default_timezone option; a client-set value wins
    timezone: Optional[str] = None
    channel: Channel = Channel.UNKNOWN
    user: Optional[object] = None  # auth.UserInfo when authenticated
    # fair-scheduling identity for the admission controller; servers
    # stamp it from X-Greptime-Tenant / the authenticated user, falling
    # back to "default" (concurrency/admission.py)
    tenant: Optional[str] = None
    # W3C trace context for cross-process propagation (SURVEY §5)
    trace_id: Optional[str] = None
    # deadline plane (utils/deadline.py): timeout_ms is the requested
    # per-statement budget (0/None = fall back to [query]
    # default_timeout_ms); servers stamp it from X-Greptime-Timeout /
    # max_execution_time / statement_timeout. cancel_token is the live
    # per-statement CancelToken while a statement is executing — servers
    # cancel it on client disconnect, KILL QUERY finds it via the
    # running-queries registry
    timeout_ms: Optional[float] = None
    cancel_token: Optional[object] = None  # deadline.CancelToken
    extensions: dict = field(default_factory=dict)

    @property
    def current_schema(self) -> str:
        return self.db

    def with_db(self, db: str) -> "QueryContext":
        return QueryContext(db=db, timezone=self.timezone,
                            channel=self.channel, user=self.user,
                            tenant=self.tenant,
                            trace_id=self.trace_id,
                            timeout_ms=self.timeout_ms,
                            cancel_token=self.cancel_token,
                            extensions=self.extensions)
