"""Server-side TLS configuration for the wire protocols (copy of
greptimedb_tpu/servers/tls.py).

Mirrors reference src/servers/src/tls.rs (TlsOption: mode +
cert/key paths, reloadable context). `TlsConfig.make_context()` builds
one ssl.SSLContext per server; MySQL upgrades after the client's
SSLRequest (CLIENT_SSL capability), PostgreSQL after the SSLRequest
startup code — both mid-handshake STARTTLS-style upgrades on the
accepted socket.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass


@dataclass
class TlsConfig:
    cert_path: str
    key_path: str
    # 'prefer': offer TLS, allow plaintext; 'require': reject plaintext
    # clients (reference tls.rs TlsMode subset that matters server-side)
    mode: str = "prefer"

    def __post_init__(self):
        if self.mode not in ("prefer", "require"):
            raise ValueError(f"bad TLS mode {self.mode!r}")

    def make_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        return ctx
