"""Authentication & authorization of the port (copy of
greptimedb_tpu/auth/__init__.py; mirrors reference `src/auth`:
`UserProvider` trait, static file/options user providers, permission
checks — src/auth/src/lib.rs, user_provider.rs, permission.rs).

Providers verify credentials per wire protocol:
- HTTP: Basic auth (username:password)
- MySQL: mysql_native_password scramble (SHA1 challenge-response)
- PostgreSQL: cleartext password message

Authorization is a coarse per-statement permission check
(reference `PermissionChecker`, src/auth/src/permission.rs).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "AuthError",
    "UserInfo",
    "UserProvider",
    "StaticUserProvider",
    "PermissionChecker",
    "user_provider_from_option",
    "mysql_native_scramble",
]


class AuthError(Exception):
    """Authentication / authorization failure (wire boundary error)."""


@dataclass(frozen=True)
class UserInfo:
    """Authenticated principal (reference src/auth/src/user_info.rs)."""

    username: str
    # coarse grants: statement kinds this user may run; None = all
    grants: Optional[frozenset] = None

    def can(self, permission: str) -> bool:
        return self.grants is None or permission in self.grants


class UserProvider:
    """Base provider (reference `UserProvider` trait,
    src/auth/src/user_provider.rs). Subclasses implement `lookup`."""

    name = "user_provider"

    def lookup(self, username: str) -> Optional[str]:
        """Return the stored plaintext password for `username`, or None
        if the user is unknown."""
        raise NotImplementedError

    # -- protocol-specific verification --------------------------------------

    def authenticate(self, username: str, password: str) -> UserInfo:
        stored = self.lookup(username)
        if stored is None or not hmac.compare_digest(
                stored.encode(), password.encode()):
            raise AuthError(f"access denied for user {username!r}")
        return UserInfo(username)

    def authenticate_basic(self, authorization_header: str) -> UserInfo:
        """HTTP `Authorization: Basic <b64>` (reference
        servers/src/http/authorize.rs)."""
        scheme, _, payload = authorization_header.partition(" ")
        if scheme.lower() != "basic" or not payload:
            raise AuthError("unsupported authorization scheme")
        try:
            decoded = base64.b64decode(payload.strip()).decode()
            username, _, password = decoded.partition(":")
        except Exception as e:  # noqa: BLE001 — wire boundary
            raise AuthError("malformed basic auth payload") from e
        return self.authenticate(username, password)

    def authenticate_mysql(self, username: str, auth_response: bytes,
                           salt: bytes) -> UserInfo:
        """mysql_native_password: client sends
        SHA1(pwd) XOR SHA1(salt + SHA1(SHA1(pwd)))."""
        stored = self.lookup(username)
        if stored is None:
            raise AuthError(f"access denied for user {username!r}")
        # empty stored password ⇒ client sends a zero-length auth response
        expect = mysql_native_scramble(stored, salt) if stored else b""
        if not hmac.compare_digest(auth_response, expect):
            raise AuthError(f"access denied for user {username!r}")
        return UserInfo(username)

    # back-compat shim for the earlier name-only hook used by the wire
    # servers before password auth landed
    def allow(self, username: str) -> bool:
        return self.lookup(username) is not None


class StaticUserProvider(UserProvider):
    """Fixed user/password table, from inline pairs or a credentials file
    (reference static_user_provider, src/auth/src/user_provider/
    static_user_provider.rs: `static_user_provider:file:<path>` and
    `static_user_provider:cmd:<u>=<p>[,<u>=<p>]`)."""

    name = "static_user_provider"

    def __init__(self, users: dict[str, str]):
        if not users:
            raise AuthError("static user provider needs at least one user")
        self._users = dict(users)

    @classmethod
    def from_pairs(cls, spec: str) -> "StaticUserProvider":
        users = {}
        for part in spec.split(","):
            user, sep, pwd = part.partition("=")
            if not sep or not user:
                raise AuthError(f"malformed user spec {part!r}")
            users[user.strip()] = pwd
        return cls(users)

    @classmethod
    def from_file(cls, path: str) -> "StaticUserProvider":
        if not os.path.exists(path):
            raise AuthError(f"user file {path!r} not found")
        users = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                user, sep, pwd = line.partition("=")
                if sep:
                    users[user.strip()] = pwd.strip()
        return cls(users)

    def lookup(self, username: str) -> Optional[str]:
        return self._users.get(username)


def user_provider_from_option(option: str) -> UserProvider:
    """Parse `--user-provider` style option strings (reference
    src/auth/src/lib.rs user_provider_from_option)."""
    kind, _, rest = option.partition(":")
    if kind != StaticUserProvider.name:
        raise AuthError(f"unknown user provider {kind!r}")
    mode, _, value = rest.partition(":")
    if mode == "file":
        return StaticUserProvider.from_file(value)
    if mode == "cmd":
        return StaticUserProvider.from_pairs(value)
    raise AuthError(f"unknown static provider mode {mode!r}")


def mysql_native_scramble(password: str, salt: bytes) -> bytes:
    """SHA1(pwd) XOR SHA1(salt + SHA1(SHA1(pwd))) per the MySQL
    native-password handshake."""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


# ---- authorization ----------------------------------------------------------


#: statement-class → permission name (reference permission.rs maps
#: Statement kinds to read/write requirements per catalog/schema)
_WRITE_STMTS = frozenset({
    "Insert", "Delete", "CreateTable", "CreateDatabase", "DropTable",
    "TruncateTable", "AlterTable", "CreateFlow", "DropFlow", "AdminFunc",
    "CreateView", "DropView",
    # COPY FROM writes into tables; COPY TO writes server-side files —
    # both require the write grant
    "CopyTable", "CopyDatabase",
})


class PermissionChecker:
    """Coarse statement authorization (reference `PermissionChecker`
    trait, src/auth/src/permission.rs). Deny reads/writes on protected
    schemas; consult the user's grants."""

    PROTECTED_SCHEMAS = frozenset({"greptime_private"})

    def check(self, user: Optional[UserInfo], stmt, db: str) -> None:
        kind = type(stmt).__name__
        needed = "write" if kind in _WRITE_STMTS else "read"
        self.check_access(user, needed, db)

    def check_access(self, user: Optional[UserInfo], needed: str,
                     db: str) -> None:
        """Grant + protected-schema check for a raw access kind — used by
        non-SQL entry points (Flight do_put bulk ingest, region scans)
        that don't carry a statement AST."""
        # protected-schema rule applies to every context, authenticated or
        # not: only the admin user may write greptime_private; reads are
        # allowed for everyone
        if db in self.PROTECTED_SCHEMAS and needed == "write" \
                and (user is None or user.username != "greptime"):
            raise AuthError(f"schema {db!r} is protected")
        if user is None:
            return
        if not user.can(needed):
            raise AuthError(
                f"user {user.username!r} lacks {needed} permission")
