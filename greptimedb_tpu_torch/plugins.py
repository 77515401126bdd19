"""Plugin system (copy of greptimedb_tpu/plugins.py): a typed extension
container and its hook points.

Mirrors the reference's plugins crate (a typed `Plugins` map threaded
through frontend/datanode/metasrv construction, src/common/plugins) plus
its two concrete extension seams:

- `Plugins`: a by-type container; components `insert` implementations
  and others `get` them without hard dependencies.
- function plugins: objects with `scalar_functions() -> {name: fn}`
  registered here become SQL scalar functions (the reference's
  FunctionRegistry::register path).
- request interceptors: `on_sql(sql, ctx) -> sql` rewrite/veto hooks the
  query engine runs before parsing (reference SqlQueryInterceptor,
  frontend/src/instance.rs).

`load_from_env()` imports modules named in GREPTIMEDB_TPU_PLUGINS
(comma-separated); each must expose `setup(plugins)`.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Callable, Optional, Type, TypeVar

import contextvars

T = TypeVar("T")

_default: Optional["Plugins"] = None
_default_lock = threading.Lock()

#: the Plugins container of the engine currently executing a statement —
#: expression evaluation resolves scalar functions through this so a
#: QueryEngine constructed with a custom container sees ITS functions,
#: not only the process default
_active: "contextvars.ContextVar[Optional[Plugins]]" = \
    contextvars.ContextVar("gtpu_active_plugins", default=None)


def active_plugins() -> "Plugins":
    return _active.get() or default_plugins()


def set_active(plugins: "Plugins"):
    """Returns a token for contextvars reset."""
    return _active.set(plugins)


def reset_active(token) -> None:
    _active.reset(token)


def default_plugins() -> "Plugins":
    """Process-wide default container (what standalone mode threads
    through engine + servers when no explicit Plugins is passed).
    Publication happens only after a successful env load — a broken
    plugin module raises on EVERY call instead of leaving a silently
    partial container behind."""
    global _default
    with _default_lock:
        if _default is None:
            p = Plugins()
            p.load_from_env()
            _default = p
        return _default


class Plugins:
    """Typed plugin container (reference plugins::Plugins)."""

    def __init__(self):
        self._by_type: dict[type, object] = {}
        self._scalar_functions: dict[str, Callable] = {}
        self._sql_interceptors: list[Callable] = []
        self._lock = threading.Lock()

    # ---------------------------------------------------------- container
    def insert(self, value: object) -> None:
        with self._lock:
            self._by_type[type(value)] = value

    def get(self, cls: Type[T]) -> Optional[T]:
        with self._lock:
            return self._by_type.get(cls)  # type: ignore[return-value]

    # -------------------------------------------------------------- hooks
    def register_scalar_function(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._scalar_functions[name.lower()] = fn

    def scalar_function(self, name: str) -> Optional[Callable]:
        with self._lock:
            return self._scalar_functions.get(name.lower())

    def register_sql_interceptor(self, fn: Callable) -> None:
        """fn(sql, ctx) -> sql; raise to veto the statement."""
        with self._lock:
            self._sql_interceptors.append(fn)

    def intercept_sql(self, sql: str, ctx) -> str:
        for fn in list(self._sql_interceptors):
            sql = fn(sql, ctx)
        return sql

    # ------------------------------------------------------------ loading
    def setup_module(self, module_name: str) -> None:
        mod = importlib.import_module(module_name)
        setup = getattr(mod, "setup", None)
        if setup is None:
            raise ValueError(
                f"plugin module {module_name!r} has no setup(plugins)")
        setup(self)

    def load_from_env(self, var: str = "GREPTIMEDB_TPU_PLUGINS") -> list[str]:
        loaded = []
        for name in filter(None, os.environ.get(var, "").split(",")):
            self.setup_module(name.strip())
            loaded.append(name.strip())
        return loaded
