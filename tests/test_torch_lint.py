"""gtpu-lint over the port (greptimedb_tpu_torch/lint, `python -m
greptimedb_tpu_torch.lint`) as a tier-1 gate: the twins of
tests/test_lint.py where they apply to the port, and the port's own
rules.

Fixture snippets prove each checker fires on known-bad code and stays
quiet on the near-miss it must not flag; the run over the port's tree
asserts zero unallowed findings. The runtime lockdep twin
(GTPU_TORCH_LOCKDEP=1) is exercised in subprocesses over the port's
multithreaded scan pool and admission, and across processes through its
dump directory. Nothing here compiles JAX: the file stays fast.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from greptimedb_tpu_torch.lint import (
    ALLOW_PATH,
    AllowEntry,
    Repo,
    SourceFile,
    apply_allowlist,
    load_repo,
    run_checkers,
)
from greptimedb_tpu_torch.lint import lockdep as rt_lockdep
from greptimedb_tpu_torch.lint.blocking import check as blocking_check
from greptimedb_tpu_torch.lint.datarace import check as datarace_check
from greptimedb_tpu_torch.lint.deadcode import check as deadcode_check
from greptimedb_tpu_torch.lint.deadline import check as deadline_check
from greptimedb_tpu_torch.lint.escape import check as escape_check
from greptimedb_tpu_torch.lint.fault_seam import check as fault_seam_check
from greptimedb_tpu_torch.lint.jax_imports import check as import_check
from greptimedb_tpu_torch.lint.lockgraph import build_edges
from greptimedb_tpu_torch.lint.lockgraph import check as lockdep_check
from greptimedb_tpu_torch.lint.metrics_options import (
    check_exemplars,
    check_metrics,
    check_options,
)
from greptimedb_tpu_torch.lint.span_coverage import check as span_check
from greptimedb_tpu_torch.lint.tracer import check as kernel_check
from greptimedb_tpu_torch.lint.typed_errors import check as typed_check

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "greptimedb_tpu_torch"


def fixture_repo(*files) -> Repo:
    """Repo of (path, source) fixtures; root='' disables the allowlist
    and the checkers that import the live process."""
    return Repo(root="", files=[SourceFile.from_text(p, textwrap.dedent(s))
                                for p, s in files])


@pytest.fixture(scope="module")
def repo_findings():
    """One full run over the port's tree, shared by the repo-wide tests
    (a run reads every file of the port and chip_smoke.py)."""
    return run_checkers(load_repo(REPO_ROOT))


# ---- fault-seam -------------------------------------------------------------


def test_fault_seam_fires_on_raw_io():
    repo = fixture_repo((f"{PKG}/storage/foo.py", """
        def save(path, data):
            with open(path, "wb") as f:
                f.write(data)
        """))
    found = fault_seam_check(repo)
    assert len(found) == 1 and "open()" in found[0].message


def test_fault_seam_quiet_in_seam_module_and_out_of_scope():
    seam = (f"{PKG}/storage/bar.py", """
        from greptimedb_tpu_torch.fault import FAULTS

        def append(path, blob):
            FAULTS.fire("wal.append")
            with open(path, "ab") as f:
                f.write(blob)
        """)
    elsewhere = (f"{PKG}/datasource/baz.py", """
        def dump(path, data):
            with open(path, "w") as f:
                f.write(data)
        """)
    assert fault_seam_check(fixture_repo(seam, elsewhere)) == []


def test_fault_seam_quiet_in_seam_subclass():
    base = (f"{PKG}/objectstore/__init__.py", """
        from greptimedb_tpu_torch.fault import FAULTS

        class ObjectStore:
            def read(self, key):
                FAULTS.fire("objectstore.read")
                return self._do_read(key)
        """)
    backend = (f"{PKG}/objectstore/mys3.py", """
        import urllib.request

        from greptimedb_tpu_torch.objectstore import ObjectStore

        class MyS3(ObjectStore):
            def _do_read(self, key):
                with urllib.request.urlopen(key) as r:
                    return r.read()
        """)
    assert fault_seam_check(fixture_repo(base, backend)) == []


def test_fault_seam_holds_the_flight_seams_by_name():
    path = f"{PKG}/servers/flight.py"
    bad = fixture_repo((path, """
        def _rpc(self, point, fn):
            return retry_call(fn, point=point)

        def _region_scan(self, req):
            FAULTS.fire("flight.do_put", side="server")

        def _region_write(self, path, t, user):
            return self.engine.put(1, t)
        """))
    msgs = sorted(f.message for f in fault_seam_check(bad))
    assert len(msgs) == 3
    assert "_region_scan() no longer fires flight.do_get" in msgs[0]
    assert "_region_write() no longer fires flight.do_put" in msgs[1]
    assert "_rpc() no longer fires its FAULTS point" in msgs[2]
    ok = fixture_repo((path, """
        def _rpc(self, point, fn):
            def op():
                FAULTS.fire(point, side="client")
                return fn()
            return retry_call(op, point=point)

        def _region_scan(self, req):
            FAULTS.fire("flight.do_get", side="server")

        def _region_write(self, path, t, user):
            FAULTS.fire("flight.do_put", side="server")
        """))
    assert fault_seam_check(ok) == []


@pytest.mark.parametrize("path,fn,point", [
    ("cluster/cluster.py", "beat", "datanode.crash"),
    ("meta/heartbeat.py", "beat", "heartbeat.send"),
    ("meta/election.py", "_lease_chaos", "election.lease"),
    ("servers/flight.py", "_region_frag", "flight.do_get"),
    ("cluster/process_cluster.py", "beat_all", "datanode.crash"),
    ("meta/kv_service.py", "_dispatch", "metasrv.kv"),
])
def test_fault_seam_holds_the_cluster_points_by_name(path, fn, point):
    """The cluster's control-plane points (and the region_frag ticket's
    seam) are held by name: a function that stops firing its point is a
    finding."""
    bad = fixture_repo((f"{PKG}/{path}", f"""
        def {fn}(self):
            return None
        """))
    msgs = [f.message for f in fault_seam_check(bad)]
    assert msgs == [f"{fn}() no longer fires {point} — chaos schedules "
                    "armed there would never fire"]
    ok = fixture_repo((f"{PKG}/{path}", f"""
        def {fn}(self):
            FAULTS.fire("{point}", node="dn-0")
        """))
    assert fault_seam_check(ok) == []


# ---- jax-import: the port's import rule -------------------------------------


@pytest.mark.parametrize("src,name", [
    ("import jax\n", "jax"),
    ("import jax.numpy as jnp\n", "jax.numpy"),
    ("from greptimedb_tpu.options import tomllib\n", "greptimedb_tpu.options"),
    ("def f():\n    import pyarrow.csv\n    return pyarrow.csv\n",
     "pyarrow.csv"),
    ("def f():\n    from jaxlib import xla_client\n", "jaxlib"),
    ("import importlib\n\ndef f():\n"
     "    return importlib.import_module('grpc')\n", "grpc"),
    ("import flatbuffers\n", "flatbuffers"),
    ("from google.protobuf import message\n", "google.protobuf"),
    ("import h2.connection\n", "h2.connection"),
    ("def f():\n    import hpack\n    return hpack\n", "hpack"),
    ("import hyperframe.frame\n", "hyperframe.frame"),
])
def test_import_rule_fires_top_level_and_lazy(src, name):
    found = import_check(fixture_repo((f"{PKG}/storage/kern.py", src)))
    assert len(found) == 1 and f"imports {name} " in found[0].message


@pytest.mark.parametrize("sub", ["partition", "meta", "procedure",
                                 "cluster"])
def test_import_rule_covers_the_cluster_packages(sub):
    """The import rule holds the in-process cluster's packages as the
    rest of the port: the repo the lint loads has their files, and an
    import of jax or of the JAX package there is a finding."""
    from greptimedb_tpu_torch.lint import load_repo

    assert any(f.path.startswith(f"{PKG}/{sub}/")
               for f in load_repo().files)
    found = import_check(fixture_repo((
        f"{PKG}/{sub}/x.py",
        "def f():\n    from greptimedb_tpu.meta import route\n")))
    assert len(found) == 1 and "greptimedb_tpu.meta" in found[0].message


def test_import_rule_fires_in_chip_smoke_and_names_where():
    found = import_check(fixture_repo(("chip_smoke.py", """
        import numpy as np

        def phase():
            import pyarrow
            return pyarrow
        """)))
    assert len(found) == 1 and "in phase()" in found[0].message


def test_import_rule_quiet_on_the_port_and_relative_imports():
    ok = (f"{PKG}/query/x.py", """
        import torch

        import greptimedb_tpu_torch
        from greptimedb_tpu_torch.ops import segment_kernels
        from . import planner
        from .expr import PlanError

        def f():
            import jax_like_name  # another package, not jax
            return torch, segment_kernels, planner, PlanError
        """)
    assert import_check(fixture_repo(ok)) == []


# ---- kernel-wrapper: the no-fallback rule -----------------------------------

KERNELS = (f"{PKG}/ops/segment_kernels.py", """
    import torch

    def segment_sum_plain(plane, ids, g):
        return plane

    def segment_sum(plane, ids, g):
        if plane.device.type == "cpu":
            return segment_sum_plain(plane, ids, g)
        from greptimedb_tpu_torch.ops import _build

        lib = _build.library()
        rc = lib.gtpu_segment_sum(plane.data_ptr())
        if rc:
            raise RuntimeError(rc)
        return plane
    """)


def test_kernel_wrapper_quiet_on_the_cpu_branch():
    assert kernel_check(fixture_repo(KERNELS)) == []


def test_kernel_wrapper_fires_on_try_except_fallback_to_plain():
    bad = (f"{PKG}/query/agg.py", """
        from greptimedb_tpu_torch.ops import segment_kernels as sk

        def dense(plane, ids, g):
            try:
                return sk.segment_sum(plane, ids, g)
            except RuntimeError:
                return sk.segment_sum_plain(plane, ids, g)
        """)
    msgs = [f.message for f in kernel_check(fixture_repo(KERNELS, bad))]
    assert any("handler around the kernel launch sk.segment_sum()"
               in m and "does not raise" in m for m in msgs)
    assert any("plain version sk.segment_sum_plain() in dense()" in m
               for m in msgs)


def test_kernel_wrapper_fires_on_env_switch_to_plain():
    bad = (f"{PKG}/query/agg.py", """
        import os

        from greptimedb_tpu_torch.ops import segment_kernels as sk

        PLAIN = os.environ.get("USE_PLAIN") == "1"

        def dense(plane, ids, g):
            if PLAIN:
                return sk.segment_sum_plain(plane, ids, g)
            return sk.segment_sum(plane, ids, g)

        def dense2(plane, ids, g):
            if os.getenv("X") or plane.device.type == "cpu":
                return sk.segment_sum_plain(plane, ids, g)
            return sk.segment_sum(plane, ids, g)
        """)
    found = kernel_check(fixture_repo(KERNELS, bad))
    assert len(found) == 2
    assert all("environment or configuration read" in f.message
               for f in found)


def test_kernel_wrapper_fires_on_degrade_latch_and_library_canary():
    bad = (f"{PKG}/query/agg.py", """
        from greptimedb_tpu_torch.ops import _build
        from greptimedb_tpu_torch.ops import segment_kernels as sk

        _FUSED_DISABLED = {"flag": False}
        _OFF = False

        def fused(vals, ids, g):
            global _OFF
            try:
                return sk.segment_sum(vals, ids, g)
            except Exception:
                _FUSED_DISABLED["flag"] = True
                _OFF = True
                raise

        def canary():
            try:
                _build.library()
                return True
            except OSError:
                return False
        """)
    msgs = [f.message for f in kernel_check(fixture_repo(KERNELS, bad))]
    assert sum("module-level latch" in m for m in msgs) == 2
    assert any("_FUSED_DISABLED" in m for m in msgs)
    assert any("_build.library()" in m and "does not raise" in m
               for m in msgs)


def test_kernel_wrapper_quiet_on_reraise_and_cpu_guard_in_callers():
    ok = (f"{PKG}/query/agg.py", """
        from greptimedb_tpu_torch.ops import segment_kernels as sk

        def dense(plane, ids, g):
            try:
                return sk.segment_sum(plane, ids, g)
            except RuntimeError as e:
                raise ValueError(str(e)) from e

        def reference(plane, ids, g):
            if plane.device.type != "cpu":
                return sk.segment_sum(plane, ids, g)
            else:
                return sk.segment_sum_plain(plane, ids, g)
        """)
    assert kernel_check(fixture_repo(KERNELS, ok)) == []


def test_kernel_wrapper_quiet_on_todays_wrappers(repo_findings):
    assert not [f for f in repo_findings if f.checker == "kernel-wrapper"
                and f.path.startswith(f"{PKG}/ops/")]
    assert not [f for f in repo_findings if f.checker == "kernel-wrapper"
                and not f.allowed]


# ---- typed-error ------------------------------------------------------------


def test_typed_error_fires_on_broad_except():
    repo = fixture_repo((f"{PKG}/servers/h.py", """
        def handle(self, req):
            try:
                return self.engine.execute(req)
            except Exception as e:
                return self.send(400, str(e))
        """))
    found = typed_check(repo)
    assert len(found) == 1 and "broad `except Exception`" in found[0].message


def test_typed_error_quiet_with_typed_branch_or_reraise():
    ok = (f"{PKG}/servers/h.py", """
        from greptimedb_tpu_torch.fault import Unavailable

        def handle(self, req):
            try:
                return self.engine.execute(req)
            except Unavailable as e:
                return self.send(503, str(e))
            except Exception as e:
                return self.send(400, str(e))

        def passthrough(self, req):
            try:
                return self.engine.execute(req)
            except Exception:
                self.log()
                raise
        """)
    assert typed_check(fixture_repo(ok)) == []


def test_typed_error_fires_on_bare_except():
    repo = fixture_repo((f"{PKG}/query/engine.py", """
        def handle(self, req):
            try:
                return self.engine.execute(req)
            except:
                return None
        """))
    assert any("bare `except:`" in f.message for f in typed_check(repo))


# ---- lockdep (static) -------------------------------------------------------

LOCK_CYCLE = (f"{PKG}/concurrency/pair.py", """
    import threading

    _lock_a = threading.Lock()
    _lock_b = threading.Lock()

    def fa():
        with _lock_a:
            grab_b()

    def grab_b():
        with _lock_b:
            pass

    def fb():
        with _lock_b:
            grab_a()

    def grab_a():
        with _lock_a:
            pass
    """)


def test_lockdep_static_finds_cycle():
    found = lockdep_check(fixture_repo(LOCK_CYCLE))
    assert any("lock-order cycle" in f.message for f in found)


def test_lockdep_static_quiet_on_consistent_order():
    ok = (f"{PKG}/shm/pair.py", """
        import threading

        class B:
            def __init__(self):
                self._lock = threading.Lock()

            def poke(self):
                with self._lock:
                    pass

        class A:
            def __init__(self):
                self._lock = threading.Lock()
                self._b = B()

            def do(self):
                with self._lock:
                    self._b.poke()
        """)
    repo = fixture_repo(ok)
    edges, _, _ = build_edges(repo)
    assert ("pair.A._lock", "pair.B._lock") in edges
    assert lockdep_check(repo) == []


def test_lockdep_static_flags_nonreentrant_self_nesting():
    bad = (f"{PKG}/objectstore/selfdead.py", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def do(self):
                with self._lock:
                    with self._lock:
                        pass
        """)
    assert any("self-deadlock" in f.message
               for f in lockdep_check(fixture_repo(bad)))


def test_lockdep_static_keeps_same_named_modules_apart():
    """storage/engine.py and flow/engine.py are distinct modules of the
    graph: the same function name in both makes no false edge."""
    a = (f"{PKG}/storage/engine.py", """
        import threading

        _lock = threading.Lock()

        def helper():
            with _lock:
                pass
        """)
    b = (f"{PKG}/flow/engine.py", """
        import threading

        _lock = threading.Lock()

        def helper():
            pass

        def tick():
            with _lock:
                helper()
        """)
    edges, _, _ = build_edges(fixture_repo(a, b))
    assert edges == {}


# ---- blocking ---------------------------------------------------------------


def test_blocking_fires_on_direct_sleep_under_lock():
    bad = (f"{PKG}/servers/napper.py", """
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def do(self):
                with self._lock:
                    time.sleep(1.0)
        """)
    assert any("time.sleep" in f.message and "C.do" in f.message
               for f in blocking_check(fixture_repo(bad)))


def test_blocking_fires_transitively_through_annotated_attr():
    bad = (f"{PKG}/storage/pipe.py", """
        import os
        import threading

        class Sink:
            def append(self, b):
                f = open("/tmp/x", "ab")
                f.write(b)
                os.fsync(f.fileno())

        class Holder:
            def __init__(self, wal: Sink):
                self._lock = threading.Lock()
                self.wal = wal

            def write(self, b):
                with self._lock:
                    self.wal.append(b)
        """)
    assert any("os.fsync" in f.message and "Holder.write" in f.message
               for f in blocking_check(fixture_repo(bad)))


def test_blocking_quiet_outside_lock_and_on_condition_wait():
    ok = (f"{PKG}/concurrency/pipe.py", """
        import os
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)

            def do(self, f):
                with self._lock:
                    pass
                time.sleep(0.01)
                os.fsync(f.fileno())
                with self._cv:
                    self._cv.wait(1.0)
        """)
    assert blocking_check(fixture_repo(ok)) == []


def test_blocking_guards_the_real_group_commit_path(repo_findings):
    found = [f for f in repo_findings if f.checker == "blocking"]
    assert not any("group_commit" in f.path for f in found), \
        [f.render() for f in found]
    serial = [f for f in found if "write_many_serial" in f.message]
    assert len(serial) == 1 and serial[0].allowed
    assert len(found) == 1


# ---- escape -----------------------------------------------------------------


def test_escape_fires_on_lambda_under_lock_into_pool():
    bad = (f"{PKG}/concurrency/cb.py", """
        import threading

        class C:
            def __init__(self, pool):
                self._lock = threading.Lock()
                self._q = []
                self._pool = pool

            def kick(self):
                with self._lock:
                    self._pool.submit(lambda: self._q.pop())
        """)
    found = escape_check(fixture_repo(bad))
    assert len(found) == 1
    assert "lambda" in found[0].message and "self._q" in found[0].message


def test_escape_fires_on_closure_into_thread_and_queue():
    bad = (f"{PKG}/flow/defer.py", """
        import threading

        class S:
            def __init__(self, q):
                self._lock = threading.Lock()
                self._jobs = {}
                self._q = q

            def go(self):
                with self._lock:
                    def drain():
                        return list(self._jobs)
                    threading.Thread(target=drain, daemon=True).start()
                    self._q.put(drain)
        """)
    found = escape_check(fixture_repo(bad))
    assert len(found) == 2
    assert all("closure drain()" in f.message for f in found)


def test_escape_fires_on_partial_wrapped_lambda():
    bad = (f"{PKG}/script/pw.py", """
        import functools
        import threading

        class C:
            def __init__(self, pool):
                self._lock = threading.Lock()
                self._n = 0
                self._pool = pool

            def kick(self):
                with self._lock:
                    self._pool.submit(functools.partial(
                        (lambda k: self._n + k), 3))
        """)
    found = escape_check(fixture_repo(bad))
    assert len(found) == 1 and "partial(lambda)" in found[0].message


def test_escape_quiet_on_safe_idioms():
    ok = (f"{PKG}/concurrency/okc.py", """
        import functools
        import threading

        def work(rows):
            return len(rows)

        class C:
            def __init__(self, pool):
                self._lock = threading.Lock()
                self._q = []
                self._pool = pool

            def _build(self, key):
                with self._lock:
                    return self._q.count(key)

            def kick(self, key):
                with self._lock:
                    self._pool.submit(self._build, key)
                    self._pool.submit(functools.partial(self._build, key))
                    self._pool.submit(work, list(self._q))
                    snapshot = list(self._q)
                self._pool.submit(lambda: self._q.pop())
                return snapshot
        """)
    assert escape_check(fixture_repo(ok)) == []


def test_escape_repo_is_clean(repo_findings):
    assert not [f for f in repo_findings if f.checker == "escape"]


# ---- datarace ---------------------------------------------------------------


def test_datarace_fires_on_bare_access_in_other_method():
    bad = (f"{PKG}/storage/counts.py", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def bump(self):
                with self._lock:
                    self._n += 1

            def reset(self):
                self._n = 0
        """)
    found = datarace_check(fixture_repo(bad))
    assert len(found) == 1
    assert "C._n" in found[0].message and "reset" in found[0].message


def test_datarace_quiet_on_locked_convention_and_immutable():
    ok = (f"{PKG}/concurrency/counts.py", '''
        import threading

        class C:
            def __init__(self, cap):
                self._lock = threading.Lock()
                self._n = 0
                self.cap = cap

            def bump(self):
                with self._lock:
                    self._bump_locked()

            def _bump_locked(self):
                self._n += 1

            def drain(self):
                """Caller holds self._lock."""
                self._n = 0

            def limit(self):
                return self.cap
        ''')
    assert datarace_check(fixture_repo(ok)) == []


def test_datarace_quiet_on_double_checked_same_method():
    ok = (f"{PKG}/shm/dc.py", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._v = None

            def get(self):
                if self._v is not None:
                    return self._v
                with self._lock:
                    if self._v is None:
                        self._v = object()
                    return self._v
        """)
    assert datarace_check(fixture_repo(ok)) == []


def test_datarace_quiet_without_any_lock():
    ok = (f"{PKG}/concurrency/plain.py", """
        class C:
            def __init__(self):
                self._n = 0

            def bump(self):
                self._n += 1
        """)
    assert datarace_check(fixture_repo(ok)) == []


def test_datarace_fixed_sites_stay_guarded(repo_findings):
    """The three bare accesses the first lint run found, now under their
    locks: the object store cache's and the hot set's byte counts, the
    file engine's cache drop."""
    bad = [f.message for f in repo_findings if f.checker == "datarace"]
    for name in ("LruCacheLayer._bytes", "DeviceCache._bytes",
                 "FileRegion._cache"):
        assert not any(name in m for m in bad), bad


# ---- deadline ---------------------------------------------------------------


def test_deadline_fires_on_unbounded_waits_in_serving_scope():
    bad = (f"{PKG}/servers/w.py", """
        def serve(ev, fut, q, t, sem):
            ev.wait()
            fut.result()
            q.get()
            t.join()
            sem.acquire()
        """)
    found = deadline_check(fixture_repo(bad))
    assert len(found) == 5


def test_deadline_quiet_with_timeouts_and_out_of_scope():
    ok = (f"{PKG}/query/w.py", """
        def serve(ev, fut, q, t, d):
            ev.wait(0.5)
            fut.result(timeout=1)
            q.get(timeout=1)
            t.join(0.1)
            d.get("key")
            ",".join(["a"])
        """)
    offline = (f"{PKG}/cli.py", "def main(t):\n    t.join()\n")
    assert deadline_check(fixture_repo(ok, offline)) == []


# ---- span_coverage ----------------------------------------------------------


def test_span_coverage_fires_on_uncovered_fault_site():
    repo = fixture_repo((f"{PKG}/storage/foo.py", """
        from greptimedb_tpu_torch.fault import FAULTS

        def push(data):
            FAULTS.fire("objectstore.write")
            do_io(data)
        """))
    found = span_check(repo)
    assert len(found) == 1 and "push()" in found[0].message


def test_span_coverage_quiet_inside_span_and_closure_under_span():
    repo = fixture_repo((f"{PKG}/storage/foo.py", """
        from greptimedb_tpu_torch.fault import FAULTS
        from greptimedb_tpu_torch.utils import tracing

        def push(data):
            with tracing.span("objectstore_write", bytes=len(data)):
                FAULTS.fire("objectstore.write")
                do_io(data)

        def append(data):
            with tracing.span("wal_append"):
                def attempt():
                    FAULTS.mangled_write("wal.append", data, sink)
                retry_call(attempt, point="wal.append")
        """))
    assert span_check(repo) == []


@pytest.mark.parametrize("path,fn", [
    ("servers/mysql.py", "_dispatch"),
    ("servers/postgres.py", "_run_simple"),
    ("servers/http.py", "_route"),
    ("servers/opentsdb.py", "handle"),
])
def test_span_coverage_wire_entries(path, fn):
    bad = fixture_repo((f"{PKG}/{path}", f"""
        def {fn}(engine, sql, ctx):
            return engine.execute_one(sql, ctx)
        """))
    found = span_check(bad)
    assert len(found) == 1 and f"wire entry point {fn}()" in \
        found[0].message
    ok = fixture_repo((f"{PKG}/{path}", f"""
        def {fn}(engine, sql, ctx):
            with tracing.request_span("x:query"):
                return engine.execute_one(sql, ctx)
        """))
    assert span_check(ok) == []


def test_span_coverage_flight_entries_and_spans():
    path = f"{PKG}/servers/flight.py"
    names = ("flight:sql", "flight:tql", "region_scan", "region_write",
             "flight_rpc", "remote_region_scan", "remote_region_write")
    spans = "\n".join(f"    with tracing.span({n!r}):\n        pass"
                      for n in names)
    entries = "\n\n".join(
        f"def {fn}(self, req):\n    with tracing.adopt_remote(None):\n"
        "        pass" for fn in ("_query", "_region_scan", "_region_write"))
    ok = fixture_repo((path, f"def spans():\n{spans}\n\n{entries}\n"))
    assert span_check(ok) == []
    bad = fixture_repo((path, "def _query(self, req):\n"
                              "    return self.qe.execute_one(req)\n"))
    msgs = [f.message for f in span_check(bad)]
    assert len(msgs) == 8
    assert sum("is no longer opened here" in m for m in msgs) == 7
    assert any("wire entry point _query()" in m for m in msgs)


# ---- deadcode ---------------------------------------------------------------


def test_deadcode_unused_import_fires_noqa_quiet():
    bad = (f"{PKG}/x.py", "import os\nimport sys\n\nprint(sys.argv)\n")
    assert any("unused import 'os'" in f.message
               for f in deadcode_check(fixture_repo(bad)))
    ok = (f"{PKG}/x.py",
          "import os  # noqa: F401 — re-export\nimport sys\n\n"
          "print(sys.argv)\n")
    assert deadcode_check(fixture_repo(ok)) == []


def test_deadcode_unreachable_statement_fires():
    bad = (f"{PKG}/x.py", "def f():\n    return 1\n    print('never')\n")
    assert any("unreachable" in f.message
               for f in deadcode_check(fixture_repo(bad)))


def test_deadcode_chip_smoke_keeps_a_name_alive():
    """chip_smoke.py is linted with the port: a probe only it reads is
    not dead."""
    a = (f"{PKG}/a.py", "ZQXW_PROBE = 7\n")
    smoke = ("chip_smoke.py",
             "from greptimedb_tpu_torch.a import ZQXW_PROBE\n\n"
             "print(ZQXW_PROBE)\n")
    assert not [f for f in deadcode_check(fixture_repo(a, smoke))
                if "ZQXW_PROBE" in f.message]
    assert any("ZQXW_PROBE" in f.message
               for f in deadcode_check(fixture_repo(a)))


# ---- metrics, exemplars, options --------------------------------------------


def test_metrics_checker_flags_an_uncharted_metric():
    from greptimedb_tpu_torch.utils.metrics import REGISTRY, Counter

    repo = Repo(root=REPO_ROOT, files=[])
    assert check_metrics(repo) == []
    fake = Counter("greptimedb_tpu_zz_not_charted_total", "help")
    REGISTRY._metrics.append(fake)
    try:
        found = check_metrics(repo)
    finally:
        REGISTRY._metrics.remove(fake)
    assert len(found) == 1 and "not referenced by any panel" in \
        found[0].message


def test_exemplars_fires_on_hot_histogram_without_exemplars():
    bad = (f"{PKG}/utils/m.py", """
        A = REGISTRY.histogram("greptimedb_tpu_query_x_seconds", "h")
        B = REGISTRY.histogram("greptimedb_tpu_query_y_seconds", "h",
                               exemplars=True)
        C = REGISTRY.histogram("greptimedb_tpu_flush_seconds", "h")
        """)
    found = check_exemplars(fixture_repo(bad))
    assert len(found) == 1 and "query_x_seconds" in found[0].message


def test_options_checker_flags_stale_docs_and_refusals(monkeypatch):
    from greptimedb_tpu_torch import options

    repo = Repo(root=REPO_ROOT, files=[])
    assert check_options(repo) == []
    monkeypatch.setitem(options._UNPORTED, "query.no_such_key",
                        ("ROADMAP X", ()))
    monkeypatch.setitem(options._DOC, "no_such.section_key", "stale")
    doc = dict(options._DOC)
    doc.pop("http.addr")
    monkeypatch.setattr(options, "_DOC", doc)
    msgs = [f.message for f in check_options(repo)]
    assert any("_UNPORTED key 'query.no_such_key'" in m for m in msgs)
    assert any("'no_such.section_key' names no existing option" in m
               for m in msgs)
    assert any("option 'http.addr' has no _DOC entry" in m for m in msgs)


# ---- allowlist --------------------------------------------------------------


def test_allowlist_suppresses_and_requires_match():
    repo = fixture_repo((f"{PKG}/servers/h.py", """
        def handle(self, req):
            try:
                return 1
            except Exception:
                return None
        """))
    found = typed_check(repo)
    assert found and not found[0].allowed
    entry = AllowEntry(checker="typed-error", path=f"{PKG}/servers/*.py",
                       match="in handle()", reason="fixture")
    assert apply_allowlist(found, [entry])[0].allowed and entry.used == 1
    miss = AllowEntry(checker="typed-error", path=f"{PKG}/servers/*.py",
                      match="in other()", reason="fixture")
    out = apply_allowlist(typed_check(repo), [miss])
    assert not out[0].allowed and miss.used == 0


def test_unused_allow_entry_is_a_finding(tmp_path):
    dash = tmp_path / "grafana" / "greptimedb_tpu.json"
    dash.parent.mkdir()
    with open(os.path.join(REPO_ROOT, "grafana", "greptimedb_tpu.json"),
              "rb") as f:
        dash.write_bytes(f.read())
    allow = tmp_path / ALLOW_PATH
    allow.parent.mkdir(parents=True)
    allow.write_text('[[allow]]\nchecker = "deadcode"\npath = "*"\n'
                     'match = "never matches"\nreason = "stale"\n')
    findings = run_checkers(Repo(root=str(tmp_path), files=[]))
    assert [f.checker for f in findings] == ["allowlist"]
    allow.write_text('[[allow]]\nchecker = "deadcode"\npath = "*"\n')
    with pytest.raises(ValueError, match="reason"):
        run_checkers(Repo(root=str(tmp_path), files=[]))


# ---- the port's tree --------------------------------------------------------


def test_port_has_zero_unallowed_findings(repo_findings):
    """The gate: every checker over the port and chip_smoke.py, the
    allowlist applied, nothing unallowed, and every allow entry used."""
    bad = [f.render() for f in repo_findings if not f.allowed]
    assert bad == [], "\n".join(bad)
    assert not [f for f in repo_findings if f.checker == "allowlist"]
    linted = {f.path for f in load_repo(REPO_ROOT).files}
    assert "chip_smoke.py" in linted
    assert not [p for p in linted if not (p == "chip_smoke.py"
                                          or p.startswith(f"{PKG}/"))]


def test_changed_only_filters_to_given_paths():
    path = f"{PKG}/storage/region.py"
    findings = run_checkers(load_repo(REPO_ROOT), names=["blocking",
                                                         "datarace"],
                            changed_only={path})
    assert findings and all(f.path == path for f in findings)


def test_cli_json_output_and_no_jax_or_pyarrow():
    """`python -m greptimedb_tpu_torch.lint --all --json` in a process of
    its own: exit 0, the allowed findings in the JSON, and neither jax,
    the JAX package nor pyarrow loaded by the lint."""
    code = ("import runpy, sys\n"
            "sys.argv = ['lint', '--all', '--json', '--verbose']\n"
            "try:\n"
            "    runpy.run_module('greptimedb_tpu_torch.lint', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'greptimedb_tpu', 'pyarrow', 'grpc'))\n"
            "print('LOADED=' + ','.join(bad))\n"
            "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out, loaded = res.stdout.rsplit("LOADED=", 1)
    assert loaded.strip() == ""
    payload = json.loads(out[out.index("["):])
    assert payload and all(f["allowed"] for f in payload)
    assert {f["checker"] for f in payload} >= {"kernel-wrapper",
                                               "deadline", "span_coverage"}


# ---- runtime lockdep --------------------------------------------------------


def test_runtime_lockdep_reversal_detection():
    rt_lockdep.reset()
    try:
        rt_lockdep._on_acquired("a.py:1")
        rt_lockdep._on_acquired("b.py:2")   # A -> B
        rt_lockdep._on_released("b.py:2")
        rt_lockdep._on_released("a.py:1")
        rt_lockdep.assert_acyclic()
        rt_lockdep._on_acquired("b.py:2")
        rt_lockdep._on_acquired("a.py:1")   # B -> A: reversal
        rt_lockdep._on_released("a.py:1")
        rt_lockdep._on_released("b.py:2")
        with pytest.raises(rt_lockdep.LockOrderViolation):
            rt_lockdep.assert_acyclic()
    finally:
        rt_lockdep.reset()


def test_runtime_lockdep_does_not_wrap_another_installer():
    """A process that already patched threading.Lock (the JAX package's
    GTPU_LOCKDEP=1 installer, say) keeps its wrapper: the port's
    install() does nothing rather than wrap it."""
    code = ("import threading\n"
            "orig = threading.Lock\n"
            "threading.Lock = lambda: orig()\n"
            "from greptimedb_tpu_torch.lint import lockdep\n"
            "lockdep.install()\n"
            "assert not lockdep.enabled()\n"
            "threading.Lock = orig\n"
            "lockdep.install()\n"
            "assert lockdep.enabled()\n"
            "lock = threading.Lock()\n"
            "assert 'test_torch_lint' in repr(lock) or '<string>' in "
            "repr(lock), repr(lock)\n"
            "lockdep.uninstall()\n"
            "print('OK')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "GTPU_TORCH_LOCKDEP": "0"})
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr


_LOCKDEP_SCRIPT = """
import os, sys, tempfile, threading
import greptimedb_tpu_torch
from greptimedb_tpu_torch.lint import lockdep
assert lockdep.enabled(), "GTPU_TORCH_LOCKDEP=1 did not install"

from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

with tempfile.TemporaryDirectory() as d:
    eng = RegionEngine(EngineConfig(data_dir=d, scan_decode_threads=2),
                       device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), eng, device="cpu")
    ctx = QueryContext(db="public")
    qe.execute_sql("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX,"
                   " v DOUBLE, PRIMARY KEY(host))", ctx)
    for start in (1700000000000, 1700000100000):
        vals = ",".join(f"('h{i % 3}', {start + i}, {i * 0.5})"
                        for i in range(120))
        qe.execute_sql(f"INSERT INTO t VALUES {vals}", ctx)
        r = qe.execute_sql("ADMIN flush_table('t')", ctx)[-1]
        eng.maintenance.wait(int(r.rows()[0][0]), timeout=60)
    errs = []
    def worker():
        try:
            for _ in range(4):
                qe.execute_sql("SELECT host, count(*), avg(v) FROM t"
                               " GROUP BY host", ctx)
        except Exception as e:
            errs.append(e)
    threads = [threading.Thread(target=worker) for _ in range(6)]
    [t.start() for t in threads]
    [t.join(120) for t in threads]
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    qe.concurrency.shutdown()
    eng.close()

rep = lockdep.assert_acyclic()
port_edges = [e for e in rep["edges"]
              if all("greptimedb_tpu_torch" in s for s in e)]
assert port_edges, "no port lock nesting observed"
assert any("admission.py" in a for a, b in port_edges), port_edges
assert not any("greptimedb_tpu/" in s for e in rep["edges"] for s in e)
print(f"LOCKDEP_EDGES={len(port_edges)}")
if os.environ.get("GTPU_TORCH_LOCKDEP_DIR"):
    print("DUMPED=" + lockdep.dump())
"""


def test_runtime_lockdep_under_scan_pool_and_admission(tmp_path):
    """GTPU_TORCH_LOCKDEP=1 over the port's multithreaded path: 6 threads
    of GROUP BY queries through admission slots (GTPU_MAX_CONCURRENCY=2
    forces the queued slow path, which takes the admission lock) and the
    2-worker scan decode pool. The observed nesting is acyclic, includes
    the admission lock, and keys every lock on the port's own paths. The
    child's dump merges into this process's report."""
    dump_dir = tmp_path / "lockdep"
    res = subprocess.run(
        [sys.executable, "-c", _LOCKDEP_SCRIPT],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env={**os.environ, "GTPU_TORCH_LOCKDEP": "1",
             "GTPU_TORCH_LOCKDEP_DIR": str(dump_dir),
             "GTPU_MAX_CONCURRENCY": "2", "GTPU_SLOW_QUERY_MS": "600000"})
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    n = int(res.stdout.split("LOCKDEP_EDGES=")[1].split()[0])
    rt_lockdep.reset()
    try:
        merged = rt_lockdep.assert_acyclic_merged(str(dump_dir))
    finally:
        rt_lockdep.reset()
    assert merged["processes"] >= 2
    assert len([e for e in merged["edges"]
                if all("greptimedb_tpu_torch" in s for s in e)]) >= n


def test_runtime_lockdep_merge_finds_a_cross_process_cycle(tmp_path):
    """Two processes each nest two locks consistently, in opposite
    orders: neither sees a cycle alone, the merged graph does (the
    serving fabric's case: N frontends on one box)."""
    for i, order in enumerate((("a.py:1", "b.py:2"), ("b.py:2", "a.py:1"))):
        (tmp_path / f"lockdep-{100 + i}.json").write_text(json.dumps(
            {"pid": 100 + i, "edges": [list(order)], "violations": []}))
    rt_lockdep.reset()
    try:
        with pytest.raises(rt_lockdep.LockOrderViolation,
                           match="merged"):
            rt_lockdep.assert_acyclic_merged(str(tmp_path))
    finally:
        rt_lockdep.reset()
