"""fault-seam: direct I/O in the storage plane must route through the
FaultRegistry seams.

The port threads `FAULTS.fire`/`FAULTS.mangle*` through its I/O edges
(objectstore.read/write, wal.append/replay, ingest.commit,
maintenance.job) so chaos schedules exercise the failures the
reference survives. The invariant: a module in `storage/` or
`objectstore/` performing raw file/socket I/O is either (a) a seam
implementation — it fires the registry itself, or its class subclasses
a base defined in a seam module (the object-store backends implement
`_read_impl`/`_write_impl` behind the FAULTS-wrapping `ObjStore`
base) — or (b) bypassing chaos coverage: a fault schedule armed at the
matching point would never fire on that path. (b) is a finding.

Left out, having no FAULTS point in either package: `shm/` (the
fabric's shared segment), `datasource/` (COPY's and the external
tables' user-named files), `servers/` apart from Flight, `flow/`,
`script/` and `ingest.py` (no raw I/O: they reach storage through the
engine).

Flight's seams are held by name (`REQUIRED_SEAMS`): its RPCs cross the
gRPC transport (`servers/grpc.py`, `servers/h2.py`), whose sockets
carry no seam of their own, so the functions that must fire
`flight.do_get` / `flight.do_put` (the client's `_rpc`, the server's
`_region_scan`, `_region_frag` and `_region_write`) are named, and one
that stops firing is a finding. So are the cluster's control-plane
points, whose seams have no raw I/O: a datanode's beat
(`datanode.crash`, the in-process Datanode's and the process cluster's
parent beating for its children), the heartbeat it sends
(`heartbeat.send`), the election's lease (`election.lease`) and the
metadata KV's dispatch over HTTP (`metasrv.kv`).
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import (
    call_name,
    enclosing_function,
    iter_calls,
)

SCOPE_PREFIXES = (
    "greptimedb_tpu_torch/storage/",
    "greptimedb_tpu_torch/objectstore/",
)

#: raw-I/O entry points whose use bypasses the registry
IO_CALLS = frozenset({
    "open",
    "os.replace", "os.rename", "os.remove", "os.unlink", "os.truncate",
    "urllib.request.urlopen",
    "socket.socket", "socket.create_connection",
    "shutil.copy", "shutil.copyfile", "shutil.move", "shutil.rmtree",
})


#: (repo path) -> {function: the point it must fire (None: any point,
#: the caller passes it in)}
REQUIRED_SEAMS = {
    "greptimedb_tpu_torch/servers/flight.py": {
        "_rpc": None, "_region_scan": "flight.do_get",
        "_region_frag": "flight.do_get", "_region_write": "flight.do_put"},
    "greptimedb_tpu_torch/cluster/cluster.py": {"beat": "datanode.crash"},
    "greptimedb_tpu_torch/cluster/process_cluster.py": {
        "beat_all": "datanode.crash"},
    "greptimedb_tpu_torch/meta/kv_service.py": {"_dispatch": "metasrv.kv"},
    "greptimedb_tpu_torch/meta/heartbeat.py": {"beat": "heartbeat.send"},
    "greptimedb_tpu_torch/meta/election.py": {
        "_lease_chaos": "election.lease"},
}


def _fires(fn: ast.AST, point) -> bool:
    for call in iter_calls(fn):
        if call_name(call) != "FAULTS.fire" or not call.args:
            continue
        arg = call.args[0]
        if point is None or (isinstance(arg, ast.Constant)
                             and arg.value == point):
            return True
    return False


def _required_seams(f) -> list:
    out = []
    for fn_name, point in REQUIRED_SEAMS.get(f.path, {}).items():
        for fn in ast.walk(f.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name == fn_name and not _fires(fn, point):
                out.append(Finding(
                    "fault-seam", f.path, fn.lineno,
                    f"{fn_name}() no longer fires "
                    f"{point or 'its FAULTS point'} — chaos schedules "
                    "armed there would never fire"))
    return out


def _uses_faults(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "FAULTS":
            return True
    return False


def _seam_base_names(repo: Repo) -> set:
    """Class names defined in seam modules (modules that use FAULTS)
    inside the scope — subclassing one marks the subclass as a seam
    implementation (its raw I/O sits *behind* the registry wrapper)."""
    out = set()
    for f in repo.files:
        if not f.path.startswith(SCOPE_PREFIXES):
            continue
        if not _uses_faults(f.tree):
            continue
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                out.add(node.name)
    return out


@checker("fault-seam")
def check(repo: Repo) -> list:
    seam_bases = _seam_base_names(repo)
    findings = []
    for f in repo.files:
        findings += _required_seams(f)
        if not f.path.startswith(SCOPE_PREFIXES):
            continue
        if _uses_faults(f.tree):
            continue  # seam implementation module
        exempt_classes = set()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                bases = {b.id if isinstance(b, ast.Name) else
                         getattr(b, "attr", "") for b in node.bases}
                if bases & seam_bases:
                    exempt_classes.add(node)
        for call in iter_calls(f.tree):
            name = call_name(call)
            if name not in IO_CALLS:
                continue
            in_exempt = any(
                cls.lineno <= call.lineno <= max(
                    (n.lineno for n in ast.walk(cls)
                     if hasattr(n, "lineno")), default=cls.lineno)
                for cls in exempt_classes)
            if in_exempt:
                continue
            findings.append(Finding(
                "fault-seam", f.path, call.lineno,
                f"direct I/O call {name}() in "
                f"{enclosing_function(f.tree, call)}() bypasses the "
                "FaultRegistry seams — route it through the "
                "objectstore/WAL seam or fire the matching FAULTS "
                "point"))
    return findings
