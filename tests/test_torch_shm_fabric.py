"""The port's cross-process serving fabric (greptimedb_tpu_torch/shm/)
held against the JAX package's on the CPU: the twin of
tests/test_shm_fabric.py with `device="cpu"` engines (the segment, the
SIGKILL-mid-publish chaos, peer adoption through the fast lane and the
plan cache, peer-DDL invalidation, byte identity with the fabric on and
off, the result arena, the worker-metrics bridge, the gauges), plus the
layout parity of the two packages' segments and the rows of two
fabric-on port engines against the JAX engine's.

Every test leaves no /dev/shm segment (the `fabric_dir` fixture checks),
no child process and no thread behind.
"""

import json
import os
import pickle
import signal
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.shm import fabric as jfabric
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch import shm
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import (
    ConcurrencyConfig,
    ConcurrencyPlane,
)
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.shm import fabric as fabric_mod
from greptimedb_tpu_torch.shm.fabric import Fabric, FabricError, segment_name
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines here decode SST parts inline: the JAX package's
    process-wide decode pool would leave idle worker threads in this test
    process, and tests/test_profile_plane.py's sampler counts them when
    xdist runs that file later on the same worker."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def make_qe(tmp_path, plane=None, sub="a"):
    engine = RegionEngine(EngineConfig(
        data_dir=str(tmp_path / f"data_{sub}"), maintenance_workers=0),
        device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu",
                     concurrency=plane)
    return engine, qe


def create_cpu(qe):
    qe.execute_one(
        "CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) "
        "TIME INDEX, PRIMARY KEY(host))")


def ingest(qe, hosts=4, points=40):
    rows = []
    for h in range(hosts):
        for i in range(points):
            rows.append(f"('h{h}', {float((h + 1) * (i % 7))}, "
                        f"{i * 1000})")
    qe.execute_one("INSERT INTO cpu (host, v, ts) VALUES "
                   + ",".join(rows))


DASH = ("SELECT date_bin(INTERVAL '1 minute', ts) AS minute, max(v), "
        "sum(v) FROM cpu WHERE host = '{host}' AND ts >= {lo} AND "
        "ts < {hi} GROUP BY minute")


@pytest.fixture
def fabric_dir(tmp_path):
    """A private fabric directory whose segments provably do not
    outlive the test, and no thread or child process either."""
    d = str(tmp_path / "fabric")
    names = [segment_name(d), segment_name(os.path.join(d, "arena"))]
    threads0 = set(threading.enumerate())
    yield d
    shm.shutdown_fabric()
    from greptimedb_tpu import shm as jshm

    jshm.shutdown_fabric()
    leftovers = [n for n in names if os.path.exists("/dev/shm/" + n)]
    for n in leftovers:
        fabric_mod._unlink_segment(n)
    assert leftovers == [], f"leaked shared-memory segments: {leftovers}"
    import multiprocessing

    assert multiprocessing.active_children() == []
    extra = [t.name for t in set(threading.enumerate()) - threads0
             if t.is_alive()]
    assert extra == [], f"threads left behind: {extra}"


@pytest.fixture
def fabric_env(fabric_dir, monkeypatch):
    """The fabric switched on for this process, the singleton reset on
    both sides so other tests never see a stale attach. The JAX
    package's shared XLA cache stays off (a JAX plane built here must
    not point the process-global cache into a deleted tmp dir)."""
    shm.shutdown_fabric()
    monkeypatch.setenv("GTPU_SHM_FABRIC", "1")
    monkeypatch.setenv("GTPU_SHM_FABRIC_DIR", fabric_dir)
    monkeypatch.setenv("GREPTIMEDB_TPU_COMPILATION_CACHE_DIR", "off")
    yield fabric_dir
    shm.shutdown_fabric()


# ---- fabric segment primitives ---------------------------------------------


class TestFabricSegment:
    def test_put_get_across_two_attached_instances(self, fabric_dir):
        a = Fabric(fabric_dir, size=2 << 20)
        b = Fabric(fabric_dir, size=2 << 20)
        try:
            assert a.put("tpl", b"k1", b"payload-1")
            assert b.get("tpl", b"k1") == b"payload-1"
            # overwrite in place: latest value wins for both
            assert b.put("tpl", b"k1", b"payload-2")
            assert a.get("tpl", b"k1") == b"payload-2"
            # kinds are separate namespaces over the same key bytes
            assert a.get("plan", b"k1") is None
        finally:
            a.close()
            b.close()

    def test_versions_bump_monotonic_and_shared(self, fabric_dir):
        a = Fabric(fabric_dir, size=2 << 20)
        b = Fabric(fabric_dir, size=2 << 20)
        try:
            assert a.version("public", "cpu") == 0
            assert a.bump_version("public", "cpu") == 1
            assert b.version("public", "cpu") == 1
            assert b.bump_version("public", "cpu") == 2
            assert a.version("public", "cpu") == 2
            assert a.version("public", "mem") == 0
        finally:
            a.close()
            b.close()

    def test_wipe_drops_artifacts_and_epoch_guards_readers(
            self, fabric_dir):
        a = Fabric(fabric_dir, size=2 << 20)
        b = Fabric(fabric_dir, size=2 << 20)
        try:
            a.put("tpl", b"k", b"v")
            epoch = a.stats()["epoch"]
            a.wipe()
            assert b.stats()["epoch"] == epoch + 1
            assert b.get("tpl", b"k") is None
            # the fabric stays writable after a wipe
            assert b.put("tpl", b"k", b"v2")
            assert a.get("tpl", b"k") == b"v2"
        finally:
            a.close()
            b.close()

    def test_corrupt_slot_is_refused_not_propagated(self, fabric_dir):
        a = Fabric(fabric_dir, size=2 << 20)
        try:
            a.put("tpl", b"k", b"v")
            # smash the slot's value length out of bounds with a STABLE
            # (even) generation: a reader classifies it as corruption
            # (typed), never returns garbage bytes
            hdr, slot = fabric_mod._HDR, fabric_mod._SLOT
            poisoned = 0
            slots = hdr.unpack_from(a._shm.buf, 0)[2]
            for i in range(slots):
                off = hdr.size + i * slot.size
                gen, khash, klen, vlen, koff = slot.unpack_from(
                    a._shm.buf, off)
                if gen and gen % 2 == 0:
                    slot.pack_into(a._shm.buf, off, gen, khash, klen,
                                   2 ** 31, koff)
                    poisoned += 1
            assert poisoned
            with pytest.raises(FabricError):
                a.get("tpl", b"k")
        finally:
            a.close()

    def test_attach_refuses_alien_layout_version(self, fabric_dir):
        a = Fabric(fabric_dir, size=2 << 20)
        try:
            struct.pack_into("<I", a._shm.buf, 8, 99)
            with pytest.raises(FabricError):
                Fabric(fabric_dir, size=2 << 20)
        finally:
            struct.pack_into("<I", a._shm.buf, 8,
                             fabric_mod.FABRIC_VERSION)
            a.close()

    def test_get_fabric_degrades_to_none_on_bad_segment(
            self, fabric_env):
        from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

        a = Fabric(fabric_env, size=2 << 20)
        try:
            struct.pack_into("<I", a._shm.buf, 8, 99)
            shm.shutdown_fabric()  # reset the singleton latch
            d0 = SHM_FABRIC_EVENTS.total(event="detach", kind="fabric")
            assert shm.get_fabric() is None
            assert SHM_FABRIC_EVENTS.total(
                event="detach", kind="fabric") == d0 + 1
        finally:
            struct.pack_into("<I", a._shm.buf, 8,
                             fabric_mod.FABRIC_VERSION)
            a.close()

    def test_oversized_value_is_not_shared_but_not_fatal(
            self, fabric_dir):
        a = Fabric(fabric_dir, size=2 << 20)
        try:
            assert a.put("tpl", b"big", b"x" * (4 << 20)) is False
            assert a.get("tpl", b"big") is None
            assert a.put("tpl", b"ok", b"y")
        finally:
            a.close()

    def test_last_process_out_unlinks_the_segment(self, fabric_dir):
        name = segment_name(fabric_dir)
        a = Fabric(fabric_dir, size=2 << 20)
        b = Fabric(fabric_dir, size=2 << 20)
        a.close()
        assert os.path.exists("/dev/shm/" + name)  # b still attached
        b.close()
        assert not os.path.exists("/dev/shm/" + name)

    def test_unreservable_segment_is_a_typed_refusal(self, fabric_dir,
                                                     monkeypatch):
        """A /dev/shm too small for the segment fails at attach (a
        FabricError the caller counts as a detach), not with a SIGBUS
        at the first touch; the half-made segment is unlinked."""
        def full(fd, off, n):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(fabric_mod.os, "posix_fallocate", full)
        with pytest.raises(FabricError, match="reserve"):
            Fabric(fabric_dir, size=2 << 20)
        assert not os.path.exists("/dev/shm/" + segment_name(fabric_dir))


# ---- the two packages attach one segment -----------------------------------


class TestLayoutParity:
    def test_jax_and_port_fabrics_share_one_segment(self, fabric_dir):
        assert segment_name(fabric_dir) == jfabric.segment_name(fabric_dir)
        assert (fabric_mod.MAGIC, fabric_mod.FABRIC_VERSION) == (
            jfabric.MAGIC, jfabric.FABRIC_VERSION)
        assert (fabric_mod._HDR.format, fabric_mod._SLOT.format,
                fabric_mod._PROBES) == (jfabric._HDR.format,
                                        jfabric._SLOT.format,
                                        jfabric._PROBES)
        port = Fabric(fabric_dir, size=2 << 20)
        jax = jfabric.Fabric(fabric_dir, size=2 << 20)
        try:
            assert port.name == jax.name
            assert port.put("tpl", b"from-port", b"p" * 100)
            assert jax.get("tpl", b"from-port") == b"p" * 100
            assert jax.put("plan", b"from-jax", b"j" * 33)
            assert port.get("plan", b"from-jax") == b"j" * 33
            assert jax.bump_version("public", "cpu") == 1
            assert port.version("public", "cpu") == 1
            assert port.bump_version("public", "cpu") == 2
            assert jax.version("public", "cpu") == 2
            assert sorted(port.scan("tpl")) == sorted(jax.scan("tpl"))
        finally:
            jax.close()
            port.close()
        assert not os.path.exists("/dev/shm/" + segment_name(fabric_dir))

    @pytest.mark.parametrize("creator", ["port", "jax"])
    def test_alien_version_refused_by_both(self, fabric_dir, creator):
        make = Fabric if creator == "port" else jfabric.Fabric
        a = make(fabric_dir, size=2 << 20)
        try:
            struct.pack_into("<I", a._shm.buf, 8,
                             fabric_mod.FABRIC_VERSION + 1)
            with pytest.raises(FabricError):
                Fabric(fabric_dir, size=2 << 20)
            with pytest.raises(jfabric.FabricError):
                jfabric.Fabric(fabric_dir, size=2 << 20)
        finally:
            struct.pack_into("<I", a._shm.buf, 8,
                             fabric_mod.FABRIC_VERSION)
            a.close()


_PORT_PEER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
from greptimedb_tpu_torch import shm
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import (ConcurrencyConfig,
                                              ConcurrencyPlane)
from greptimedb_tpu_torch.concurrency.plan_cache import fabric_key
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

engine = RegionEngine(EngineConfig(data_dir={data!r}, maintenance_workers=0),
                      device="cpu")
plane = ConcurrencyPlane(ConcurrencyConfig())
qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu",
                 concurrency=plane)
qe.execute_one({ddl!r})
qe.execute_one({rows!r})
# the first sighting probes the fabric for a template and a plan, plans
# locally and publishes its plan
qe.execute_sql({sql!r}, QueryContext())
fabric = shm.get_fabric()
info = qe.catalog.table("public", "cpu")
tkey = next(iter(plane.fast_lane._templates))
pkey = next(iter(plane.plan_cache._entries))
out = {{"keys": {{}}, "forged": {{}}}}
for bare, own, key, probe in (
        ("tpl", shm.TEMPLATE_KIND, tkey,
         lambda: plane.fast_lane._fabric_probe(tkey)),
        ("plan", shm.PLAN_KIND, pkey,
         lambda: plane.plan_cache._fabric_probe(pkey, info))):
    digest = fabric_key(key)
    out["keys"][bare] = digest.hex()
    if bare == "plan":  # the port's own plan, published under its kind
        out["own_plan"] = isinstance(shm.loads(fabric.get(own, digest)),
                                     tuple)
    # the JAX plane's artifact lies under the same digest: forged under
    # the port's own kind, it is still no more than a miss
    blob = fabric.get(bare, digest)
    if blob is not None:
        fabric.put(own, digest, blob)
        out["forged"][bare] = probe() is None
out["modules"] = sorted(m for m in ("jax", "greptimedb_tpu")
                        if m in sys.modules)
engine.close()
plane.shutdown()
shm.shutdown_fabric()
print(json.dumps(out))
"""


class TestCrossPackageArtifacts:
    def test_neither_package_reads_the_others_artifacts(self, tmp_path,
                                                        fabric_env):
        """A JAX plane and a port process on one segment: the port's
        probes never unpickle the JAX plan and template (that would
        import the JAX package, and run whatever a blob names), a JAX
        blob forged under the port's kinds is a plain miss, and what the
        port publishes lands under its own kinds, leaving the JAX
        artifacts for JAX readers untouched."""
        from greptimedb_tpu import shm as jshm
        from greptimedb_tpu.concurrency import (
            ConcurrencyConfig as JConcurrencyConfig,
        )
        from greptimedb_tpu.concurrency import (
            ConcurrencyPlane as JConcurrencyPlane,
        )

        jshm.shutdown_fabric()
        je = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                   maintenance_workers=0))
        jq = JQueryEngine(JCatalog(JMemoryKv()), je,
                          concurrency=JConcurrencyPlane(JConcurrencyConfig()))
        sql = DASH.format(host="h1", lo=0, hi=60_000)
        ddl = ("CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) "
               "TIME INDEX, PRIMARY KEY(host))")
        rows = ("INSERT INTO cpu (host, v, ts) VALUES ('h1', 1.5, 1000), "
                "('h1', 2.5, 2000), ('h2', 4.0, 3000)")
        try:
            jf = jshm.get_fabric()
            assert jf is not None
            jq.execute_one(ddl)
            jq.execute_one(rows)
            for _ in range(3):  # the second sighting publishes both
                jq.execute_sql(sql, QueryContext())
            assert jf.scan("tpl") and jf.scan("plan")
            proc = subprocess.run(
                [sys.executable, "-c", _PORT_PEER.format(
                    repo=REPO, data=str(tmp_path / "port"), ddl=ddl,
                    rows=rows, sql=sql)],
                capture_output=True, text=True, timeout=120,
                env={**os.environ, "GTPU_SHM_FABRIC": "1",
                     "GTPU_SHM_FABRIC_DIR": fabric_env})
            assert proc.returncode == 0, proc.stderr[-3000:]
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            assert out["modules"] == []
            # both JAX artifacts were there to be misread, and each one
            # forged under the port's kind was refused
            assert out["forged"] == {"tpl": True, "plan": True}
            for bare, own in (("tpl", shm.TEMPLATE_KIND),
                              ("plan", shm.PLAN_KIND)):
                digest = bytes.fromhex(out["keys"][bare])
                mods = _pickled_modules(jf.get(bare, digest))
                assert not [m for m in mods
                            if m.startswith("greptimedb_tpu_torch")], bare
            assert out["own_plan"] is True
        finally:
            jq.concurrency.shutdown()
            je.close()
            jshm.shutdown_fabric()


# ---- SIGKILL-mid-publish chaos ---------------------------------------------


_KILL_MID_PUBLISH = r"""
import os, sys, fcntl
sys.path.insert(0, {repo!r})
from greptimedb_tpu_torch.shm import fabric as fm

f = fm.Fabric({fdir!r}, size=2 << 20)
f.put("tpl", b"pre", b"published-before-death")
# die INSIDE a publish: take the write flock, mark the slot where key
# "half" would land as mid-write (odd generation), then SIGKILL this
# process while it still holds the flock
fcntl.flock(f._write_fd, fcntl.LOCK_EX)
hdr = fm._HDR
slot = fm._SLOT
slots = hdr.unpack_from(f._shm.buf, 0)[2]
h = fm._hash_key(b"tpl\x00half")
for p in range(slots):
    idx = (h % slots + p) % slots
    off = hdr.size + idx * slot.size
    if slot.unpack_from(f._shm.buf, off)[0] == 0:
        slot.pack_into(f._shm.buf, off, 1, h, 0, 0, 0)
        break
print("armed", "torch" in sys.modules, flush=True)
os.kill(os.getpid(), 9)
"""


class TestSigkillChaos:
    def test_killed_writer_neither_wedges_nor_poisons(self, fabric_dir):
        proc = subprocess.run(
            [sys.executable, "-c",
             _KILL_MID_PUBLISH.format(repo=REPO, fdir=fabric_dir)],
            capture_output=True, text=True, timeout=60)
        assert proc.returncode == -signal.SIGKILL
        # the fabric runs in processes that never import torch (encode
        # workers)
        assert proc.stdout.split() == ["armed", "False"]
        survivor = Fabric(fabric_dir, size=2 << 20)
        try:
            # the kernel released the dead peer's flock: writes proceed
            assert survivor.put("tpl", b"after", b"alive")
            assert survivor.get("tpl", b"after") == b"alive"
            # the mid-write slot (odd generation) reads as absent
            assert survivor.get("tpl", b"half") is None
            assert survivor.get("tpl", b"pre") \
                == b"published-before-death"
        finally:
            survivor.close()
        # the dead peer leaked its attach refcount; the survivor being
        # last out must still have unlinked the segment
        assert not os.path.exists("/dev/shm/" + segment_name(fabric_dir))


# ---- adoption between two in-process planes --------------------------------


def _pickled_modules(blob: bytes) -> set:
    """The modules a pickle's classes and functions come from."""
    import io

    seen: set = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add(module)
            return super().find_class(module, name)

    Recorder(io.BytesIO(blob)).load()
    return seen


class TestPeerAdoption:
    def _twin_planes(self, tmp_path):
        pa = ConcurrencyPlane(ConcurrencyConfig())
        pb = ConcurrencyPlane(ConcurrencyConfig())
        ea, qa = make_qe(tmp_path, plane=pa, sub="peer_a")
        eb, qb = make_qe(tmp_path, plane=pb, sub="peer_b")
        for qe in (qa, qb):
            create_cpu(qe)
            ingest(qe)
        return (ea, qa), (eb, qb)

    def test_template_and_plan_adopted_from_peer(self, tmp_path,
                                                 fabric_env):
        from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

        (ea, qa), (eb, qb) = self._twin_planes(tmp_path)
        sql = DASH.format(host="h1", lo=0, hi=60_000)
        try:
            pub0 = {k: SHM_FABRIC_EVENTS.total(event="publish", kind=k)
                    for k in ("template", "plan")}
            # peer A: sighting -> build -> publish
            for _ in range(3):
                oracle = qa.execute_sql(sql, QueryContext())[-1].rows()
            for k in ("template", "plan"):
                assert SHM_FABRIC_EVENTS.total(
                    event="publish", kind=k) > pub0[k], k
            tpl_hit0 = SHM_FABRIC_EVENTS.total(event="hit",
                                               kind="template")
            plan_hit0 = SHM_FABRIC_EVENTS.total(event="hit", kind="plan")
            # peer B: the first sighting adopts A's verified template
            # and canonical plan instead of re-probing and re-planning
            rows = qb.execute_sql(sql, QueryContext())[-1].rows()
            assert rows == oracle
            assert SHM_FABRIC_EVENTS.total(
                event="hit", kind="template") == tpl_hit0 + 1
            assert SHM_FABRIC_EVENTS.total(
                event="hit", kind="plan") >= plan_hit0 + 1
            # what A published is host state only: no tensor, device or
            # other torch object rides a template or a plan
            fabric = shm.get_fabric()
            for kind in (shm.TEMPLATE_KIND, shm.PLAN_KIND):
                blobs = fabric.scan(kind)
                assert blobs, kind
                for _, blob in blobs:
                    assert not [m for m in _pickled_modules(blob)
                                if m == "torch" or m.startswith("torch.")]
            # the adopted template serves repeats as fast-lane hits, with
            # other parameters too
            lane = qb.concurrency.fast_lane
            key = next(iter(lane._templates))
            assert lane._templates[key].entries
            assert qb.execute_sql(sql, QueryContext())[-1].rows() == oracle
            other = DASH.format(host="h2", lo=10_000, hi=40_000)
            assert qb.execute_sql(other, QueryContext())[-1].rows() == \
                qa.execute_sql(other, QueryContext())[-1].rows()
        finally:
            ea.close()
            eb.close()

    def test_peer_ddl_invalidates_published_artifacts(self, tmp_path,
                                                      fabric_env):
        from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

        (ea, qa), (eb, qb) = self._twin_planes(tmp_path)
        sql = DASH.format(host="h1", lo=0, hi=60_000)
        try:
            for _ in range(3):
                qa.execute_sql(sql, QueryContext())
            fabric = shm.get_fabric()
            assert fabric is not None
            v0 = fabric.version("public", "cpu")
            # B's DDL bumps the shared version through the same seam
            # that clears its in-process caches
            qb.execute_one("ALTER TABLE cpu ADD COLUMN extra DOUBLE")
            assert fabric.version("public", "cpu") == v0 + 1
            # A's published template is stale now: a fresh plane's first
            # sighting misses it instead of adopting it
            pc = ConcurrencyPlane(ConcurrencyConfig())
            key = next(iter(qa.concurrency.fast_lane._templates))
            miss0 = SHM_FABRIC_EVENTS.total(event="miss", kind="template")
            assert pc.fast_lane._fabric_probe(key) is None
            assert SHM_FABRIC_EVENTS.total(
                event="miss", kind="template") == miss0 + 1
            # B re-executes against its own new schema and still answers
            # as A does
            rows = qb.execute_sql(sql, QueryContext())[-1].rows()
            assert rows == qa.execute_sql(sql, QueryContext())[-1].rows()
        finally:
            ea.close()
            eb.close()

    def test_garbage_blobs_degrade_to_a_plain_miss(self, tmp_path,
                                                   fabric_env):
        """A garbage blob under a template or plan key degrades to a
        plain miss, never an exception on the serving path."""
        from greptimedb_tpu_torch.concurrency.plan_cache import fabric_key

        plane = ConcurrencyPlane(ConcurrencyConfig())
        engine, qe = make_qe(tmp_path, plane=plane, sub="garbage")
        create_cpu(qe)
        ingest(qe)
        sql = DASH.format(host="h2", lo=0, hi=60_000)
        try:
            fabric = shm.get_fabric()
            assert fabric is not None
            key = (QueryContext().db, "junk")
            fabric.put(shm.TEMPLATE_KIND, fabric_key(key),
                       b"\x80\x04not-pickle")
            fabric.put(shm.TEMPLATE_KIND, b"junk", b"\x80\x04not-pickle")
            fabric.put(shm.PLAN_KIND, b"junk", pickle.dumps(("x", 1)))
            assert plane.fast_lane._fabric_probe(key) is None
            rows = [qe.execute_sql(sql, QueryContext())[-1].rows()
                    for _ in range(3)]
            assert rows[0] == rows[1] == rows[2]
        finally:
            engine.close()


# ---- rows against the JAX engine -------------------------------------------


def test_fabric_on_engines_match_the_jax_engine(tmp_path, fabric_dir,
                                                monkeypatch):
    """Two port engines sharing one fabric (the second adopting the
    first's templates and plans) return the JAX engine's rows for the
    same writes and statements, with other parameters each time."""
    from greptimedb_tpu import shm as jshm
    from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

    tpl0 = SHM_FABRIC_EVENTS.total(event="hit", kind="template")
    plan0 = SHM_FABRIC_EVENTS.total(event="hit", kind="plan")
    je = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                               write_workers=0, maintenance_workers=0))
    jq = JQueryEngine(JCatalog(JMemoryKv()), je)
    monkeypatch.setenv("GTPU_SHM_FABRIC", "1")
    monkeypatch.setenv("GTPU_SHM_FABRIC_DIR", fabric_dir)
    monkeypatch.setenv("GREPTIMEDB_TPU_COMPILATION_CACHE_DIR", "off")
    shm.shutdown_fabric()
    ea, qa = make_qe(tmp_path, plane=ConcurrencyPlane(ConcurrencyConfig()),
                     sub="rows_a")
    eb, qb = make_qe(tmp_path, plane=ConcurrencyPlane(ConcurrencyConfig()),
                     sub="rows_b")
    try:
        assert jshm.get_fabric() is None  # the JAX engine stays private
        for qe in (jq, qa, qb):
            create_cpu(qe)
            ingest(qe, hosts=6, points=90)
        rng = np.random.default_rng(3)
        stmts = []
        for _ in range(6):
            h = int(rng.integers(0, 6))
            lo = int(rng.integers(0, 30)) * 1000
            stmts.append(DASH.format(host=f"h{h}", lo=lo, hi=lo + 45_000))
            stmts.append(f"SELECT host, avg(v), count(*) FROM cpu WHERE "
                         f"ts >= {lo} AND ts < {lo + 50_000} GROUP BY host "
                         f"ORDER BY host")
        # A sees each template twice (its second sighting builds and
        # publishes it); B's first sighting of each then adopts it
        for sql in stmts[:2] * 2:
            qa.execute_sql(sql, QueryContext())
        for i, sql in enumerate(stmts * 2):
            want = jq.execute_sql(sql, QueryContext())[-1].rows()
            for qe in (qa, qb) if i % 2 == 0 else (qb, qa):
                got = qe.execute_sql(sql, QueryContext())[-1].rows()
                assert len(got) == len(want), sql
                for g, w in zip(got, want):
                    assert g[:-2] == w[:-2] or g == w, sql
                    np.testing.assert_allclose(
                        np.asarray(g[-2:], dtype=float),
                        np.asarray(w[-2:], dtype=float), rtol=1e-9)
        assert SHM_FABRIC_EVENTS.total(event="hit", kind="template") \
            >= tpl0 + 2
        assert SHM_FABRIC_EVENTS.total(event="hit", kind="plan") > plan0
    finally:
        ea.close()
        eb.close()
        je.close()
        jshm.shutdown_fabric()


# ---- byte identity: fabric on vs off ---------------------------------------


class TestByteIdentityFabric:
    def test_http_payload_bytes_identical(self, tmp_path, fabric_dir,
                                          monkeypatch):
        from greptimedb_tpu_torch.servers.encode import encode_sql_payload

        sqls = [DASH.format(host=f"h{h}", lo=lo, hi=lo + 60_000)
                for h in range(2) for lo in (0, 10_000)]
        # the oracle first, with the fabric OFF for the whole process
        shm.shutdown_fabric()
        monkeypatch.delenv("GTPU_SHM_FABRIC", raising=False)
        eo, qo = make_qe(tmp_path, plane=ConcurrencyPlane(
            ConcurrencyConfig()), sub="oracle")
        create_cpu(qo)
        ingest(qo)
        oracle = {}
        for s in sqls * 3:
            oracle[s] = encode_sql_payload(
                qo.execute_sql(s, QueryContext()), 1.0)
        eo.close()
        # the fabric ON: two engines share one fabric; the second adopts
        monkeypatch.setenv("GTPU_SHM_FABRIC", "1")
        monkeypatch.setenv("GTPU_SHM_FABRIC_DIR", fabric_dir)
        shm.shutdown_fabric()
        ea, qa = make_qe(tmp_path, plane=ConcurrencyPlane(
            ConcurrencyConfig()), sub="fab_a")
        eb, qb = make_qe(tmp_path, plane=ConcurrencyPlane(
            ConcurrencyConfig()), sub="fab_b")
        try:
            assert shm.get_fabric() is not None
            for qe in (qa, qb):
                create_cpu(qe)
                ingest(qe)
            for s in sqls * 3:
                assert encode_sql_payload(
                    qa.execute_sql(s, QueryContext()), 1.0) == oracle[s]
                assert encode_sql_payload(
                    qb.execute_sql(s, QueryContext()), 1.0) == oracle[s]
        finally:
            ea.close()
            eb.close()

    def test_mysql_and_postgres_wire_parity(self, tmp_path, fabric_dir,
                                            monkeypatch):
        from greptimedb_tpu_torch.servers.mysql import MysqlServer
        from greptimedb_tpu_torch.servers.postgres import PostgresServer
        from tests.test_wire_protocols import MiniMysql, MiniPg

        sqls = [DASH.format(host="h0", lo=0, hi=60_000),
                "SELECT host, v FROM cpu WHERE ts >= 1000 AND "
                "ts < 9000 ORDER BY host, ts"]

        def answers(sub):
            engine, qe = make_qe(tmp_path, plane=ConcurrencyPlane(
                ConcurrencyConfig()), sub=sub)
            create_cpu(qe)
            ingest(qe)
            ms = MysqlServer(qe, port=0)
            ms.start()
            ps = PostgresServer(qe, port=0)
            ps.start()
            my, pg = MiniMysql(ms.port), MiniPg(ps.port)
            try:
                return [(my.query(s), pg.query(s)) for s in sqls * 2]
            finally:
                my.close()
                pg.close()
                ms.shutdown()
                ps.shutdown()
                qe.concurrency.shutdown()
                engine.close()

        shm.shutdown_fabric()
        monkeypatch.delenv("GTPU_SHM_FABRIC", raising=False)
        oracle = answers("wire_oracle")
        monkeypatch.setenv("GTPU_SHM_FABRIC", "1")
        monkeypatch.setenv("GTPU_SHM_FABRIC_DIR", fabric_dir)
        shm.shutdown_fabric()
        first = answers("wire_fab_a")
        assert shm.get_fabric() is not None
        assert first == oracle
        assert answers("wire_fab_b") == oracle


# ---- result arena ----------------------------------------------------------


def _encode_rows(n):
    """A picklable encoder (spawn workers import it by name)."""
    from greptimedb_tpu_torch.servers.encode import encode_sql_payload

    return encode_sql_payload(n, 1.0)


class TestResultArena:
    def test_publish_claim_roundtrip_and_free(self, fabric_dir):
        from greptimedb_tpu_torch.shm.results import ResultArena

        arena = ResultArena(fabric_dir, size=2 << 20)
        try:
            data = b"HTTP payload bytes" * 100
            handle = arena.publish(data)
            assert handle is not None
            payload = arena.claim(handle)
            assert payload is not None
            assert bytes(payload) == data
            assert len(payload) == len(data)
            assert arena.stats()["active"] == 1
            payload.release()
            assert arena.stats()["active"] == 0
            # the freed block is reusable
            assert arena.publish(b"second") is not None
        finally:
            arena.close()

    def test_claim_failure_falls_back_to_reencode(self, fabric_env):
        from greptimedb_tpu_torch.shm import results
        from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

        arena = results.get_arena()
        assert arena is not None
        handle = arena.publish(b"the-bytes")
        assert handle is not None
        # a handle whose publisher is "gone" (its block reaped): resolve
        # re-encodes inline, byte-identical, and counts the event
        mark, idx, off, ln, _pid = handle
        dead = (mark, idx, off, ln, 2 ** 22 + 12345)
        c0 = SHM_FABRIC_EVENTS.total(event="corrupt", kind="result")
        out = results.resolve(dead, lambda: b"the-bytes", ())
        assert out == b"the-bytes"
        assert SHM_FABRIC_EVENTS.total(
            event="corrupt", kind="result") == c0 + 1

    def test_shm_encode_times_worker_exactly(self, fabric_env):
        from greptimedb_tpu_torch.shm import results
        from greptimedb_tpu_torch.utils.metrics import ENCODE_SECONDS

        c0 = ENCODE_SECONDS.total_count(protocol="process")
        out = results.shm_encode(lambda: b"abc" * 10)
        assert results.is_handle(out)
        assert ENCODE_SECONDS.total_count(protocol="process") == c0 + 1
        resolved = results.resolve(out, lambda: b"abc" * 10, ())
        assert bytes(resolved) == b"abc" * 10
        resolved.release()

    def test_non_bytes_results_pass_through(self, fabric_env):
        from greptimedb_tpu_torch.shm import results

        # MySQL encoders return packet LISTS: those never ride the
        # arena, they fall through to the pickle path untouched
        out = results.shm_encode(lambda: [b"pkt1", b"pkt2"])
        assert out == [b"pkt1", b"pkt2"]

    def test_process_workers_hand_results_through_the_arena(
            self, tmp_path, fabric_env):
        """A spawn-mode encode worker publishes the HTTP body into the
        arena; the parent claims it and gets the thread-encoded bytes;
        the bridge folds the worker's own encode count into the
        parent's registry exactly."""
        from greptimedb_tpu_torch.concurrency.encode_pool import EncodePool
        from greptimedb_tpu_torch.servers.encode import encode_sql_payload
        from greptimedb_tpu_torch.shm import metrics_bridge
        from greptimedb_tpu_torch.utils.metrics import (
            ENCODE_SECONDS,
            SHM_FABRIC_EVENTS,
        )

        engine, qe = make_qe(tmp_path, plane=ConcurrencyPlane(
            ConcurrencyConfig()), sub="arena")
        create_cpu(qe)
        ingest(qe, hosts=8, points=200)
        pool = EncodePool(workers=1, min_rows=0, process_mode="on")
        try:
            results = qe.execute_sql("SELECT * FROM cpu ORDER BY host, ts",
                                     QueryContext())
            want = encode_sql_payload(results, 1.0)
            hits0 = SHM_FABRIC_EVENTS.total(event="hit", kind="result")
            c0 = ENCODE_SECONDS.total_count(protocol="process")
            out = pool.run(encode_sql_payload, results, 1.0,
                           cost_rows=1600, shm_result=True)
            assert getattr(out, "is_shm_payload", False)
            assert bytes(out) == want
            out.release()
            # plain callers get bytes copied out of the arena
            assert pool.run(encode_sql_payload, results, 1.0,
                            cost_rows=1600) == want
            assert SHM_FABRIC_EVENTS.total(
                event="hit", kind="result") == hits0 + 2
            metrics_bridge.collect_worker_metrics()
            assert ENCODE_SECONDS.total_count(protocol="process") == c0 + 2
        finally:
            pool.shutdown()
            qe.concurrency.shutdown()
            engine.close()


def test_orphaned_worker_exits_at_once(monkeypatch):
    """An encode worker that starts after its server was killed is an
    orphan before its watchdog runs: the watchdog, given the server's
    pid at pool creation, ends it at once instead of watching the reaper
    (which would keep its fabric and arena attach flocks forever)."""
    from greptimedb_tpu_torch.concurrency import encode_pool

    class Exited(Exception):
        pass

    def fake_exit(code):
        raise Exited(code)

    monkeypatch.setattr(os, "_exit", fake_exit)
    monkeypatch.setattr(encode_pool.time, "sleep", lambda s: pytest.fail(
        "the watchdog slept although its server is gone"))
    with pytest.raises(Exited):
        encode_pool._worker_watchdog(os.getppid() + 1)


# ---- worker metrics bridge -------------------------------------------------


class TestMetricsBridge:
    def test_worker_snapshot_folds_into_parent_scrape(self, fabric_env):
        from greptimedb_tpu_torch.shm import metrics_bridge
        from greptimedb_tpu_torch.utils.metrics import (
            ENCODE_SECONDS,
            SHM_FABRIC_EVENTS,
        )

        fabric = shm.get_fabric()
        assert fabric is not None
        # snapshots of a worker of this process (7 process encodes and 3
        # result publishes) and of a peer frontend's worker, which this
        # process's /metrics must not count
        hist = {(("protocol", "process"),):
                ([0] * len(ENCODE_SECONDS.BUCKETS) + [7], 1.25, 7)}
        counters = {(("event", "publish"), ("kind", "result")): 3.0}
        blob = pickle.dumps(
            {"hist": {"greptimedb_tpu_encode_seconds": hist},
             "counter": {"greptimedb_tpu_shm_fabric_events_total":
                         counters}})
        fabric.put(shm.METRICS_KIND, f"{os.getpid()}/999999".encode(), blob)
        fabric.put(shm.METRICS_KIND, f"{os.getpid() + 1}/999998".encode(),
                   blob)
        before = ENCODE_SECONDS.total_count(protocol="process")
        pub = SHM_FABRIC_EVENTS.total(event="publish", kind="result")
        try:
            metrics_bridge.collect_worker_metrics()
            assert ENCODE_SECONDS.total_count(protocol="process") \
                == before + 7
            assert SHM_FABRIC_EVENTS.total(event="publish", kind="result") \
                == pub + 3
            # cumulative snapshots: folding the same one again adds nothing
            metrics_bridge.collect_worker_metrics()
            assert ENCODE_SECONDS.total_count(protocol="process") \
                == before + 7
        finally:
            for m in (ENCODE_SECONDS, SHM_FABRIC_EVENTS):
                m._external.clear()


# ---- fabric stats & observability ------------------------------------------


class TestObservability:
    def test_fabric_stats_rendered_as_gauges(self, fabric_env):
        from greptimedb_tpu_torch.utils.metrics import (
            REGISTRY,
            SHM_FABRIC_BYTES,
        )

        fabric = shm.get_fabric()
        assert fabric is not None
        fabric.put("tpl", b"k", b"v" * 1000)
        shm.collect_fabric_stats()
        assert SHM_FABRIC_BYTES.get(segment="fabric", dim="size") > 0
        assert SHM_FABRIC_BYTES.get(segment="fabric", dim="used") > 0
        text = REGISTRY.render()
        assert "greptimedb_tpu_shm_fabric_bytes{" in text
