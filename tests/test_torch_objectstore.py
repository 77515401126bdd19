"""The port's object stores (greptimedb_tpu_torch/objectstore/) against
the JAX package's (greptimedb_tpu/objectstore/), on the CPU.

Twins of tests/test_objectstore.py (the local backends, the LRU layer,
build_store), tests/test_objectstore_s3.py and
tests/test_objectstore_cloud.py (S3, GCS and Azure against in-process
fakes, tests/torch_store_fakes.py): the same sequence of calls through
the JAX store and the port's store against one fake gives the same
objects and the same answers; the signers give the JAX signatures; the
LRU evicts and refuses oversized objects as the JAX one does. Then the
port's own range reads (one GET an object through the cache, one ranged
GET without it), the fault seams, the shared retry and the counters
/metrics renders under the JAX names.
"""

import datetime
import os

import numpy as np
import pytest

import greptimedb_tpu.objectstore as jos
from greptimedb_tpu.objectstore import azblob as jaz
from greptimedb_tpu.objectstore import gcs as jgcs
from greptimedb_tpu.objectstore import s3 as js3
from greptimedb_tpu_torch import objectstore as tos
from greptimedb_tpu_torch.fault import FAULTS, Fault, FaultError
from greptimedb_tpu_torch.objectstore import azblob as taz
from greptimedb_tpu_torch.objectstore import gcs as tgcs
from greptimedb_tpu_torch.objectstore import s3 as ts3
from greptimedb_tpu_torch.utils.metrics import (
    REGISTRY,
    RETRY_ATTEMPTS,
    RETRY_EXHAUSTED,
)

import torch_store_fakes as fakes

_STORES = {"s3": (js3.S3Store, ts3.S3Store),
           "gcs": (jgcs.GcsStore, tgcs.GcsStore),
           "azblob": (jaz.AzblobStore, taz.AzblobStore)}


@pytest.fixture(autouse=True)
def _disarm():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _outcome(fn):
    """A call's answer, or its error type and whether it says not found."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the type is the answer
        return ("error", "not found" in str(e), type(e).__name__)


def _script(store) -> list:
    """One sequence of store calls; the answers in order."""
    out = [_outcome(lambda: store.exists("a.txt"))]
    for key, data in (("a.txt", b"alpha"), ("sub/b.txt", b"beta"),
                      ("sub/c.txt", b"gamma" * 100),
                      ("weird key/with spaces&amp.txt", b"ok")):
        out.append(_outcome(lambda: store.write(key, data)))
    for call in (lambda: store.exists("a.txt"),
                 lambda: store.read("a.txt"),
                 lambda: store.size("sub/c.txt"),
                 lambda: sorted(store.list("")),
                 lambda: sorted(store.list("sub/")),
                 lambda: store.read("weird key/with spaces&amp.txt"),
                 lambda: store.delete("a.txt"),
                 lambda: store.exists("a.txt"),
                 lambda: store.delete("a.txt"),
                 lambda: store.read("a.txt")):
        out.append(_outcome(call))
    return out


@pytest.mark.parametrize("kind", ["s3", "gcs", "azblob"])
def test_remote_store_answers_as_jax_against_one_fake(kind):
    fake = fakes.serve(kind)
    try:
        jcls, tcls = _STORES[kind]
        jstore = jcls(**fakes.store_kwargs(kind, fake, "root/jax"))
        tstore = tcls(**fakes.store_kwargs(kind, fake, "root/port"))
        assert _script(tstore) == _script(jstore)
        objs = fake.objects
        jkeys = {k[len("root/jax/"):]: v for k, v in objs.items()
                 if k.startswith("root/jax/")}
        tkeys = {k[len("root/port/"):]: v for k, v in objs.items()
                 if k.startswith("root/port/")}
        assert tkeys == jkeys and len(tkeys) == 3
        # a wrong secret is refused by the fake in both packages
        bad = dict(fakes.store_kwargs(kind, fake, "root/port"))
        bad.update({"s3": {"secret_key": "wrong"}, "gcs": {"token": "x"},
                    "azblob": {"account_key": "d3Jvbmcta2V5"}}[kind])
        errs = [_outcome(lambda c=c: c(**bad).write("x", b"y"))
                for c in (jcls, tcls)]
        assert errs[0] == errs[1] and errs[0][0] == "error"
    finally:
        fake.close()


@pytest.mark.parametrize("backend", ["fs", "memory"])
def test_local_backend_answers_as_jax(tmp_path, backend):
    answers = []
    for mod, root in ((jos, tmp_path / "jax"), (tos, tmp_path / "port")):
        store = mod.FsStore() if backend == "fs" else mod.MemoryStore()
        key = f"{root}/a/b.bin"
        out = [_outcome(lambda: store.exists(key)),
               _outcome(lambda: store.read(key))]
        store.write(key, b"hello")
        out += [_outcome(lambda: store.exists(key)),
                _outcome(lambda: store.read(key)),
                _outcome(lambda: store.size(key))]
        store.write(key, b"world!")
        out += [_outcome(lambda: store.read(key)),
                [k[len(str(root)):] for k in store.list(f"{root}/a/")]]
        store.delete(key)
        store.delete(key)  # idempotent
        out.append(_outcome(lambda: store.exists(key)))
        answers.append(out)
    assert answers[1] == answers[0]


def test_build_store_selects_as_jax():
    for kind in ("fs", "memory"):
        assert type(tos.build_store(kind)).__name__ == \
            type(jos.build_store(kind)).__name__
    assert isinstance(tos.build_store("memory", cache_bytes=1024),
                      tos.LruCacheLayer)
    for kind in ("s3", "gcs", "azblob", "hdfs"):
        if kind == "s3":
            # the JAX S3Store has defaults for everything but the bucket
            with pytest.raises(tos.ObjectStoreError, match="misconfigured"):
                tos.build_store(kind)
            continue
        with pytest.raises(jos.ObjectStoreError) as je:
            jos.build_store(kind)
        with pytest.raises(tos.ObjectStoreError) as te:
            tos.build_store(kind)
        assert str(te.value) == str(je.value)
    assert isinstance(tos.build_store("gcs", bucket="b", token="t"),
                      tgcs.GcsStore)
    assert isinstance(tos.build_store("azblob", container="c",
                                      account_name="a", account_key="aGk="),
                      taz.AzblobStore)
    s = ts3.from_url("oss://bkt/p", access_key="a", secret_key="b")
    j = js3.from_url("oss://bkt/p", access_key="a", secret_key="b")
    assert (s.bucket, s.prefix, s.endpoint) == (j.bucket, j.prefix,
                                                j.endpoint)
    with pytest.raises(tos.ObjectStoreError, match="scheme"):
        ts3.from_url("azblob://x/y")


def _seeded_keys(seed: int) -> list:
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019-_.~ /+=&?%:@!")
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 24))))
            for _ in range(6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sign_v4_gives_the_jax_signatures(seed):
    now = datetime.datetime(2024, 5, 6, 7, 8, 9,
                            tzinfo=datetime.timezone.utc)
    j = js3.S3Store("bkt", "root", endpoint="http://h:9", access_key="A",
                    secret_key="S" * (seed + 1))
    t = ts3.S3Store("bkt", "root", endpoint="http://h:9", access_key="A",
                    secret_key="S" * (seed + 1))
    for key in _seeded_keys(seed):
        for method in ("GET", "PUT", "DELETE"):
            q = f"list-type=2&prefix={key[:3]}" if method == "GET" else ""
            url = t._url(key, q)
            assert url == j._url(key, q)
            headers = {"X-Amz-Meta-K": key.strip()} if seed else {}
            assert ts3.sign_v4(method, url, headers, "e3b0", "A", "S",
                               "eu-west-1", now=now) == \
                js3.sign_v4(method, url, headers, "e3b0", "A", "S",
                            "eu-west-1", now=now)


@pytest.mark.parametrize("seed", [0, 1])
def test_sign_shared_key_gives_the_jax_signatures(seed):
    for key in _seeded_keys(seed + 10):
        t = taz.AzblobStore("ctr", "p", endpoint="http://h:1",
                            account_name="acct", account_key="aGk=")
        url = t._url(key) + ("?comp=list&prefix=a&restype=container"
                             if seed else "")
        headers = {"x-ms-date": "Mon, 06 May 2024 07:08:09 GMT",
                   "x-ms-version": taz.API_VERSION, "Content-Length": "5",
                   "Range": "bytes=0-4" if seed else ""}
        assert taz.sign_shared_key("GET", url, headers, "acct", "aGk=") == \
            jaz.sign_shared_key("GET", url, headers, "acct", "aGk=")


def test_lru_evicts_and_refuses_oversized_as_jax():
    outs = []
    for mod in (jos, tos):
        inner = mod.MemoryStore()
        cache = mod.LruCacheLayer(inner, capacity_bytes=10)
        for k, v in (("a", b"12345"), ("b", b"67890"), ("c", b"abcde")):
            inner.write(k, v)
        out = [cache.read("a"), cache.read("b"), cache.cached_bytes]
        cache.read("a")
        cache.read("c")  # evicts b (a was touched)
        out.append(cache.cached_bytes)
        inner.write("b", b"NEW__")
        out.append(cache.read("b"))
        inner.delete("c")
        out.append(_outcome(lambda: cache.read("c")))
        inner.write("big", b"x" * 11)
        out += [cache.read("big"), cache.cached_bytes]
        cache.write("k", b"v1")
        out.append(inner.read("k"))
        cache.delete("k")
        out += [cache.exists("k"), cache.cached_bytes]
        outs.append(out)
    assert outs[1] == outs[0]


def test_range_reads_one_get_through_the_cache_and_ranged_without():
    fake = fakes.serve("s3")
    try:
        store = ts3.S3Store(**fakes.store_kwargs("s3", fake, "r"))
        data = bytes(range(256)) * 40
        store.write("obj", data)
        fake.requests.clear()
        buf = bytearray(100)
        store.read_into("obj", 1000, buf)
        assert bytes(buf) == data[1000:1100]
        assert fake.requests == [("GET", "r/obj", "bytes=1000-1099")]
        cached = tos.LruCacheLayer(store, capacity_bytes=1 << 20)
        fake.requests.clear()
        for off in (0, 5000, 9000):
            buf = bytearray(200)
            cached.read_into("obj", off, buf)
            assert bytes(buf) == data[off:off + 200]
        assert fake.verbs() == ["GET"] and fake.requests[0][2] is None
        assert (cached.hits, cached.misses) == (2, 1)
        with pytest.raises(tos.ObjectStoreError, match="short read"):
            cached.read_into("obj", len(data) - 10, bytearray(20))
    finally:
        fake.close()


@pytest.mark.parametrize("cache", [1 << 30, 4096])
def test_cold_scan_gets_of_an_sst_against_the_cache_size(tmp_path, cache):
    """A cold scan of a flushed SST on the fake S3: with a cache that
    holds the file, one whole-object GET; with a cache smaller than the
    file, one ranged GET a footer or column-chunk read and no whole-object
    GET (the file is never downloaded once a chunk)."""
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    fake = fakes.serve("s3")
    kv = MemoryKv()
    cfg = EngineConfig(data_dir=str(tmp_path / "d"), object_store="s3",
                       object_store_cache_bytes=cache,
                       object_store_kwargs=fakes.store_kwargs("s3", fake,
                                                              "root"),
                       maintenance_workers=0)
    rng = np.random.default_rng(7)
    q = "SELECT host, a, b, c, ts FROM t ORDER BY ts, host"
    try:
        eng = RegionEngine(cfg, device="cpu")
        qe = QueryEngine(Catalog(kv), eng, device="cpu")
        qe.execute_one("CREATE TABLE t (host STRING, a DOUBLE, b DOUBLE, "
                       "c BIGINT, ts TIMESTAMP(3) TIME INDEX, "
                       "PRIMARY KEY(host))")
        qe.execute_one("INSERT INTO t VALUES " + ", ".join(
            f"('h{k % 5}', {rng.normal()!r}, {rng.normal()!r}, "
            f"{int(rng.integers(-10**9, 10**9))}, {1000 * k})"
            for k in range(600)))
        qe.execute_one("ADMIN flush_table('t')")
        want = qe.execute_one(q).rows()
        eng.close()
        (sst,) = [k for k in fake.objects if k.endswith(".sst")]
        assert len(fake.objects[sst]) > 4096
        fake.requests.clear()
        eng = RegionEngine(cfg, device="cpu")
        qe = QueryEngine(Catalog(kv), eng, device="cpu")
        assert qe.execute_one(q).rows() == want
        gets = [r[2] for r in fake.requests if r[:2] == ("GET", sst)]
        if cache > len(fake.objects[sst]):
            assert gets == [None]
        else:
            assert len(gets) > 2 and None not in gets
            assert sum(int(b) - int(a) + 1 for a, b in
                       (r[len("bytes="):].split("-") for r in gets)) \
                <= len(fake.objects[sst])
        eng.close()
    finally:
        fake.close()


def test_transient_read_fault_is_retried_and_counted():
    store = tos.MemoryStore()
    store.write("k", b"payload")
    before = RETRY_ATTEMPTS.get(point="objectstore.read")
    FAULTS.arm("objectstore.read", Fault(kind="fail", nth=1))
    assert store.read("k") == b"payload"
    buf = bytearray(3)
    FAULTS.arm("objectstore.read", Fault(kind="fail", nth=1))
    store.read_into("k", 2, buf)
    assert bytes(buf) == b"ylo"
    assert RETRY_ATTEMPTS.get(point="objectstore.read") == before + 2
    # a torn read is not transient: it surfaces at once, unretried
    ex0 = RETRY_EXHAUSTED.get(point="objectstore.read")
    FAULTS.arm("objectstore.read", Fault(kind="torn"))
    with pytest.raises(FaultError) as e:
        store.read("k")
    assert e.value.kind == "torn"
    assert RETRY_ATTEMPTS.get(point="objectstore.read") == before + 2
    # a fault on every attempt exhausts the policy
    FAULTS.arm("objectstore.read", Fault(kind="fail"))
    with pytest.raises(FaultError):
        store.read("k")
    assert RETRY_EXHAUSTED.get(point="objectstore.read") == ex0 + 1


@pytest.mark.parametrize("backend", ["fs", "memory", "s3"])
def test_enospc_write_leaves_no_partial_object_or_tmp(tmp_path, backend):
    fake = fakes.serve("s3") if backend == "s3" else None
    try:
        if backend == "s3":
            store = ts3.S3Store(**fakes.store_kwargs("s3", fake, "r"))
        else:
            store = tos.build_store(backend)
        key = str(tmp_path / "d" / "obj.sst")
        FAULTS.arm("objectstore.write", Fault(kind="enospc", arg=0.5))
        with pytest.raises(FaultError) as e:
            store.write(key, [b"x" * 100, b"y" * 100])
        assert e.value.kind == "enospc" and not e.value.transient
        assert not store.exists(key)
        if backend == "fs":
            assert os.listdir(tmp_path / "d") == []
        if fake is not None:
            assert fake.objects == {}
        # a torn write lands partial bytes and is never acknowledged
        FAULTS.arm("objectstore.write", Fault(kind="torn", arg=0.25))
        with pytest.raises(FaultError) as e:
            store.write(key, b"z" * 40)
        assert e.value.kind == "torn" and store.read(key) == b"z" * 10
        FAULTS.reset()
        store.write(key, b"whole")
        assert store.read(key) == b"whole"
    finally:
        if fake is not None:
            fake.close()


def test_seams_arm_and_metrics_render_under_the_jax_names():
    """The four data seams arm; a point of a later slice still raises;
    /metrics carries the object-store and retry counters under the JAX
    names, by backend and outcome."""
    from greptimedb_tpu.utils import metrics as jmetrics

    for point in ("objectstore.read", "objectstore.write", "wal.append",
                  "wal.replay"):
        FAULTS.arm(point, Fault(kind="latency", arg=0.0))
    FAULTS.reset()
    with pytest.raises(ValueError, match="A10"):
        FAULTS.arm("flight.do_get", Fault())
    store = tos.MemoryStore()
    store.write("m", b"abc")
    cached = tos.LruCacheLayer(store)
    cached.read("m")
    cached.read("m")
    names = ("greptimedb_tpu_object_store_reads_total",
             "greptimedb_tpu_object_store_read_bytes_total",
             "greptimedb_tpu_retry_attempts_total",
             "greptimedb_tpu_retry_exhausted_total")
    jnames = {m.name for m in jmetrics.REGISTRY._metrics}
    tnames = {m.name for m in REGISTRY._metrics}
    assert set(names) <= jnames and set(names) <= tnames
    text = REGISTRY.render()
    for name in names:
        assert f"# TYPE {name} counter" in text
    for outcome in ("read", "hit", "miss"):
        assert f'backend="memory",outcome="{outcome}"' in text
