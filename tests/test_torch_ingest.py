"""The port's line-protocol front door (greptimedb_tpu_torch/servers/
influx.py, ingest.py) against the JAX package's on the same bodies:
twins of tests/test_ingest.py's TestLineProtocolFuzz, TestVectorParseLane
and TestColumnarFrontDoors, and a seeded fuzz of regular and irregular
bodies. Every body gives equal slabs, or equal rejected line numbers and
messages, from both packages' Python lanes; wherever the port's vector
lane (one native scan, native/src/lp_columns.cpp) accepts a body, its
batch equals the Python lanes' batch value for value. Group commit's
classes wait for the port's write workers (ROADMAP A12-write).
"""

import math
import random

import numpy as np
import pytest

from greptimedb_tpu.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
from greptimedb_tpu.query import QueryEngine as JQueryEngine
from greptimedb_tpu.servers import influx as jinflux
from greptimedb_tpu.servers.prom_store import (
    handle_remote_write as j_remote_write,
)
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch import native
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.servers import influx
from greptimedb_tpu_torch.servers.prom_store import handle_remote_write
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils import protowire as pw
from greptimedb_tpu_torch.utils import snappy
from torch_write_pair import plain_rows

NOW_MS = 1_700_000_000_000


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def engines(tmp_path):
    """A JAX engine and a port engine (on the CPU), each in its own dir."""
    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                 maintenance_workers=0))
    teng = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"), maintenance_workers=0),
                        device="cpu")
    return ((jeng, JQueryEngine(JCatalog(JMemoryKv()), jeng)),
            (teng, QueryEngine(Catalog(MemoryKv()), teng, device="cpu")))


def outcome(mod, body, precision="ns"):
    """('ok', {measurement: (tags, fields, ts)}) of a package's Python
    lanes, or ('error', lines, message)."""
    try:
        slabs = mod.parse_lines_columnar(body, precision=precision,
                                         now_ms=NOW_MS)
    except mod.LineProtocolError as e:
        return ("error", e.lines, str(e))
    return ("ok", {m: (s.tags, s.fields, s.ts) for m, s in slabs.items()})


def slab_schema(slab) -> Schema:
    """The schema ensure_table would create for `slab`."""
    cols = [ColumnSchema(t, DataType.STRING, SemanticType.TAG)
            for t in slab.tags]
    cols.append(ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                             SemanticType.TIMESTAMP, nullable=False))
    cols += [ColumnSchema(f, slab.field_type(f), SemanticType.FIELD)
             for f in slab.fields]
    return Schema(cols)


def assert_same_batches(vec, py) -> None:
    """The vector lane's slabs give the Python lanes' batches, column by
    column, value for value."""
    assert vec.keys() == py.keys()
    for m in py:
        sv, sp = vec[m], py[m]
        assert list(sv.tags) == list(sp.tags)
        assert list(sv.fields) == list(sp.fields)
        schema = slab_schema(sp)
        bv, bp = sv.to_batch(schema), sp.to_batch(schema)
        assert bv.num_rows == bp.num_rows
        for name in schema.names:
            cv, cp = bv.columns[name], bp.columns[name]
            if hasattr(cp, "decode"):
                assert list(cv.decode()) == list(cp.decode()), name
            else:
                cv, cp = np.asarray(cv), np.asarray(cp)
                assert cv.dtype == cp.dtype, name
                # bit for bit: -0.0 and 0.0 differ here
                assert cv.tobytes() == cp.tobytes(), name


# ---- twins of TestLineProtocolFuzz ------------------------------------------


LP_CASES = {
    "escaped_commas_spaces_and_quotes": (
        'my\\ table,ta\\,g=va\\ lue,b=c\\=d '
        'f1=1.5,msg="say \\"hi\\", bye" 1000\n', "ns"),
    "nan_inf_rejected_with_line_numbers": (
        "cpu,h=a v=1.0 1000\ncpu,h=a v=NaN 2000\n"
        "cpu,h=a v=inf 3000\ncpu,h=a v=-Infinity 4000\n", "ns"),
    "torn_partial_line_rejected_by_number": (
        "cpu,h=a v=1.0 1000\ncpu,h=b v=", "ns"),
    "out_of_order_tags_share_columns": (
        "m,b=2,a=1 v=1.0 1000\nm,a=3,b=4 v=2.0 2000\n", "ns"),
    "sparse_fields_null_pad": ("m f1=1.0 1000\nm f2=2.0 2000\n", "ns"),
    "bad_timestamp_and_missing_fields": (
        "m v=1.0 notatime\nm,h=a  \nok v=2.0 5\n", "ns"),
    "integer_and_bool_suffixes": (
        "m i=42i,u=7u,t=true,f=F,neg=-3i 1000\n", "ns"),
    "duplicate_key_last_wins": ("m v=1.0,v=2.0 1000\n", "ns"),
    "trailing_junk_plain": ("m v=1.0 123 456\n", "ns"),
    "trailing_junk_escaped": ('m,t=a\\ b v=1.0 123 456\n', "ns"),
    "precision_scaling_exact_at_ns": (
        "m v=1.0 1465839830100400200\n", "ns"),
}


@pytest.mark.parametrize("name", list(LP_CASES))
def test_line_protocol_case_matches_jax(name):
    body, precision = LP_CASES[name]
    want = outcome(jinflux, body, precision)
    got = outcome(influx, body, precision)
    assert got == want
    if name == "escaped_commas_spaces_and_quotes":
        tags, fields, _ = got[1]["my table"]
        assert tags["ta,g"] == ["va lue"] and tags["b"] == ["c=d"]
        assert fields["msg"] == ['say "hi", bye']
    elif name == "nan_inf_rejected_with_line_numbers":
        assert got[1] == [2, 3, 4] and "non-finite" in got[2]
    elif name == "torn_partial_line_rejected_by_number":
        assert got[1] == [2] and "line 2" in got[2]
    elif name.startswith("trailing_junk"):
        assert got[1] == [1]
    elif name == "precision_scaling_exact_at_ns":
        assert got[1]["m"][2] == [1465839830100400200 // 1_000_000]
    # the vector lane never decides otherwise
    vec = influx._vector_parse(body, *influx._PRECISION_TO_MS[precision],
                               NOW_MS)
    if vec is not None:
        assert got[0] == "ok"
        assert_same_batches(vec, influx.parse_lines_columnar(
            body, precision=precision, now_ms=NOW_MS))


# ---- twins of TestVectorParseLane -------------------------------------------


def _uniform_body(rng, rows=500, fields=("f0", "f1", "f2")) -> str:
    return "\n".join(
        f"cpu,hostname=host_{int(h)},dc=dc{int(h) % 3} "
        + ",".join(f"{f}={v:.4f}" for f, v in zip(fields, row))
        + f" {1000 + j}"
        for j, (h, row) in enumerate(zip(
            rng.integers(0, 40, rows),
            rng.uniform(-50.0, 50.0, (rows, len(fields))).tolist())))


def test_vector_lane_parity_with_python_lane_and_jax():
    """The native lane, the port's Python lanes and the JAX package's
    Arrow lane give the same batch for the uniform shape."""
    assert native.try_load() is not None
    body = _uniform_body(np.random.default_rng(3))
    vec = influx._vector_parse(body, 1, 1, now_ms=0)
    assert vec is not None and "cpu" in vec
    py = influx.parse_lines_columnar(body, precision="ms", now_ms=0)
    assert_same_batches(vec, py)
    jvec = jinflux._vector_parse(body, 1, 1, now_ms=0)
    schema = slab_schema(py["cpu"])
    bt = vec["cpu"].to_batch(schema)
    for name in schema.names:
        t, j = bt.columns[name], jvec["cpu"].to_batch(
            _jax_schema(schema)).columns[name]
        if hasattr(t, "decode"):
            assert list(t.decode()) == list(j.decode())
        else:
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _jax_schema(schema):
    from greptimedb_tpu.datatypes import Schema as JSchema

    return JSchema.from_dict(schema.to_dict())


@pytest.mark.parametrize("body", [
    "cpu,h=a v=1.0 1000\ncpu,h=b v=inf 2000",    # non-finite
    "cpu,h=a v=1.0 1000\nmem,h=b v=2.0 2000",    # mixed tables
    "cpu,h=a v=1.0 1000\ncpu,h=b v=2.0",         # mixed ts
    "cpu,h=a v=1.0 1000\ncpu,h=b v=",            # torn line
    'cpu,h=a msg="x" 1000',                      # string field
    "cpu,h=a v=2i 1000",                         # int suffix
    "cpu,h=a v=1.0 1000\ncpu,v=2.0,h=b x 1",     # ragged/odd
    "cpu,h=a v=1_0 1000",                        # underscore: Python only
    "cpu,h=a v=1.0 1000\ncpu,h=b v=2.0 1000 7",  # trailing junk
    "cpu,h=a v=1.0,v=2.0 1000",                  # repeated key
    "cpu,h=a v=1.0 1000\r\ncpu,h=b v=2.0 2000",  # CRLF
    "cpu,h=é v=1.0 1000",                   # non-ASCII
    "cpu,h=a v=1.0 99999999999999999999",        # past int64
])
def test_vector_lane_bails_to_python_diagnostics(body):
    """Every precondition miss returns None, never a wrong batch; both
    packages' Python lanes then give the same outcome."""
    assert influx._vector_parse(body, 1, 1, 0) is None
    assert outcome(influx, body, "ms") == outcome(jinflux, body, "ms")


def test_write_lines_roundtrip_through_vector_lane(tmp_path):
    (jeng, jqe), (teng, tqe) = engines(tmp_path)
    body = ("vm,host=a cpu=1.5,mem=10.0 1000\n"
            "vm,host=b cpu=2.5,mem=20.0 2000\n"
            "vm,host=a cpu=3.5,mem=30.0 3000")
    assert influx._vector_parse(body, 1, 1, 0) is not None
    try:
        assert jinflux.write_lines(jqe, "public", body, precision="ms") \
            == influx.write_lines(tqe, "public", body, precision="ms") == 3
        sql = "SELECT host, cpu, mem, ts FROM vm ORDER BY ts"
        assert plain_rows(tqe.execute_one(sql)) \
            == plain_rows(jqe.execute_one(sql)) \
            == [["a", 1.5, 10.0, 1000], ["b", 2.5, 20.0, 2000],
                ["a", 3.5, 30.0, 3000]]
        # the auto-created table: not append mode, so a rewrite of a key
        # replaces it on both
        for mod, qe in ((jinflux, jqe), (influx, tqe)):
            mod.write_lines(qe, "public", "vm,host=a cpu=9.5,mem=1.0 1000",
                            precision="ms")
        assert plain_rows(tqe.execute_one(sql)) \
            == plain_rows(jqe.execute_one(sql))
        assert plain_rows(tqe.execute_one(sql))[0][1] == 9.5
    finally:
        jeng.close()
        teng.close()


# ---- twins of TestColumnarFrontDoors ------------------------------------------


def test_batched_auto_alter_one_schema_swap(tmp_path):
    """A request introducing several new fields alters the schema once,
    with the JAX rows and column order."""
    (jeng, jqe), (teng, tqe) = engines(tmp_path)
    try:
        for mod, qe in ((jinflux, jqe), (influx, tqe)):
            mod.write_lines(qe, "public", "m,h=a f1=1.0 1000\n",
                            precision="ms")
        info = tqe._table("m", QueryContext(db="public"))
        region = teng.region(info.region_ids[0])
        files_before = len(region.files)
        for mod, qe in ((jinflux, jqe), (influx, tqe)):
            mod.write_lines(qe, "public",
                            "m,h=a f1=1.0,f2=2.0,f3=3.0,f4=4.0 2000\n",
                            precision="ms")
        info = tqe._table("m", QueryContext(db="public"))
        for fn in ("f2", "f3", "f4"):
            assert fn in info.schema
        assert len(region.files) - files_before <= 1
        for sql in ("SELECT f1, f2, f3, f4 FROM m WHERE ts = 2000",
                    "SELECT * FROM m ORDER BY ts"):
            jr, tr = jqe.execute_one(sql), tqe.execute_one(sql)
            assert list(tr.names) == list(jr.names)
            assert plain_rows(tr) == plain_rows(jr)
        assert plain_rows(tqe.execute_one(
            "SELECT f1, f2, f3, f4 FROM m WHERE ts = 2000")) \
            == [[1.0, 2.0, 3.0, 4.0]]
        # a new tag on an existing table is refused with the JAX text
        errs = []
        for mod, qe in ((jinflux, jqe), (influx, tqe)):
            with pytest.raises(ValueError) as ei:
                mod.write_lines(qe, "public", "m,h=a,z=1 f1=1.0 3000",
                                precision="ms")
            errs.append(str(ei.value))
        assert errs[0] == errs[1]
    finally:
        jeng.close()
        teng.close()


def test_remote_write_series_bulk_extend(tmp_path):
    """Remote write lands columnar: one batch a metric, NULL for labels
    a series does not carry, the JAX rows."""
    def label(n, v):
        return pw.field_bytes(1, pw.field_str(1, n) + pw.field_str(2, v))

    def sample(val, ts):
        return pw.field_bytes(2, pw.field_double(1, val)
                              + pw.field_varint(2, ts))

    ts1 = pw.field_bytes(1, label("__name__", "up") + label("job", "api")
                         + sample(1.0, 1000) + sample(0.0, 2000))
    ts2 = pw.field_bytes(1, label("__name__", "up") + label("job", "db")
                         + label("zone", "z1") + sample(1.0, 1500))
    body = snappy.compress(ts1 + ts2)
    (jeng, jqe), (teng, tqe) = engines(tmp_path)
    try:
        assert j_remote_write(jqe, body) == handle_remote_write(tqe, body) \
            == 3
        sql = ("SELECT job, zone, greptime_value FROM up "
               "ORDER BY greptime_timestamp")
        assert plain_rows(tqe.execute_one(sql)) \
            == plain_rows(jqe.execute_one(sql)) \
            == [["api", None, 1.0], ["db", "z1", 1.0], ["api", None, 0.0]]
    finally:
        jeng.close()
        teng.close()


def test_multi_region_table_write_names_its_slice(tmp_path):
    """Partitioned tables run on the port now (ROADMAP A10-cluster): a
    line-protocol write to a table of several regions scatters through
    its partition rule as in the JAX engine, and a table of several
    regions with no rule takes the write on its first region, as the
    JAX engine's does."""
    teng = RegionEngine(EngineConfig(data_dir=str(tmp_path / "t")),
                        device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), teng, device="cpu")
    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "j")))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng)
    body = "\n".join(f"m,h={h} v={i}.5 {1000 * (i + 1)}"
                     for i, h in enumerate("abcmnoyz"))
    try:
        for q, lp in ((tqe, influx), (jqe, jinflux)):
            q.execute_one("CREATE TABLE m (h STRING, v DOUBLE, ts "
                          "TIMESTAMP(3) TIME INDEX, PRIMARY KEY (h)) "
                          "PARTITION ON COLUMNS (h) (h < 'm', h >= 'm')")
            lp.write_lines(q, "public", body, "ms")
        sizes = [[e.scan(rid).num_rows for rid in
                  q.catalog.table("public", "m").region_ids]
                 for q, e in ((tqe, teng), (jqe, jeng))]
        assert sizes[0] == sizes[1] == [3, 5]
        assert tqe.execute_one("SELECT h, v FROM m ORDER BY h").rows() == \
            jqe.execute_one("SELECT h, v FROM m ORDER BY h").rows()
        schema = Schema([
            ColumnSchema("h", DataType.STRING, SemanticType.TAG),
            ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                         SemanticType.TIMESTAMP, nullable=False),
            ColumnSchema("v", DataType.FLOAT64, SemanticType.FIELD)])
        info = tqe.catalog.create_table("public", "m2", schema,
                                        num_regions=2)
        for rid in info.region_ids:
            teng.create_region(rid, schema)
        influx.write_lines(tqe, "public", "m2,h=a v=2.0 2000", "ms")
        assert teng.scan(info.region_ids[0]).num_rows == 1
        assert teng.scan(info.region_ids[1]) is None
    finally:
        teng.close()
        jeng.close()


# ---- seeded fuzz: both packages' Python lanes and the port's vector lane ----


_PRECISIONS = list(influx._PRECISION_TO_MS)


def _value(rng: random.Random) -> str:
    """A field value in one of the spellings clients send."""
    x = rng.uniform(-1e4, 1e4)
    return rng.choice((
        repr(x), f"{x:.3f}", f"{x:e}", str(rng.randint(-99, 99)),
        f"{x:.0f}.", f".{rng.randint(0, 999)}", f"+{abs(x):.2f}", "-0",
        "0.0", f"{x:.17g}", f"{rng.randint(1, 9)}E{rng.randint(-5, 5)}"))


def _regular_body(rng: random.Random) -> tuple:
    meas = rng.choice(("cpu", "mem_x", "disk.io"))
    ntags, nfields = rng.randint(0, 3), rng.randint(1, 5)
    tags = [f"t{i}" for i in range(ntags)]
    fields = [f"f{i}" for i in range(nfields)]
    has_ts = rng.random() < 0.85
    t0 = rng.choice((0, 1_465_839_830, 1_465_839_830_100_400_200 // 10**3))
    lines = []
    for j in range(rng.randint(1, 40)):
        head = ",".join([meas] + [f"{t}=v{rng.randint(0, 4)}"
                                  for t in tags])
        line = head + " " + ",".join(f"{f}={_value(rng)}" for f in fields)
        if has_ts:
            line += f" {t0 + j * rng.randint(1, 1000)}"
        lines.append(line)
    return lines, rng.choice(_PRECISIONS)


_MUTATIONS = (
    lambda ln, r: ln.replace(" ", "  ", 1),           # double space
    lambda ln, r: ln + " ",                           # trailing space
    lambda ln, r: "  " + ln,                          # leading space
    lambda ln, r: ln.replace("=", "=1_", 1),          # underscore
    lambda ln, r: ln.rsplit(",", 1)[0] if "," in ln else ln,  # drop a kv
    lambda ln, r: ln[:r.randint(0, len(ln))],         # torn
    lambda ln, r: ln + f",zz={r.choice(('1i', 't', 'inf', 'nan'))}",
    lambda ln, r: ln.replace(",", "\\,", 1),          # escape
    lambda ln, r: ln + ' ,s="q"',                     # quoted junk
    lambda ln, r: "# " + ln,                          # comment
    lambda ln, r: "",                                 # empty line
    lambda ln, r: ln.replace("cpu", "cpv", 1),        # other measurement
    lambda ln, r: ln + "\r",                          # CR
    lambda ln, r: ln + " 99999999999999999999999",    # huge ts
    lambda ln, r: ln.replace("=v", "=é", 1),      # non-ASCII
    lambda ln, r: ln.replace("f0=", "f9=", 1),        # new / sparse field
    lambda ln, r: ln.replace("\t", "") + "\t",        # tab
    lambda ln, r: ln + " 12 13",                      # trailing junk
)


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_bodies_match_jax_and_lanes(seed):
    rng = random.Random(seed)
    for _ in range(12):
        lines, precision = _regular_body(rng)
        if rng.random() < 0.6:
            for _ in range(rng.randint(1, 3)):
                i = rng.randrange(len(lines))
                lines[i] = rng.choice(_MUTATIONS)(lines[i], rng)
        body = "\n".join(lines)
        want = outcome(jinflux, body, precision)
        got = outcome(influx, body, precision)
        assert got == want, (body, precision)
        num, den = influx._PRECISION_TO_MS[precision]
        vec = influx._vector_parse(body, num, den, NOW_MS)
        if vec is None:
            continue
        assert got[0] == "ok", body
        try:
            py = influx.parse_lines_columnar(body, precision=precision,
                                             now_ms=NOW_MS)
            for slab in py.values():
                slab_schema(slab)  # the lane admits float fields only
                assert all(not isinstance(v, float) or math.isfinite(v)
                           for vs in slab.fields.values() for v in vs)
        except Exception as e:  # noqa: BLE001 — shown with the body
            raise AssertionError((body, e)) from None
        assert_same_batches(vec, py)


def test_concurrent_first_writes_create_the_table_once(tmp_path):
    """Every client of a fresh measurement writes at once: one of them
    creates the table, the others find it (ROADMAP C8: the catalog's
    compare-and-put used to turn them away with "concurrent create"),
    and every row lands."""
    import sys
    import threading

    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    clients, rounds = 16, 4
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d"),
                                       maintenance_workers=0), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    old = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        for r in range(rounds):
            barrier = threading.Barrier(clients)
            errors = []

            def client(i):
                body = f"fresh{r},host=h{i} v={i}.5 {1000 + i}"
                barrier.wait(timeout=30)
                try:
                    influx.write_lines(qe, "public", body, precision="ms")
                except Exception as e:  # noqa: BLE001 — collected below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert errors == []
            assert qe.execute_one(f"SELECT count(*) FROM fresh{r}"
                                  ).rows() == [[clients]]
    finally:
        sys.setswitchinterval(old)
        engine.close()
