"""The port's concurrency plane (greptimedb_tpu_torch/concurrency/:
admission, the query batcher, the encode pool) and its deadline plane
(utils/deadline.py) against the JAX package's on the same writes.

- `QueryBatcher._execute_group` driven directly, so the route choice is
  deterministic: vmapped first, then the IN-list rewrite, then serial
  self-execution, with the JAX batcher's event kinds and paths and its
  rows (floats within rtol=1e-9, maxima bit for bit);
- threaded parameter siblings through `execute_sql` equal to their
  serial runs, and a member's bad literal failing that member only;
- typed `Overloaded` at a full queue and after the queue timeout, a
  deadline and a KILL QUERY giving typed errors with the JAX texts;
- the encode pool's bytes equal inline encoding, and the plane leaves
  no thread behind after `shutdown()`.
"""

import threading
import time

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.concurrency import ConcurrencyConfig as JPlaneConfig
from greptimedb_tpu.concurrency import ConcurrencyPlane as JPlane
from greptimedb_tpu.concurrency import batcher as jbatcher
from greptimedb_tpu.query import physical as jph
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.session import QueryContext as JQueryContext
from greptimedb_tpu.sql.parser import parse_sql as jparse
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu.utils import metrics as jmetrics
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import (
    ConcurrencyConfig,
    ConcurrencyPlane,
    Overloaded,
)
from greptimedb_tpu_torch.concurrency import batcher
from greptimedb_tpu_torch.fault import Cancelled, DeadlineExceeded
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.query import physical as tph
from greptimedb_tpu_torch.query.expr import PlanError
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils import deadline as dl
from greptimedb_tpu_torch.utils import metrics as tmetrics

SEED = 5
HOSTS, POINTS, STEP_MS = 6, 180, 1000
DDL = ("CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) TIME "
       "INDEX, PRIMARY KEY(host))")
DASH = ("SELECT date_bin(INTERVAL '1 minute', ts) AS minute, max(v), "
        "avg(v) FROM cpu WHERE host = '{h}' AND ts >= {lo} AND ts < {hi} "
        "GROUP BY minute")
KINDS = ("vmapped", "stacked", "serial_fallback", "coalesced", "join")


def _insert(grid, points) -> str:
    return "INSERT INTO cpu (host, v, ts) VALUES " + ", ".join(
        f"('h{h}', {float(grid[h, p])!r}, {p * STEP_MS})"
        for p in points for h in range(HOSTS))


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def engines(root, jplane=None, tplane=None, state="memtable"):
    jeng = JRegionEngine(JConfig(data_dir=str(root / "jax"),
                                 maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng,
                       concurrency=jplane or JPlane(JPlaneConfig(
                           fast_lane=False, plan_cache_entries=0)))
    teng = RegionEngine(EngineConfig(data_dir=str(root / "port"), maintenance_workers=0),
                        device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), teng, device="cpu",
                      concurrency=tplane)
    grid = np.round(np.random.default_rng(SEED).uniform(
        0, 100, (HOSTS, POINTS)), 3)
    for qe in (jqe, tqe):
        qe.execute_one(DDL)
        if state == "flushed":
            qe.execute_one(_insert(grid, range(0, 150)))
            qe.execute_one("ADMIN flush_table('cpu')")
            qe.execute_one(_insert(grid, range(150, POINTS)))
        else:
            qe.execute_one(_insert(grid, range(POINTS)))
    return jeng, jqe, teng, tqe


def close(jeng, jqe, teng, tqe):
    jqe.concurrency.shutdown()
    tqe.concurrency.shutdown()
    jeng.close()
    teng.close()


@pytest.fixture(scope="module", params=("memtable", "flushed"))
def pair(request, tmp_path_factory):
    e = engines(tmp_path_factory.mktemp(f"b_{request.param}"),
                state=request.param)
    yield e[1], e[3]
    close(*e)


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return None if v != v else float(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def assert_same(want, got):
    assert list(want.names) == list(got.names)
    assert len(want.rows()) == len(got.rows()), (want.rows(), got.rows())
    for wr, gr in zip(want.rows(), got.rows()):
        for name, a, b in zip(got.names, wr, gr):
            a, b = _cell(a), _cell(b)
            if isinstance(a, float) and isinstance(b, float) \
                    and name.startswith("avg("):
                np.testing.assert_allclose(b, a, rtol=1e-9)
            else:
                assert a == b, (name, wr, gr)


def drive_group(mod, metrics, qe, ctx, parse, sqls, **batcher_kw):
    """Run `_execute_group` once for a group led by sqls[0]; returns
    (by_value, event deltas, member order)."""
    b = mod.QueryBatcher(window_s=0.0, **batcher_kw)
    info = qe._table("cpu", ctx)
    sels = [parse(s)[0] for s in sqls]
    shapes = [mod.analyze(s, info) for s in sels]
    g = mod._Group(sels[0], shapes[0])
    order = []
    for sh in shapes:
        if sh.values not in order:
            order.append(sh.values)
    ev = metrics.QUERY_BATCH_EVENTS
    before = {k: ev.get(event=k) for k in KINDS}
    by_value = b._execute_group(
        qe, g, info, ctx, order, lambda s: qe._select_table(s, info, ctx))
    return by_value, {k: ev.get(event=k) - before[k] for k in KINDS
                      if ev.get(event=k) != before[k]}, order


GROUPS = {
    # differing hosts and windows: one vmapped launch
    "vmapped": ([DASH.format(h=f"h{i}", lo=i * 20_000, hi=120_000)
                 for i in range(4)], {}, "vmapped"),
    # vmap off, one varying tag: the IN-list rewrite
    "in_list": ([DASH.format(h=f"h{i}", lo=0, hi=120_000)
                 for i in range(4)], {"vmap": False}, "stacked"),
    # vmap off, varying windows: the leader runs, the rest self-execute
    "serial": ([DASH.format(h="h1", lo=i * 20_000, hi=120_000)
                for i in range(3)], {"vmap": False}, "serial_fallback"),
    # the scan estimate over batch_max_rows: serial even for one tag
    "over_max_rows": ([DASH.format(h=f"h{i}", lo=0, hi=120_000)
                       for i in range(3)], {"max_rows": 10},
                      "serial_fallback"),
}


@pytest.mark.parametrize("name", list(GROUPS))
def test_execute_group_routes_match_jax(pair, name):
    sqls, kw, kind = GROUPS[name]
    jqe, tqe = pair
    jctx, tctx = JQueryContext(timezone="UTC"), QueryContext(timezone="UTC")
    jby, jev, jorder = drive_group(jbatcher, jmetrics, jqe, jctx, jparse,
                                   sqls, **kw)
    tby, tev, torder = drive_group(batcher, tmetrics, tqe, tctx, parse_sql,
                                   sqls, **kw)
    assert torder == jorder
    assert tev == jev == {kind: float(len(torder))}
    for v in torder:
        if jby[v] is jbatcher.SELF_EXECUTE:
            assert tby[v] is batcher.SELF_EXECUTE
            continue
        (jres, jpath), (tres, tpath) = jby[v], tby[v]
        assert tpath == jpath
        assert_same(jres, tres)


def test_vmapped_declined_turns_to_in_list(pair, monkeypatch):
    """A scan part spanning several device blocks declines the vmapped
    dispatch in both packages; one varying tag then takes the IN-list
    rewrite."""
    monkeypatch.setattr(jph, "DEFAULT_BLOCK_ROWS", 64)
    monkeypatch.setattr(tph, "DEFAULT_BLOCK_ROWS", 64)
    sqls = GROUPS["in_list"][0]
    jqe, tqe = pair
    _, jev, _ = drive_group(jbatcher, jmetrics, jqe,
                            JQueryContext(timezone="UTC"), jparse, sqls)
    tby, tev, order = drive_group(batcher, tmetrics, tqe,
                                  QueryContext(timezone="UTC"), parse_sql,
                                  sqls)
    assert tev == jev == {"stacked": float(len(order))}
    assert tby[order[0]][1].endswith("+stacked")


def test_vmapped_failure_raises_without_latch(pair, monkeypatch):
    """A kernel failure inside the vmapped dispatch raises into the
    statement; the next group still tries the vmapped route."""
    from greptimedb_tpu_torch.ops import segment_kernels

    jqe, tqe = pair
    sqls = GROUPS["vmapped"][0]

    def broken(*a, **kw):
        raise RuntimeError("fused_segment_agg: CUDA error 700")

    monkeypatch.setattr(segment_kernels, "fused_segment_agg", broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        drive_group(batcher, tmetrics, tqe, QueryContext(timezone="UTC"),
                    parse_sql, sqls)
    monkeypatch.undo()
    b = batcher.QueryBatcher(window_s=0.0)
    assert not hasattr(b, "_vmap_failed")
    _, ev, order = drive_group(batcher, tmetrics, tqe,
                               QueryContext(timezone="UTC"), parse_sql, sqls)
    assert ev == {"vmapped": float(len(order))}


# ---- threaded traffic through execute_sql ------------------------------------


def run_threads(fns, timeout=120):
    """Run fns at once behind a barrier; (results, errors) per fn."""
    out, errs = [None] * len(fns), [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def wrap(i, fn):
        try:
            barrier.wait(timeout)
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 — returned to the caller
            errs[i] = e

    threads = [threading.Thread(target=wrap, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return out, errs


@pytest.fixture(scope="module")
def threaded(tmp_path_factory):
    # the batcher's own traffic: the lane and the plan cache off, as on
    # the JAX side (a learned template would skip the batcher)
    plane = ConcurrencyPlane(ConcurrencyConfig(
        batch_window_ms=100.0, fast_lane=False, plan_cache_entries=0))
    e = engines(tmp_path_factory.mktemp("threaded"), tplane=plane,
                state="flushed")
    yield e[1], e[3]
    close(*e)


def test_threaded_siblings_equal_serial(threaded):
    jqe, tqe = threaded
    sqls = [DASH.format(h=f"h{i % HOSTS}", lo=(i % 3) * 20_000,
                        hi=150_000) for i in range(12)]
    with tqe.concurrency.suppress_batching():
        want = [tqe.execute_one(s) for s in sqls]
    ev = tmetrics.QUERY_BATCH_EVENTS
    joins0 = ev.get(event="join")
    got, errs = run_threads([lambda s=s: tqe.execute_one(s) for s in sqls])
    assert errs == [None] * len(sqls)
    for w, g in zip(want, got):
        assert_same(w, g)
    assert ev.get(event="join") > joins0


def test_failing_leader_reaches_its_statement_only(threaded):
    """The bad statement opens the group, so it leads: its error is its
    own, and the members with other parameters run their statements."""
    from greptimedb_tpu_torch.session import QueryContext

    jqe, tqe = threaded
    good = [DASH.format(h=f"h{i}", lo=0, hi=120_000) for i in range(3)]
    bad = DASH.format(h="h0", lo="'not a time'", hi=120_000)
    with tqe.concurrency.suppress_batching():
        want = [tqe.execute_one(s) for s in good]
    b = tqe.concurrency.batcher
    out: dict = {}

    def call(i, sql):
        ctx = QueryContext()
        sel = tqe._parse_cached(sql)[0]
        try:
            out[i] = b.execute(tqe, sel, tqe._table(sel.table, ctx), ctx,
                               busy=True)
        except Exception as e:  # noqa: BLE001 — compared below
            out[i] = e

    lead = threading.Thread(target=call, args=(0, bad))
    lead.start()
    for _ in range(200):  # the leader's group is open and collecting
        if b._open:
            break
        time.sleep(0.001)
    members = [threading.Thread(target=call, args=(i + 1, s))
               for i, s in enumerate(good)]
    for t in members:
        t.start()
    for t in [lead] + members:
        t.join(timeout=60)
        assert not t.is_alive()
    assert isinstance(out[0], ValueError)
    for i, w in enumerate(want):
        assert_same(w, out[i + 1])


def test_bad_literal_reaches_its_member_only(threaded):
    jqe, tqe = threaded
    good = [DASH.format(h=f"h{i}", lo=0, hi=120_000) for i in range(4)]
    bad = DASH.format(h="h0", lo="'not a time'", hi=120_000)
    with pytest.raises(Exception) as jerr:
        jqe.execute_one(bad)
    sqls = good + [bad]
    with tqe.concurrency.suppress_batching():
        want = [tqe.execute_one(s) for s in good]
    got, errs = run_threads([lambda s=s: tqe.execute_one(s) for s in sqls])
    assert errs[:-1] == [None] * len(good)
    for w, g in zip(want, got):
        assert_same(w, g)
    assert type(errs[-1]).__name__ == type(jerr.value).__name__
    assert str(errs[-1]) == str(jerr.value)


# ---- admission, deadlines, KILL ------------------------------------------------


class HeldSlot:
    """Hold one admission slot of `plane` on a helper thread."""

    def __init__(self, plane):
        self.plane, self.go, self.held = plane, threading.Event(), \
            threading.Event()

    def __enter__(self):
        def hold():
            with self.plane.admission.slot("holder"):
                self.held.set()
                self.go.wait(30)

        self.t = threading.Thread(target=hold)
        self.t.start()
        assert self.held.wait(30)
        return self

    def __exit__(self, *exc):
        self.go.set()
        self.t.join()


def _plane_pair(tmp_path, **kw):
    jplane = JPlane(JPlaneConfig(fast_lane=False, plan_cache_entries=0,
                                 batching=False, **kw))
    tplane = ConcurrencyPlane(ConcurrencyConfig(batching=False, **kw))
    return engines(tmp_path, jplane, tplane)


SELECT = "SELECT host, max(v) FROM cpu GROUP BY host"


@pytest.mark.parametrize("kw,event", [
    ({"max_concurrency": 1, "queue_size": 0}, "reject_full"),
    ({"max_concurrency": 1, "queue_size": 4, "queue_timeout_s": 0.05},
     "reject_timeout"),
], ids=["queue_full", "queue_timeout"])
def test_overloaded_is_typed(tmp_path, kw, event):
    e = _plane_pair(tmp_path, **kw)
    texts = []
    try:
        for qe, err in ((e[1], None), (e[3], Overloaded)):
            before = tmetrics.ADMISSION_EVENTS.total(event=event)
            with HeldSlot(qe.concurrency):
                with pytest.raises(Exception) as exc:
                    qe.execute_one(SELECT)
            assert type(exc.value).__name__ == "Overloaded"
            if err is not None:
                assert isinstance(exc.value, err)
                assert tmetrics.ADMISSION_EVENTS.total(event=event) \
                    == before + 1
            texts.append(str(exc.value))
    finally:
        close(*e)
    assert texts[0] == texts[1]


def test_deadline_in_the_admission_queue_is_typed(tmp_path):
    e = _plane_pair(tmp_path, max_concurrency=1, queue_size=4)
    errs = []
    try:
        for qe, ctx in ((e[1], JQueryContext(timeout_ms=50)),
                        (e[3], QueryContext(timeout_ms=50))):
            with HeldSlot(qe.concurrency):
                t0 = time.perf_counter()
                with pytest.raises(Exception) as exc:
                    qe.execute_one(SELECT, ctx)
                assert time.perf_counter() - t0 < 5
            errs.append(exc.value)
    finally:
        close(*e)
    assert type(errs[0]).__name__ == "DeadlineExceeded"
    assert isinstance(errs[1], DeadlineExceeded)
    assert str(errs[0]) == str(errs[1]) == \
        "query deadline exceeded at admission queue"


def test_kill_query_cancels_a_queued_statement(tmp_path):
    e = _plane_pair(tmp_path, max_concurrency=1, queue_size=4)
    texts = []
    try:
        for qe, running in ((e[1], None), (e[3], dl.RUNNING)):
            if running is None:
                from greptimedb_tpu.utils.deadline import RUNNING as running
            out = {}

            def victim():
                try:
                    qe.execute_one(SELECT)
                except Exception as exc:  # noqa: BLE001 — checked below
                    out["err"] = exc

            with qe.concurrency.admission.slot("killer"):
                t = threading.Thread(target=victim)
                t.start()
                qid = None
                for _ in range(600):
                    ids = [q["id"] for q in running.list()
                           if q["query"] == SELECT]
                    if ids:
                        qid = ids[0]
                        break
                    time.sleep(0.01)
                assert qid is not None
                # this thread holds the slot: KILL rides it as nested
                killed = qe.execute_one(f"KILL QUERY {qid}")
                assert killed.affected_rows == 1
                t.join(30)
            texts.append(out["err"])
    finally:
        close(*e)
    assert type(texts[0]).__name__ == "Cancelled"
    assert isinstance(texts[1], Cancelled)
    assert str(texts[0]) == str(texts[1]) == \
        "query cancelled at admission queue (KILL QUERY)"


def test_kill_unknown_query_matches_jax(pair):
    jqe, tqe = pair
    with pytest.raises(Exception) as jerr:
        jqe.execute_one("KILL QUERY 987654")
    with pytest.raises(PlanError) as terr:
        tqe.execute_one("KILL QUERY 987654")
    assert str(terr.value) == str(jerr.value)


# ---- encode pool and shutdown ------------------------------------------------


def test_encode_pool_bytes_equal_inline_and_threads_joined(pair):
    from greptimedb_tpu.servers.encode import encode_sql_payload as jenc
    from greptimedb_tpu_torch.concurrency.encode_pool import EncodePool
    from greptimedb_tpu_torch.servers.encode import encode_sql_payload

    jqe, tqe = pair
    sql = "SELECT host, ts, v FROM cpu WHERE ts < 60000 ORDER BY host, ts"
    t = tqe.execute_sql(sql)
    j = jqe.execute_sql(sql)
    inline = encode_sql_payload(t, 1.5)
    assert inline == jenc(j, 1.5)
    before = set(threading.enumerate())
    pool = EncodePool(workers=2, min_rows=1)
    assert pool.run(encode_sql_payload, t, 1.5, cost_rows=360) == inline
    pool.shutdown()
    assert set(threading.enumerate()) - before == set()
