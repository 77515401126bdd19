"""The port's vmapped batch execution (greptimedb_tpu_torch/query/
vmapped.py: parameter-sibling members as one K2 call) against the JAX
package's `run_vmapped` and against the port's own serial execution, on
the same writes in two storage states (memtable; two flushed SSTs and a
memtable tail).

Cases: multi-tag members with different windows (window union, an
absent tag value), single-tag dashboards, first/last with timestamp ties
(several hosts a segment), count(*), and the sparse twin (a low
GREPTIMEDB_TPU_DENSE_GROUPS_MAX). `last_path` must be equal, and
`VmapIneligible` must be raised with the same text in the same cases.

Tolerances (ROADMAP.md's parity bar): counts, rows, min, max, first and
last bit for bit; sums rtol=1e-10, atol=1e-9; avg rtol=1e-9 (the port's
K2 plain version adds in another order than the serial routes and the
JAX package's XLA scatter).
"""

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.concurrency import ConcurrencyConfig as JConfigPlane
from greptimedb_tpu.concurrency import ConcurrencyPlane as JPlane
from greptimedb_tpu.concurrency import batcher as jbatcher
from greptimedb_tpu.query import vmapped as jvm
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.session import QueryContext as JQueryContext
from greptimedb_tpu.sql.parser import parse_sql as jparse
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import batcher
from greptimedb_tpu_torch.ops import segment_kernels
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.query import vmapped as vm
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

SEED = 17
HOSTS, DCS, POINTS, STEP_MS = 4, 2, 120, 1000

DDL = ("CREATE TABLE cpu (host STRING, dc STRING, v DOUBLE, w DOUBLE, "
       "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host, dc))")
DASH2 = ("SELECT date_bin(INTERVAL '10 seconds', ts) AS b, max(v), "
         "min(w), sum(v), avg(w), count(v) FROM cpu WHERE host = '{h}' "
         "AND dc = '{d}' AND ts >= {lo} AND ts < {hi} GROUP BY b")
DASH1 = ("SELECT date_bin(INTERVAL '10 seconds', ts) AS b, max(v) FROM cpu "
         "WHERE host = '{h}' AND ts >= {lo} AND ts < {hi} GROUP BY b")
FIRST_LAST = ("SELECT date_bin(INTERVAL '10 seconds', ts) AS b, "
              "first_value(v), last_value(w), count(*) FROM cpu WHERE "
              "dc = '{d}' AND ts >= {lo} AND ts < {hi} GROUP BY b")
BY_HOST = ("SELECT host, max(v), avg(w) FROM cpu WHERE dc = '{d}' AND "
           "ts >= {lo} AND ts < {hi} GROUP BY host")

CASES = {
    "multi_tag_window_union": [
        DASH2.format(h=f"h{i % HOSTS}", d=f"dc{i % DCS}",
                     lo=(i % 3) * 20_000, hi=60_000 + (i % 3) * 20_000)
        for i in range(8)] + [
        DASH2.format(h="absent", d="dc0", lo=0, hi=60_000)],
    "single_tag": [DASH1.format(h=f"h{i}", lo=i * 10_000,
                                hi=40_000 + i * 10_000)
                   for i in range(HOSTS)],
    "first_last_ties": [FIRST_LAST.format(d=f"dc{i % DCS}",
                                          lo=i * 15_000,
                                          hi=75_000 + i * 15_000)
                        for i in range(3)],
    "tag_group_key": [BY_HOST.format(d=f"dc{i % DCS}", lo=i * 30_000,
                                     hi=90_000 + i * 10_000)
                      for i in range(3)],
}


def _rows(grid_v, grid_w, points):
    out = []
    for p in points:
        for h in range(HOSTS):
            for d in range(DCS):
                out.append(f"('h{h}', 'dc{d}', {float(grid_v[h, d, p])!r}, "
                           f"{float(grid_w[h, d, p])!r}, {p * STEP_MS})")
    return "INSERT INTO cpu VALUES " + ", ".join(out)


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


@pytest.fixture(scope="module", params=("memtable", "flushed"))
def pair(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"vm_{request.param}")
    jeng = JRegionEngine(JConfig(data_dir=str(root / "jax"),
                                 maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng, concurrency=JPlane(
        JConfigPlane(fast_lane=False, plan_cache_entries=0)))
    teng = RegionEngine(EngineConfig(data_dir=str(root / "port"), maintenance_workers=0),
                        device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), teng, device="cpu")
    rng = np.random.default_rng(SEED)
    gv = np.round(rng.uniform(0, 100, (HOSTS, DCS, POINTS)), 3)
    gw = np.round(rng.uniform(0, 100, (HOSTS, DCS, POINTS)), 3)
    for qe in (jqe, tqe):
        qe.execute_one(DDL)
        if request.param == "flushed":
            # two SSTs and a tail: windows straddle the part seams
            for chunk in (range(0, 50), range(50, 100)):
                qe.execute_one(_rows(gv, gw, chunk))
                qe.execute_one("ADMIN flush_table('cpu')")
            qe.execute_one(_rows(gv, gw, range(100, POINTS)))
        else:
            qe.execute_one(_rows(gv, gw, range(POINTS)))
    yield jqe, tqe
    jqe.concurrency.shutdown()
    tqe.concurrency.shutdown()
    jeng.close()
    teng.close()


def _group(analyze, parse, qe, ctx, sqls):
    """Leader statement, shape, distinct member values and each SQL's
    values, from one package's parser and analyzer."""
    info = qe._table("cpu", ctx)
    shapes = []
    for sql in sqls:
        sel = parse(sql)[0]
        sh = analyze(sel, info)
        assert sh is not None, sql
        shapes.append((sel, sh))
    assert len({sh.masked for _, sh in shapes}) == 1
    order = []
    for _, sh in shapes:
        if sh.values not in order:
            order.append(sh.values)
    return info, shapes[0][0], shapes[0][1], order, \
        [sh.values for _, sh in shapes]


def run_both(pair, sqls):
    """(JAX results, JAX path, port results, port path, values per SQL,
    member order) of one vmapped group."""
    jqe, tqe = pair
    info, lead, shape, jorder, per = _group(
        jbatcher.analyze, jparse, jqe, JQueryContext(), sqls)
    jres = jvm.run_vmapped(jqe.executor, lead, info, shape.params, jorder)
    jpath = jqe.executor.last_path
    info, lead, shape, order, tper = _group(
        batcher.analyze, parse_sql, tqe, QueryContext(), sqls)
    assert order == jorder and tper == per
    tres = vm.run_vmapped(tqe.executor, lead, info, shape.params, order)
    return jres, jpath, tres, tqe.executor.last_path, per, order


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return None if v != v else float(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def assert_same(names, want, got):
    """Rows equal under the parity bar, column by column."""
    assert len(want.rows()) == len(got.rows()), (want.rows(), got.rows())
    for wr, gr in zip(want.rows(), got.rows()):
        for name, a, b in zip(names, wr, gr):
            a, b = _cell(a), _cell(b)
            if a is None or b is None or not isinstance(a, float):
                assert a == b, (name, wr, gr)
            elif name.startswith("sum("):
                np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-9)
            elif name.startswith("avg("):
                np.testing.assert_allclose(b, a, rtol=1e-9)
            else:  # min, max, first, last: bit for bit
                assert a == b, (name, wr, gr)


@pytest.mark.parametrize("case", list(CASES))
def test_vmapped_matches_jax_and_serial(pair, case, monkeypatch):
    """One K2 call a group; each member's rows equal the JAX package's
    vmapped member and the port's own serial run of that statement."""
    calls = []
    real = segment_kernels.fused_segment_agg

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(segment_kernels, "fused_segment_agg", counting)
    sqls = CASES[case]
    jres, jpath, tres, tpath, per, order = run_both(pair, sqls)
    assert jpath == tpath == "dense_vmapped"
    assert len(calls) == 1
    tqe = pair[1]
    for sql, vals in zip(sqls, per):
        got = tres[order.index(vals)]
        want = jres[order.index(vals)]
        assert list(got.names) == list(want.names)
        assert_same(got.names, want, got)
        with tqe.concurrency.suppress_batching():
            serial = tqe.execute_one(sql)
        assert_same(got.names, serial, got)


def test_sparse_members_match_jax_and_serial(pair, monkeypatch):
    """Past the dense budget the members ride the sparse twin: one
    sort-compact, one K2 call over M * U + 1 segments."""
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "4")
    calls = []
    real = segment_kernels.fused_segment_agg

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(segment_kernels, "fused_segment_agg", counting)
    sqls = CASES["multi_tag_window_union"]
    jres, jpath, tres, tpath, per, order = run_both(pair, sqls)
    assert jpath == tpath == "sparse_vmapped"
    assert len(calls) == 1
    tqe = pair[1]
    for sql, vals in zip(sqls, per):
        got = tres[order.index(vals)]
        assert_same(got.names, jres[order.index(vals)], got)
        with tqe.concurrency.suppress_batching():
            serial = tqe.execute_one(sql)
        assert_same(got.names, serial, got)


def _ineligible(pair, sqls, monkeypatch=None, block_rows=None):
    """Both packages' VmapIneligible texts for a group (the leader's
    statement is the first SQL's)."""
    jqe, tqe = pair
    texts = []
    for pkg, qe, ctx, parse, analyze, run in (
            ("jax", jqe, JQueryContext(), jparse, jbatcher.analyze,
             jvm.run_vmapped),
            ("port", tqe, QueryContext(), parse_sql, batcher.analyze,
             vm.run_vmapped)):
        info = qe._table("cpu", ctx)
        members = [analyze(parse(s)[0], info) for s in sqls]
        lead = parse(sqls[0])[0]
        shape = analyze(lead, info) or members[0]
        order = [m.values for m in members]
        err = vm.VmapIneligible if pkg == "port" else jvm.VmapIneligible
        with pytest.raises(err) as e:
            run(qe.executor, lead, info, shape.params, order)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    return texts[1]


def _refusal(pair, lead_sql, member_sqls):
    """Both packages' VmapIneligible texts for `lead_sql` run with the
    parameters of `member_sqls` (a shape the analyzer itself refuses;
    the refusal comes before any parameter is bound)."""
    texts = []
    for qe, ctx, parse, analyze, run, err in (
            (pair[0], JQueryContext(), jparse, jbatcher.analyze,
             jvm.run_vmapped, jvm.VmapIneligible),
            (pair[1], QueryContext(), parse_sql, batcher.analyze,
             vm.run_vmapped, vm.VmapIneligible)):
        info = qe._table("cpu", ctx)
        shapes = [analyze(parse(s)[0], info) for s in member_sqls]
        with pytest.raises(err) as e:
            run(qe.executor, parse(lead_sql)[0], info, shapes[0].params,
                [s.values for s in shapes])
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    return texts[1]


def test_ineligible_order_by_on_top(pair):
    base = [DASH1.format(h=f"h{i}", lo=0, hi=60_000) for i in range(2)]
    lead = base[0] + " ORDER BY b"
    info = pair[1]._table("cpu", QueryContext())
    assert batcher.analyze(parse_sql(lead)[0], info) is None
    assert _refusal(pair, lead, base) == "plan root is not a projection"


def test_ineligible_host_aggregate(pair):
    base = [DASH1.format(h=f"h{i}", lo=0, hi=60_000) for i in range(2)]
    lead = base[0].replace("max(v)", "median(v)")
    info = pair[1]._table("cpu", QueryContext())
    assert batcher.analyze(parse_sql(lead)[0], info) is None
    assert _refusal(pair, lead, base) == \
        "host-side aggregate in batch shape"


def test_ineligible_part_spanning_blocks(pair, monkeypatch):
    from greptimedb_tpu.query import physical as jph
    from greptimedb_tpu_torch.query import physical as tph

    monkeypatch.setattr(jph, "DEFAULT_BLOCK_ROWS", 64)
    monkeypatch.setattr(tph, "DEFAULT_BLOCK_ROWS", 64)
    text = _ineligible(pair, CASES["single_tag"])
    assert text == "a scan part spans multiple blocks"


def test_ineligible_group_budget(pair, monkeypatch):
    # 6 ten-second buckets a member window fit the dense budget alone;
    # the padded width x G does not
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "20")
    sqls = [DASH1.format(h=f"h{i}", lo=0, hi=60_000) for i in range(3)]
    text = _ineligible(pair, sqls)
    assert text == "stacked accumulator exceeds group budget"
