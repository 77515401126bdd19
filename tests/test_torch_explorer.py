"""The port's chaos explorer against the JAX package's (ROADMAP A10-proc).

Twins (tests/torch_twin.py) of tests/test_explorer.py: the samplers, ddmin,
the explore -> catch -> shrink -> repro pipeline on the test-only bug
hook, the injection log's trace id and the live budget of three
single-datanode runs, with every live run's children on the CPU
(`device="cpu"`). `TestDeepExplorerMatrix` keeps the JAX package's
`slow` mark (the twin strips it; it is put back here), so tier-1 skips
it on both packages; its replay test runs the port's entry point.

Parity: a seed gives the JAX package's GTPU_CHAOS strings, workloads,
deadlines and skews draw for draw, and the bug-hook pipeline gives the
same outcomes and shrunk schedules in both packages.
"""

import random

import pytest

from greptimedb_tpu.fault import explorer as jex
from greptimedb_tpu_torch.fault import explorer as ex
from torch_twin import twin

pytestmark = pytest.mark.chaos

_ON_CPU = r'__import__("functools").partial(\1, device="cpu")('

globals().update(twin("test_explorer.py", [
    "clean_faults", "TestSamplers", "TestDdmin", "TestBugHookPipeline",
    "TestFaultLogTraceId", "TestLiveExplorerBudget",
    "TestDeepExplorerMatrix"], subs=(
    # every live run's datanodes on the CPU
    (r"\b(ex\.explore)\(", _ON_CPU),
    # the replay test runs the port's entry point, on the CPU
    (r'"tools/chaos_explorer\.py", ',
     '"-m", "greptimedb_tpu_torch.fault.explorer", "--device", "cpu", '),
)))
# tier-1 runs neither package's deep matrix
TestDeepExplorerMatrix = pytest.mark.slow(TestDeepExplorerMatrix)

SEEDS = range(50)


@pytest.mark.parametrize("num_datanodes", [1, 2, 3])
def test_schedules_match_the_jax_sampler(num_datanodes):
    """sample_schedule gives the JAX package's GTPU_CHAOS for seeds 0-49,
    without a deadline, under a fixed one and under the seed's own."""
    for seed in SEEDS:
        for deadline in (None, 800, jex._sample_deadline_ms(seed)):
            got = ex.compile_env(ex.sample_schedule(
                random.Random(f"schedule:{seed}"),
                ex.Topology.cluster(num_datanodes), deadline_ms=deadline))
            want = jex.compile_env(jex.sample_schedule(
                random.Random(f"schedule:{seed}"),
                jex.Topology.cluster(num_datanodes), deadline_ms=deadline))
            assert got == want, (seed, deadline)


def test_election_schedules_skews_and_deadlines_match_the_jax_samplers():
    for seed in SEEDS:
        assert ex.compile_env(ex.sample_election_schedule(
            random.Random(f"schedule:{seed}"), ex.Topology.election(3))) \
            == jex.compile_env(jex.sample_election_schedule(
                random.Random(f"schedule:{seed}"),
                jex.Topology.election(3)))
        assert ex.sample_skews(random.Random(f"skew:{seed}"),
                               ex.Topology.election(3), 9.0) \
            == jex.sample_skews(random.Random(f"skew:{seed}"),
                                jex.Topology.election(3), 9.0)
        assert ex._sample_deadline_ms(seed) == jex._sample_deadline_ms(seed)


@pytest.mark.parametrize("num_datanodes", [1, 2, 3])
def test_workloads_match_the_jax_sampler(num_datanodes):
    for seed in SEEDS:
        for allow_kill in (True, False):
            assert ex.sample_workload(
                random.Random(f"workload:{seed}"), 28,
                ex.Topology.cluster(num_datanodes), allow_kill) \
                == jex.sample_workload(
                    random.Random(f"workload:{seed}"), 28,
                    jex.Topology.cluster(num_datanodes), allow_kill)


def test_bug_hook_pipeline_matches_the_jax_explorer(monkeypatch):
    """explore(runs=10, seed=100, shrink=True) under the point:wal.append
    hook: the same schedules, outcomes and shrunk schedules in both
    packages; the port's repro lines name the port's entry point."""
    monkeypatch.setenv("GTPU_CHAOS_BUG", "point:wal.append")

    def key(report):
        return [(r["seed"], r["chaos_env"], r["outcome"],
                 r.get("shrunk_env")) for r in report["runs"]]

    got = ex.explore(runs=10, seed=100, shrink=True, device="cpu")
    want = jex.explore(runs=10, seed=100, shrink=True)
    assert key(got) == key(want)
    assert any(r["outcome"] == "fail" for r in got["runs"])
    for r in got["runs"]:
        if r["outcome"] == "fail":
            assert "python -m greptimedb_tpu_torch.fault.explorer " \
                   "--replay" in r["repro"]
            assert r["repro"].endswith("--device cpu")


def test_replay_by_seed_regenerates_the_explored_schedule(monkeypatch,
                                                         capsys):
    """`--replay --seed S` samples under the seed's own deadline, as
    explore() did, so it re-runs the schedule the run printed (seed 3
    is one of the seeds whose deadline changes its schedule); the JAX
    tool samples without the deadline (ROADMAP C)."""
    monkeypatch.setenv("GTPU_CHAOS_BUG", "env:no-such-entry")
    monkeypatch.delenv("GTPU_CHAOS", raising=False)
    ran = ex.explore(runs=1, seed=3, shrink=False, device="cpu")
    assert ex.main(["--replay", "--seed", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"replaying (seed 3): {ran['runs'][0]['chaos_env']}\n" in out
    assert "PASS" in out
