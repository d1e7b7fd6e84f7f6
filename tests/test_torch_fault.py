"""Fault injection and recovery in the port (``repro_torch.core.fault``)
against the JAX package's (``repro.core.fault``): the seeded
``FaultPlan``, ``FaultInjectionCost`` and its fire budgets, the engine's
retry loop, and process lanes that crash, hang, raise and respawn — with
the same outcomes, counters and journal bytes as the reference wherever
the reference runs the same lanes."""

import json
import math
import time

import pytest

from repro.core import FaultInjectionCost as RefFaultCost
from repro.core import FaultPlan as RefPlan
from repro.core import MeasureEngine as RefEngine
from repro.core import RetryPolicy as RefRetry
from repro.core import TrialJournal as RefJournal
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core import fault as ref_fault
from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro.core.tuners import GBFSTuner as RefGBFS
from repro_torch.core import (
    PERMANENT_KINDS,
    TRANSIENT_KINDS,
    AnalyticalHopperCost,
    Budget,
    FaultInjectionCost,
    FaultPlan,
    GBFSTuner,
    GemmConfigSpace,
    MeasureEngine,
    MeasureStats,
    ProcessExecutor,
    RetryPolicy,
    SleepingCost,
    ThreadExecutor,
    TrialJournal,
    TuningRecords,
    TuningSession,
    Workload,
    classify_error,
)
from repro_torch.core.cost.base import backend_from_spec
from test_torch_executor import LAUNCHABLE, ShippedPortTable
from test_torch_tuning import PortTable, RefTable, _read, frozen_clock  # noqa: F401

WKEY = "gemm/m256k256n256/bfloat16/table"


@pytest.fixture(scope="module")
def space():
    return GemmConfigSpace(256, 256, 256)


@pytest.fixture(scope="module")
def states(space):
    return [space.initial_state()] + space.neighbors(space.initial_state())[:5]


def _ref_states(states):
    rs = RefSpace(256, 256, 256)
    return [rs.state_from_lists(s.as_lists()) for s in states]


# -- taxonomy and plans --------------------------------------------------------------


def test_taxonomy_and_classification_match_the_reference():
    assert TRANSIENT_KINDS == ref_fault.TRANSIENT_KINDS
    assert PERMANENT_KINDS == ref_fault.PERMANENT_KINDS
    assert not TRANSIENT_KINDS & PERMANENT_KINDS
    for note in (None, "worker crashed mid-measurement", "lane timeout after 1s",
                 "worker died before dispatch", "RuntimeError: boom", "corrupt value"):
        assert classify_error(note) == ref_fault.classify_error(note)


@pytest.mark.parametrize("kw", [
    dict(seed=3, p_crash=0.2, p_raise=0.2),
    dict(seed=9, p_crash=0.1, p_hang=0.1, p_raise=0.05, p_outlier=0.1, p_corrupt=0.3),
    dict(seed=0, p_corrupt=1.0, fires=-1),
])
def test_fault_plan_matches_the_reference(space, kw):
    plan, ref = FaultPlan(**kw), RefPlan(**kw)
    assert plan.as_kwargs() == ref.as_kwargs()
    keys = [s.key() for s in list(space.enumerate())[:3000:7]]
    assert [plan.fault_for(k) for k in keys] == [ref.fault_for(k) for k in keys]


def test_fault_injection_fire_budget_and_spec(space, states, tmp_path):
    inner = AnalyticalHopperCost(space)
    faulty = FaultInjectionCost(inner, FaultPlan(seed=1, p_corrupt=1.0, fires=2),
                                fault_dir=str(tmp_path / "f"))
    s = states[0]
    assert [faulty.cost(s), faulty.cost(s)] == [-1.0, -1.0]
    assert faulty.cost(s) == inner.cost(s)  # budget spent: measures cleanly
    assert faulty.measure_fingerprint() == inner.measure_fingerprint()
    rebuilt = backend_from_spec(faulty.worker_spec())
    assert rebuilt.plan == faulty.plan and rebuilt.fault_dir == faulty.fault_dir
    assert rebuilt.cost(s) == inner.cost(s)  # the fire counter is shared on disk
    always = FaultInjectionCost(inner, FaultPlan(seed=0, p_raise=1.0),
                                fault_dir=str(tmp_path / "g"))
    for _ in range(3):
        with pytest.raises(RuntimeError, match="injected permanent"):
            always.cost(s)


# -- the engine's retry loop (simulated lanes: corrupt is the in-process-safe
# transient, a crash would kill the test runner) --------------------------------------


def _engine_run(pkg, tmp_path, plan_kw, retry_kw, states, n_workers):
    if pkg == "ref":
        Engine, Journal, Fault, Plan, Retry, Table = (
            RefEngine, RefJournal, RefFaultCost, RefPlan, RefRetry, RefTable)
        states = _ref_states(states)
        space = RefSpace(256, 256, 256)
    else:
        Engine, Journal, Fault, Plan, Retry, Table = (
            MeasureEngine, TrialJournal, FaultInjectionCost, FaultPlan, RetryPolicy, PortTable)
        space = GemmConfigSpace(256, 256, 256)
    faulty = Fault(Table(space), Plan(**plan_kw), fault_dir=str(tmp_path / f"faults-{pkg}"))
    jpath = tmp_path / f"{pkg}.jsonl"
    with Journal(str(jpath)) as j:
        eng = Engine(faulty, n_workers=n_workers, journal=j, workload_key=WKEY,
                     retry=Retry(**retry_kw) if retry_kw else None)
        outs = []
        for i in range(0, len(states), n_workers):
            outs.extend(eng.measure_wave(states[i : i + n_workers]))
    trace = [(o.state.key(), o.cost, o.lane_s, o.kind, o.attempts, o.failed_transient)
             for o in outs]
    st = eng.stats
    counters = (st.n_retries, st.n_transient_recovered, st.n_failed_transient,
                st.n_failures, st.retry_backoff_s, st.n_dispatched)
    return trace, counters, _read(jpath) if jpath.exists() else b""


@pytest.mark.parametrize("case", [
    # every transient retried to success
    (dict(seed=1, p_corrupt=1.0, fires=1), dict(max_attempts=3, seed=1), 3),
    # retries exhausted: provenance rows, never cache entries
    (dict(seed=1, p_corrupt=1.0, fires=-1), dict(max_attempts=2, seed=0), 2),
    # without a policy, lane failures are counted but never journaled
    (dict(seed=1, p_corrupt=1.0, fires=-1), None, 1),
    # a partial plan, several waves
    (dict(seed=5, p_corrupt=0.4, fires=1), dict(max_attempts=3, backoff_s=0.1, seed=4), 2),
])
def test_retry_loop_matches_the_reference(space, states, tmp_path, case):
    plan_kw, retry_kw, n_workers = case
    ref = _engine_run("ref", tmp_path, plan_kw, retry_kw, states, n_workers)
    port = _engine_run("port", tmp_path, plan_kw, retry_kw, states, n_workers)
    assert port == ref


def test_retried_search_matches_the_reference_and_a_fault_free_run(tmp_path):
    """G-BFS over a faulted backend with retries: the trial sequence,
    clock and journal bytes are the reference's, and the journal is the
    fault-free run's cost table (recovery is invisible to the search)."""
    out = {}
    for pkg, Space, Table, Fault, Plan, Engine, Journal, Retry, GBFS, Bud in (
        ("ref", RefSpace, RefTable, RefFaultCost, RefPlan, RefEngine, RefJournal, RefRetry,
         RefGBFS, RefBudget),
        ("port", GemmConfigSpace, PortTable, FaultInjectionCost, FaultPlan, MeasureEngine,
         TrialJournal, RetryPolicy, GBFSTuner, Budget),
    ):
        for faulted in (False, True):
            space = Space(512, 256, 1024)
            backend = Table(space)
            if faulted:
                backend = Fault(backend, Plan(seed=5, p_corrupt=0.4, fires=1),
                                fault_dir=str(tmp_path / f"faults-{pkg}"))
            jpath = tmp_path / f"{pkg}-{faulted}.jsonl"
            with Journal(str(jpath)) as j:
                eng = Engine(backend, n_workers=2, journal=j, workload_key=WKEY,
                             retry=Retry(max_attempts=3, seed=0))
                res = GBFS(space, backend, seed=4).tune(Bud(max_trials=24), engine=eng)
            out[pkg, faulted] = ([(t.state.key(), t.cost, t.clock_s) for t in res.trials],
                                 _read(jpath))
    assert out["port", True] == out["ref", True]
    assert out["port", False] == out["ref", False]
    # retried rows land later in the file, so the cost tables are compared
    tables = [{r["k"]: r["c"] for r in map(json.loads, out["port", f][1].splitlines())}
              for f in (True, False)]
    assert tables[0] == tables[1]


def test_permanent_raise_is_cached_not_retried(space, tmp_path):
    """A deterministic raise is a property of the schedule: one attempt,
    journaled as a cacheable ``inf`` row of kind ``raise`` — the
    reference's row, though the port measures it in a worker process
    (its in-process lanes let the exception end the session)."""
    s = space.state_from_lists([[int(f) for f in r.split(",")] for r in LAUNCHABLE[0].split("|")])
    ref_faulty = RefFaultCost(RefTable(RefSpace(256, 256, 256)), RefPlan(seed=1, p_raise=1.0),
                              fault_dir=str(tmp_path / "rf"))
    with RefJournal(str(tmp_path / "ref.jsonl")) as j:
        eng = RefEngine(ref_faulty, journal=j, workload_key=WKEY,
                        retry=RefRetry(max_attempts=3, seed=0))
        (ref_o,) = eng.measure_wave(_ref_states([s]))
    faulty = FaultInjectionCost(ShippedPortTable(space), FaultPlan(seed=1, p_raise=1.0),
                                fault_dir=str(tmp_path / "pf"))
    with pytest.raises(RuntimeError, match="injected permanent"):
        MeasureEngine(faulty, workload_key=WKEY).measure_wave([s])
    with ProcessExecutor(timeout_s=30.0) as ex, TrialJournal(str(tmp_path / "port.jsonl")) as j:
        eng = MeasureEngine(faulty, journal=j, workload_key=WKEY, executor=ex,
                            retry=RetryPolicy(max_attempts=3, seed=0))
        (o,) = eng.measure_wave([s])
        assert eng.stats.n_retries == 0
    assert (o.kind, o.attempts, o.failed_transient, o.cost) == (
        ref_o.kind, ref_o.attempts, ref_o.failed_transient, ref_o.cost) == ("raise", 1, False, math.inf)
    assert _read(tmp_path / "port.jsonl") == _read(tmp_path / "ref.jsonl")
    assert math.isinf(TrialJournal(str(tmp_path / "port.jsonl")).get(
        f"{WKEY}?{faulty.measure_fingerprint()}", s.key(), op="gemm"))


# -- process lanes: crash, hang and corrupt recovered; respawn budget; spares ----------


@pytest.mark.slow
def test_process_lanes_recover_every_planted_transient(tmp_path, frozen_clock):
    """A seeded plan of crashes, hangs and corrupt values over process
    lanes with retries: every transient is recovered, each crash and
    hang respawns a worker, and the journal's cost table and the records
    are the fault-free reference run's, the records byte for byte."""
    plan = FaultPlan(seed=2, p_crash=0.15, p_hang=0.05, p_corrupt=0.15, hang_s=10.0, fires=1)
    wl_kw = dict(op="gemm", dims=(512, 256, 1024), dtype="float32", label="a")
    def ref_factory(space):  # the same wrapper (its name keys the records), no faults
        return RefFaultCost(RefTable(space), RefPlan(seed=2), fault_dir=str(tmp_path / "rf"))

    with RefJournal(str(tmp_path / "ref.jsonl")) as j:
        RefSession(RefRecords(str(tmp_path / "ref.json")), cost_factory=ref_factory, seed=3,
                   verbose=False, journal=j).tune_workload(
            RefWorkload(**wl_kw), "g-bfs", RefBudget(max_trials=40), n_workers=4)

    def factory(space, dtype="bfloat16"):
        return FaultInjectionCost(ShippedPortTable(space), plan, fault_dir=str(tmp_path / "f"))

    stats = MeasureStats()
    # a budget no slot exhausts: a degraded slot measures in this process,
    # where a planted crash would end the test run
    with ProcessExecutor(timeout_s=2.0, max_respawns=1000) as ex, \
            TrialJournal(str(tmp_path / "port.jsonl")) as j:
        session = TuningSession(TuningRecords(str(tmp_path / "port.json")),
                                cost_factory=factory, seed=3, verbose=False, journal=j)
        res = session.tune_workload(Workload(**wl_kw), "g-bfs", Budget(max_trials=40),
                                    n_workers=4, executor=ex, stats=stats,
                                    retry=RetryPolicy(max_attempts=3, backoff_s=0.01, seed=0))
    fates = [plan.fault_for(t.state.key()) for t in res.trials]
    assert stats.n_transient_recovered == sum(f in ("crash", "hang", "corrupt") for f in fates) > 0
    assert stats.n_failed_transient == 0
    assert stats.n_respawns >= sum(f in ("crash", "hang") for f in fates) > 0
    # the same cost table (a retried failure row also records its attempts)
    tables = [{r["k"]: r["c"] for r in map(json.loads, open(tmp_path / f"{p}.jsonl"))}
              for p in ("port", "ref")]
    assert tables[0] == tables[1]
    assert _read(tmp_path / "port.json") == _read(tmp_path / "ref.json")


@pytest.mark.slow
def test_process_respawn_budget_degrades_to_an_in_thread_lane(space, states):
    backend = SleepingCost(AnalyticalHopperCost(space), delay_s=0.0,
                           exit_keys=[s.key() for s in states[:2]])
    clean = space.state_from_lists([[int(f) for f in r.split(",")] for r in LAUNCHABLE[1].split("|")])
    with ProcessExecutor(timeout_s=30.0, max_respawns=1, respawn_backoff_s=0.01) as ex:
        eng = MeasureEngine(backend, n_workers=1, executor=ex)
        for s in states[:2]:  # two deaths on lane 0: its budget (1) is exhausted
            (o,) = eng.measure_wave([s])
            assert math.isinf(o.cost) and o.kind == "crash"
        (o,) = eng.measure_wave([clean])  # in-thread now, same value
        assert o.cost == AnalyticalHopperCost(space).cost(clean)
        assert ex.fault_stats()["n_degraded_lanes"] == eng.stats.n_degraded_lanes == 1


@pytest.mark.slow
def test_process_hot_spare_adoption(space, states):
    backend = SleepingCost(AnalyticalHopperCost(space), delay_s=0.0, exit_keys=[states[0].key()])
    with ProcessExecutor(timeout_s=30.0) as ex:
        ex.warm_up(2, backend=backend)  # one lane wide + one hot spare
        eng = MeasureEngine(backend, n_workers=1, executor=ex)
        (o,) = eng.measure_wave([states[0]])
        assert o.kind == "crash"
        t0 = time.perf_counter()
        (o,) = eng.measure_wave([states[1]])
        assert time.perf_counter() - t0 < 2.0  # the spare was prewarmed
        fs = ex.fault_stats()
    assert (fs["n_spare_adoptions"], fs["n_respawns"], fs["n_degraded_lanes"]) == (1, 1, 0)
    assert eng.stats.n_spare_adoptions == 1


@pytest.mark.slow
def test_straggler_detection(space, tmp_path):
    plan = FaultPlan(seed=13, p_outlier=0.2, outlier_s=0.6, fires=1)
    pool, outlier = [], None
    for s in [space.initial_state()] + space.neighbors(space.initial_state()):
        fate = plan.fault_for(s.key())
        if fate == "outlier" and outlier is None:
            outlier = s
        elif fate is None and len(pool) < 2:
            pool.append(s)
    assert outlier is not None
    backend = FaultInjectionCost(SleepingCost(AnalyticalHopperCost(space), delay_s=0.01),
                                 plan, fault_dir=str(tmp_path))
    with ThreadExecutor(timeout_s=30.0) as ex:
        eng = MeasureEngine(backend, n_workers=3, executor=ex)
        eng.measure_wave(pool + [outlier])
    assert eng.stats.n_stragglers >= 1


def test_cli_lanes_and_retries_keep_the_journal(tmp_path, capsys):
    """The tune CLI's lane, retry and reload flags change how candidates
    are measured, never what is journaled."""
    from repro_torch.launch import tune as tune_cli

    base = ["--arch", "yi-6b", "--device", "cpu", "--cost", "analytical", "--max-trials", "20",
            "--warm-start", "--seed", "2"]
    tune_cli.main(base + ["--records", str(tmp_path / "a.json")])
    tune_cli.main(base + ["--records", str(tmp_path / "b.json"), "--workers", "4",
                          "--executor", "thread", "--retries", "3", "--retry-backoff", "0.01",
                          "--reload-every", "2"])
    out = capsys.readouterr().out
    assert "workers=4 executor=thread" in out and "lane_failures=0" in out
    rows = [[json.loads(line) for line in open(tmp_path / f"{n}.json.journal.jsonl")]
            for n in "ab"]
    assert sorted(map(json.dumps, rows[0])) == sorted(map(json.dumps, rows[1]))
