"""Measurement lanes of the port (``repro_torch.core.executor``) against
the JAX package's (``repro.core.executor``): the worker-spec protocol,
thread and process lanes, crash and timeout isolation, and whole
searches through real lanes that must reproduce the reference's trial
sequence, costs, records and journal bytes.  Also the two things the
card changes: a worker that raised exits and its slot respawns, and an
in-process lane lets an exception end the session."""

import itertools
import json
import math
import os
import time

import numpy as np
import pytest

from repro.core import ProcessExecutor as RefProcessExecutor
from repro.core import ThreadExecutor as RefThreadExecutor
from repro.core import TrialJournal as RefJournal
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.cost.analytical import AnalyticalTPUCost
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro_torch.core import (
    AnalyticalHopperCost,
    Budget,
    FlashAnalyticalHopperCost,
    FlashAttnConfigSpace,
    GBFSTuner,
    GemmConfigSpace,
    MeasureEngine,
    ProcessExecutor,
    SimulatedExecutor,
    SleepingCost,
    ThreadExecutor,
    TrialJournal,
    TuningRecords,
    TuningSession,
    Workload,
    get_op,
    make_executor,
)
from repro_torch.core.cost.base import backend_from_spec, lognormal_noise, space_spec
from repro_torch.core.cost.measured import TimingGate
from repro_torch.core.executor import stop_worker_servers
from test_torch_tuning import PortTable, RefTable, _read, _same, frozen_clock  # noqa: F401

#: every process lane here has a kill timeout, so no test can hang
LANE_TIMEOUT_S = 30.0


class ShippedRefTable(RefTable):
    """The shared table cost, process-shippable in the JAX package."""

    def worker_spec(self):
        return ("test_torch_executor:shipped_table",
                {"pkg": "ref", "dims": list(self.space.dims)})


class ShippedPortTable(PortTable):
    """The shared table cost, process-shippable in the port."""

    def worker_spec(self):
        return ("test_torch_executor:shipped_table",
                {"pkg": "port", "dims": list(self.space.dims)})


def shipped_table(pkg, dims):
    """Worker-side factory of the shipped table costs."""
    if pkg == "ref":
        return ShippedRefTable(RefSpace(*dims))
    return ShippedPortTable(GemmConfigSpace(*dims))


@pytest.fixture(scope="module")
def space():
    return GemmConfigSpace(256, 256, 256)


#: bf16 tiles of 256^3 the wgmma kernel launches (finite model costs)
LAUNCHABLE = ["1,2,128,1|2,128|2,1,128,1", "1,2,128,1|2,128|4,1,64,1",
              "1,2,128,1|4,64|2,1,128,1", "2,1,128,1|2,128|2,1,128,1"]


@pytest.fixture(scope="module")
def states(space):
    # untiled states (inf: no kernel takes them) and launchable ones
    sts = [space.initial_state()] + space.neighbors(space.initial_state())[:3]
    return sts + [space.state_from_lists([[int(f) for f in row.split(",")]
                                          for row in key.split("|")]) for key in LAUNCHABLE]


# -- worker specs and the noisy models ----------------------------------------------


@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_analytical_spec_round_trip(space, states, sigma):
    for cost in (AnalyticalHopperCost(space, n_repeats=2, noise_sigma=sigma, seed=5),
                 AnalyticalHopperCost(space, dtype="float32", noise_sigma=sigma)):
        rebuilt = backend_from_spec(cost.worker_spec())
        assert type(rebuilt) is type(cost)
        assert [rebuilt.cost(s) for s in states] == [cost.cost(s) for s in states]
        assert rebuilt.measure_fingerprint() == cost.measure_fingerprint()
    fspace = FlashAttnConfigSpace(1024, 1024, 128, heads=32, kv_heads=4)
    flash = FlashAnalyticalHopperCost(fspace, noise_sigma=sigma, seed=2)
    rebuilt = backend_from_spec(flash.worker_spec())
    fstates = list(itertools.islice(fspace.enumerate(), 40))
    assert rebuilt.space.spec_kwargs() == fspace.spec_kwargs()
    assert [rebuilt.cost(s) for s in fstates] == [flash.cost(s) for s in fstates]


def test_noise_draw_is_the_reference_draw(space, states):
    """The seeded lognormal factor is the JAX package's, bit for bit, and
    a noise-free model keeps its fingerprint and costs."""
    ref = AnalyticalTPUCost(RefSpace(256, 256, 256), noise_sigma=0.05, seed=7)
    plain = AnalyticalHopperCost(space)
    noisy = AnalyticalHopperCost(space, n_repeats=3, noise_sigma=0.05, seed=7)
    assert AnalyticalHopperCost(space, noise_sigma=0.0, seed=9).measure_fingerprint() \
        == plain.measure_fingerprint() == "r1|bfloat16|wgmma-tma"
    assert noisy.measure_fingerprint() == "r3|bfloat16|wgmma-tma|noise0.05|seed7"
    for s in states:
        for r in range(3):
            assert lognormal_noise(7, s.key(), r, 0.05) == ref._noise_factor(s, r)
        base = plain.cost(s)
        if math.isfinite(base):
            expect = sum(float(base * ref._noise_factor(s, r)) for r in range(3)) / 3
            assert noisy.cost(s) == expect
        else:
            assert math.isinf(noisy.cost(s))


def test_cli_noise_defaults_to_the_reference_and_touches_only_the_model(tmp_path, capsys):
    from repro_torch.launch import tune as tune_cli

    rec = str(tmp_path / "r.json")
    tune_cli.main(["--arch", "yi-6b", "--device", "cpu", "--cost", "analytical",
                   "--max-trials", "10", "--records", rec])
    keys = {json.loads(line)["w"] for line in open(rec + ".journal.jsonl")}
    assert all(k.endswith("?r1|bfloat16|wgmma-tma|noise0.05|seed0") for k in keys)


def test_sleeping_backend_spec_round_trip(space, states):
    sl = SleepingCost(AnalyticalHopperCost(space), delay_s=0.0,
                      raise_keys=[states[1].key()], hang_s=2.0)
    rebuilt = backend_from_spec(sl.worker_spec())
    assert rebuilt.raise_keys == sl.raise_keys and rebuilt.hang_s == 2.0
    assert rebuilt.cost(states[0]) == sl.cost(states[0])


def test_unshippable_backend_refused():
    guarded = GemmConfigSpace(256, 256, 256, extra_constraint=lambda s: True)
    cost = AnalyticalHopperCost(guarded)
    assert space_spec(guarded) is None and cost.worker_spec() is None
    with ProcessExecutor(timeout_s=LANE_TIMEOUT_S) as ex:
        with pytest.raises(ValueError, match="worker_spec"):
            ex.run_wave(cost, [guarded.initial_state()])


def test_make_executor_names_and_no_fork():
    for name, cls_name in [("sim", "SimulatedExecutor"), ("thread", "ThreadExecutor"),
                           ("process", "ProcessExecutor")]:
        ex = make_executor(name)
        assert type(ex).__name__ == cls_name and ex.name == name
        ex.close()
    with pytest.raises(ValueError):
        make_executor("rpc")
    with pytest.raises(ValueError, match="fork"):
        ProcessExecutor(mp_context="fork")


def test_tune_workload_rejects_engine_executor_conflict():
    space = GemmConfigSpace(64, 64, 64)
    session = TuningSession(cost_factory=AnalyticalHopperCost, verbose=False, device="cpu")
    engine = MeasureEngine(AnalyticalHopperCost(space))
    with pytest.raises(ValueError, match="conflicts"):
        session.tune_workload(Workload("gemm", (64, 64, 64)), "g-bfs", Budget(max_trials=3),
                              engine=engine, executor=SimulatedExecutor())


# -- thread lanes ------------------------------------------------------------------


def test_thread_executor_value_parity_and_overlap(space, states):
    cost = AnalyticalHopperCost(space, n_repeats=2, noise_sigma=0.1, seed=3)
    sim = MeasureEngine(cost, n_workers=4).measure_wave(states[:4])
    sl = SleepingCost(cost, delay_s=0.15)
    with ThreadExecutor() as ex:
        eng = MeasureEngine(sl, n_workers=4, executor=ex)
        t0 = time.perf_counter()
        out = eng.measure_wave(states[:4])
        wall = time.perf_counter() - t0
    assert [o.cost for o in out] == [o.cost for o in sim]
    assert wall < 4 * 0.15  # overlapped, not serial
    assert all(o.lane_s >= 0.15 for o in out)  # measured wall, not modeled


def test_in_process_lanes_end_the_session_on_a_raise_and_time_out(space, states):
    """The port's in-process lanes let a backend exception end the
    session (the JAX package's turn it into an ``inf`` trial): after a
    CUDA error the caller's own context cannot be trusted.  A hung
    thread lane still times out."""
    bad = SleepingCost(AnalyticalHopperCost(space), delay_s=0.02,
                       raise_keys=[states[1].key()], hang_keys=[states[2].key()], hang_s=30.0)
    for ex in (SimulatedExecutor(), ThreadExecutor(timeout_s=0.5)):
        with pytest.raises(RuntimeError, match="injected"):
            MeasureEngine(bad, n_workers=2, executor=ex).measure_wave(states[:2])
    with ThreadExecutor(timeout_s=0.5) as ex:
        eng = MeasureEngine(bad, n_workers=2, executor=ex)
        out = eng.measure_wave([states[0], states[2]])
    assert out[0].error is None
    assert math.isinf(out[1].cost) and out[1].kind == "timeout"
    assert eng.stats.n_failures == 1


# -- process lanes -----------------------------------------------------------------


@pytest.mark.slow
def test_process_executor_value_parity(space, states):
    cost = AnalyticalHopperCost(space, n_repeats=2, noise_sigma=0.1, seed=3)
    with ProcessExecutor(timeout_s=LANE_TIMEOUT_S) as ex:
        eng = MeasureEngine(cost, n_workers=4, executor=ex)
        out = eng.measure_wave(states[4:8]) + eng.measure_wave(states[:4])
    assert [o.cost for o in out] == [cost.cost(s) for s in states[4:8] + states[:4]]
    assert all(o.lane_s > 0 for o in out)


@pytest.mark.slow
def test_process_executor_crash_and_timeout_isolation(tmp_path, space, states):
    """A worker's hard death or hang costs one ``inf`` trial of a
    transient kind, is never journaled, and the next wave measures on
    respawned workers; the worker's start-up never counts against the
    lane timeout."""
    bad = SleepingCost(AnalyticalHopperCost(space), delay_s=0.02,
                       exit_keys=[states[5].key()], hang_keys=[states[6].key()], hang_s=30.0)
    with ProcessExecutor(timeout_s=1.0) as ex, TrialJournal(str(tmp_path / "j.jsonl")) as j:
        eng = MeasureEngine(bad, n_workers=3, executor=ex, journal=j, workload_key="w")
        out = eng.measure_wave(states[4:7])  # cold workers: no warm_up on purpose
        assert out[0].error is None and math.isfinite(out[0].cost)
        assert (out[1].kind, out[2].kind) == ("crash", "timeout")
        assert j.get(eng.journal_key, states[4].key()) is not None
        assert j.get(eng.journal_key, states[5].key()) is None
        assert j.get(eng.journal_key, states[6].key()) is None
        again = eng.measure_wave([states[7], states[0], states[1]])
        assert all(o.error is None for o in again) and math.isfinite(again[0].cost)
        assert ex.fault_stats()["n_respawns"] == 2


def test_worker_that_raised_exits_and_its_slot_respawns(space, states):
    """A measurement that raised is reported with the reference's kind
    (``raise``), and its worker exits: the next job of that slot runs in
    a fresh process, charged to the respawn budget."""
    bad = SleepingCost(AnalyticalHopperCost(space), delay_s=0.0, raise_keys=[states[5].key()])
    with ProcessExecutor(timeout_s=LANE_TIMEOUT_S) as ex:
        eng = MeasureEngine(bad, n_workers=2, executor=ex)
        out = eng.measure_wave(states[4:6])
        assert out[0].error is None
        assert out[1].kind == "raise" and "RuntimeError" in out[1].error
        pid = ex._workers[1].proc.pid
        assert not ex._workers[1].alive()
        out = eng.measure_wave(states[6:8])
        assert all(o.error is None for o in out)
        assert ex._workers[1].alive() and ex._workers[1].proc.pid != pid
        assert ex.fault_stats()["n_respawns"] == 1
        assert eng.stats.n_respawns == 1


@pytest.mark.slow
def test_gbfs_search_identical_through_process_lanes(tmp_path):
    """The same G-BFS search through process lanes visits the same states
    at the same costs as the simulated engine and journals them alike."""
    space = GemmConfigSpace(512, 256, 512)

    s0 = get_op("gemm").default_state(space, "bfloat16")

    def run(executor, jpath):
        cost = AnalyticalHopperCost(space, n_repeats=2, noise_sigma=0.1, seed=3)
        with TrialJournal(jpath) as journal:
            eng = MeasureEngine(cost, n_workers=4, executor=executor, journal=journal,
                                workload_key="gemm/m512k256n512/bfloat16/analytical_h100")
            return GBFSTuner(space, cost, seed=7, s0=s0).tune(Budget(max_trials=40), engine=eng)

    sim = run(None, str(tmp_path / "sim.jsonl"))
    with ProcessExecutor(timeout_s=LANE_TIMEOUT_S) as ex:
        proc = run(ex, str(tmp_path / "proc.jsonl"))
    assert [(t.state.key(), t.cost) for t in proc.trials] == [
        (t.state.key(), t.cost) for t in sim.trials]
    assert proc.best_cost == sim.best_cost
    assert (proc.executor, sim.executor) == ("process", "sim")
    assert _read(tmp_path / "proc.jsonl") == _read(tmp_path / "sim.jsonl")


def test_stop_worker_servers_leaves_no_process_running(space, states):
    """After the last executor closes, ``stop_worker_servers`` ends the
    forkserver and the resource tracker and waits for both, so nothing
    the lanes started outlives the program; a later executor starts
    them anew."""
    from multiprocessing import forkserver, resource_tracker

    cost = AnalyticalHopperCost(space)
    with ProcessExecutor(timeout_s=LANE_TIMEOUT_S) as ex:
        eng = MeasureEngine(cost, n_workers=2, executor=ex)
        assert [o.cost for o in eng.measure_wave(states[:2])] == [cost.cost(s) for s in states[:2]]
        workers = [w.proc.pid for w in ex._workers]
    servers = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
    assert all(servers)
    stop_worker_servers()
    assert forkserver._forkserver._forkserver_pid is None
    assert resource_tracker._resource_tracker._pid is None
    for pid in servers + workers:  # gone, or a zombie that has ended
        try:
            with open(f"/proc/{pid}/stat") as f:
                assert f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except FileNotFoundError:
            pass
    with ProcessExecutor(timeout_s=LANE_TIMEOUT_S) as ex:
        eng = MeasureEngine(cost, n_workers=1, executor=ex)
        assert eng.measure_wave(states[2:3])[0].cost == cost.cost(states[2])
    stop_worker_servers()


def test_worker_memory_probe(space):
    with ProcessExecutor(timeout_s=LANE_TIMEOUT_S) as ex:
        ex.warm_up(2, backend=AnalyticalHopperCost(space))
        stats = ex.worker_call("repro_torch.core.cost.measured:worker_stats")
    assert len(stats) == 2 and all(s["peak_allocated"] == 0 for s in stats)
    assert len({s["pid"] for s in stats}) == 2


# -- the per-card timing gate -------------------------------------------------------


def test_timing_gate_raises_when_its_lock_cannot_be_opened(tmp_path):
    """No unserialized fallback: measuring without the lock would hand
    out wrong costs."""
    gate = TimingGate(str(tmp_path / "no-such-dir" / "card.lock"))
    with pytest.raises(OSError):
        with gate:
            pass
    with gate.__class__(str(tmp_path / "card.lock")):  # the thread lock was released
        pass


def test_timing_gate_serializes_holders_and_counts_overlaps(tmp_path):
    """Gates on one lock path never hold the region together (each is
    its own open file, as another process's would be), and a live
    foreign holder found inside the region is counted as an overlap."""
    import threading

    lock = str(tmp_path / "card.lock")
    inside, peak = [0], [0]
    guard = threading.Lock()

    def lane():
        gate = TimingGate(lock)
        for _ in range(25):
            with gate:
                with guard:
                    inside[0] += 1
                    peak[0] = max(peak[0], inside[0])
                time.sleep(0.001)
                with guard:
                    inside[0] -= 1

    threads = [threading.Thread(target=lane) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    gate = TimingGate(lock)
    assert peak[0] == 1 and gate.stats() == {"entries": 100, "overlaps": 0}
    with open(lock + ".held", "w") as f:  # a live holder that bypassed the lock
        f.write(f"{os.getppid()}:1")
    with gate:
        pass
    assert gate.stats() == {"entries": 101, "overlaps": 1}
    with open(lock + ".held", "w") as f:  # a holder killed inside the region
        f.write("999999999:1")
    with gate:
        pass
    assert gate.stats()["overlaps"] == 1


# -- whole searches: the port against the reference ---------------------------------


def _session_run(pkg, tmp_path, executor, n_workers):
    if pkg == "ref":
        Session, Records, Journal, Wl, Bud, Table = (
            RefSession, RefRecords, RefJournal, RefWorkload, RefBudget, ShippedRefTable)
        Thread, Process = RefThreadExecutor, RefProcessExecutor
    else:
        Session, Records, Journal, Wl, Bud, Table = (
            TuningSession, TuningRecords, TrialJournal, Workload, Budget, ShippedPortTable)
        Thread, Process = ThreadExecutor, ProcessExecutor
    ex = (Thread(timeout_s=LANE_TIMEOUT_S) if executor == "thread"
          else Process(timeout_s=LANE_TIMEOUT_S))
    rec, jnl = tmp_path / f"{pkg}.json", tmp_path / f"{pkg}.jsonl"
    try:
        with Journal(str(jnl)) as journal:
            session = Session(Records(str(rec)), cost_factory=Table, seed=3,
                              verbose=False, journal=journal)
            wls = [Wl("gemm", (512, 256, 1024), dtype="float32", label="a"),
                   Wl("gemm", (256, 256, 256), dtype="bfloat16", label="b")]
            report = session.tune_arch(workloads=wls, tuner_name="g-bfs",
                                       budget=Bud(max_trials=48), n_workers=n_workers,
                                       executor=ex)
    finally:
        ex.close()
    return report, _read(rec), _read(jnl)


@pytest.mark.parametrize("executor,n_workers", [("thread", 1), ("thread", 4),
                                                ("process", 1), ("process", 4)])
def test_tune_arch_through_real_lanes_matches_the_reference(tmp_path, frozen_clock,
                                                           executor, n_workers):
    ref, ref_rec, ref_jnl = _session_run("ref", tmp_path, executor, n_workers)
    port, port_rec, port_jnl = _session_run("port", tmp_path, executor, n_workers)
    assert port.executor == ref.executor == executor
    for label in ref.results:
        r, p = ref.results[label], port.results[label]
        assert [(t.state.key(), t.cost) for t in p.trials] == [
            (t.state.key(), t.cost) for t in r.trials]
        assert p.best_state.key() == r.best_state.key() and p.best_cost == r.best_cost
    assert port.total_trials == ref.total_trials == 48
    assert port_rec == ref_rec
    assert port_jnl == ref_jnl


def test_sim_lanes_clock_matches_the_reference(tmp_path, frozen_clock):
    """Under the simulated executor the clock is modeled, so it matches
    too; the two real executors charge measured wall seconds instead."""
    from repro.core import make_executor as ref_make_executor

    out = {}
    for pkg, Session, Records, Journal, Wl, Bud, Table, make in (
        ("ref", RefSession, RefRecords, RefJournal, RefWorkload, RefBudget, RefTable,
         ref_make_executor),
        ("port", TuningSession, TuningRecords, TrialJournal, Workload, Budget, PortTable,
         make_executor),
    ):
        with Journal(str(tmp_path / f"{pkg}.jsonl")) as journal:
            session = Session(Records(str(tmp_path / f"{pkg}.json")), cost_factory=Table,
                              seed=3, verbose=False, journal=journal)
            out[pkg] = session.tune_workload(
                Wl("gemm", (512, 256, 1024), dtype="float32", label="a"), "g-bfs",
                Bud(max_trials=40), n_workers=4, executor=make("sim"),
                reload_every=2)
    _same(out["ref"], out["port"])
    assert out["port"].clock_s == out["ref"].clock_s
    assert np.isfinite(out["port"].clock_s)
