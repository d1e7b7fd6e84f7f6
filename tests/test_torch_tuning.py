"""G-BFS parity: one deterministic cost table, wrapped as a cost backend
of each package, drives G-BFS directly, through
``TuningSession.tune_workload`` and through ``tune_arch`` on yi-6b's
workloads.  The port must reproduce the JAX package's trial sequence,
costs, clock, best state, records JSON and journal bytes exactly."""

import hashlib
import math
import random
import time

import pytest

from repro.core import TrialJournal as RefJournal
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.cost.base import CostBackend as RefBackend
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro.core.tuners import GBFSTuner as RefGBFS
from repro.launch.tune import workloads_for_arch as ref_workloads_for_arch
from repro_torch.core import Budget, GemmConfigSpace, TrialJournal, TuningRecords, TuningSession, Workload
from repro_torch.core.cost.base import CostBackend
from repro_torch.core.tuners import GBFSTuner
from repro_torch.launch.tune import workloads_for_arch


def table_cost(key: str) -> float:
    """The shared deterministic cost table: a hash of the state key, with
    about one state in ten failing (``inf``)."""
    u = int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big") / 2.0**64
    return math.inf if u < 0.1 else 1e-3 * (1.0 + u)


class RefTable(RefBackend):
    name = "table"

    def cost_once(self, s, repeat_idx):
        return table_cost(s.key())


class PortTable(CostBackend):
    name = "table"

    def cost_once(self, s, repeat_idx):
        return table_cost(s.key())


def _trace(result):
    return [(t.state.key(), t.cost, t.clock_s) for t in result.trials]


def _same(ref, port):
    assert _trace(port) == _trace(ref)
    assert port.n_trials == ref.n_trials
    assert port.best_cost == ref.best_cost
    assert (port.best_state is None) == (ref.best_state is None)
    if ref.best_state is not None:
        assert port.best_state.key() == ref.best_state.key()


@pytest.mark.parametrize("dims", [(64, 64, 64), (256, 512, 128), (8192, 4096, 6144)])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_workers", [1, 4])
def test_gbfs_direct_parity(dims, seed, n_workers):
    ref = RefGBFS(RefSpace(*dims), RefTable(RefSpace(*dims)), seed=seed).tune(
        RefBudget(max_trials=80), n_workers=n_workers
    )
    port = GBFSTuner(GemmConfigSpace(*dims), PortTable(GemmConfigSpace(*dims)), seed=seed).tune(
        Budget(max_trials=80), n_workers=n_workers
    )
    assert ref.n_trials == 80
    _same(ref, port)


@pytest.fixture
def frozen_clock(monkeypatch):
    """Records carry a wall-clock timestamp: freeze it so the files of
    both packages can be compared byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_tune_workload_parity(tmp_path, frozen_clock):
    out = {}
    for pkg, Session, Records, Journal, Wl, Bud, Table in (
        ("ref", RefSession, RefRecords, RefJournal, RefWorkload, RefBudget, RefTable),
        ("port", TuningSession, TuningRecords, TrialJournal, Workload, Budget, PortTable),
    ):
        rec, jnl = str(tmp_path / f"{pkg}.json"), str(tmp_path / f"{pkg}.jsonl")
        with Journal(jnl) as journal:
            session = Session(Records(rec), cost_factory=Table, seed=3,
                              verbose=False, journal=journal)
            wl = Wl("gemm", (512, 256, 1024), dtype="float32", label="w")
            first = session.tune_workload(wl, "g-bfs", Bud(max_trials=40))
            # a warm start from the record just written, partly cache-served
            second = session.tune_workload(wl, "g-bfs", Bud(max_trials=40),
                                           seed=5, warm_start=True)
        out[pkg] = (first, second, _read(rec), _read(jnl))
    ref, port = out["ref"], out["port"]
    _same(ref[0], port[0])
    _same(ref[1], port[1])
    assert port[1].n_cache_hits == ref[1].n_cache_hits > 0
    assert port[2] == ref[2]
    assert port[3] == ref[3]


def test_tune_arch_parity_yi_6b(tmp_path, frozen_clock):
    ref_wls = ref_workloads_for_arch("yi-6b", "train_4k")
    port_wls = workloads_for_arch("yi-6b", "train_4k")
    assert [(w.op, w.dims, w.dtype, w.depths, w.label) for w in port_wls] == [
        (w.op, w.dims, w.dtype, w.depths, w.label) for w in ref_wls
    ]
    out = {}
    for pkg, Session, Records, Journal, wls, Bud, Table in (
        ("ref", RefSession, RefRecords, RefJournal, ref_wls, RefBudget, RefTable),
        ("port", TuningSession, TuningRecords, TrialJournal, port_wls, Budget, PortTable),
    ):
        rec, jnl = str(tmp_path / f"{pkg}.json"), str(tmp_path / f"{pkg}.jsonl")
        journal = Journal(jnl)
        session = Session(Records(rec), cost_factory=Table, seed=1,
                          verbose=False, journal=journal)
        report = session.tune_arch(workloads=wls, tuner_name="g-bfs",
                                   budget=Bud(max_trials=60), n_workers=2)
        out[pkg] = (report, _read(rec), _read(jnl))
    (ref, ref_rec, ref_jnl), (port, port_rec, port_jnl) = out["ref"], out["port"]
    assert sorted(port.results) == sorted(ref.results)
    for label in ref.results:
        _same(ref.results[label], port.results[label])
    assert port.total_trials == ref.total_trials == 60
    assert port.stats.n_dispatched == ref.stats.n_dispatched
    assert port.stats.span_s == ref.stats.span_s
    assert port_rec == ref_rec
    assert port_jnl == ref_jnl


def test_port_reads_reference_stores(tmp_path, frozen_clock):
    """Records and journals keep one schema: the port loads a store the
    JAX package wrote, and a TPU-namespaced record is never served under
    the port's Hopper namespace."""
    from repro.core.records import workload_key_for as ref_key
    from repro_torch.core.records import workload_key_for

    rec, jnl = str(tmp_path / "r.json"), str(tmp_path / "r.jsonl")
    with RefJournal(jnl) as journal:
        session = RefSession(RefRecords(rec), cost_factory=RefTable,
                             verbose=False, journal=journal)
        wl = RefWorkload("gemm", (256, 256, 256), label="w")
        session.tune_workload(wl, "g-bfs", RefBudget(max_trials=20))
        session.records.update(ref_key("gemm", (256, 256, 256)), wl.space().initial_state(),
                               1e-9, "g-bfs", 1)
    records, port_journal = TuningRecords(rec), TrialJournal(jnl)
    assert set(records.keys()) == set(RefRecords(rec).keys())
    key = workload_key_for("gemm", (256, 256, 256), "bfloat16", "table")
    assert records.lookup_state(key).key() == RefRecords(rec).lookup_state(key).key()
    assert records.lookup_state(workload_key_for("gemm", (256, 256, 256))) is None
    assert len(port_journal) == len(RefJournal(jnl)) == 20


@pytest.mark.parametrize("n_workers", [1, 3])
def test_counting_cost_clock_parity(n_workers):
    """The simulated wave clock charges the same seconds in both packages."""
    from repro.core.cost.base import CountingCost as RefCounting
    from repro_torch.core.cost.base import CountingCost

    ref_space, space = RefSpace(256, 256, 256), GemmConfigSpace(256, 256, 256)
    ref = RefCounting(RefTable(ref_space), n_workers=n_workers)
    port = CountingCost(PortTable(space), n_workers=n_workers)
    ref_states = [ref_space.random_state(random.Random(i)) for i in range(10)]
    states = [space.random_state(random.Random(i)) for i in range(10)]
    assert port.batch_cost(states) == ref.batch_cost(ref_states)
    assert port.cost(states[0]) == ref.cost(ref_states[0])
    assert (port.n_measured, port.simulated_clock_s) == (ref.n_measured, ref.simulated_clock_s)
