"""The rest of the JAX package's tuning API in the port, held against
``repro`` on the CPU: ``TuningSession.compare`` (the paper's head-to-head),
``GemmWorkload`` and the ``Workload`` accessors, ``CountingCost.
fraction_explored``, ``TuningRecords.best_cost``, ``TrialJournal.n_trials``
/ ``workloads`` / ``nearest_workload`` (bit for bit: the code is
framework-neutral), and the analytical H100 models' terms
(``compute_time``, ``memory_time``, ``overhead_time``, ``breakdown``) and
brute-force ``optimum`` (the H100 models have no reference to match:
held to their own cost on every state)."""

import math
import random

import pytest

from repro.core import GemmWorkload as RefGemmWorkload
from repro.core import TrialJournal as RefJournal
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.cost.base import CountingCost as RefCounting
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro_torch.core import (AnalyticalHopperCost, Budget, FlashAnalyticalHopperCost,
                              FlashAttnConfigSpace, GemmConfigSpace, GemmWorkload, TrialJournal,
                              TuningRecords, TuningSession, Workload)
from repro_torch.core.analysis import ScheduleAnalyzer
from repro_torch.core.cost.base import CountingCost
from test_torch_tuning import PortTable, RefTable, _read, _same, frozen_clock  # noqa: F401

#: the tuners whose trials are framework-neutral (the learned ones use
#: jax.random in the reference)
NEUTRAL = ["g-bfs", "random", "grid", "sim-anneal", "genetic", "xgboost-like"]


# -- compare ------------------------------------------------------------------------


@pytest.mark.parametrize("n_workers", [1, 4])
def test_compare_matches_the_reference(tmp_path, frozen_clock, n_workers):
    """Every neutral tuner over two seeds (``seed + s``) on the shared
    table cost: the same trials, bests and clocks, and the same records
    and journal bytes."""
    out = {}
    for pkg, Session, Records, Journal, Wl, Bud, Table in (
        ("ref", RefSession, RefRecords, RefJournal, RefWorkload, RefBudget, RefTable),
        ("port", TuningSession, TuningRecords, TrialJournal, Workload, Budget, PortTable),
    ):
        rec, jnl = str(tmp_path / f"{pkg}.json"), str(tmp_path / f"{pkg}.jsonl")
        with Journal(jnl) as journal:
            session = Session(Records(rec), cost_factory=Table, seed=3, verbose=False,
                              journal=journal)
            res = session.compare(Wl("gemm", (256, 512, 128), dtype="float32", label="w"),
                                  NEUTRAL, Bud(max_trials=30), n_seeds=2,
                                  tuner_kwargs={"genetic": {"pop": 8}},
                                  n_workers=n_workers)
        out[pkg] = (res, _read(rec), _read(jnl))
    (ref, ref_rec, ref_jnl), (port, port_rec, port_jnl) = out["ref"], out["port"]
    assert list(port) == list(ref) == NEUTRAL
    for name in NEUTRAL:
        assert len(port[name]) == len(ref[name]) == 2
        for r, p in zip(ref[name], port[name]):
            _same(r, p)
            assert p.clock_s == r.clock_s
    assert port_rec == ref_rec
    assert port_jnl == ref_jnl


def test_compare_tunes_seed_plus_s():
    space = GemmConfigSpace(64, 64, 64)
    session = TuningSession(cost_factory=PortTable, seed=11, verbose=False)
    wl = Workload("gemm", (64, 64, 64), dtype="float32")
    res = session.compare(wl, ["random"], Budget(max_trials=12), n_seeds=3)["random"]
    for s, r in enumerate(res):
        alone = TuningSession(cost_factory=PortTable, verbose=False).tune_workload(
            wl, "random", Budget(max_trials=12), seed=11 + s)
        _same(alone, r)
    assert len({tuple(t.state.key() for t in r.trials) for r in res}) == 3
    assert all(r.n_trials <= 12 for r in res) and space.size() > 12


# -- workloads, counting, records, journal --------------------------------------------


@pytest.mark.parametrize("args", [(8192, 4096, 11008), (8, 4096, 512, "float32", 2, 1, 3, "x")])
def test_gemm_workload_is_the_reference_workload(args):
    port, ref = GemmWorkload(*args), RefGemmWorkload(*args)
    generic = Workload("gemm", args[:3], *args[3:4], depths=tuple(args[4:7]),
                       label=args[7] if len(args) > 7 else "")
    assert port == generic
    for attr in ("op", "dims", "dtype", "depths", "label", "m", "k", "n", "d_m", "d_k", "d_n"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.key("analytical_h100") == ref.key("analytical_h100") == generic.key(
        "analytical_h100")
    assert port.space().size() == ref.space().size()


@pytest.mark.parametrize("n_workers", [1, 3])
def test_fraction_explored_matches_the_reference(n_workers):
    ref_space, space = RefSpace(64, 64, 64), GemmConfigSpace(64, 64, 64)
    ref = RefCounting(RefTable(ref_space), n_workers=n_workers)
    port = CountingCost(PortTable(space), n_workers=n_workers)
    assert port.fraction_explored() == ref.fraction_explored() == 0.0
    port.batch_cost([space.random_state(random.Random(i)) for i in range(25)])
    ref.batch_cost([ref_space.random_state(random.Random(i)) for i in range(25)])
    port.cost(space.initial_state())
    ref.cost(ref_space.initial_state())
    assert port.fraction_explored() == ref.fraction_explored() == 26 / space.size()


def test_records_and_journal_accessors_match_the_reference(tmp_path, frozen_clock):
    """One store the port's session wrote (four GEMM shapes and a flash
    workload), read by both packages."""
    rec, jnl = str(tmp_path / "r.json"), str(tmp_path / "r.jsonl")
    shapes = [(256, 256, 256), (512, 256, 1024), (8, 512, 512), (1024, 512, 512)]
    with TrialJournal(jnl) as journal:
        session = TuningSession(TuningRecords(rec), cost_factory=PortTable, seed=2,
                                verbose=False, journal=journal)
        for dims in shapes:
            session.tune_workload(Workload("gemm", dims, dtype="float32"), "g-bfs",
                                  Budget(max_trials=15 + dims[0] % 7))
        session.tune_workload(Workload("flash", (256, 256, 64)), "g-bfs", Budget(max_trials=6))
    port_r, ref_r = TuningRecords(rec), RefRecords(rec)
    port_j, ref_j = TrialJournal(jnl), RefJournal(jnl)
    keys = list(ref_r.keys())
    assert len(keys) == 5
    missing = "gemm/m1k1n1/float32/table"
    for key in keys + [missing]:
        assert port_r.best_cost(key) == ref_r.best_cost(key)
    assert math.isinf(port_r.best_cost(missing))
    workloads = list(ref_j.workloads())
    assert list(port_j.workloads()) == workloads and len(workloads) == 5
    for wl in workloads + ["nothing"]:
        assert port_j.n_trials(wl) == ref_j.n_trials(wl)
    assert all(port_j.n_trials(wl) > 0 for wl in workloads)
    big = next(wl for wl in workloads if wl.startswith("gemm/m1024"))
    # a journal key's backend part carries its measurement fingerprint
    queries = [(8, 512, 512, "float32", None, None), (300, 300, 300, None, None, None),
               (1024, 512, 512, "float32", None, None), (1024, 512, 512, "float32", None, big),
               (64, 64, 64, "float32", "table?r1", None),
               (64, 64, 64, "bfloat16", None, None), (64, 64, 64, "float32", "table", None)]
    found = [port_j.nearest_workload(*q) for q in queries]
    assert found == [ref_j.nearest_workload(*q) for q in queries]
    assert found[0].startswith("gemm/m8k512n512/") and found[2] == big != found[3]
    assert None not in found[:5] and found[5:] == [None, None]


# -- the analytical models' terms and optimum -----------------------------------------


def _models():
    yield AnalyticalHopperCost(GemmConfigSpace(64, 64, 64), dtype="float32")
    yield AnalyticalHopperCost(GemmConfigSpace(64, 64, 128), dtype="bfloat16")
    yield AnalyticalHopperCost(GemmConfigSpace(8, 256, 512), dtype="bfloat16")
    yield FlashAnalyticalHopperCost(FlashAttnConfigSpace(256, 256, 64), dtype="bfloat16")
    yield FlashAnalyticalHopperCost(FlashAttnConfigSpace(256, 256, 64), dtype="float32")


@pytest.mark.parametrize("model", list(_models()), ids=lambda m: f"{m.space}-{m.dtype}")
def test_terms_add_up_to_the_cost_and_optimum_is_the_minimum(model):
    """On every state the kernel launches, ``max(compute_s, memory_s) +
    overhead_s`` is the model's cost bit for bit; ``optimum()`` is the
    cheapest state of ``enumerate()``; the space's size is refused above
    ``max_states``."""
    analyzer = ScheduleAnalyzer(model.space, model.spec, model.in_bytes)
    costs, kinds = {}, set()
    for s in model.space.enumerate():
        c = model.cost(s)
        costs[s.key()] = c
        if analyzer.analyze(s).illegal:
            assert math.isinf(c)
            continue
        b = model.breakdown(s)
        assert set(b) >= {"smem_bytes", "kernel", "compute_s", "memory_s", "overhead_s"}
        assert (b["compute_s"], b["memory_s"], b["overhead_s"]) == (
            model.compute_time(s), model.memory_time(s), model.overhead_time(s))
        assert max(b["compute_s"], b["memory_s"]) + b["overhead_s"] == c
        assert b["smem_bytes"] == model.space.working_set_bytes(s, model.in_bytes)
        kinds.add(b["kernel"])
    best_s, best_c = model.optimum()
    assert best_c == min(costs.values()) and math.isfinite(best_c)
    assert costs[best_s.key()] == best_c
    assert kinds
    if isinstance(model, AnalyticalHopperCost):
        assert all(model.overhead_time(s) == 0.0 for s in model.space.enumerate()
                   if not analyzer.analyze(s).illegal)
    with pytest.raises(ValueError, match="too large"):
        model.optimum(max_states=model.space.size() - 1)


def test_each_gemm_kernel_has_its_terms():
    """The SIMT and ``wgmma`` kernels have both terms, the bandwidth
    kernel (bf16, fewer than 64 rows a block) memory alone."""
    seen = {}
    for model in list(_models())[:3]:
        analyzer = ScheduleAnalyzer(model.space, model.spec, model.in_bytes)
        for s in model.space.enumerate():
            if not analyzer.analyze(s).illegal:
                b = model.breakdown(s)
                seen.setdefault(b["kernel"], b)
    assert sorted(seen) == ["simt", "stream", "wgmma"]
    assert seen["stream"]["compute_s"] == 0.0 < seen["stream"]["memory_s"]
    assert seen["simt"]["compute_s"] > 0 and seen["wgmma"]["compute_s"] > 0
