"""The port's audit CLI (``repro_torch.launch.analyze``), which judges
stores on the Hopper kernels' rules, against the JAX package's
(``repro.launch.analyze``): given that package's analyzer on its
``TpuSpec``, the port's audit gives the same verdicts, counters, lines
and exit codes on TPU-namespaced stores.  On the port's own stores it
repairs two faults: the reference audit called 20 refused Hopper states
"permanent failures for legal schedules", and a warm start transplanted
a tile the decode product cannot launch."""

import json
import math
import os

import pytest

from repro.core import FaultInjectionCost as RefFaultCost
from repro.core import FaultPlan as RefPlan
from repro.core import RetryPolicy as RefRetry
from repro.core import TrialJournal as RefJournal
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core import shard as ref_shard
from repro.core.analysis import ScheduleAnalyzer as RefAnalyzer
from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.ops import get_op as ref_get_op
from repro.core.records import workload_key_for as ref_key
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro.launch import analyze as ref_analyze
from repro_torch.core import (
    AnalyticalHopperCost,
    GemmConfigSpace,
    ScheduleAnalyzer,
    TrialJournal,
    TuningRecords,
    TuningSession,
    Workload,
)
from repro_torch.launch import analyze
from repro_torch.launch import tune as tune_cli


def _tpu_analyzer(space, in_bytes):
    """The JAX package's analyzer on its own space (whose working set is
    the TPU kernel's) and its ``TpuSpec``."""
    ref_space = ref_get_op(space.op).make_space(space.dims, space.depths, **space.spec_kwargs())
    return RefAnalyzer(ref_space, in_bytes=in_bytes)


def _both(capsys, argv):
    """(exit code, stdout) of the reference audit and of the port's audit
    handed the reference analyzer."""
    out = []
    for run in (lambda: ref_analyze.main(argv),
                lambda: analyze.main(argv, make_analyzer=_tpu_analyzer)):
        rc = run()
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.fixture(scope="module")
def tpu_store(tmp_path_factory):
    """A store the JAX package wrote: two tuned GEMM workloads with
    pruned (static) rows and retried transients."""
    root = tmp_path_factory.mktemp("tpu")
    rec, jnl = str(root / "r.json"), str(root / "r.json.journal.jsonl")

    def factory(space):
        from repro.core.cost.analytical import AnalyticalTPUCost

        return RefFaultCost(AnalyticalTPUCost(space), RefPlan(seed=3, p_corrupt=0.3, fires=1),
                            fault_dir=str(root / "faults"))

    with RefJournal(jnl) as j:
        session = RefSession(RefRecords(rec), cost_factory=factory, seed=1, verbose=False,
                             journal=j)
        for dims in ((256, 256, 256), (512, 256, 512)):
            session.tune_workload(RefWorkload("gemm", dims), "g-bfs", RefBudget(max_trials=30),
                                  n_workers=2, analyze="prune",
                                  retry=RefRetry(max_attempts=3, seed=0))
    return rec, jnl


def _append(path, *rows):
    with open(path, "a") as f:
        for row in rows:
            f.write((row if isinstance(row, str) else json.dumps(row)) + "\n")


# -- the audit against the reference on TPU-namespaced stores -------------------------


@pytest.mark.parametrize("strict", [False, True])
def test_audit_of_a_reference_store_matches_the_reference(tpu_store, capsys, strict):
    rec, jnl = tpu_store
    argv = ["--records", rec, "--journal", jnl] + (["--strict"] if strict else [])
    (ref_rc, ref_out), (rc, out) = _both(capsys, argv)
    assert (rc, out) == (ref_rc, ref_out)
    assert "static audit rows" in out and "failure-provenance:" in out


def test_audit_of_broken_records_matches_the_reference(tmp_path, capsys):
    key = ref_key("gemm", (1024, 1024, 1024), "bfloat16", "analytical_tpu_v5e")
    big = ref_key("gemm", (8192, 8192, 8192), "bfloat16", "analytical_tpu_v5e")
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({
            key: {"op": "gemm", "state": [[8, 8, 4, 4], [8, 128], [8, 8, 4, 4]], "cost": 1e-4},
            big: {"op": "gemm", "state": [[1, 8192, 1, 1], [1, 8192], [1, 8192, 1, 1]],
                  "cost": 1e-4},  # over the TPU's VMEM
            key.replace("1024x", "2048x", 1): {"op": "gemm", "state": [[1, 2048, 1, 1]],
                                                "cost": 1e-4},
            "not a key": {"op": "gemm", "state": [[1]], "cost": 1.0},
            key.replace("bfloat16", "float32"): {"op": "flash", "state": [[8, 128], [8, 128]],
                                                 "cost": 1e-4},  # cross-op
        }, f)
    (ref_rc, ref_out), (rc, out) = _both(capsys, ["--records", path])
    assert (rc, out) == (ref_rc, ref_out)
    assert rc == 1 and out.count("ERROR") >= 4


def test_audit_of_journal_rows_matches_the_reference(tmp_path, capsys):
    """Every row kind the audit triages: finite costs for illegal states,
    predictions posing as measurements, fail kinds (transient, permanent
    on a legal state, unknown, retried), malformed rows, and sharded rows
    with an ownership violation, a cross-shard duplicate and a marker
    gap."""
    jpath = str(tmp_path / "j.jsonl")
    key = ref_key("gemm", (8192, 8192, 8192), "bfloat16", "analytical_tpu_v5e") + "?r1"
    small = ref_key("gemm", (1024, 1024, 1024), "bfloat16", "analytical_tpu_v5e") + "?r1"
    illegal = [[1, 8192, 1, 1], [1, 8192], [1, 8192, 1, 1]]
    legal = [[8, 8, 4, 4], [8, 128], [8, 8, 4, 4]]

    def k(lists):
        return "|".join(",".join(map(str, r)) for r in lists)

    cands = [[[a, 1024 // a, 1, 1], [1, 1024], [b, 1024 // b, 1, 1]]
             for a in (1, 2, 4, 8, 16) for b in (1, 2, 4, 8)]
    foreign = next(c for c in cands if ref_shard.shard_of(small, k(c), 2) == 1)
    mine = [c for c in cands if ref_shard.shard_of(small, k(c), 2) == 0][:2]
    _append(jpath,
            {"w": key, "k": k(illegal), "s": illegal, "op": "gemm", "c": None, "fail": True},
            {"w": key, "k": k(illegal), "s": illegal, "op": "gemm", "c": 0.001},
            {"w": small, "k": k(legal), "s": legal, "op": "gemm", "c": None, "pred": 0.3},
            {"w": small, "k": "bogus", "s": legal, "op": "gemm", "c": 1.0, "pred": 0.5},
            {"w": small, "k": k(legal), "s": legal, "op": "gemm", "c": None, "fail": True,
             "kind": "crash", "attempts": 3},
            {"w": small, "k": k(legal), "s": legal, "op": "gemm", "c": None, "fail": True,
             "kind": "raise"},
            {"w": small, "k": k(legal), "s": legal, "op": "gemm", "c": None, "fail": True,
             "kind": "gremlin"},
            {"w": small, "k": k(mine[0]), "s": mine[0], "op": "gemm", "c": 2e-4, "shard": [0, 2]},
            {"w": small, "k": k(foreign), "s": foreign, "op": "gemm", "c": 3e-4,
             "shard": [0, 2]},
            {"w": small, "k": k(mine[0]), "s": mine[0], "op": "gemm", "c": 2e-4, "shard": [1, 2]},
            {"w": "alien/key", "k": "x", "s": [[1]], "op": "gemm", "c": 1.0},
            {"nothing": "here"},
            "{torn")
    ref_shard.write_done_marker(ref_shard.shard_dir_for(jpath), small, ref_shard.ShardSpec(0, 2),
                                mine[0], 2e-4, 2)
    for strict in ([], ["--strict"]):
        (ref_rc, ref_out), (rc, out) = _both(capsys, ["--journal", jpath] + strict)
        assert (rc, out) == (ref_rc, ref_out)
    assert rc == 1
    assert "violations=2 cross_shard_dups=1 marker_gaps=1" in out
    assert "retried_rows=1" in out and "provenance-only" in out


# -- the port's own stores, on Hopper rules --------------------------------------------


@pytest.fixture(scope="module")
def yi_store(tmp_path_factory):
    """The store of ROADMAP queue 3: yi-6b's GEMMs tuned on the CPU
    against the H100 model, 30 trials, warm-started."""
    rec = str(tmp_path_factory.mktemp("yi") / "yi.json")
    tune_cli.main(["--arch", "yi-6b", "--device", "cpu", "--cost", "analytical", "--noise", "0",
                   "--warm-start", "--max-trials", "30", "--records", rec])
    return rec, rec + ".journal.jsonl"


def test_port_audit_passes_the_port_store_the_reference_audit_misjudges(yi_store, capsys):
    rec, jnl = yi_store
    assert ref_analyze.main(["--records", rec, "--journal", jnl]) == 0
    ref_out = capsys.readouterr().out
    assert "permanent_for_legal=20" in ref_out  # Hopper states judged on TPU rules
    assert analyze.main(["--records", rec, "--journal", jnl, "--strict"]) == 0
    out = capsys.readouterr().out
    assert "permanent_for_legal=0" in out and "0 error(s), 0 warning(s)" in out


def test_warm_start_skips_a_donor_the_kernel_cannot_launch(yi_store):
    """After the yi-6b tune, the nearest donor of the decode product
    (8, 4096, 11008) is a 128-row ``wgmma`` tile that transplants to a
    state the bandwidth kernel cannot take; the warm start moves on and
    returns a launchable state."""
    rec, jnl = yi_store
    session = TuningSession(TuningRecords(rec), journal=TrialJournal(jnl), verbose=False,
                            device="cpu", cost_factory=AnalyticalHopperCost)
    wl = Workload("gemm", (8, 4096, 11008), dtype="bfloat16")
    space = wl.space()
    cost = AnalyticalHopperCost(space)
    s0 = session.warm_start_state(wl, space, cost.name, fingerprint=cost.measure_fingerprint())
    verdict = ScheduleAnalyzer(space, in_bytes=2).analyze(s0)
    assert not verdict.illegal, verdict
    assert math.isfinite(cost.cost(s0))
    # the donor the fault transplanted, still in the store, is refused
    bad = space.state_from_lists([[1, 2, 4, 1], [32, 128], [43, 1, 256, 1]])
    assert ScheduleAnalyzer(space, in_bytes=2).analyze(bad).reason == "stream_tile"


def _gemm_space(pkg, dims):
    return (RefSpace if pkg == "ref" else GemmConfigSpace)(*dims)


@pytest.mark.parametrize("dims,dtype", [((1024, 512, 2048), "float32"),
                                        ((2048, 512, 1024), "bfloat16"),
                                        ((16, 4096, 4096), "bfloat16")])
def test_warm_start_equals_the_reference_where_the_transplant_launches(tmp_path, dims, dtype):
    """Seeded from the same donor record, the port's warm start is the
    reference's transplant whenever the Hopper kernel can launch it, and
    otherwise a state it can."""
    donor_dims = (512, 512, 1024)
    out = {}
    for pkg, Records, Session, Wl in (("ref", RefRecords, RefSession, RefWorkload),
                                      ("port", TuningRecords, TuningSession, Workload)):
        records = Records(str(tmp_path / f"{pkg}.json"))
        donor = Wl("gemm", donor_dims, dtype=dtype)
        best = _gemm_space(pkg, donor_dims).state_from_lists(
            [[2, 2, 64, 1], [4, 128], [2, 2, 128, 2]])
        records.update(donor.key("table"), best, 1e-4, "g-bfs", 10)
        wl = Wl("gemm", dims, dtype=dtype)
        session = Session(records, verbose=False, cost_factory=lambda s, **kw: None)
        out[pkg] = session.warm_start_state(wl, wl.space(), "table")
    space = Workload("gemm", dims, dtype=dtype).space()
    port_ok = not ScheduleAnalyzer(space, in_bytes=2 if dtype == "bfloat16" else 4).analyze(
        out["port"]).illegal
    assert port_ok
    ref_ok = not ScheduleAnalyzer(space, in_bytes=2 if dtype == "bfloat16" else 4).analyze(
        space.state_from_lists(out["ref"].as_lists())).illegal
    if ref_ok:
        assert out["port"].key() == out["ref"].key()


def test_flash_record_is_judged_on_its_head_layout(tmp_path, capsys):
    """A flash record tuned on yi-6b's 32 query heads fills the card; the
    audit rebuilds that space from the record, so ``--strict`` passes."""
    rec = str(tmp_path / "f.json")
    tune_cli.main(["--op", "flash", "--arch", "yi-6b", "--device", "cpu", "--cost",
                   "analytical", "--max-trials", "12", "--fraction", "1.0", "--records", rec,
                   "--warm-start"])
    (record,) = json.load(open(rec)).values()
    assert record["space_kwargs"] == {"heads": 32, "kv_heads": 4}
    capsys.readouterr()
    assert analyze.main(["--records", rec, "--journal", rec + ".journal.jsonl", "--strict"]) == 0
    del record["space_kwargs"]  # judged on one head, the same tile under-fills the card
    path = str(tmp_path / "one_head.json")
    with open(path, "w") as f:
        json.dump({"flash/4096x4096x128/bfloat16/analytical_h100": record}, f)
    assert analyze.main(["--records", path]) == 0
    assert analyze.main(["--records", path, "--strict"]) == 1
    assert "under_fill" in capsys.readouterr().out


def test_port_audit_refuses_what_the_hopper_kernel_cannot_launch(tmp_path, capsys):
    """A 128-row wgmma tile filed under the decode product: legal on the
    TPU's rules, ILLEGAL on the bandwidth kernel's."""
    key = "gemm/m8k4096n11008/bfloat16/hopper_timed"
    path = str(tmp_path / "r.json")
    with open(path, "w") as f:
        json.dump({key: {"op": "gemm", "state": [[1, 2, 4, 1], [32, 128], [43, 1, 256, 1]],
                         "cost": 1e-4}}, f)
    assert analyze.main(["--records", path]) == 1
    assert "ILLEGAL record (stream_tile)" in capsys.readouterr().out
    assert os.path.exists(path)
