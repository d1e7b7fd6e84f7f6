"""Crash-safe tune resume in the port, held against the JAX package's: the
tree<->JSON codec (tensor leaves included), the atomic snapshot store,
per-tuner ``state_dict`` round trips, interrupt-and-resume equivalence
for all eight tuners (the learned ones with their networks on the CPU),
snapshots byte-identical to the reference's, done-snapshot serving, and
a real SIGTERM through the CLI."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.snapshot import tree_to_jsonable as ref_tree_to_jsonable
from repro.core.tuners import TUNERS as REF_TUNERS
from repro.core.tuners import Budget as RefBudget
from repro_torch.core import (
    AnalyticalHopperCost,
    Budget,
    CountingCost,
    GemmConfigSpace,
    TrialJournal,
    TuneCheckpointer,
    TuneInterrupted,
    TuningRecords,
    TuningSession,
    Workload,
    get_op,
)
from repro_torch.core.snapshot import tree_from_jsonable, tree_to_jsonable
from repro_torch.core.tuners import TUNERS, GBFSTuner, RandomTuner
from test_torch_tuning import PortTable, RefTable

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LEARNED = ("n-a2c", "rnn-controller")
#: small proposal batches so a 24-trial budget spans several rounds (the
#: interrupt must land at a round boundary before the budget runs out)
TUNER_KW = {
    "genetic": {"pop": 8, "elite": 4},
    "xgboost-like": {"warmup": 6, "batch_size": 4},
    "n-a2c": {"batch_size": 4},
    "rnn-controller": {"batch_size": 4},
}


@pytest.fixture(scope="module")
def space():
    return GemmConfigSpace(256, 256, 256)


@pytest.fixture(scope="module")
def cost(space):
    return AnalyticalHopperCost(space, dtype="float32")


def _tuner(name, space, seed=7):
    kw = dict(TUNER_KW.get(name, {}))
    if name in LEARNED:
        kw["device"] = "cpu"
    if name in ("g-bfs", "n-a2c"):  # the session's warm start
        kw["s0"] = get_op("gemm").default_state(space, "float32")
    return TUNERS[name](space, AnalyticalHopperCost(space, dtype="float32"), seed=seed, **kw)


# -- tree <-> JSON codec ---------------------------------------------------------

TREE = {
    "params": [
        np.arange(6, dtype=np.float32).reshape(2, 3) / 7.0,
        (np.int32(3), np.bool_(True)),
    ],
    "scalar": np.float32(0.1),
    "empty": [],
}


def test_tree_codec_round_trip_exact():
    data = json.loads(json.dumps(tree_to_jsonable(TREE)))  # survives JSON
    back = tree_from_jsonable(data)
    assert isinstance(back["params"], list)
    assert isinstance(back["params"][1], tuple)  # tuples stay tuples
    np.testing.assert_array_equal(back["params"][0], TREE["params"][0])
    assert back["params"][0].dtype == np.float32
    # float32 values survive the float repr round trip bit-identically
    assert back["scalar"] == np.float32(0.1)
    assert back["params"][1][0] == 3 and back["params"][1][1]


def test_tree_codec_matches_reference_and_takes_tensors():
    """A numpy tree encodes to the reference's bytes, and so does the same
    tree with tensor leaves (copied to the host first)."""
    want = json.dumps(ref_tree_to_jsonable(TREE))
    assert json.dumps(tree_to_jsonable(TREE)) == want
    tensors = {
        "params": [torch.from_numpy(TREE["params"][0]).requires_grad_(),
                   (torch.tensor(3, dtype=torch.int32), torch.tensor(True))],
        "scalar": torch.tensor(np.float32(0.1)),
        "empty": [],
    }
    assert json.dumps(tree_to_jsonable(tensors)) == want


def test_tree_codec_leaf_hook():
    got = tree_from_jsonable(tree_to_jsonable([np.float32(2.0)]), leaf=torch.from_numpy)
    assert isinstance(got[0], torch.Tensor) and got[0].item() == 2.0


# -- the snapshot store -----------------------------------------------------------

def test_checkpointer_save_load_gc_clear(tmp_path):
    ck = TuneCheckpointer(str(tmp_path / "state"), keep_n=2)
    assert ck.load("w", "g-bfs") is None
    for step in (1, 2, 3):
        ck.save("w", "g-bfs", {"round": step}, step=step)
    assert ck.latest_step("w", "g-bfs") == 3
    assert ck.load("w", "g-bfs") == {"round": 3}
    wdir = ck._wdir("w", "g-bfs")
    assert len([n for n in os.listdir(wdir) if n.startswith("step_")]) == 2  # GC
    ck.save("w", "random", {"round": 9}, step=9)  # identities are independent
    assert ck.load("w", "g-bfs") == {"round": 3}
    ck.clear("w", "g-bfs")
    assert ck.load("w", "g-bfs") is None
    assert ck.load("w", "random") == {"round": 9}


def test_checkpointer_uncommitted_snapshot_is_invisible(tmp_path):
    ck = TuneCheckpointer(str(tmp_path / "state"))
    final = ck.save("w", "g-bfs", {"round": 1}, step=1)
    ck.save("w", "g-bfs", {"round": 2}, step=2)
    os.remove(os.path.join(ck._wdir("w", "g-bfs"), "step_00000002", "COMMIT"))
    assert ck.load("w", "g-bfs") == {"round": 1}  # torn publish ignored
    assert os.path.exists(final)


def test_checkpointer_layout_matches_reference(tmp_path):
    """Snapshot directories are named as the reference names them, so
    either package finds the other's snapshots."""
    from repro.core.snapshot import TuneCheckpointer as RefCheckpointer

    key = "gemm/1024x1024x1024/float32/hopper_timed"
    assert (TuneCheckpointer(str(tmp_path))._wdir(key, "n-a2c")
            == RefCheckpointer(str(tmp_path))._wdir(key, "n-a2c"))


def test_interrupt_flag_is_cooperative(tmp_path):
    ck = TuneCheckpointer(str(tmp_path / "state"))
    assert not ck.interrupted
    ck.request_interrupt()
    assert ck.interrupted


# -- tuner state_dict round trips ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(TUNERS))
def test_state_dict_json_round_trip(space, name):
    t = _tuner(name, space, seed=3)
    t.tune(Budget(max_trials=12))
    payload = json.loads(json.dumps(t.state_dict()))
    t2 = _tuner(name, space, seed=3)
    t2.load_state_dict(payload)
    assert t2.rng.getstate() == t.rng.getstate()
    assert json.loads(json.dumps(t2.state_dict())) == payload


def test_state_dict_rejects_foreign_tuner(space, cost):
    snap = GBFSTuner(space, cost).state_dict()
    with pytest.raises(ValueError, match="belongs to tuner"):
        RandomTuner(space, cost).load_state_dict(snap)


# -- interrupt-and-resume equivalence (in-process) -----------------------------------

def _interrupt_then_resume(name, space, n_trials, stop_round):
    """Run until round ``stop_round``, snapshot there, resume a FRESH
    tuner from the JSON-round-tripped snapshot."""
    box = {}

    def checkpoint_fn(t, ctx):
        box["payload"] = {"tuner_state": t.state_dict(), "ctx": ctx.snapshot()}
        if ctx.round_idx >= stop_round:
            raise TuneInterrupted("test")

    with pytest.raises(TuneInterrupted):
        _tuner(name, space).tune(Budget(max_trials=n_trials), checkpoint_fn=checkpoint_fn)
    payload = json.loads(json.dumps(box["payload"]))
    return _tuner(name, space).tune(Budget(max_trials=n_trials), restore=payload)


def _assert_equivalent(ref, res):
    assert [(t.state.key(), t.cost, t.clock_s) for t in res.trials] == [
        (t.state.key(), t.cost, t.clock_s) for t in ref.trials
    ]
    assert (res.best_state is None) == (ref.best_state is None)
    if ref.best_state is not None:
        assert res.best_state.key() == ref.best_state.key()
    assert res.best_cost == ref.best_cost
    assert res.clock_s == ref.clock_s


@pytest.mark.parametrize("name", sorted(TUNERS))
def test_interrupted_resume_is_bit_identical(space, name):
    ref = _tuner(name, space).tune(Budget(max_trials=24))
    res = _interrupt_then_resume(name, space, 24, stop_round=2)
    _assert_equivalent(ref, res)


@pytest.mark.parametrize("stop_round", [1, 3])
@pytest.mark.parametrize("name", ["g-bfs", "sim-anneal", "n-a2c"])
def test_resume_equivalence_at_any_cut(space, name, stop_round):
    ref = _tuner(name, space).tune(Budget(max_trials=40))
    _assert_equivalent(ref, _interrupt_then_resume(name, space, 40, stop_round))


# -- snapshots byte-identical to the reference's ----------------------------------------

def _snapshots(tuners, Space, Table, Bud, name, n_workers):
    out = []

    def checkpoint_fn(t, ctx):
        out.append(json.dumps({"tuner_state": t.state_dict(), "ctx": ctx.snapshot()},
                              separators=(",", ":")))

    space = Space(256, 512, 128)
    kw = {"genetic": {"pop": 8, "elite": 4}}.get(name, {})
    tuners[name](space, Table(space), seed=5, **kw).tune(
        Bud(max_trials=60), n_workers=n_workers, checkpoint_fn=checkpoint_fn)
    return out


@pytest.mark.parametrize("name", ["g-bfs", "random", "grid", "genetic", "xgboost-like"])
@pytest.mark.parametrize("n_workers", [1, 4])
def test_snapshots_byte_identical_to_reference(name, n_workers):
    ref = _snapshots(REF_TUNERS, RefSpace, RefTable, RefBudget, name, n_workers)
    port = _snapshots(TUNERS, GemmConfigSpace, PortTable, Budget, name, n_workers)
    assert len(ref) >= 2 and port == ref


def test_annealing_snapshot_adds_only_its_chains():
    """The annealing tuner's snapshot is the reference's plus its chains
    (which make its resume bit-identical; the reference restarts them)."""
    ref = _snapshots(REF_TUNERS, RefSpace, RefTable, RefBudget, "sim-anneal", 4)
    port = _snapshots(TUNERS, GemmConfigSpace, PortTable, Budget, "sim-anneal", 4)
    assert len(port) == len(ref) >= 2
    for p, r in zip(port, ref):
        p = json.loads(p)
        assert len(p["tuner_state"].pop("chains")) >= 1
        assert json.dumps(p, separators=(",", ":")) == r


# -- session level: done snapshots, fresh-run clearing ----------------------------------

def _session(tmp_path, cost):
    return TuningSession(
        TuningRecords(str(tmp_path / "records.json")),
        cost_factory=lambda space, dtype: cost,
        verbose=False,
        journal=TrialJournal(str(tmp_path / "journal.jsonl")),
        device="cpu",
    )


@pytest.mark.parametrize("name", ["g-bfs", "n-a2c"])
def test_done_snapshot_serves_finished_workload(space, tmp_path, name):
    wl = Workload("gemm", (256, 256, 256), dtype="float32")
    cost = CountingCost(AnalyticalHopperCost(space, dtype="float32"))
    ck = TuneCheckpointer(str(tmp_path / "state"))
    sess = _session(tmp_path, cost)
    res = sess.tune_workload(wl, name, Budget(max_trials=20), checkpointer=ck,
                             warm_start=True)
    n_after_run = cost.n_measured
    assert n_after_run > 0 and ck.load(wl.key(cost.name), name)["done"]
    # resume of a finished workload: served from the done marker — the
    # backend is never touched again
    res2 = sess.tune_workload(wl, name, Budget(max_trials=20), checkpointer=ck,
                              resume=True)
    assert cost.n_measured == n_after_run
    assert res2.best_state.key() == res.best_state.key()
    assert res2.best_cost == res.best_cost
    assert [t.state.key() for t in res2.trials] == [t.state.key() for t in res.trials]


def test_fresh_run_clears_stale_done_marker(space, tmp_path):
    wl = Workload("gemm", (256, 256, 256), dtype="float32")
    cost = CountingCost(AnalyticalHopperCost(space, dtype="float32"))
    ck = TuneCheckpointer(str(tmp_path / "state"))
    sess = _session(tmp_path, cost)
    sess.tune_workload(wl, "g-bfs", Budget(max_trials=6), checkpointer=ck)
    wkey = wl.key(cost.name)
    ck.save(wkey, "g-bfs", {"stale": True}, step=5)  # a leftover below the marker
    # a NON-resume run re-tunes and drops every old snapshot: a new done
    # marker lands and the leftover is gone
    n0 = cost.n_measured
    sess.tune_workload(wl, "g-bfs", Budget(max_trials=6), checkpointer=ck)
    assert cost.n_measured == n0  # (the journal serves the repeats)
    assert ck.load(wkey, "g-bfs")["done"]
    assert not os.path.exists(os.path.join(ck._wdir(wkey, "g-bfs"), "step_00000005"))


def test_session_interrupt_always_snapshots(space, tmp_path):
    """An interrupt flushes a snapshot at the next round boundary even off
    the cadence, and a resume continues to the uninterrupted result."""
    wl = Workload("gemm", (256, 256, 256), dtype="float32")
    cost = AnalyticalHopperCost(space, dtype="float32")
    ref = _session(tmp_path / "ref", cost).tune_workload(wl, "random", Budget(max_trials=12))
    ck = TuneCheckpointer(str(tmp_path / "run" / "state"), every_rounds=1000)
    ck.request_interrupt()
    sess = _session(tmp_path / "run", cost)
    with pytest.raises(TuneInterrupted):
        sess.tune_workload(wl, "random", Budget(max_trials=12), checkpointer=ck)
    assert ck.latest_step(wl.key(cost.name), "random") == 1
    ck2 = TuneCheckpointer(str(tmp_path / "run" / "state"))
    res = sess.tune_workload(wl, "random", Budget(max_trials=12), checkpointer=ck2,
                             resume=True)
    assert [t.state.key() for t in res.trials] == [t.state.key() for t in ref.trials]


# -- the CLI: SIGTERM mid-search, --resume, identical journal and records -------------------

def _tune_cmd(tmp, tuner, *extra):
    return [
        sys.executable, "-m", "repro_torch.launch.tune",
        "--op", "flash", "--fraction", "0.5", "--max-trials", "30", "--warm-start",
        "--seed", "3", "--measure-delay", "0.05", "--device", "cpu",
        "--cost", "analytical", "--tuner", tuner,
        "--records", str(tmp / "records.json"), *extra,
    ]


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in [os.path.abspath(SRC), os.environ.get("PYTHONPATH", "")] if p))


def _journal_keys(path):
    with open(path) as f:
        return [json.loads(line)["k"] for line in f]


@pytest.mark.parametrize("tuner", ["g-bfs", "random", "genetic"])
def test_cli_sigterm_resume_matches_uninterrupted(tuner, tmp_path):
    env = _env()
    ref_dir, run_dir = tmp_path / "ref", tmp_path / "run"
    ref_dir.mkdir()
    run_dir.mkdir()
    # the uninterrupted reference and the run to interrupt, side by side
    ref = subprocess.Popen(_tune_cmd(ref_dir, tuner), env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    p = subprocess.Popen(_tune_cmd(run_dir, tuner), env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    jpath = str(run_dir / "records.json.journal.jsonl")
    deadline = time.monotonic() + 60
    # wait until some measurements landed, so the kill interrupts a search
    while time.monotonic() < deadline:
        if os.path.exists(jpath) and len(_journal_keys(jpath)) >= 3:
            break
        if p.poll() is not None:
            pytest.fail(f"tune exited early: {p.communicate()[1]}")
        time.sleep(0.02)
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 130, (out, err)
    assert "rerun with --resume" in out
    r_out, r_err = ref.communicate(timeout=60)
    assert ref.returncode == 0, r_err
    ref_keys = _journal_keys(str(ref_dir / "records.json.journal.jsonl"))
    assert 0 < len(_journal_keys(jpath)) < len(ref_keys)

    # resume: finishes the search; the combined journal replays the
    # reference's visited sequence exactly and the records match
    r2 = subprocess.run(_tune_cmd(run_dir, tuner, "--resume"), env=env,
                        capture_output=True, text=True, timeout=60)
    assert r2.returncode == 0, r2.stderr
    assert _journal_keys(jpath) == ref_keys
    with open(run_dir / "records.json") as f, open(ref_dir / "records.json") as g:
        recs, ref_recs = json.load(f), json.load(g)
    assert sorted(recs) == sorted(ref_recs) and recs
    for key in recs:
        assert recs[key]["cost"] == ref_recs[key]["cost"]
        assert recs[key]["state"] == ref_recs[key]["state"]

    # resuming the finished run is a no-op served from the done marker
    r3 = subprocess.run(_tune_cmd(run_dir, tuner, "--resume"), env=env,
                        capture_output=True, text=True, timeout=60)
    assert r3.returncode == 0, r3.stderr
    assert "already complete" in r3.stdout
    assert _journal_keys(jpath) == ref_keys
