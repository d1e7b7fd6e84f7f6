"""Sharded search in the port (``repro_torch.core.shard``) against the
JAX package's (``repro.core.shard``): the partition rule, the CLI spec,
done-marker bytes, the election, shard-suffixed snapshot names, and
sharded sessions that merge to the single-engine best with the
reference's journal and records bytes — plus two concurrent CLI shard
processes over one journal, as a user runs them."""

import json
import math
import os
import subprocess
import sys

import pytest

from repro.core import shard as ref_shard
from repro.core import TrialJournal as RefJournal
from repro.core import TuneCheckpointer as RefCheckpointer
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro_torch.core import (
    Budget,
    GemmConfigSpace,
    ShardSpec,
    TrialJournal,
    TuneCheckpointer,
    TuningRecords,
    TuningSession,
    Workload,
    await_markers,
    elect_best,
    parse_shard,
    read_done_markers,
    shard_dir_for,
    shard_of,
    write_done_marker,
)
from test_torch_tuning import PortTable, RefTable, _read, frozen_clock  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# -- the partition rule and the spec -------------------------------------------------


def test_shard_of_and_specs_match_the_reference():
    keys = [s.key() for s in list(GemmConfigSpace(256, 256, 256).enumerate())[:4000:13]]
    for wkey in ("gemm/m256k256n256/bfloat16/hopper_timed?r3", "flash/x"):
        for n in (0, 1, 2, 3, 5):
            owners = [shard_of(wkey, k, n) for k in keys]
            assert owners == [ref_shard.shard_of(wkey, k, n) for k in keys]
            assert all(0 <= o < max(1, n) for o in owners)
        assert [shard_of(wkey, k, 2) for k in keys] != [shard_of("other", k, 2) for k in keys]
    for text in ("0/1", "0/2", " 1/4 "):
        spec, ref = parse_shard(text), ref_shard.parse_shard(text)
        assert (spec.index, spec.count, spec.enabled, str(spec)) == (
            ref.index, ref.count, ref.enabled, str(ref))
        assert spec.owns("w", "k") == ref.owns("w", "k")
    for bad in ("", "1", "1/", "/2", "a/b", "1:2", "0/2/3", "2/2"):
        with pytest.raises(ValueError):
            parse_shard(bad)
        with pytest.raises(ValueError):
            ref_shard.parse_shard(bad)
    with pytest.raises(ValueError):
        ShardSpec(-1, 2)


def test_done_markers_and_election_match_the_reference(tmp_path):
    wkey = "gemm/m256k256n256/bfloat16/table?r1"
    trees = {}
    for pkg, mod in (("port", sys.modules[write_done_marker.__module__]), ("ref", ref_shard)):
        root = mod.shard_dir_for(str(tmp_path / pkg / "j.jsonl"))
        mod.write_done_marker(root, wkey, mod.ShardSpec(0, 2), [[1, 2], [3]], 0.5, 10)
        mod.write_done_marker(root, wkey, mod.ShardSpec(1, 2), None, math.inf, 7)
        trees[pkg] = {os.path.relpath(os.path.join(d, f), root): _read(os.path.join(d, f))
                      for d, _, fs in os.walk(root) for f in fs}
        assert mod.read_done_markers(root, "other", 2) == {}
    assert trees["port"] == trees["ref"] and len(trees["port"]) == 2
    root = shard_dir_for(str(tmp_path / "port" / "j.jsonl"))
    markers = read_done_markers(root, wkey, 2)
    assert markers[1]["best_cost"] is None and markers[0]["n_measured"] == 10
    assert elect_best(markers) == ref_shard.elect_best(markers) == (0, [[1, 2], [3]], 0.5)
    tie = {1: {"best": [[1]], "best_cost": 1.0}, 0: {"best": [[0]], "best_cost": 1.0}}
    assert elect_best(tie) == ref_shard.elect_best(tie) == (0, [[0]], 1.0)
    assert elect_best({}) is None
    partial = await_markers(shard_dir_for(str(tmp_path / "p.jsonl")), wkey,
                            ShardSpec(0, 2), timeout_s=0.2, poll_s=0.05)
    assert partial == {}


# -- sharded sessions: the port against the reference ----------------------------------


def _sharded_runs(pkg, root, tuner):
    if pkg == "ref":
        Session, Records, Journal, Wl, Bud, Table, Ck, parse = (
            RefSession, RefRecords, RefJournal, RefWorkload, RefBudget, RefTable,
            RefCheckpointer, ref_shard.parse_shard)
    else:
        Session, Records, Journal, Wl, Bud, Table, Ck, parse = (
            TuningSession, TuningRecords, TrialJournal, Workload, Budget, PortTable,
            TuneCheckpointer, parse_shard)
    root.mkdir()
    wl = Wl("gemm", (512, 256, 1024), dtype="float32", label="w")
    out = {}
    for shard in (None, "0/2", "1/2"):
        tag = shard.replace("/", "of") if shard else "one"
        jpath = root / ("one.jsonl" if shard is None else "shared.jsonl")
        with Journal(str(jpath)) as journal:
            session = Session(Records(str(root / f"records-{tag}.json")), cost_factory=Table,
                              seed=11, verbose=False, journal=journal)
            out[tag] = session.tune_workload(
                wl, tuner, Bud(max_trials=40), n_workers=4, checkpointer=Ck(str(root / "ck")),
                shard=None if shard is None else parse(shard), shard_wait_s=0.3)
    files = {os.path.relpath(os.path.join(d, f), root): _read(os.path.join(d, f))
             for d, _, fs in os.walk(root) for f in fs}
    for name, raw in files.items():
        snap = json.loads(raw) if name.endswith("state.json") else {}
        if "result" in snap:  # a done snapshot carries the search's host wall time
            snap["result"]["wall_s"] = 0.0
            files[name] = json.dumps(snap).encode()
    return out, files


@pytest.mark.parametrize("tuner", ["random", "g-bfs"])
def test_sharded_sessions_match_the_reference_and_merge_to_the_single_best(
        tmp_path, frozen_clock, tuner):
    """Shards 0/2 then 1/2 over one journal, beside an unsharded run:
    every file either package writes (journals, records, done markers,
    shard-suffixed snapshots, whose done snapshots differ only in the
    host's wall seconds) is byte-identical, the shards measure
    disjoint sets, and for the random tuner's cost-independent proposal
    stream the merged record is the unsharded best."""
    ref, ref_files = _sharded_runs("ref", tmp_path / "ref", tuner)
    port, port_files = _sharded_runs("port", tmp_path / "port", tuner)
    assert port_files.keys() == ref_files.keys()
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    for tag in ref:
        assert [(t.state.key(), t.cost) for t in port[tag].trials] == [
            (t.state.key(), t.cost) for t in ref[tag].trials]
    assert any("shard0of2" in n for n in port_files) and any("shard1of2" in n for n in port_files)
    rows = [json.loads(line) for line in port_files["shared.jsonl"].splitlines()]
    owners = {}
    for r in rows:
        assert owners.setdefault(r["k"], r["shard"][0]) == r["shard"][0]  # disjoint
        assert shard_of(r["w"], r["k"], 2) == r["shard"][0]
    merged = json.loads(port_files["records-1of2.json"])
    (rec,) = merged.values()
    finite = [r["c"] for r in rows if r["c"] is not None]
    assert rec["cost"] == min(finite) and rec["n_shards"] == 2
    if tuner == "random":
        assert rec["cost"] == port["one"].best_cost


def test_unsharded_spec_is_the_plain_engine(tmp_path, frozen_clock):
    """0/1 normalizes away: it needs no journal, and with one it writes
    the unsharded engine's bytes."""
    wl = Workload("gemm", (512, 256, 1024), dtype="float32")
    res = TuningSession(TuningRecords(), cost_factory=PortTable, verbose=False).tune_workload(
        wl, "random", Budget(max_trials=10), shard=parse_shard("0/1"))
    assert res.n_trials == 10
    for name, shard in (("a", None), ("b", parse_shard("0/1"))):
        with TrialJournal(str(tmp_path / f"{name}.jsonl")) as j:
            TuningSession(TuningRecords(), cost_factory=PortTable, verbose=False,
                          journal=j).tune_workload(wl, "g-bfs", Budget(max_trials=20),
                                                   n_workers=2, shard=shard)
    assert _read(tmp_path / "a.jsonl") == _read(tmp_path / "b.jsonl")
    with pytest.raises(ValueError, match="shared journal"):
        TuningSession(TuningRecords(), cost_factory=PortTable, verbose=False).tune_workload(
            wl, "random", Budget(max_trials=4), shard=ShardSpec(0, 2))


# -- two concurrent CLI shards ------------------------------------------------------


def test_two_concurrent_cli_shards_split_one_journal(tmp_path):
    """``tune --shard 0/2`` and ``--shard 1/2`` run at once over one
    journal: their measured sets are disjoint, each workload gets one
    record, that record is the lowest cost in the union of their rows,
    and the port's audit finds the coverage whole."""
    from repro_torch.launch import analyze

    rec, jnl = tmp_path / "r.json", tmp_path / "shared.jsonl"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in [os.path.abspath(SRC), os.environ.get("PYTHONPATH", "")] if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.tune", "--arch", "yi-6b", "--device", "cpu",
         "--cost", "analytical", "--max-trials", "40", "--warm-start", "--workers", "4",
         "--records", str(rec), "--journal", str(jnl), "--shard", f"{i}/2",
         "--shard-wait", "60", "--checkpoint-dir", "none"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    rows = [json.loads(line) for line in open(jnl)]
    by_shard = [{(r["w"], r["k"]) for r in rows if r["shard"][0] == i} for i in range(2)]
    assert by_shard[0] and by_shard[1] and not by_shard[0] & by_shard[1]
    records = json.loads(rec.read_text())
    assert len(records) == 5
    for key, r in records.items():
        finite = [row["c"] for row in rows
                  if row["w"].split("?")[0] == key and row["c"] is not None]
        assert r["cost"] == min(finite) and r["n_shards"] == 2
    assert analyze.main(["--records", str(rec), "--journal", str(jnl), "--strict"]) == 0
