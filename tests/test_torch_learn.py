"""The learned cost model of the port (``repro_torch.core.learn``) against
the JAX package's (``repro.core.learn``): the journal corpus, the
pairwise rank model and its cache file, the proposal filter's decisions
and ``pred`` provenance rows, the snapshot's ``filter`` key, a whole
``--learned-filter on`` search, and the ``learn`` CLI."""

import glob
import itertools
import json
import math
import os
import shutil

import numpy as np
import pytest

from repro.core import MeasureEngine as RefEngine
from repro.core import TrialJournal as RefJournal
from repro.core import TuneCheckpointer as RefCheckpointer
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core import learn as ref_learn
from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.cost.analytical import AnalyticalTPUCost
from repro.core.records import workload_key_for as ref_key
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro_torch.core import (
    AnalyticalHopperCost,
    Budget,
    CountingCost,
    GemmConfigSpace,
    MeasureEngine,
    TrialJournal,
    TuneCheckpointer,
    TuningRecords,
    TuningSession,
    Workload,
)
from repro_torch.core.learn import (
    ProposalFilter,
    RankingCostModel,
    build_dataset,
    learn_cache_dir_for,
    scan_corpus,
    spearman_rank_corr,
    top_k_recall,
)
from test_torch_tuning import PortTable, RefTable, _read, frozen_clock  # noqa: F401

SHAPES = [(64, 64, 64), (32, 64, 32), (64, 32, 64)]


def _fill_journal(jpath, shapes, n_states=48):
    """Measure the first legitimate states of each shape into one journal
    with the JAX package's noise-free analytical model — a store both
    packages read."""
    for m, k, n in shapes:
        space = RefSpace(m, k, n)
        cost = AnalyticalTPUCost(space)
        with RefJournal(jpath) as j:
            eng = RefEngine(cost, n_workers=8, journal=j,
                            workload_key=ref_key("gemm", (m, k, n), "bfloat16", cost.name))
            states = list(itertools.islice(
                (s for s in space.enumerate() if space.is_legitimate(s)), n_states))
            for i in range(0, len(states), 8):
                eng.measure_wave(states[i : i + 8])
    return cost.measure_fingerprint()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A three-shape journal with every row kind: measured, failed,
    static, predicted and a raw duplicate."""
    jpath = str(tmp_path_factory.mktemp("corpus") / "j.jsonl")
    fp = _fill_journal(jpath, SHAPES)
    space = RefSpace(64, 64, 64)
    sts = list(itertools.islice(space.enumerate(), 400, 404))
    wkey = ref_key("gemm", (64, 64, 64), "bfloat16", "analytical_tpu_v5e") + "?" + fp
    with RefJournal(jpath) as j:
        j.record_static(wkey, sts[0], "degenerate", op="gemm")
        j.record_predicted(wkey, sts[1], 0.25, op="gemm")
        j.record(wkey, sts[2], math.inf, op="gemm")
        j.record(wkey, sts[3], 1.0, op="gemm")
    with open(jpath, "a") as f:
        f.write(json.dumps({"w": wkey, "k": sts[3].key(), "s": sts[3].as_lists(),
                            "op": "gemm", "c": 2.0}) + "\n")
    return jpath, fp


# -- the corpus ---------------------------------------------------------------------


@pytest.mark.parametrize("scope", [{}, {"dtype": "bfloat16"}, {"dtype": "float32"},
                                   {"fingerprint": "nope"}, {"op": "flash"}])
def test_build_dataset_matches_the_reference(corpus, scope):
    jpath, _ = corpus
    kw = dict(scope)
    op = kw.pop("op", "gemm")
    ds, ref = build_dataset([jpath], op, **kw), ref_learn.build_dataset([jpath], op, **kw)
    for name in ("X", "y", "groups"):
        a, b = getattr(ds, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ds.group_keys == ref.group_keys
    assert ds.counts == ds.counts.__class__(**vars(ref.counts))
    census, ref_census = scan_corpus([jpath]), ref_learn.scan_corpus([jpath])
    assert {k: vars(v) for k, v in census.items()} == {k: vars(v) for k, v in ref_census.items()}


def test_corpus_triage(corpus):
    ds = build_dataset([corpus[0]], "gemm")
    c = ds.counts
    assert c.n_trainable == len(ds) == 3 * 48 + 1
    assert (c.n_static, c.n_predicted, c.n_fail, c.n_duplicate) == (1, 1, 1, 1)
    assert ds.n_groups == 3
    train, held = ds.split_group(0)
    assert len(train) + len(held) == len(ds)


# -- the rank model -----------------------------------------------------------------


def test_ranking_model_matches_the_reference(corpus, tmp_path):
    jpath, _ = corpus
    ds, ref_ds = build_dataset([jpath], "gemm"), ref_learn.build_dataset([jpath], "gemm")
    train, held = ds.split_group(2)
    ref_train, ref_held = ref_ds.split_group(2)
    model = RankingCostModel.fit_dataset(train)
    ref = ref_learn.RankingCostModel.fit_dataset(ref_train)
    pred, ref_pred = model.predict(held.X), ref.predict(ref_held.X)
    assert np.array_equal(pred, ref_pred)
    assert model.evaluate(held) == ref.evaluate(ref_held)
    assert spearman_rank_corr(held.y, pred, held.groups) == ref_learn.spearman_rank_corr(
        ref_held.y, ref_pred, ref_held.groups) > 0.5
    assert top_k_recall(held.y, pred, 8, held.groups) == ref_learn.top_k_recall(
        ref_held.y, ref_pred, 8, ref_held.groups)
    # the cache file: same name, same bytes, read back by either package
    paths = [m.save(str(tmp_path / pkg)) for m, pkg in ((model, "port"), (ref, "ref"))]
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert _read(paths[0]) == _read(paths[1])
    hit = RankingCostModel.load_for(str(tmp_path / "ref"), "gemm", train.dtype,
                                    train.fingerprint, train.n_features)
    assert hit is not None and np.array_equal(hit.predict(held.X), pred)
    with open(paths[0], "w") as f:
        f.write("{not json")
    assert RankingCostModel.load(paths[0]) is None


# -- the proposal filter --------------------------------------------------------------


def test_filter_decisions_and_pred_rows_match_the_reference(corpus, tmp_path):
    """Fresh copies of one corpus, one filtered wave each: the same
    kept/skipped split, scores, counters and journal bytes."""
    out = {}
    for pkg in ("ref", "port"):
        jpath = str(tmp_path / f"{pkg}.jsonl")
        shutil.copy(corpus[0], jpath)
        fp = corpus[1]
        if pkg == "ref":
            space, j = RefSpace(64, 64, 64), RefJournal(jpath)
            flt = ref_learn.ProposalFilter(space, j, fingerprint=fp, keep=0.5, min_rows=16)
            cost, Engine = RefTable(space), RefEngine
        else:
            space, j = GemmConfigSpace(64, 64, 64), TrialJournal(jpath)
            flt = ProposalFilter(space, j, fingerprint=fp, keep=0.5, min_rows=16)
            cost, Engine = PortTable(space), MeasureEngine
        wkey = ref_key("gemm", (64, 64, 64), "bfloat16", "table")
        try:
            assert flt.maybe_retrain() and flt.active
            states = list(itertools.islice(space.enumerate(), 200, 208))
            kept, skipped = flt.select(states)
            eng = Engine(cost, n_workers=8, journal=j, workload_key=wkey,
                         learned_filter=flt)
            outs = eng.measure_wave(list(itertools.islice(space.enumerate(), 300, 308)))
        finally:
            j.close()
        pred_rows = [line for line in _read(jpath).splitlines()[-8:] if b'"pred"' in line]
        out[pkg] = (kept, skipped, flt.state_dict(),
                    [(o.state.key(), o.predicted) for o in outs],
                    eng.stats.trials_avoided_learned, pred_rows)
    assert out["port"] == out["ref"]
    assert len(out["port"][1]) == 4 and len(out["port"][5]) == 4


def test_filter_passes_through_until_trained_and_prewarms(corpus, tmp_path):
    space = GemmConfigSpace(64, 64, 64)
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="keep"):
            ProposalFilter(space, None, keep=bad)
    jpath = str(tmp_path / "j.jsonl")
    shutil.copy(corpus[0], jpath)
    with TrialJournal(jpath) as j:
        idle = ProposalFilter(space, j, min_rows=10_000)
        states = list(itertools.islice(space.enumerate(), 8))
        assert not idle.maybe_retrain() and idle.select(states) == (list(range(8)), [])
        ProposalFilter(space, j, fingerprint=corpus[1], min_rows=16).maybe_retrain()
    with TrialJournal(jpath) as j:  # a later session's filter is fitted before its first wave
        flt = ProposalFilter(space, j, fingerprint=corpus[1], min_rows=16)
        assert flt.active and flt.n_retrains == 0
        assert flt.cache_dir == learn_cache_dir_for(jpath)


def test_pred_rows_are_never_cache_hits(corpus, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    shutil.copy(corpus[0], jpath)
    space = GemmConfigSpace(64, 64, 64)
    wkey = ref_key("gemm", (64, 64, 64), "bfloat16", "analytical_tpu_v5e")
    states = list(itertools.islice(space.enumerate(), 300, 308))
    with TrialJournal(jpath) as j:
        flt = ProposalFilter(space, j, fingerprint=corpus[1], keep=0.5, min_rows=16)
        outs = MeasureEngine(CountingCost(AnalyticalHopperCost(space)), n_workers=8,
                             journal=j, workload_key=wkey, learned_filter=flt).measure_wave(states)
    skipped = {o.state.key() for o in outs if o.predicted is not None}
    assert len(skipped) == 4
    with TrialJournal(jpath) as j2:
        cc = CountingCost(AnalyticalHopperCost(space))
        eng = MeasureEngine(cc, n_workers=8, journal=j2, workload_key=wkey)
        again = eng.measure_wave(states)
    assert cc.n_measured == 4 and eng.stats.n_cache_hits == 4
    assert all(not o.cache_hit for o in again if o.state.key() in skipped)


# -- a whole filtered search, and its snapshot -----------------------------------------


def test_learned_filter_search_matches_the_reference(tmp_path, frozen_clock):
    """``--learned-filter on`` through the session, seeded from a corpus of
    earlier searches: the trial sequence, journal, records and every
    snapshot (whose ``filter`` key carries the filter's cadence) are the
    reference's."""
    out = {}
    for pkg, Session, Records, Journal, Wl, Bud, Table, Ck in (
        ("ref", RefSession, RefRecords, RefJournal, RefWorkload, RefBudget, RefTable,
         RefCheckpointer),
        ("port", TuningSession, TuningRecords, TrialJournal, Workload, Budget, PortTable,
         TuneCheckpointer),
    ):
        root = tmp_path / pkg
        root.mkdir()
        with Journal(str(root / "j.jsonl")) as journal:
            session = Session(Records(str(root / "r.json")), cost_factory=Table, seed=5,
                              verbose=False, journal=journal)
            for dims in ((512, 256, 512), (256, 512, 256)):
                session.tune_workload(Wl("gemm", dims, dtype="float32"), "random",
                                      Bud(max_trials=40), n_workers=4)
            res = session.tune_workload(
                Wl("gemm", (512, 256, 1024), dtype="float32"), "g-bfs", Bud(max_trials=48),
                n_workers=4, learned_filter="on", filter_keep=0.5, filter_retrain_every=2,
                filter_min_rows=16, checkpointer=Ck(str(root / "ck"), every_rounds=1))
        snaps = {}
        for path in sorted(glob.glob(str(root / "ck" / "*" / "*" / "state.json"))):
            snap = json.loads(_read(path))
            if "result" in snap:
                snap["result"]["wall_s"] = 0.0
            snaps[os.path.relpath(path, root)] = snap
        out[pkg] = ([(t.state.key(), t.cost, t.clock_s) for t in res.trials],
                    _read(root / "j.jsonl"), _read(root / "r.json"), snaps,
                    res.n_trials)
    assert out["port"] == out["ref"]
    journal_rows = out["port"][1].decode()
    assert '"pred"' in journal_rows  # the filter did skip candidates
    assert any("filter" in s.get("ctx", {}) for s in out["port"][3].values())


def test_measured_fingerprint_is_one_for_every_shape(monkeypatch):
    """The measured cost's fingerprint names its settings (seed, card,
    software, kernel source) and not the shapes, which the workload key
    and the space's kwargs name: every GEMM shape's rows share one
    fingerprint, so the filter's model trains across shapes, as it does
    in the JAX package."""
    import torch

    from repro_torch.core import FlashAttnConfigSpace, get_op
    from repro_torch.core.cost import measured

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")
    prints = []
    for op, space in (("gemm", GemmConfigSpace(8192, 4096, 6144)),
                      ("gemm", GemmConfigSpace(8, 4096, 11008)),
                      ("flash", FlashAttnConfigSpace(4096, 4096, 128, heads=32, kv_heads=4)),
                      ("flash", FlashAttnConfigSpace(4096, 4096, 128))):
        backend = object.__new__(measured.HopperTimedCost)
        backend.space, backend.n_repeats, backend.dtype, backend.seed = space, 3, "bfloat16", 0
        backend.device, backend._opspec = torch.device("cuda"), get_op(op)
        prints.append(backend.measure_fingerprint())
    assert prints[0] == prints[1] and "8192" not in prints[0]
    assert prints[2] != prints[3] and prints[2].endswith("heads=32,kv_heads=4")


def test_session_rejects_bad_filter_mode():
    session = TuningSession(TuningRecords(), cost_factory=PortTable, verbose=False)
    with pytest.raises(ValueError, match="learned.filter"):
        session.tune_workload(Workload("gemm", (64, 64, 64)), "random",
                              Budget(max_trials=2), learned_filter="sometimes")


# -- the learn CLI ------------------------------------------------------------------


def test_learn_cli_train_then_eval(tmp_path, capsys):
    """Train on the port's own journal (the H100 model's rows), then
    evaluate held-out shapes; the gate fails an unreachable correlation."""
    from repro_torch.launch import learn, tune

    rec = str(tmp_path / "r.json")
    tune.main(["--arch", "yi-6b", "--device", "cpu", "--cost", "analytical", "--noise", "0",
               "--max-trials", "60", "--warm-start", "--analyze", "prune", "--records", rec])
    jpath = rec + ".journal.jsonl"
    assert learn.main(["train", "--journal", jpath, "--dtype", "bfloat16"]) == 0
    assert "saved model to" in capsys.readouterr().out
    assert glob.glob(learn_cache_dir_for(jpath) + "/rankmodel-*.json")
    assert learn.main(["eval", "--journal", jpath, "--min-corr", "-1.0"]) == 0
    assert "held_out_rank_corr=" in capsys.readouterr().out
    assert learn.main(["eval", "--journal", jpath, "--min-corr", "1.0"]) == 1
