"""Train and evaluate learned cost models from trial journals.

``python -m repro_torch.launch.learn train`` assembles the op/dtype-scoped
corpus from one or more journal files (``repro_torch.core.learn.build_dataset``
— cross-shape: each workload's rows form one rank group), fits a
:class:`~repro_torch.core.learn.RankingCostModel`, and persists it
content-keyed into the journal's ``.learncache`` directory — the same
cache the tune CLI's ``--learned-filter`` consults, so an offline
training run pre-warms the filter for every later search.

``python -m repro_torch.launch.learn eval`` measures what actually matters
for transfer: **held-out-shape** rank quality.  Each workload group is
held out in turn, the model is refit on the remaining shapes, and the
held-out group's Spearman rank correlation and top-k recall are
reported (with ``--min-corr`` as a CI exit gate: a model that cannot
rank a shape it never saw is not safe to filter with).

Usage::

  python -m repro_torch.launch.learn train --journal j.jsonl --op gemm
  python -m repro_torch.launch.learn eval  --journal j.jsonl --op gemm --min-corr 0.0
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from repro_torch.core.learn import (
    RankingCostModel,
    build_dataset,
    learn_cache_dir_for,
    spearman_rank_corr,
    top_k_recall,
)


def _add_scope_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--journal", action="append", required=True,
                    help="trial-journal JSONL to read (repeatable)")
    ap.add_argument("--op", default="gemm",
                    help="operator whose rows form the corpus")
    ap.add_argument("--dtype", default=None,
                    help="narrow the corpus to one dtype (default: all)")
    ap.add_argument("--fingerprint", default=None,
                    help="narrow to one measurement fingerprint "
                         "(default: all — fine for eval; training for a "
                         "specific filter should match its backend)")
    ap.add_argument("--n-trees", type=int, default=60)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.2)


def _print_corpus(ds) -> None:
    c = ds.counts
    print(
        f"[learn] corpus: op={ds.op} dtype={ds.dtype or 'any'} "
        f"rows={c.n_trainable} groups={ds.n_groups} "
        f"features={ds.n_features} (excluded: fail={c.n_fail} "
        f"static={c.n_static} predicted={c.n_predicted} "
        f"dup={c.n_duplicate} foreign={c.n_foreign} "
        f"incompatible={c.n_incompatible})"
    )


def _hyper(args) -> dict:
    return {"n_trees": args.n_trees, "depth": args.depth, "lr": args.lr}


def cmd_train(args) -> int:
    ds = build_dataset(args.journal, args.op, dtype=args.dtype,
                       fingerprint=args.fingerprint)
    _print_corpus(ds)
    if len(ds) < 2:
        print("[learn] corpus too small to train on")
        return 1
    model = RankingCostModel.fit_dataset(ds, **_hyper(args))
    metrics = model.evaluate(ds, k=args.k)
    print(
        f"[learn] trained: trees={len(model.booster.trees)} "
        f"in-sample rank_corr={metrics['rank_corr']:.3f} "
        f"top{args.k}_recall={metrics['top_k_recall']:.3f}"
    )
    cache_dir = args.cache_dir or learn_cache_dir_for(args.journal[0])
    path = model.save(cache_dir)
    print(f"[learn] saved model to {path} (content key {model.content_key()})")
    return 0


def cmd_eval(args) -> int:
    ds = build_dataset(args.journal, args.op, dtype=args.dtype,
                       fingerprint=args.fingerprint)
    _print_corpus(ds)
    if len(ds) < 4:
        print("[learn] corpus too small to evaluate")
        return 1
    corrs, recalls = [], []
    groups = np.unique(ds.groups)
    if len(groups) >= 2:
        # held-out-shape: refit without each workload, score its rows
        for g in groups:
            train, held = ds.split_group(int(g))
            if len(held) < 3 or len(train) < 2:
                continue
            model = RankingCostModel.fit_dataset(train, **_hyper(args))
            if not model.is_fitted:
                continue
            pred = model.predict(held.X)
            corr = spearman_rank_corr(held.y, pred, held.groups)
            recall = top_k_recall(held.y, pred, args.k, held.groups)
            key = ds.group_keys[int(g)]
            print(
                f"[learn] held-out {key}: rows={len(held)} "
                f"rank_corr={corr:.3f} top{args.k}_recall={recall:.3f}"
            )
            if math.isfinite(corr):
                corrs.append(corr)
            if math.isfinite(recall):
                recalls.append(recall)
    else:
        # one shape only: no transfer to measure — fall back to an
        # interleaved in-shape split so the gate still means something
        print("[learn] single-shape corpus: evaluating an in-shape "
              "even/odd split (no held-out shape available)")
        mask = np.arange(len(ds)) % 2 == 0
        train, held = ds.subset(mask), ds.subset(~mask)
        model = RankingCostModel.fit_dataset(train, **_hyper(args))
        pred = model.predict(held.X)
        corr = spearman_rank_corr(held.y, pred, held.groups)
        recall = top_k_recall(held.y, pred, args.k, held.groups)
        if math.isfinite(corr):
            corrs.append(corr)
        if math.isfinite(recall):
            recalls.append(recall)
    if not corrs:
        print("[learn] no group large enough to rank")
        return 1
    mean_corr = float(np.mean(corrs))
    mean_recall = float(np.mean(recalls)) if recalls else float("nan")
    print(
        f"[learn] eval: held_out_rank_corr={mean_corr:.3f} "
        f"held_out_top{args.k}_recall={mean_recall:.3f} "
        f"over {len(corrs)} split(s)"
    )
    if args.min_corr is not None and not mean_corr > args.min_corr:
        print(
            f"[learn] FAIL: held-out rank correlation {mean_corr:.3f} "
            f"not above the --min-corr gate {args.min_corr}"
        )
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.learn",
        description="Train / evaluate journal-backed learned cost models "
                    "(repro_torch.core.learn).",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="fit a rank model and persist it "
                                      "content-keyed next to the journal")
    _add_scope_args(tr)
    tr.add_argument("--k", type=int, default=8,
                    help="k for the top-k recall report")
    tr.add_argument("--cache-dir", default=None,
                    help="model cache directory (default: "
                         "<first journal>.learncache)")
    tr.set_defaults(fn=cmd_train)
    ev = sub.add_parser("eval", help="held-out-shape rank-correlation and "
                                     "top-k-recall report")
    _add_scope_args(ev)
    ev.add_argument("--k", type=int, default=8)
    ev.add_argument("--min-corr", type=float, default=None,
                    help="exit nonzero unless the mean held-out rank "
                         "correlation exceeds this (CI gate)")
    ev.set_defaults(fn=cmd_eval)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
