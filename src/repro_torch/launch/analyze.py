"""Audit persistent tuning stores with the static schedule analyzer, on
the Hopper kernels' rules.

``python -m repro_torch.launch.analyze`` re-derives a verdict (see
``repro_torch.core.analysis``) for every record in a
:class:`TuningRecords` JSON and every row of a :class:`TrialJournal`,
and exits nonzero when anything is provably broken — the tripwire
against shipping stale or corrupted schedule stores.  The JAX package's
``repro.launch.analyze`` judges states on the TPU's rules and so
misjudges this package's stores; audit them with this one.  Errors:

* a record whose state is ILLEGAL for its own workload key and dtype — a
  factor product that no longer matches the dims (a stale record for
  another shape), a corrupted state list, or a tile the kernel cannot
  launch;
* a record filed under an unparseable key, or whose ``op`` field
  disagrees with its key's op (cross-op contamination);
* a journal row carrying a *finite* measured cost for a schedule the
  analyzer proves ILLEGAL — every backend scores those ``inf`` (the
  measured and analytical costs consult the same analyzer), so a finite
  cost means the store and the models disagree about reality.

WASTEFUL verdicts and unparseable *journal* keys are warnings: dominated
schedules are legal to serve, and a journal is an append-only log that
may carry foreign experiments.  ``--strict`` promotes warnings to the
exit code.  Journal ``static`` rows (the engine's pruned-candidate audit
trail) and ``pred`` rows (the learned filter's skip provenance, see
``repro_torch.core.learn``) are counted and reported, never flagged — except a
``pred`` row claiming a finite measured cost, which is an error: a
prediction masquerading as a measurement.

The audit also reports the learned-model training corpus per op/dtype
(``[analyze] learn-corpus:`` lines — trainable measured rows vs
fail/static/predicted provenance rows), so users can tell when a
workload has accumulated enough data to train on.

Sharded searches (``tune --shard I/N``, see ``repro_torch.core.shard``) leave
``"shard": [i, n]`` tags on their journal rows and done markers next to
the journal; the audit recomputes each tagged row's owner (a claimed
shard that doesn't own the candidate is an error), errors on candidates
measured by two shards, and warns on owner gaps — shards that never
wrote their done marker.  The ``[analyze] shard-coverage:`` line is the
machine-greppable summary.

A record is judged on the space it was tuned in: flash records carry
their head layout (``space_kwargs``), which the under-fill rule reads.

Usage::

  python -m repro_torch.launch.analyze                       # records/*.json + journals
  python -m repro_torch.launch.analyze --records r.json      # one store
  python -m repro_torch.launch.analyze --journal j.jsonl     # one journal
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import math
import os
import sys
from typing import Callable, Optional

from repro_torch.core.analysis import ScheduleAnalyzer, dtype_in_bytes
from repro_torch.core.fault import PERMANENT_KINDS, TRANSIENT_KINDS
from repro_torch.core.learn import scan_corpus
from repro_torch.core.ops import get_op
from repro_torch.core.records import (
    TrialJournal,
    iter_journal_rows,
    parse_workload_key_generic,
)
from repro_torch.core.shard import read_done_markers, shard_dir_for, shard_of
from repro_torch.core.space import state_from_lists


def _hopper_analyzer(space, in_bytes: int) -> ScheduleAnalyzer:
    return ScheduleAnalyzer(space, in_bytes=in_bytes)


class _Auditor:
    """Shared error/warning sink + per-workload analyzer cache.

    ``make_analyzer(space, in_bytes)`` builds the analyzer a workload is
    judged by: by default this package's, on the H100's spec.  A test may
    hand in another (the JAX package's, on its ``TpuSpec``) to hold the
    audit's row triage and counters against that package's CLI."""

    def __init__(self, make_analyzer: Optional[Callable] = None) -> None:
        self.make_analyzer = make_analyzer or _hopper_analyzer
        self.errors: list[str] = []
        self.warnings: list[str] = []
        self._analyzers: dict[tuple, Optional[ScheduleAnalyzer]] = {}
        # failure provenance (the journal's fail-row taxonomy)
        self.fail_kinds: collections.Counter = collections.Counter()
        self.n_retried_rows = 0  # fail rows that record >1 attempt
        self.n_permanent_legal = 0  # permanent failures on legal schedules
        self.n_predicted = 0  # learned-filter skip provenance rows
        # sharded-search coverage (rows tagged "shard": [i, n])
        self.n_shard_rows = 0
        self.shard_workloads: set[str] = set()
        self.n_shard_violations = 0  # row's claimed shard != recomputed owner
        self.n_cross_shard_dups = 0  # one candidate measured by two shards
        self.n_marker_gaps = 0  # done-marker sets missing a shard index
        self._shard_claims: dict[tuple[str, str], int] = {}

    def error(self, where: str, msg: str) -> None:
        self.errors.append(f"{where}: {msg}")
        print(f"[analyze] ERROR {where}: {msg}")

    def warn(self, where: str, msg: str) -> None:
        self.warnings.append(f"{where}: {msg}")
        print(f"[analyze] warning {where}: {msg}")

    def analyzer(self, op: str, dims: tuple, dtype: str, depths: tuple,
                 space_kwargs: Optional[dict] = None) -> Optional[ScheduleAnalyzer]:
        """Analyzer for one workload identity, or None when the op's
        space cannot even be built (reported by the caller)."""
        kw = dict(space_kwargs or {})
        key = (op, dims, dtype, depths, tuple(sorted(kw.items())))
        if key not in self._analyzers:
            try:
                space = get_op(op).make_space(dims, depths, **kw)
                self._analyzers[key] = self.make_analyzer(
                    space, dtype_in_bytes(dtype)
                )
            except Exception:
                self._analyzers[key] = None
        return self._analyzers[key]


def _depths_of(lists) -> tuple:
    return tuple(len(r) for r in lists)


def audit_records(path: str, auditor: _Auditor) -> int:
    """Audit one TuningRecords JSON; returns the number of records seen."""
    try:
        with open(path) as f:
            data = json.load(f)
        assert isinstance(data, dict)
    except Exception as e:
        auditor.error(path, f"unreadable records file ({type(e).__name__}: {e})")
        return 0
    n = 0
    for key, rec in sorted(data.items()):
        n += 1
        where = f"{path} :: {key}"
        parsed = parse_workload_key_generic(key)
        if parsed is None:
            auditor.error(where, "unparseable workload key")
            continue
        op, dims, dtype, _backend = parsed
        rec_op = rec.get("op") if isinstance(rec, dict) else None
        if rec_op is not None and rec_op != op:
            auditor.error(
                where, f"cross-op record: op field {rec_op!r} under a {op!r} key"
            )
            continue
        try:
            lists = rec["state"]
            st = state_from_lists(op, lists)
        except Exception as e:
            auditor.error(
                where, f"undeserializable state ({type(e).__name__}: {e})"
            )
            continue
        an = auditor.analyzer(op, dims, dtype, _depths_of(lists),
                              rec.get("space_kwargs"))
        if an is None:
            auditor.error(where, f"cannot build the {op!r} search space")
            continue
        res = an.analyze(st)
        if res.illegal:
            auditor.error(where, f"ILLEGAL record ({res.reason}): {res.detail}")
        elif res.wasteful:
            auditor.warn(where, f"WASTEFUL record ({res.reason}): {res.detail}")
    return n


def audit_journal(path: str, auditor: _Auditor) -> tuple[int, int]:
    """Audit one trial journal; returns (rows seen, static audit rows)."""
    n = n_static = 0
    shard_counts: dict[str, int] = {}  # journal key -> shard count seen
    for row in iter_journal_rows(path):
        n += 1
        try:
            full_key = row["w"]
            base_key = full_key.split("?", 1)[0]
            state_key = row["k"]
        except (KeyError, AttributeError, TypeError):
            auditor.warn(path, f"malformed row (no w/k): {str(row)[:80]}")
            continue
        where = f"{path} :: {base_key} :: {state_key}"
        # sharded-search coverage: a row tagged "shard": [i, n] must be
        # owned by shard i under the deterministic partition, and no
        # candidate may carry measurements from two different shards
        tag = row.get("shard")
        if tag is not None:
            try:
                si, sn = int(tag[0]), int(tag[1])
            except (TypeError, ValueError, IndexError, KeyError):
                auditor.warn(where, f"malformed shard tag {tag!r}")
            else:
                auditor.n_shard_rows += 1
                auditor.shard_workloads.add(full_key)
                shard_counts[full_key] = max(shard_counts.get(full_key, 0), sn)
                owner = shard_of(full_key, state_key, sn)
                if owner != si:
                    auditor.n_shard_violations += 1
                    auditor.error(
                        where,
                        f"shard-ownership violation: row claims shard "
                        f"{si}/{sn} but the partition owner is {owner}",
                    )
                claim = auditor._shard_claims.setdefault(
                    (full_key, state_key), si
                )
                if claim != si:
                    auditor.n_cross_shard_dups += 1
                    auditor.error(
                        where,
                        f"candidate measured by two shards "
                        f"({claim} and {si}) — the partition must be disjoint",
                    )
        parsed = parse_workload_key_generic(base_key)
        if parsed is None:
            # journals are append-only logs that may carry foreign
            # experiments; an alien key is suspicious, not fatal
            auditor.warn(where, "unparseable journal workload key")
            continue
        op, dims, dtype, _backend = parsed
        row_op = row.get("op", "gemm")
        if row_op != op:
            auditor.error(
                where, f"cross-op row: op field {row_op!r} under a {op!r} key"
            )
            continue
        if "static" in row:
            n_static += 1  # the engine's pruned-candidate audit trail
            continue
        if "pred" in row:
            # learned-filter skip provenance: the model's rank score for
            # a candidate that never reached a lane.  Counted, never
            # audited as a measurement — but a finite "c" here means a
            # prediction is posing as a measured cost, which downstream
            # loaders would cache
            auditor.n_predicted += 1
            if row.get("c") is not None:
                auditor.error(
                    where,
                    "predicted row carries a measured cost "
                    f"(c={row.get('c')!r}) — predictions must be "
                    "provenance-only",
                )
            continue
        # failure provenance: every fail row carries a taxonomy kind
        # (legacy rows without one are the historical failed-build inf)
        fail_kind = None
        if row.get("fail") or row.get("c") is None:
            fail_kind = row.get("kind", "build")
            auditor.fail_kinds[fail_kind] += 1
            if int(row.get("attempts", 1)) > 1:
                auditor.n_retried_rows += 1
            if fail_kind in TRANSIENT_KINDS:
                # provenance-only rows: the lane died, not the schedule —
                # nothing about the state to audit
                continue
            if fail_kind not in PERMANENT_KINDS:
                auditor.warn(where, f"unknown failure kind {fail_kind!r}")
                continue
        try:
            lists = row["s"]
            st = state_from_lists(op, lists)
        except Exception as e:
            auditor.warn(
                where, f"undeserializable state ({type(e).__name__}: {e})"
            )
            continue
        an = auditor.analyzer(op, dims, dtype, _depths_of(lists))
        if an is None:
            auditor.warn(where, f"cannot build the {op!r} search space")
            continue
        res = an.analyze(st)
        if res.illegal and math.isfinite(TrialJournal._row_cost(row)):
            auditor.error(
                where,
                f"finite measured cost for an ILLEGAL schedule "
                f"({res.reason}): {res.detail}",
            )
        if fail_kind in PERMANENT_KINDS and not res.illegal:
            # a cacheable failure for a schedule the analyzer finds legal:
            # either the backend is flakier than the taxonomy thinks (a
            # transient miscast as permanent — it will never be retried)
            # or the static model disagrees with the backend about
            # feasibility; both deserve eyes
            auditor.n_permanent_legal += 1
            auditor.warn(
                where,
                f"permanent-failure row ({fail_kind}) cached for a schedule "
                f"the analyzer finds legal",
            )
    # done-marker coverage: every workload with sharded rows should have
    # all n shard markers once the searches finish — a gap means a shard
    # never completed (or timed out before electing), so its owned slice
    # of the space went unexplored
    root = shard_dir_for(path)
    if shard_counts and os.path.isdir(root):
        for jkey, sn in sorted(shard_counts.items()):
            markers = read_done_markers(root, jkey, sn)
            missing = sorted(set(range(sn)) - set(markers))
            if missing:
                auditor.n_marker_gaps += 1
                auditor.warn(
                    f"{path} :: {jkey}",
                    f"owner gap: shard(s) {missing} of {sn} never wrote a "
                    f"done marker — their owned candidates are unexplored",
                )
    return n, n_static


def main(argv=None, make_analyzer: Optional[Callable] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.analyze",
        description="Audit tuning records and trial journals with the "
                    "static schedule analyzer on the Hopper kernels' "
                    "rules; exits nonzero on provably broken entries.",
    )
    ap.add_argument("--records", action="append", default=None,
                    help="TuningRecords JSON to audit (repeatable; default: "
                         "records/*.json)")
    ap.add_argument("--journal", action="append", default=None,
                    help="trial-journal JSONL to audit (repeatable; default: "
                         "the <records>.journal.jsonl next to each records "
                         "file, when present)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings (WASTEFUL records, alien journal rows) "
                         "also fail the exit code")
    args = ap.parse_args(argv)

    records = args.records
    journals = args.journal
    if records is None and journals is None:
        records = sorted(glob.glob("records/*.json"))
        journals = [
            p + ".journal.jsonl"
            for p in records
            if os.path.exists(p + ".journal.jsonl")
        ]
    records = records or []
    journals = journals or []
    if not records and not journals:
        print("[analyze] nothing to audit (no records/*.json here; "
              "pass --records/--journal)")
        return 0

    auditor = _Auditor(make_analyzer)
    n_rec = sum(audit_records(p, auditor) for p in records)
    n_rows = n_static = 0
    for p in journals:
        rows, static = audit_journal(p, auditor)
        n_rows += rows
        n_static += static
    print(
        f"[analyze] audited {n_rec} records in {len(records)} file(s), "
        f"{n_rows} journal rows ({n_static} static audit rows, "
        f"{auditor.n_predicted} predicted rows) in "
        f"{len(journals)} file(s): {len(auditor.errors)} error(s), "
        f"{len(auditor.warnings)} warning(s)"
    )
    # learned-model corpus census: trainable measured rows vs provenance
    # rows, per op/dtype — "do I have enough data to train on yet?"
    if journals:
        for (op, dtype), c in sorted(scan_corpus(journals).items()):
            print(
                f"[analyze] learn-corpus: op={op} dtype={dtype} "
                f"trainable={c.n_trainable} fail={c.n_fail} "
                f"static={c.n_static} predicted={c.n_predicted}"
            )
    # machine-greppable failure-provenance summary
    kinds = " ".join(
        f"{k}={auditor.fail_kinds[k]}" for k in sorted(auditor.fail_kinds)
    )
    print(
        f"[analyze] failure-provenance: {kinds or 'none'} "
        f"retried_rows={auditor.n_retried_rows} "
        f"permanent_for_legal={auditor.n_permanent_legal}"
    )
    # machine-greppable sharded-search coverage summary
    print(
        f"[analyze] shard-coverage: sharded_rows={auditor.n_shard_rows} "
        f"workloads={len(auditor.shard_workloads)} "
        f"violations={auditor.n_shard_violations} "
        f"cross_shard_dups={auditor.n_cross_shard_dups} "
        f"marker_gaps={auditor.n_marker_gaps}"
    )
    if auditor.errors or (args.strict and auditor.warnings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
