"""Journal-to-corpus assembly for the learned cost model.

A :class:`TrialJournal` file already holds exactly the training set a
rank-based cost model needs: every measured row carries the state's
factor lists (features via ``space.features``), the measured cost, and a
journal key that scopes it to op / dims / dtype / backend / measurement
fingerprint.  :func:`build_dataset` turns one or more journal files into
a :class:`JournalDataset` — an op/dtype/fingerprint-scoped
``(features, log-cost, group)`` corpus where the *group* is the full
journal key (workload shape + measurement settings), i.e. the unit the
pairwise rank loss compares within.  Grouping is what makes the corpus
cross-shape: rows from a 512^3 and a 4096x256 GEMM train one model
without normalizing their incommensurable absolute runtimes.

Excluded from training, but counted for observability (the analyze CLI
prints these per op/dtype so users can tell when a workload has enough
data to train on):

* fail rows (``c=null, fail=true``) — permanent or transient, neither
  carries a runtime to rank against;
* static audit rows (``"static"``) — pruned, never measured;
* predicted rows (``"pred"``) — the learned filter's own skip
  provenance; training on them would be feedback, not data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from ..records import iter_journal_rows, parse_workload_key_generic
from ..space import state_from_lists

__all__ = ["CorpusCounts", "JournalDataset", "build_dataset", "scan_corpus"]


@dataclasses.dataclass
class CorpusCounts:
    """Row census of one corpus scope (or one op/dtype in a scan)."""

    n_trainable: int = 0  # finite measured rows that entered the corpus
    n_fail: int = 0  # failure rows (permanent + transient)
    n_static: int = 0  # analyzer audit rows
    n_predicted: int = 0  # learned-filter skip provenance rows
    n_duplicate: int = 0  # repeat (workload, state) measurements
    n_foreign: int = 0  # out of scope: other op/dtype/fingerprint, malformed
    n_incompatible: int = 0  # in scope but feature width differs (depths)

    @property
    def n_rows(self) -> int:
        return (
            self.n_trainable + self.n_fail + self.n_static + self.n_predicted
            + self.n_duplicate + self.n_foreign + self.n_incompatible
        )


def _row_category(row: dict) -> str:
    """Schema triage shared with the audit CLI: measured / fail /
    static / pred.  Order matters — ``static`` and ``pred`` rows also
    have ``c=null`` and must not read as failures."""
    if "static" in row:
        return "static"
    if "pred" in row:
        return "pred"
    if row.get("fail") or row.get("c") is None:
        return "fail"
    return "measured"


@dataclasses.dataclass
class JournalDataset:
    """One training corpus: features, log-costs, and rank groups.

    ``groups[i]`` indexes ``group_keys`` — the full journal key
    (``workload?fingerprint``) row ``i`` was measured under.  The rank
    objective only compares rows within one group."""

    op: str
    dtype: Optional[str]
    fingerprint: Optional[str]
    n_features: int
    X: np.ndarray  # (n, n_features) float32
    y: np.ndarray  # (n,) float64 — log cost
    groups: np.ndarray  # (n,) intp
    group_keys: list[str]
    counts: CorpusCounts

    def __len__(self) -> int:
        return len(self.y)

    @property
    def n_groups(self) -> int:
        return len(self.group_keys)

    def subset(self, mask: np.ndarray) -> "JournalDataset":
        """Row-masked view (group ids are preserved, not renumbered) —
        the held-out-shape split the eval CLI uses."""
        mask = np.asarray(mask, dtype=bool)
        return dataclasses.replace(
            self, X=self.X[mask], y=self.y[mask], groups=self.groups[mask]
        )

    def split_group(self, group: int) -> tuple["JournalDataset", "JournalDataset"]:
        """(train, held-out) leave-one-shape-out split."""
        held = self.groups == group
        return self.subset(~held), self.subset(held)


def _space_for(op: str, dims: tuple[int, ...], depths: tuple[int, ...], cache: dict):
    key = (op, dims, depths)
    sp = cache.get(key)
    if sp is None:
        from ..ops import get_op  # lazy: ops imports cost modules

        sp = get_op(op).make_space(dims, depths)
        cache[key] = sp
    return sp


def build_dataset(
    paths: Sequence[str] | str,
    op: str,
    dtype: Optional[str] = None,
    fingerprint: Optional[str] = None,
) -> JournalDataset:
    """Assemble the ``(features, log-cost, group)`` corpus for one op
    (optionally narrowed to one dtype and one measurement fingerprint)
    from one or more journal files.  Rows outside the scope, duplicate
    measurements, and provenance-only rows are excluded but censused in
    ``counts``."""
    if isinstance(paths, str):
        paths = [paths]
    counts = CorpusCounts()
    feats: list[np.ndarray] = []
    ys: list[float] = []
    gids: list[int] = []
    group_ids: dict[str, int] = {}
    group_keys: list[str] = []
    seen: set[tuple[str, str]] = set()
    space_cache: dict = {}
    n_features: Optional[int] = None
    for path in paths:
        for row in iter_journal_rows(path):
            try:
                jkey, skey, lists = row["w"], row["k"], row["s"]
            except KeyError:
                counts.n_foreign += 1
                continue
            wkey, _, fp = jkey.partition("?")
            parsed = parse_workload_key_generic(wkey)
            if parsed is None:
                counts.n_foreign += 1
                continue
            row_op, dims, row_dtype, _backend = parsed
            if (
                row_op != op
                or row.get("op", "gemm") != op
                or (dtype is not None and row_dtype != dtype)
                or (fingerprint is not None and fp != fingerprint)
            ):
                counts.n_foreign += 1
                continue
            cat = _row_category(row)
            if cat != "measured":
                counts.n_fail += int(cat == "fail")
                counts.n_static += int(cat == "static")
                counts.n_predicted += int(cat == "pred")
                continue
            if (jkey, skey) in seen:
                counts.n_duplicate += 1
                continue
            try:
                c = float(row["c"])
                depths = tuple(len(r) for r in lists)
                sp = _space_for(op, dims, depths, space_cache)
                if n_features is None:
                    n_features = sp.n_features
                elif sp.n_features != n_features:
                    # a different nesting depth means a different feature
                    # width — one model can't consume both
                    counts.n_incompatible += 1
                    continue
                x = sp.features(state_from_lists(op, lists))
            except (KeyError, ValueError, TypeError):
                counts.n_foreign += 1
                continue
            if not (math.isfinite(c) and c > 0.0 and np.isfinite(x).all()):
                counts.n_foreign += 1
                continue
            seen.add((jkey, skey))
            gid = group_ids.setdefault(jkey, len(group_keys))
            if gid == len(group_keys):
                group_keys.append(jkey)
            feats.append(x)
            ys.append(math.log(c))
            gids.append(gid)
            counts.n_trainable += 1
    nf = n_features if n_features is not None else 0
    return JournalDataset(
        op=op,
        dtype=dtype,
        fingerprint=fingerprint,
        n_features=nf,
        X=(np.stack(feats).astype(np.float32) if feats
           else np.empty((0, nf), np.float32)),
        y=np.asarray(ys, dtype=np.float64),
        groups=np.asarray(gids, dtype=np.intp),
        group_keys=group_keys,
        counts=counts,
    )


def scan_corpus(paths: Sequence[str] | str) -> dict[tuple[str, str], CorpusCounts]:
    """Per-(op, dtype) row census across journal files — the analyze
    CLI's corpus-size report (no features computed, just triage)."""
    if isinstance(paths, str):
        paths = [paths]
    out: dict[tuple[str, str], CorpusCounts] = {}
    for path in paths:
        for row in iter_journal_rows(path):
            wkey = str(row.get("w", "")).partition("?")[0]
            parsed = parse_workload_key_generic(wkey)
            if parsed is None:
                continue
            _row_op, _dims, row_dtype, _backend = parsed
            op = row.get("op", "gemm")
            counts = out.setdefault((op, row_dtype), CorpusCounts())
            cat = _row_category(row)
            if cat == "measured":
                counts.n_trainable += 1
            elif cat == "fail":
                counts.n_fail += 1
            elif cat == "static":
                counts.n_static += 1
            else:
                counts.n_predicted += 1
    return out
