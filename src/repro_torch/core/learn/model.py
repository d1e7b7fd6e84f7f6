"""The learned cost model: a pairwise-rank GBT scoped to one
op/dtype/fingerprint, with versioned content-keyed persistence next to
the journal.

Models live in a ``<journal>.learncache/`` directory, one JSON file per
*content key* — a hash over the schema version, the model's scope
(op/dtype/fingerprint/feature width), and its hyper-parameters.  A
schema bump, a different measurement fingerprint, or different
hyper-parameters land in a different file, so a stale or foreign model
can never be loaded as this configuration's model; the corpus row count
is stored alongside, so the filter knows whether a cached model is
behind the journal it is filtering for.

Quality is reported the way the transfer literature does: Spearman rank
correlation (the model's job is ordering, not absolute prediction) and
top-k recall (does the predicted top fraction contain the truly best
candidates — exactly what the proposal filter relies on), both computed
per group (= per workload shape) and averaged.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np

from .dataset import JournalDataset
from .gbt import PairwiseRankGBT

__all__ = [
    "RankingCostModel",
    "learn_cache_dir_for",
    "spearman_rank_corr",
    "top_k_recall",
]

#: Bump on any change to the serialized layout or the feature contract —
#: old cache files simply stop matching their content key.
SCHEMA_VERSION = 1


def learn_cache_dir_for(journal_path: str) -> str:
    """Default location of the persistent learned-model cache: a
    directory next to the :class:`~repro_torch.core.records.TrialJournal`:
    the journal and every model trained from it travel together."""
    return journal_path + ".learncache"


def _ranks(v: np.ndarray) -> np.ndarray:
    """Double-argsort ranks (ties broken by position — both sides of
    the correlation get the same tie policy, which is all Spearman
    needs here)."""
    order = np.argsort(v, kind="stable")
    r = np.empty(len(v))
    r[order] = np.arange(len(v))
    return r


def spearman_rank_corr(
    y_true: np.ndarray, y_pred: np.ndarray, groups: Optional[np.ndarray] = None
) -> float:
    """Per-group Spearman correlation between true costs and predicted
    scores, averaged over groups with >= 3 rows.  NaN when no group is
    big enough to rank."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if groups is None:
        groups = np.zeros(len(y_true), dtype=np.intp)
    vals = []
    for g in np.unique(groups):
        idx = np.flatnonzero(groups == g)
        if len(idx) < 3:
            continue
        rt, rp = _ranks(y_true[idx]), _ranks(y_pred[idx])
        st, sp = rt.std(), rp.std()
        if st == 0.0 or sp == 0.0:
            continue
        vals.append(float(np.mean((rt - rt.mean()) * (rp - rp.mean())) / (st * sp)))
    return float(np.mean(vals)) if vals else float("nan")


def top_k_recall(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    k: int,
    groups: Optional[np.ndarray] = None,
) -> float:
    """Fraction of each group's true best-k found in its predicted
    best-k, averaged over groups with > k rows — the filter's success
    metric (a kept fraction only helps if the real winners are in it)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if groups is None:
        groups = np.zeros(len(y_true), dtype=np.intp)
    vals = []
    for g in np.unique(groups):
        idx = np.flatnonzero(groups == g)
        if len(idx) <= k:
            continue
        true_top = set(idx[np.argsort(y_true[idx], kind="stable")[:k]].tolist())
        pred_top = set(idx[np.argsort(y_pred[idx], kind="stable")[:k]].tolist())
        vals.append(len(true_top & pred_top) / k)
    return float(np.mean(vals)) if vals else float("nan")


class RankingCostModel:
    """A :class:`PairwiseRankGBT` plus the scope it is valid for.

    ``predict`` returns scores ascending with cost — only the order
    carries meaning.  A model only ever scores candidates whose
    op/dtype/fingerprint/feature-width match its training scope
    (:meth:`compatible_with` enforces this; the proposal filter and the
    eval CLI both go through it)."""

    def __init__(
        self,
        op: str,
        dtype: Optional[str],
        fingerprint: Optional[str],
        n_features: int,
        n_trees: int = 60,
        depth: int = 4,
        lr: float = 0.2,
        min_samples: int = 2,
    ):
        self.op = op
        self.dtype = dtype
        self.fingerprint = fingerprint
        self.n_features = int(n_features)
        self.booster = PairwiseRankGBT(
            n_trees=n_trees, depth=depth, lr=lr, min_samples=min_samples
        )
        self.n_rows_trained = 0  # corpus size at fit time (cache freshness)
        self.n_groups_trained = 0

    # -- training -------------------------------------------------------------
    @classmethod
    def fit_dataset(cls, ds: JournalDataset, **hyper) -> "RankingCostModel":
        m = cls(ds.op, ds.dtype, ds.fingerprint, ds.n_features, **hyper)
        m.booster.fit(ds.X, ds.y, ds.groups)
        m.n_rows_trained = len(ds)
        m.n_groups_trained = ds.n_groups
        return m

    @property
    def is_fitted(self) -> bool:
        return bool(self.booster.trees)

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"feature width {X.shape[-1] if X.ndim == 2 else X.shape} "
                f"does not match model's {self.n_features}"
            )
        return self.booster.predict(X)

    def compatible_with(self, op: str, dtype: Optional[str],
                        fingerprint: Optional[str], n_features: int) -> bool:
        return (
            self.op == op
            and (self.dtype is None or dtype is None or self.dtype == dtype)
            and (
                self.fingerprint is None
                or fingerprint is None
                or self.fingerprint == fingerprint
            )
            and self.n_features == int(n_features)
        )

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, ds: JournalDataset, k: int = 8) -> dict:
        """Rank quality on a (held-out) dataset: per-group Spearman and
        top-k recall."""
        if len(ds) == 0:
            return {"n_rows": 0, "rank_corr": float("nan"),
                    "top_k_recall": float("nan"), "k": k}
        pred = self.predict(ds.X)
        return {
            "n_rows": len(ds),
            "n_groups": len(np.unique(ds.groups)),
            "rank_corr": spearman_rank_corr(ds.y, pred, ds.groups),
            "top_k_recall": top_k_recall(ds.y, pred, k, ds.groups),
            "k": k,
        }

    # -- persistence ----------------------------------------------------------
    def content_key(self) -> str:
        """Hash of everything that decides whether a cached model may be
        reused for a given configuration (NOT of the training data: the
        row count is stored in the payload for freshness checks)."""
        h = hashlib.sha256()
        b = self.booster
        ident = json.dumps(
            [
                SCHEMA_VERSION, self.op, self.dtype, self.fingerprint,
                self.n_features, b.n_trees, b.depth, b.lr, b.min_samples,
            ],
            sort_keys=True,
        )
        h.update(ident.encode("utf-8"))
        return h.hexdigest()[:24]

    def cache_path(self, cache_dir: str) -> str:
        return os.path.join(cache_dir, f"rankmodel-{self.content_key()}.json")

    def save(self, cache_dir: str) -> str:
        """Atomic write into the cache directory; returns the path."""
        os.makedirs(cache_dir, exist_ok=True)
        payload = {
            "schema": SCHEMA_VERSION,
            "op": self.op,
            "dtype": self.dtype,
            "fingerprint": self.fingerprint,
            "n_features": self.n_features,
            "n_rows_trained": self.n_rows_trained,
            "n_groups_trained": self.n_groups_trained,
            "booster": self.booster.to_jsonable(),
        }
        path = self.cache_path(cache_dir)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, separators=(",", ":"))
            os.replace(tmp, path)  # atomic publish
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    @classmethod
    def load(cls, path: str) -> Optional["RankingCostModel"]:
        """Load one cache file; None if unreadable or schema-mismatched
        (a missing/foreign model is an expected cache miss, not an
        error)."""
        try:
            with open(path) as f:
                payload = json.load(f)
            if payload.get("schema") != SCHEMA_VERSION:
                return None
            b = payload["booster"]
            m = cls(
                payload["op"], payload["dtype"], payload["fingerprint"],
                payload["n_features"], n_trees=int(b["n_trees"]),
                depth=int(b["depth"]), lr=float(b["lr"]),
                min_samples=int(b["min_samples"]),
            )
            m.booster = PairwiseRankGBT.from_jsonable(b)
            m.n_rows_trained = int(payload.get("n_rows_trained", 0))
            m.n_groups_trained = int(payload.get("n_groups_trained", 0))
            return m
        except (OSError, ValueError, KeyError, TypeError):
            return None

    @classmethod
    def load_for(
        cls,
        cache_dir: str,
        op: str,
        dtype: Optional[str],
        fingerprint: Optional[str],
        n_features: int,
        **hyper,
    ) -> Optional["RankingCostModel"]:
        """Cache lookup by content key: build the identity the caller
        wants, hash it, load that file if present and compatible."""
        probe = cls(op, dtype, fingerprint, n_features, **hyper)
        m = cls.load(probe.cache_path(cache_dir))
        if m is not None and m.compatible_with(op, dtype, fingerprint, n_features):
            return m
        return None
