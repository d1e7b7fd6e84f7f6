"""The measurement proposal filter: score a wave's candidates with the
learned rank model, really measure only the predicted-best fraction.

This is the measurement-reduction analogue of the static pre-filter
(``MeasureEngine(analyze="prune")``), one stage later in the funnel: the
analyzer rejects *provably broken* schedules for free, the learned
filter skips *predictably slow* legal ones.  The contract mirrors the
static path deliberately —

* a skipped candidate gets an ``inf`` outcome carrying its predicted
  score (``MeasureOutcome.predicted``) and is journaled as a compile-free
  ``{"c": null, "pred": score}`` provenance row that NEVER enters the
  cost table: a later unfiltered run must re-measure it, not cache-hit a
  guess;
* the trial is still charged against the tuner's budget (the tuner
  proposed it; the saving is real measurements, ``stats.n_dispatched``,
  not trial count);
* at least one candidate per wave is always measured, so the search can
  never starve and every wave still feeds the next retrain.

The filter retrains itself mid-search: every ``retrain_every`` waves it
rebuilds the corpus from the journal file (which by then contains the
rows the search itself just measured — including sibling engines' rows,
via the shared journal) and refits once the corpus has grown.  Models
persist content-keyed next to the journal (``<journal>.learncache/``),
so a later session starts filtering from wave one instead of measuring
``min_rows`` candidates first.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from ..records import TrialJournal
from ..space import SearchSpace, State
from .dataset import build_dataset
from .model import RankingCostModel, learn_cache_dir_for

__all__ = ["ProposalFilter"]


class ProposalFilter:
    """Wave-level candidate filter for one workload's engine.

    ``keep`` is the fraction of each wave's cache-missing candidates
    that really reaches a measurement lane (at least 1).  Until the
    journal holds ``min_rows`` trainable rows in this filter's scope the
    filter passes everything through — identical to an unfiltered
    engine."""

    def __init__(
        self,
        space: SearchSpace,
        journal: Optional[TrialJournal],
        dtype: Optional[str] = None,
        fingerprint: Optional[str] = None,
        keep: float = 0.5,
        retrain_every: int = 8,
        min_rows: int = 32,
        cache_dir: Optional[str] = None,
        **hyper,
    ):
        if not (0.0 < keep <= 1.0):
            raise ValueError(f"filter keep fraction must be in (0, 1], got {keep}")
        self.space = space
        self.journal = journal
        self.dtype = dtype
        self.fingerprint = fingerprint
        self.keep = float(keep)
        self.retrain_every = max(1, int(retrain_every))
        self.min_rows = max(2, int(min_rows))
        self.hyper = hyper
        if cache_dir is None and journal is not None and journal.path:
            cache_dir = learn_cache_dir_for(journal.path)
        self.cache_dir = cache_dir
        self.model: Optional[RankingCostModel] = None
        self.n_retrains = 0
        self.learn_s = 0.0  # wall spent scoring + retraining
        self._waves_since_check = None  # None -> check on the first wave
        self._rows_at_fit = 0
        if self.cache_dir is not None:
            cached = RankingCostModel.load_for(
                self.cache_dir, space.op, dtype, fingerprint,
                space.n_features, **hyper,
            )
            if cached is not None and cached.is_fitted:
                self.model = cached
                self._rows_at_fit = cached.n_rows_trained

    @property
    def active(self) -> bool:
        """Whether :meth:`select` can currently drop candidates."""
        return self.model is not None and self.model.is_fitted

    # -- crash-safe resume ----------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable filter state for crash-safe resume: the
        retrain cadence counters plus the fitted model's provenance
        (content key + corpus size).  The model weights themselves are
        NOT serialized — they already persist content-keyed in
        ``cache_dir`` (every refit saves before the next round
        boundary), so the snapshot only has to name the file."""
        return {
            "waves_since_check": self._waves_since_check,
            "rows_at_fit": self._rows_at_fit,
            "n_retrains": self.n_retrains,
            "model_key": None if self.model is None else self.model.content_key(),
            "model_rows": 0 if self.model is None else self.model.n_rows_trained,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` output.  Without this, a resumed
        ``--learned-filter on`` run resets ``_waves_since_check`` to
        None (an immediate retrain check on the first resumed wave) and
        loses ``_rows_at_fit``, so it skips different candidates than
        the uninterrupted run — the resume-parity bug this fixes."""
        wsc = state.get("waves_since_check")
        self._waves_since_check = None if wsc is None else int(wsc)
        self._rows_at_fit = int(state.get("rows_at_fit", 0))
        self.n_retrains = int(state.get("n_retrains", 0))
        key = state.get("model_key")
        if key is None:
            self.model = None
            return
        if self.cache_dir is not None:
            cached = RankingCostModel.load(
                os.path.join(self.cache_dir, f"rankmodel-{key}.json")
            )
            if cached is not None and cached.compatible_with(
                self.space.op, self.dtype, self.fingerprint,
                self.space.n_features,
            ):
                self.model = cached

    # -- retraining -----------------------------------------------------------
    def maybe_retrain(self) -> bool:
        """Once per wave: at the cadence, rebuild the corpus from the
        journal file and refit if it grew.  Returns True when a new
        model was fit."""
        if self.journal is None or not self.journal.path:
            return False
        if self._waves_since_check is not None:
            self._waves_since_check += 1
            if self._waves_since_check < self.retrain_every:
                return False
        self._waves_since_check = 0
        t0 = time.perf_counter()
        try:
            ds = build_dataset(
                self.journal.path, self.space.op,
                dtype=self.dtype, fingerprint=self.fingerprint,
            )
            if (
                ds.counts.n_trainable < self.min_rows
                or ds.counts.n_trainable <= self._rows_at_fit
                or ds.n_features != self.space.n_features
            ):
                return False
            model = RankingCostModel.fit_dataset(ds, **self.hyper)
            if not model.is_fitted:
                return False
            self.model = model
            self._rows_at_fit = ds.counts.n_trainable
            self.n_retrains += 1
            if self.cache_dir is not None:
                model.save(self.cache_dir)
            return True
        finally:
            self.learn_s += time.perf_counter() - t0

    # -- selection ------------------------------------------------------------
    def select(
        self, states: Sequence[State]
    ) -> tuple[list[int], list[tuple[int, float]]]:
        """Partition one wave's candidates into (measure, skip).

        Returns ``(kept_indices, [(skipped_index, predicted_score), ...])``
        — both in ascending index order, so the surviving wave keeps the
        engine's deterministic dispatch order.  Scores are the model's
        raw rank outputs (lower = predicted better); they are what the
        skip provenance rows journal."""
        n = len(states)
        if not self.active or n < 2:
            return list(range(n)), []
        n_keep = max(1, int(np.ceil(self.keep * n)))
        if n_keep >= n:
            return list(range(n)), []
        t0 = time.perf_counter()
        X = np.stack([self.space.features(s) for s in states])
        scores = self.model.predict(X)
        self.learn_s += time.perf_counter() - t0
        order = np.argsort(scores, kind="stable")
        kept = sorted(int(i) for i in order[:n_keep])
        skipped = [
            (int(i), float(scores[int(i)])) for i in sorted(order[n_keep:])
        ]
        return kept, skipped
