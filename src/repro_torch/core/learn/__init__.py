"""Learned cost-model subsystem: journal-trained ranking models and the
measurement proposal filter.

The tuning stack accumulates exactly the training set a learned cost
model needs — every measurement ever taken, journaled with its state's
factor lists and scoped to op/dtype/backend/measurement-fingerprint.
This package closes the loop (the "Learning to Optimize Tensor
Programs" recipe, see PAPERS.md):

* :mod:`~repro_torch.core.learn.gbt` — the gradient-boosted-tree
  machinery shared with the ``xgboost-like`` tuner, plus the
  pairwise-rank booster;
* :mod:`~repro_torch.core.learn.dataset` — :class:`JournalDataset`, the
  cross-shape ``(features, log-cost, group)`` corpus builder;
* :mod:`~repro_torch.core.learn.model` — :class:`RankingCostModel` with
  content-keyed persistence next to the journal and rank-quality
  metrics (Spearman, top-k recall);
* :mod:`~repro_torch.core.learn.filter` — :class:`ProposalFilter`, the
  :class:`~repro_torch.core.measure.MeasureEngine` stage that measures only
  each wave's predicted-best fraction and journals the rest as
  ``{"c": null, "pred": score}`` provenance rows.
"""

from .dataset import CorpusCounts, JournalDataset, build_dataset, scan_corpus
from .filter import ProposalFilter
from .gbt import GradientBoostedTrees, PairwiseRankGBT
from .model import (
    RankingCostModel,
    learn_cache_dir_for,
    spearman_rank_corr,
    top_k_recall,
)

__all__ = [
    "CorpusCounts",
    "JournalDataset",
    "build_dataset",
    "scan_corpus",
    "ProposalFilter",
    "GradientBoostedTrees",
    "PairwiseRankGBT",
    "RankingCostModel",
    "learn_cache_dir_for",
    "spearman_rank_corr",
    "top_k_recall",
]
