"""Learned models of the tuning stack.  So far the port holds the
gradient-boosted-tree boosters (:mod:`~repro_torch.core.learn.gbt`), the
surrogate of the ``xgboost-like`` tuner; the JAX package's journal
dataset, ranking cost model and proposal filter are not ported yet."""

from .gbt import GradientBoostedTrees, PairwiseRankGBT

__all__ = ["GradientBoostedTrees", "PairwiseRankGBT"]
