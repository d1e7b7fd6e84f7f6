"""Gradient-boosted-tree machinery of the SMBO tuner (and, in the JAX
package, of its learned cost model), held bit for bit against it.

The project takes no xgboost dependency, so the boosters here are
implemented from scratch in numpy: depth-limited regression trees fit
with a vectorized SSE split search, combined by shrinkage.  Two losses
share the tree fitter:

* :class:`GradientBoostedTrees` — squared loss on absolute targets, the
  surrogate :class:`~repro_torch.core.tuners.gbt.GBTTuner` refits every
  SMBO round.
* :class:`PairwiseRankGBT` — a pairwise logistic *rank* objective (the
  LambdaMART/"Learning to Optimize Tensor Programs" recipe): only the
  relative order of costs *within a group* (one workload shape) enters
  the loss, so corpora from different shapes — whose absolute runtimes
  differ by orders of magnitude — train one transferable model without
  any per-shape normalization.

Both boosters are deterministic: tree fitting uses stable sorts and the
rank loss pairs each sample with fixed neighbor offsets in the
within-group cost order instead of sampling pairs with an RNG, so a
retrain over the same corpus reproduces the same model bit-for-bit.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "GradientBoostedTrees",
    "PairwiseRankGBT",
    "tree_to_jsonable",
    "tree_from_jsonable",
]


class _Tree:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = 0.0


def _fit_tree(X: np.ndarray, y: np.ndarray, depth: int, min_samples: int) -> _Tree:
    node = _Tree()
    node.value = float(y.mean())
    if depth == 0 or len(y) < 2 * min_samples or np.allclose(y, y[0]):
        return node
    best_gain, best = 0.0, None
    n, f = X.shape
    parent_sse = float(((y - y.mean()) ** 2).sum())
    idx = np.arange(1, n, dtype=np.float64)
    for j in range(f):
        xs = X[:, j]
        order = np.argsort(xs, kind="stable")
        xs_s, ys_s = xs[order], y[order]
        cums = np.cumsum(ys_s)[:-1]
        cums2 = np.cumsum(ys_s**2)[:-1]
        # vectorized SSE for every split position i in [1, n)
        left_n, right_n = idx, n - idx
        sse = (cums2 - cums * cums / left_n) + (
            (cums2[-1] + ys_s[-1] ** 2 - cums2)
            - (cums[-1] + ys_s[-1] - cums) ** 2 / right_n
        )
        valid = (xs_s[1:] != xs_s[:-1]) & (left_n >= min_samples) & (right_n >= min_samples)
        if not valid.any():
            continue
        sse = np.where(valid, sse, np.inf)
        i = int(np.argmin(sse))
        gain = parent_sse - float(sse[i])
        if gain > best_gain + 1e-12:
            best_gain = gain
            best = (j, 0.5 * (xs_s[i + 1] + xs_s[i]))
    if best is None:
        return node
    j, thr = best
    mask = X[:, j] <= thr
    node.feature, node.threshold = j, thr
    node.left = _fit_tree(X[mask], y[mask], depth - 1, min_samples)
    node.right = _fit_tree(X[~mask], y[~mask], depth - 1, min_samples)
    return node


def _tree_predict(node: _Tree, X: np.ndarray) -> np.ndarray:
    if node.feature < 0:
        return np.full(len(X), node.value)
    out = np.empty(len(X))
    mask = X[:, node.feature] <= node.threshold
    out[mask] = _tree_predict(node.left, X[mask]) if mask.any() else 0
    out[~mask] = _tree_predict(node.right, X[~mask]) if (~mask).any() else 0
    return out


def tree_to_jsonable(node: _Tree) -> dict:
    """Recursive plain-dict form of one fitted tree (the JAX package's
    model-cache schema)."""
    if node.feature < 0:
        return {"v": node.value}
    return {
        "f": node.feature,
        "t": node.threshold,
        "v": node.value,
        "l": tree_to_jsonable(node.left),
        "r": tree_to_jsonable(node.right),
    }


def tree_from_jsonable(data: dict) -> _Tree:
    node = _Tree()
    node.value = float(data["v"])
    if "f" in data:
        node.feature = int(data["f"])
        node.threshold = float(data["t"])
        node.left = tree_from_jsonable(data["l"])
        node.right = tree_from_jsonable(data["r"])
    return node


class GradientBoostedTrees:
    """Squared-loss GBT with shrinkage — enough of xgboost for SMBO."""

    def __init__(self, n_trees: int = 50, depth: int = 4, lr: float = 0.2,
                 min_samples: int = 2):
        self.n_trees, self.depth, self.lr = n_trees, depth, lr
        self.min_samples = min_samples
        self.base = 0.0
        self.trees: list[_Tree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoostedTrees":
        self.base = float(y.mean())
        self.trees = []
        pred = np.full(len(y), self.base)
        for _ in range(self.n_trees):
            resid = y - pred
            t = _fit_tree(X, resid, self.depth, self.min_samples)
            self.trees.append(t)
            pred = pred + self.lr * _tree_predict(t, X)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        pred = np.full(len(X), self.base)
        for t in self.trees:
            pred = pred + self.lr * _tree_predict(t, X)
        return pred


#: Neighbor offsets in the within-group cost order that form training
#: pairs: each sample is compared against its 1st/2nd/4th/8th-better
#: neighbor.  Local pairs teach fine ranking near the optimum, the
#: longer strides anchor the global order — with no RNG involved.
_PAIR_OFFSETS = (1, 2, 4, 8)


class PairwiseRankGBT:
    """Gradient boosting on a pairwise logistic rank loss.

    ``fit(X, y, groups)`` learns a scalar score that *sorts like* ``y``
    within every group (lower score = lower cost); absolute values carry
    no meaning across groups, which is exactly what makes journal rows
    from different workload shapes one training corpus.  For each pair
    (i better, j worse) the loss is ``log(1 + exp(f_i - f_j))``; each
    round fits a regression tree to the negative gradient via the same
    vectorized tree fitter the squared-loss booster uses.
    """

    def __init__(self, n_trees: int = 60, depth: int = 4, lr: float = 0.2,
                 min_samples: int = 2):
        self.n_trees, self.depth, self.lr = n_trees, depth, lr
        self.min_samples = min_samples
        self.trees: list[_Tree] = []

    @staticmethod
    def _pairs(y: np.ndarray, groups: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Deterministic (better_idx, worse_idx) training pairs: within
        each group, sort by cost and pair each sample with its better
        neighbor at the fixed strides.  Ties produce no pair."""
        better, worse = [], []
        for g in np.unique(groups):
            idx = np.flatnonzero(groups == g)
            if len(idx) < 2:
                continue
            order = idx[np.argsort(y[idx], kind="stable")]
            ys = y[order]
            for off in _PAIR_OFFSETS:
                if off >= len(order):
                    break
                a = order[:-off]  # the better (lower-cost) side
                b = order[off:]
                tie = ys[:-off] == ys[off:]
                better.append(a[~tie])
                worse.append(b[~tie])
        if not better:
            return np.empty(0, np.intp), np.empty(0, np.intp)
        return np.concatenate(better), np.concatenate(worse)

    def fit(self, X: np.ndarray, y: np.ndarray,
            groups: np.ndarray | None = None) -> "PairwiseRankGBT":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if groups is None:
            groups = np.zeros(len(y), dtype=np.intp)
        bi, wi = self._pairs(y, np.asarray(groups))
        self.trees = []
        if len(bi) == 0:
            return self
        f = np.zeros(len(y))
        for _ in range(self.n_trees):
            # d loss / d f_better = sigma, with sigma -> 0 once the pair
            # is ordered correctly by a margin; residual = -gradient
            sigma = 1.0 / (1.0 + np.exp(np.clip(f[wi] - f[bi], -60, 60)))
            resid = np.zeros(len(y))
            np.subtract.at(resid, bi, sigma)
            np.add.at(resid, wi, sigma)
            t = _fit_tree(X, resid, self.depth, self.min_samples)
            self.trees.append(t)
            f = f + self.lr * _tree_predict(t, X)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Scores ascending with cost: lower = predicted better."""
        X = np.asarray(X, dtype=np.float64)
        pred = np.zeros(len(X))
        for t in self.trees:
            pred = pred + self.lr * _tree_predict(t, X)
        return pred

    # -- persistence ------------------------------------------------------------
    def to_jsonable(self) -> dict:
        return {
            "n_trees": self.n_trees,
            "depth": self.depth,
            "lr": self.lr,
            "min_samples": self.min_samples,
            "trees": [tree_to_jsonable(t) for t in self.trees],
        }

    @classmethod
    def from_jsonable(cls, data: dict) -> "PairwiseRankGBT":
        m = cls(
            n_trees=int(data["n_trees"]),
            depth=int(data["depth"]),
            lr=float(data["lr"]),
            min_samples=int(data["min_samples"]),
        )
        m.trees = [tree_from_jsonable(t) for t in data["trees"]]
        return m
