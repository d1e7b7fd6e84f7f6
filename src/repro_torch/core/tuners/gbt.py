"""XGBoost-style tuner: SMBO with a gradient-boosted-tree surrogate.

This is the paper's primary baseline ("state-of-the-art XGBoost method"
= AutoTVM's cost-model tuner, Chen et al. 2018b).  The project takes no
xgboost dependency, so the surrogate — depth-limited regression trees fit on
residuals with shrinkage — is implemented from scratch in numpy
(:class:`~repro_torch.core.learn.gbt.GradientBoostedTrees`, re-exported
here).
The SMBO loop mirrors AutoTVM:

  1. measure a random warmup batch,
  2. fit the surrogate on log-costs of everything measured,
  3. propose candidates (random pool + neighbors of incumbents),
     rank by predicted cost, ε-diversify,
  4. measure the top batch in one batched engine call, go to 2.

Both the warmup and the per-round top batch go through
``TuningContext.measure_many`` so the engine can spread each batch
across its ``n_workers`` measurement lanes (AutoTVM measures its
proposal batches on parallel device workers the same way).
"""

from __future__ import annotations

import math

import numpy as np

from ..learn.gbt import GradientBoostedTrees
from ..space import State
from .base import Tuner, TuningContext

__all__ = ["GBTTuner", "GradientBoostedTrees"]


class GBTTuner(Tuner):
    name = "xgboost-like"

    def __init__(
        self,
        space,
        cost,
        seed: int = 0,
        warmup: int = 16,
        batch_size: int = 16,
        pool_size: int = 512,
        eps_random: float = 0.15,
        n_trees: int = 50,
        depth: int = 4,
        refit_every: int = 1,
    ):
        super().__init__(space, cost, seed)
        self.warmup = warmup
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.eps_random = eps_random
        self.n_trees, self.depth = n_trees, depth
        self.refit_every = refit_every
        self._it = 0
        self._needs_refit = False

    # -- crash-safe resume ---------------------------------------------------
    # The surrogate itself is not serialized: it is a pure function of
    # ctx.trials, so a restored tuner refits from the restored trial log
    # on its first round (bit-identical to an uninterrupted run when
    # refit_every == 1, the default).
    def state_dict(self) -> dict:
        d = super().state_dict()
        d["it"] = self._it
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._it = state["it"]
        self._needs_refit = True

    def _propose_pool(self, ctx: TuningContext) -> list[State]:
        pool: dict[str, State] = {}
        for _ in range(self.pool_size):
            s = self.space.random_state(self.rng)
            pool.setdefault(s.key(), s)
        # exploit: neighborhoods of the best measured states
        ranked = sorted(
            (t for t in ctx.trials if math.isfinite(t.cost)), key=lambda t: t.cost
        )[:8]
        for t in ranked:
            for s2 in self.space.neighbors(t.state):
                pool.setdefault(s2.key(), s2)
        return [s for k, s in pool.items() if k not in ctx.visited]

    def run(self, ctx: TuningContext) -> None:
        # 1. warmup — random states proposed in lane-sized waves
        ctx.measure(self.space.initial_state())
        while len(ctx.trials) < self.warmup and not ctx.done():
            want = min(max(1, ctx.n_workers), self.warmup - len(ctx.trials))
            wave: list[State] = []
            keys: set[str] = set()
            attempts = 0
            while len(wave) < want and attempts < 64 * want:
                attempts += 1
                s = self.space.random_state(self.rng)
                if not ctx.seen(s) and s.key() not in keys:
                    wave.append(s)
                    keys.add(s.key())
            if not wave:
                break
            ctx.measure_many(wave)
        model = GradientBoostedTrees(self.n_trees, self.depth)
        while not ctx.done():
            ctx.checkpoint(self)
            # 2. fit surrogate on log-costs
            xs, ys = [], []
            for t in ctx.trials:
                xs.append(self.space.features(t.state))
                ys.append(
                    math.log(t.cost) if math.isfinite(t.cost) else math.log(1e3)
                )
            if self._needs_refit or self._it % self.refit_every == 0:
                model.fit(np.stack(xs), np.asarray(ys))
                self._needs_refit = False
            self._it += 1
            # 3. rank pool
            pool = self._propose_pool(ctx)
            if not pool:
                s = self.space.random_state(self.rng)
                if not ctx.seen(s):
                    ctx.measure(s)
                continue
            feats = np.stack([self.space.features(s) for s in pool])
            pred = model.predict(feats)
            order = np.argsort(pred)
            batch: list[State] = [pool[i] for i in order[: self.batch_size]]
            # ε-diversification (AutoTVM's ε-greedy proposal mix)
            n_rand = max(1, int(self.eps_random * len(batch)))
            for _ in range(n_rand):
                batch[self.rng.randrange(len(batch))] = pool[
                    int(order[self.rng.randrange(len(order))])
                ]
            # 4. measure the surviving batch in one engine round
            fresh: list[State] = []
            keys = set()
            for s in batch:
                if not ctx.seen(s) and s.key() not in keys:
                    fresh.append(s)
                    keys.add(s.key())
            if fresh:
                ctx.measure_many(fresh)
