"""G-BFS — Greedy Best-First-Search tuner (paper Algorithm 1, Fig. 5).

A priority queue ordered by measured cost holds the frontier.  Each
iteration pops the cheapest state, samples ``rho`` of its legitimate
unvisited neighbors (Eqn. 9), measures the whole ρ-sample in one engine
call (``measure_many``), and pushes the results back.  With
``rho = len(g(s))`` and unlimited budget the search visits the entire
reachable space (paper Sec. 4.2).
"""

from __future__ import annotations

import heapq
from typing import Optional

from ..space import State
from .base import Tuner, TuningContext

__all__ = ["GBFSTuner"]


class GBFSTuner(Tuner):
    name = "g-bfs"

    def __init__(self, space, cost, seed: int = 0, rho: int = 5,
                 s0: Optional[State] = None):
        super().__init__(space, cost, seed)
        self.rho = rho
        self.s0 = s0

    def run(self, ctx: TuningContext) -> None:
        tie = 0  # stable heap order for equal costs
        s0 = self.s0 or self.space.initial_state()
        pq: list[tuple[float, int, State]] = [(ctx.measure(s0), tie, s0)]
        while pq and not ctx.done():
            _, _, s = heapq.heappop(pq)
            neigh = [s2 for s2 in self.space.neighbors(s) if not ctx.seen(s2)]
            if not neigh:
                continue
            batch = self.rng.sample(neigh, min(self.rho, len(neigh)))
            # one engine round per ρ-sample; raises BudgetExhausted at the limit
            costs = ctx.measure_many(batch)
            for s2, c2 in zip(batch, costs):
                tie += 1
                heapq.heappush(pq, (c2, tie, s2))
