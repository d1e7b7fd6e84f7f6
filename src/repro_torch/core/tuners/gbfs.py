"""G-BFS — Greedy Best-First-Search tuner (paper Algorithm 1, Fig. 5).

A priority queue ordered by measured cost holds the frontier.  Each
iteration pops the cheapest state, samples ``rho`` of its legitimate
unvisited neighbors (Eqn. 9), measures the whole ρ-sample in **one
engine call** (`measure_many`), and pushes the results back.  With
``n_workers >= rho`` the entire sample is measured as one concurrent
wave, so each round costs one critical-path measurement on the search
clock instead of ρ sequential ones.  With ``rho = len(g(s))`` and
unlimited budget the search visits the entire reachable space (paper
Sec. 4.2).

The frontier and its tie-break counter live on the instance (not run's
stack) so a crash-safe snapshot (``state_dict``) can capture them; a
restored tuner resumes popping the exact frontier the interrupted run
would have popped next.
"""

from __future__ import annotations

import heapq
from typing import Optional

from ..space import State
from .base import Tuner, TuningContext, decode_cost, encode_cost

__all__ = ["GBFSTuner"]


class GBFSTuner(Tuner):
    name = "g-bfs"

    def __init__(self, space, cost, seed: int = 0, rho: int = 5,
                 s0: Optional[State] = None):
        super().__init__(space, cost, seed)
        self.rho = rho
        self.s0 = s0
        self._pq: Optional[list[tuple[float, int, State]]] = None
        self._tie = 0  # stable heap order for equal costs

    def _next_tie(self) -> int:
        t = self._tie
        self._tie += 1
        return t

    # -- crash-safe resume ---------------------------------------------------
    def state_dict(self) -> dict:
        d = super().state_dict()
        d["tie"] = self._tie
        d["pq"] = (
            None
            if self._pq is None
            else [[encode_cost(c), t, s.as_lists()] for c, t, s in self._pq]
        )
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._tie = state["tie"]
        pq = state["pq"]
        # a heap serialized in list order deserializes as a valid heap
        self._pq = (
            None
            if pq is None
            else [
                (decode_cost(c), t, self.space.state_from_lists(rows))
                for c, t, rows in pq
            ]
        )

    def run(self, ctx: TuningContext) -> None:
        if self._pq is None:
            s0 = self.s0 or self.space.initial_state()
            c0 = ctx.measure(s0)
            self._pq = [(c0, self._next_tie(), s0)]
        while self._pq and not ctx.done():
            ctx.checkpoint(self)  # snapshot sees the un-popped frontier
            cost_s, _, s = heapq.heappop(self._pq)
            neigh = [s2 for s2 in self.space.neighbors(s) if not ctx.seen(s2)]
            if not neigh:
                continue
            rho = min(self.rho, len(neigh))
            batch = self.rng.sample(neigh, rho)
            # one engine round per ρ-sample; raises BudgetExhausted at the limit
            costs = ctx.measure_many(batch)
            for s2, c2 in zip(batch, costs):
                heapq.heappush(self._pq, (c2, self._next_tie(), s2))
