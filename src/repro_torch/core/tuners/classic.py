"""Classic baseline tuners: random, grid, simulated annealing, genetic.

Random/grid/GA are the baselines the TVM papers (Chen et al. 2018a/b)
compare XGBoost against; the paper inherits those comparisons.  Simulated
annealing is included as an extra neighborhood-aware control (beyond
paper) since it uses the same MDP moves as G-BFS but no frontier memory.

All four propose candidate *batches* per round through
``TuningContext.measure_many`` so the measurement engine can spread each
round across its ``n_workers`` lanes: random and grid propose lane-sized
waves, the GA measures its seed population and each generation's
children as one batch, and annealing runs ``n_workers`` independent
Metropolis chains whose per-round proposals are measured together.  With
``n_workers=1`` each of them degenerates to the historical serial loop
(identical RNG consumption, identical trial order).

Crash-safe resume: random and grid carry no search memory beyond the RNG
stream / enumeration cursor, so their ``state_dict`` is (nearly) the base
one; the GA externalizes its population, and annealing its chains.

Two changes from the JAX package, both in annealing: its chains are
explicit records instead of generators, so a snapshot carries them
(``chains``) and a resumed run is bit-identical to an uninterrupted one
(there the chains restart from fresh seeds on resume); and a chain that
meets only ``inf`` costs cools out and restarts (there it loops forever
once every neighbour is visited).  Costs that are finite everywhere, as
on the TPU model, never take that exit; the trial sequence is the JAX
package's.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

from ..space import State
from .base import Tuner, TuningContext, decode_cost, encode_cost

__all__ = ["RandomTuner", "GridTuner", "AnnealingTuner", "GeneticTuner"]


class RandomTuner(Tuner):
    name = "random"

    def run(self, ctx: TuningContext) -> None:
        while not ctx.done():
            ctx.checkpoint(self)
            wave: list[State] = []
            keys: set[str] = set()
            attempts = 0
            want = max(1, ctx.n_workers)
            while len(wave) < want and attempts < 64 * want:
                attempts += 1
                s = self.space.random_state(self.rng)
                if not ctx.seen(s) and s.key() not in keys:
                    wave.append(s)
                    keys.add(s.key())
            if not wave:
                return  # space (effectively) exhausted
            ctx.measure_many(wave)


class GridTuner(Tuner):
    """Sequential sweep in enumeration order (paper Sec. 2: grid search),
    chunked into lane-sized waves.  The enumeration cursor (`_drawn`) is
    instance state so a restored tuner re-enters the sweep exactly where
    the snapshot left it."""

    name = "grid"

    def __init__(self, space, cost, seed: int = 0):
        super().__init__(space, cost, seed)
        self._drawn = 0

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["drawn"] = self._drawn
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._drawn = state["drawn"]

    def run(self, ctx: TuningContext) -> None:
        it = itertools.islice(self.space.enumerate(), self._drawn, None)
        while not ctx.done():
            ctx.checkpoint(self)
            chunk = list(itertools.islice(it, max(1, ctx.n_workers)))
            if not chunk:
                return
            self._drawn += len(chunk)
            ctx.measure_many(chunk)


class AnnealingTuner(Tuner):
    """Metropolis chains over the MDP neighborhood.  One chain per engine
    lane; each round every chain advances to its next *unvisited*
    proposal (cached states are folded in for free along the way) and the
    proposals are measured as one wave.

    The JAX package runs each chain as a generator; here a chain is an
    explicit record (``_Chain``) advanced by :meth:`_advance`, which
    consumes the RNG in the generator's order — so the trial sequence is
    the same — and can be snapshotted between rounds, so a resumed run
    continues every chain from its pending proposal."""

    name = "sim-anneal"

    def __init__(self, space, cost, seed: int = 0, t0: float = 1.0,
                 decay: float = 0.995, restarts: int = 8):
        super().__init__(space, cost, seed)
        self.t0, self.decay, self.restarts = t0, decay, restarts
        self._chains: Optional[list[dict]] = None  # live chains, in request order

    # -- crash-safe resume ---------------------------------------------------
    def state_dict(self) -> dict:
        d = super().state_dict()
        if self._chains is not None:
            d["chains"] = [
                {
                    "first": ch["first"],
                    "mode": ch["mode"],
                    "temp": ch["temp"],
                    "c": encode_cost(ch["c"]),
                    "s": None if ch["s"] is None else ch["s"].as_lists(),
                    "s2": None if ch["s2"] is None else ch["s2"].as_lists(),
                }
                for ch in self._chains
            ]
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        chains = state.get("chains")
        self._chains = None if chains is None else [
            {
                "first": ch["first"],
                "mode": ch["mode"],
                "temp": ch["temp"],
                "c": decode_cost(ch["c"]),
                "s": None if ch["s"] is None else self.space.state_from_lists(ch["s"]),
                "s2": None if ch["s2"] is None else self.space.state_from_lists(ch["s2"]),
            }
            for ch in chains
        ]

    # -- one chain -------------------------------------------------------------
    @staticmethod
    def _new_chain(first: bool) -> dict:
        return {"first": first, "mode": "restart", "temp": 0.0, "c": math.inf,
                "s": None, "s2": None}

    @staticmethod
    def _pending(ch: dict) -> State:
        """The proposal a suspended chain waits on: its start state or
        its neighbour move."""
        return ch["s"] if ch["mode"] == "start" else ch["s2"]

    def _advance(self, ctx: TuningContext, ch: dict,
                 cost: Optional[float]) -> Optional[State]:
        """Run one chain until it proposes an unvisited state (returned,
        the chain suspended on it) or ends (None).  ``cost`` is the
        measured cost of the proposal the chain was suspended on.  Modes:
        ``restart`` draws a start state, ``start`` takes the start
        state's cost, ``inner`` proposes a neighbour move, ``step``
        takes the move's cost and applies the Metropolis rule."""
        mode = ch["mode"]
        while True:
            if mode == "restart":  # keep restarting until the budget is spent
                if ctx.done():
                    return None
                s = self.space.initial_state() if ch["first"] else self.space.random_state(self.rng)
                ch["first"], ch["s"] = False, s
                if not ctx.seen(s):
                    ch["mode"] = "start"
                    return s
                cost, mode = ctx.visited[s.key()], "start"
            if mode == "start":
                ch["c"], ch["temp"], mode = cost, self.t0, "inner"
            if mode == "inner":
                if ctx.done():
                    return None
                neigh = self.space.neighbors(ch["s"])
                if not neigh:
                    mode = "restart"
                    continue
                s2 = self.rng.choice(neigh)
                ch["s2"] = s2
                if not ctx.seen(s2):
                    ch["mode"] = "step"
                    return s2
                cost, mode = ctx.visited[s2.key()], "step"
            if mode == "step":
                c, c2, temp = ch["c"], cost, ch["temp"]
                mode = "inner"
                if not math.isfinite(c2):
                    ch["temp"] = temp * self.decay
                    # the JAX package's chain has no exit here: on a cost
                    # that is inf around the start (the Hopper kernels
                    # refuse the untiled state and its neighbours), it
                    # circles visited states forever; cooling out ends
                    # the chain as an accepted or rejected move does
                    if ch["temp"] < 1e-3:
                        mode = "restart"
                    continue
                # Metropolis on relative cost (scale-free)
                if c2 < c or self.rng.random() < math.exp(-(c2 - c) / max(c * temp, 1e-30)):
                    ch["s"], ch["c"] = ch["s2"], c2
                ch["temp"] = temp * self.decay
                if ch["temp"] < 1e-3:
                    mode = "restart"

    def run(self, ctx: TuningContext) -> None:
        if self._chains is None:
            chains = []
            for i in range(max(1, ctx.n_workers)):
                ch = self._new_chain(first=(i == 0))
                if self._advance(ctx, ch, None) is not None:
                    chains.append(ch)
            self._chains = chains
        while self._chains:
            ctx.checkpoint(self)
            batch = [self._pending(ch) for ch in self._chains]
            costs = ctx.measure_many(batch)  # raises BudgetExhausted at the limit
            cost_of = {s.key(): c for s, c in zip(batch, costs)}
            self._chains = [
                ch for ch, s in zip(self._chains, batch)
                if self._advance(ctx, ch, cost_of[s.key()]) is not None
            ]


class GeneticTuner(Tuner):
    """GA over exponent vectors; mutation = one MDP move, crossover =
    per-dimension-row factor-list swap (keeps products exact).  The
    population is instance state so a snapshot restores the exact gene
    pool the interrupted generation was breeding from."""

    name = "genetic"

    def __init__(self, space, cost, seed: int = 0, pop: int = 32,
                 elite: int = 8, mut_p: float = 0.6):
        super().__init__(space, cost, seed)
        self.pop_size, self.elite, self.mut_p = pop, elite, mut_p
        self._pop: Optional[list[tuple[float, State]]] = None

    # -- crash-safe resume ---------------------------------------------------
    def state_dict(self) -> dict:
        d = super().state_dict()
        d["pop"] = (
            None
            if self._pop is None
            else [[encode_cost(c), s.as_lists()] for c, s in self._pop]
        )
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        pop = state["pop"]
        self._pop = (
            None
            if pop is None
            else [
                (decode_cost(c), self.space.state_from_lists(rows))
                for c, rows in pop
            ]
        )

    def _crossover(self, a: State, b: State) -> State:
        rows_a, rows_b = a.as_lists(), b.as_lists()
        child = [
            rows_a[d] if self.rng.random() < 0.5 else rows_b[d]
            for d in range(len(rows_a))
        ]
        return self.space.state_from_lists(child)

    def _mutate(self, s: State) -> State:
        neigh = self.space.neighbors(s)
        return self.rng.choice(neigh) if neigh else s

    def _measure_fresh(self, ctx: TuningContext,
                       cands: list[State]) -> list[tuple[float, State]]:
        """Batch-measure the unvisited, intra-batch-unique candidates."""
        fresh: list[State] = []
        keys: set[str] = set()
        for s in cands:
            if not ctx.seen(s) and s.key() not in keys:
                fresh.append(s)
                keys.add(s.key())
        if not fresh:
            return []
        costs = ctx.measure_many(fresh)
        return list(zip(costs, fresh))

    def run(self, ctx: TuningContext) -> None:
        if self._pop is None:
            seeds = [self.space.initial_state()] + [
                self.space.random_state(self.rng) for _ in range(self.pop_size - 1)
            ]
            self._pop = self._measure_fresh(ctx, seeds)
        while not ctx.done():
            ctx.checkpoint(self)
            pop = self._pop
            pop.sort(key=lambda t: t[0])
            elites = pop[: self.elite]
            children: list[State] = []
            attempts = 0
            while len(children) < self.pop_size and attempts < 20 * self.pop_size:
                attempts += 1
                pa = self.rng.choice(elites)[1]
                pb = self.rng.choice(elites)[1]
                ch = self._crossover(pa, pb)
                if self.rng.random() < self.mut_p:
                    ch = self._mutate(ch)
                if self.space.is_legitimate(ch) and not ctx.seen(ch):
                    children.append(ch)
            nxt = list(elites)
            measured = self._measure_fresh(ctx, children)
            nxt.extend(measured)
            if not measured:  # converged population: inject fresh genes
                for _ in range(self.pop_size):
                    s = self.space.random_state(self.rng)
                    if not ctx.seen(s):
                        nxt.append((ctx.measure(s), s))
                        break
            self._pop = nxt
