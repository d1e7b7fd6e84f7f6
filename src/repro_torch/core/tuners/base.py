"""Tuner protocol + shared bookkeeping under the batched measurement
engine (budgets, dedup, incumbent, the simulated search clock).

Every tuner runs through the same :class:`TuningContext`, so "fraction
of configuration space explored" and "search time" are counted
identically across methods — what the paper's Figs. 7–8 plot.  Tuners
propose candidate *batches* and call :meth:`TuningContext.measure_many`,
which dedups against the visited table, slices fresh states into waves
of ``n_workers``, charges one trial per fresh state (capping the final
wave at the budget), advances the clock by each wave's critical path,
tracks the incumbent, and raises :class:`BudgetExhausted` when the
budget is spent.  At the top of each proposal round a tuner calls
:meth:`TuningContext.checkpoint`, where a session-installed callback may
snapshot the search (``Tuner.state_dict`` plus :meth:`TuningContext.snapshot`)
for a crash-safe resume (the learned filter's cadence included).  The
trial sequence and the snapshot bytes are the JAX package's.
"""

from __future__ import annotations

import abc
import dataclasses
import math
import random
import time
from typing import Callable, Optional, Sequence

from ..cost.base import CostBackend
from ..measure import MeasureEngine
from ..shard import ShardSpec
from ..space import SearchSpace, State

__all__ = [
    "Budget",
    "Trial",
    "TuneResult",
    "TuningContext",
    "Tuner",
    "BudgetExhausted",
    "encode_cost",
    "decode_cost",
]


def encode_cost(c: float) -> Optional[float]:
    """JSON-safe cost: ``inf`` (a failure) round-trips as ``null`` —
    same convention as the journal's fail rows."""
    return c if math.isfinite(c) else None


def decode_cost(c: Optional[float]) -> float:
    return math.inf if c is None else float(c)


@dataclasses.dataclass
class Budget:
    """Stop conditions; any satisfied one ends the search (paper: T_max)."""

    max_trials: Optional[int] = None
    max_time_s: Optional[float] = None
    max_fraction: Optional[float] = None  # of space.size(), e.g. 0.001

    def resolve_trials(self, space_size: int) -> int:
        n = self.max_trials if self.max_trials is not None else space_size
        if self.max_fraction is not None:
            n = min(n, max(1, int(space_size * self.max_fraction)))
        return n


@dataclasses.dataclass
class Trial:
    state: State
    cost: float
    index: int
    clock_s: float  # simulated search clock at measurement time


@dataclasses.dataclass
class TuneResult:
    tuner: str
    best_state: Optional[State]
    best_cost: float
    trials: list[Trial]
    n_trials: int
    fraction: float
    wall_s: float
    clock_s: float
    n_workers: int = 1
    n_cache_hits: int = 0  # trials served from the persistent journal
    executor: str = "sim"  # lane executor the engine measured through

    @property
    def cache_hit_rate(self) -> float:
        return self.n_cache_hits / max(1, self.n_trials)

    def best_curve(self) -> list[tuple[int, float]]:
        """(n_trials, best_cost_so_far) — the paper's Fig. 7a series."""
        out, best = [], math.inf
        for t in self.trials:
            best = min(best, t.cost)
            out.append((t.index + 1, best))
        return out

    def best_time_curve(self) -> list[tuple[float, float]]:
        """(clock_s, best_cost_so_far) — the paper's Fig. 7b series."""
        out, best = [], math.inf
        for t in self.trials:
            best = min(best, t.cost)
            out.append((t.clock_s, best))
        return out


class BudgetExhausted(Exception):
    pass


class TuningContext:
    """Search-side measurement broker: dedups states, charges the budget,
    tracks the incumbent, and drives the engine's measurement waves.
    Raising :class:`BudgetExhausted` unwinds the tuner."""

    def __init__(
        self,
        space: SearchSpace,
        cost: CostBackend,
        budget: Budget,
        n_workers: Optional[int] = None,
        engine: Optional[MeasureEngine] = None,
        checkpoint_fn: Optional[Callable[["Tuner", "TuningContext"], None]] = None,
        shard: Optional[ShardSpec] = None,
    ):
        self.space = space
        self.cost_backend = cost
        self.budget = budget
        self.max_trials = budget.resolve_trials(space.size())
        self.visited: dict[str, float] = {}
        self.trials: list[Trial] = []
        self.best_state: Optional[State] = None
        self.best_cost = math.inf
        self.clock_s = 0.0
        # crash-safe search state: tuners announce round boundaries via
        # checkpoint(); the session-installed callback snapshots tuner +
        # context state and may raise TuneInterrupted on SIGTERM
        self.round_idx = 0
        self._checkpoint_fn = checkpoint_fn
        if engine is None:
            engine = MeasureEngine(
                cost, n_workers=1 if n_workers is None else n_workers, shard=shard
            )
        else:
            if n_workers is not None and n_workers != engine.n_workers:
                raise ValueError(
                    f"n_workers={n_workers} conflicts with the provided "
                    f"engine's {engine.n_workers}"
                )
            if shard is not None and shard.enabled and shard != engine.shard:
                raise ValueError(
                    f"shard={shard} conflicts with the provided "
                    f"engine's {engine.shard}"
                )
        self.engine = engine
        self.n_workers = engine.n_workers
        # engine stats may be shared across contexts (tune_arch): snapshot
        # so result() reports this search's deltas only
        self._stats0 = (engine.stats.n_dispatched, engine.stats.n_cache_hits)
        self.wall_start = time.monotonic()

    # -- crash safety --------------------------------------------------------
    def checkpoint(self, tuner: "Tuner") -> None:
        """Announce a round boundary — every tuner calls this at the top
        of its proposal loop.  A consistent cut of the search lives here:
        the tuner's own state (``state_dict``) plus this context's
        visited/trials/best/clock.  The installed callback decides
        whether to snapshot and raises
        :class:`~repro_torch.core.snapshot.TuneInterrupted` after
        flushing a final snapshot when an interrupt was requested.
        No-op without a callback."""
        self.round_idx += 1
        if self._checkpoint_fn is not None:
            self._checkpoint_fn(tuner, self)

    def snapshot(self) -> dict:
        """JSON-serializable search state (the context half of a
        snapshot; the tuner half is ``Tuner.state_dict``)."""
        snap = {
            "visited": [[k, encode_cost(c)] for k, c in self.visited.items()],
            "trials": [
                [t.state.as_lists(), encode_cost(t.cost), t.clock_s]
                for t in self.trials
            ],
            "best": None if self.best_state is None else self.best_state.as_lists(),
            "best_cost": encode_cost(self.best_cost),
            "clock_s": self.clock_s,
            "round": self.round_idx,
        }
        flt = self.engine.learned_filter
        if flt is not None:
            # without this, a resumed --learned-filter run restarts the
            # retrain cadence and re-derives the model, skipping a
            # different candidate sequence than the uninterrupted run
            snap["filter"] = flt.state_dict()
        return snap

    def restore_snapshot(self, snap: dict) -> None:
        """Rebuild visited/trials/best/clock from :meth:`snapshot` output
        (states rebuilt through this context's space)."""
        self.visited = {k: decode_cost(c) for k, c in snap["visited"]}
        self.trials = [
            Trial(self.space.state_from_lists(lists), decode_cost(c), i, float(tc))
            for i, (lists, c, tc) in enumerate(snap["trials"])
        ]
        self.best_state = (
            None if snap["best"] is None
            else self.space.state_from_lists(snap["best"])
        )
        self.best_cost = decode_cost(snap["best_cost"])
        self.clock_s = float(snap["clock_s"])
        self.round_idx = int(snap.get("round", 0))
        flt = self.engine.learned_filter
        if flt is not None and "filter" in snap:  # pre-filter snapshots lack it
            flt.load_state_dict(snap["filter"])

    # -- paper bookkeeping ---------------------------------------------------
    def seen(self, s: State) -> bool:
        return s.key() in self.visited

    def done(self) -> bool:
        if len(self.trials) >= self.max_trials:
            return True
        if self.budget.max_time_s is not None and self.clock_s >= self.budget.max_time_s:
            return True
        return False

    def measure_many(self, states: Sequence[State]) -> list[float]:
        """Measure a candidate batch; returns costs aligned with
        ``states``.  Visited states and intra-batch duplicates are free;
        fresh states charge one trial each, in proposal order,
        ``n_workers`` at a time.  Raises :class:`BudgetExhausted` when
        the budget runs out mid-batch (the measured prefix is kept)."""
        fresh: list[State] = []
        fresh_keys: set[str] = set()
        for s in states:
            key = s.key()
            if key not in self.visited and key not in fresh_keys:
                fresh.append(s)
                fresh_keys.add(key)
        i = 0
        while i < len(fresh):
            if self.done():
                raise BudgetExhausted()
            room = self.max_trials - len(self.trials)
            wave = fresh[i : i + min(self.n_workers, room)]
            outcomes = self.engine.measure_wave(wave)
            self.clock_s += max(o.lane_s for o in outcomes)
            for o in outcomes:
                self.visited[o.state.key()] = o.cost
                self.trials.append(Trial(o.state, o.cost, len(self.trials), self.clock_s))
                if o.cost < self.best_cost:
                    self.best_cost, self.best_state = o.cost, o.state
            i += len(wave)
        return [self.visited[s.key()] for s in states]

    def measure(self, s: State) -> float:
        """Single-state convenience wrapper over :meth:`measure_many`."""
        return self.measure_many([s])[0]

    def result(self, tuner_name: str) -> TuneResult:
        _, h0 = self._stats0
        return TuneResult(
            tuner=tuner_name,
            best_state=self.best_state,
            best_cost=self.best_cost,
            trials=self.trials,
            n_trials=len(self.trials),
            fraction=len(self.trials) / max(1, self.space.size()),
            wall_s=time.monotonic() - self.wall_start,
            clock_s=self.clock_s,
            n_workers=self.n_workers,
            n_cache_hits=self.engine.stats.n_cache_hits - h0,
            executor=self.engine.executor.name,
        )


class Tuner(abc.ABC):
    name: str = "tuner"

    def __init__(self, space: SearchSpace, cost: CostBackend, seed: int = 0):
        self.space = space
        self.cost = cost
        self.seed = seed
        self.rng = random.Random(seed)

    @abc.abstractmethod
    def run(self, ctx: TuningContext) -> None:
        """Search until ctx.done() or BudgetExhausted."""

    # -- crash-safe resume ---------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable tuner state for crash-safe resume.  The base
        captures the RNG stream (every tuner draws from ``self.rng``);
        subclasses extend via ``super()`` with their search memory
        (frontier, population, network weights, counters).  ``run`` must
        treat restored state as already-initialized and continue from
        it."""
        st = self.rng.getstate()
        return {
            "tuner": self.name,
            "seed": self.seed,
            "rng": [st[0], list(st[1]), st[2]],
        }

    def load_state_dict(self, state: dict) -> None:
        got = state.get("tuner")
        if got is not None and got != self.name:
            raise ValueError(
                f"snapshot belongs to tuner {got!r}, cannot restore {self.name!r}"
            )
        version, internal, gauss = state["rng"]
        self.rng.setstate((version, tuple(internal), gauss))

    def tune(
        self,
        budget: Budget,
        n_workers: Optional[int] = None,  # defaults to 1 without an engine
        engine: Optional[MeasureEngine] = None,
        checkpoint_fn: Optional[Callable[["Tuner", TuningContext], None]] = None,
        restore: Optional[dict] = None,
    ) -> TuneResult:
        """Run the search.  ``checkpoint_fn`` receives ``(tuner, ctx)``
        at every round boundary (see ``TuningContext.checkpoint``);
        ``restore`` is a snapshot payload (``{"tuner_state": ...,
        "ctx": ...}``) to continue from instead of starting fresh.  A
        :class:`~repro_torch.core.snapshot.TuneInterrupted` raised by the
        callback propagates to the caller — the snapshot is already
        flushed by then."""
        ctx = TuningContext(
            self.space, self.cost, budget, n_workers=n_workers, engine=engine,
            checkpoint_fn=checkpoint_fn,
        )
        if restore is not None:
            self.load_state_dict(restore["tuner_state"])
            ctx.restore_snapshot(restore["ctx"])
        try:
            self.run(ctx)
        except BudgetExhausted:
            pass
        return ctx.result(self.name)
