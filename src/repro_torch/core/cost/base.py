"""Cost-backend protocol — the paper's "run the configuration on target
hardware" abstraction (TVM measure).  A backend times one op's schedule
states (``backend.op``, derived from its space) and returns seconds per
kernel invocation; ``math.inf`` marks a configuration that fails to
build or launch, matching how TVM reports failed measurements.

Backends expose ``cost(s)`` (one state) and ``batch_cost(states)`` (a
wave of the measurement engine's lanes).  Whatever the override,
``batch_cost(states)[i]`` must equal ``cost(states[i])`` for a fresh
backend — batching changes time accounting, never values.
"""

from __future__ import annotations

import abc
import math
import time
from typing import Sequence

from ..space import SearchSpace, State

__all__ = ["CostBackend", "CountingCost", "SleepingCost"]


class CostBackend(abc.ABC):
    """Measures ``cost(s; m, k, n, d_m, d_k, d_n)`` (paper Sec. 3.3)."""

    name: str = "base"

    def __init__(self, space: SearchSpace, n_repeats: int = 1, dtype: str = "bfloat16"):
        self.space = space
        # paper: "arithmetic mean for 10 repeated trials"
        self.n_repeats = n_repeats
        # the input type the op runs in: its kernels and their rules differ
        self.dtype = dtype

    @property
    def op(self) -> str:
        """Which operator this backend times (journal/cache scoping)."""
        return getattr(self.space, "op", "gemm")

    @abc.abstractmethod
    def cost_once(self, s: State, repeat_idx: int) -> float:
        ...

    def cost(self, s: State) -> float:
        if not self.space.is_legitimate(s):
            return math.inf
        total = 0.0
        for r in range(self.n_repeats):
            c = self.cost_once(s, r)
            if not math.isfinite(c):
                return math.inf
            total += c
        return total / self.n_repeats

    def batch_cost(self, states: Sequence[State]) -> list[float]:
        """Measure a batch; value-equivalent to ``[cost(s) for s in states]``."""
        return [self.cost(s) for s in states]

    def measure_fingerprint(self) -> str:
        """Identifies the backend's *measurement settings* (not just its
        name), so persistent caches never serve a cost measured under
        different settings as if it were this backend's measurement."""
        return f"r{self.n_repeats}" + self.space_fingerprint()

    def space_fingerprint(self) -> str:
        """Fingerprint component for non-default space construction
        kwargs (``SearchSpace.spec_kwargs``); empty kwargs add nothing,
        keeping GEMM fingerprints equal to the JAX package's."""
        kw = getattr(self.space, "spec_kwargs", dict)() or {}
        if not kw:
            return ""
        return "|" + ",".join(f"{k}={v!r}" for k, v in sorted(kw.items()))


class CountingCost(CostBackend):
    """Wraps another backend, counting measurements and charging a
    simulated wall-clock per trial (codegen + upload + launch overhead
    plus the timeout-capped runtime), in waves of ``n_workers`` lanes
    whose clock advances by each wave's *maximum* lane time."""

    def __init__(
        self,
        inner: CostBackend,
        simulated_overhead_s: float = 0.35,
        timeout_s: float = 4.0,
        n_workers: int = 1,
    ):
        super().__init__(inner.space, n_repeats=1, dtype=inner.dtype)
        self.inner = inner
        self.name = f"counting({inner.name})"
        self.n_measured = 0
        self.simulated_clock_s = 0.0
        self.simulated_overhead_s = simulated_overhead_s
        self.timeout_s = timeout_s
        self.n_workers = max(1, n_workers)

    def cost_once(self, s: State, repeat_idx: int) -> float:  # pragma: no cover
        raise RuntimeError("CountingCost delegates via cost()")

    def _lane_s(self, c: float) -> float:
        t = self.simulated_overhead_s
        if math.isfinite(c):
            t += min(c * self.inner.n_repeats, self.timeout_s)
        return t

    def cost(self, s: State) -> float:
        c = self.inner.cost(s)
        self.n_measured += 1
        self.simulated_clock_s += self._lane_s(c)
        return c

    def batch_cost(self, states: Sequence[State]) -> list[float]:
        out: list[float] = []
        for i in range(0, len(states), self.n_workers):
            wave = states[i : i + self.n_workers]
            costs = self.inner.batch_cost(wave)
            self.n_measured += len(wave)
            self.simulated_clock_s += max(self._lane_s(c) for c in costs)
            out.extend(costs)
        return out


class SleepingCost(CostBackend):
    """Returns the inner backend's costs but occupies ``delay_s`` of real
    wall clock per measurement, as a device occupies a measurement lane:
    it gives an interrupt a window to land in mid-search (the tune CLI's
    ``--measure-delay``).  The JAX package's class of this name also
    injects lane failures; that part is not ported yet."""

    def __init__(self, inner: CostBackend, delay_s: float = 0.05):
        super().__init__(inner.space, n_repeats=1, dtype=inner.dtype)
        self.inner = inner
        self.name = f"sleeping({inner.name})"
        self.delay_s = delay_s

    def cost_once(self, s: State, repeat_idx: int) -> float:  # pragma: no cover
        raise RuntimeError("SleepingCost delegates via cost()")

    def cost(self, s: State) -> float:
        time.sleep(self.delay_s)
        return self.inner.cost(s)

    def measure_fingerprint(self) -> str:
        # sleeping changes lane occupancy, never the measured value
        return self.inner.measure_fingerprint()
