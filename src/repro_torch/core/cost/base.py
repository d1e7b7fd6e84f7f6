"""Cost-backend protocol — the paper's "run the configuration on target
hardware" abstraction (TVM measure).  A backend times one op's schedule
states (``backend.op``, derived from its space) and returns seconds per
kernel invocation; ``math.inf`` marks a configuration that fails to
build or launch, matching how TVM reports failed measurements.

Backends expose ``cost(s)`` (one state) and ``batch_cost(states)`` (a
wave of the measurement engine's lanes).  Whatever the override,
``batch_cost(states)[i]`` must equal ``cost(states[i])`` for a fresh
backend — batching changes time accounting, never values.

For process-backed measurement lanes
(:class:`~repro_torch.core.executor.ProcessExecutor`) a backend also
advertises a **worker spec**: a picklable ``("module:callable",
kwargs)`` recipe that a worker process rebuilds an equivalent backend
from (the backend itself, with its operands on the card, is never
pickled).  ``worker_spec()`` returns ``None`` for a backend that cannot
be shipped.
"""

from __future__ import annotations

import abc
import importlib
import math
import operator
import os
import time
import zlib
from typing import Optional, Sequence

import numpy as np

from ..space import SearchSpace, State

__all__ = [
    "CostBackend", "CountingCost", "SleepingCost", "backend_from_spec",
    "lognormal_noise",
]


def backend_from_spec(spec: tuple[str, dict]) -> "CostBackend":
    """Rebuild a backend from a :meth:`CostBackend.worker_spec` recipe —
    the worker-process side of the executor boundary."""
    entry, kwargs = spec
    mod_name, _, attr = entry.partition(":")
    fn = operator.attrgetter(attr)(importlib.import_module(mod_name))
    return fn(**kwargs)


def lognormal_noise(seed: int, state_key: str, repeat_idx: int, sigma: float) -> float:
    """The analytical models' deterministic per-(state, repeat)
    measurement jitter: a lognormal factor drawn from a generator seeded
    by a CRC of ``seed|state_key|repeat_idx`` (stable across processes,
    where ``hash()`` is salted), the JAX package's draw bit for bit."""
    h = zlib.crc32(f"{seed}|{state_key}|{repeat_idx}".encode()) & 0xFFFFFFFF
    return np.random.default_rng(h).lognormal(0.0, sigma)


def space_spec(space: SearchSpace) -> Optional[dict]:
    """The picklable description a worker rebuilds ``space`` from (see
    :func:`space_from_spec`), or ``None`` when it carries a closure."""
    kw = space.spec_kwargs()
    if kw is None:
        return None
    return {"op": space.op, "dims": list(space.dims),
            "depths": list(space.depths), "space_kwargs": kw}


def space_from_spec(op: str, dims: list, depths: list, space_kwargs: dict) -> SearchSpace:
    from ..ops import get_op  # lazy: the registry imports cost modules

    return get_op(op).make_space(tuple(dims), tuple(depths), **space_kwargs)


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

    def worker_spec(self) -> Optional[tuple[str, dict]]:
        """Picklable ``("module:callable", kwargs)`` recipe that rebuilds
        an equivalent backend inside a measurement worker process, or
        ``None`` when this backend cannot cross a process boundary (see
        :func:`backend_from_spec`).  The rebuilt backend must produce the
        same costs as this one."""
        return None


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

    def fraction_explored(self) -> float:
        """Measurements so far over the space's size."""
        return self.n_measured / max(1, self.space.size())


def _sleeping_from_spec(
    inner: tuple[str, dict],
    delay_s: float,
    hang_s: float,
    raise_keys: list,
    exit_keys: list,
    hang_keys: list,
) -> "SleepingCost":
    return SleepingCost(
        backend_from_spec(inner),
        delay_s=delay_s,
        hang_s=hang_s,
        raise_keys=raise_keys,
        exit_keys=exit_keys,
        hang_keys=hang_keys,
    )


class SleepingCost(CostBackend):
    """Hardware-in-the-loop stand-in: returns the inner backend's costs
    but occupies ``delay_s`` of real wall clock per measurement, as a
    device occupies a measurement lane.  Real lanes (threads, processes)
    overlap the sleeps; the simulated lane cannot.  It also gives an
    interrupt a window to land in mid-search (the tune CLI's
    ``--measure-delay``).

    Failure injection, for the executor's isolation tests: states whose
    ``key()`` is in ``raise_keys`` raise, ``exit_keys`` hard-kill the
    measuring process via ``os._exit`` (only meaningful under a
    :class:`~repro_torch.core.executor.ProcessExecutor`; in-process it
    kills the session, which is the failure process lanes exist to
    contain), and ``hang_keys`` sleep ``hang_s`` to trip the lane
    timeout.
    """

    def __init__(
        self,
        inner: CostBackend,
        delay_s: float = 0.05,
        hang_s: float = 3600.0,
        raise_keys: Sequence[str] = (),
        exit_keys: Sequence[str] = (),
        hang_keys: Sequence[str] = (),
    ):
        super().__init__(inner.space, n_repeats=1, dtype=inner.dtype)
        self.inner = inner
        self.name = f"sleeping({inner.name})"
        self.delay_s = delay_s
        self.hang_s = hang_s
        self.raise_keys = frozenset(raise_keys)
        self.exit_keys = frozenset(exit_keys)
        self.hang_keys = frozenset(hang_keys)

    def cost_once(self, s: State, repeat_idx: int) -> float:  # pragma: no cover
        raise RuntimeError("SleepingCost delegates via cost()")

    def cost(self, s: State) -> float:
        key = s.key()
        if key in self.exit_keys:
            os._exit(13)  # simulated segfault: no exception, no cleanup
        if key in self.raise_keys:
            raise RuntimeError(f"injected measurement failure for {key}")
        time.sleep(self.hang_s if key in self.hang_keys else self.delay_s)
        return self.inner.cost(s)

    def measure_fingerprint(self) -> str:
        # sleeping changes lane occupancy, never the measured value
        return self.inner.measure_fingerprint()

    def worker_spec(self) -> Optional[tuple[str, dict]]:
        inner_spec = self.inner.worker_spec()
        if inner_spec is None:
            return None
        return (
            "repro_torch.core.cost.base:_sleeping_from_spec",
            {
                "inner": inner_spec,
                "delay_s": self.delay_s,
                "hang_s": self.hang_s,
                "raise_keys": sorted(self.raise_keys),
                "exit_keys": sorted(self.exit_keys),
                "hang_keys": sorted(self.hang_keys),
            },
        )
