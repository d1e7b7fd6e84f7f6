"""Measurement lane executors — how a wave of candidate states runs.

Only the simulated lane is ported: :class:`SimulatedExecutor` measures in
the calling thread (a single-miss wave takes the backend's scalar
``cost`` path, a multi-miss wave takes ``batch_cost``) and lane
occupancy is *modeled* by the engine (overhead + capped runtime), which
keeps every ``n_workers=1`` parity guarantee with the JAX package.  One
process drives the card, so no real lanes share it.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional, Sequence

from .cost.base import CostBackend
from .space import State

__all__ = ["LaneExecutor", "LaneResult", "SimulatedExecutor"]


@dataclasses.dataclass
class LaneResult:
    """What one measurement lane hands back for one state."""

    cost: float
    error: Optional[str] = None  # raised-exception note
    #: failure taxonomy (see ``repro_torch.core.fault``); ``None`` on
    #: success, classified by the engine from ``error`` when unset
    kind: Optional[str] = None


class LaneExecutor(abc.ABC):
    """Runs the cache-miss portion of one measurement wave."""

    name: str = "base"

    @abc.abstractmethod
    def run_wave(
        self, backend: CostBackend, states: Sequence[State]
    ) -> list[LaneResult]:
        """Measure ``states`` (one per lane); results align with input."""


class SimulatedExecutor(LaneExecutor):
    """In-thread lanes with modeled occupancy.

    Unlike the JAX package's lane, a backend exception is not turned into
    an ``inf`` trial: it ends the session.  The measured backend returns
    ``inf`` itself for a schedule the kernel refuses; anything it raises
    is a failed build or launch, after which the CUDA context cannot be
    trusted, so carrying on would only charge wrong costs."""

    name = "sim"

    def run_wave(self, backend, states):
        if len(states) == 1:
            return [LaneResult(cost=backend.cost(states[0]))]
        return [LaneResult(cost=c) for c in backend.batch_cost(states)]
