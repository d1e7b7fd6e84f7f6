"""Failure taxonomy and retry policy for the measurement stack.

Every lane failure gets a ``kind``.  *Transient* kinds (worker crash,
lane timeout, spawn failure, corrupt result) say nothing about the
schedule and may be retried; *permanent* kinds (deterministic raise,
failed build, static-illegal) are properties of the schedule and are
exactly as cacheable as a runtime.  :class:`RetryPolicy` is how
:class:`~repro_torch.core.measure.MeasureEngine` re-queues transient
failures into later waves, with exponential backoff and deterministic
jitter (hashed from seed/state/attempt, so two runs with the same seed
charge the same clock).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

__all__ = [
    "TRANSIENT_KINDS",
    "PERMANENT_KINDS",
    "classify_error",
    "RetryPolicy",
]


#: Failure kinds that say nothing about the schedule itself — the lane
#: died, not the candidate.  Safe to retry; never served from the
#: journal as "this config is infeasible".
TRANSIENT_KINDS = frozenset({"crash", "timeout", "spawn", "corrupt"})

#: Failure kinds that are properties of the schedule: a deterministic
#: exception from the backend, a failed build (the ``inf``-cost row), or
#: a static-analyzer rejection.
PERMANENT_KINDS = frozenset({"build", "raise", "static"})


def classify_error(error: Optional[str]) -> Optional[str]:
    """Map a free-form ``LaneResult.error`` note to a failure kind
    (``None`` for no error)."""
    if error is None:
        return None
    e = error.lower()
    if "timeout" in e:
        return "timeout"
    if "before dispatch" in e:
        return "spawn"
    if "crash" in e:
        return "crash"
    return "raise"


def _unit_hash(*parts) -> float:
    """Deterministic uniform-ish draw in ``[0, 1)`` from hashed parts."""
    h = hashlib.blake2b(
        "\x1f".join(str(p) for p in parts).encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / 2.0**64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How the engine retries transient lane failures.

    ``max_attempts`` counts *total* attempts per candidate (1 = no
    retry).  Attempt ``k``'s failure backs off
    ``backoff_s * 2**(k-1) * (1 + jitter * u)`` with ``u`` drawn
    deterministically from ``(seed, state_key, k)``."""

    max_attempts: int = 3
    backoff_s: float = 0.25
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")

    @property
    def enabled(self) -> bool:
        return self.max_attempts > 1

    def delay_s(self, state_key: str, attempt: int) -> float:
        """Backoff charged after failed attempt number ``attempt`` (1-based)."""
        base = self.backoff_s * (2.0 ** max(0, attempt - 1))
        u = _unit_hash("retry", self.seed, state_key, attempt)
        return base * (1.0 + self.jitter * u)
