"""Failure taxonomy and retry policy for the measurement stack.

Every lane failure gets a ``kind``.  *Transient* kinds (worker crash,
lane timeout, spawn failure, corrupt result) say nothing about the
schedule and may be retried; *permanent* kinds (deterministic raise,
failed build, static-illegal) are properties of the schedule and are
exactly as cacheable as a runtime.  :class:`RetryPolicy` is how
:class:`~repro_torch.core.measure.MeasureEngine` re-queues transient
failures into later waves, with exponential backoff and deterministic
jitter (hashed from seed/state/attempt, so two runs with the same seed
charge the same clock).  :class:`FaultPlan` / :class:`FaultInjectionCost`
are a seeded, picklable schedule of crash/hang/raise/outlier/corrupt
faults wrapped around any backend: which states fault is a pure function
of ``(plan.seed, state.key())``, and whether a transient fault fires
again on retry is tracked in a shared ``fault_dir`` on disk, so a plan
behaves the same across process boundaries and across an interrupted
and resumed session.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional, Sequence

from .cost.base import CostBackend, backend_from_spec
from .space import State

__all__ = [
    "TRANSIENT_KINDS",
    "PERMANENT_KINDS",
    "classify_error",
    "RetryPolicy",
    "FaultPlan",
    "FaultInjectionCost",
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


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of measurement faults.

    Each state's fate is a pure function of ``(seed, state.key())``: one
    uniform draw is partitioned into probability bands, so raising any
    single probability never reshuffles which states take the *other*
    fault kinds.  Kinds:

    * ``crash``   — the measuring process hard-exits (transient);
    * ``hang``    — sleeps ``hang_s`` to trip the lane timeout (transient);
    * ``raise``   — deterministic exception, fires on *every* attempt
      (permanent — retrying a schedule that always raises is futile);
    * ``outlier`` — correct value after an extra ``outlier_s`` of lane
      wall (a straggler, not a failure);
    * ``corrupt`` — returns an invalid (negative) cost (transient).

    ``fires`` bounds how many times each planned *transient* fault
    actually triggers (then the state measures cleanly — the retry-able
    scenario); ``-1`` means every attempt (the exhaustion scenario).
    """

    seed: int = 0
    p_crash: float = 0.0
    p_hang: float = 0.0
    p_raise: float = 0.0
    p_outlier: float = 0.0
    p_corrupt: float = 0.0
    hang_s: float = 30.0
    outlier_s: float = 1.0
    fires: int = 1

    def fault_for(self, state_key: str) -> Optional[str]:
        """The fault kind planned for this state, or None."""
        u = _unit_hash("fault", self.seed, state_key)
        for kind, p in (
            ("crash", self.p_crash),
            ("hang", self.p_hang),
            ("raise", self.p_raise),
            ("outlier", self.p_outlier),
            ("corrupt", self.p_corrupt),
        ):
            if u < p:
                return kind
            u -= p
        return None

    def as_kwargs(self) -> dict:
        return dataclasses.asdict(self)


def _fault_injection_from_spec(
    inner: tuple, plan: dict, fault_dir: str, delay_s: float
) -> "FaultInjectionCost":
    return FaultInjectionCost(
        backend_from_spec(tuple(inner)),
        FaultPlan(**plan),
        fault_dir=fault_dir,
        delay_s=delay_s,
    )


class FaultInjectionCost(CostBackend):
    """Wraps any backend with a :class:`FaultPlan`.

    Transient fire counts live as files under ``fault_dir`` (one
    append-only counter file per faulting state), so "this crash already
    fired" is shared across worker processes and survives a session
    restart — which is what makes a faulted run deterministic end to
    end.  ``delay_s`` adds real lane occupancy per measurement (the
    :class:`~repro_torch.core.cost.base.SleepingCost` role) so process-lane
    tests and benchmarks have a wall-clock to overlap.

    Values are untouched (an outlier is slow, not wrong), so the
    measurement fingerprint delegates to the inner backend and journal
    rows stay interchangeable with fault-free runs.
    """

    def __init__(
        self,
        inner: CostBackend,
        plan: FaultPlan,
        fault_dir: str,
        delay_s: float = 0.0,
    ):
        super().__init__(inner.space, n_repeats=1, dtype=inner.dtype)
        self.inner = inner
        self.plan = plan
        self.fault_dir = fault_dir
        self.delay_s = delay_s
        self.name = f"faulty({inner.name})"

    def cost_once(self, s: State, repeat_idx: int) -> float:  # pragma: no cover
        raise RuntimeError("FaultInjectionCost delegates via cost()")

    def _should_fire(self, state_key: str) -> bool:
        """Consume one fire from this state's budget (True = fault now).
        One byte is appended to the state's counter file per consumed
        fire; O_APPEND keeps concurrent workers from double-counting."""
        if self.plan.fires < 0:
            return True
        if self.plan.fires == 0:
            return False
        os.makedirs(self.fault_dir, exist_ok=True)
        digest = hashlib.blake2b(state_key.encode("utf-8"), digest_size=10).hexdigest()
        path = os.path.join(self.fault_dir, f"fire_{digest}")
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            fired_before = os.fstat(fd).st_size
            if fired_before >= self.plan.fires:
                return False
            os.write(fd, b"x")
            return True
        finally:
            os.close(fd)

    def cost(self, s: State) -> float:
        key = s.key()
        kind = self.plan.fault_for(key)
        if self.delay_s:
            time.sleep(self.delay_s)
        if kind == "raise":
            # deterministic: the schedule itself is broken, every attempt
            # fails identically — the permanent arm of the taxonomy
            raise RuntimeError(f"injected permanent failure for {key}")
        if kind is not None and self._should_fire(key):
            if kind == "crash":
                os._exit(13)  # simulated segfault: no exception, no cleanup
            if kind == "hang":
                time.sleep(self.plan.hang_s)  # trips the per-lane timeout
            elif kind == "outlier":
                time.sleep(self.plan.outlier_s)  # straggler: slow, then correct
            elif kind == "corrupt":
                return -1.0  # impossible runtime: engine flags it transient
        return self.inner.cost(s)

    def batch_cost(self, states: Sequence[State]) -> list[float]:
        return [self.cost(s) for s in states]

    def measure_fingerprint(self) -> str:
        # faults change availability/occupancy, never the measured value
        return self.inner.measure_fingerprint()

    def worker_spec(self) -> Optional[tuple[str, dict]]:
        inner_spec = self.inner.worker_spec()
        if inner_spec is None:
            return None
        return (
            "repro_torch.core.fault:_fault_injection_from_spec",
            {
                "inner": inner_spec,
                "plan": self.plan.as_kwargs(),
                "fault_dir": self.fault_dir,
                "delay_s": self.delay_s,
            },
        )
