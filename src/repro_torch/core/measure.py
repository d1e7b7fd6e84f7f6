"""Batched measurement engine — the caching substrate under every tuner.

:class:`MeasureEngine` measures waves of up to ``n_workers`` candidate
states on a cost backend and never re-measures a configuration it has
already seen:

  * **lanes** — a wave's duration on the search clock is the *max* of
    its lane times, not the sum; how a lane runs is delegated to a
    :class:`~repro_torch.core.executor.LaneExecutor` (the simulated,
    in-thread one here);
  * **trial cache** — an optional :class:`~repro_torch.core.records.TrialJournal`
    is consulted before dispatch, so states measured by any previous
    session for the same workload are served in zero lane time (a cache
    hit still counts as a search trial);
  * **static pre-filter** — ``analyze="warn"|"prune"`` classifies misses
    with :class:`~repro_torch.core.analysis.ScheduleAnalyzer` before they
    occupy a lane;
  * **retries** — with a :class:`~repro_torch.core.fault.RetryPolicy`,
    transient failures are re-queued with deterministic backoff.

This is the JAX package's engine without its learned proposal filter
and search sharding; with those off (their default there) the two
engines produce the same trial sequence, clock and journal bytes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

from .analysis import ScheduleAnalyzer, analyzer_for_backend, should_prune
from .cost.base import CostBackend
from .executor import LaneExecutor, LaneResult, SimulatedExecutor
from .fault import TRANSIENT_KINDS, RetryPolicy, classify_error
from .records import TrialJournal
from .space import State

__all__ = ["MeasureEngine", "MeasureOutcome", "MeasureStats"]


@dataclasses.dataclass
class MeasureOutcome:
    """One measured (or cache-served) state."""

    state: State
    cost: float
    cache_hit: bool
    lane_s: float  # modeled lane occupancy
    error: Optional[str] = None  # lane failure note
    static: Optional[str] = None  # analyzer verdict reason if pruned pre-dispatch
    kind: Optional[str] = None  # failure taxonomy (see repro_torch.core.fault)
    attempts: int = 1  # measurement attempts spent (retries included)
    #: retries exhausted on transient failures — the ``inf`` says "the
    #: lanes kept failing", NOT "this schedule is infeasible"
    failed_transient: bool = False


@dataclasses.dataclass
class MeasureStats:
    """Dispatch counters; share one instance across engines to aggregate
    a whole arch-tuning run (see ``TuningSession.tune_arch``)."""

    n_dispatched: int = 0
    n_cache_hits: int = 0
    n_waves: int = 0
    lane_busy_s: float = 0.0  # sum of per-lane occupancy
    span_s: float = 0.0  # sum of wave critical paths (what the clock pays)
    n_failures: int = 0  # lanes that failed
    trials_avoided: int = 0  # candidates pruned without occupying a lane
    n_static_flags: int = 0  # advisory verdicts (warn mode, or non-pruned WASTEFUL)
    static_s: float = 0.0  # wall seconds spent in the analyzer
    n_retries: int = 0  # transient-failure re-dispatches
    retry_backoff_s: float = 0.0  # backoff charged to the clock by retries
    n_transient_recovered: int = 0  # candidates that succeeded on a retry
    n_failed_transient: int = 0  # candidates whose retries were exhausted

    @property
    def n_measured(self) -> int:
        return self.n_dispatched + self.n_cache_hits

    def cache_hit_rate(self) -> float:
        return self.n_cache_hits / max(1, self.n_measured)


class MeasureEngine:
    """Measures batches of schedule states on a cost backend with
    ``n_workers`` lanes and an optional persistent trial cache.  Journal
    traffic is scoped to the backend's op."""

    def __init__(
        self,
        backend: CostBackend,
        n_workers: int = 1,
        journal: Optional[TrialJournal] = None,
        workload_key: Optional[str] = None,
        overhead_s: float = 0.35,
        timeout_s: float = 4.0,
        stats: Optional[MeasureStats] = None,
        executor: Optional[LaneExecutor] = None,
        analyze: str = "off",
        analyzer: Optional[ScheduleAnalyzer] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        if analyze not in ("off", "warn", "prune"):
            raise ValueError(
                f"analyze must be 'off', 'warn' or 'prune', got {analyze!r}"
            )
        self.backend = backend
        self.n_workers = max(1, int(n_workers))
        self.executor = executor if executor is not None else SimulatedExecutor()
        self.journal = journal
        self.workload_key = workload_key
        # journal entries are keyed by workload AND measurement settings:
        # a cost measured under other settings is never served as this
        # backend's measurement
        self.journal_key = (
            None
            if workload_key is None
            else f"{workload_key}?{backend.measure_fingerprint()}"
        )
        # TVM-style per-trial codegen/upload/launch charge and the
        # AutoTVM measurement timeout: the *simulated* clock's charging
        # cap — a slow config charges at most ``timeout_s``, it is never
        # killed for it
        self.overhead_s = overhead_s
        self.timeout_s = timeout_s
        self.stats = stats or MeasureStats()
        self.analyze = analyze
        self._analyzer = analyzer
        self.retry = retry if (retry is not None and retry.enabled) else None

    @property
    def analyzer(self) -> ScheduleAnalyzer:
        """The static analyzer for this backend's space/spec (built lazily
        so ``analyze='off'`` engines never pay for one)."""
        if self._analyzer is None:
            self._analyzer = analyzer_for_backend(self.backend)
        return self._analyzer

    # -- clock model ---------------------------------------------------------
    def lane_time(self, cost: float) -> float:
        """Per-lane occupancy of one measurement: fixed overhead plus the
        timeout-capped kernel runtime (failed builds charge overhead only)."""
        return self.overhead_s + (
            0.0 if math.isinf(cost) else min(cost, self.timeout_s)
        )

    # -- fault handling ------------------------------------------------------
    def _lane_kind(self, lane: LaneResult) -> Optional[str]:
        """Classify one lane result.  ``None`` means the backend judged
        the schedule (a failed build reports as ``inf`` with no error).
        A value no real measurement can produce (NaN / negative /
        non-numeric) is a ``corrupt`` transient."""
        if lane.error is not None:
            return lane.kind or classify_error(lane.error)
        try:
            c = float(lane.cost)
        except (TypeError, ValueError):
            return "corrupt"
        if math.isnan(c) or c < 0:
            return "corrupt"
        return None

    def _finalize(
        self, s: State, lane: LaneResult, kind: Optional[str],
        n_attempts: int, lane_s: float,
    ) -> MeasureOutcome:
        """Book one candidate's final verdict after any retries."""
        if kind is None:
            cost = float(lane.cost)
            if n_attempts > 1:
                self.stats.n_transient_recovered += 1
            if self.journal is not None and self.journal_key is not None:
                self.journal.record(
                    self.journal_key, s, cost, op=self.backend.op,
                    attempts=n_attempts,
                )
            return MeasureOutcome(
                s, cost, False, lane_s, None,
                kind=None if math.isfinite(cost) else "build",
                attempts=n_attempts,
            )
        self.stats.n_failures += 1
        failed_transient = kind in TRANSIENT_KINDS
        if failed_transient:
            self.stats.n_failed_transient += 1
        if (
            self.retry is not None
            and self.journal is not None
            and self.journal_key is not None
        ):
            # permanent kinds are cacheable inf rows; transient kinds are
            # audit-only rows that never enter the cost table.  Without a
            # RetryPolicy, lane failures are counted but never journaled.
            self.journal.record_failure(
                self.journal_key, s, kind, attempts=n_attempts,
                op=self.backend.op,
            )
        return MeasureOutcome(
            s, math.inf, False, lane_s, lane.error, kind=kind,
            attempts=n_attempts, failed_transient=failed_transient,
        )

    # -- dispatch ------------------------------------------------------------
    def measure_wave(self, states: Sequence[State]) -> list[MeasureOutcome]:
        """Measure up to ``n_workers`` states as one wave.  Journal hits
        are served without touching the backend; misses go to the
        backend and are journaled."""
        if len(states) > self.n_workers:
            raise ValueError(
                f"wave of {len(states)} states exceeds {self.n_workers} lanes"
            )
        outcomes: list[Optional[MeasureOutcome]] = [None] * len(states)
        miss_idx: list[int] = []
        n_hits = 0
        for i, s in enumerate(states):
            cached = None
            if self.journal is not None and self.journal_key is not None:
                cached = self.journal.get(
                    self.journal_key, s.key(), op=self.backend.op
                )
            if cached is not None:
                outcomes[i] = MeasureOutcome(s, cached, True, 0.0)
                n_hits += 1
            else:
                miss_idx.append(i)
        if miss_idx and self.analyze != "off":
            # static pre-filter: provably-bad candidates are rejected
            # launch-free in prune mode and journaled as audit rows
            t0 = time.perf_counter()
            kept: list[int] = []
            for i in miss_idx:
                s = states[i]
                res = self.analyzer.analyze(s)
                if self.analyze == "prune" and should_prune(res):
                    outcomes[i] = MeasureOutcome(
                        s, math.inf, False, 0.0, static=res.reason
                    )
                    self.stats.trials_avoided += 1
                    if self.journal is not None and self.journal_key is not None:
                        self.journal.record_static(
                            self.journal_key, s, res.reason, op=self.backend.op
                        )
                else:
                    if not res.ok:
                        self.stats.n_static_flags += 1
                    kept.append(i)
            miss_idx = kept
            self.stats.static_s += time.perf_counter() - t0
        if miss_idx:
            attempts = dict.fromkeys(miss_idx, 0)
            acc_lane_s = dict.fromkeys(miss_idx, 0.0)
            pending = list(miss_idx)
            while pending:
                lanes = self.executor.run_wave(
                    self.backend, [states[i] for i in pending]
                )
                nxt: list[int] = []
                for i, lane in zip(pending, lanes):
                    s = states[i]
                    attempts[i] += 1
                    kind = self._lane_kind(lane)
                    acc_lane_s[i] += self.lane_time(
                        lane.cost if kind is None else math.inf
                    )
                    if (
                        self.retry is not None
                        and kind in TRANSIENT_KINDS
                        and attempts[i] < self.retry.max_attempts
                    ):
                        delay = self.retry.delay_s(s.key(), attempts[i])
                        self.stats.n_retries += 1
                        self.stats.retry_backoff_s += delay
                        acc_lane_s[i] += delay  # charged, never slept
                        nxt.append(i)
                        continue
                    outcomes[i] = self._finalize(
                        s, lane, kind, attempts[i], acc_lane_s[i]
                    )
                pending = nxt
        done = [o for o in outcomes if o is not None]
        self.stats.n_dispatched += len(miss_idx)
        self.stats.n_cache_hits += n_hits
        self.stats.n_waves += 1
        span = max((o.lane_s for o in done), default=0.0)
        self.stats.lane_busy_s += sum(o.lane_s for o in done)
        self.stats.span_s += span
        return done
