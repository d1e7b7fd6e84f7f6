"""Batched measurement engine — the concurrency and caching substrate
under every tuner.

:class:`MeasureEngine` measures waves of up to ``n_workers`` candidate
states on a cost backend and never re-measures a configuration it has
already seen:

  * **lanes** — a wave's duration on the search clock is the *max* of
    its lane times, not the sum.  How a lane runs is delegated to a
    :class:`~repro_torch.core.executor.LaneExecutor`: the default
    simulated one measures in the calling thread (the ``n_workers=1``
    parity path), ``ThreadExecutor`` / ``ProcessExecutor`` measure with
    real threads or worker processes, per-lane timeouts and crash
    isolation — a dead worker is an ``inf``-cost outcome of a transient
    kind, not a dead session;
  * **trial cache** — an optional :class:`~repro_torch.core.records.TrialJournal`
    is consulted before dispatch, so states measured by any previous
    session for the same workload are served in zero lane time (a cache
    hit still counts as a search trial);
  * **auto-reload** — with ``reload_every=N``, every N waves the engine
    merges journal rows appended by sibling engines or processes sharing
    the journal file;
  * **static pre-filter** — ``analyze="warn"|"prune"`` classifies misses
    with :class:`~repro_torch.core.analysis.ScheduleAnalyzer` before they
    occupy a lane;
  * **learned filter** — with a
    :class:`~repro_torch.core.learn.ProposalFilter`, only each wave's
    predicted-best fraction of misses is measured;
  * **shard ownership** — with an enabled
    :class:`~repro_torch.core.shard.ShardSpec`, misses this engine does
    not own are deferred to the sibling shard after one journal reload;
  * **retries** — with a :class:`~repro_torch.core.fault.RetryPolicy`,
    transient failures are re-queued with deterministic backoff.

This is the JAX package's engine without its build-cache counters (the
port has no per-state build): the trial sequence, clock and journal
bytes are the same.
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
from .learn.filter import ProposalFilter
from .records import TrialJournal
from .shard import ShardSpec
from .space import State

__all__ = ["MeasureEngine", "MeasureOutcome", "MeasureStats"]


@dataclasses.dataclass
class MeasureOutcome:
    """One measured (or cache-served) state."""

    state: State
    cost: float
    cache_hit: bool
    lane_s: float  # lane occupancy: simulated model or measured wall
    error: Optional[str] = None  # lane failure note (crash/timeout)
    static: Optional[str] = None  # analyzer verdict reason if pruned pre-dispatch
    kind: Optional[str] = None  # failure taxonomy (see repro_torch.core.fault)
    attempts: int = 1  # measurement attempts spent (retries included)
    #: retries exhausted on transient failures — the ``inf`` says "the
    #: lanes kept dying", NOT "this schedule is infeasible"
    failed_transient: bool = False
    #: learned-filter skip: the model's rank score (lower = predicted
    #: better).  The ``inf`` cost means "not measured this run", NOT
    #: "infeasible" — the journal row is provenance, never a cache entry
    predicted: Optional[float] = None
    #: sharded search: this candidate belongs to a sibling shard and was
    #: not in the journal yet — the ``inf`` cost means "the sibling owns
    #: it", never "infeasible"; nothing is journaled for it here
    deferred: bool = False


@dataclasses.dataclass
class MeasureStats:
    """Dispatch counters; share one instance across engines to aggregate
    a whole arch-tuning run (see ``TuningSession.tune_arch``)."""

    n_dispatched: int = 0
    n_cache_hits: int = 0
    n_waves: int = 0
    lane_busy_s: float = 0.0  # sum of per-lane occupancy
    span_s: float = 0.0  # sum of wave critical paths (what the clock pays)
    n_failures: int = 0  # lanes that crashed / timed out / raised
    # -- journal auto-reload (mid-search sibling merging) --------------------
    n_journal_reloads: int = 0
    n_journal_rows_merged: int = 0  # sibling rows ingested mid-search
    # -- static pre-filter (see repro_torch.core.analysis; zero with analyze=off) --
    trials_avoided: int = 0  # candidates rejected without occupying a lane
    n_static_flags: int = 0  # advisory verdicts (warn mode, or non-pruned WASTEFUL)
    static_s: float = 0.0  # wall seconds spent in the analyzer
    # -- learned proposal filter (see repro_torch.core.learn; zero without one) ----
    trials_avoided_learned: int = 0  # candidates skipped on a model's say-so
    n_learned_retrains: int = 0  # mid-search refits from fresh journal rows
    learn_s: float = 0.0  # wall seconds spent scoring + retraining
    # -- sharded search (see repro_torch.core.shard; zero without a ShardSpec) -----
    n_deferred_to_sibling: int = 0  # non-owned misses left to a sibling shard
    n_served_by_sibling: int = 0  # non-owned candidates served from the journal
    # -- fault tolerance (see repro_torch.core.fault; zero without a RetryPolicy) --
    n_retries: int = 0  # transient-failure re-dispatches
    retry_backoff_s: float = 0.0  # backoff charged to the clock by retries
    n_transient_recovered: int = 0  # candidates that succeeded on a retry
    #: candidates whose retries were exhausted on transient failures —
    #: distinct from infeasible: the lanes kept dying, the schedule was
    #: never actually judged (these are counted inside ``n_failures`` too)
    n_failed_transient: int = 0
    n_stragglers: int = 0  # lanes ≥ straggler_factor × wave median wall
    n_respawns: int = 0  # worker processes respawned after a death
    n_spare_adoptions: int = 0  # deaths absorbed by a pre-warmed spare worker
    n_degraded_lanes: int = 0  # lanes that fell back to in-thread measurement

    @property
    def n_measured(self) -> int:
        return self.n_dispatched + self.n_cache_hits

    def cache_hit_rate(self) -> float:
        return self.n_cache_hits / max(1, self.n_measured)


class MeasureEngine:
    """Measures batches of schedule states on a cost backend with
    ``n_workers`` parallel lanes and an optional persistent trial cache.
    Journal traffic is scoped to the backend's op, so engines for
    different operators can share one journal file safely."""

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
        reload_every: int = 0,
        analyze: str = "off",
        analyzer: Optional[ScheduleAnalyzer] = None,
        retry: Optional[RetryPolicy] = None,
        straggler_factor: float = 8.0,
        learned_filter: Optional[ProposalFilter] = None,
        shard: Optional[ShardSpec] = None,
    ):
        if analyze not in ("off", "warn", "prune"):
            raise ValueError(
                f"analyze must be 'off', 'warn' or 'prune', got {analyze!r}"
            )
        self.backend = backend
        self.n_workers = max(1, int(n_workers))
        # how a lane runs: simulated (default, bit-identical to the
        # historical path) or real threads/processes; the engine never
        # closes it — lifetime belongs to whoever built it
        self.executor = executor if executor is not None else SimulatedExecutor()
        self.journal = journal
        self.workload_key = workload_key
        # Journal entries are keyed by workload AND measurement settings:
        # a cost measured under different noise/repeats must never be
        # served as this backend's measurement.
        self.journal_key = (
            None
            if workload_key is None
            else f"{workload_key}?{backend.measure_fingerprint()}"
        )
        # TVM-style per-trial codegen/upload/launch charge and the
        # AutoTVM measurement timeout (a pathological config charges at
        # most ``timeout_s`` of lane time, see TuningContext)
        self.overhead_s = overhead_s
        self.timeout_s = timeout_s
        self.stats = stats or MeasureStats()
        # auto-reload cadence: every ``reload_every`` waves the journal
        # merges rows appended by sibling engines/processes, so
        # concurrent searches serve each other's fresh measurements
        # mid-search instead of re-measuring (0 disables)
        self.reload_every = max(0, int(reload_every))
        self._waves_since_reload = 0
        # static pre-filter mode: "off" never consults the analyzer (the
        # historical bit-identical path), "warn" classifies misses and
        # counts advisory flags, "prune" rejects provably-bad candidates
        # before they occupy a lane (journaled as audit rows, counted in
        # trials_avoided; the trial is still charged by TuningContext)
        self.analyze = analyze
        self._analyzer = analyzer
        # fault tolerance: with a RetryPolicy, transient lane failures
        # (crash/timeout/spawn/corrupt — see repro_torch.core.fault) are
        # re-dispatched with backoff instead of surfacing inf to the
        # tuner; None keeps the historical fail-fast semantics exactly
        self.retry = retry if (retry is not None and retry.enabled) else None
        # a successful lane whose wall exceeds straggler_factor × the
        # wave median is counted in stats.n_stragglers (real executors
        # with ≥3 lanes only — detection, not re-measurement)
        self.straggler_factor = straggler_factor
        # learned proposal filter: with a ProposalFilter, each wave's
        # cache-missing candidates are scored by the journal-trained
        # rank model and only the predicted-best fraction is really
        # measured (skips journal as {"c": null, "pred": score}
        # provenance rows); None keeps the historical path bit-identical
        self.learned_filter = learned_filter
        # sharded search: with an enabled ShardSpec, cache misses this
        # engine does not own (see repro_torch.core.shard.shard_of) become
        # deferred outcomes served later by the sibling's journal rows
        # instead of occupying a lane.  A 1-shard spec normalizes to
        # None so the default path stays bit-identical.
        if shard is not None and not shard.enabled:
            shard = None
        if shard is not None and (journal is None or self.journal_key is None):
            raise ValueError(
                "sharded measurement needs a shared journal and a "
                "workload key (deferred candidates are served by the "
                "sibling's journal rows)"
            )
        self.shard = shard

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

    # -- sharding ------------------------------------------------------------
    def _shard_tag(self) -> Optional[tuple[int, int]]:
        """Journal provenance for measured rows: ``(index, count)`` when
        sharding is active, None otherwise (rows stay byte-identical to
        the unsharded format)."""
        if self.shard is None:
            return None
        return (self.shard.index, self.shard.count)

    # -- fault handling ------------------------------------------------------
    def _lane_kind(self, lane: LaneResult) -> Optional[str]:
        """Classify one lane result.  ``None`` means the backend actually
        judged the schedule (including a failed build, which reports as
        ``inf`` cost with no error).  A lane that hands back a value no
        real measurement can produce (NaN / negative / non-numeric) is a
        ``corrupt`` transient — journaling it would poison the cache."""
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
                    attempts=n_attempts, shard=self._shard_tag(),
                )
            return MeasureOutcome(
                s, cost, False, lane_s, None,
                kind=None if math.isfinite(cost) else "build",
                attempts=n_attempts,
            )
        # executor-level failure (crash/timeout/spawn/raise/corrupt)
        self.stats.n_failures += 1
        failed_transient = kind in TRANSIENT_KINDS
        if failed_transient:
            self.stats.n_failed_transient += 1
        if (
            self.retry is not None
            and self.journal is not None
            and self.journal_key is not None
        ):
            # failure provenance: permanent kinds are cacheable inf rows;
            # transient kinds are audit-only rows that never enter the
            # cost table — a worker death must not be cached as "this
            # config is infeasible".  Without a RetryPolicy the
            # historical contract holds: executor failures are counted
            # but never journaled.
            self.journal.record_failure(
                self.journal_key, s, kind, attempts=n_attempts,
                op=self.backend.op, shard=self._shard_tag(),
            )
        return MeasureOutcome(
            s, math.inf, False, lane_s, lane.error, kind=kind,
            attempts=n_attempts, failed_transient=failed_transient,
        )

    def _note_stragglers(self, lanes: Sequence[LaneResult]) -> None:
        """Count successful lanes whose measured wall dwarfs the wave
        median (preempted host, contended device).  Detection only — the
        value is kept; re-measuring belongs to a noise model, not here."""
        if not self.executor.real_time or len(lanes) < 3:
            return
        walls = sorted(l.wall_s for l in lanes if l.error is None)
        if len(walls) < 3:
            return
        # true median: even-length waves average the two middle walls —
        # taking the upper element alone biased the threshold high and
        # misclassified borderline lanes on 4-lane waves
        n = len(walls)
        if n % 2:
            med = walls[n // 2]
        else:
            med = 0.5 * (walls[n // 2 - 1] + walls[n // 2])
        if med <= 0.0:
            return
        for l in lanes:
            if (
                l.error is None
                and l.wall_s > self.straggler_factor * med
                and l.wall_s > 0.05
            ):
                self.stats.n_stragglers += 1

    # -- dispatch ------------------------------------------------------------
    def measure_wave(self, states: Sequence[State]) -> list[MeasureOutcome]:
        """Measure up to ``n_workers`` states as one concurrent wave.

        Journal hits are served without touching the backend and occupy a
        lane for zero time; misses go to the backend — via its batched API
        when the wave has more than one miss — and are journaled so future
        sessions (or other workloads sharing the journal) hit the cache.
        """
        if len(states) > self.n_workers:
            raise ValueError(
                f"wave of {len(states)} states exceeds {self.n_workers} lanes"
            )
        if self.journal is not None and self.reload_every:
            self._waves_since_reload += 1
            if self._waves_since_reload >= self.reload_every:
                # merge rows appended by sibling engines/processes since
                # the last read, *before* the cache lookup below — a
                # sibling's fresh measurement serves this wave for free
                self._waves_since_reload = 0
                self.stats.n_journal_reloads += 1
                self.stats.n_journal_rows_merged += self.journal.reload()
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
                if self.shard is not None and not self.shard.owns(
                    self.journal_key, s.key()
                ):
                    # a hit on a candidate we don't own: the sibling's
                    # measurement (merged by an earlier reload) served it
                    self.stats.n_served_by_sibling += 1
            else:
                miss_idx.append(i)
        if miss_idx and self.analyze != "off":
            # static pre-filter: classify every miss before it occupies a
            # lane; provably-bad candidates (ILLEGAL, or degenerate
            # WASTEFUL) are rejected launch-free in prune mode and
            # journaled as audit rows, anything else merely flagged
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
        if self.learned_filter is not None and len(miss_idx) >= 2:
            # learned proposal filter: retrain at its cadence from the
            # journal rows accumulated so far (this very search's rows
            # included), then measure only the wave's predicted-best
            # fraction.  A skip is an inf outcome carrying the score and
            # a {"c": null, "pred": score} provenance row — never a
            # cost-table entry, so nothing downstream can ever serve the
            # guess as a measurement.  The trial is still charged by
            # TuningContext, exactly like a static prune.  Waves that
            # cannot skip anything (fully cache-served, or a single
            # miss) never reach this block, so they neither advance the
            # retrain cadence nor pay a build_dataset re-parse with
            # nothing to filter.
            flt = self.learned_filter
            learn_before = flt.learn_s
            retrains_before = flt.n_retrains
            flt.maybe_retrain()
            kept_rel, skipped_rel = flt.select([states[i] for i in miss_idx])
            for rel, score in skipped_rel:
                i = miss_idx[rel]
                s = states[i]
                outcomes[i] = MeasureOutcome(
                    s, math.inf, False, 0.0, predicted=score
                )
                self.stats.trials_avoided_learned += 1
                if self.journal is not None and self.journal_key is not None:
                    self.journal.record_predicted(
                        self.journal_key, s, score, op=self.backend.op
                    )
            miss_idx = [miss_idx[rel] for rel in kept_rel]
            self.stats.learn_s += flt.learn_s - learn_before
            self.stats.n_learned_retrains += flt.n_retrains - retrains_before
        if self.shard is not None and miss_idx:
            # shard ownership — the last funnel stage before the lanes:
            # misses this engine does not own are the sibling's to
            # measure.  One journal reload gives the sibling's fresh
            # rows a chance to serve them as free hits; whatever is
            # still missing defers (an inf outcome with zero lane time,
            # never journaled — the sibling will write the real row, and
            # the elect-and-merge step reconciles the bests at the end).
            owned = [
                i for i in miss_idx
                if self.shard.owns(self.journal_key, states[i].key())
            ]
            foreign = [i for i in miss_idx if i not in set(owned)]
            if foreign:
                self.stats.n_journal_reloads += 1
                self.stats.n_journal_rows_merged += self.journal.reload()
                for i in foreign:
                    s = states[i]
                    cached = self.journal.get(
                        self.journal_key, s.key(), op=self.backend.op
                    )
                    if cached is not None:
                        outcomes[i] = MeasureOutcome(s, cached, True, 0.0)
                        n_hits += 1
                        self.stats.n_served_by_sibling += 1
                    else:
                        outcomes[i] = MeasureOutcome(
                            s, math.inf, False, 0.0, deferred=True
                        )
                        self.stats.n_deferred_to_sibling += 1
            miss_idx = owned
        if miss_idx:
            # NOTE: self.timeout_s is the *simulated charging cap* (a slow
            # config charges at most that much search clock); the real
            # executors own their kill timeout separately — conflating the
            # two would kill legitimately slow measurements
            fault_fn = getattr(self.executor, "fault_stats", None)
            fault_before = fault_fn() if callable(fault_fn) else None
            attempts = dict.fromkeys(miss_idx, 0)
            acc_lane_s = dict.fromkeys(miss_idx, 0.0)
            pending = list(miss_idx)
            while pending:
                lanes = self.executor.run_wave(
                    self.backend, [states[i] for i in pending]
                )
                self._note_stragglers(lanes)
                nxt: list[int] = []
                backoffs: list[float] = []
                for i, lane in zip(pending, lanes):
                    s = states[i]
                    attempts[i] += 1
                    kind = self._lane_kind(lane)
                    acc_lane_s[i] += (
                        lane.wall_s
                        if self.executor.real_time
                        else self.lane_time(lane.cost if kind is None else math.inf)
                    )
                    if (
                        self.retry is not None
                        and kind in TRANSIENT_KINDS
                        and attempts[i] < self.retry.max_attempts
                    ):
                        # transient: the lane died, the schedule was never
                        # judged — re-queue into a follow-up wave with
                        # deterministic backoff instead of surfacing inf
                        delay = self.retry.delay_s(s.key(), attempts[i])
                        self.stats.n_retries += 1
                        self.stats.retry_backoff_s += delay
                        acc_lane_s[i] += delay
                        backoffs.append(delay)
                        nxt.append(i)
                        continue
                    outcomes[i] = self._finalize(
                        s, lane, kind, attempts[i], acc_lane_s[i]
                    )
                if nxt and backoffs and self.executor.real_time:
                    # the retried lanes redispatch as one wave: sleep the
                    # longest backoff for real; simulated lanes only
                    # charged it to the clock above
                    time.sleep(max(backoffs))
                pending = nxt
            if fault_before is not None:
                after = fault_fn()
                for key, attr in (
                    ("n_respawns", "n_respawns"),
                    ("n_spare_adoptions", "n_spare_adoptions"),
                    ("n_degraded_lanes", "n_degraded_lanes"),
                ):
                    setattr(
                        self.stats, attr,
                        getattr(self.stats, attr)
                        + after.get(key, 0) - fault_before.get(key, 0),
                    )
        done = [o for o in outcomes if o is not None]
        self.stats.n_dispatched += len(miss_idx)
        self.stats.n_cache_hits += n_hits
        self.stats.n_waves += 1
        span = max((o.lane_s for o in done), default=0.0)
        self.stats.lane_busy_s += sum(o.lane_s for o in done)
        self.stats.span_s += span
        return done
