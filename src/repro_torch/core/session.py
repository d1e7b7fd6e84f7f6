"""Tuning sessions: run a tuner over one-or-many operator workloads
through the batched measurement engine, persist the results, and report.

``TuningSession`` is what ``launch/tune.py`` drives.  A
:class:`Workload` names an op from the registry
(``repro_torch.core.ops``) plus its dimension sizes.  The session owns
the two persistence layers — the keep-best :class:`TuningRecords` table
that ``kernels/ops.py`` consults at dispatch time, and the append-only
:class:`TrialJournal` the :class:`~repro_torch.core.measure.MeasureEngine`
serves repeat measurements from — and wires both into every search:

* :meth:`tune_workload` builds a per-workload engine and can
  **warm-start** the search from the best record of this workload or,
  via the space's ``transplant``, from the nearest previously-tuned
  shape of the same op;
* :meth:`tune_arch` fans every distinct workload an architecture
  executes through one shared budget pool and one
  :class:`MeasureStats`.

With a :class:`~repro_torch.core.snapshot.TuneCheckpointer` the session
snapshots each search at its tuner's round boundaries, serves a finished
workload from its ``done`` snapshot on ``resume``, and restores an
interrupted one mid-search.

The default cost is :class:`~repro_torch.core.cost.HopperTimedCost`:
candidates are timed on the card.  The session's ``device`` is handed to
every tuner that takes one (the learned tuners' networks run there).
A session may measure through real lanes (``executor``: threads or
worker processes, see :mod:`~repro_torch.core.executor`), filter
proposals with a journal-trained model (``learned_filter``), and run as
one shard of a search split over processes that share the journal
(``shard``), electing and merging the shards' bests into one record.

One thing differs from the JAX package's session: a warm start skips a
donor whose transplant the Hopper kernel cannot launch (the analyzer
calls it ILLEGAL for the workload's dtype) and tries the next donor,
then the kernel's heuristic state.  On the TPU every transplant is
legal; on Hopper, a 128-row ``wgmma`` tile transplanted into an
``M = 8`` product is not.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, Optional, Sequence

from .analysis import ScheduleAnalyzer, dtype_in_bytes
from .cost import CostBackend
from .executor import LaneExecutor, make_executor
from .fault import RetryPolicy
from .learn import ProposalFilter
from .measure import MeasureEngine, MeasureStats
from .records import (
    TrialJournal,
    TuningRecords,
    donor_distance,
    parse_workload_key_generic,
    workload_key_for,
)
from .shard import (
    ShardSpec,
    await_markers,
    elect_best,
    shard_dir_for,
    write_done_marker,
)
from .snapshot import TuneCheckpointer, TuneInterrupted
from .space import SearchSpace, State
from .tuners import TUNERS, Budget, Trial, TuneResult
from .tuners.base import decode_cost, encode_cost

__all__ = ["Workload", "TuningSession", "ArchTuneReport"]


@dataclasses.dataclass(frozen=True)
class Workload:
    """One tunable operator instance: op name + dimension sizes (plus
    nesting depths, defaulted from the op registry, and extra
    ``make_space`` kwargs such as flash's head layout, which shape what
    is measured but not the workload key)."""

    op: str
    dims: tuple[int, ...]
    dtype: str = "bfloat16"
    depths: tuple[int, ...] = ()
    label: str = ""
    space_kwargs: tuple[tuple[str, object], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "space_kwargs", tuple(sorted(dict(self.space_kwargs).items())))
        if self.depths:
            object.__setattr__(
                self, "depths", tuple(int(d) for d in self.depths)
            )
        else:
            from .ops import get_op  # lazy: ops imports cost modules

            object.__setattr__(self, "depths", get_op(self.op).default_depths)

    def space(self) -> SearchSpace:
        from .ops import get_op

        return get_op(self.op).make_space(self.dims, self.depths, **dict(self.space_kwargs))

    def key(self, backend: str) -> str:
        return workload_key_for(self.op, self.dims, self.dtype, backend)


@dataclasses.dataclass
class ArchTuneReport:
    """What ``tune_arch`` hands back: per-label results + engine totals."""

    results: dict[str, TuneResult]
    stats: MeasureStats
    n_workers: int
    n_unique_shapes: int
    executor: str = "sim"  # lane executor the arch's engines measured through

    @property
    def total_trials(self) -> int:
        return sum(r.n_trials for r in self.distinct_results())

    @property
    def total_clock_s(self) -> float:
        return sum(r.clock_s for r in self.distinct_results())

    def distinct_results(self) -> list[TuneResult]:
        seen: set[int] = set()
        out = []
        for r in self.results.values():
            if id(r) not in seen:
                seen.add(id(r))
                out.append(r)
        return out


#: Snapshot step reserved for the "workload finished" marker — larger
#: than any round index, so it always survives the checkpointer's GC and
#: ``latest_step`` finds it first on resume.
_DONE_STEP = 99_999_999


def _result_to_jsonable(result: TuneResult) -> dict:
    return {
        "tuner": result.tuner,
        "best": None if result.best_state is None else result.best_state.as_lists(),
        "best_cost": encode_cost(result.best_cost),
        "trials": [
            [t.state.as_lists(), encode_cost(t.cost), t.clock_s]
            for t in result.trials
        ],
        "fraction": result.fraction,
        "wall_s": result.wall_s,
        "clock_s": result.clock_s,
        "n_workers": result.n_workers,
        "n_cache_hits": result.n_cache_hits,
        "executor": result.executor,
    }


def _result_from_jsonable(data: dict, space: SearchSpace) -> TuneResult:
    trials = [
        Trial(space.state_from_lists(lists), decode_cost(c), i, float(tc))
        for i, (lists, c, tc) in enumerate(data["trials"])
    ]
    return TuneResult(
        tuner=data["tuner"],
        best_state=(
            None if data["best"] is None else space.state_from_lists(data["best"])
        ),
        best_cost=decode_cost(data["best_cost"]),
        trials=trials,
        n_trials=len(trials),
        fraction=data["fraction"],
        wall_s=data["wall_s"],
        clock_s=data["clock_s"],
        n_workers=data["n_workers"],
        n_cache_hits=data["n_cache_hits"],
        executor=data["executor"],
    )


def _default_cost_factory(space: SearchSpace, dtype: str = "bfloat16") -> CostBackend:
    """Time candidates on the card (raises where there is none)."""
    from .cost import HopperTimedCost

    return HopperTimedCost(space, dtype=dtype)


class TuningSession:
    def __init__(
        self,
        records: Optional[TuningRecords] = None,
        cost_factory: Optional[Callable[..., CostBackend]] = None,
        seed: int = 0,
        verbose: bool = True,
        journal: Optional[TrialJournal] = None,
        device="cuda",
    ):
        # NOTE: TuningRecords defines __len__, so an EMPTY store is falsy —
        # `records or TuningRecords()` would silently drop it
        self.records = records if records is not None else TuningRecords()
        self.cost_factory = cost_factory or _default_cost_factory
        self.seed = seed
        self.verbose = verbose
        # persistent measurement cache; None disables cross-session serving
        self.journal = journal
        # where tuners that take a device (the learned ones) run their networks
        self.device = device

    # -- warm start ----------------------------------------------------------
    def warm_start_state(
        self,
        wl: Workload,
        space: SearchSpace,
        backend_name: str,
        fingerprint: Optional[str] = None,
    ) -> Optional[State]:
        """Initial state for a warm-started search: this workload's own
        best record if one exists, else the best state of the nearest
        previously-tuned shape of the *same op* transplanted into this
        space, else the state of the kernel's heuristic config.  Donor
        scans are scoped to the workload's op and dtype — a bf16-tuned
        best must never seed an int8 search (the tile economics differ) —
        and a transplant the kernel cannot launch for this dtype is
        skipped for the next donor.
        ``fingerprint`` scopes the journal search to entries measured
        under the same backend settings (see ``measure_fingerprint``)."""
        wkey = wl.key(backend_name)
        s = self.records.lookup_state(wkey)
        if s is not None and space.is_legitimate(s):
            return s
        # trailing non-factored dims (e.g. flash's head_dim) are workload
        # identity: a donor tuned for a different value has different
        # tile economics and must never seed this search
        n_fixed = space.n_fixed_dims
        donors: list[tuple[float, str, State]] = []
        for key in self.records.keys():
            parsed = parse_workload_key_generic(key)
            if parsed is None or key == wkey:
                continue
            d = donor_distance(parsed, wl.op, wl.dims, dtype=wl.dtype,
                               backend=backend_name, fixed_tail=n_fixed)
            if d is None:
                continue
            src = self.records.lookup_state(key)
            if src is None:
                continue
            donors.append((d, key, src))
        if self.journal is not None:
            jbackend = (
                backend_name if fingerprint is None else f"{backend_name}?{fingerprint}"
            )
            near = self.journal.nearest(
                wl.op, wl.dims, dtype=wl.dtype, backend=jbackend,
                exclude=wkey if fingerprint is None else f"{wkey}?{fingerprint}",
                fixed_tail=n_fixed,
            )
            if near is not None:
                best = self.journal.best_state(near)
                parsed = parse_workload_key_generic(near)
                if best is not None and parsed is not None:
                    d = donor_distance(parsed, wl.op, wl.dims,
                                       fixed_tail=n_fixed)
                    if d is not None:
                        donors.append((d, near, best[0]))
        analyzer = ScheduleAnalyzer(space, in_bytes=dtype_in_bytes(wl.dtype))
        for d, _key, src in sorted(donors, key=lambda t: (t[0], t[1])):
            s = space.transplant(src)
            if s is not None and not analyzer.analyze(s).illegal:
                return s
        # no donor: start from the kernel's heuristic config — the
        # paper's untiled s0 is a state the Hopper kernel cannot launch
        from .ops import get_op

        return get_op(wl.op).default_state(space, wl.dtype)

    @staticmethod
    def _record_extra(wl: Workload, engine: MeasureEngine) -> dict:
        """A record's provenance fields; a workload tuned on a non-default
        space (flash's head layout) also records the space's kwargs, so
        the audit judges the record on the space it was tuned in."""
        extra = {"label": wl.label, "n_workers": engine.n_workers}
        if wl.space_kwargs:
            extra["space_kwargs"] = dict(wl.space_kwargs)
        return extra

    # -- single workload -----------------------------------------------------
    def tune_workload(
        self,
        wl: Workload,
        tuner_name: str = "g-bfs",
        budget: Optional[Budget] = None,
        tuner_kwargs: Optional[dict] = None,
        seed: Optional[int] = None,
        n_workers: int = 1,
        warm_start: bool = False,
        engine: Optional[MeasureEngine] = None,
        stats: Optional[MeasureStats] = None,
        executor: Optional[LaneExecutor] = None,
        reload_every: int = 0,
        analyze: str = "off",
        retry: Optional[RetryPolicy] = None,
        checkpointer: Optional[TuneCheckpointer] = None,
        resume: bool = False,
        learned_filter: str = "off",
        filter_keep: float = 0.5,
        filter_retrain_every: int = 8,
        filter_min_rows: int = 32,
        shard: Optional[ShardSpec] = None,
        shard_wait_s: float = 60.0,
    ) -> TuneResult:
        if learned_filter not in ("off", "on"):
            raise ValueError(
                f"learned_filter must be 'off' or 'on', got {learned_filter!r}"
            )
        if shard is not None and not shard.enabled:
            shard = None  # 0/1 is the unsharded engine, bit-identical
        if shard is not None and self.journal is None:
            raise ValueError(
                "sharded tuning (shard I/N with N > 1) needs a shared journal "
                "— siblings exchange measurements and done markers through it"
            )
        space = wl.space()
        # the workload's dtype picks the kernel, its launch rule and its
        # model: a cost for another dtype would rank the wrong kernel
        cost = self.cost_factory(space, dtype=wl.dtype)
        wkey = wl.key(cost.name)
        if engine is not None and executor is not None and engine.executor is not executor:
            # the engine owns the measurement model — reject conflicts,
            # don't silently drop them
            raise ValueError(
                "executor=... conflicts with the provided engine's executor"
            )
        if engine is not None and analyze != "off" and engine.analyze != analyze:
            raise ValueError(
                "analyze=... conflicts with the provided engine's analyze mode"
            )
        if engine is not None and retry is not None and retry.enabled and engine.retry != retry:
            raise ValueError(
                "retry=... conflicts with the provided engine's retry policy"
            )
        if engine is not None and learned_filter == "on" and engine.learned_filter is None:
            raise ValueError(
                "learned_filter='on' conflicts with the provided engine "
                "(it has no ProposalFilter)"
            )
        if engine is not None and shard is not None and engine.shard != shard:
            raise ValueError(
                f"shard={shard} conflicts with the provided engine's "
                f"{engine.shard}"
            )
        # each shard owns its own search state: a shard-suffixed snapshot
        # identity keeps two hosts resuming one workload from colliding
        tuner_id = (
            tuner_name if shard is None
            else f"{tuner_name}@shard{shard.index}of{shard.count}"
        )
        # -- crash-safe resume: serve finished workloads from their done
        # snapshot, restore interrupted ones mid-search -----------------------
        restore = None
        if checkpointer is not None and resume:
            payload = checkpointer.load(wkey, tuner_id)
            if payload is not None and payload.get("done"):
                result = _result_from_jsonable(payload["result"], space)
                if self.verbose:
                    print(
                        f"[tune] {wl.label or wkey} {tuner_name}: "
                        f"already complete (resumed from done snapshot, "
                        f"best={result.best_cost:.3e}s trials={result.n_trials})"
                    )
                return result
            restore = payload
        elif checkpointer is not None:
            # fresh run: stale snapshots (incl. a previous done marker)
            # must not shadow this run for a later --resume
            checkpointer.clear(wkey, tuner_id)
        if engine is None:
            flt = None
            if learned_filter == "on":
                # per-workload filter: the model's scope is this space's
                # op/feature-width + the backend's dtype/fingerprint, and
                # its cache lives next to the session journal
                flt = ProposalFilter(
                    space,
                    self.journal,
                    dtype=wl.dtype,
                    fingerprint=cost.measure_fingerprint(),
                    keep=filter_keep,
                    retrain_every=filter_retrain_every,
                    min_rows=filter_min_rows,
                )
            engine = MeasureEngine(
                cost,
                n_workers=n_workers,
                journal=self.journal,
                workload_key=wkey,
                stats=stats,
                executor=executor,
                reload_every=reload_every,
                analyze=analyze,
                retry=retry,
                learned_filter=flt,
                shard=shard,
            )
        warm_up = getattr(engine.executor, "warm_up", None)
        if warm_up is not None:
            # process lanes build this workload's backend (CUDA context,
            # operands, kernel library) before the first timed wave
            warm_up(engine.n_workers, backend=cost)
        budget = budget or Budget(max_fraction=0.001)
        tuner_cls = TUNERS[tuner_name]
        kwargs = dict(tuner_kwargs or {})
        takes = inspect.signature(tuner_cls.__init__).parameters
        if warm_start and "s0" not in kwargs:
            s0 = self.warm_start_state(
                wl, space, cost.name, fingerprint=cost.measure_fingerprint()
            )
            if s0 is not None and "s0" in takes:
                kwargs["s0"] = s0
        if "device" in takes and "device" not in kwargs:
            kwargs["device"] = self.device
        tuner = tuner_cls(space, cost, seed=self.seed if seed is None else seed,
                          **kwargs)
        checkpoint_fn = None
        if checkpointer is not None:
            def checkpoint_fn(t, ctx, _ck=checkpointer):
                # periodic snapshot at the cadence; an interrupt always
                # flushes a final one, then unwinds the whole session
                if _ck.interrupted or ctx.round_idx % _ck.every_rounds == 0:
                    _ck.save(
                        wkey,
                        tuner_id,
                        {
                            "tuner": tuner_name,
                            "tuner_state": t.state_dict(),
                            "ctx": ctx.snapshot(),
                        },
                        step=ctx.round_idx,
                    )
                if _ck.interrupted:
                    raise TuneInterrupted(wkey)

        result = tuner.tune(
            budget, engine=engine, checkpoint_fn=checkpoint_fn, restore=restore
        )
        if shard is not None:
            # elect-and-merge: publish this shard's best, wait for the
            # siblings' done markers, and keep-best-merge the elected
            # winner (lowest journaled cost, ties -> lowest shard index)
            # into the records table.  Every shard runs this — the merge
            # is idempotent, so no coordinator is needed.
            root = shard_dir_for(self.journal.path)
            write_done_marker(
                root,
                engine.journal_key,
                shard,
                None if result.best_state is None else result.best_state.as_lists(),
                result.best_cost,
                result.n_trials,
            )
            markers = await_markers(
                root, engine.journal_key, shard, timeout_s=shard_wait_s
            )
            if len(markers) < shard.count and self.verbose:
                missing = sorted(set(range(shard.count)) - set(markers))
                print(
                    f"[tune] {wl.label or wkey} shard {shard}: warning — "
                    f"sibling shard(s) {missing} never reported within "
                    f"{shard_wait_s:.0f}s; electing over the partial set"
                )
            # pick up the siblings' measurements before anyone reads best_state
            self.journal.reload()
            won = elect_best(markers)
            if won is not None:
                win_idx, win_lists, win_cost = won
                self.records.update(
                    wkey,
                    space.state_from_lists(win_lists),
                    win_cost,
                    tuner_name,
                    result.n_trials,
                    extra={
                        **self._record_extra(wl, engine),
                        "shard_winner": win_idx,
                        "n_shards": shard.count,
                    },
                )
        elif result.best_state is not None and math.isfinite(result.best_cost):
            self.records.update(
                wkey,
                result.best_state,
                result.best_cost,
                tuner_name,
                result.n_trials,
                extra=self._record_extra(wl, engine),
            )
        if checkpointer is not None:
            # mark the workload finished AFTER records.update so a crash
            # between the two re-runs the search instead of losing the record
            checkpointer.save(
                wkey,
                tuner_id,
                {"done": True, "tuner": tuner_name,
                 "result": _result_to_jsonable(result)},
                step=_DONE_STEP,
            )
        if self.verbose:
            print(
                f"[tune] {wl.label or wkey} {tuner_name}: "
                f"best={result.best_cost:.3e}s trials={result.n_trials} "
                f"frac={result.fraction:.5f} wall={result.wall_s:.1f}s "
                f"clock={result.clock_s:.1f}s workers={result.n_workers} "
                f"cache_hit={result.cache_hit_rate:.2f}"
            )
        return result

    # -- whole architecture --------------------------------------------------
    def tune_arch(
        self,
        arch: Optional[str] = None,
        shape: str = "train_4k",
        tuner_name: str = "g-bfs",
        budget: Optional[Budget] = None,
        n_workers: int = 1,
        warm_start: bool = False,
        workloads: Optional[Sequence[Workload]] = None,
        tuner_kwargs: Optional[dict] = None,
        executor: Optional[LaneExecutor | str] = None,
        reload_every: int = 0,
        analyze: str = "off",
        retry: Optional[RetryPolicy] = None,
        checkpointer: Optional[TuneCheckpointer] = None,
        resume: bool = False,
        learned_filter: str = "off",
        filter_keep: float = 0.5,
        filter_retrain_every: int = 8,
        filter_min_rows: int = 32,
        shard: Optional[ShardSpec] = None,
        shard_wait_s: float = 60.0,
    ) -> ArchTuneReport:
        """Tune every distinct workload an architecture executes through
        one shared budget pool.

        ``budget.max_trials`` / ``max_time_s`` are the TOTAL across the
        arch — a hard ceiling: each remaining workload is allocated an
        equal share of whatever is left, capped at the remainder
        (``max_fraction`` stays per-workload).  Workloads with identical
        ``(op, dims, dtype, depths, space_kwargs)`` are tuned once and share the
        result; all engines share the session journal and one
        :class:`MeasureStats`.

        ``executor`` selects how measurement lanes run — a
        :class:`~repro_torch.core.executor.LaneExecutor`, or a name
        (``"sim"``/``"thread"``/``"process"``) built here and closed when
        the arch finishes; all workloads share it, so process lanes pay
        worker start-up once.  ``reload_every=N`` makes every engine merge
        sibling journal rows every N waves.  ``shard=ShardSpec(i, n)``
        makes this process shard ``i`` of an ``n``-way search over the
        same journal: each engine measures only the candidates it owns
        (see :mod:`~repro_torch.core.shard`) and every workload's shards
        elect and merge one record when they finish."""
        if workloads is None:
            if arch is None:
                raise ValueError("tune_arch needs an arch name or explicit workloads")
            from repro_torch.launch.tune import workloads_for_arch  # lazy: avoids cycle

            workloads = workloads_for_arch(arch, shape)
        budget = budget or Budget(max_fraction=0.001)
        stats = MeasureStats()
        unique: dict[tuple, Workload] = {}
        labels: dict[tuple, list[str]] = {}
        for i, wl in enumerate(workloads):
            shape_key = (wl.op, wl.dims, wl.dtype, wl.depths, wl.space_kwargs)
            unique.setdefault(shape_key, wl)
            labels.setdefault(shape_key, []).append(wl.label or f"wl{i}")
        results: dict[str, TuneResult] = {}
        owns_executor = isinstance(executor, str)
        exec_obj = make_executor(executor) if isinstance(executor, str) else executor
        left_trials = budget.max_trials
        left_time = budget.max_time_s
        n_left = len(unique)
        try:
            for shape_key, wl in unique.items():
                if (left_trials is not None and left_trials <= 0) or (
                    left_time is not None and left_time <= 0.0
                ):
                    break  # shared pool exhausted
                alloc = Budget(
                    max_trials=None
                    if left_trials is None
                    else min(left_trials, max(1, left_trials // n_left)),
                    max_time_s=None if left_time is None else left_time / n_left,
                    max_fraction=budget.max_fraction,
                )
                res = self.tune_workload(
                    wl, tuner_name, alloc, tuner_kwargs,
                    n_workers=n_workers, warm_start=warm_start, stats=stats,
                    executor=exec_obj, reload_every=reload_every,
                    analyze=analyze, retry=retry, checkpointer=checkpointer,
                    resume=resume,
                    learned_filter=learned_filter, filter_keep=filter_keep,
                    filter_retrain_every=filter_retrain_every,
                    filter_min_rows=filter_min_rows,
                    shard=shard, shard_wait_s=shard_wait_s,
                )
                if left_trials is not None:
                    left_trials -= res.n_trials
                if left_time is not None:
                    left_time -= res.clock_s
                n_left -= 1
                for lbl in labels[shape_key]:
                    results[lbl] = res
        finally:
            if self.journal is not None:
                # drop the append descriptor between archs; the journal
                # stays usable (record() reopens lazily)
                self.journal.close()
            if owns_executor and exec_obj is not None:
                exec_obj.close()
        report = ArchTuneReport(
            results=results,
            stats=stats,
            n_workers=max(1, n_workers),
            n_unique_shapes=len(unique),
            executor=exec_obj.name if exec_obj is not None else "sim",
        )
        if self.verbose:
            print(
                f"[tune-arch] {len(results)} workloads / "
                f"{report.n_unique_shapes} distinct shapes: "
                f"trials={report.total_trials} clock={report.total_clock_s:.1f}s "
                f"workers={report.n_workers} executor={report.executor} "
                f"cache_hit={stats.cache_hit_rate():.2f} "
                f"lane_failures={stats.n_failures}"
            )
        return report
