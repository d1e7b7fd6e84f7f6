"""Tuning-record store: persisted best configurations per GEMM workload,
plus the persistent trial journal the measurement engine caches from.

Both files keep the JAX package's JSON/JSONL schema byte for byte, so
either package's stores can be read by the other; the backend namespace
in every workload key keeps a TPU-tuned record from ever being served
to the Hopper kernel.

Two artifacts live here:

* :class:`TuningRecords` — the keep-best table the framework ships (the
  analogue of AutoTVM's tophub).  ``kernels/ops.py`` consults the
  process-global store at dispatch time to pick the kernel config for
  each matmul shape; ``launch/tune.py`` writes it.  Plain JSON for
  diffability; crash-safe via atomic replace.
* :class:`TrialJournal` — an append-only JSONL log of *every*
  measurement ever taken, keyed by workload.  The
  :class:`~repro_torch.core.measure.MeasureEngine` consults it before
  dispatching to hardware, so repeat queries — within a session, across
  sessions, or across workloads that share GEMM shapes — are served from
  cache; ``TuningSession`` also uses it to warm-start a workload from
  the nearest previously-tuned shape.
"""

from __future__ import annotations

import json
import math
import os
import re
import tempfile
import threading
import time
from typing import Iterable, Optional, Sequence

from .fault import PERMANENT_KINDS, TRANSIENT_KINDS
from .space import State, state_from_lists

__all__ = [
    "TuningRecords",
    "TrialJournal",
    "iter_journal_rows",
    "workload_key_for",
    "workload_key",
    "parse_workload_key",
    "parse_workload_key_generic",
    "op_of_workload_key",
    "donor_distance",
    "global_records",
    "set_global_records",
    "add_change_listener",
]


# -- change notification -------------------------------------------------------
# Dispatch-time consumers (kernels/ops.py memoizes its per-shape record
# lookups) must drop their caches whenever the visible records change:
# a keep-best update, or the process-global store being swapped for a
# freshly loaded one.  Listeners must be idempotent and cheap.

_CHANGE_LISTENERS: list = []


def add_change_listener(fn) -> None:
    """Register ``fn()`` to run after any TuningRecords mutation or
    global-store swap.  Exceptions in listeners propagate — a broken
    invalidation hook must fail loudly, not serve stale schedules."""
    _CHANGE_LISTENERS.append(fn)


def _notify_change() -> None:
    for fn in list(_CHANGE_LISTENERS):
        fn()


def workload_key_for(op: str, dims: Sequence[int], dtype: str = "bfloat16",
                     backend: str = "hopper_timed") -> str:
    """Persistent-store key for one op workload.  GEMM keeps its legacy
    ``gemm/m{M}k{K}n{N}/...`` spelling bit-for-bit (old records files and
    journals stay valid); every other op gets the generic
    ``{op}/{d0}x{d1}x../{dtype}/{backend}`` form.  Either way the key
    leads with the op, so cross-op rows can never collide."""
    if op == "gemm":
        m, k, n = dims
        return f"gemm/m{m}k{k}n{n}/{dtype}/{backend}"
    return f"{op}/" + "x".join(str(d) for d in dims) + f"/{dtype}/{backend}"


def workload_key(m: int, k: int, n: int, dtype: str = "bfloat16",
                 backend: str = "analytical_h100") -> str:
    """The GEMM spelling of :func:`workload_key_for`, under the H100
    analytical model's namespace unless another backend is named."""
    return workload_key_for("gemm", (m, k, n), dtype, backend)


_KEY_RE = re.compile(r"^gemm/m(\d+)k(\d+)n(\d+)/([^/]+)/(.+)$")
_GENERIC_KEY_RE = re.compile(r"^([A-Za-z0-9_-]+)/(\d+(?:x\d+)*)/([^/]+)/(.+)$")


def parse_workload_key(key: str) -> Optional[tuple[int, int, int, str, str]]:
    """Inverse of :func:`workload_key`: ``(m, k, n, dtype, backend)``, or
    None for a key that is not a GEMM's."""
    m = _KEY_RE.match(key)
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4), m.group(5)


def parse_workload_key_generic(
    key: str,
) -> Optional[tuple[str, tuple[int, ...], str, str]]:
    """Inverse of :func:`workload_key_for`:
    ``(op, dims, dtype, backend)`` for any op (legacy GEMM keys
    included)."""
    m = _KEY_RE.match(key)
    if m is not None:
        return (
            "gemm",
            (int(m.group(1)), int(m.group(2)), int(m.group(3))),
            m.group(4),
            m.group(5),
        )
    g = _GENERIC_KEY_RE.match(key)
    if g is None:
        return None
    dims = tuple(int(x) for x in g.group(2).split("x"))
    return g.group(1), dims, g.group(3), g.group(4)


def donor_distance(
    parsed: tuple[str, tuple[int, ...], str, str],
    op: str,
    dims: Sequence[int],
    dtype: Optional[str] = None,
    backend: Optional[str] = None,
    fixed_tail: int = 0,
) -> Optional[float]:
    """THE warm-start donor filter, shared by the records and journal
    scans: log-shape distance from a parsed donor workload key (see
    :func:`parse_workload_key_generic`) to ``(op, dims)``, or ``None``
    when the donor is out of scope — different op, dims arity, trailing
    identity dims (``fixed_tail``, e.g. flash's head_dim), dtype, or
    backend."""
    op2, dims2, dt2, be2 = parsed
    dims = tuple(dims)
    if op2 != op or len(dims2) != len(dims):
        return None
    if fixed_tail and dims2[-fixed_tail:] != dims[-fixed_tail:]:
        return None
    if backend is not None and be2 != backend:
        return None
    if dtype is not None and dt2 != dtype:
        return None
    return sum(abs(math.log2(a / b)) for a, b in zip(dims2, dims))


def op_of_workload_key(key: str) -> str:
    """The op a workload key (or ``key?fingerprint`` journal key)
    belongs to; pre-op-registry keys are all GEMM."""
    op = key.split("/", 1)[0]
    return op if "/" in key else "gemm"


class TuningRecords:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._data: dict[str, dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    # -- read ------------------------------------------------------------------
    def lookup(self, key: str) -> Optional[dict]:
        return self._data.get(key)

    def lookup_state(self, key: str) -> Optional[State]:
        rec = self.lookup(key)
        if rec is None:
            return None
        op = rec.get("op") or op_of_workload_key(key)
        try:
            return state_from_lists(op, rec["state"])
        except KeyError:  # op's space module not available here
            return None

    def best_cost(self, key: str) -> float:
        """The recorded best cost of ``key``, or ``inf`` without a record."""
        rec = self.lookup(key)
        return rec["cost"] if rec else math.inf

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    # -- write -----------------------------------------------------------------
    def update(
        self,
        key: str,
        state: State,
        cost: float,
        tuner: str,
        n_trials: int,
        extra: Optional[dict] = None,
    ) -> bool:
        """Keep-best merge; returns True if the record improved."""
        with self._lock:
            old = self._data.get(key)
            if old is not None and old["cost"] <= cost:
                return False
            self._data[key] = {
                "op": op_of_workload_key(key),
                "state": state.as_lists(),
                "cost": cost,
                "tuner": tuner,
                "n_trials": n_trials,
                "timestamp": time.time(),
                **(extra or {}),
            }
            self._flush_locked()
        # outside the lock: listeners may read back through this store
        _notify_change()
        return True

    def _flush_locked(self) -> None:
        if not self.path:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)  # atomic publish
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


class TrialJournal:
    """Append-only measurement log: ``(workload, state) -> cost``.

    Persists as strict JSONL — one row per measurement, written as a
    **single ``write()`` on an ``O_APPEND`` descriptor**, so any number
    of engines *and processes* can share one journal file without ever
    interleaving torn rows (POSIX serialises O_APPEND writes).  Failed
    builds (``math.inf``) are journaled too — knowing a config fails is
    exactly as cacheable as knowing its runtime — but encoded as
    ``{"c": null, "fail": true}`` so every row survives strict
    ``json.loads``; legacy ``Infinity`` rows are still understood on
    load.  A crash mid-append leaves at most one unterminated tail line,
    which loading skips (and a later :meth:`reload` re-reads once some
    surviving writer completes it).

    Rows carry an ``op`` schema field (rows from before the op
    registry load as ``op="gemm"``); a workload key belongs to
    exactly one op, and lookups can assert it (:meth:`get` with
    ``op=``), so a mixed-op journal can never serve a flash row to a
    GEMM search.  The in-memory view is a per-workload cost table plus a running best
    (state, cost) pair used for warm starts.  :meth:`reload` merges rows
    appended by sibling engines/processes since the last read — the
    multi-engine sharing primitive.  The journal is a context manager;
    ``close()`` drops the append descriptor (reopened lazily by the next
    ``record``).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._costs: dict[str, dict[str, float]] = {}
        self._best: dict[str, tuple[float, list]] = {}
        self._ops: dict[str, str] = {}  # workload -> op (schema guard)
        self._static_seen: dict[str, set] = {}  # audit rows already journaled
        # learned-filter skip rows already journaled (provenance only —
        # a prediction must never be served as a measurement)
        self._pred_seen: dict[str, set] = {}
        # transient-failure provenance rows already journaled (kept OUT of
        # the cost table — see record_failure)
        self._transient_seen: dict[str, set] = {}
        self._fd: Optional[int] = None
        self._read_pos = 0  # how far reload() has consumed the file
        if path:
            self.reload()

    def __enter__(self) -> "TrialJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def _row_cost(row: dict) -> float:
        c = row.get("c")
        if row.get("fail") or c is None:
            return math.inf
        return float(c)  # legacy rows: json.loads already accepts Infinity

    def reload(self) -> int:
        """Ingest rows appended to the file since the last load —
        including rows written by *other* engines or processes sharing
        this journal path.  Returns the number of new rows ingested
        (rows this instance already holds dedup to zero).  Only complete
        (newline-terminated) lines are consumed; a torn tail stays
        unread until a later reload sees it completed."""
        if not self.path or not os.path.exists(self.path):
            return 0
        n_new = 0
        with self._lock:
            with open(self.path, "rb") as f:
                f.seek(self._read_pos)
                data = f.read()
            end = data.rfind(b"\n")
            if end < 0:
                return 0
            self._read_pos += end + 1
            for line in data[: end + 1].splitlines():
                if not line.strip():
                    continue
                try:
                    row = json.loads(line)
                    if isinstance(row, dict) and "static" in row:
                        # analyzer audit row (a pruned candidate, not a
                        # measurement): remember it for dedup but keep it
                        # out of the cost table — a later analyze=off run
                        # must re-measure the state, not cache-hit inf
                        self._static_seen.setdefault(
                            row["w"], set()
                        ).add(row["k"])
                        continue
                    if isinstance(row, dict) and "pred" in row:
                        # learned-filter skip row (a *prediction*, not a
                        # measurement): provenance only — without this
                        # branch the row would fall through below and be
                        # ingested as a cacheable inf "failure"
                        self._pred_seen.setdefault(
                            row["w"], set()
                        ).add(row["k"])
                        continue
                    if (
                        isinstance(row, dict)
                        and (row.get("fail") or row.get("c") is None)
                        # failure taxonomy: rows from before it load as
                        # kind="build" (a failed build — permanent, and
                        # exactly as cacheable as a runtime).  Transient
                        # kinds (crash/timeout/spawn/corrupt) say nothing
                        # about the schedule: provenance only, a later
                        # run must re-measure, never cache-hit inf.
                        and row.get("kind", "build") in TRANSIENT_KINDS
                    ):
                        self._transient_seen.setdefault(
                            row["w"], set()
                        ).add(row["k"])
                        continue
                    ingested = self._ingest(
                        row["w"], row["k"], row["s"], self._row_cost(row),
                        # schema field added with the op registry; every
                        # pre-registry row is a GEMM measurement
                        op=row.get("op", "gemm"),
                    )
                except (ValueError, KeyError, TypeError):
                    continue  # torn/foreign line from a crashed writer
                n_new += int(ingested)
        return n_new

    # -- read ------------------------------------------------------------------
    def get(self, workload: str, state_key: str,
            op: Optional[str] = None) -> Optional[float]:
        """Cached cost, or None.  ``op`` (when given) must match the
        workload's journaled op — a flash row must never be served to a
        GEMM lookup even if the key strings were ever to collide."""
        if op is not None and self._ops.get(workload, "gemm") != op:
            return None
        return self._costs.get(workload, {}).get(state_key)

    def n_trials(self, workload: str) -> int:
        """Distinct states journaled for ``workload``."""
        return len(self._costs.get(workload, ()))

    def workloads(self) -> Iterable[str]:
        """The journaled workload keys."""
        return self._costs.keys()

    def __len__(self) -> int:
        return sum(len(d) for d in self._costs.values())

    def op_of(self, workload: str) -> str:
        return self._ops.get(workload, "gemm")

    def best_state(self, workload: str) -> Optional[tuple[State, float]]:
        rec = self._best.get(workload)
        if rec is None:
            return None
        cost, lists = rec
        try:
            return state_from_lists(self.op_of(workload), lists), cost
        except KeyError:
            return None

    def nearest(
        self,
        op: str,
        dims: Sequence[int],
        dtype: Optional[str] = None,
        backend: Optional[str] = None,
        exclude: Optional[str] = None,
        fixed_tail: int = 0,
    ) -> Optional[str]:
        """The previously-journaled workload of ``op`` closest to
        ``dims`` in log-shape space — the warm-start donor for a new
        shape.  Donors are scoped to the op: a flash schedule can never
        seed a GEMM search.  ``fixed_tail`` is the count of trailing
        dims that are workload identity rather than factored rows
        (``SearchSpace.n_fixed_dims``): donors must match them exactly
        (e.g. flash's head_dim)."""
        best_key, best_d = None, math.inf
        for key in self._costs:
            if key == exclude or key not in self._best:
                continue
            parsed = parse_workload_key_generic(key)
            if parsed is None or self.op_of(key) != op:
                continue
            d = donor_distance(parsed, op, dims, dtype=dtype,
                               backend=backend, fixed_tail=fixed_tail)
            if d is not None and d < best_d:
                best_key, best_d = key, d
        return best_key

    def nearest_workload(
        self,
        m: int,
        k: int,
        n: int,
        dtype: Optional[str] = None,
        backend: Optional[str] = None,
        exclude: Optional[str] = None,
    ) -> Optional[str]:
        """The GEMM spelling of :meth:`nearest` (the JAX package's name)."""
        return self.nearest("gemm", (m, k, n), dtype=dtype, backend=backend,
                            exclude=exclude)

    # -- write -----------------------------------------------------------------
    def _ingest(self, workload: str, state_key: str, state_lists: list,
                cost: float, op: str = "gemm") -> bool:
        known = self._ops.setdefault(workload, op)
        if known != op:
            # schema guard: a workload key belongs to exactly one op —
            # never let a foreign row shadow (or serve) another op's
            # measurements
            return False
        table = self._costs.setdefault(workload, {})
        if state_key in table:
            return False
        table[state_key] = cost
        if math.isfinite(cost):
            best = self._best.get(workload)
            if best is None or cost < best[0]:
                self._best[workload] = (cost, state_lists)
        return True

    def _append_row(self, row: dict) -> None:
        """Append one JSONL row (caller holds the lock, ``self.path`` set).

        One write() per row: O_APPEND makes concurrent appends from
        sibling engines/processes atomic, never interleaved.  A short
        write (disk full, NFS) would tear the row AND swallow the next
        sibling's O_APPEND line, so finish or fail loudly rather than
        continue with a corrupt tail."""
        if self._fd is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fd = os.open(
                self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644
            )
        line = json.dumps(row, allow_nan=False, separators=(",", ":"))
        view = memoryview((line + "\n").encode("utf-8"))
        while view:
            view = view[os.write(self._fd, view):]

    def record(self, workload: str, state: State, cost: float,
               op: Optional[str] = None, kind: Optional[str] = None,
               attempts: Optional[int] = None,
               shard: Optional[Sequence[int]] = None) -> None:
        """Journal one measurement.  ``inf`` costs are failure rows; they
        carry a failure ``kind`` (default ``"build"`` — the
        backend-says-infeasible case) and optionally the number of
        measurement ``attempts`` that led to the verdict.  ``shard`` is
        the measuring engine's ``(index, count)`` in a sharded search —
        pure provenance (the audit CLI recomputes ownership from it);
        unsharded rows keep the unsharded format."""
        if op is None:
            op = op_of_workload_key(workload)
        with self._lock:
            lists = state.as_lists()
            if not self._ingest(workload, state.key(), lists, cost, op=op):
                return
            if self.path:
                row: dict = {"w": workload, "k": state.key(), "s": lists,
                             "op": op}
                if math.isfinite(cost):
                    row["c"] = cost
                else:
                    row["c"] = None
                    row["fail"] = True
                    row["kind"] = kind or "build"
                    if attempts is not None and attempts > 1:
                        row["attempts"] = int(attempts)
                if shard is not None:
                    row["shard"] = [int(shard[0]), int(shard[1])]
                self._append_row(row)

    def record_failure(self, workload: str, state: State, kind: str,
                       attempts: int = 1, op: Optional[str] = None,
                       shard: Optional[Sequence[int]] = None) -> None:
        """Journal a lane failure with taxonomy provenance.

        *Permanent* kinds (a deterministic raise) are cacheable facts
        about the schedule: they enter the cost table as ``inf`` exactly
        like a failed build.  *Transient* kinds (crash/timeout/spawn/
        corrupt — written after retry exhaustion) are provenance-only
        audit rows: the journal documents what happened and how many
        attempts were spent, but the state stays out of the cost table so
        no later session ever cache-hits a worker death as "this config
        is infeasible"."""
        if kind in PERMANENT_KINDS:
            self.record(workload, state, math.inf, op=op, kind=kind,
                        attempts=attempts, shard=shard)
            return
        if op is None:
            op = op_of_workload_key(workload)
        with self._lock:
            seen = self._transient_seen.setdefault(workload, set())
            key = state.key()
            if key in seen:
                return
            seen.add(key)
            if not self.path:
                return
            row = {"w": workload, "k": key, "s": state.as_lists(), "op": op,
                   "c": None, "fail": True, "kind": str(kind),
                   "attempts": int(attempts)}
            if shard is not None:
                row["shard"] = [int(shard[0]), int(shard[1])]
            self._append_row(row)

    def record_static(self, workload: str, state: State, reason: str,
                      op: Optional[str] = None) -> None:
        """Journal an analyzer rejection as an **audit row**:
        ``{"c": null, "static": "<reason>"}``.  Unlike :meth:`record`
        this never enters the cost table — the row documents *why* the
        candidate was pruned without ever being measured, and a later
        ``analyze=off`` run must re-measure it rather than cache-hit an
        inferred failure.  Legacy readers that ignore the ``static``
        field see ``c=None`` (a failure row), which is safe."""
        if op is None:
            op = op_of_workload_key(workload)
        with self._lock:
            seen = self._static_seen.setdefault(workload, set())
            key = state.key()
            if key in seen:
                return
            seen.add(key)
            if not self.path:
                return
            row = {"w": workload, "k": key, "s": state.as_lists(),
                   "op": op, "c": None, "static": str(reason)}
            self._append_row(row)


    def record_predicted(self, workload: str, state: State, score: float,
                         op: Optional[str] = None) -> None:
        """Journal a learned-filter skip as a **provenance row**:
        ``{"c": null, "pred": <score>}`` — the model's rank score, not a
        runtime.  Like :meth:`record_static` this never enters the cost
        table: the candidate was never measured, and a later unfiltered
        run must measure it rather than cache-hit a guess.  Legacy
        readers that ignore the ``pred`` field see ``c=None`` (a
        failure row), which is safe."""
        if op is None:
            op = op_of_workload_key(workload)
        with self._lock:
            seen = self._pred_seen.setdefault(workload, set())
            key = state.key()
            if key in seen:
                return
            seen.add(key)
            if not self.path:
                return
            row = {"w": workload, "k": key, "s": state.as_lists(),
                   "op": op, "c": None, "pred": float(score)}
            self._append_row(row)

    def close(self) -> None:
        """Release the append descriptor; the in-memory view (and
        ``_read_pos``) survive, so the journal stays usable — the next
        ``record`` reopens lazily."""
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


_GLOBAL = TuningRecords()


def global_records() -> TuningRecords:
    return _GLOBAL


def set_global_records(records: TuningRecords) -> None:
    global _GLOBAL
    _GLOBAL = records
    _notify_change()


def iter_journal_rows(path: str) -> Iterable[dict]:
    """Yield every parseable row dict of a journal file, skipping blank
    and torn lines — the audit CLI's raw view (it needs the rows, not
    the deduped cost table :class:`TrialJournal` builds)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # torn tail from a crashed writer
            if isinstance(row, dict):
                yield row


_GLOBAL = TuningRecords()


def global_records() -> TuningRecords:
    return _GLOBAL


def set_global_records(records: TuningRecords) -> None:
    global _GLOBAL
    _GLOBAL = records
    _notify_change()
