"""Measurement lane executors — how a wave of candidate states runs.

* :class:`SimulatedExecutor` — in the calling thread: a single-miss wave
  takes the backend's scalar ``cost`` path, a multi-miss wave takes
  ``batch_cost``, and lane occupancy is *modeled* by the engine
  (overhead + capped runtime).  The default; it keeps every
  ``n_workers=1`` parity guarantee with the JAX package.
* :class:`ThreadExecutor` — each lane is a thread running
  ``backend.cost``; real overlap only where the backend drops the GIL.
  A lane that exceeds the timeout is abandoned (a thread cannot be
  killed, which is why crash-grade isolation needs processes).
* :class:`ProcessExecutor` — each lane is a persistent worker *process*
  fed ``(backend_spec, state)`` jobs over a pipe.  The backend is
  rebuilt worker-side from ``CostBackend.worker_spec()`` and cached per
  spec, so a job costs one pipe round trip.  A worker that dies
  (segfault, ``os._exit``, OOM-kill) or blows the lane timeout is reaped
  and respawned, and its lane resolves to ``inf`` of a transient kind.

Three things differ from the JAX package's lanes, all because a lane
may hold a CUDA context:

* a worker whose measurement raised reports the error (kind ``raise``,
  as there) and then *exits*: after a CUDA error its context is broken,
  so no later job may run on it; the slot respawns through the respawn
  budget;
* an in-process lane (simulated, thread, or a process slot degraded to
  a thread) does not turn an exception into an ``inf`` trial: it ends
  the session, because the caller's own context cannot be trusted after
  it (the measured backend already returns ``inf`` for a schedule the
  kernel refuses);
* workers start by ``forkserver`` or ``spawn``, never ``fork``: a child
  forked from a process that holds a CUDA context cannot use the card.
  Each worker opens its own context on first use.

Real executors own their **kill timeout** (``timeout_s``, default 60 s):
how long a lane may really run before it is abandoned or killed.  It is
distinct from ``MeasureEngine.timeout_s``, the simulated clock's
charging cap.  Executors with ``real_time = True`` report measured
per-lane wall seconds, which the engine charges to the search clock
instead of the occupancy model.
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
import math
import multiprocessing
import time
from typing import Optional, Sequence

from .cost.base import CostBackend, backend_from_spec
from .space import State

__all__ = [
    "LaneExecutor",
    "LaneResult",
    "SimulatedExecutor",
    "ThreadExecutor",
    "ProcessExecutor",
    "EXECUTORS",
    "make_executor",
    "stop_worker_servers",
]


@dataclasses.dataclass
class LaneResult:
    """What one measurement lane hands back for one state."""

    cost: float
    wall_s: float = 0.0  # measured lane wall time (0 under simulation)
    error: Optional[str] = None  # crash / timeout / raised-exception note
    #: failure taxonomy (see ``repro_torch.core.fault``): ``"crash"`` /
    #: ``"timeout"`` / ``"spawn"`` are transient (retry-able), ``"raise"``
    #: is permanent.  ``None`` on success; executors that only set
    #: ``error`` are classified by the engine via ``classify_error``.
    kind: Optional[str] = None


class LaneExecutor(abc.ABC):
    """Runs the cache-miss portion of one measurement wave."""

    name: str = "base"
    #: True when ``LaneResult.wall_s`` is measured wall-clock the engine
    #: should charge, False when occupancy must come from the clock model.
    real_time: bool = False

    @abc.abstractmethod
    def run_wave(
        self,
        backend: CostBackend,
        states: Sequence[State],
        timeout_s: Optional[float] = None,
    ) -> list[LaneResult]:
        """Measure ``states`` (one per lane); results align with input."""

    def close(self) -> None:
        """Release lanes (threads/processes). Idempotent."""

    def __enter__(self) -> "LaneExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SimulatedExecutor(LaneExecutor):
    """In-thread lanes with modeled occupancy.  A backend exception is
    not turned into an ``inf`` trial: it ends the session (see the
    module docstring)."""

    name = "sim"
    real_time = False

    def run_wave(self, backend, states, timeout_s=None):
        if len(states) == 1:
            return [LaneResult(cost=backend.cost(states[0]))]
        return [LaneResult(cost=c) for c in backend.batch_cost(states)]


class ThreadExecutor(LaneExecutor):
    """One daemon thread per lane (waves are measurement-bound, so
    per-wave thread spawn is noise).  Real overlap only where the
    backend drops the GIL; a timed-out lane is abandoned — daemon
    threads mean an abandoned lane can never block interpreter
    shutdown the way a ThreadPoolExecutor's atexit join would."""

    name = "thread"
    real_time = True

    def __init__(self, timeout_s: Optional[float] = 60.0):
        self.timeout_s = timeout_s  # kill timeout; None = never abandon

    def run_wave(self, backend, states, timeout_s=None):
        import threading

        timeout = timeout_s if timeout_s is not None else self.timeout_s
        box: list = [None] * len(states)

        def lane(i: int, s: State) -> None:
            box[i] = _in_thread(backend, s)

        threads = [
            threading.Thread(
                target=lane, args=(i, s), daemon=True, name=f"measure-lane-{i}"
            )
            for i, s in enumerate(states)
        ]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        results: list[LaneResult] = []
        for i, t in enumerate(threads):
            remaining = (
                None
                if timeout is None
                else max(0.0, t_start + timeout - time.perf_counter())
            )
            t.join(remaining)
            if t.is_alive():  # abandoned: its eventual box write is dropped
                results.append(
                    LaneResult(
                        cost=math.inf,
                        wall_s=time.perf_counter() - t_start,
                        error=f"lane timeout after {timeout:g}s",
                        kind="timeout",
                    )
                )
            else:
                results.append(_unbox(box[i]))
        return results


def _in_thread(backend, s: State):
    """One in-process measurement: its LaneResult, or the exception it
    raised (re-raised by the caller in its own thread)."""
    t0 = time.perf_counter()
    try:
        c = backend.cost(s)
    except BaseException as e:  # noqa: BLE001 — handed to the caller's thread
        return e
    return LaneResult(cost=c, wall_s=time.perf_counter() - t0)


def _unbox(result):
    if isinstance(result, BaseException):
        raise result
    return result


def _worker_main(conn) -> None:
    """Measurement worker loop: rebuild backends from specs (cached per
    spec, so a backend's operands survive across jobs), measure one state
    per job, report ``("ok", cost, wall)``; a measurement that raised
    reports ``("err", message)`` and ends the worker, whose context may
    be broken.  Runs until the sentinel ``None`` or parent death."""
    backends: dict = {}
    while True:
        try:
            job = conn.recv()
        except (EOFError, OSError):
            return
        if job is None:
            return
        if job == "ping":  # liveness probe (see ProcessExecutor.warm_up)
            conn.send("pong")
            continue
        if job[0] == "prewarm":
            # build the backend ahead of the first measurement so lane
            # wall-clocks never include its construction (operands on the
            # card, the kernel library's load)
            try:
                key = repr(job[1])
                if key not in backends:
                    backends[key] = backend_from_spec(job[1])
            except BaseException:  # noqa: BLE001 — surface it on the real job
                pass
            conn.send("prewarmed")
            continue
        if job[0] == "call":  # see ProcessExecutor.worker_call
            mod_name, _, attr = job[1].partition(":")
            conn.send(("called", getattr(importlib.import_module(mod_name), attr)()))
            continue
        spec, state_lists = job
        try:
            key = repr(spec)
            backend = backends.get(key)
            if backend is None:
                backend = backends[key] = backend_from_spec(spec)
            t0 = time.perf_counter()
            # the state class is op-specific: the rebuilt backend's space
            # owns the deserialization (operator-agnostic lane protocol)
            cost = backend.cost(backend.space.state_from_lists(state_lists))
            wall = time.perf_counter() - t0
            conn.send(("ok", cost, wall))
        except BaseException as e:  # noqa: BLE001 — reported, then the worker ends
            try:
                conn.send(("err", f"{type(e).__name__}: {e}"))
            except (BrokenPipeError, OSError):
                pass
            return


class _Worker:
    """One lane: a persistent process plus its duplex pipe."""

    def __init__(self, ctx):
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main, args=(child,), daemon=True)
        self.proc.start()
        child.close()  # parent keeps only its end

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        # idempotent: a lane may be killed at timeout AND reaped again
        # by the next wave's _ensure_workers
        try:
            self._end()
        except (ValueError, OSError):
            pass
        try:
            self.conn.close()
        except OSError:
            pass

    def _end(self) -> None:
        """SIGTERM, then SIGKILL if the process still runs 2 s later; no
        worker outlives its lane."""
        self.proc.terminate()
        self.proc.join(timeout=2.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10.0)

    def reap(self) -> None:
        """Wait for a worker that is ending on its own (after a raise)."""
        self.proc.join(timeout=10.0)
        if self.proc.is_alive():
            self.kill()

    def stop(self) -> None:
        """Graceful: sentinel, short join, then terminate and kill."""
        try:
            self.conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout=2.0)
        if self.proc.is_alive():
            self._end()
        self.conn.close()


class ProcessExecutor(LaneExecutor):
    """Persistent worker-process lanes with per-lane timeouts and crash
    isolation (TVM's measure-worker pattern, pipes instead of RPC).

    Requires ``backend.worker_spec()`` — the backend is rebuilt inside
    each worker, never pickled.  ``mp_context`` defaults to
    ``forkserver`` where available (workers fork from a clean server
    process that never touched the card), falling back to ``spawn``;
    ``fork`` is refused.
    """

    name = "process"
    real_time = True

    def __init__(
        self,
        timeout_s: Optional[float] = 60.0,
        mp_context: Optional[str] = None,
        spawn_timeout_s: float = 120.0,
        max_respawns: int = 3,
        respawn_backoff_s: float = 0.05,
    ):
        self.timeout_s = timeout_s  # per-lane kill timeout; None = wait forever
        self.spawn_timeout_s = spawn_timeout_s
        # per-lane-slot respawn budget: after ``max_respawns`` worker
        # deaths a slot stops burning processes and degrades to the
        # in-thread (ThreadExecutor) path for the rest of the run — a
        # deterministic crasher must not respawn forever, once per wave
        self.max_respawns = max(0, int(max_respawns))
        self.respawn_backoff_s = respawn_backoff_s
        if mp_context is None:
            methods = multiprocessing.get_all_start_methods()
            mp_context = "forkserver" if "forkserver" in methods else "spawn"
        if mp_context not in ("forkserver", "spawn"):
            raise ValueError(
                f"mp_context={mp_context!r}: workers start by forkserver or "
                "spawn; a child forked from a process holding a CUDA "
                "context cannot use the card"
            )
        self._ctx = multiprocessing.get_context(mp_context)
        if mp_context == "forkserver":
            # the server imports torch and the port once (no CUDA context),
            # and every worker forks from it instead of importing anew
            # (seconds each).  torch by name: some Pythons (3.12.3) start
            # the server without the parent's sys.path, so a port put on
            # the path at run time does not import there, but torch does
            self._ctx.set_forkserver_preload(["torch", __name__])
        # positional lane slots: slot i keeps its respawn count across
        # worker generations (None = never spawned, or degraded)
        self._workers: list[Optional[_Worker]] = []
        self._respawns: list[int] = []
        self._degraded: set[int] = set()
        self.n_respawns = 0  # lifetime worker respawns (all slots)
        self.n_spare_adoptions = 0  # deaths absorbed by a warm spare

    def fault_stats(self) -> dict:
        """Lifetime hardening counters; the engine snapshot-diffs these
        per wave into :class:`~repro_torch.core.measure.MeasureStats`."""
        return {
            "n_respawns": self.n_respawns,
            "n_degraded_lanes": len(self._degraded),
            "n_spare_adoptions": self.n_spare_adoptions,
        }

    def _ensure_workers(self, n: int) -> None:
        """Reap dead workers and (re)spawn slots up to ``n``, blocking
        until fresh ones answer a liveness ping — interpreter start-up
        and repro imports must never count against a lane's measurement
        timeout.  Each observed worker death consumes one respawn from
        its slot's budget, with exponential backoff between respawns;
        a slot whose budget is exhausted is degraded (logged once) and
        served in-thread by ``run_wave`` from then on."""
        while len(self._workers) < n:
            self._workers.append(None)
            self._respawns.append(0)
        fresh: list[_Worker] = []
        for i in range(n):
            if i in self._degraded:
                continue
            w = self._workers[i]
            if w is not None and w.alive():
                continue
            if w is not None:
                # an observed death: reap it and charge the slot budget
                w.kill()
                self._workers[i] = None
                self._respawns[i] += 1
                self.n_respawns += 1
                if self._respawns[i] > self.max_respawns:
                    self._degraded.add(i)
                    print(
                        f"[executor] lane {i}: worker died "
                        f"{self._respawns[i]} times (respawn budget "
                        f"{self.max_respawns} exhausted); degrading to "
                        "in-thread measurement for the rest of the run"
                    )
                    continue
                # hot-spare adoption: ``warm_up(n_lanes + spares)`` parks
                # warm workers beyond the wave; a dead lane adopts one
                # instantly instead of paying a cold interpreter start-up
                # on the respawn path (the death still charges the budget)
                for j in range(n, len(self._workers)):
                    cand = self._workers[j]
                    if j not in self._degraded and cand is not None and cand.alive():
                        self._workers[i] = cand
                        self._workers[j] = None
                        self.n_spare_adoptions += 1
                        break
                if self._workers[i] is not None:
                    continue
                if self.respawn_backoff_s > 0:
                    time.sleep(
                        self.respawn_backoff_s * (2.0 ** (self._respawns[i] - 1))
                    )
            self._workers[i] = w2 = _Worker(self._ctx)
            fresh.append(w2)
        for w in fresh:
            try:
                w.conn.send("ping")
            except (BrokenPipeError, OSError):
                pass
        deadline = time.perf_counter() + self.spawn_timeout_s
        for w in fresh:
            try:
                if w.conn.poll(max(0.0, deadline - time.perf_counter())):
                    w.conn.recv()
            except (EOFError, OSError):
                pass  # dead at birth: run_wave resolves its lane to inf

    def run_wave(self, backend, states, timeout_s=None):
        import threading

        spec = backend.worker_spec()
        if spec is None:
            raise ValueError(
                f"backend {backend.name!r} has no worker_spec(); "
                "ProcessExecutor needs a process-shippable backend recipe "
                "(use ThreadExecutor or SimulatedExecutor instead)"
            )
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        self._ensure_workers(len(states))
        results: list[Optional[LaneResult]] = [None] * len(states)

        # degraded slots run the ThreadExecutor path on the engine-side
        # backend (its measured cost takes the same per-card timing
        # gate), overlapping the process lanes dispatched below
        def deg_lane(box: list, s: State) -> None:
            box[0] = _in_thread(backend, s)

        deg: dict[int, tuple] = {}
        for i, s in enumerate(states):
            if i in self._degraded:
                box: list = [None]
                t0 = time.perf_counter()
                th = threading.Thread(
                    target=deg_lane, args=(box, s), daemon=True,
                    name=f"degraded-lane-{i}",
                )
                th.start()
                deg[i] = (th, box, t0)
        sent_t: list[float] = [0.0] * len(states)
        dead_on_send: set[int] = set()
        for i, s in enumerate(states):
            if i in deg:
                continue
            w = self._workers[i]
            if w is None:
                dead_on_send.add(i)
                sent_t[i] = time.perf_counter()
                continue
            try:
                w.conn.send((spec, s.as_lists()))
            except (BrokenPipeError, OSError):
                dead_on_send.add(i)
            sent_t[i] = time.perf_counter()
        for i in range(len(states)):
            if i in deg:
                continue
            w = self._workers[i]
            if i in dead_on_send:
                if w is not None:
                    w.kill()
                results[i] = LaneResult(
                    cost=math.inf,
                    error="worker died before dispatch",
                    kind="spawn",
                )
                continue
            remaining = (
                None
                if timeout is None
                else max(0.0, sent_t[i] + timeout - time.perf_counter())
            )
            try:
                if not w.conn.poll(remaining):
                    w.kill()
                    results[i] = LaneResult(
                        cost=math.inf,
                        wall_s=time.perf_counter() - sent_t[i],
                        error=f"lane timeout after {timeout:g}s (worker killed)",
                        kind="timeout",
                    )
                    continue
                msg = w.conn.recv()
            except (EOFError, OSError):
                w.kill()
                results[i] = LaneResult(
                    cost=math.inf,
                    wall_s=time.perf_counter() - sent_t[i],
                    error="worker crashed mid-measurement",
                    kind="crash",
                )
                continue
            if msg[0] == "ok":
                results[i] = LaneResult(cost=msg[1], wall_s=msg[2])
            else:
                # the worker reported a raise and is exiting: reap it now so
                # the next wave respawns the slot (charging its budget)
                w.reap()
                results[i] = LaneResult(
                    cost=math.inf,
                    wall_s=time.perf_counter() - sent_t[i],
                    error=msg[1],
                    kind="raise",
                )
        for i, (th, box, t0) in deg.items():
            remaining = (
                None
                if timeout is None
                else max(0.0, t0 + timeout - time.perf_counter())
            )
            th.join(remaining)
            if th.is_alive():  # abandoned, same as ThreadExecutor
                results[i] = LaneResult(
                    cost=math.inf,
                    wall_s=time.perf_counter() - t0,
                    error=f"lane timeout after {timeout:g}s (degraded lane)",
                    kind="timeout",
                )
            else:
                results[i] = _unbox(box[0])
        return results

    def warm_up(self, n_lanes: int, backend=None) -> None:
        """Pre-spawn ``n_lanes`` ready workers so not even the *first*
        wave's wall-clock includes process start-up (``run_wave`` already
        excludes start-up from lane timeouts via ``_ensure_workers``).

        With ``backend``, each worker also pre-builds the backend from
        its ``worker_spec()`` — its CUDA context, operands and kernel
        library are made here instead of inside the first measurement
        wave.  Spawning more lanes than
        the wave width parks warm spares that dead lanes adopt instantly
        (see ``_ensure_workers``)."""
        self._ensure_workers(n_lanes)
        if backend is None:
            return
        spec = backend.worker_spec()
        if spec is None:
            return
        warmed: list[_Worker] = []
        for w in self._workers[:n_lanes]:
            if w is None or not w.alive():
                continue
            try:
                w.conn.send(("prewarm", spec))
                warmed.append(w)
            except (BrokenPipeError, OSError):
                pass
        deadline = time.perf_counter() + self.spawn_timeout_s
        for w in warmed:
            try:
                if w.conn.poll(max(0.0, deadline - time.perf_counter())):
                    w.conn.recv()
            except (EOFError, OSError):
                pass  # dead during prewarm: run_wave resolves it later

    def worker_call(self, entry: str) -> list:
        """Call the no-argument ``"module:function"`` in every live
        worker and return the results (e.g. each worker's peak device
        memory, ``repro_torch.core.cost.measured:worker_stats``)."""
        out = []
        for w in self._workers:
            if w is None or not w.alive():
                continue
            w.conn.send(("call", entry))
            if not w.conn.poll(self.spawn_timeout_s):
                raise TimeoutError(f"worker {w.proc.pid} did not answer {entry}")
            out.append(w.conn.recv()[1])
        return out

    def close(self) -> None:
        workers, self._workers = self._workers, []
        self._respawns = []
        for w in workers:
            if w is None:
                continue
            if w.alive():
                w.stop()
            else:
                w.kill()


def stop_worker_servers() -> None:
    """Stop the forkserver and the resource tracker that process lanes
    started in this process, and wait for both to exit.  Python stops
    them only when the interpreter ends, and they outlive it for a
    moment; a program that must stop every process it starts calls this
    after its last ``ProcessExecutor`` is closed.  A later executor
    starts them anew."""
    from multiprocessing import forkserver, resource_tracker

    # the server first: it and its workers hold the tracker's pipe open
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


EXECUTORS = {
    "sim": SimulatedExecutor,
    "thread": ThreadExecutor,
    "process": ProcessExecutor,
}


def make_executor(name: str, **kwargs) -> LaneExecutor:
    """Build a lane executor by CLI name (``sim``/``thread``/``process``)."""
    try:
        cls = EXECUTORS[name]
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; pick from {sorted(EXECUTORS)}")
    return cls(**kwargs)
