"""Measured cost on the card — the main path's oracle.

:class:`HopperTimedCost` times the op's hand-written kernel (the
registry's ``kernel_run`` binding; ``kernels/csrc/gemm.cu`` for GEMM,
``kernels/csrc/flash_attention.cu`` for flash) under each schedule
state, as the paper times candidates on real hardware:

* operands live on the card, made when the backend is built from a
  seeded generator (for flash, one sequence of the space's head
  layout); ``measure_fingerprint`` names the seed, the card, the
  software stack and the digest of the kernel's source
  (``kernel_source_part``), while the workload key and the space's
  kwargs name the shapes;
* one untimed warm-up launch, then ``n_repeats`` launches, each timed
  with CUDA events, with the 50 MB L2 flushed before each so every
  launch starts from device memory, and the card spinning for about
  0.5 ms before the start event so the host has enqueued the launch
  (decode's products take microseconds, less than the wrapper's host
  overhead); the cost is their mean in seconds;
* a state the static analyzer calls ILLEGAL, or that the kernel's
  wrapper refuses with ``ValueError``, costs ``inf`` without a launch.
  Anything else the wrapper raises (a failed build or launch)
  propagates: the search stops rather than charging a broken context.

Tile sizes are runtime arguments of one compiled kernel, so there is no
per-state build to cache: the kernel's library is built (or loaded) when
the backend is, outside any timed region.

Every lane that shares the card — threads of one process, worker
processes of a :class:`~repro_torch.core.executor.ProcessExecutor`, the
processes of a sharded search — times its kernels through one
:class:`TimingGate` per card, so no two timed regions overlap (two
kernels sharing the SMs would make both timings wrong).  The gate covers
the warm-up launch, the L2 flush, the spin and the timed launches;
building operands stays outside it.  ``worker_spec()`` ships the
backend's recipe to worker processes, which rebuild it on their own
CUDA context.
"""

from __future__ import annotations

import importlib
import math
import os
import tempfile
import threading
from typing import Optional

import torch

from ..analysis import HopperSpec, ScheduleAnalyzer, dtype_in_bytes
from ..space import SearchSpace, State
from .base import CostBackend, space_from_spec, space_spec

__all__ = [
    "HopperTimedCost", "TimingGate", "kernel_source_part", "timing_lock_path",
    "worker_stats",
]

#: bytes written between timed launches: twice the H100's 50 MB L2
_L2_FLUSH_BYTES = 100 * 1024 * 1024
#: device clock cycles spun before each timed launch (about 0.5 ms)
_SPIN_CYCLES = 1_000_000


class TimingGate:
    """Serializes timed regions on one card: a thread lock covers lanes
    sharing one backend object, an exclusive ``flock`` on ``lock_path``
    covers every other holder on the host (worker processes, sibling
    shards, other backend objects).

    A lock that cannot be opened or taken raises: measuring unserialized
    would hand out wrong costs.  The gate also checks itself: a holder
    that finds another live holder's marker inside the region counts an
    overlap in ``<lock_path>.overlaps`` (one byte each, ``O_APPEND``), and
    every entry appends one byte to ``<lock_path>.entries``;
    :meth:`stats` reads both."""

    def __init__(self, lock_path: str):
        self.lock_path = lock_path
        self._tlock = threading.Lock()
        self._fd: Optional[int] = None

    def _flock(self, op: int) -> None:
        import fcntl

        if self._fd is None:
            self._fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(self._fd, op)

    @staticmethod
    def _append(path: str) -> None:
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, b"x")
        finally:
            os.close(fd)

    def _mark_held(self) -> None:
        """Publish this holder; another live holder's marker is an overlap."""
        held = self.lock_path + ".held"
        token = f"{os.getpid()}:{id(self)}"
        while True:
            try:
                fd = os.open(held, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            except FileExistsError:
                try:
                    with open(held) as f:
                        other = f.read()
                    pid = int(other.split(":")[0])
                except (OSError, ValueError):
                    other, pid = "", 0
                if other != token and pid and _alive(pid):
                    self._append(self.lock_path + ".overlaps")
                try:
                    os.unlink(held)  # a dead holder's (killed mid-region)
                except FileNotFoundError:
                    pass
                continue
            with os.fdopen(fd, "w") as f:
                f.write(token)
            return

    def __enter__(self) -> "TimingGate":
        import fcntl

        self._tlock.acquire()
        try:
            self._flock(fcntl.LOCK_EX)
            self._mark_held()
            self._append(self.lock_path + ".entries")
        except BaseException:
            self._tlock.release()
            raise
        return self

    def __exit__(self, *exc) -> None:
        import fcntl

        try:
            try:
                os.unlink(self.lock_path + ".held")
            except FileNotFoundError:
                pass
            self._flock(fcntl.LOCK_UN)
        finally:
            self._tlock.release()

    def stats(self) -> dict:
        """``{"entries": n, "overlaps": n}`` over every holder so far."""
        out = {}
        for name in ("entries", "overlaps"):
            try:
                out[name] = os.path.getsize(f"{self.lock_path}.{name}")
            except FileNotFoundError:
                out[name] = 0
        return out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def timing_lock_path(device) -> str:
    """The one timing lock of a card, under the system temp directory:
    keyed by the card's index and UUID, never by workload or process."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    uuid = str(getattr(props, "uuid", props.name)).replace(" ", "_")
    return os.path.join(tempfile.gettempdir(), f"repro_torch-timing-cuda{index}-{uuid}.lock")


def worker_stats() -> dict:
    """This process's peak device memory (its caching allocator's) and
    the launches of each kernel wrapper by shape (flash's by dtype too):
    a measurement worker reports them through
    ``ProcessExecutor.worker_call``."""
    from repro_torch.kernels.ledger import launches

    out = {"pid": os.getpid(), "peak_allocated": 0, "peak_reserved": 0}
    if torch.cuda.is_initialized():
        out.update(peak_allocated=torch.cuda.max_memory_allocated(),
                   peak_reserved=torch.cuda.max_memory_reserved())
    for kind in ("gemm", "flash"):
        out[f"{kind}_launches"] = {"x".join(map(str, d)): n for d, n in launches(kind).items()}
    out["flash_dtype_launches"] = dict(launches("flash", "dtype"))
    return out


def _hopper_timed_from_spec(op, dims, depths, space_kwargs, n_repeats, dtype,
                            seed, device) -> "HopperTimedCost":
    """Worker-process factory (see ``CostBackend.worker_spec``)."""
    return HopperTimedCost(space_from_spec(op, dims, depths, space_kwargs),
                           n_repeats=n_repeats, dtype=dtype, seed=seed, device=device)


class HopperTimedCost(CostBackend):
    name = "hopper_timed"

    def __init__(
        self,
        space: SearchSpace,
        n_repeats: int = 3,
        dtype: str = "bfloat16",
        seed: int = 0,
        device="cuda",
    ):
        super().__init__(space, n_repeats, dtype)
        self.device = torch.device(device)
        if self.device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"HopperTimedCost times the CUDA kernel and needs a card "
                f"(device={self.device}, cuda available="
                f"{torch.cuda.is_available()})"
            )
        from ..ops import get_op  # lazy: the registry imports cost modules

        self.in_bytes = dtype_in_bytes(dtype)
        self.seed = seed
        self.spec = HopperSpec.for_device(self.device)
        self.analyzer = ScheduleAnalyzer(space, self.spec, self.in_bytes)
        self._opspec = get_op(self.op)
        # build or load the kernel's library now, not inside a timed lane
        stem = os.path.splitext(self._opspec.kernel_source)[0]
        importlib.import_module(f"repro_torch.kernels.{stem}").build_kernel()
        self._operands = self._opspec.operands(space, dtype, seed, self.device)
        self._flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device=self.device)
        self.gate = TimingGate(timing_lock_path(self.device))

    def _run(self, s: State) -> None:
        self._opspec.kernel_run(self.space, s, self._operands)

    def cost(self, s: State) -> float:
        if self.analyzer.analyze(s).illegal:
            return math.inf
        with self.gate:
            try:
                self._run(s)  # warm-up launch, never timed
            except ValueError:  # a schedule the kernel refuses
                return math.inf
            return sum(self.cost_once(s, r) for r in range(self.n_repeats)) / self.n_repeats

    def cost_once(self, s: State, repeat_idx: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        self._flush.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        self._run(s)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def worker_spec(self):
        sp = space_spec(self.space)
        if sp is None:  # a constraint closure does not survive the round trip
            return None
        return (
            "repro_torch.core.cost.measured:_hopper_timed_from_spec",
            {**sp, "n_repeats": self.n_repeats, "dtype": self.dtype,
             "seed": self.seed, "device": str(self.device)},
        )

    def measure_fingerprint(self) -> str:
        # the card, the software stack and the kernel's source change
        # every measured value; seed fixes the operand contents.  What is
        # timed is named by the workload key (dims, dtype) and the space's
        # kwargs (flash's head layout), not here, so one setting names
        # every shape's rows: the learned filter trains across shapes
        return (
            f"r{self.n_repeats}|{self.dtype}|seed{self.seed}|spin{_SPIN_CYCLES}"
            f"|{torch.cuda.get_device_name(self.device)}"
            f"|torch{torch.__version__}|cuda{torch.version.cuda}"
            f"|{kernel_source_part(self._opspec)}"
            + self.space_fingerprint()
        )


def kernel_source_part(opspec) -> str:
    """The fingerprint part naming the source an op's kernel is built
    from: a journal measured on another build of it is re-measured, not
    served."""
    from repro_torch.kernels import build

    return f"src={opspec.kernel_source}@{build.source_digest(opspec.kernel_source, build.CSRC_DIR)}"
