"""Measured cost on the card — the main path's oracle.

:class:`HopperTimedCost` times the op's hand-written kernel (the
registry's ``kernel_run`` binding; ``kernels/csrc/gemm.cu`` for GEMM,
``kernels/csrc/flash_attention.cu`` for flash) under each schedule
state, as the paper times candidates on real hardware:

* operands live on the card, made when the backend is built from a
  seeded generator (for flash, one sequence of the space's head
  layout); their shapes are part of ``measure_fingerprint``, and so is
  the digest of the kernel's source (``kernel_source_part``);
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
per-state build to cache.  One process drives the card, so no timing
gate is needed between lanes.
"""

from __future__ import annotations

import math

import torch

from ..analysis import HopperSpec, ScheduleAnalyzer, dtype_in_bytes
from ..space import SearchSpace, State
from .base import CostBackend

__all__ = ["HopperTimedCost", "kernel_source_part"]

#: bytes written between timed launches: twice the H100's 50 MB L2
_L2_FLUSH_BYTES = 100 * 1024 * 1024
#: device clock cycles spun before each timed launch (about 0.5 ms)
_SPIN_CYCLES = 1_000_000


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
        self._operands = self._opspec.operands(space, dtype, seed, self.device)
        self._flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device=self.device)

    def _run(self, s: State) -> None:
        self._opspec.kernel_run(self.space, s, self._operands)

    def cost(self, s: State) -> float:
        if self.analyzer.analyze(s).illegal:
            return math.inf
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

    def measure_fingerprint(self) -> str:
        # the card, the software stack and the kernel's source change
        # every measured value; seed fixes the operand contents, the
        # shapes what is timed
        shapes = ",".join("x".join(map(str, t.shape)) for t in self._operands)
        return (
            f"r{self.n_repeats}|{self.dtype}|seed{self.seed}|spin{_SPIN_CYCLES}"
            f"|{torch.cuda.get_device_name(self.device)}"
            f"|torch{torch.__version__}|cuda{torch.version.cuda}"
            f"|{kernel_source_part(self._opspec)}"
            f"|operands={shapes}"
            + self.space_fingerprint()
        )


def kernel_source_part(opspec) -> str:
    """The fingerprint part naming the source an op's kernel is built
    from: a journal measured on another build of it is re-measured, not
    served."""
    from repro_torch.kernels import build

    return f"src={opspec.kernel_source}@{build.source_digest(opspec.kernel_source, build.CSRC_DIR)}"
