"""Analytical H100 cost model of the GEMM kernel — the CPU-side oracle.

A deterministic model of ``kernels/csrc/gemm.cu`` on an H100: it takes
no time on the card and serves tests and searches on machines without
one.  It is not the main path's cost (that is
:class:`~repro_torch.core.cost.measured.HopperTimedCost`).  States the
kernel cannot launch cost ``inf`` (the shared rule of
``repro_torch.core.analysis``).  For the rest:

* compute time: ``2*M*K*N`` FMA-operations at the CUDA-core f32 rate,
  scaled by the share of the inner loop's instructions that are FMAs
  (``rm*rn`` FMAs per ``rm + rn`` shared-memory loads) and by how full
  the last wave of CTAs leaves the SMs;
* memory time: every CTA reads its A and B strips once (A is read
  ``n0`` times over, B ``m0`` times) and writes its C tile once, at the
  card's memory rate.

The larger of the two is the cost.
"""

from __future__ import annotations

import math

from ..analysis import HopperSpec, ScheduleAnalyzer, dtype_in_bytes
from ..space import State
from .base import CostBackend

__all__ = ["AnalyticalHopperCost"]

#: H100 SXM data sheet: non-tensor f32 FMA rate and HBM3 bandwidth
_F32_FLOPS = 67e12
_HBM_BYTES_S = 3.35e12
_SMEM_PER_SM = 233_472
_THREADS_PER_SM = 2048


class AnalyticalHopperCost(CostBackend):
    name = "analytical_h100"

    def __init__(self, space, n_repeats: int = 1, dtype: str = "bfloat16",
                 spec: HopperSpec | None = None):
        super().__init__(space, n_repeats)
        self.dtype = dtype
        self.in_bytes = dtype_in_bytes(dtype)
        self.spec = spec or HopperSpec()
        self.analyzer = ScheduleAnalyzer(space, self.spec, self.in_bytes)

    def cost_once(self, s: State, repeat_idx: int) -> float:
        if self.analyzer.analyze(s).illegal:
            return math.inf
        m, k, n = self.space.dims
        m0, _, n0 = s.grid
        rm, rn = s.reg_m, s.reg_n
        threads = (s.block_m // rm) * (s.block_n // rn)
        smem = self.space.working_set_bytes(s, self.in_bytes)
        per_sm = max(1, min(_THREADS_PER_SM // threads, _SMEM_PER_SM // smem, 32))
        slots = per_sm * self.spec.num_sms
        ctas = m0 * n0
        fill = ctas / (math.ceil(ctas / slots) * slots)
        fma_share = rm * rn / (rm * rn + rm + rn)
        t_compute = 2.0 * m * k * n / (_F32_FLOPS * fma_share * fill)
        traffic = (m * k * n0 + k * n * m0 + m * n) * self.in_bytes
        return max(t_compute, traffic / _HBM_BYTES_S)

    def measure_fingerprint(self) -> str:
        return f"r{self.n_repeats}|{self.dtype}" + self.space_fingerprint()
