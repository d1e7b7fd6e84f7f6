"""Analytical H100 cost model of the flash-attention kernel — the flash
op's CPU-side oracle, the twin of
:class:`~repro_torch.core.cost.analytical.AnalyticalHopperCost` for GEMM.

A deterministic model of ``kernels/csrc/flash_attention.cu`` on an H100,
on the operand the measured backend times (one sequence of the space's
``heads`` query heads).  It takes no time on the card and serves
``tune --op flash --cost analytical`` and tests on machines without one.
States the kernel cannot launch cost ``inf`` (the shared launch rule of
``repro_torch.core.analysis``).  For the rest:

* compute time: every kv-block visit (exact, the kernel's causal
  early-exit bound, equal to the JAX package's count) does
  ``4 * bq * bkv * hd`` operations of the two products at the CUDA-core
  f32 rate, at half efficiency (about one shared-memory load per FMA),
  plus ``bq * bkv`` exponentials at the special-function rate, scaled by
  how full the last wave of CTAs leaves the SMs;
* memory time: Q read and O written once, and a K and a V tile read per
  visit (the kernel streams them), at the card's memory rate;
* overhead: two block-wide barriers per visit, serialised over the
  visits of one CTA's sequential loop.

The larger of compute and memory, plus the overhead, is the cost.
"""

from __future__ import annotations

import math

import numpy as np

from ..analysis import (
    HopperSpec,
    ScheduleAnalyzer,
    dtype_in_bytes,
    flash_threads_per_row,
)
from ..flash_space import FlashAttnConfigSpace, FlashScheduleState
from .base import CostBackend

__all__ = ["FlashAnalyticalHopperCost"]

#: H100 SXM data sheet: non-tensor f32 FMA rate and HBM3 bandwidth
_F32_FLOPS = 67e12
_HBM_BYTES_S = 3.35e12
#: exponentials per second: 16 special-function results per clock per SM
#: at 1.83 GHz on 132 SMs
_SFU_PER_S = 16 * 1.83e9 * 132
_SMEM_PER_SM = 233_472
_THREADS_PER_SM = 2048
#: one __syncthreads round trip, seconds (about 40 clocks)
_BARRIER_S = 2.2e-8


class FlashAnalyticalHopperCost(CostBackend):
    name = "analytical_h100"

    def __init__(self, space: FlashAttnConfigSpace, n_repeats: int = 1,
                 dtype: str = "bfloat16", spec: HopperSpec | None = None):
        super().__init__(space, n_repeats)
        self.dtype = dtype
        self.in_bytes = dtype_in_bytes(dtype)
        self.spec = spec or HopperSpec()
        self.analyzer = ScheduleAnalyzer(space, self.spec, self.in_bytes)
        # visits depend only on the block schedule: memoize per (bq, bkv)
        self._visits_cache: dict[tuple[int, int], int] = {}

    def kv_visits(self, s: FlashScheduleState) -> int:
        """Total kv-block visits across the q grid of one head — exact,
        matching the kernel's causal early-exit bound ``last``."""
        bq, bkv = s.block_q, s.block_kv
        n_q, n_kv = s.n_q_blocks, s.n_kv_blocks
        if not self.space.causal:
            return n_q * n_kv
        cached = self._visits_cache.get((bq, bkv))
        if cached is None:
            ends = (np.arange(1, n_q + 1, dtype=np.int64) * bq + bkv - 1) // bkv
            cached = int(np.minimum(ends, n_kv).sum())
            self._visits_cache[(bq, bkv)] = cached
        return cached

    def cost_once(self, s: FlashScheduleState, repeat_idx: int) -> float:
        if self.analyzer.analyze(s).illegal:
            return math.inf
        sp = self.space
        bq, bkv, hd = s.block_q, s.block_kv, sp.head_dim
        heads = sp.heads
        visits = self.kv_visits(s) * heads
        threads = bq * flash_threads_per_row(hd)
        smem = sp.working_set_bytes(s, self.in_bytes)
        per_sm = max(1, min(_THREADS_PER_SM // threads, _SMEM_PER_SM // smem, 32))
        slots = per_sm * self.spec.num_sms
        ctas = s.n_q_blocks * heads
        fill = ctas / (math.ceil(ctas / slots) * slots)
        t_compute = (
            visits * 4.0 * bq * bkv * hd / (0.5 * _F32_FLOPS)
            + visits * bq * bkv / _SFU_PER_S
        ) / fill
        traffic = (
            2 * sp.seq_q * heads * hd  # Q read, O written
            + visits * 2 * bkv * hd  # a K and a V tile per visit
        ) * self.in_bytes
        t_overhead = 2 * _BARRIER_S * self.kv_visits(s) / s.n_q_blocks
        return max(t_compute, traffic / _HBM_BYTES_S) + t_overhead

    def measure_fingerprint(self) -> str:
        return f"r{self.n_repeats}|{self.dtype}" + self.space_fingerprint()
