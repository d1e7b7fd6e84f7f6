"""Analytical H100 cost model of the flash-attention kernel — the flash
op's CPU-side oracle, the twin of
:class:`~repro_torch.core.cost.analytical.AnalyticalHopperCost` for GEMM.

A deterministic model of ``kernels/csrc/flash_attention.cu`` on an H100,
on the operand the measured backend times (one sequence of the space's
``heads`` query heads).  It takes no time on the card and serves
``tune --op flash --cost analytical`` and tests on machines without one.
States the kernel cannot launch cost ``inf`` (the shared launch rule of
``repro_torch.core.analysis``).  For the rest, over every kv-block visit
(exact, the kernel's causal early-exit bound, equal to the JAX package's
count), scaled by how full the last wave of CTAs leaves the SMs:

* bf16 (the tensor-core kernel): ``4 * bq * bkv * hd`` operations of the
  two products per visit at the dense bf16 tensor-core rate times
  ``_TC_EFFICIENCY`` (nothing overlaps a warpgroup's softmax with its
  products, and the CTA's warpgroups meet at a barrier every kv block),
  plus ``bq * bkv`` exponentials at the special-function rate; CTAs per
  SM from threads, the shared memory of the Q tile and the
  ``FLASH_STAGES`` ring of K/V tiles, and registers (the instantiation
  for each ``block_kv`` holds its own S fragments); one block-wide
  barrier per visit;
* f32 (the CUDA-core kernel): the same operations at the CUDA-core f32
  rate, scaled by the FMAs' share of a thread's FMAs and shared loads
  (its register tiles: 4 rows against ``block_kv / flash_row_threads``
  keys and ``head_dim / flash_row_threads`` columns; a load weighs
  ``_SIMT_LOAD_WEIGHT`` FMAs) and by how many warps an SM holds to hide
  their latency (``_SIMT_WARPS``); the exponentials; CTAs per SM from
  threads, the shared memory of its Q and P tiles and ring of K/V stages
  (``flash_stages``), and registers; one barrier per visit with two
  stages, two with one;
* memory time: Q read and O written once, and a K and a V tile read per
  visit (the kernel streams them), at the card's memory rate.

The larger of compute and memory, plus the barriers, serialised over the
visits of one CTA's sequential loop, is the cost; with ``noise_sigma >
0`` each repeat takes the GEMM model's seeded lognormal factor.
"""

from __future__ import annotations

import math

import numpy as np

from ..analysis import (
    FLASH_F32_ROWS,
    HopperSpec,
    ScheduleAnalyzer,
    dtype_in_bytes,
    flash_row_threads,
    flash_stages,
    flash_threads,
)
from ..flash_space import FlashAttnConfigSpace, FlashScheduleState
from .base import CostBackend, lognormal_noise

__all__ = ["FlashAnalyticalHopperCost"]

#: H100 SXM data sheet: non-tensor f32 FMA rate, dense bf16 tensor-core
#: rate and HBM3 bandwidth
_F32_FLOPS = 67e12
_BF16_TC_FLOPS = 989e12
_HBM_BYTES_S = 3.35e12
#: share of the tensor-core rate the bf16 kernel's products reach: an
#: estimate for a kernel whose softmax runs between its products
_TC_EFFICIENCY = 0.3
#: exponentials per second: 16 special-function results per clock per SM
#: at 1.83 GHz on 132 SMs
_SFU_PER_S = 16 * 1.83e9 * 132
_SMEM_PER_SM = 233_472
_THREADS_PER_SM = 2048
_REGS_PER_SM = 65_536
#: one __syncthreads round trip, seconds (about 40 clocks)
_BARRIER_S = 2.2e-8
#: the f32 kernel's rate: the FMAs a shared load weighs, and the warps an
#: SM needs to hide latency (the rate falls in proportion below them),
#: fitted to its spun times over the twelve (block_q, block_kv) its rule
#: launches at yi-6b's geometry in f32 on an H100 (``chip_smoke.py
#: --flash-f32-only``; PERF.md section 6)
_SIMT_LOAD_WEIGHT = 8.0
_SIMT_WARPS = 12
#: shared memory the card reserves for each resident CTA
_SMEM_RESERVED = 1024


class FlashAnalyticalHopperCost(CostBackend):
    name = "analytical_h100"

    def __init__(self, space: FlashAttnConfigSpace, n_repeats: int = 1,
                 dtype: str = "bfloat16", spec: HopperSpec | None = None,
                 noise_sigma: float = 0.0, seed: int = 0):
        super().__init__(space, n_repeats, dtype)
        self.in_bytes = dtype_in_bytes(dtype)
        self.spec = spec or HopperSpec()
        self.noise_sigma = noise_sigma
        self.seed = seed
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
        base = self._base_cost(s)
        if self.noise_sigma <= 0.0:
            return base
        return float(base * lognormal_noise(self.seed, s.key(), repeat_idx, self.noise_sigma))

    # -- the model's terms ------------------------------------------------------
    def compute_time(self, s: FlashScheduleState) -> float:
        """Seconds of the products and exponentials over every visit."""
        return self._terms(s)[0]

    def memory_time(self, s: FlashScheduleState) -> float:
        """Seconds of Q and O once and a K and a V tile a visit."""
        return self._terms(s)[1]

    def overhead_time(self, s: FlashScheduleState) -> float:
        """Seconds of the block-wide barriers of one CTA's visits."""
        return self._terms(s)[2]

    def breakdown(self, s: FlashScheduleState) -> dict:
        compute, memory, overhead = self._terms(s)
        return {
            "smem_bytes": self.space.working_set_bytes(s, self.in_bytes),
            "kernel": "wgmma" if self.in_bytes == 2 else "simt",
            "kv_visits": self.kv_visits(s),
            "compute_s": compute,
            "memory_s": memory,
            "overhead_s": overhead,
        }

    def optimum(self, max_states: int = 2_000_000) -> tuple[FlashScheduleState, float]:
        """Brute-force the space (flash spaces are small)."""
        from .analytical import brute_force_optimum

        return brute_force_optimum(self, max_states)

    def _base_cost(self, s: FlashScheduleState) -> float:
        compute, memory, overhead = self._terms(s)
        return max(compute, memory) + overhead

    def _terms(self, s: FlashScheduleState) -> tuple[float, float, float]:
        """``(compute, memory, overhead)`` seconds of a state the kernel
        launches; the cost is the larger of the first two plus the third."""
        sp = self.space
        bq, bkv, hd = s.block_q, s.block_kv, sp.head_dim
        heads = sp.heads
        visits = self.kv_visits(s) * heads
        threads = flash_threads(bq, hd, self.in_bytes)
        smem = sp.working_set_bytes(s, self.in_bytes)
        per_sm = min(_THREADS_PER_SM // threads, _SMEM_PER_SM // smem, 32)
        if self.in_bytes == 2:
            # the O and S accumulators in f32 plus about 48 registers of
            # addresses, P fragments and softmax state, per thread
            regs = hd // 2 + bkv // 2 + 48
            per_sm = min(per_sm, _REGS_PER_SM // (threads * regs))
            rate, barriers = _TC_EFFICIENCY * _BF16_TC_FLOPS, 1
        else:
            rt = flash_row_threads(hd)
            rns, rno = bkv // rt, hd // rt  # keys of S, columns of O a thread owns
            # the S and O accumulators plus about 48 registers of operands,
            # softmax state and addresses, under the launch bound's 128
            regs = min(128, FLASH_F32_ROWS * (rns + rno) + 48)
            per_sm = min(_THREADS_PER_SM // threads, _SMEM_PER_SM // (smem + _SMEM_RESERVED),
                         _REGS_PER_SM // (threads * regs), 32)
            # per visit a thread issues 4 (rns hd + rno bkv) FMAs against one
            # LDS of Q per d and of P per key, and a run of up to 4 floats
            # of K per d and of V per key
            ffma = FLASH_F32_ROWS * (rns * hd + rno * bkv)
            lds = hd * (1 + -(-rns // 4)) + bkv * (1 + -(-rno // 4))
            warps = max(1, per_sm) * threads // self.spec.warp_size
            rate = (_F32_FLOPS * ffma / (ffma + _SIMT_LOAD_WEIGHT * lds)
                    * min(1.0, warps / _SIMT_WARPS))
            barriers = 2 if flash_stages(bq, bkv, hd, 4, self.spec) == 1 else 1
        slots = max(1, per_sm) * self.spec.num_sms
        ctas = s.n_q_blocks * heads
        fill = ctas / (math.ceil(ctas / slots) * slots)
        t_compute = (
            visits * 4.0 * bq * bkv * hd / rate + visits * bq * bkv / _SFU_PER_S
        ) / fill
        traffic = (
            2 * sp.seq_q * heads * hd  # Q read, O written
            + visits * 2 * bkv * hd  # a K and a V tile per visit
        ) * self.in_bytes
        t_overhead = barriers * _BARRIER_S * self.kv_visits(s) / s.n_q_blocks
        return t_compute, traffic / _HBM_BYTES_S, t_overhead

    def measure_fingerprint(self) -> str:
        # each model names its kernel's design: costs of the models they
        # replaced (bf16 on CUDA cores, f32 without register tiles and a
        # K/V ring) are not served from a journal
        from .analytical import noise_part

        model = "|wgmma" if self.in_bytes == 2 else "|ring"
        return (f"r{self.n_repeats}|{self.dtype}{model}" + noise_part(self)
                + self.space_fingerprint())

    def worker_spec(self):
        from .analytical import analytical_worker_spec

        return analytical_worker_spec(self)
