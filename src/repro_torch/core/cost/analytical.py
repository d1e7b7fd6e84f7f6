"""Analytical H100 cost model of the GEMM kernels — the CPU-side oracle.

A deterministic model of ``kernels/csrc/gemm.cu`` on an H100: it takes
no time on the card and serves tests and searches on machines without
one.  It is not the main path's cost (that is
:class:`~repro_torch.core.cost.measured.HopperTimedCost`).  States the
kernel cannot launch cost ``inf`` (the shared rule of
``repro_torch.core.analysis``).  For the rest, one branch per kernel:

* float32 (the SIMT kernel): ``2*M*K*N`` operations at the CUDA-core f32
  rate, scaled by the share of the inner loop's instructions that are
  FMAs (``rm*rn`` FMAs per ``rm + rn`` shared-memory loads) and by how
  full the last wave of CTAs leaves the SMs; against memory time, every
  CTA reading its A and B strips once (A is read ``n0`` times over, B
  ``m0`` times) and writing its C tile once, at the card's memory rate.
* bfloat16, ``bm >= 64`` (the ``wgmma`` kernel): ``2*M*K*N`` operations
  at the dense bf16 tensor-core rate times ``_WGMMA_EFFICIENCY`` times
  ``bk / (bk + 16)`` (each slab's products drain before a block-wide
  barrier), over the
  waves of CTAs the SMs hold at once (CTAs per SM from threads, the
  shared memory of the ring and registers: the accumulators plus about
  40); against the operand strips every CTA copies (``M*K*n0 +
  K*N*m0``, served by the L2 at ``_L2_BYTES_S``) and the unique bytes
  (``M*K + K*N + M*N``) at the card's memory rate.
* bfloat16, ``bm < 64`` (the bandwidth kernel): B's bytes once per CTA
  row, A's per CTA and C's once, at the memory rate the SMs that hold
  CTAs can draw: each at most ``_SM_BYTES_S``, and no more than the
  bytes its ring keeps in flight over ``_LATENCY_S``.

The largest of the times is the cost.  With ``noise_sigma > 0`` each
repeat is multiplied by the JAX package's seeded lognormal draw
(:func:`~repro_torch.core.cost.base.lognormal_noise`), so a search can be
run against a noisy oracle as the paper's measurements are.
"""

from __future__ import annotations

import dataclasses
import math

from ..analysis import (
    GEMM_ACC_REGS_MAX,
    HopperSpec,
    ScheduleAnalyzer,
    dtype_in_bytes,
    GEMM_WG_THREADS,
    gemm_kernel_kind,
    gemm_stages,
)
from ..space import State
from .base import CostBackend, lognormal_noise, space_from_spec, space_spec

__all__ = ["AnalyticalHopperCost", "brute_force_optimum"]

#: H100 SXM data sheet: non-tensor f32 FMA rate, dense bf16 tensor-core
#: rate and HBM3 bandwidth
_F32_FLOPS = 67e12
_BF16_TC_FLOPS = 989e12
_HBM_BYTES_S = 3.35e12
_SMEM_PER_SM = 233_472
_THREADS_PER_SM = 2048
_REGS_PER_SM = 65_536
#: share of the tensor-core rate the wgmma kernel's products reach between
#: its barriers: an estimate for a kernel whose warpgroups also issue its
#: copies (no producer warp, no TMA)
_WGMMA_EFFICIENCY = 0.7
#: the rate at which the kernel's cp.async operand copies reach the SMs
#: from the L2: an estimate, near what its measured times imply for
#: 128 x 256 tiles, whose copies and not their products bound it
_L2_BYTES_S = 4e12
#: registers a wgmma thread holds beside its accumulators (an estimate)
_WGMMA_OTHER_REGS = 40
#: the bandwidth kernel: the most one SM draws from memory, and the
#: latency its ring's bytes in flight have to cover (estimates)
_SM_BYTES_S = 60e9
_LATENCY_S = 1e-6


class AnalyticalHopperCost(CostBackend):
    name = "analytical_h100"

    def __init__(self, space, n_repeats: int = 1, dtype: str = "bfloat16",
                 spec: HopperSpec | None = None, noise_sigma: float = 0.0,
                 seed: int = 0):
        super().__init__(space, n_repeats, dtype)
        self.in_bytes = dtype_in_bytes(dtype)
        self.spec = spec or HopperSpec()
        self.noise_sigma = noise_sigma
        self.seed = seed
        self.analyzer = ScheduleAnalyzer(space, self.spec, self.in_bytes)

    def cost_once(self, s: State, repeat_idx: int) -> float:
        if self.analyzer.analyze(s).illegal:
            return math.inf
        base = self._base_cost(s)
        if self.noise_sigma <= 0.0:
            return base
        return float(base * lognormal_noise(self.seed, s.key(), repeat_idx, self.noise_sigma))

    # -- the model's terms ------------------------------------------------------
    def compute_time(self, s: State) -> float:
        """Seconds of the kernel's operations (0 for the bandwidth kernel,
        which the model holds to its bytes alone)."""
        return self._terms(s)[0]

    def memory_time(self, s: State) -> float:
        """Seconds of the bytes it moves: the ``wgmma`` kernel's the larger
        of its L2 operand copies and its unique bytes from memory."""
        return self._terms(s)[1]

    def overhead_time(self, s: State) -> float:
        """Seconds charged beside the two: none (the H100 model has no
        per-grid-step cost)."""
        return self._terms(s)[2]

    def breakdown(self, s: State) -> dict:
        compute, memory, overhead = self._terms(s)
        return {
            "smem_bytes": self.space.working_set_bytes(s, self.in_bytes),
            "kernel": gemm_kernel_kind(s.block_m, self.in_bytes),
            "compute_s": compute,
            "memory_s": memory,
            "overhead_s": overhead,
        }

    def optimum(self, max_states: int = 2_000_000) -> tuple[State, float]:
        """Brute-force the space (small spaces, tests, and the paper's 512^3)."""
        return brute_force_optimum(self, max_states)

    def _base_cost(self, s: State) -> float:
        compute, memory, overhead = self._terms(s)
        return max(compute, memory) + overhead

    def _terms(self, s: State) -> tuple[float, float, float]:
        """``(compute, memory, overhead)`` seconds of the kernel that runs
        ``s`` (a state it launches); the cost is the larger of the first two
        plus the third."""
        kind = gemm_kernel_kind(s.block_m, self.in_bytes)
        if kind == "wgmma":
            return self._wgmma_terms(s)
        if kind == "stream":
            return 0.0, self._stream_time(s), 0.0
        m, k, n = self.space.dims
        m0, _, n0 = s.grid
        rm, rn = s.reg_m, s.reg_n
        threads = (s.block_m // rm) * (s.block_n // rn)
        smem = self.space.working_set_bytes(s, self.in_bytes)
        per_sm = max(1, min(_THREADS_PER_SM // threads, _SMEM_PER_SM // smem, 32))
        fill = self._fill(m0 * n0, per_sm)
        fma_share = rm * rn / (rm * rn + rm + rn)
        t_compute = 2.0 * m * k * n / (_F32_FLOPS * fma_share * fill)
        traffic = (m * k * n0 + k * n * m0 + m * n) * self.in_bytes
        return t_compute, traffic / _HBM_BYTES_S, 0.0

    def _fill(self, ctas: int, per_sm: int) -> float:
        """How full the waves of ``ctas`` CTAs leave the SMs, at
        ``per_sm`` CTAs an SM."""
        slots = per_sm * self.spec.num_sms
        return ctas / (math.ceil(ctas / slots) * slots)

    def _wgmma_terms(self, s: State) -> tuple[float, float, float]:
        m, k, n = self.space.dims
        m0, _, n0 = s.grid
        bk = s.block_k
        threads = GEMM_WG_THREADS * (s.block_m // s.sub_m) * (s.block_n // s.sub_n)
        regs = min(s.sub_m * s.sub_n // 128, GEMM_ACC_REGS_MAX) + _WGMMA_OTHER_REGS
        smem = self.space.working_set_bytes(s, 2)
        per_sm = max(1, min(_THREADS_PER_SM // threads, _SMEM_PER_SM // smem,
                            _REGS_PER_SM // (threads * regs)))
        rate = _BF16_TC_FLOPS * _WGMMA_EFFICIENCY * bk / (bk + 16)
        t_compute = 2.0 * m * k * n / (rate * self._fill(m0 * n0, per_sm))
        t_l2 = (m * k * n0 + k * n * m0) * 2 / _L2_BYTES_S
        t_hbm = (m * k + k * n + m * n) * 2 / _HBM_BYTES_S
        return t_compute, max(t_l2, t_hbm), 0.0

    def _stream_time(self, s: State) -> float:
        m, k, n = self.space.dims
        m0, _, n0 = s.grid
        bk, bn = s.block_k, s.block_n
        stages = gemm_stages(s.block_m, bk, bn, 2, self.spec)
        per_sm = max(1, min(_SMEM_PER_SM // self.space.working_set_bytes(s, 2), 16))
        ctas, slots = m0 * n0, per_sm * self.spec.num_sms
        resident = min(ctas, slots)  # CTAs streaming at once
        sms = min(self.spec.num_sms, resident)
        in_flight = (stages - 1) * bk * bn * 2 * resident / sms  # bytes per SM
        rate = min(_HBM_BYTES_S, sms * min(_SM_BYTES_S, in_flight / _LATENCY_S))
        if ctas > slots:  # a part-full last wave
            rate *= self._fill(ctas, per_sm)
        return (k * n * m0 + m * k * n0 + m * n) * 2 / rate

    def measure_fingerprint(self) -> str:
        # the bf16 model is of the tensor-core and bandwidth kernels: costs
        # of the SIMT model it replaced are not served from a journal
        model = "|wgmma" if self.in_bytes == 2 else ""
        return (f"r{self.n_repeats}|{self.dtype}{model}" + noise_part(self)
                + self.space_fingerprint())

    def worker_spec(self):
        return analytical_worker_spec(self)


def brute_force_optimum(backend: CostBackend, max_states: int) -> tuple[State, float]:
    """The cheapest state of ``backend``'s space and its cost, over every
    state (``cost``, so ``inf`` where the kernel cannot launch); refuses a
    space of more than ``max_states`` states."""
    if backend.space.size() > max_states:
        raise ValueError("space too large to brute force")
    best_s, best_c = None, math.inf
    for s in backend.space.enumerate():
        c = backend.cost(s)
        if c < best_c:
            best_s, best_c = s, c
    if best_s is None:
        raise ValueError("no state of the space is launchable")
    return best_s, best_c


def noise_part(backend) -> str:
    """Fingerprint part of a noisy model (nothing for a noise-free one,
    whose journals stay valid)."""
    if backend.noise_sigma <= 0.0:
        return ""
    return f"|noise{backend.noise_sigma:g}|seed{backend.seed}"


def analytical_worker_spec(backend):
    """The worker spec of an analytical model (GEMM or flash): its space,
    dtype, card spec, repeats and noise."""
    sp = space_spec(backend.space)
    if sp is None:  # a constraint closure does not survive the round trip
        return None
    return (
        "repro_torch.core.cost.analytical:_analytical_from_spec",
        {**sp, "cls": type(backend).__name__, "n_repeats": backend.n_repeats,
         "dtype": backend.dtype, "spec": dataclasses.asdict(backend.spec),
         "noise_sigma": backend.noise_sigma, "seed": backend.seed},
    )


def _analytical_from_spec(op, dims, depths, space_kwargs, cls, n_repeats,
                          dtype, spec, noise_sigma, seed):
    """Worker-process factory (see ``CostBackend.worker_spec``)."""
    from .flash_analytical import FlashAnalyticalHopperCost

    factory = {"AnalyticalHopperCost": AnalyticalHopperCost,
               "FlashAnalyticalHopperCost": FlashAnalyticalHopperCost}[cls]
    return factory(space_from_spec(op, dims, depths, space_kwargs),
                   n_repeats=n_repeats, dtype=dtype, spec=HopperSpec(**spec),
                   noise_sigma=noise_sigma, seed=seed)
