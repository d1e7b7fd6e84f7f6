"""GEMM tiling configuration space — the paper's MDP (Sec. 3.3 / 4.1),
the canonical :class:`~repro_torch.core.space.SearchSpace` implementation.

A *state* (Eqn. 5) is ``s = [s_m, s_k, s_n, J]`` where ``s_x`` is an
ordered factor list whose product equals the matrix dimension and ``J``
is a legitimacy bit.  The *action space* (Eqn. 6) doubles one factor and
halves another within the same dimension:

    A = { s_x[i] <- 2*s_x[i],  s_x[j] <- s_x[j]/2 }   x in {m,k,n}, i != j

which preserves the product — the paper's central structural insight is
that the cost surface is smooth under these product-preserving moves.
The row-generic machinery (actions, stepping, enumeration, sampling,
transplanting) lives in :class:`~repro_torch.core.space.FactoredSearchSpace`;
this module fixes the three ``m/k/n`` rows, the GEMM featurization, and
the Hopper kernel's shared-memory working set.

For power-of-two dims (the paper's benchmarks: 512^3, 1024^3, 2048^3) the
reachable space is exactly the set of ordered power-of-two compositions;
its size reproduces the paper's reported counts:

    (512,512,512):    C(12,3) * 10 * C(12,3) = 220*10*220   =   484,000
    (1024,1024,1024): C(13,3) * 11 * C(13,3) = 286*11*286   =   899,756
    (2048,2048,2048): C(14,3) * 12 * C(14,3) = 364*12*364   = 1,589,952

Hopper reading of a state (the GEMM kernels of ``kernels/csrc/gemm.cu``).
The rows, keys and features are the JAX package's, so journals stay
comparable; only the reading depends on the dtype.  Always: ``m0 x n0``
= the CTA grid, ``bm = m1*m2*m3`` x ``bn = n1*n2*n3`` = the CTA tile,
``s_k=[k0,k1]`` → ``k0`` = trip count of the K loop inside the CTA,
``bk = k1`` = the K slab.  Then:

* float32 (the SIMT kernel): ``sub_m = m2*m3`` = warp tile (``m1`` warp
  tiles per CTA), ``m3`` = per-thread register tile (``m2`` threads per
  warp tile) — the same for n.
* bfloat16, ``bm >= 64`` (the ``wgmma`` kernel): ``m1 x n1`` = the CTA's
  consumer warpgroups (1 or 2 in all); ``sub_m = m2`` = a warpgroup's
  rows (64 or 128: one or two m64 instructions), ``sub_n = n2`` = the
  instruction's N (64, 128 or 256: whole atoms of the 128-byte swizzled
  layout); ``m3 = n3 = 1``, because a ``wgmma`` fragment is fixed by the
  instruction and any other value would only alias the same schedule (the
  rule refuses it as ``register_tile``, so G-BFS spends no trial on it).
  ``bk`` is 64 or 128.
* bfloat16, ``bm < 64`` (the bandwidth kernel, decode's M = 8): ``bm =
  m2`` rows (8 or 16) and ``bn = n2`` columns (8 .. 64) per CTA, with
  ``m1 = n1 = m3 = n3 = 1`` (its four warps split K, a fixed split the
  state does not carry); ``bk`` a multiple of 16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from .analysis import gemm_smem_bytes
from .space import (
    Action,
    FactoredSearchSpace,
    compositions_pow2,
    count_compositions_pow2,
    register_state_type,
)

__all__ = [
    "TilingState",
    "Action",
    "GemmConfigSpace",
    "compositions_pow2",
    "count_compositions_pow2",
]


@dataclasses.dataclass(frozen=True)
class TilingState:
    """One configuration ``s = [s_m, s_k, s_n]`` (legitimacy via space)."""

    m: tuple[int, ...]
    k: tuple[int, ...]
    n: tuple[int, ...]

    # -- convenience views (Hopper mapping) ---------------------------------
    @property
    def grid(self) -> tuple[int, int, int]:
        """(m0, k0, n0): CTA grid rows, K-loop trip count, CTA grid columns."""
        return (self.m[0], self.k[0], self.n[0])

    @property
    def block_m(self) -> int:
        return math.prod(self.m[1:]) if len(self.m) > 1 else 1

    @property
    def block_k(self) -> int:
        return math.prod(self.k[1:]) if len(self.k) > 1 else 1

    @property
    def block_n(self) -> int:
        return math.prod(self.n[1:]) if len(self.n) > 1 else 1

    @property
    def sub_m(self) -> int:
        """Warp tile (second-level split)."""
        return math.prod(self.m[2:]) if len(self.m) > 2 else 1

    @property
    def sub_n(self) -> int:
        return math.prod(self.n[2:]) if len(self.n) > 2 else 1

    @property
    def reg_m(self) -> int:
        return self.m[-1]

    @property
    def reg_n(self) -> int:
        return self.n[-1]

    def dims(self) -> tuple[int, int, int]:
        return (math.prod(self.m), math.prod(self.k), math.prod(self.n))

    def as_lists(self) -> list[list[int]]:
        return [list(self.m), list(self.k), list(self.n)]

    @staticmethod
    def from_lists(lists: Sequence[Sequence[int]]) -> "TilingState":
        m, k, n = lists
        return TilingState(tuple(m), tuple(k), tuple(n))

    def key(self) -> str:
        return (
            ",".join(map(str, self.m))
            + "|"
            + ",".join(map(str, self.k))
            + "|"
            + ",".join(map(str, self.n))
        )

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"[{list(self.m)} x {list(self.k)} x {list(self.n)}]"


class GemmConfigSpace(FactoredSearchSpace):
    """The search space for one GEMM workload ``(M, K, N)`` with nesting
    depths ``(d_m, d_k, d_n)`` (paper defaults 4, 2, 4 for GPUs)."""

    op = "gemm"

    def __init__(
        self,
        m: int,
        k: int,
        n: int,
        d_m: int = 4,
        d_k: int = 2,
        d_n: int = 4,
        extra_constraint: Optional[Callable[[TilingState], bool]] = None,
    ):
        if min(m, k, n) < 1:
            raise ValueError(f"bad GEMM dims ({m},{k},{n})")
        self.m, self.k, self.n = m, k, n
        self.d_m, self.d_k, self.d_n = d_m, d_k, d_n
        super().__init__((m, k, n), (d_m, d_k, d_n), extra_constraint)

    def state_from_rows(self, rows: Sequence[Sequence[int]]) -> TilingState:
        return TilingState.from_lists(rows)

    # -- hardware footprint ---------------------------------------------------
    def working_set_bytes(self, s: TilingState, in_bytes: int = 2) -> int:
        """Shared memory of one CTA: the A/B operand slabs, in bf16 the
        ring of them (the f32 accumulators live in registers).  The
        arithmetic lives in ``repro_torch.core.analysis``, the kernel's
        single legality rule."""
        return gemm_smem_bytes(s.block_m, s.block_k, s.block_n, in_bytes)

    # -- featurization (for surrogate / policy models) ------------------------
    def features(self, s: TilingState) -> np.ndarray:
        """Dense feature vector: log2 of every factor plus derived tile
        descriptors.  Used by the GBT surrogate, the RNN controller
        baseline, and N-A2C's actor/critic networks."""
        lg = lambda v: math.log2(max(v, 1))
        raw = [lg(f) for f in (s.m + s.k + s.n)]
        bm, bk, bn = s.block_m, s.block_k, s.block_n
        derived = [
            lg(bm),
            lg(bk),
            lg(bn),
            lg(s.sub_m),
            lg(s.sub_n),
            lg(s.reg_m),
            lg(s.reg_n),
            lg(s.grid[0] * s.grid[1] * s.grid[2]),
            float(bn % 128 == 0),
            float(bm % 8 == 0),
            lg(bm * bk + bk * bn + bm * bn),  # operand + output tile elements
        ]
        return np.asarray(raw + derived, dtype=np.float32)

    @property
    def n_features(self) -> int:
        return self.d_m + self.d_k + self.d_n + 11

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"GemmConfigSpace(({self.m},{self.k},{self.n}), "
            f"d=({self.d_m},{self.d_k},{self.d_n}), size={self.size()})"
        )


register_state_type("gemm", TilingState)
