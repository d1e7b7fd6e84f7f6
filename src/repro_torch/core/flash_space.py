"""Flash-attention schedule space — the first non-GEMM
:class:`~repro_torch.core.space.SearchSpace` instance.

The tunable schedule of the Hopper kernel
(``repro_torch/kernels/csrc/flash_attention.cu``) is its
``(block_q, block_kv)`` pair: the q-sequence is split into
``seq_q // block_q`` parallel CTAs per (batch, query head) and each CTA
streams the kv sequence ``block_kv`` rows at a time through the
online-softmax inner loop.  That is exactly the paper's factored MDP
with two dimension rows instead of three:

    s = [s_q, s_kv]      s_q = [q0, q1, ..],  prod == seq_q
                         s_kv = [kv0, kv1, ..], prod == seq_kv

with ``block_q = prod(s_q[1:])`` (grid cells ``q0``) and
``block_kv = prod(s_kv[1:])`` (inner iterations per visit ``kv0``).
``head_dim`` is a workload dimension — it shapes the working set, the
kernel instantiation and the cache keys — but is not factored: the
kernel keeps full heads.

All MDP machinery (product-preserving double/halve actions, neighbors,
enumeration, sampling, transplant warm starts) is inherited from
:class:`~repro_torch.core.space.FactoredSearchSpace`; this module fixes
the state dataclass, the attention featurization, and the working set,
which follows the Hopper kernel's shared memory (the Q tile plus a ring
of streamed K/V tiles in bf16; Q, K/V and the staged P tile in f32).
States, keys, size, enumeration, neighbours, transplants and
``spec_kwargs`` are the JAX package's, so
journals and records stay comparable; ``working_set_bytes`` and the one
feature derived from it differ, because the TPU kernel keeps the whole
K/V sequence resident and this one streams it.

The space also carries the head layout of the operand a schedule is
judged on, ``heads`` query heads on ``kv_heads`` kv heads of one
sequence: the kernel's grid holds ``seq_q / block_q`` CTAs per query
head, so the launch rule, the under-fill rule, the analytical model and
the timed operand all read it.  The default, one head, is the JAX
package's timed operand; ``flash_workloads_for_arch`` passes the arch's
own layout.  It is not part of the workload key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from .analysis import flash_smem_bytes
from .space import FactoredSearchSpace, register_state_type

__all__ = ["FlashScheduleState", "FlashAttnConfigSpace"]


@dataclasses.dataclass(frozen=True)
class FlashScheduleState:
    """One flash-attention schedule ``s = [s_q, s_kv]``."""

    q: tuple[int, ...]
    kv: tuple[int, ...]

    # -- kernel mapping ------------------------------------------------------
    @property
    def n_q_blocks(self) -> int:
        """Parallel grid cells along the q sequence."""
        return self.q[0]

    @property
    def n_kv_blocks(self) -> int:
        """Inner-loop iterations per full kv sweep."""
        return self.kv[0]

    @property
    def block_q(self) -> int:
        return math.prod(self.q[1:]) if len(self.q) > 1 else 1

    @property
    def block_kv(self) -> int:
        return math.prod(self.kv[1:]) if len(self.kv) > 1 else 1

    def dims(self) -> tuple[int, int]:
        return (math.prod(self.q), math.prod(self.kv))

    def as_lists(self) -> list[list[int]]:
        return [list(self.q), list(self.kv)]

    @staticmethod
    def from_lists(lists: Sequence[Sequence[int]]) -> "FlashScheduleState":
        q, kv = lists
        return FlashScheduleState(tuple(q), tuple(kv))

    def key(self) -> str:
        return ",".join(map(str, self.q)) + "|" + ",".join(map(str, self.kv))

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"[q{list(self.q)} x kv{list(self.kv)}]"


class FlashAttnConfigSpace(FactoredSearchSpace):
    """Search space for one attention workload
    ``(seq_q, seq_kv, head_dim)`` with nesting depths ``(d_q, d_kv)``
    (default 2: one grid factor + one block factor per sequence, the
    kernel's actual degrees of freedom)."""

    op = "flash"

    def __init__(
        self,
        seq_q: int,
        seq_kv: int,
        head_dim: int,
        d_q: int = 2,
        d_kv: int = 2,
        causal: bool = True,
        heads: int = 1,
        kv_heads: int = 1,
        extra_constraint: Optional[Callable[[FlashScheduleState], bool]] = None,
    ):
        if min(seq_q, seq_kv, head_dim) < 1:
            raise ValueError(
                f"bad attention dims ({seq_q},{seq_kv},{head_dim})"
            )
        if kv_heads < 1 or heads % kv_heads:
            raise ValueError(f"{heads} query heads on {kv_heads} kv heads")
        self.seq_q, self.seq_kv, self.head_dim = seq_q, seq_kv, head_dim
        self.d_q, self.d_kv = d_q, d_kv
        self.causal = causal
        self.heads, self.kv_heads = heads, kv_heads
        super().__init__((seq_q, seq_kv), (d_q, d_kv), extra_constraint)

    # -- identity ------------------------------------------------------------
    @property
    def dims(self) -> tuple[int, int, int]:
        # head_dim is part of the workload identity (cache keys, warm
        # starts must never cross head sizes) even though it is not a
        # factored row
        return (self.seq_q, self.seq_kv, self.head_dim)

    def spec_kwargs(self) -> Optional[dict]:
        kw = super().spec_kwargs()
        if kw is None:
            return None
        kw = {**kw, "causal": self.causal}
        if (self.heads, self.kv_heads) != (1, 1):  # the JAX package's one head adds nothing
            kw.update(heads=self.heads, kv_heads=self.kv_heads)
        return kw

    def state_from_rows(self, rows: Sequence[Sequence[int]]) -> FlashScheduleState:
        return FlashScheduleState.from_lists(rows)

    # -- hardware footprint ---------------------------------------------------
    def working_set_bytes(self, s: FlashScheduleState, in_bytes: int = 2) -> int:
        """Shared memory of one CTA of the Hopper kernel for ``in_bytes``
        inputs: in bf16 the Q tile and a ring of K/V tiles of ``block_kv``
        rows; in f32 the Q, K and V tiles and the P tile.  The arithmetic
        lives in ``repro_torch.core.analysis`` (the kernel's launch rule),
        so filter and oracle can never disagree."""
        return flash_smem_bytes(s.block_q, s.block_kv, self.head_dim, in_bytes)

    # -- featurization --------------------------------------------------------
    def features(self, s: FlashScheduleState) -> np.ndarray:
        """log2 of every factor plus derived schedule descriptors — the
        flash analogue of the GEMM tile features the learned tuners
        consume."""
        lg = lambda v: math.log2(max(v, 1))
        raw = [lg(f) for f in (s.q + s.kv)]
        bq, bkv = s.block_q, s.block_kv
        derived = [
            lg(bq),
            lg(bkv),
            lg(s.n_q_blocks),
            lg(s.n_kv_blocks),
            float(bq % 8 == 0),  # the JAX package's alignment features,
            float(bkv % 128 == 0),  # kept so the vectors stay comparable
            lg(bq * bkv),  # logits tile (elements)
            lg(self.working_set_bytes(s)),
        ]
        return np.asarray(raw + derived, dtype=np.float32)

    @property
    def n_features(self) -> int:
        return self.d_q + self.d_kv + 8

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"FlashAttnConfigSpace(({self.seq_q},{self.seq_kv},"
            f"{self.head_dim}), d=({self.d_q},{self.d_kv}), "
            f"causal={self.causal}, heads={self.heads}/{self.kv_heads}, "
            f"size={self.size()})"
        )


register_state_type("flash", FlashScheduleState)
