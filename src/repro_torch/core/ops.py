"""Operator registry — binds each tunable op to its search space, its
analytical oracle, and how the measured backend runs its kernel.

An :class:`OpSpec` names:

* ``make_space``      — dims/depths -> :class:`~repro_torch.core.space.SearchSpace`
* ``analytical_cost`` — the op's deterministic model
* ``operands``        — ``(space, dtype, seed, device)`` -> operand tensors,
  made on the device from a seeded ``torch.Generator``
* ``kernel_run``      — ``(space, state, operands)`` -> output of the op's
  hand-written kernel under that schedule (``ValueError`` when the kernel
  refuses it)
* ``default_state``   — ``(space, dtype)`` -> the state of the kernel's
  heuristic config, or None — where a warm start with no donor begins
* ``kernel_source``   — the CUDA source under ``kernels/csrc/`` that
  ``kernel_run`` launches; the measured backend's fingerprint names its
  digest

Built-in ops: ``gemm``, the paper's tiled matrix multiply, and ``flash``,
blocked causal attention.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .analysis import dtype_in_bytes
from .config_space import GemmConfigSpace, TilingState
from .flash_space import FlashAttnConfigSpace, FlashScheduleState
from .space import SearchSpace, State

__all__ = ["OpSpec", "OPS", "register_op", "get_op", "op_names"]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Everything the tuner stack needs to know about one operator."""

    name: str
    state_type: type
    default_depths: tuple[int, ...]
    make_space: Callable[..., SearchSpace]
    analytical_cost: Callable[..., object]
    operands: Callable[..., tuple]
    kernel_run: Callable[..., torch.Tensor]
    default_state: Callable[..., Optional[State]]
    kernel_source: str


OPS: dict[str, OpSpec] = {}


def register_op(spec: OpSpec) -> None:
    OPS[spec.name] = spec


def get_op(name: str) -> OpSpec:
    try:
        return OPS[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; registered ops: {sorted(OPS)}"
        ) from None


def op_names() -> list[str]:
    return sorted(OPS)


def _gemm_space(dims: Sequence[int], depths: Sequence[int] = (), **kw) -> GemmConfigSpace:
    m, k, n = dims
    d_m, d_k, d_n = depths or (4, 2, 4)
    return GemmConfigSpace(m, k, n, d_m, d_k, d_n, **kw)


def _gemm_analytical(space, **kw):
    from .cost.analytical import AnalyticalHopperCost

    return AnalyticalHopperCost(space, **kw)


def _gemm_operands(space: GemmConfigSpace, dtype: str, seed: int, device) -> tuple:
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in ((space.m, space.k), (space.k, space.n)):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        out.append(x.to(getattr(torch, dtype)))
    return tuple(out)


def _gemm_kernel_run(space: GemmConfigSpace, s: TilingState, operands) -> torch.Tensor:
    from repro_torch.kernels.gemm import gemm_tiled, kernel_config_from_state

    a, b = operands
    return gemm_tiled(a, b, kernel_config_from_state(s))


def _gemm_default_state(space: GemmConfigSpace, dtype: str) -> Optional[TilingState]:
    from repro_torch.kernels.gemm import default_config, state_from_config

    if (space.d_m, space.d_k, space.d_n) != (4, 2, 4):
        return None
    cfg = default_config(space.m, space.k, space.n, dtype_in_bytes(dtype))
    return None if cfg is None else state_from_config(cfg, space.m, space.k, space.n)


register_op(
    OpSpec(
        name="gemm",
        state_type=TilingState,
        default_depths=(4, 2, 4),
        make_space=_gemm_space,
        analytical_cost=_gemm_analytical,
        operands=_gemm_operands,
        kernel_run=_gemm_kernel_run,
        default_state=_gemm_default_state,
        kernel_source="gemm.cu",
    )
)


# ---------------------------------------------------------------------------
# flash — blocked causal attention
# ---------------------------------------------------------------------------


def _flash_space(dims: Sequence[int], depths: Sequence[int] = (), **kw) -> FlashAttnConfigSpace:
    seq_q, seq_kv, head_dim = dims
    d_q, d_kv = depths or (2, 2)
    return FlashAttnConfigSpace(seq_q, seq_kv, head_dim, d_q, d_kv, **kw)


def _flash_analytical(space, **kw):
    from .cost.flash_analytical import FlashAnalyticalHopperCost

    return FlashAnalyticalHopperCost(space, **kw)


def _flash_operands(space: FlashAttnConfigSpace, dtype: str, seed: int, device) -> tuple:
    """One sequence of the space's ``heads`` query heads on ``kv_heads``
    kv heads — the arch's layout, where the JAX package times a single
    ``(seq, hd)`` head, whose 64 CTAs at bq = 64 would leave half of 132
    SMs idle and reward small blocks for filling the card rather than
    for the served shape."""
    heads, kv_heads = space.heads, space.kv_heads
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for seq, h in ((space.seq_q, heads), (space.seq_kv, kv_heads), (space.seq_kv, kv_heads)):
        x = torch.randn((1, seq, h, space.head_dim), generator=gen, device=device,
                        dtype=torch.float32)
        out.append(x.to(getattr(torch, dtype)))
    return tuple(out)


def _flash_kernel_run(space: FlashAttnConfigSpace, s: FlashScheduleState,
                      operands) -> torch.Tensor:
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = operands
    return flash_attention(q, k, v, s.block_q, s.block_kv, causal=space.causal)


def _flash_default_state(space: FlashAttnConfigSpace, dtype: str) -> Optional[FlashScheduleState]:
    from repro_torch.kernels.flash_attention import default_blocks, state_from_blocks

    if (space.d_q, space.d_kv) != (2, 2):
        return None
    # at the grid of the space's operand: one sequence of its query heads
    blocks = default_blocks(space.seq_q, space.seq_kv, space.head_dim, dtype_in_bytes(dtype),
                            grid_y=space.heads)
    return None if blocks is None else state_from_blocks(*blocks, space.seq_q, space.seq_kv)


register_op(
    OpSpec(
        name="flash",
        state_type=FlashScheduleState,
        default_depths=(2, 2),
        make_space=_flash_space,
        analytical_cost=_flash_analytical,
        operands=_flash_operands,
        kernel_run=_flash_kernel_run,
        default_state=_flash_default_state,
        kernel_source="flash_attention.cu",
    )
)
