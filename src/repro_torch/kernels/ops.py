"""Record-aware kernel dispatch — the bridge from tuning records to the
GEMMs and the attention a model runs.

``gemm(a, b)`` picks a kernel config for its shape:

  1. the tuned record for the workload key (``records.workload_key_for``
     under the policy's cost-backend namespace, written by
     ``launch/tune.py``), unless the static analyzer calls it ILLEGAL;
  2. else the kernel's heuristic :func:`~repro_torch.kernels.gemm.default_config`;
  3. ``torch.matmul`` when no kernel config divides the shape (or the
     dtype is one the kernel does not take) — a shape rule, counted as
     ``"matmul"``, never a fallback after a failure.

A bf16 product of fewer than 8 rows (a decode batch under 8) runs the
bandwidth kernel's 8-row block on rows padded with zeros: the weights
it streams are the same, and its key is ``(8, K, N)``.

``models/common.attention_dispatch`` asks :func:`flash_schedule` for the
tuned ``(block_q, block_kv)`` of a long self-attention, through
:func:`flash_blocks`, in the same order: tuned record, then the
kernel's heuristic blocks, then plain attention when no block the
kernel launches divides the sequence.  :func:`launch_counts` reads both
kernels' launch counters as one ``Counter``.

The lookup is memoized per ``(op, dims, dtype, backend)`` and dropped by
:func:`set_kernel_policy` and by any records change (a records change
listener).  :func:`dispatch_stats` counts, per op, which source drove
each call.  ``gemm`` is differentiable: its ``torch.autograd.Function``
computes ``dA = g Bᵀ`` and ``dB = Aᵀ g`` with the same kernel, each
looked up under its own shape's key, cast to its operand's type and
counted under the launch role ``dA`` / ``dB``.

Entry points run on the card: ``gemm`` takes ``device="cuda"`` unless
the caller asks for ``device="cpu"`` (the plain version) or
``device="meta"`` (a dry run's trace: every decision above is the
card's, the kernel's work is reported to the op counters in force and
nothing is launched), and refuses operands that live elsewhere.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.core.analysis import dtype_in_bytes, flash_launch_error
from repro_torch.core.records import add_change_listener, global_records, workload_key_for
from .flash_attention import LAUNCHES as FLASH_LAUNCHES
from .flash_attention import default_blocks
from .gemm import LAUNCHES as GEMM_LAUNCHES
from .gemm import (KernelConfig, default_config, gemm_tiled, kernel_config_from_state,
                   launch_role, misaligned)

__all__ = [
    "gemm",
    "kernel_config",
    "KernelPolicy",
    "set_kernel_policy",
    "kernel_policy",
    "lookup_tuned_state",
    "flash_schedule",
    "flash_blocks",
    "launch_counts",
    "note_dispatch",
    "invalidate_dispatch_cache",
    "dispatch_stats",
    "reset_dispatch_stats",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the fewest rows a bf16 product launches the kernel with (the bandwidth
#: kernel's smallest block); a product with fewer is padded with zero rows
_MIN_ROWS = 8


@dataclasses.dataclass
class KernelPolicy:
    cost_backend: str = "hopper_timed"  # records namespace to consult
    #: ops that consult TuningRecords; others always use their heuristic
    record_ops: tuple[str, ...] = ("gemm", "flash")


_POLICY = KernelPolicy()


def kernel_policy() -> KernelPolicy:
    return _POLICY


def set_kernel_policy(policy: KernelPolicy) -> None:
    global _POLICY
    _POLICY = policy
    invalidate_dispatch_cache()  # cost_backend / record_ops may differ


# -- memoized record lookup ----------------------------------------------------

_MISS = object()
_CACHE_LOCK = threading.Lock()
_DISPATCH_CACHE: dict[tuple, object] = {}
_DISPATCH_STATS: dict[str, dict[str, int]] = {}
_STAT_FIELDS = (
    "records", "heuristic", "explicit", "matmul", "plain", "memo_hits",
    "store_lookups", "static_reject",
)


def invalidate_dispatch_cache() -> None:
    """Drop every memoized record lookup."""
    with _CACHE_LOCK:
        _DISPATCH_CACHE.clear()


add_change_listener(invalidate_dispatch_cache)


def note_dispatch(op: str, source: str) -> None:
    """Count one dispatch decision for ``op``: ``source`` is
    ``records``, ``heuristic`` or ``explicit`` (a kernel config), or
    ``matmul``/``plain`` (no kernel takes the shape), plus the lookup
    counters ``memo_hits``, ``store_lookups`` and ``static_reject``."""
    with _CACHE_LOCK:
        per_op = _DISPATCH_STATS.setdefault(op, dict.fromkeys(_STAT_FIELDS, 0))
        per_op[source] += 1


def dispatch_stats() -> dict[str, dict[str, int]]:
    with _CACHE_LOCK:
        return {op: dict(d) for op, d in _DISPATCH_STATS.items()}


def reset_dispatch_stats() -> None:
    with _CACHE_LOCK:
        _DISPATCH_STATS.clear()


def _static_reject_record(op: str, dims: tuple, dtype: str, st) -> bool:
    """True when a tuned record cannot run on the kernel: the static
    analyzer classifies it ILLEGAL for this workload (a stale record for
    another shape, a corrupted state, or tiles the kernel cannot launch).
    Failing to even build the space or analyzer also rejects: the
    heuristic is always safe, a broken record never is."""
    try:
        from repro_torch.core.analysis import ScheduleAnalyzer, dtype_in_bytes
        from repro_torch.core.ops import get_op

        depths = tuple(len(r) for r in st.as_lists())
        space = get_op(op).make_space(tuple(dims), depths)
        analyzer = ScheduleAnalyzer(space, in_bytes=dtype_in_bytes(dtype))
        return analyzer.analyze(st).illegal
    except Exception:
        return True


def lookup_tuned_state(op: str, dims: tuple, dtype: str):
    """Tuned schedule state for one op workload, or None (no record, or
    a record the static analyzer rejects — counted as ``static_reject``).
    Memoized per ``(op, dims, dtype, backend)`` until records change."""
    if op not in _POLICY.record_ops:
        return None
    key = (op, tuple(dims), dtype, _POLICY.cost_backend)
    with _CACHE_LOCK:
        hit = _DISPATCH_CACHE.get(key, _MISS)
    if hit is not _MISS:
        note_dispatch(op, "memo_hits")
        return hit
    note_dispatch(op, "store_lookups")
    st = global_records().lookup_state(
        workload_key_for(op, tuple(dims), dtype, _POLICY.cost_backend)
    )
    if st is not None and _static_reject_record(op, dims, dtype, st):
        note_dispatch(op, "static_reject")
        st = None  # memoized as a miss: refused once per (shape, records)
    with _CACHE_LOCK:
        _DISPATCH_CACHE[key] = st
    return st


def flash_schedule(seq_q: int, seq_kv: int, head_dim: int, dtype: str,
                   grid_y: int = 1) -> Optional[tuple[int, int]]:
    """Tuned ``(block_q, block_kv)`` for one flash-attention workload, or
    None when no record fits.  A record the kernel cannot launch is
    refused by the static guard, and again (counted as ``static_reject``)
    when it cannot launch at the served grid of ``grid_y`` = batch x
    query heads; blocks must tile the sequences exactly."""
    st = lookup_tuned_state("flash", (seq_q, seq_kv, head_dim), dtype)
    if st is None:
        return None
    try:
        bq, bkv = st.block_q, st.block_kv
    except AttributeError:  # a foreign record under a flash key
        return None
    if bq < 1 or bkv < 1 or seq_q % bq or seq_kv % bkv:
        return None
    if flash_launch_error(bq, bkv, head_dim, dtype_in_bytes(dtype), grid_y=grid_y):
        note_dispatch("flash", "static_reject")
        return None
    return bq, bkv


def flash_blocks(seq_q: int, seq_kv: int, head_dim: int, dtype: torch.dtype,
                 grid_y: int = 1) -> tuple[Optional[tuple[int, int]], str]:
    """``(blocks, source)`` that attention dispatch runs one long
    self-attention under: the tuned record, else the kernel's heuristic
    blocks, or ``(None, "plain")`` when no block the kernel launches (at
    ``grid_y`` = batch x query heads) divides the sequences.  Counts only
    the record lookup."""
    blocks = flash_schedule(seq_q, seq_kv, head_dim, dtype_name(dtype), grid_y=grid_y)
    if blocks is not None:
        return blocks, "records"
    in_bytes = torch.empty((), dtype=dtype).element_size()
    blocks = default_blocks(seq_q, seq_kv, head_dim, in_bytes, grid_y=grid_y)
    return blocks, "plain" if blocks is None else "heuristic"


def launch_counts() -> collections.Counter:
    """Both kernels' launch counts, keyed ``("gemm", (M, K, N))`` and
    ``("flash", (seq_q, seq_kv, head_dim))``."""
    counts = collections.Counter({("gemm", d): n for d, n in GEMM_LAUNCHES.items()})
    counts.update({("flash", d): n for d, n in FLASH_LAUNCHES.items()})
    return counts


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def kernel_config(m: int, k: int, n: int, dtype: torch.dtype,
                  config: Optional[KernelConfig] = None) -> tuple[Optional[KernelConfig], str]:
    """``(config, source)`` that :func:`gemm` dispatches one product
    under: explicit, tuned record, heuristic, or ``(None, "matmul")``
    when the kernel takes none.  Counts only the record lookup."""
    if dtype not in _KERNEL_DTYPES:
        return None, "matmul"
    in_bytes = torch.empty((), dtype=dtype).element_size()
    if config is not None:
        cfg, src = config, "explicit"
    else:
        st = lookup_tuned_state("gemm", (m, k, n), dtype_name(dtype))
        if st is not None:
            cfg, src = kernel_config_from_state(st), "records"
        else:
            cfg, src = default_config(m, k, n, in_bytes), "heuristic"
    if cfg is None:
        return None, "matmul"
    try:
        cfg.validate(m, k, n, in_bytes)
    except ValueError:
        return None, "matmul"
    return cfg, src


def _dispatch(a: torch.Tensor, b: torch.Tensor,
              config: Optional[KernelConfig] = None) -> torch.Tensor:
    """One 2-D product through the policy (no autograd); a bf16 product
    of fewer than ``_MIN_ROWS`` rows runs on rows padded with zeros."""
    (m, k), n = a.shape, b.shape[1]
    pad = max(_MIN_ROWS - m, 0) if config is None and a.dtype == torch.bfloat16 else 0
    cfg, src = kernel_config(m + pad, k, n, a.dtype, config)
    note_dispatch("gemm", src)
    if cfg is None:
        return torch.matmul(a, b)
    if pad:
        return gemm_tiled(_aligned(torch.nn.functional.pad(a, (0, 0, 0, pad))),
                          _aligned(b), cfg)[:m]
    return gemm_tiled(_aligned(a), _aligned(b), cfg)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary, as the bf16
    kernels' copies need: a contiguous view at an odd offset is copied
    (on ``meta``, where the same view is copied as on the card)."""
    t = t.contiguous()
    return t.clone() if misaligned(t) else t


class _Gemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, config):
        ctx.save_for_backward(a, b)
        return _dispatch(a, b, config)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        # the backward products get their own tuned configs (shapes differ);
        # each is cast to its operand's type, as the JAX package's VJP casts
        da = db = None
        if ctx.needs_input_grad[0]:
            with launch_role("dA"):
                da = _dispatch(g, b.t().contiguous()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            with launch_role("dB"):
                db = _dispatch(a.t().contiguous(), g).to(b.dtype)
        return da, db, None


def gemm(a: torch.Tensor, b: torch.Tensor, config: Optional[KernelConfig] = None,
         device="cuda") -> torch.Tensor:
    """``a @ b`` through the dispatch policy (see module docstring).
    Higher-rank ``a`` is flattened to 2-D and restored."""
    if a.ndim < 2 or b.ndim != 2:
        raise ValueError(f"gemm expects (.., K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gemm runs on the card and none is present; pass device='cpu'")
    if a.device.type != dev.type or b.device.type != dev.type:
        raise ValueError(
            f"operands on {a.device}/{b.device}, but gemm runs on {dev}"
        )
    lead, k, n = a.shape[:-1], a.shape[-1], b.shape[-1]
    out = _Gemm.apply(a.reshape(-1, k), b, config)
    return out.reshape(*lead, n)
