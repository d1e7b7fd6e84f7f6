"""Static schedule analysis — compile-free legality verdicts over
:class:`~repro_torch.core.space.SearchSpace` states, for the Hopper
kernels (``repro_torch/kernels/csrc/gemm.cu`` and ``flash_attention.cu``).

One rule per kernel decides what it can launch, and every layer shares
it: the kernel wrapper's check (``KernelConfig.validate``,
``flash_attention``), the measured and analytical cost backends, the
measurement engine's pre-filter, and record-aware dispatch's
static-reject guard.  So the analyzer's ILLEGAL verdicts and the
kernels' refusals cannot drift apart.

Verdict lattice (``AnalysisResult.verdict``):

``ILLEGAL`` — the kernel provably cannot launch the state:

  * *structural* (``SearchSpace.structural_error``): wrong row count or
    nesting depth, a factor < 1, or a row product that does not equal
    its dimension;
  * *launch* (:func:`gemm_launch_error`): a register tile the kernel has
    no instantiation for, a block below the kernel's minimum, a thread
    count that is not whole warps or exceeds the register-capped limit
    of its instantiation, operand slabs over the shared-memory budget,
    or a CTA grid taller than CUDA's ``gridDim.y`` limit;
  * *flash launch* (:func:`flash_launch_error`): a dtype or head_dim the
    kernel has no instantiation for, a block below 16 or not a multiple
    of 16 (of 64 rows, one warpgroup, for block_q in bf16), threads over
    the instantiation's limit, a bf16 kv block over the keys held in
    registers, tiles over the shared-memory budget, or a grid taller
    than ``gridDim.y``.

``WASTEFUL`` — launchable but dominated (advisory unless noted):

  * ``degenerate``: a 1x1 GEMM register tile — every shared-memory
    operand load feeds a single FMA, the SIMT kernel's worst corner;
  * ``under_fill``: fewer CTAs than the card has SMs (for flash, over
    the space's ``heads`` query heads).

``OK`` — no static objection.

Pruning policy (:func:`should_prune`): ILLEGAL plus the ``degenerate``
WASTEFUL subclass, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = [
    "ILLEGAL",
    "WASTEFUL",
    "OK",
    "HopperSpec",
    "AnalysisResult",
    "ScheduleAnalyzer",
    "analyzer_for_backend",
    "should_prune",
    "gemm_smem_bytes",
    "gemm_launch_error",
    "max_threads_for_reg_tile",
    "FLASH_HEAD_DIMS",
    "FLASH_STAGES",
    "flash_threads",
    "flash_max_threads",
    "flash_smem_bytes",
    "flash_launch_error",
    "dtype_in_bytes",
]

ILLEGAL = "ILLEGAL"
WASTEFUL = "WASTEFUL"
OK = "OK"

_DTYPE_BYTES = {
    "float64": 8, "f64": 8,
    "float32": 4, "f32": 4,
    "bfloat16": 2, "bf16": 2,
    "float16": 2, "f16": 2,
    "int8": 1, "uint8": 1,
}


def dtype_in_bytes(dtype: Optional[str], default: int = 2) -> int:
    """Element size of a dtype name; unknown/None falls back to bf16."""
    if dtype is None:
        return default
    return _DTYPE_BYTES.get(str(dtype), default)


@dataclasses.dataclass(frozen=True)
class HopperSpec:
    """What the GEMM kernel may use on one Hopper card.  Defaults are the
    H100 SXM's (NVIDIA data sheet); :meth:`for_device` reads the SM count
    and the opt-in shared-memory limit from the card itself."""

    #: dynamic shared memory a block may opt in to (above 48 KB only after
    #: ``cudaFuncSetAttribute``, which the kernel's launcher does)
    smem_per_block: int = 232_448
    num_sms: int = 132
    warp_size: int = 32
    max_grid_y: int = 65_535
    #: the kernel's smallest CTA tile along m/n and its smallest K slab
    min_block_mn: int = 8
    min_block_k: int = 8
    #: per-thread register tiles the kernel is instantiated for
    reg_tiles: tuple[int, ...] = (1, 2, 4, 8)

    @classmethod
    def for_device(cls, device=None) -> "HopperSpec":
        import torch

        props = torch.cuda.get_device_properties(device)
        return cls(
            smem_per_block=int(
                getattr(props, "shared_memory_per_block_optin", cls.smem_per_block)
            ),
            num_sms=int(props.multi_processor_count),
        )


def max_threads_for_reg_tile(reg_m: int, reg_n: int) -> int:
    """Thread limit of the kernel instantiation for one register tile —
    the ``__launch_bounds__`` of ``gemm.cu`` (which caps registers so a
    block of this many threads always fits the 64K-register file)."""
    t = reg_m * reg_n
    return 1024 if t <= 4 else (512 if t <= 16 else 256)


def gemm_smem_bytes(block_m: int, block_k: int, block_n: int,
                    in_bytes: int = 2) -> int:
    """Shared memory of one CTA: the A (bk x bm) and B (bk x bn) operand
    slabs in the input type.  The f32 accumulator lives in registers."""
    return (block_m + block_n) * block_k * in_bytes


def gemm_launch_error(
    block_m: int, block_k: int, block_n: int,
    sub_m: int, sub_n: int, reg_m: int, reg_n: int,
    in_bytes: int = 2, spec: Optional[HopperSpec] = None,
    grid_m: int = 1,
) -> Optional[tuple[str, str]]:
    """``(reason, detail)`` when the GEMM kernel cannot launch this tile
    configuration, else None.  THE legality rule of the kernel."""
    spec = spec or HopperSpec()
    if reg_m not in spec.reg_tiles or reg_n not in spec.reg_tiles:
        return ("register_tile",
                f"register tile {reg_m}x{reg_n}: the kernel is instantiated "
                f"for {list(spec.reg_tiles)} per side")
    if min(block_m, block_n) < spec.min_block_mn or block_k < spec.min_block_k:
        return ("block_below_minimum",
                f"block {block_m}x{block_k}x{block_n} is below the kernel's "
                f"minimum {spec.min_block_mn} (m, n) / {spec.min_block_k} (k)")
    if (sub_m < 1 or sub_n < 1 or block_m % sub_m or block_n % sub_n
            or sub_m % reg_m or sub_n % reg_n):
        return ("tile_nesting",
                f"block {block_m}x{block_n} / warp tile {sub_m}x{sub_n} / "
                f"register tile {reg_m}x{reg_n} do not nest")
    threads = (block_m // reg_m) * (block_n // reg_n)
    if threads % spec.warp_size:
        return ("partial_warp",
                f"{threads} threads per CTA is not a whole number of warps")
    cap = max_threads_for_reg_tile(reg_m, reg_n)
    if threads > cap:
        return ("threads_over_limit",
                f"{threads} threads per CTA exceeds {cap}, the register-capped "
                f"limit for a {reg_m}x{reg_n} register tile")
    smem = gemm_smem_bytes(block_m, block_k, block_n, in_bytes)
    if smem > spec.smem_per_block:
        return ("smem_overflow",
                f"operand slabs take {smem} B of shared memory, over the "
                f"{spec.smem_per_block} B budget (in_bytes={in_bytes})")
    if grid_m > spec.max_grid_y:
        return ("grid_too_large",
                f"{grid_m} CTA rows exceed gridDim.y <= {spec.max_grid_y}")
    return None


def _gemm_state_launch_error(space, s, in_bytes: int, spec: HopperSpec):
    return gemm_launch_error(
        s.block_m, s.block_k, s.block_n, s.sub_m, s.sub_n, s.reg_m, s.reg_n,
        in_bytes, spec, grid_m=s.grid[0],
    )


def _gemm_waste(space, s, spec: HopperSpec) -> Optional[tuple[str, str]]:
    if s.reg_m == 1 and s.reg_n == 1:
        return ("degenerate",
                "1x1 register tile: one FMA per shared-memory operand load")
    ctas = s.grid[0] * s.grid[2]
    if ctas < spec.num_sms:
        return ("under_fill", f"{ctas} CTAs for {spec.num_sms} SMs")
    return None


# -- the flash-attention kernel (kernels/csrc/flash_attention.cu) --------------

#: head_dim values the kernel is instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 128)
#: the kernel's smallest block along q and kv; blocks are multiples of it
#: (f32: whole warps, float4 rows of the P tile, whole keys per thread;
#: bf16: the k16 step of P @ V, one instantiation per 16 keys of block_kv)
FLASH_MIN_BLOCK = 16
_FLASH_PAD = 4  # floats of padding per shared-memory row (f32 kernel)
#: bf16 (tensor-core) kernel: depth of the K/V ring of stages (``kStages``)
FLASH_STAGES = 2
#: ... query rows per warpgroup, the M of ``wgmma`` (``kWgRows``); block_q
#: is a multiple of it, with 128 threads per warpgroup
FLASH_WG_ROWS = 64
#: ... the largest block_q (two warpgroups, ``__launch_bounds__(256)``)
FLASH_BF16_MAX_BQ = 128
#: ... the largest block_kv (``kMaxBkv``): each multiple of 16 up to it is
#: an instantiation whose S fragments live in registers
FLASH_BF16_MAX_BKV = 128


def flash_threads(block_q: int, head_dim: int, in_bytes: int = 2) -> int:
    """Threads of one CTA: a 128-thread warpgroup per 64 query rows in
    bf16; in f32 ``threads_per_row`` (8, or 4 below head_dim 32) per row."""
    if in_bytes == 2:
        return block_q * 128 // FLASH_WG_ROWS
    return block_q * (8 if head_dim >= 32 else 4)


def flash_max_threads(head_dim: int, in_bytes: int = 2) -> int:
    """Thread limit of the kernel instantiation for one dtype and head_dim
    — its ``__launch_bounds__``."""
    if in_bytes == 2:
        return FLASH_BF16_MAX_BQ * 128 // FLASH_WG_ROWS
    return 512 if head_dim >= 128 else 1024


def flash_smem_bytes(block_q: int, block_kv: int, head_dim: int, in_bytes: int = 2) -> int:
    """Shared memory of one CTA.  bf16: the Q tile and a ring of
    ``FLASH_STAGES`` K and V tiles, all bf16 and unpadded (P stays in
    registers).  f32: the Q, K and V tiles with padded rows, plus the f32
    P tile of staged logits.  The accumulator, running max and sum live
    in registers."""
    if in_bytes == 2:
        return 2 * head_dim * (block_q + 2 * FLASH_STAGES * block_kv)
    ld = head_dim + _FLASH_PAD
    return 4 * (block_q * ld + 2 * block_kv * ld + block_q * (block_kv + _FLASH_PAD))


def flash_launch_error(
    block_q: int, block_kv: int, head_dim: int,
    in_bytes: int = 2, spec: Optional[HopperSpec] = None, grid_y: int = 1,
) -> Optional[tuple[str, str]]:
    """``(reason, detail)`` when the flash kernel cannot launch these
    blocks, else None.  ``grid_y`` is batch x query heads.  THE legality
    rule of the kernel: bf16 inputs take the tensor-core kernel, f32
    inputs the CUDA-core one."""
    spec = spec or HopperSpec()
    if in_bytes not in (2, 4):
        return ("dtype", f"{in_bytes}-byte inputs: the kernel takes bfloat16 or float32")
    if head_dim not in FLASH_HEAD_DIMS:
        return ("head_dim",
                f"head_dim {head_dim}: the kernel is instantiated for "
                f"{list(FLASH_HEAD_DIMS)}")
    if min(block_q, block_kv) < FLASH_MIN_BLOCK:
        return ("block_below_minimum",
                f"blocks ({block_q}, {block_kv}) are below the kernel's "
                f"minimum {FLASH_MIN_BLOCK}")
    if block_q % FLASH_MIN_BLOCK or block_kv % FLASH_MIN_BLOCK:
        return ("block_alignment",
                f"blocks ({block_q}, {block_kv}) are not multiples of "
                f"{FLASH_MIN_BLOCK}")
    if in_bytes == 2 and block_q % FLASH_WG_ROWS:
        return ("block_alignment",
                f"block_q {block_q} is not a multiple of {FLASH_WG_ROWS}, the "
                f"query rows of one warpgroup (wgmma m64)")
    threads = flash_threads(block_q, head_dim, in_bytes)
    if threads % spec.warp_size:
        return ("partial_warp",
                f"{threads} threads per CTA is not a whole number of warps")
    cap = flash_max_threads(head_dim, in_bytes)
    if threads > cap:
        return ("threads_over_limit",
                f"{threads} threads per CTA exceeds {cap}, the register-capped "
                f"limit for head_dim {head_dim} ({in_bytes}-byte inputs)")
    if in_bytes == 2 and block_kv > FLASH_BF16_MAX_BKV:
        return ("kv_block_over_registers",
                f"block_kv {block_kv} exceeds {FLASH_BF16_MAX_BKV}, the keys "
                f"whose S fragments the kernel holds in registers")
    smem = flash_smem_bytes(block_q, block_kv, head_dim, in_bytes)
    if smem > spec.smem_per_block:
        return ("smem_overflow",
                f"Q/K/V{'' if in_bytes == 2 else '/P'} tiles take {smem} B of shared "
                f"memory, over the {spec.smem_per_block} B budget")
    if grid_y > spec.max_grid_y:
        return ("grid_too_large",
                f"{grid_y} batch x head rows exceed gridDim.y <= {spec.max_grid_y}")
    return None


def _flash_state_launch_error(space, s, in_bytes: int, spec: HopperSpec):
    return flash_launch_error(
        s.block_q, s.block_kv, space.head_dim, in_bytes, spec, grid_y=space.heads,
    )


def _flash_waste(space, s, spec: HopperSpec) -> Optional[tuple[str, str]]:
    ctas = s.n_q_blocks * space.heads
    if ctas < spec.num_sms:
        return ("under_fill", f"{ctas} CTAs for {spec.num_sms} SMs")
    return None


#: op -> (launch rule, waste rule); ops without one get structural checks only
_RULES: dict[str, tuple[Callable, Callable]] = {
    "gemm": (_gemm_state_launch_error, _gemm_waste),
    "flash": (_flash_state_launch_error, _flash_waste),
}


@dataclasses.dataclass(frozen=True)
class AnalysisResult:
    """One verdict: ``(verdict, reason, detail)``; ``reason`` is the
    stable machine-readable tag journal ``static`` rows key on."""

    verdict: str
    reason: str = ""
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.verdict == OK

    @property
    def illegal(self) -> bool:
        return self.verdict == ILLEGAL

    @property
    def wasteful(self) -> bool:
        return self.verdict == WASTEFUL


_OK_RESULT = AnalysisResult(OK)


def should_prune(result: AnalysisResult) -> bool:
    """ILLEGAL plus the ``degenerate`` WASTEFUL subclass only."""
    return result.illegal or (result.wasteful and result.reason == "degenerate")


class ScheduleAnalyzer:
    """Classifies schedule states of one space without launching
    anything; verdicts are memoized per state key."""

    def __init__(self, space, spec: Optional[HopperSpec] = None,
                 in_bytes: int = 2):
        self.space = space
        self.spec = spec or HopperSpec()
        self.in_bytes = int(in_bytes)
        self._rules = _RULES.get(getattr(space, "op", None))
        self._cache: dict[str, AnalysisResult] = {}

    def analyze(self, s) -> AnalysisResult:
        try:
            key = s.key()
        except Exception:
            return self._classify(s)
        cached = self._cache.get(key)
        if cached is None:
            cached = self._cache[key] = self._classify(s)
        return cached

    def _classify(self, s) -> AnalysisResult:
        err = self._structural(s)
        if err is not None:
            return AnalysisResult(ILLEGAL, err[0], err[1])
        if self._rules is None:
            return _OK_RESULT
        launch, waste = self._rules
        err = launch(self.space, s, self.in_bytes, self.spec)
        if err is not None:
            return AnalysisResult(ILLEGAL, err[0], err[1])
        w = waste(self.space, s, self.spec)
        if w is not None:
            return AnalysisResult(WASTEFUL, w[0], w[1])
        return _OK_RESULT

    def _structural(self, s) -> Optional[tuple[str, str]]:
        try:
            return self.space.structural_error(s)
        except Exception as e:  # malformed rows: wrong types, bad arity
            return ("malformed", f"{type(e).__name__}: {e}")


def analyzer_for_backend(backend) -> ScheduleAnalyzer:
    """The analyzer matching a cost backend: its space, element width
    and card spec."""
    in_bytes = getattr(backend, "in_bytes", None)
    if in_bytes is None:
        in_bytes = dtype_in_bytes(getattr(backend, "dtype", None))
    return ScheduleAnalyzer(
        backend.space, spec=getattr(backend, "spec", None), in_bytes=in_bytes
    )
