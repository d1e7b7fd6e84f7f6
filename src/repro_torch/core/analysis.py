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
  * *launch* (:func:`gemm_launch_error`), per dtype.  float32 (the SIMT
    kernel): a register tile the kernel has no instantiation for, a block
    below the kernel's minimum, a thread count that is not whole warps
    or exceeds the register-capped limit of its instantiation, one
    (padded) slab of its ring over the shared-memory budget.  bfloat16
    at ``block_m >= 64`` (the ``wgmma`` kernel): a register tile other
    than 1x1 (``register_tile``), a warpgroup tile or slab depth with no
    instantiation (``wgmma_shape``), accumulators over the register cliff
    (``accumulator_cliff``), more than two consumer warpgroups (beside the
    producer), or a ring of fewer than two stages (``ring_too_shallow``).
    bfloat16 below 64 rows (the bandwidth kernel): rows, columns, warp
    split or slab depth it does not take (``stream_tile``) or a ring of
    fewer than two stages.
    Every kernel: a CTA grid taller than CUDA's ``gridDim.y`` limit;
  * *flash launch* (:func:`flash_launch_error`): a dtype or head_dim the
    kernel has no instantiation for, a block below 16 or not a multiple
    of 16 (of 64 rows, one warpgroup, for block_q in bf16), an f32
    block_kv other than 16, 32 or 64 (its instantiations), threads over
    the instantiation's limit, a bf16 kv block over the keys held in
    registers, tiles over the shared-memory budget (in f32 with a ring
    of one stage), or a grid taller than ``gridDim.y``.

``WASTEFUL`` — launchable but dominated (advisory unless noted):

  * ``degenerate``: a 1x1 register tile of the float32 SIMT GEMM kernel —
    every shared-memory operand load feeds a single FMA, its worst
    corner (in bfloat16 every launchable state has a 1x1 tile: a
    ``wgmma`` fragment is fixed by the instruction);
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
    "gemm_kernel_kind",
    "gemm_stages",
    "simt_lda",
    "GEMM_SIMT_MAX_STAGES",
    "gemm_bf16_max_threads",
    "gemm_wgmma_threads",
    "GEMM_WG_INSTANCES",
    "GEMM_BW_BN",
    "max_threads_for_reg_tile",
    "FLASH_HEAD_DIMS",
    "FLASH_STAGES",
    "FLASH_F32_BKV",
    "FLASH_F32_MAX_STAGES",
    "flash_row_threads",
    "flash_stages",
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
    """Thread limit of the float32 SIMT kernel's instantiation for one
    register tile — the ``__launch_bounds__`` of ``gemm.cu`` (which caps
    registers so a block of this many threads always fits the 64K-register
    file)."""
    t = reg_m * reg_n
    return 1024 if t <= 4 else (512 if t <= 16 else 256)


#: the SIMT kernel's ring: stages = min(GEMM_SIMT_MAX_STAGES, opt-in shared
#: memory // slab bytes) (``kSimtMaxStages``); one stage launches too
GEMM_SIMT_MAX_STAGES = 4


def simt_lda(block_m: int) -> int:
    """Row stride (elements) of the SIMT kernel's transposed A slab: the
    least stride >= ``block_m`` that is 4 modulo 8, so a warp's 4-byte
    stores of 8 k by 4 rows and its 16-byte row loads hit distinct banks
    (``simt_lda`` in ``gemm.cu``)."""
    return block_m + (12 - block_m % 8) % 8


# -- the bfloat16 kernels of gemm.cu --------------------------------------------

#: threads of one warpgroup, and the M of one ``wgmma`` instruction
GEMM_WG_THREADS = 128
GEMM_WG_ROWS = 64
#: the most consumer warpgroups a CTA has (``kMaxWarpgroups``); beside
#: them the CTA runs one producer warpgroup, which issues the TMA loads, so
#: every instantiation's ``__launch_bounds__`` allows (2 + 1) x 128 threads
GEMM_WG_MAX = 2
#: the ring: stages = min(GEMM_WG_MAX_STAGES, (opt-in shared memory - 1 KB
#: of alignment slack - the barriers) // slab bytes), refused below
#: GEMM_WG_MIN_STAGES (one slab multiplied while the next is loaded)
GEMM_WG_MAX_STAGES = 8
GEMM_WG_MIN_STAGES = 2
#: a full and an empty mbarrier (8 bytes each) for each of the most stages
#: (``kBarrierBytes``), after the ring
GEMM_WG_BARRIER_BYTES = 2 * GEMM_WG_MAX_STAGES * 8
#: the register cliff: f32 accumulators per thread, sub_m * sub_n / 128
GEMM_ACC_REGS_MAX = 128
#: the wgmma instantiations (``WG_INSTANCES``): (slab depth bk, warpgroup
#: rows sub_m, instruction N sub_n) with accumulators under the cliff; bk
#: and sub_n are whole 64-element atoms of the 128-byte swizzled layout
GEMM_WG_INSTANCES = tuple(
    (bk, sub_m, sub_n)
    for bk in (64, 128)
    for sub_m in (64, 128)
    for sub_n in (64, 128, 256)
    if sub_m * sub_n // GEMM_WG_THREADS <= GEMM_ACC_REGS_MAX
)
#: shared memory the wgmma kernel adds to its ring to align it to 1024 B
GEMM_ALIGN_SLACK = 1024
#: the bandwidth kernel (``gemm_tiled_stream``): CTA rows, the columns it
#: is instantiated for, its warps (split-K inside the CTA), its slab depth
#: granularity (the k16 of mma.sync) and its ring (``kStreamRingBytes``)
GEMM_BW_ROWS = (8, 16)
GEMM_BW_BN = (8, 16, 32, 64)
GEMM_BW_WARPS = 4
GEMM_BW_K_STEP = 16
GEMM_BW_MAX_STAGES = 8
GEMM_BW_RING_BYTES = 98_304
GEMM_BW_MIN_STAGES = 2


def gemm_kernel_kind(block_m: int, in_bytes: int = 2) -> str:
    """Which kernel of ``gemm.cu`` runs a tile: ``"simt"`` (float32),
    ``"wgmma"`` (bfloat16, ``block_m >= 64``) or ``"stream"`` (bfloat16,
    below 64 rows: decode's skinny products)."""
    if in_bytes != 2:
        return "simt"
    return "wgmma" if block_m >= GEMM_WG_ROWS else "stream"


def _stream_stage_elems(block_m: int, block_k: int, block_n: int) -> int:
    # rows padded to an odd number of 16-byte units (stream_lda/stream_ldb)
    ldb = block_n if (block_n // 8) % 2 else block_n + 8
    return block_m * (block_k + 8) + block_k * ldb


def gemm_stages(block_m: int, block_k: int, block_n: int, in_bytes: int = 2,
                spec: Optional[HopperSpec] = None) -> int:
    """Depth of a kernel's ring of K slabs, derived from shared memory as
    the launcher derives it.  SIMT (float32): ``min(4, opt-in shared
    memory // ((simt_lda(bm) + bn) * bk * 4))``, 0 where one slab does
    not fit.  ``wgmma``: ``min(8, (opt-in shared memory - 1 KB of
    alignment slack - 128 B of barriers) // ((bm + bn) * bk * 2))``.  The
    bandwidth kernel:
    ``min(8, 96 KB // stage bytes)``."""
    kind = gemm_kernel_kind(block_m, in_bytes)
    spec = spec or HopperSpec()
    if kind == "simt":
        slab = (simt_lda(block_m) + block_n) * block_k * in_bytes
        return min(GEMM_SIMT_MAX_STAGES, spec.smem_per_block // slab)
    if kind == "wgmma":
        slab = (block_m + block_n) * block_k * 2
        return min(GEMM_WG_MAX_STAGES,
                   (spec.smem_per_block - GEMM_ALIGN_SLACK - GEMM_WG_BARRIER_BYTES) // slab)
    stage = 2 * _stream_stage_elems(block_m, block_k, block_n)
    return min(GEMM_BW_MAX_STAGES, GEMM_BW_RING_BYTES // stage)


def gemm_smem_bytes(block_m: int, block_k: int, block_n: int,
                    in_bytes: int = 2, spec: Optional[HopperSpec] = None) -> int:
    """Shared memory of one CTA.  SIMT (float32): the ring of
    ``gemm_stages`` slabs, each an A slab transposed with rows padded to
    ``simt_lda`` and a B slab (one slab's bytes where it does not fit
    once).  ``wgmma``: the ring of ``gemm_stages`` slabs, 1 KB of
    alignment slack and the ring's barriers.  Bandwidth kernel: its ring of padded slabs plus the
    f32 partial sums of its warps.  Accumulators live in registers."""
    kind = gemm_kernel_kind(block_m, in_bytes)
    stages = gemm_stages(block_m, block_k, block_n, in_bytes, spec)
    if kind == "simt":
        return max(stages, 1) * (simt_lda(block_m) + block_n) * block_k * in_bytes
    if kind == "wgmma":
        return (stages * (block_m + block_n) * block_k * 2 + GEMM_ALIGN_SLACK
                + GEMM_WG_BARRIER_BYTES)
    return (stages * 2 * _stream_stage_elems(block_m, block_k, block_n)
            + 4 * GEMM_BW_WARPS * block_m * block_n)


def gemm_bf16_max_threads(block_m: int) -> int:
    """Thread limit of the bf16 instantiations that run a tile of
    ``block_m`` rows — their ``__launch_bounds__`` (``wgmma``: the most
    consumer warpgroups and the producer)."""
    if block_m >= GEMM_WG_ROWS:
        return (GEMM_WG_MAX + 1) * GEMM_WG_THREADS
    return 32 * GEMM_BW_WARPS


def gemm_wgmma_threads(block_m: int, block_n: int, sub_m: int, sub_n: int) -> int:
    """Threads of a ``wgmma`` CTA: its ``(block_m / sub_m) x (block_n /
    sub_n)`` consumer warpgroups and the producer warpgroup
    (``wgmma_threads`` in ``gemm.cu``)."""
    return ((block_m // sub_m) * (block_n // sub_n) + 1) * GEMM_WG_THREADS


def gemm_launch_error(
    block_m: int, block_k: int, block_n: int,
    sub_m: int, sub_n: int, reg_m: int, reg_n: int,
    in_bytes: int = 2, spec: Optional[HopperSpec] = None,
    grid_m: int = 1,
) -> Optional[tuple[str, str]]:
    """``(reason, detail)`` when the GEMM kernel cannot launch this tile
    configuration, else None.  THE legality rule of the kernel: bf16
    inputs take the tensor-core kernel (``block_m >= 64``) or the
    bandwidth kernel (below), other inputs the SIMT kernel."""
    spec = spec or HopperSpec()
    if in_bytes == 2:
        err = _bf16_launch_error(block_m, block_k, block_n, sub_m, sub_n,
                                 reg_m, reg_n, spec)
        if err is not None:
            return err
    else:
        err = _simt_launch_error(block_m, block_k, block_n, sub_m, sub_n,
                                 reg_m, reg_n, in_bytes, spec)
        if err is not None:
            return err
    if grid_m > spec.max_grid_y:
        return ("grid_too_large",
                f"{grid_m} CTA rows exceed gridDim.y <= {spec.max_grid_y}")
    return None


def _simt_launch_error(block_m, block_k, block_n, sub_m, sub_n, reg_m, reg_n,
                       in_bytes, spec) -> Optional[tuple[str, str]]:
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
    if gemm_stages(block_m, block_k, block_n, in_bytes, spec) < 1:
        smem = gemm_smem_bytes(block_m, block_k, block_n, in_bytes, spec)
        return ("smem_overflow",
                f"one A/B slab takes {smem} B of shared memory, over the "
                f"{spec.smem_per_block} B budget (in_bytes={in_bytes})")
    return None


def _bf16_launch_error(block_m, block_k, block_n, sub_m, sub_n, reg_m, reg_n,
                       spec) -> Optional[tuple[str, str]]:
    if min(block_m, block_n) < spec.min_block_mn or block_k < GEMM_BW_K_STEP:
        return ("block_below_minimum",
                f"block {block_m}x{block_k}x{block_n} is below the bf16 "
                f"kernels' minimum {spec.min_block_mn} (m, n) / "
                f"{GEMM_BW_K_STEP} (k)")
    if reg_m != 1 or reg_n != 1:
        return ("register_tile",
                f"register tile {reg_m}x{reg_n}: the bf16 kernels' fragments "
                f"are fixed by the instruction (m3 = n3 = 1)")
    if sub_m < 1 or sub_n < 1 or block_m % sub_m or block_n % sub_n:
        return ("tile_nesting",
                f"block {block_m}x{block_n} / warpgroup tile {sub_m}x{sub_n} "
                f"do not nest")
    if block_m < GEMM_WG_ROWS:
        if (block_m not in GEMM_BW_ROWS or block_n not in GEMM_BW_BN
                or sub_m != block_m or sub_n != block_n
                or block_k % GEMM_BW_K_STEP):
            return ("stream_tile",
                    f"block {block_m}x{block_k}x{block_n} / {sub_m}x{sub_n}: "
                    f"the bandwidth kernel takes {list(GEMM_BW_ROWS)} rows, "
                    f"{list(GEMM_BW_BN)} columns, slabs in steps of "
                    f"{GEMM_BW_K_STEP} and no split of the CTA tile")
        stages, floor = gemm_stages(block_m, block_k, block_n, 2, spec), GEMM_BW_MIN_STAGES
    else:
        if (block_k, sub_m, sub_n) not in GEMM_WG_INSTANCES:
            acc = sub_m * sub_n // GEMM_WG_THREADS
            if (sub_m % GEMM_WG_ROWS == 0 and sub_n % 64 == 0
                    and acc > GEMM_ACC_REGS_MAX):
                return ("accumulator_cliff",
                        f"warpgroup tile {sub_m}x{sub_n} holds {acc} f32 "
                        f"accumulators a thread, over {GEMM_ACC_REGS_MAX}")
            return ("wgmma_shape",
                    f"(bk, sub_m, sub_n) = ({block_k}, {sub_m}, {sub_n}): the "
                    f"wgmma kernel is instantiated for bk in (64, 128), "
                    f"sub_m in (64, 128), sub_n in (64, 128, 256)")
        wgs = (block_m // sub_m) * (block_n // sub_n)
        if wgs > GEMM_WG_MAX:
            threads = gemm_wgmma_threads(block_m, block_n, sub_m, sub_n)
            return ("threads_over_limit",
                    f"{wgs} consumer warpgroups and the producer ({threads} threads) "
                    f"per CTA exceed {gemm_bf16_max_threads(block_m)}, the kernel's "
                    f"__launch_bounds__")
        stages = gemm_stages(block_m, block_k, block_n, 2, spec)
        floor = GEMM_WG_MIN_STAGES
    if stages < floor:
        return ("ring_too_shallow",
                f"{max(stages, 0)} stages of {block_m}x{block_k}x{block_n} slabs "
                f"fit the ring; the kernel needs {floor}")
    smem = gemm_smem_bytes(block_m, block_k, block_n, 2, spec)
    if smem > spec.smem_per_block:
        return ("smem_overflow",
                f"the ring takes {smem} B of shared memory, over the "
                f"{spec.smem_per_block} B budget")
    return None


def _gemm_state_launch_error(space, s, in_bytes: int, spec: HopperSpec):
    return gemm_launch_error(
        s.block_m, s.block_k, s.block_n, s.sub_m, s.sub_n, s.reg_m, s.reg_n,
        in_bytes, spec, grid_m=s.grid[0],
    )


def _gemm_waste(space, s, in_bytes: int, spec: HopperSpec) -> Optional[tuple[str, str]]:
    if in_bytes != 2 and s.reg_m == 1 and s.reg_n == 1:
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
#: (f32: four row groups of 8 or 16 lanes, whole warps; bf16: the k16 step
#: of P @ V, one instantiation per 16 keys of block_kv)
FLASH_MIN_BLOCK = 16
_FLASH_PAD = 4  # floats of padding of a d-major row (f32 kernel, ``kPad``)
#: f32 (CUDA-core) kernel: the query rows a thread owns, in S and in O
#: (``kF32Rows``)
FLASH_F32_ROWS = 4
#: ... its block_kv instantiations (``F32_BKV``): a thread holds 4 x
#: block_kv / flash_row_threads logits of S in registers
FLASH_F32_BKV = (16, 32, 64)
#: ... every instantiation's ``__launch_bounds__`` (``kF32MaxThreads``)
FLASH_F32_MAX_THREADS = 512
#: ... the deepest K/V ring (``kF32MaxStages``): the next kv block in flight
#: while this one is computed
FLASH_F32_MAX_STAGES = 2
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


def flash_row_threads(head_dim: int) -> int:
    """Threads of the f32 kernel that share a query row (consecutive lanes
    of one warp): 16 at head_dim >= 64, else 8 (``f32_row_threads``)."""
    return 16 if head_dim >= 64 else 8


def flash_threads(block_q: int, head_dim: int, in_bytes: int = 2) -> int:
    """Threads of one CTA: a 128-thread warpgroup per 64 query rows in
    bf16; in f32 ``flash_row_threads`` per ``FLASH_F32_ROWS`` rows."""
    if in_bytes == 2:
        return block_q * 128 // FLASH_WG_ROWS
    return block_q // FLASH_F32_ROWS * flash_row_threads(head_dim)


def flash_max_threads(head_dim: int, in_bytes: int = 2) -> int:
    """Thread limit of the kernel instantiations for one dtype and head_dim
    — their ``__launch_bounds__``."""
    if in_bytes == 2:
        return FLASH_BF16_MAX_BQ * 128 // FLASH_WG_ROWS
    return FLASH_F32_MAX_THREADS


def _flash_f32_tiles(block_q: int, block_kv: int, head_dim: int) -> tuple[int, int, int]:
    # floats of the d-major Q tile, one ring stage (K d-major, V row-major)
    # and the key-major P tile
    q = head_dim * (block_q + _FLASH_PAD)
    stage = head_dim * (block_kv + _FLASH_PAD) + block_kv * head_dim
    p = block_kv * (block_q + _FLASH_PAD)
    return q, stage, p


def flash_stages(block_q: int, block_kv: int, head_dim: int, in_bytes: int = 2,
                 spec: Optional[HopperSpec] = None) -> int:
    """Depth of the kernel's K/V ring.  bf16: ``FLASH_STAGES``.  f32: as
    many stages as the opt-in shared memory holds beside the Q and P
    tiles, at most ``FLASH_F32_MAX_STAGES``; 0 where one does not fit
    (``f32_stages``)."""
    if in_bytes == 2:
        return FLASH_STAGES
    spec = spec or HopperSpec()
    q, stage, p = _flash_f32_tiles(block_q, block_kv, head_dim)
    return max(0, min(FLASH_F32_MAX_STAGES, (spec.smem_per_block - 4 * (q + p)) // (4 * stage)))


def flash_smem_bytes(block_q: int, block_kv: int, head_dim: int, in_bytes: int = 2,
                     spec: Optional[HopperSpec] = None) -> int:
    """Shared memory of one CTA.  bf16: the Q tile and a ring of
    ``FLASH_STAGES`` K and V tiles, all bf16 and unpadded (P stays in
    registers).  f32: the d-major Q tile, the key-major P tile and a ring
    of ``flash_stages`` stages, each a d-major K tile and a row-major V
    tile (one stage's bytes where none fits); d-major rows are padded by
    ``_FLASH_PAD`` floats.  The accumulators, running max and sum live in
    registers."""
    if in_bytes == 2:
        return 2 * head_dim * (block_q + 2 * FLASH_STAGES * block_kv)
    q, stage, p = _flash_f32_tiles(block_q, block_kv, head_dim)
    stages = max(1, flash_stages(block_q, block_kv, head_dim, in_bytes, spec))
    return 4 * (q + stages * stage + p)


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
    if in_bytes == 4 and block_kv not in FLASH_F32_BKV:
        if block_kv > max(FLASH_F32_BKV):
            return ("kv_block_over_registers",
                    f"block_kv {block_kv} exceeds {max(FLASH_F32_BKV)}, the keys "
                    f"whose logits the f32 kernel holds in registers")
        return ("block_alignment",
                f"block_kv {block_kv}: the f32 kernel is instantiated for "
                f"{list(FLASH_F32_BKV)}")
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
    smem = flash_smem_bytes(block_q, block_kv, head_dim, in_bytes, spec)
    if smem > spec.smem_per_block:
        return ("smem_overflow",
                f"Q/K/V{'' if in_bytes == 2 else '/P'} tiles take {smem} B of shared "
                f"memory{'' if in_bytes == 2 else ' with one stage'}, over the "
                f"{spec.smem_per_block} B budget")
    if grid_y > spec.max_grid_y:
        return ("grid_too_large",
                f"{grid_y} batch x head rows exceed gridDim.y <= {spec.max_grid_y}")
    return None


def _flash_state_launch_error(space, s, in_bytes: int, spec: HopperSpec):
    return flash_launch_error(
        s.block_q, s.block_kv, space.head_dim, in_bytes, spec, grid_y=space.heads,
    )


def _flash_waste(space, s, in_bytes: int, spec: HopperSpec) -> Optional[tuple[str, str]]:
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
        w = waste(self.space, s, self.in_bytes, self.spec)
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
