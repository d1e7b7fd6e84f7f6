"""The tiled GEMM kernels for Hopper, their plain PyTorch version, and the
tuner <-> kernel contract.

The kernels (``csrc/gemm.cu``, CUDA C++ for ``sm_90a``) replace the
Pallas TPU kernel ``repro/kernels/gemm.py:_gemm_kernel``: float32 runs
on CUDA cores (SIMT), bfloat16 on the tensor cores (``wgmma``) at
``block_m >= 64`` and on a bandwidth-bound kernel (``mma.sync``,
split-K inside the CTA) below, for decode's M = 8 products.  The file is
built with ``nvcc`` into a shared library with a plain C interface the
first time it is needed (into ``_build/`` beside this file, keyed by a
hash of the source) and bound with ``ctypes``.

:func:`gemm_tiled` is the wrapper: it checks device, dtype, shape,
contiguity, alignment and the config (raising ``ValueError`` on what the
kernel does not take), then launches the kernel on the current stream
for CUDA tensors, or runs :func:`gemm_plain` — the same K slabs and f32
accumulation in PyTorch — for CPU tensors (on ``meta`` tensors it
returns an empty result: a dry run traces the step there), and reports
the kernel's work to the op counters in force.  Every kernel launch adds one
to :data:`LAUNCHES` (keyed by ``(M, K, N)``) and to :data:`ROLE_LAUNCHES`
(keyed by the :func:`launch_role` in force and ``(M, K, N)``: a training
step's forward, remat recompute, ``dA`` and ``dB`` products).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import threading
from typing import Optional

import torch

from repro_torch.core.analysis import GEMM_BW_BN, HopperSpec, gemm_kernel_kind, gemm_launch_error
from repro_torch.core.config_space import TilingState
from repro_torch.utils.op_costs import kernel_ran, uncounted

from .build import build_library

__all__ = [
    "KernelConfig",
    "kernel_config_from_state",
    "state_from_config",
    "default_config",
    "gemm_tiled",
    "gemm_plain",
    "misaligned",
    "build_kernel",
    "bind",
    "launch_with",
    "kernel_max_threads",
    "kernel_max_threads_bf16",
    "LAUNCHES",
    "ROLE_LAUNCHES",
    "launch_role",
    "reset_launches",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per ``(M, K, N)``: the wrapper adds one where it
#: launches the kernel, and nowhere else
LAUNCHES: collections.Counter = collections.Counter()
#: the same launches keyed ``(role, (M, K, N))``, by the role in force on
#: the launching thread (``forward`` unless :func:`launch_role` says other)
ROLE_LAUNCHES: collections.Counter = collections.Counter()
_ROLE = threading.local()


@contextlib.contextmanager
def launch_role(role: str):
    """Attribute this thread's launches inside the block to ``role``
    (``recompute``, ``dA``, ``dB``; the autograd engine runs a CUDA
    backward on its own thread, so the role is per thread)."""
    prev = getattr(_ROLE, "name", "forward")
    _ROLE.name = role
    try:
        yield
    finally:
        _ROLE.name = prev


def reset_launches() -> None:
    LAUNCHES.clear()
    ROLE_LAUNCHES.clear()


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """CTA tile ``block_m x block_n`` with K slab ``block_k``, warp tile
    (bf16: warpgroup tile) ``sub_m x sub_n`` (0 = the whole block) and
    per-thread register tile ``reg_m x reg_n`` (1 x 1 in bf16)."""

    block_m: int
    block_k: int
    block_n: int
    sub_m: int = 0
    sub_n: int = 0
    reg_m: int = 1
    reg_n: int = 1

    def resolved(self) -> "KernelConfig":
        return dataclasses.replace(
            self, sub_m=self.sub_m or self.block_m, sub_n=self.sub_n or self.block_n
        )

    def validate(self, m: int, k: int, n: int, in_bytes: int = 2,
                 spec: Optional[HopperSpec] = None) -> None:
        """Raise ``ValueError`` unless the kernel can run this config on
        an ``(m, k) @ (k, n)`` product: blocks divide the dims, and the
        launch rule of ``repro_torch.core.analysis`` holds."""
        c = self.resolved()
        if min(c.block_m, c.block_k, c.block_n) < 1 or (
            m % c.block_m or k % c.block_k or n % c.block_n
        ):
            raise ValueError(
                f"blocks {(c.block_m, c.block_k, c.block_n)} do not divide "
                f"dims {(m, k, n)}"
            )
        err = gemm_launch_error(
            c.block_m, c.block_k, c.block_n, c.sub_m, c.sub_n, c.reg_m, c.reg_n,
            in_bytes, spec, grid_m=m // c.block_m,
        )
        if err is not None:
            raise ValueError(f"{err[0]}: {err[1]}")


def kernel_config_from_state(s: TilingState) -> KernelConfig:
    """Read a tuner state as a kernel config (see ``config_space``)."""
    return KernelConfig(
        block_m=s.block_m, block_k=s.block_k, block_n=s.block_n,
        sub_m=s.sub_m, sub_n=s.sub_n, reg_m=s.reg_m, reg_n=s.reg_n,
    )


def state_from_config(cfg: KernelConfig, m: int, k: int, n: int) -> TilingState:
    """The depth-(4, 2, 4) tuner state that reads back as ``cfg``."""
    c = cfg.resolved()
    return TilingState(
        (m // c.block_m, c.block_m // c.sub_m, c.sub_m // c.reg_m, c.reg_m),
        (k // c.block_k, c.block_k),
        (n // c.block_n, c.block_n // c.sub_n, c.sub_n // c.reg_n, c.reg_n),
    )


#: bf16 tensor-core tiles the heuristic tries, best first: (block_m,
#: block_n, sub_m, sub_n).  128 x 256 by two 64 x 256 warpgroups copies
#: the fewest operand bytes per operation of the tiles under the register
#: cliff, and 128-deep slabs the fewest barriers per operation
_WGMMA_TILES = (
    (128, 256, 64, 256), (128, 128, 64, 128), (64, 256, 64, 256), (64, 128, 64, 128),
    (128, 64, 64, 64), (64, 64, 64, 64),
)
_WGMMA_BK = (128, 64)
#: bf16 bandwidth-kernel tiles: rows and slab depths, best first; columns
#: per CTA from :func:`_stream_widths`
_STREAM_ROWS = (16, 8)
_STREAM_BK = (256, 128, 512, 64, 32, 16)
#: CTAs the bandwidth kernel wants at least: about one per SM
_STREAM_MIN_CTAS = 128


def _stream_widths(n: int) -> tuple[int, ...]:
    """Columns per CTA, best first: the widest that still gives about one
    CTA per SM (wider rows of B stream better), then the narrowest."""
    wide = tuple(bn for bn in GEMM_BW_BN[::-1] if n // bn >= _STREAM_MIN_CTAS)
    return wide + tuple(bn for bn in GEMM_BW_BN if bn not in wide)


def _first_valid(cands, m, k, n, in_bytes) -> Optional[KernelConfig]:
    for cfg in cands:
        try:
            cfg.validate(m, k, n, in_bytes)
        except ValueError:
            continue
        return cfg
    return None


@functools.lru_cache(maxsize=None)
def default_config(m: int, k: int, n: int, in_bytes: int = 2) -> Optional[KernelConfig]:
    """Heuristic config when no tuning record exists, or None when the
    kernel takes no config for these dims (then dispatch uses
    ``torch.matmul``).  bfloat16: a ``wgmma`` tile (128 x 256 x 128 first)
    when M allows 64-row blocks, else the bandwidth kernel (16 or 8 rows,
    the widest columns that leave about one CTA per SM, 256-deep slabs
    first).  float32: the classic SIMT shape,
    a 128x128 CTA of 256 threads, each holding an 8x8 register tile, in
    32x64 warp tiles of 4x8 threads, with a 32-deep K slab — shrinking
    where the dims do not divide.  (The JAX package's TPU default picks
    blocks up to 256x512x256, whose slabs need far more than a CTA's
    227 KB.)  Memoized: decode asks once per product per step."""
    if in_bytes == 2:
        wgmma = (KernelConfig(bm, bk, bn, sm, sn) for bm, bn, sm, sn in _WGMMA_TILES
                 for bk in _WGMMA_BK)
        stream = (KernelConfig(bm, bk, bn, bm, bn) for bm in _STREAM_ROWS
                  for bn in _stream_widths(n) for bk in _STREAM_BK)
        return (_first_valid(wgmma, m, k, n, in_bytes) if m >= 64 else None) or \
            _first_valid(stream, m, k, n, in_bytes)
    return _first_valid(
        (KernelConfig(bm, bk, bn, min(bm, 4 * min(reg, bm)), min(bn, 8 * min(reg, bn)),
                      min(reg, bm), min(reg, bn))
         for bm in (128, 64, 32, 16, 8) for bn in (128, 64, 32, 16, 8)
         for bk in (32, 16, 8) for reg in (8, 4, 2, 1)),
        m, k, n, in_bytes)


# -- the plain version ---------------------------------------------------------


def gemm_plain(a: torch.Tensor, b: torch.Tensor, config: KernelConfig) -> torch.Tensor:
    """The kernels' arithmetic in PyTorch: the product of each ``bk``-deep
    K slab in float32, accumulated slab by slab into an f32 accumulator,
    cast to the input type at the end.  The CTA, warp(group) and register
    tiles partition the output without changing any element's
    arithmetic, so they are folded into one product per slab; the
    kernels sum in other orders (``wgmma`` per k16 step, the bandwidth
    kernel per warp, then over warps), all in f32, and none rounds
    anything to bf16 before the output."""
    bk = config.block_k
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    a32, b32 = a.float(), b.float()
    for k0 in range(0, a.shape[1], bk):
        acc.addmm_(a32[:, k0:k0 + bk], b32[k0:k0 + bk])
    return acc.to(a.dtype)


# -- build and bind ------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()


def build_kernel() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/gemm.cu`` for ``sm_90a`` (once per source hash) and
    load it.  Returns the library and ptxas' resource report.  A failed
    build raises."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib, log = build_library("gemm.cu")
        _LIB = (bind(lib), log)
        return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``gemm.cu`` (this file's, or
    a variant of its source) on the loaded library."""
    lib.repro_gemm.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
        + [ctypes.c_void_p]
    )
    lib.repro_gemm.restype = ctypes.c_int
    lib.repro_gemm_max_threads.argtypes = [ctypes.c_int] * 3
    lib.repro_gemm_max_threads.restype = ctypes.c_int
    lib.repro_gemm_bf16_max_threads.argtypes = [ctypes.c_int] * 5
    lib.repro_gemm_bf16_max_threads.restype = ctypes.c_int
    return lib


def kernel_max_threads(dtype: torch.dtype, reg_m: int, reg_n: int) -> int:
    """The compiled float32 SIMT instantiation's launch limit, as the card
    reports it (must equal ``analysis.max_threads_for_reg_tile``)."""
    lib, _ = build_kernel()
    return lib.repro_gemm_max_threads(_DTYPE_CODE[dtype], reg_m, reg_n)


def kernel_max_threads_bf16(config: KernelConfig) -> int:
    """The launch limit of the compiled bf16 instantiation that runs
    ``config``, as the card reports it (must equal
    ``analysis.gemm_bf16_max_threads``)."""
    c = config.resolved()
    lib, _ = build_kernel()
    return lib.repro_gemm_bf16_max_threads(c.block_m, c.block_k, c.block_n, c.sub_m, c.sub_n)


# -- the wrapper ---------------------------------------------------------------


def gemm_tiled(a: torch.Tensor, b: torch.Tensor, config: KernelConfig) -> torch.Tensor:
    """``C = A @ B`` through the tiled kernel under ``config``: launched
    on the card for CUDA tensors, the plain version for CPU tensors, and
    an empty result for ``meta`` tensors (a dry run's trace).  On every
    device the kernel's work, 2·M·K·N FLOPs and (M·K + K·N + M·N) elements
    moved, is reported to the op counters in force
    (``utils/op_costs.kernel_ran``); only a launch counts in
    :data:`LAUNCHES`.  Raises ``ValueError`` on anything the kernel does
    not take, and ``RuntimeError`` when a launch fails."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_tiled expects (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes {a.dtype}/{b.dtype}: the kernel takes float32 or bfloat16 pairs")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes row-major contiguous operands")
    (m, k), n = a.shape, b.shape[1]
    cfg = config.resolved()
    cfg.validate(m, k, n, a.element_size())
    # a contiguous view may start at any element; the same refusal on every
    # device, so the plain version refuses what the kernel would
    if gemm_kernel_kind(cfg.block_m, a.element_size()) != "simt" and (
            misaligned(a) or misaligned(b)):
        raise ValueError("the bf16 kernels copy 16-byte chunks: operands must be "
                         "16-byte aligned")
    if a.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"no kernel for device {a.device}")
    with uncounted():  # the kernel's work is reported below, on every device
        if a.device.type == "cpu":
            out = gemm_plain(a, b, cfg)
        elif a.device.type == "meta":
            out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        else:
            out = launch_with(build_kernel()[0], a, b, cfg)
            LAUNCHES[(m, k, n)] += 1
            ROLE_LAUNCHES[(getattr(_ROLE, "name", "forward"), (m, k, n))] += 1
    kernel_ran("gemm", (m, k, n), 2 * m * k * n, (m * k + k * n + m * n) * a.element_size(),
               out)
    return out


def misaligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s first element lies off a 16-byte boundary.  A
    ``meta`` tensor has no address: its storage offset decides, as it
    does on the card, whose allocator starts every storage on a 512-byte
    boundary."""
    if t.device.type == "meta":
        return bool(t.storage_offset() * t.element_size() % 16)
    return bool(t.data_ptr() % 16)


def launch_with(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor,
                config: KernelConfig) -> torch.Tensor:
    """Launch a bound build of the kernel on CUDA operands that
    :func:`gemm_tiled` has checked, on the current stream; neither checks
    nor counts.  Raises ``RuntimeError`` when the launch fails."""
    (m, k), n = a.shape, b.shape[1]
    cfg = config.resolved()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_gemm(
            _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, k, n, cfg.block_m, cfg.block_k, cfg.block_n,
            cfg.sub_m, cfg.sub_n, cfg.reg_m, cfg.reg_n, stream,
        )
    if err != 0:
        raise RuntimeError(f"GEMM kernel launch failed (error {err}) for {cfg} at {(m, k, n)}")
    return out
