"""The flash-attention kernel for Hopper, its plain PyTorch version, and the
tuner <-> kernel contract.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``: bf16 on
the tensor cores with ``wgmma``, f32 on CUDA cores) replaces the Pallas
TPU kernel ``repro/kernels/flash_attention.py:_flash_kernel``.
It is built with ``nvcc`` into a shared library with a plain C interface
the first time it is needed (into ``_build/`` beside this file, keyed by
a hash of the source) and bound with ``ctypes``.

:func:`flash_attention` is the wrapper.  It keeps the JAX package's
layout — q ``(B, S, H, hd)``, k/v ``(B, S, KV, hd)`` with ``H = KV * G``
— checks device, dtype, shapes, contiguity and the blocks (raising
``ValueError`` on everything the launch rule of
``repro_torch.core.analysis`` refuses), then launches the kernel on the
current stream for CUDA tensors, or runs :func:`flash_attention_plain` —
the same block loop and online softmax in PyTorch f32, rounding where the
kernel rounds — for CPU tensors (an empty result for ``meta`` tensors, a
dry run's trace), and reports the grid's work to the op counters in
force.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.analysis import HopperSpec, flash_launch_error
from repro_torch.core.flash_space import FlashScheduleState
from repro_torch.utils.op_costs import kernel_ran, uncounted

from .build import load
from .gemm import misaligned
from .ledger import note_launch

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "flash_work",
    "default_blocks",
    "state_from_blocks",
    "build_kernel",
    "bind",
    "launch_with",
    "kernel_max_threads",
    "kernel_f32_ring",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


#: heuristic blocks by input width, most preferred first.  bf16: two
#: warpgroups on 128-key blocks (256 threads, 160 KB of shared memory at
#: hd 128), then smaller; f32: 128 x 64 (512 threads at hd 128, one ring
#: stage in 165 KB), then 64 x 64 (two stages in 183 KB), then the fastest
#: pair of 32 and of 16 rows, down to 16 x 16, which every sequence that
#: is a multiple of 16 takes (``chip_smoke.py --flash-f32-only``'s sweeps)
_HEURISTIC_BLOCKS = {
    2: ((128, 128), (128, 64), (64, 64), (64, 32), (64, 16)),
    4: ((128, 64), (64, 64), (32, 32), (16, 16)),
}


def default_blocks(seq_q: int, seq_kv: int, head_dim: int, in_bytes: int = 2,
                   grid_y: int = 1) -> Optional[tuple[int, int]]:
    """Heuristic ``(block_q, block_kv)`` for ``in_bytes``-wide inputs when
    no tuning record exists, or None when no block the kernel launches
    (at ``grid_y`` = batch x query heads) divides the sequences (then
    dispatch runs plain attention).  Takes the first of
    ``_HEURISTIC_BLOCKS`` that divides and launches; in f32, where that
    pair's grid is under one wave of the card's SMs and the next pair
    has shorter CTAs, the next (a CUDA-core CTA of 128 rows takes twice
    as long as one of 64, so half the grid in one wave is slower).  (The
    JAX package's TPU default, 256 x 512, needs more than a CTA's 227 KB
    at hd 128.)"""
    pairs = [(bq, bkv) for bq, bkv in _HEURISTIC_BLOCKS.get(in_bytes, ())
             if seq_q % bq == 0 and seq_kv % bkv == 0
             and flash_launch_error(bq, bkv, head_dim, in_bytes, grid_y=grid_y) is None]
    if not pairs:
        return None
    if (in_bytes == 4 and len(pairs) > 1 and pairs[1][0] < pairs[0][0]
            and seq_q // pairs[0][0] * grid_y < HopperSpec().num_sms):
        return pairs[1]
    return pairs[0]


def state_from_blocks(block_q: int, block_kv: int, seq_q: int,
                      seq_kv: int) -> FlashScheduleState:
    """The depth-(2, 2) tuner state that reads back as these blocks."""
    return FlashScheduleState((seq_q // block_q, block_q), (seq_kv // block_kv, block_kv))


# -- the plain version ---------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block_q: int, block_kv: int,
                          causal: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch f32: q scaled by ``1/sqrt(hd)``,
    per q block an online softmax over kv blocks (running max from
    -1e30, logits masked to -1e30 where ``q_pos < k_pos``, the causal
    early exit at ``ceil((iq+1)*bq / bkv)``), output
    ``acc / max(l, 1e-30)`` in the input type.  For bf16 inputs p is
    rounded to bf16 before ``p @ v`` and l is summed from the f32 p, as
    the tensor-core kernel does.  Takes any shape; the blocks must divide
    the sequences."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if sq % block_q or sk % block_kv:
        raise ValueError(f"blocks ({block_q},{block_kv}) must divide ({sq},{sk})")
    scale = 1.0 / math.sqrt(hd)
    # (B, KV, G, S, hd) queries against (B, KV, 1, S, hd) keys and values
    qf = (q.float() * scale).reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty((b, kvh, g, sq, hd), dtype=torch.float32, device=q.device)
    n_kv = sk // block_kv
    for iq in range(sq // block_q):
        qb = qf[:, :, :, iq * block_q:(iq + 1) * block_q]
        acc = torch.zeros((b, kvh, g, block_q, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, kvh, g, block_q), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        last = n_kv if not causal else min(n_kv, ((iq + 1) * block_q + block_kv - 1) // block_kv)
        q_pos = iq * block_q + torch.arange(block_q, device=q.device)[:, None]
        for ik in range(last):
            kb = kf[:, :, :, ik * block_kv:(ik + 1) * block_kv]
            vb = vf[:, :, :, ik * block_kv:(ik + 1) * block_kv]
            logits = qb @ kb.transpose(-1, -2)  # (B, KV, G, bq, bkv)
            if causal:
                k_pos = ik * block_kv + torch.arange(block_kv, device=q.device)[None, :]
                logits = torch.where(q_pos >= k_pos, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if q.dtype == torch.bfloat16:  # P enters the tensor cores as bf16
                p = p.to(torch.bfloat16).float()
            acc = acc * corr[..., None] + p @ vb
            m = m_new
        out[:, :, :, iq * block_q:(iq + 1) * block_q] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


# -- build and bind ------------------------------------------------------------

def build_kernel() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/flash_attention.cu`` for ``sm_90a`` (once per source
    hash) and load it.  Returns the library and ptxas' resource report.
    A failed build raises."""
    return load("flash_attention.cu", bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``flash_attention.cu`` (this
    file's, or a variant of its source) on the loaded library."""
    lib.repro_flash.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.repro_flash.restype = ctypes.c_int
    lib.repro_flash_max_threads.argtypes = [ctypes.c_int] * 2
    lib.repro_flash_max_threads.restype = ctypes.c_int
    lib.repro_flash_f32_ring.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.repro_flash_f32_ring.restype = ctypes.c_int
    return lib


def kernel_max_threads(dtype: torch.dtype, head_dim: int) -> int:
    """The compiled instantiation's launch limit, as the card reports it
    (must equal ``analysis.flash_max_threads``)."""
    lib, _ = build_kernel()
    return lib.repro_flash_max_threads(_DTYPE_CODE[dtype], head_dim)


def kernel_f32_ring(block_q: int, block_kv: int, head_dim: int) -> tuple[int, int]:
    """``(stages, shared-memory bytes)`` of the K/V ring the compiled
    float32 kernel launches these blocks with on this card (must equal
    ``analysis.flash_stages`` and ``flash_smem_bytes``; 0 stages where one
    does not fit)."""
    lib, _ = build_kernel()
    smem = ctypes.c_int(0)
    stages = lib.repro_flash_f32_ring(block_q, block_kv, head_dim, ctypes.byref(smem))
    return stages, smem.value


# -- the wrapper ---------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int, block_kv: int, causal: bool = True) -> torch.Tensor:
    """Attention of q ``(B, Sq, H, hd)`` over k/v ``(B, Sk, KV, hd)``
    through the kernel under ``(block_q, block_kv)``: launched on the card
    for CUDA tensors, the plain version for CPU tensors, an empty result
    for ``meta`` tensors (a dry run's trace); on every device the grid's
    work (:func:`flash_work`) is reported to the op counters in force, and
    only a launch counts in the launch ledger.  Raises
    ``ValueError`` on anything the kernel does not take — the causal mask
    has no offset, so causal attention needs ``Sq == Sk`` — and
    ``RuntimeError`` when a launch fails.

    The kernel has no backward (nor has the JAX package's), so operands
    that autograd would record are refused on every device: its output
    would carry no gradient to q, k or v.  Training takes
    ``models/common.chunked_causal_attention``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention has no backward: operands that require a "
                         "gradient take chunked_causal_attention")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention expects (B, S, H, hd) / (B, S, KV, hd) tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel takes "
                         "float32 or bfloat16 triples")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device} and {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd or kvh < 1 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         "are not GQA-compatible")
    if causal and sq != sk:
        raise ValueError(f"causal attention needs seq_q == seq_kv (got {sq}, {sk}): "
                         "the kernel's mask has no offset")
    bq, bkv = block_q, block_kv
    if min(bq, bkv) < 1 or sq % bq or sk % bkv:
        raise ValueError(f"blocks ({bq},{bkv}) must divide ({sq},{sk})")
    err = flash_launch_error(bq, bkv, hd, q.element_size(), grid_y=b * h)
    if err is not None:
        raise ValueError(f"{err[0]}: {err[1]}")
    if q.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    if q.device.type == "cuda" and any(misaligned(t) for t in (q, k, v)):
        raise ValueError("the kernel copies 16-byte chunks: operands must be 16-byte aligned")
    with uncounted():  # the grid's work is reported below, on every device
        if q.device.type == "cpu":  # laid out as the kernel writes it
            out = flash_attention_plain(q, k, v, bq, bkv, causal).contiguous()
        elif q.device.type == "meta":
            out = torch.empty_like(q)
        else:
            out = launch_with(build_kernel()[0], q, k, v, bq, bkv, causal)
            note_launch("flash", (sq, sk, hd), q.dtype)
    kernel_ran("flash", (sq, sk, hd),
               *flash_work(b, sq, sk, h, kvh, hd, bq, bkv, causal, q.element_size()), out)
    return out


def flash_work(b: int, seq_q: int, seq_kv: int, heads: int, kv_heads: int, head_dim: int,
               block_q: int, block_kv: int, causal: bool, in_bytes: int) -> tuple[int, int]:
    """``(FLOPs, bytes)`` of one call.  FLOPs are the grid's, by the
    blocks it visits: each of the ``b·heads·(seq_q/block_q)`` CTAs visits
    ``n_visit(iq)`` kv blocks — all ``n_kv = seq_kv/block_kv`` of them,
    or, causal, the first ``min(n_kv, ceil((iq+1)·block_q / block_kv))``
    — and on each does ``4·block_q·block_kv·head_dim`` FLOPs (``QKᵀ`` and
    ``PV``, the diagonal block's masked entries included; the softmax's
    exponentials and sums are not counted): ``4·b·heads·block_q·block_kv
    ·head_dim·Σ_iq n_visit(iq)``.  Bytes are the function's least
    traffic, q, k and v read once and the output written once:
    ``in_bytes·b·head_dim·(2·seq_q·heads + 2·seq_kv·kv_heads)``.  The
    grid reads each K/V block once per q block that visits it, but the
    re-reads of one head group's K/V mostly hit L2, so counting them as
    HBM traffic would overstate the roofline's memory term."""
    n_kv = seq_kv // block_kv
    visits = sum(min(n_kv, ((iq + 1) * block_q + block_kv - 1) // block_kv) if causal
                 else n_kv for iq in range(seq_q // block_q))
    flops = 4 * b * heads * block_q * block_kv * head_dim * visits
    nbytes = in_bytes * b * head_dim * (2 * seq_q * heads + 2 * seq_kv * kv_heads)
    return flops, nbytes


def launch_with(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                block_q: int, block_kv: int, causal: bool = True) -> torch.Tensor:
    """Launch a bound build of the kernel on CUDA operands that
    :func:`flash_attention` has checked, on the current stream; neither
    checks nor counts.  Raises ``RuntimeError`` when the launch fails."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_flash(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, sk, h, kvh, block_q, block_kv, int(causal),
            1.0 / math.sqrt(hd), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed (error {rc}) for blocks "
                           f"({block_q},{block_kv}) at q {tuple(q.shape)} k/v {tuple(k.shape)}")
    return out
