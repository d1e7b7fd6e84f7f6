"""The chunked SSD of Mamba-2 (arXiv:2405.21060, Listing 1): its plain
PyTorch version and the chunked-scan kernel for Hopper.

:func:`ssd_chunked` is the plain version: the chunked SSD as f32 tensor
code, a quadratic, attention-like form inside chunks plus a linear
recurrence across chunk boundaries (the JAX package's ``lax.scan`` over
chunks is a Python loop here).  It is what the JAX package has too (no
Pallas kernel), what training's autograd records and what runs on the CPU.

The kernel (``csrc/ssd.cu``, CUDA C++ for ``sm_90a``) replaces no TPU
kernel: it is the served prefill's SSD, added because that plain code,
run on the card, spent its time in elementwise passes over per-head
(q, q) decay blocks, in f32 SIMT products and in the host loop over
chunks.  It computes, from the raw ``dt``, what the Mamba-2 block's
prefill needs — ``dt = softplus(dt_raw + dt_bias)``, zero at and past each
row's valid length, the scan, the ``D·x`` skip and one rounding of ``y``
to bf16 — and the final state, with the products on ``wgmma`` and every
f32-formed operand split into two TF32 parts (see the source's note).  It
is built with ``nvcc`` into a shared library with a plain C interface the
first time it is needed (into ``_build/`` beside this file, keyed by a hash
of the source) and bound with ``ctypes``.

:func:`ssd_scan` is the wrapper and :func:`ssd_scan_plain` the plain
version of the same function; :func:`ssd_prefill`, the Mamba-2 block's
call, routes between them.  :func:`takes` says which shapes the kernel has
an instantiation for.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .build import load
from .ledger import note_launch
from .ops import note_dispatch

__all__ = [
    "ssd_chunked",
    "ssd_scan",
    "ssd_scan_plain",
    "ssd_prefill",
    "takes",
    "build_kernel",
    "bind",
]

#: ``(chunk, state size)`` pairs with an instantiation (head dim 64, bf16):
#: the B^T and C tiles a CTA stages as TF32 hold at most 128 KB
_INSTANCES = frozenset({(128, 64), (128, 128), (128, 256), (256, 64), (256, 128)})
_HEAD_DIM = 64
#: the most CTAs a grid's y or z dimension takes (rows x heads, chunks)
_GRID_LIMIT = 65535


def takes(p: int, n: int, q: int, dtype: torch.dtype) -> bool:
    """Whether the kernel has an instantiation for head dim ``p``, state
    size ``n`` and chunk ``q`` in ``dtype``."""
    return p == _HEAD_DIM and (q, n) in _INSTANCES and dtype == torch.bfloat16


# -- the plain version -------------------------------------------------------------

#: f32 bytes of the per-head decay blocks (b, c, q, q, h) one SSD pass may hold;
#: a longer batch runs in blocks of rows (about four such tensors are live)
_SSD_BLOCK_BYTES = 1 << 30


def ssd_chunked(x, dt, A, B, C, chunk: int, return_state: bool = False):
    """Chunked SSD (Mamba2 Listing 1).  All SSD math runs in f32, as the
    reference's does; inputs may be bf16.  x: (b,l,h,p); dt: (b,l,h);
    A: (h,) (negative); B,C: (b,l,g,n), g dividing h: head k reads group
    ``k // (h/g)`` (g = h: one a head, the JAX package's form).

    B and C stay per group: every contraction with them takes the heads as
    ``(g, h/g)``, and the decays scale x or a contraction's output, so no
    head-expanded ``(…, h, n)`` operand is formed (the chunk states are
    ``(h, p, n)`` by nature).  Each multi-operand einsum of the reference
    is written as pairwise products, so no (b,c,q,q,h,p) intermediate is
    ever formed.  A batch whose decay blocks exceed ``_SSD_BLOCK_BYTES``
    runs in blocks of rows.  A length the chunk does not divide is padded
    at its end with ``dt = 0``, which leaves the state unchanged."""
    y, state = _ssd_f32(x, dt, A, B, C, chunk)
    y = y.to(x.dtype)
    return (y, state) if return_state else y


def _ssd_f32(x, dt, A, B, C, chunk: int, formed=None):
    """:func:`ssd_chunked`'s ``(y in f32, final state)``.  ``formed``, where
    given, maps each operand the products form in f32 (the dt-scaled
    scores, x scaled by dt and its decay, the entering states) before it
    enters its product: how a test holds those operands to a precision."""
    b, l, h, p = x.shape
    q = min(chunk, l)
    tail = -l % q
    if tail:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, tail)) for t in (x, dt, B, C))
    rows = max(1, _SSD_BLOCK_BYTES // ((l + tail) * q * h * 4))
    parts = [_ssd_rows(x[r:r + rows], dt[r:r + rows], A, B[r:r + rows], C[r:r + rows], q,
                       formed or (lambda t: t)) for r in range(0, b, rows)]
    if len(parts) == 1:
        return parts[0][0][:, :l], parts[0][1]
    return torch.cat([y for y, _ in parts])[:, :l], torch.cat([st for _, st in parts])


def _ssd_rows(x, dt, A, B, C, q: int, formed):
    """:func:`ssd_chunked` over one block of rows, the length a multiple
    of the chunk ``q``: ``(y f32 (b,l,h,p), final state (b,h,p,n))``."""
    b, l, h, p = x.shape
    g, n = B.shape[-2:]
    r = h // g
    c = l // q
    xc = x.reshape(b, c, q, g, r, p).float()
    dtc = dt.reshape(b, c, q, g, r).float()
    Bc = B.reshape(b, c, q, g, n).float()
    Cc = C.reshape(b, c, q, g, n).float()

    dA_cs = torch.cumsum(dtc * A.reshape(g, r), dim=2)  # (b,c,q,g,r) within-chunk cumulative

    # -- intra-chunk (diagonal blocks): L[i,j] = exp(dA_cs[i] - dA_cs[j]), i >= j
    seg = dA_cs[:, :, :, None] - dA_cs[:, :, None, :]  # (b,c,qi,qj,g,r)
    ii = torch.arange(q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None, None]
    # masked before the exponential: above the diagonal seg grows with the
    # chunk and its exp overflows (at 256, every published config's chunk),
    # and the backward of the JAX package's where(causal, exp(seg), 0) then
    # multiplies the masked zeros by inf: NaN gradients (ROADMAP.md)
    L = torch.exp(torch.where(causal, seg, -math.inf))
    del seg
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)[..., None] * L  # C_i·B_j per group
    del L
    y_diag = torch.einsum("bcijgr,bcjgrp->bcigrp", formed(scores * dtc[:, :, None]), xc)
    del scores

    # -- chunk summary states: the decays and dt scale x ------------------------------
    decay_to_end = torch.exp(dA_cs[:, :, -1:] - dA_cs)  # (b,c,q,g,r)
    S = torch.einsum("bcqgn,bcqgrp->bcgrpn", Bc, formed(xc * (dtc * decay_to_end)[..., None]))

    # -- inter-chunk recurrence: carry states across chunks -----------------------
    chunk_decay = torch.exp(dA_cs[:, :, -1])  # (b,c,g,r)
    state = torch.zeros((b, g, r, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for ci in range(c):  # emit the state ENTERING each chunk
        entering.append(state)
        state = state * chunk_decay[:, ci, :, :, None, None] + S[:, ci]
    entering = torch.stack(entering, dim=1)  # (b,c,g,r,p,n)

    # -- off-diagonal contribution of the carried state, its decay on the output --
    y_off = torch.einsum("bcign,bcgrpn->bcigrp", Cc, formed(entering)) * torch.exp(dA_cs)[..., None]
    return (y_diag + y_off).reshape(b, l, h, p), state.reshape(b, h, p, n)


def _dt(dt_raw, dt_bias, valid_len):
    """``softplus(dt_raw + dt_bias)`` in f32, zero at and past each row's
    ``valid_len`` (every position real where it is None)."""
    dt = F.softplus(dt_raw.float() + dt_bias)
    if valid_len is not None:
        real = torch.arange(dt.shape[1], device=dt.device)[None, :] < valid_len[:, None]
        dt = dt * real[..., None]
    return dt


def ssd_scan_plain(x, dt_raw, dt_bias, A, B, C, D, chunk: int,
                   valid_len: Optional[torch.Tensor] = None):
    """The kernel's function in PyTorch: ``dt`` from ``dt_raw`` (masked past
    ``valid_len``), :func:`ssd_chunked`'s y in f32 plus ``D·x``, rounded
    once to x's type, and the final state (b, h, p, n) in f32.
    :func:`ssd_prefill` runs it wherever the kernel does not."""
    y, state = _ssd_f32(x, _dt(dt_raw, dt_bias, valid_len), A, B, C, chunk)
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state


# -- build and bind ------------------------------------------------------------------

def build_kernel() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/ssd.cu`` for ``sm_90a`` (once per source hash) and
    load it.  Returns the library and ptxas' resource report.  A failed
    build raises."""
    return load("ssd.cu", bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``ssd.cu`` on the library."""
    lib.repro_ssd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 14
                              + [ctypes.c_int64] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.repro_ssd.restype = ctypes.c_int
    return lib


# -- the wrapper ---------------------------------------------------------------------


def _on_kernel(operands, chunk: int) -> bool:
    """Whether a prefill runs the kernel: CUDA operands that autograd does
    not record, at a shape :func:`takes` accepts."""
    x, B = operands[0], operands[4]
    return (x.device.type == "cuda"
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in operands))
            and takes(x.shape[-1], B.shape[-1], chunk, x.dtype))


def ssd_prefill(x: torch.Tensor, dt_raw: torch.Tensor, dt_bias: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, chunk: int,
                valid_len: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 block's prefill SSD, operands as :func:`ssd_scan`'s: the
    kernel where :func:`_on_kernel`, else :func:`ssd_scan_plain` (training's
    autograd, the CPU, ``meta``, shapes without an instantiation).  Counts
    the route in ``ops.dispatch_stats()["ssd"]``: ``heuristic`` (the
    kernel, which runs its own fixed schedule) or ``plain``."""
    operands = (x, dt_raw, dt_bias, A, B, C, D)
    if _on_kernel(operands, chunk):
        note_dispatch("ssd", "heuristic")
        return ssd_scan(*operands, chunk, valid_len)
    note_dispatch("ssd", "plain")
    return ssd_scan_plain(*operands, chunk, valid_len)


def _strided(t: torch.Tensor) -> bool:
    """Whether the kernel reads bf16 ``t`` as it is: its last two dims
    packed, its batch and position strides and its start on 16-byte
    boundaries."""
    return (t.stride(-1) == 1 and t.stride(-2) == t.shape[-1] and t.data_ptr() % 16 == 0
            and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0)


def ssd_scan(x: torch.Tensor, dt_raw: torch.Tensor, dt_bias: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, chunk: int,
             valid_len: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 block's SSD from the raw ``dt``: x ``(b, l, h, 64)``,
    dt_raw ``(b, l, h)``, B and C ``(b, l, g, n)`` in bf16 (any batch and
    position strides; heads and groups packed), dt_bias, A (negative) and D
    ``(h,)``, ``valid_len`` ``(b,)`` or None.  Returns ``(y, state)``: y
    ``(b, l, h, 64)`` bf16, ``ssd(x, dt, A, B, C) + D·x`` rounded once, and
    the final state ``(b, h, 64, n)`` in f32.

    Launched on the card for CUDA tensors, the plain version
    (:func:`ssd_scan_plain`) for CPU tensors; only a launch counts in the
    launch ledger.  Raises ``ValueError`` on anything the kernel does
    not take (:func:`takes`; shapes, types, devices) and ``RuntimeError``
    when a launch fails.  The kernel has no backward (nor has the JAX
    package's SSD a kernel), so operands that autograd would record are
    refused: training takes :func:`ssd_chunked`."""
    operands = (x, dt_raw, dt_bias, A, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise ValueError("ssd_scan has no backward: operands that require a gradient take "
                         "ssd_chunked")
    if x.ndim != 4 or dt_raw.ndim != 3 or B.ndim != 4 or C.ndim != 4:
        raise ValueError("ssd_scan expects x (b, l, h, p), dt_raw (b, l, h), B and C (b, l, g, n)")
    b, l, h, p = x.shape
    g, n = B.shape[-2:]
    if (dt_raw.shape != (b, l, h) or B.shape != (b, l, g, n) or C.shape != B.shape
            or h % g or any(t.shape != (h,) for t in (dt_bias, A, D))):
        raise ValueError(f"x {tuple(x.shape)}, dt_raw {tuple(dt_raw.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)} and dt_bias/A/D do not fit one another")
    if not takes(p, n, chunk, x.dtype) or not (dt_raw.dtype == B.dtype == C.dtype == x.dtype):
        raise ValueError(f"no instantiation for head dim {p}, state {n}, chunk {chunk} in "
                         f"{x.dtype}/{dt_raw.dtype}/{B.dtype}/{C.dtype}")
    if valid_len is not None and valid_len.shape != (b,):
        raise ValueError(f"valid_len {tuple(valid_len.shape)} is not one length a row")
    devices = {t.device for t in operands} | ({valid_len.device} if valid_len is not None else set())
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(map(str, devices))}")
    device = x.device
    if device.type == "cpu":
        return ssd_scan_plain(x, dt_raw, dt_bias, A, B, C, D, chunk, valid_len)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if l == 0 or b == 0:
        raise ValueError("ssd_scan needs at least one row and one position")
    if b * h > _GRID_LIMIT or -(-l // chunk) > _GRID_LIMIT:
        raise ValueError(f"{b} rows x {h} heads or {-(-l // chunk)} chunks exceed the launch "
                         f"grid's {_GRID_LIMIT}")
    x, B, C = (t if _strided(t) else t.contiguous() for t in (x, B, C))
    if dt_raw.stride(-1) != 1:
        dt_raw = dt_raw.contiguous()
    dt_bias, A, D = (t.float().contiguous() for t in (dt_bias, A, D))
    if valid_len is not None:
        valid_len = valid_len.to(torch.int32).contiguous()
    q, chunks = chunk, -(-l // chunk)
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=device)
    state = torch.empty((b, h, p, n), **f32)
    # what the kernels pass on: dt and dA_cs (b, chunks, h, q), C B^T (b,
    # chunks, g, q, q) and the state entering each chunk (b, chunks, h, p, n)
    scratch = (torch.empty((b, chunks, h, q), **f32), torch.empty((b, chunks, h, q), **f32),
               torch.empty((b, chunks, g, q, q), **f32), torch.empty((b, chunks, h, p, n), **f32))
    lib, _ = build_kernel()
    with torch.cuda.device(device):
        rc = lib.repro_ssd(
            n, q, x.data_ptr(), dt_raw.data_ptr(), B.data_ptr(), C.data_ptr(),
            dt_bias.data_ptr(), A.data_ptr(), D.data_ptr(),
            None if valid_len is None else valid_len.data_ptr(),
            y.data_ptr(), state.data_ptr(), *(t.data_ptr() for t in scratch),
            x.stride(0), x.stride(1), dt_raw.stride(0), dt_raw.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), b, l, h, g,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed (error {rc}) at x {tuple(x.shape)}, "
                           f"B {tuple(B.shape)}, chunk {q}")
    note_launch("ssd", (n, q), x.dtype)
    return y, state
