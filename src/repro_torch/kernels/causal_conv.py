"""Mamba-2's depthwise causal conv over the sequence, with its bias and
SiLU: its plain PyTorch version and the kernel for Hopper.

:func:`causal_conv_plain` is the plain version: four taps, each a
multiply and an add over the whole tensor, the bias and ``F.silu``, every
pass rounding its result to the operands' type.  It is what the JAX
package has too (plain code, which XLA fuses into one loop), what
training's autograd records and what runs on the CPU.

The kernel (``csrc/conv.cu``, CUDA C++ for ``sm_90a``) replaces no TPU
kernel: it is the served prefill's conv, added because the plain version,
run on the card, makes about 27 full-size passes over ``xBC``.  It reads
``in_proj``'s output in place, as the strided ``xBC`` slice, once (plus a
3-position halo a tile), holds the taps, the bias and the SiLU in
registers, and writes a packed ``(b, l, ch)`` bf16 ``xBC`` once, with the
plain version's roundings: the same numbers.  It is built with ``nvcc``
into a shared library with a plain C interface the first time it is needed
(``kernels/build.load``) and bound with ``ctypes``.

:func:`causal_conv` is the wrapper; :func:`conv_prefill`, the Mamba-2
block's call, routes between it and the plain version.  :func:`takes` says
which widths, channel counts and types the kernel takes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load
from .ledger import note_launch
from .ops import note_dispatch

__all__ = ["causal_conv_plain", "causal_conv", "conv_prefill", "takes", "build_kernel", "bind",
           "bf16_steps"]

#: the one conv width the kernel takes (every served Mamba-2 config's)
_WIDTH = 4
#: channels a thread of the kernel owns: one 16-byte load or store
_VEC = 8


def takes(width: int, channels: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes a conv of ``width`` taps over ``channels``
    channels in ``dtype``."""
    return width == _WIDTH and channels % _VEC == 0 and dtype == torch.bfloat16


def causal_conv_plain(xBC: torch.Tensor, conv_w: torch.Tensor,
                      conv_b: torch.Tensor) -> torch.Tensor:
    """``silu(depthwise causal conv + bias)`` over the sequence, in plain
    PyTorch.  xBC: (b, l, ch); conv_w: (width, ch); conv_b: (ch,)."""
    w = conv_w.shape[0]
    pad = F.pad(xBC, (0, 0, w - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(w):  # the width is tiny (4): unrolled taps
        out = out + pad[:, i:i + xBC.shape[1], :] * conv_w[i][None, None, :]
    return F.silu(out + conv_b[None, None, :])


# -- build and bind ------------------------------------------------------------------

def build_kernel() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/conv.cu`` for ``sm_90a`` (once per source hash) and
    load it.  Returns the library and ptxas' resource report.  A failed
    build raises."""
    return load("conv.cu", bind)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``conv.cu`` on the library."""
    lib.repro_conv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.repro_conv.restype = ctypes.c_int
    return lib


# -- the wrapper ---------------------------------------------------------------------


def _aligned(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` as it is: channels packed, its start
    and its batch and position strides on 16-byte boundaries (bf16)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and t.stride(0) % _VEC == 0 and t.stride(1) % _VEC == 0)


def _typed(xBC, conv_w, conv_b) -> bool:
    return (conv_w.dtype == conv_b.dtype == xBC.dtype
            and takes(conv_w.shape[0], xBC.shape[-1], xBC.dtype))


def _on_kernel(xBC, conv_w, conv_b) -> bool:
    """Whether a prefill runs the kernel: CUDA operands that autograd does
    not record, of a width, channel count and type :func:`takes` accepts,
    xBC read in place (:func:`_aligned`)."""
    operands = (xBC, conv_w, conv_b)
    return (xBC.device.type == "cuda"
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in operands))
            and _typed(*operands) and _aligned(xBC))


def conv_prefill(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 block's prefill conv, operands as :func:`causal_conv`'s:
    the kernel where :func:`_on_kernel`, else :func:`causal_conv_plain`
    (training's autograd, the CPU, ``meta``, other widths and types).
    Counts the route in ``ops.dispatch_stats()["conv"]``: ``heuristic``
    (the kernel, which runs its own fixed schedule) or ``plain``."""
    if _on_kernel(xBC, conv_w, conv_b):
        note_dispatch("conv", "heuristic")
        return _launch(xBC, conv_w, conv_b)
    note_dispatch("conv", "plain")
    return causal_conv_plain(xBC, conv_w, conv_b)


def causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """``silu(depthwise causal conv + bias)`` over the sequence: xBC
    ``(b, l, ch)`` in bf16, its channels packed and its start and batch and
    position strides on 16-byte boundaries (``in_proj``'s output sliced in
    place), conv_w ``(4, ch)`` and conv_b ``(ch,)`` in bf16.  Returns
    ``(b, l, ch)`` bf16, packed: :func:`causal_conv_plain`'s numbers.

    Launched on the card for CUDA tensors, the plain version for CPU
    tensors; only a launch counts in the launch ledger.  Raises
    ``ValueError`` on anything the kernel does not take (:func:`takes`;
    shapes, strides, types, devices) and ``RuntimeError`` when a launch
    fails.  The kernel has no backward, so operands that autograd would
    record are refused: training takes :func:`causal_conv_plain`."""
    operands = (xBC, conv_w, conv_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise ValueError("causal_conv has no backward: operands that require a gradient take "
                         "causal_conv_plain")
    if xBC.ndim != 3 or conv_w.ndim != 2 or conv_w.shape[1:] != xBC.shape[-1:] \
            or conv_b.shape != xBC.shape[-1:]:
        raise ValueError(f"xBC {tuple(xBC.shape)}, conv_w {tuple(conv_w.shape)} and conv_b "
                         f"{tuple(conv_b.shape)} do not fit one another")
    if not _typed(*operands):
        raise ValueError(f"no kernel for width {conv_w.shape[0]}, {xBC.shape[-1]} channels in "
                         f"{xBC.dtype}/{conv_w.dtype}/{conv_b.dtype}")
    if not _aligned(xBC):
        raise ValueError(f"xBC at strides {xBC.stride()} from byte {xBC.data_ptr() % 16} of 16 "
                         f"is not on 16-byte boundaries")
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(map(str, devices))}")
    device = xBC.device
    if device.type == "cpu":
        return causal_conv_plain(xBC, conv_w, conv_b)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return _launch(xBC, conv_w, conv_b)


def _launch(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on operands :func:`_on_kernel` accepts, shapes
    that fit one another, all on one card."""
    b, l, ch = xBC.shape
    y = torch.empty((b, l, ch), dtype=xBC.dtype, device=xBC.device)
    if y.numel() == 0:
        return y
    conv_w, conv_b = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                      else t.clone(memory_format=torch.contiguous_format) for t in (conv_w, conv_b))
    lib, _ = build_kernel()
    with torch.cuda.device(xBC.device):
        rc = lib.repro_conv(conv_w.shape[0], xBC.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                            y.data_ptr(), xBC.stride(0), xBC.stride(1), b, l, ch,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv kernel launch failed (error {rc}) at xBC {tuple(xBC.shape)}")
    note_launch("conv", (conv_w.shape[0], ch), xBC.dtype)
    return y


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps apart each element of two bf16 tensors lies: how
    the kernel is held to :func:`causal_conv_plain`'s roundings."""
    def ordered(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (ordered(got) - ordered(want)).abs()
