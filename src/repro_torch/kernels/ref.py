"""Untiled oracle for the GEMM kernel and its VJP, on tensors: each
product accumulates in f32 and is cast to the output's type once, as the
JAX package's ``kernels/ref.py`` computes it.  It imports no kernel and
launches nothing; the checks that hold the kernel and its backward
against it call it, and no path of the port does."""

from __future__ import annotations

from typing import Optional

import torch


def ref_gemm(a: torch.Tensor, b: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` accumulated in f32, in ``out_dtype`` (``a``'s type unless
    another is given)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def ref_gemm_vjp(a: torch.Tensor, b: torch.Tensor,
                 g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dA, dB)`` of ``C = A @ B`` under the cotangent ``g``, each in its
    operand's type."""
    ga = g.float()
    return (ga @ b.float().t()).to(a.dtype), (a.float().t() @ ga).to(b.dtype)
