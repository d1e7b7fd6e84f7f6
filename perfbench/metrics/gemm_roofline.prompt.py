"""gemm_roofline.prompt: the traced batches' dense products at their bound over the GEMM kernel's device time."""

from perfbench.readers import gemm_roofline as read

__all__ = ["read"]
