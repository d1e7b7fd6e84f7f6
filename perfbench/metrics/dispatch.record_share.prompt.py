"""dispatch.record_share.prompt: the share of the window's eager GEMM dispatches a tuned record drove (``dispatch_stats()``)."""

from perfbench.readers import record_share as read

__all__ = ["read"]
