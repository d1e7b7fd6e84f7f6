"""mfu.prompt: the window's model operations over its seconds at the bf16 peak."""

from perfbench.readers import mfu as read

__all__ = ["read"]
