"""setup_s: seconds from process start to the window's start (host clock)."""

from perfbench.readers import setup_s as read

__all__ = ["read"]
