"""device.idle_share.prompt: the share of the traced window with no operation on the device."""

from perfbench.readers import idle_share as read

__all__ = ["read"]
