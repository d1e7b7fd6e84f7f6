"""flash_roofline.prompt: the traced prefills' causal attention at its bound over the flash kernel's device time."""

from perfbench.readers import flash_roofline as read

__all__ = ["read"]
