"""engine.prefill_ms.prompt: the engine's prefill time a batch, over the window (its ``stats['prefill_s']``)."""

from perfbench.readers import prefill_ms as read

__all__ = ["read"]
