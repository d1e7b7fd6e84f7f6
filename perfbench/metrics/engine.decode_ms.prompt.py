"""engine.decode_ms.prompt: the engine's decode time a batch, over the window (its ``stats['decode_s']``, the span ``serve.decode``)."""

from perfbench.spans import decode_ms as read

__all__ = ["read"]
