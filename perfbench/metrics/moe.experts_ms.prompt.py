"""moe.experts_ms.prompt: the device ms a traced prefill of the MoE's experts (kernels launched under the span ``moe.experts``)."""

from perfbench.spans import device_ms

__all__ = ["read"]


def read(ctx):
    return device_ms(ctx, "moe.experts")
